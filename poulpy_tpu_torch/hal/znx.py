"""Z[X]/(X^N+1) coefficient-domain kernels ("znx").

Twin of `poulpy_tpu/hal/znx.py` (the part the port needs): int64 tensors
whose last axis is N, broadcasting over leading axes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def znx_rotate(p, a):
    """res = a · X^p in Z[X]/(X^N+1): res[i] = ±a[(i-p) mod N], the sign
    flipping on negacyclic wrap-around.

    `p` is a Python int or an int64 tensor broadcastable against `a`'s
    leading axes (the batched blind rotation rotates every ciphertext of a
    batch by its own amount in one gather)."""
    n = a.shape[-1]
    ar = torch.arange(n, dtype=torch.int64, device=a.device)
    if not isinstance(p, torch.Tensor):
        idx2n = (ar - p) & (2 * n - 1)
        sign = torch.where(idx2n < n, 1, -1).to(torch.int64)
        return torch.index_select(a, -1, idx2n & (n - 1)) * sign
    idx2n = (ar - p.to(torch.int64)[..., None]) & (2 * n - 1)
    sign = torch.where(idx2n < n, 1, -1).to(torch.int64)
    shape = torch.broadcast_shapes(a.shape[:-1], idx2n.shape[:-1]) + (n,)
    out = torch.gather(a.expand(shape), -1, (idx2n & (n - 1)).expand(shape))
    return out * sign


@functools.lru_cache(maxsize=None)
def _automorphism_tables(n: int, p: int) -> tuple[np.ndarray, np.ndarray]:
    """Gather index + sign realizing X → X^p: res[k] = sign[k]·a[idx[k]]."""
    idx = np.zeros(n, dtype=np.int64)
    sign = np.ones(n, dtype=np.int64)
    mask = 2 * n - 1
    k = 0
    for i in range(1, n):
        k = (k + p) & mask
        if k < n:
            idx[k] = i
            sign[k] = 1
        else:
            idx[k - n] = i
            sign[k - n] = -1
    return idx, sign


def znx_automorphism(p: int, a):
    """res(X) = a(X^p) in Z[X]/(X^N+1); `p` is an odd integer."""
    n = a.shape[-1]
    idx, sign = _automorphism_tables(n, int(p) & (2 * n - 1))
    idx = torch.from_numpy(idx).to(a.device)
    return torch.index_select(a, -1, idx) * torch.from_numpy(sign).to(a.device)


def znx_switch_ring(n_out: int, a):
    """Change the ring degree: downscaling keeps every (n_in/n_out)-th
    coefficient; upscaling spreads the coefficients n_out/n_in slots apart
    (the X → X^{n_out/n_in} embedding)."""
    n_in = a.shape[-1]
    if n_out == n_in:
        return a
    if n_out < n_in:
        return a[..., :: n_in // n_out]
    out = torch.zeros(a.shape[:-1] + (n_out,), dtype=a.dtype, device=a.device)
    out[..., :: n_out // n_in] = a
    return out
