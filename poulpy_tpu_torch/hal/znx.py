"""Z[X]/(X^N+1) coefficient-domain kernels ("znx").

Twin of `poulpy_tpu/hal/znx.py`: int64 tensors whose last axis is N,
broadcasting over leading axes, with jnp's wrapping int64.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def znx_add(a, b):
    return a + b


def znx_sub(a, b):
    return a - b


def znx_negate(a):
    return -a


def znx_zero_like(a):
    return torch.zeros_like(a)


def znx_mul_power_of_two(k: int, a):
    """a · 2^k with wrapping int64 semantics; a negative k is an arithmetic
    right shift.  Shifts of 64 bits or more give what jnp's do: 0 to the
    left, the sign to the right."""
    if k == 0:
        return a
    if k > 0:
        return a << k if k < 64 else torch.zeros_like(a)
    return a >> min(-k, 63)


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
