"""Z[X]/(X^N+1) coefficient-domain kernels ("znx").

Twin of `poulpy_tpu/hal/znx.py` (the part the slice needs): int64 tensors
whose last axis is N, broadcasting over leading axes.
"""

from __future__ import annotations

import torch


def znx_rotate(p: int, a):
    """res = a · X^p in Z[X]/(X^N+1): res[i] = ±a[(i-p) mod N], the sign
    flipping on negacyclic wrap-around.  (The JAX twin also takes a batched
    `p`; the slice rotates by one integer.)"""
    n = a.shape[-1]
    idx2n = (torch.arange(n, dtype=torch.int64, device=a.device) - p) & (2 * n - 1)
    sign = torch.where(idx2n < n, 1, -1).to(torch.int64)
    return torch.index_select(a, -1, idx2n & (n - 1)) * sign
