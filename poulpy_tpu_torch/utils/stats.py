"""Noise statistics of decoded torus polynomials: twin of
`poulpy_tpu/utils/stats.py`.

The limbs are decoded on the host in float64 numpy (`decode_vec_float`),
as the JAX package does, so equal limbs give equal `Stats`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from poulpy_tpu_torch.hal.vec_znx import decode_vec_float


@dataclass(frozen=True)
class Stats:
    """Summary statistics of a decoded torus polynomial."""

    mean: float
    std: float
    max_abs: float

    @property
    def log2_std(self) -> float:
        return float(np.log2(max(self.std, 1e-300)))

    @property
    def log2_max(self) -> float:
        return float(np.log2(max(self.max_abs, 1e-300)))


def _stats(v: np.ndarray) -> Stats:
    return Stats(mean=float(v.mean()), std=float(v.std()), max_abs=float(np.abs(v).max()))


def vec_znx_stats(base2k: int, limbs) -> Stats:
    """Stats of a limb vector's torus values."""
    return _stats(decode_vec_float(base2k, limbs))


def noise_stats(base2k: int, pt_have, pt_want_float) -> Stats:
    """Stats of the torus distance between a decoded plaintext and the ideal
    value (taken mod 1 into [-0.5, 0.5])."""
    if isinstance(pt_want_float, torch.Tensor):
        pt_want_float = pt_want_float.cpu().numpy()
    v = decode_vec_float(base2k, pt_have) - np.asarray(pt_want_float)
    v -= np.round(v)
    return _stats(v)
