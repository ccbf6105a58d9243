"""Lookup tables for blind rotation: twin of `poulpy_tpu/binfhe/lut.py` for
`extension_factor == 1`.

A LUT encodes f: Z_{2N} → T as one limb-vector polynomial: each of the f_len
function samples covers step = N/f_len consecutive coefficients, scaled to
the requested torus precision, and the whole table is pre-rotated by half a
step (the `drift`) so that mod-switch rounding lands mid-window.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from poulpy_tpu_torch.core.layouts import _Replace
from poulpy_tpu_torch.hal.normalization import vec_znx_normalize
from poulpy_tpu_torch.hal.vec_znx import vec_znx_rotate


@dataclass(frozen=True)
class LookupTable(_Replace):
    """data [ext, size, N]; rot_dir "left" rotates by X^{-dec(lwe)}, "right"
    by X^{+dec(lwe)}."""

    data: torch.Tensor
    base2k: int
    k: int
    drift: int = 0
    rot_dir: str = "left"

    @property
    def n(self) -> int:
        return self.data.shape[-1]

    @property
    def extension_factor(self) -> int:
        return self.data.shape[0]

    @property
    def domain_size(self) -> int:
        return self.n * self.extension_factor

    @property
    def size(self) -> int:
        return self.data.shape[-2]


def _single_poly(extension_factor: int) -> None:
    if extension_factor != 1:
        raise NotImplementedError(
            "lookup tables over several polynomials (extension_factor > 1) are not ported")


def lookup_table_new(n: int, base2k: int, k: int, f, f_k: int, extension_factor: int = 1,
                     rot_dir: str = "left", device="cuda") -> LookupTable:
    """A LUT from integer samples `f` at precision `f_k`, on `device`."""
    _single_poly(extension_factor)
    f = np.asarray(f, dtype=np.int64)
    size = -(-k // base2k)
    limbs = -(-f_k // base2k)
    if len(f) > n:
        raise ValueError(f"{len(f)} samples do not fit a domain of {n}")
    scale = 1 << (base2k - f_k % base2k) if f_k % base2k else 1
    step = (n + len(f) // 2) // len(f)
    lut_full = np.zeros((size, n), dtype=np.int64)
    for i, fi in enumerate(f):
        lut_full[limbs - 1, i * step : (i + 1) * step] = fi * scale
    data = vec_znx_normalize(base2k, torch.from_numpy(lut_full)[None].to(device))
    lut = LookupTable(data=data, base2k=base2k, k=k, drift=step >> 1, rot_dir=rot_dir)
    return lookup_table_rotate(lut, -lut.drift)


def lookup_table_rotate(lut: LookupTable, k: int) -> LookupTable:
    """The LUT times X^k."""
    _single_poly(lut.extension_factor)
    return lut.replace(data=vec_znx_rotate(k % (2 * lut.n), lut.data))
