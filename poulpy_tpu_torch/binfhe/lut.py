"""Lookup tables for blind rotation: twin of `poulpy_tpu/binfhe/lut.py`.

A LUT encodes f: Z_{2N·ext} → T as `extension_factor` (ext) limb-vector
polynomials: each of the f_len function samples covers step = N·ext/f_len
consecutive coefficients, scaled to the requested torus precision, and the
whole table is pre-rotated by half a step (the `drift`) so that mod-switch
rounding lands mid-window.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from poulpy_tpu_torch.core.layouts import _Replace
from poulpy_tpu_torch.hal.normalization import vec_znx_normalize
from poulpy_tpu_torch.hal.vec_znx import vec_znx_rotate, vec_znx_switch_ring


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


def lookup_table_new(n: int, base2k: int, k: int, f, f_k: int, extension_factor: int = 1,
                     rot_dir: str = "left", device="cuda") -> LookupTable:
    """A LUT from integer samples `f` at precision `f_k`, on `device`: the
    table over the domain N·ext, then (ext > 1) its part i is every ext-th
    coefficient of the table times X^{-i}."""
    f = np.asarray(f, dtype=np.int64)
    size = -(-k // base2k)
    limbs = -(-f_k // base2k)
    domain = n * extension_factor
    if len(f) > domain:
        raise ValueError(f"{len(f)} samples do not fit a domain of {domain}")
    scale = 1 << (base2k - f_k % base2k) if f_k % base2k else 1
    step = (domain + len(f) // 2) // len(f)
    lut_full = np.zeros((size, domain), dtype=np.int64)
    for i, fi in enumerate(f):
        lut_full[limbs - 1, i * step : (i + 1) * step] = fi * scale
    cur = torch.from_numpy(lut_full).to(device)
    polys = []
    for _ in range(extension_factor):
        polys.append(vec_znx_switch_ring(n, cur))
        cur = vec_znx_rotate(-1, cur)
    data = vec_znx_normalize(base2k, torch.stack(polys))
    lut = LookupTable(data=data, base2k=base2k, k=k, drift=step >> 1, rot_dir=rot_dir)
    return lookup_table_rotate(lut, -lut.drift)


def lookup_table_rotate(lut: LookupTable, k: int) -> LookupTable:
    """The LUT times X^k in the ring of degree N·ext: with k mod 2N·ext =
    hi·ext + lo, part i rotates by X^{hi + (i ≥ ext − lo)}, then the parts
    roll by lo."""
    ext = lut.extension_factor
    k_hi, k_lo = divmod(k % (2 * lut.n * ext), ext)
    parts = [vec_znx_rotate(k_hi + (1 if i >= ext - k_lo else 0), lut.data[i]) for i in range(ext)]
    return lut.replace(data=torch.roll(torch.stack(parts), k_lo, dims=0))
