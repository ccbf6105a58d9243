"""DFT-domain operations: dft/idft, SVP, VMP, the bivariate convolution and
big-accumulator ops, with the wide (i128-twin) exit of `hal/wide.py`.

Twin of `poulpy_tpu/hal/dft.py` (the part the port needs), on the CRT-NTT
domain of `hal.ntt`.  Shapes (leading axes broadcast for batching):

  vec_znx       [..., size, N]            int64 limbs
  vec_znx_dft   [..., size, P, N]         int32 residues, standard form
  svp_ppol      [..., P, N]               int32 residues, Montgomery form
  vmp_pmat      [rows, cols_in, cols_out, size, P, N]  int32, Montgomery form
  vec_znx_big   [..., size, N]            int64 wrapping accumulators

The NTT and the VMP go through `backends/`: plain PyTorch for CPU tensors,
the CUDA kernels for CUDA tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from poulpy_tpu_torch.backends import ntt as _ntt
from poulpy_tpu_torch.backends import vmp as _vmp
from poulpy_tpu_torch.hal.module import Module
from poulpy_tpu_torch.hal.normalization import vec_znx_normalize_full
from poulpy_tpu_torch.hal.ntt import (
    add_mod,
    fold_mod,
    garner_lift,
    mont_mul,
    sub_mod,
    to_mont,
    to_residues,
)
from poulpy_tpu_torch.hal.wide import garner_lift_wide, vec_znx_normalize_full_wide
from poulpy_tpu_torch.hal.znx import znx_automorphism


def dft_limbs(a_size: int, step: int, offset: int, res_size: int | None):
    """Input limbs `offset + j·step` that `dft_apply` transforms, and the
    output limb count (limbs past the input are zero)."""
    steps = -(-a_size // step)
    if res_size is None:
        res_size = steps
    idx = [offset + j * step for j in range(min(res_size, steps)) if offset + j * step < a_size]
    return idx, res_size


def dft_apply(module: Module, a, step: int = 1, offset: int = 0, res_size: int | None = None):
    """vec_znx → vec_znx_dft with (step, offset) limb subsampling:
    res[j] = NTT(a[offset + j·step]) where that limb exists, else 0."""
    t = module.tables
    idx, res_size = dft_limbs(a.shape[-2], step, offset, res_size)
    r = _ntt.ntt_forward(t, to_residues(t, a[..., idx, :]))
    if len(idx) < res_size:
        r = F.pad(r, (0, 0, 0, 0, 0, res_size - len(idx)))
    return r


def idft_apply(module: Module, a_dft):
    """vec_znx_dft → vec_znx_big: inverse NTT + centred CRT lift."""
    t = module.tables
    return garner_lift(t, _ntt.ntt_inverse(t, a_dft.contiguous()))


def dft_copy(a_dft, step: int = 1, offset: int = 0, res_size: int | None = None):
    """Limb subsampling in the DFT domain: res[j] = a[offset + j·step] where
    that limb exists, else 0."""
    a_size = a_dft.shape[-3]
    steps = -(-a_size // step)
    if res_size is None:
        res_size = steps
    zero = torch.zeros_like(a_dft[..., 0, :, :])
    limbs = []
    for j in range(res_size):
        limb = offset + j * step
        limbs.append(a_dft[..., limb, :, :] if j < steps and limb < a_size else zero)
    return torch.stack(limbs, dim=-3)


def _align_limbs(a, b, res_size, limb_axis=-3):
    """Cut or zero-pad both inputs to `res_size` limbs along `limb_axis`."""
    def pad(x):
        axis = limb_axis % x.dim()
        size = x.shape[axis]
        if size >= res_size:
            return x.narrow(axis, 0, res_size)
        pads = [0, 0] * (x.dim() - 1 - axis) + [0, res_size - size]
        return F.pad(x, pads)

    return pad(a), pad(b)


def dft_add(module: Module, a_dft, b_dft, res_size: int | None = None):
    """Sum over the common limbs, copy the longer operand's tail."""
    if res_size is None:
        res_size = max(a_dft.shape[-3], b_dft.shape[-3])
    a, b = _align_limbs(a_dft, b_dft, res_size)
    return add_mod(a, b, module.tables.p[:, None])


def dft_sub(module: Module, a_dft, b_dft, res_size: int | None = None):
    """Difference over the common limbs, the longer operand's tail copied
    (negated from `b`)."""
    if res_size is None:
        res_size = max(a_dft.shape[-3], b_dft.shape[-3])
    a, b = _align_limbs(a_dft, b_dft, res_size)
    return sub_mod(a, b, module.tables.p[:, None])


def svp_prepare(module: Module, s):
    """Scalar poly `[..., N]` → Montgomery NTT form `[..., P, N]`."""
    t = module.tables
    return to_mont(t, _ntt.ntt_forward(t, to_residues(t, s)))


def svp_apply(module: Module, a_dft, s_ppol):
    """Pointwise product res[j] = a[j] ⊙ s, broadcast over limbs."""
    t = module.tables
    return mont_mul(a_dft, s_ppol[..., None, :, :], t.p[:, None], t.qinv[:, None])


def vmp_prepare(module: Module, mat):
    """MatZnx `[rows, cols_in, cols_out, size, N]` → Montgomery NTT pmat."""
    t = module.tables
    return to_mont(t, _ntt.ntt_forward(t, to_residues(t, mat)))


def vmp_apply(module: Module, a_dft, pmat, limb_offset: int = 0, res_size: int | None = None):
    """res[..., co, j, p, n] = Σ_{ci, r} a[..., ci, r, p, n] ·
    pmat[r, ci, co, j + limb_offset, p, n] · R^{-1} mod p."""
    return _vmp.vmp_apply(module, a_dft, pmat, limb_offset, res_size)


def cnv_prepare_left(module: Module, a):
    """Left operand of the bivariate convolution: standard-form NTT of each limb."""
    t = module.tables
    return _ntt.ntt_forward(t, to_residues(t, a))


def cnv_prepare_right(module: Module, b):
    """Right operand: Montgomery-form NTT of each limb."""
    t = module.tables
    return to_mont(t, _ntt.ntt_forward(t, to_residues(t, b)))


def cnv_apply(module: Module, a_prep, b_prep, res_size: int):
    """res[k] = Σ_{i+j=k} a[i]·b[j]: the convolution over the limb index with
    a negacyclic ring product per term (a standard form, b Montgomery form),
    summed lazily in int64 and folded once per output limb."""
    t = module.tables
    p = t.p[:, None]
    qinv = t.qinv[:, None]
    a_size, b_size = a_prep.shape[-3], b_prep.shape[-3]
    out = []
    for k in range(res_size):
        acc = None
        for i in range(a_size):
            j = k - i
            if 0 <= j < b_size:
                prod = mont_mul(a_prep[..., i, :, :], b_prep[..., j, :, :], p, qinv).to(torch.int64)
                acc = prod if acc is None else acc + prod
        if acc is None:
            acc = torch.zeros(torch.broadcast_shapes(a_prep.shape[:-3], b_prep.shape[:-3])
                              + a_prep.shape[-2:], dtype=a_prep.dtype, device=a_prep.device)
        else:
            acc = fold_mod(acc, p, qinv, t.r2[:, None]).to(a_prep.dtype)
        out.append(acc)
    return torch.stack(out, dim=-3)


def big_add(a, b, res_size: int | None = None):
    if res_size is None:
        res_size = max(a.shape[-2], b.shape[-2])
    a, b = _align_limbs(a, b, res_size, limb_axis=-2)
    return a + b


def big_sub(a, b, res_size: int | None = None):
    if res_size is None:
        res_size = max(a.shape[-2], b.shape[-2])
    a, b = _align_limbs(a, b, res_size, limb_axis=-2)
    return a - b


def big_automorphism(p: int, a):
    """X → X^p on every limb of a big accumulator."""
    return znx_automorphism(p, a)


def big_normalize(module: Module, res_size: int, res_base2k: int, a_big, a_base2k: int,
                  res_offset: int = 0):
    """Carry-normalize the big accumulator into `res_size` limbs of base
    2^res_base2k, with an optional power-of-two offset."""
    del module
    return vec_znx_normalize_full(res_size, res_base2k, res_offset, a_big, a_base2k)


def product_bits(base2k_a: int, base2k_b: int, log_n: int, terms: int) -> int:
    """Upper bound (bits) on |Σ negacyclic products| of `terms` pairs of
    normalized limbs, plus one sign bit."""
    return (base2k_a - 1) + (base2k_b - 1) + log_n + max(0, terms - 1).bit_length() + 1


def needs_wide(bits: int) -> bool:
    """True when a big-accumulator bound exceeds the exact int64 range of
    `garner_lift` (the wide i128-twin path of `hal/wide.py` then runs)."""
    return bits > 62


def idft_apply_wide(module: Module, a_dft):
    """vec_znx_dft → wide big (hi, lo) int64 pairs: idft_apply's i128 twin."""
    t = module.tables
    return garner_lift_wide(t, _ntt.ntt_inverse(t, a_dft.contiguous()))


def big_normalize_wide(module: Module, res_size: int, res_base2k: int, pair, a_base2k: int,
                       res_offset: int = 0):
    del module
    return vec_znx_normalize_full_wide(res_size, res_base2k, res_offset, pair, a_base2k)

