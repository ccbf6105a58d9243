"""The fused product through the four-step digit-plane transforms
(`csrc/fused_mxu.cu`) and its plain PyTorch twin.

Replaces `poulpy_tpu/backends/pallas_fused_mxu.py` (`_pipe_mxu_fn` →
`_kernel_pipe_mxu` via `fused_mxu_glwe_product`), the product and `small`
call patterns:

    limbs (wrapped to int32) ──four-step forward (4 planes)──► σ residues
    ──VMP with the σ-permuted matrix──► four-step inverse ──► Garner lift
    ──(+ small at column 0)──► normalize

in one launch for a batch; counters `fused_mxu_product` and
`fused_mxu_product_small`.  The result equals `fused.fused_glwe_product`'s
for limbs in int32 range (the σ relabeling cancels between the forward, the
permuted matrix and the inverse).  The block-step pattern
(`fused_mxu_br_block_step`) is not ported yet; the kernel takes its
parameters as template parameters.
"""

from __future__ import annotations

import torch

from poulpy_tpu_torch.backends import LAUNCHES, _lib
from poulpy_tpu_torch.backends.fused import (
    _body,
    _check_bounds,
    cols_per_block,
    fused_supported,
    garner_exit_ref,
    pm_kernel_layout,
)
from poulpy_tpu_torch.backends.mxu import (
    PAD,
    device_tables,
    mxu4_forward_limbs_ref,
    mxu4_inverse_ref,
    sigma_index,
)
from poulpy_tpu_torch.backends.mxu_ntt import NDIG
from poulpy_tpu_torch.backends.mxu_ntt4 import _split
from poulpy_tpu_torch.backends.ntt import kernel_tables
from poulpy_tpu_torch.backends.vmp import vmp_apply_ref
from poulpy_tpu_torch.hal.module import Module


def fused_mxu_supported(module: Module, psize: int, res_base2k: int) -> bool:
    """The JAX package's condition: the fused exit's window arithmetic, and
    N ≥ 256 (a four-step split with n1 ≥ 32)."""
    return fused_supported(psize, res_base2k) and module.n >= 256


def fused_mxu_glwe_product_ref(module: Module, a_data, pmat, res_size: int, res_base2k: int,
                               pm_base2k: int, small=None):
    """Plain version: the plain forward of the limbs (4 digit planes), the
    plain VMP with the σ-permuted matrix, the plain inverse, `garner_exit_ref`."""
    t = module.tables
    rmax = min(pmat.shape[0], a_data.shape[-2])
    res = mxu4_forward_limbs_ref(t, a_data[..., :rmax, :], NDIG)
    prod = vmp_apply_ref(module, res, pmat[..., sigma_index(t)])
    return garner_exit_ref(module, mxu4_inverse_ref(t, prod), pmat.shape[3], res_size,
                           res_base2k, pm_base2k, small)


def _planes_bytes(rows: int, n: int) -> tuple[int, int]:
    """Bytes of the int8 operands of `rows` rows (csrc/mxu.cuh
    planes_a_bytes / planes_b_bytes)."""
    n1, n2 = _split(n)
    return rows * n1 * (NDIG * n2 + PAD), rows * n2 * (NDIG * n1 + PAD)


def fused_mxu_stage_bytes(kk: int, mrows: int, n: int) -> int:
    """The kernel's staging region: each stage's input and output side by
    side (input planes and step-A planes; those and the σ residues; the
    residues and the VMP's planes; those and the inverse step-A planes; those
    and the coefficient residues), rows padded to an even count."""
    kkp, mrp = kk + kk % 2, mrows + mrows % 2
    pa_k, pb_k = _planes_bytes(kkp, n)
    pa_m, pb_m = _planes_bytes(mrp, n)
    res_k, res_m = 4 * kk * n, 4 * mrows * n
    return max(pa_k + pb_k, pb_k + res_k, res_k + pb_m, pb_m + pa_m, pa_m + res_m)


def fused_mxu_smem_bytes(kk: int, mrows: int, nprimes: int, n: int) -> int:
    """Shared memory of one block: the coefficient residues of primes
    0..P−2 (kept for the Garner lift), then the staging region."""
    return 4 * (nprimes - 1) * mrows * n + fused_mxu_stage_bytes(kk, mrows, n)


def fused_mxu_glwe_product(module: Module, a_data, pmat, res_size: int, res_base2k: int,
                           pm_base2k: int, small=None):
    """`a_data` [..., ci, size_a, N] int64 limbs (int32 range; wider values
    wrap to int32) × `pmat` [rows, ci, co, psize, P, N] (Montgomery, butterfly
    order) → [..., co, res_size, N] normalized int64 limbs; `small`
    [..., s_size, N] int64, if given, is added to column 0.  Plain version on
    CPU tensors, one CUDA launch on CUDA."""
    rows, ci, co, psize = pmat.shape[:4]
    if not fused_mxu_supported(module, psize, res_base2k):
        raise ValueError(f"fused_mxu: psize {psize}, res_base2k {res_base2k}, N {module.n} "
                         "outside the route's conditions")
    if a_data.device.type == "cpu":
        return fused_mxu_glwe_product_ref(module, a_data, pmat, res_size, res_base2k,
                                          pm_base2k, small)
    t, P, n = module.tables, module.nprimes, module.n
    lead, a_size = a_data.shape[:-3], a_data.shape[-2]
    rmax = min(rows, a_size)
    kk = ci * rmax
    if a_data.shape[-3] != ci or a_data.shape[-1] != n:
        raise ValueError(f"a_data: expected [..., {ci}, size, {n}], got {tuple(a_data.shape)}")
    _check_bounds(P, psize, res_size, 0)
    if pmat.device != a_data.device or module.device != a_data.device:
        raise ValueError("a_data, pmat and module must be on one device")
    cpb = cols_per_block(kk, co, psize, P, n, fused_mxu_smem_bytes)
    pm = pm_kernel_layout(pmat[..., sigma_index(t)], rmax)
    B = a_data.numel() // (ci * a_size * n) if a_data.numel() else 0
    a = a_data.reshape(B, ci, a_size, n).contiguous()
    _lib.require(a, "a_data", torch.int64)
    small, s_size, sm_ptr = _body(small, lead, B, n)
    out = torch.empty(lead + (co, res_size, n), dtype=torch.int64, device=a_data.device)
    if B == 0:
        return out
    tabs = device_tables(t)
    _, consts = kernel_tables(t)
    err = _lib.library().poulpy_fused_mxu_product(
        a.data_ptr(), pm.data_ptr(), sm_ptr, out.data_ptr(), tabs["ua"].data_ptr(),
        tabs["v0"].data_ptr(), tabs["tf"].data_ptr(), tabs["wa"].data_ptr(),
        tabs["w0"].data_ptr(), tabs["ti"].data_ptr(), consts.data_ptr(), B, ci, a_size, rmax,
        co, psize, s_size, res_size, res_base2k, pm_base2k, cpb, P, module.log_n,
        fused_mxu_stage_bytes(kk, cpb * psize, n), fused_mxu_smem_bytes(kk, cpb * psize, P, n),
        _lib.stream())
    _lib.check(err, "poulpy_fused_mxu_product")
    LAUNCHES["fused_mxu_product_small" if small is not None else "fused_mxu_product"] += 1
    return out
