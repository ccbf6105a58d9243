"""The fused product and the block-binary CGGI step through the four-step
digit-plane transforms (`csrc/fused_mxu.cu`) and their plain PyTorch twins.

Replaces `poulpy_tpu/backends/pallas_fused_mxu.py` (`_pipe_mxu_fn` →
`_kernel_pipe_mxu`), its three call patterns:

- `fused_mxu_glwe_product`, the product and `small` patterns:

      limbs (wrapped to int32) ──four-step forward (4 planes)──► σ residues
      ──VMP with the σ-permuted matrix──► four-step inverse ──► Garner lift
      ──(+ small at column 0)──► normalize

  counters `fused_mxu_product` and `fused_mxu_product_small`;
- `fused_mxu_br_block_step`, the block step (block > 1, rotate, add_acc):
  the same transforms around Σ_i NTT(X^{a_i} − 1)·(NTT(acc) ⊡ BRK_i) in σ
  order, plus acc, normalized; counter `fused_mxu_br_block_step`.

One launch for a batch.  The results equal `fused.fused_glwe_product`'s and
`fused.fused_br_block_step`'s for limbs in int32 range (the σ relabeling
cancels between the forward, the permuted operands and the inverse).
Where a block's rows do not fit in shared memory, the kernel takes its
global layout (`mxu_layout`).
"""

from __future__ import annotations

import torch

from poulpy_tpu_torch.backends import LAUNCHES, _lib
from poulpy_tpu_torch.backends.fused import (
    Layout,
    _body,
    _check_bounds,
    fused_supported,
    garner_exit_ref,
    kernel_layout,
    launch_workspace,
    pm_kernel_layout,
    xpow_minus1_sigma,
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
from poulpy_tpu_torch.hal.normalization import vec_znx_normalize_full
from poulpy_tpu_torch.hal.ntt import add_mod, garner_lift, mont_mul


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


def mxu_layout(kk: int, co: int, psize: int, nprimes: int, n: int, split: bool = True) -> Layout:
    """The kernel's layout: the shared one with the most output columns per
    block that fit (all co for the block step, `split` False); else the
    global one, whose workspace slot holds the KK σ residues and the
    P·co·psize coefficient residues, and whose stage holds the two operand
    planes of `chunk` rows (padded to an even count where N/n1 < 16)."""
    n2 = _split(n)[1]

    def stage(rows):
        return sum(_planes_bytes(rows if n2 % 16 == 0 else rows + rows % 2, n))

    return kernel_layout(co, lambda cpb: fused_mxu_smem_bytes(kk, cpb * psize, nprimes, n), split,
                         kk + nprimes * co * psize, stage, max(kk, co * psize))


def _launch(module: Module, a, pm, small, s_size: int, xpm1, amounts, out, ci: int, rmax: int,
            co: int, psize: int, res_size: int, kr: int, ka: int, block: int, lay: Layout) -> None:
    """One launch of the kernel (block 0: the product patterns)."""
    t, n = module.tables, module.n
    B, size_a = a.shape[0], a.shape[-2]
    kk = ci * rmax
    s_bytes = (fused_mxu_stage_bytes(kk, lay.cpb * psize, n) if lay.kind == "shared"
               else lay.smem)
    tabs = device_tables(t)
    _, consts = kernel_tables(t)
    ws, grid = launch_workspace(lay, B * (co // lay.cpb), n, a.device)
    err = _lib.library().poulpy_fused_mxu_product(
        a.data_ptr(), pm.data_ptr(), _lib.ptr(small), _lib.ptr(xpm1), _lib.ptr(amounts),
        out.data_ptr(), tabs["ua"].data_ptr(), tabs["v0"].data_ptr(), tabs["tf"].data_ptr(),
        tabs["wa"].data_ptr(), tabs["w0"].data_ptr(), tabs["ti"].data_ptr(), consts.data_ptr(), B,
        ci, size_a, rmax, co, psize, s_size, res_size, kr, ka, lay.cpb, block, module.nprimes,
        module.log_n, s_bytes, lay.smem, _lib.ptr(ws), lay.chunk, grid, _lib.stream())
    _lib.check(err, "poulpy_fused_mxu_product")


def fused_mxu_glwe_product(module: Module, a_data, pmat, res_size: int, res_base2k: int,
                           pm_base2k: int, small=None, pm_k=None):
    """`a_data` [..., ci, size_a, N] int64 limbs (int32 range; wider values
    wrap to int32) × `pmat` [rows, ci, co, psize, P, N] (Montgomery, butterfly
    order) → [..., co, res_size, N] normalized int64 limbs; `small`
    [..., s_size, N] int64, if given, is added to column 0.  `pm_k` [P,
    ci·rmax, co·psize, N] int32: `pmat` in σ order and kernel layout
    (`pm_kernel_layout(pmat[..., σ], rmax)`), made from `pmat` when not
    given.  Plain version on CPU tensors, one CUDA launch on CUDA."""
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
    lay = mxu_layout(kk, co, psize, P, n)
    _check_bounds(P, psize, res_size)
    if pmat.device != a_data.device or module.device != a_data.device:
        raise ValueError("a_data, pmat and module must be on one device")
    if pm_k is None:
        pm_k = pm_kernel_layout(pmat[..., sigma_index(t)], rmax)
    if tuple(pm_k.shape) != (P, kk, co * psize, n):
        raise ValueError(f"pm_k: expected {(P, kk, co * psize, n)}, got {tuple(pm_k.shape)}")
    _lib.require(pm_k, "pm_k", torch.int32)
    B = a_data.numel() // (ci * a_size * n) if a_data.numel() else 0
    a = a_data.reshape(B, ci, a_size, n).contiguous()
    _lib.require(a, "a_data", torch.int64)
    small, s_size, _ = _body(small, lead, B, n)
    out = torch.empty(lead + (co, res_size, n), dtype=torch.int64, device=a_data.device)
    if B == 0:
        return out
    _launch(module, a, pm_k, small, s_size, None, None, out, ci, rmax, co, psize, res_size,
            res_base2k, pm_base2k, 0, lay)
    LAUNCHES["fused_mxu_product_small" if small is not None else "fused_mxu_product"] += 1
    return out


# --------------------------------------------------------------------------
# Block-binary CGGI step
# --------------------------------------------------------------------------

def fused_mxu_br_block_step_ref(module: Module, acc, pmats, a_blk, res_size: int, base2k: int):
    """Plain version of the block step: the plain forward of acc's first
    rmax limbs (wrapped to int32, 4 digit planes), per key element the plain
    VMP with the σ-permuted BRK_i times the σ-order NTT(X^{a_i} − 1) row,
    the sum over the block, the plain inverse, the Garner lift, + acc's
    limbs wrapped to int32 (limb j < min(size, psize) of each column, as the
    TPU kernel adds them), normalized to `res_size` limbs."""
    t, n = module.tables, module.n
    sig = sigma_index(t)
    rmax = min(pmats.shape[1], acc.shape[-2])
    res = mxu4_forward_limbs_ref(t, acc[..., :rmax, :], NDIG)
    xpm1 = xpow_minus1_sigma(module)
    p, qinv = t.p[:, None], t.qinv[:, None]
    add = None
    for i in range(pmats.shape[0]):
        xp = xpm1[a_blk[..., i] & (2 * n - 1)]                      # [..., P, N]
        term = mont_mul(vmp_apply_ref(module, res, pmats[i][..., sig]), xp[..., None, None, :, :],
                        p, qinv)
        add = term if add is None else add_mod(add, term, p)
    big = garner_lift(t, mxu4_inverse_ref(t, add))
    m = min(acc.shape[-2], big.shape[-2])
    big[..., :m, :] += acc[..., :m, :].to(torch.int32).to(torch.int64)
    return vec_znx_normalize_full(res_size, base2k, 0, big, base2k)


def fused_mxu_br_block_step(module: Module, acc, pmats, a_blk, res_size: int, base2k: int,
                            pm_k=None):
    """One block-binary CGGI step for a batch through the four-step
    transforms: `fused.fused_br_block_step`'s arguments and, for acc limbs
    in int32 range, its result.

    acc    [..., cols, size, N] int64 limbs (wrapped to int32);
    pmats  [block, rows, cols, cols, psize, P, N] the block's prepared BRK
           elements (Montgomery, butterfly order);
    a_blk  [..., block] int64 mod-switched rotation amounts, any sign;
    pm_k   [block, P, cols·rmax, cols·psize, N] int32: `pmats` in σ order
           and kernel layout (`pm_kernel_layout(pmats[..., σ], rmax)`),
           made from `pmats` when not given.
    → [..., cols, res_size, N] normalized limbs.  Plain version on CPU
    tensors, one CUDA launch on CUDA (the x-power factor gathered in the
    kernel from the σ-order `xpow_minus1_sigma` table by `a & (2N − 1)`)."""
    block, rows, cols, co, psize = pmats.shape[:5]
    if not fused_mxu_supported(module, psize, base2k):
        raise ValueError(f"fused_mxu: psize {psize}, base2k {base2k}, N {module.n} outside the "
                         "route's conditions")
    if acc.device.type == "cpu":
        return fused_mxu_br_block_step_ref(module, acc, pmats, a_blk, res_size, base2k)
    t, P, n = module.tables, module.nprimes, module.n
    lead, size = acc.shape[:-3], acc.shape[-2]
    rmax = min(rows, size)
    kk, mdim = cols * rmax, cols * psize
    if co != cols or acc.shape[-3] != cols or acc.shape[-1] != n:
        raise ValueError(f"acc {tuple(acc.shape)} does not match the key's {cols} columns")
    if tuple(a_blk.shape) != tuple(lead) + (block,):
        raise ValueError(f"a_blk: expected {tuple(lead) + (block,)}, got {tuple(a_blk.shape)}")
    lay = mxu_layout(kk, cols, psize, P, n, split=False)
    _check_bounds(P, psize, res_size)
    if pm_k is None:
        pm_k = pm_kernel_layout(pmats[..., sigma_index(t)], rmax)
    if tuple(pm_k.shape) != (block, P, kk, mdim, n):
        raise ValueError(f"pm_k: expected {(block, P, kk, mdim, n)}, got {tuple(pm_k.shape)}")
    B = acc.numel() // (cols * size * n) if acc.numel() else 0
    a = acc.reshape(B, cols, size, n).contiguous()
    amounts = a_blk.reshape(B, block).contiguous()
    _lib.require(a, "acc", torch.int64)
    _lib.require(amounts, "a_blk", torch.int64)
    _lib.require(pm_k, "pm_k", torch.int32)
    if module.device != acc.device or pm_k.device != acc.device:
        raise ValueError("acc, pm_k and module must be on one device")
    out = torch.empty(lead + (cols, res_size, n), dtype=torch.int64, device=acc.device)
    if B == 0:
        return out
    _launch(module, a, pm_k, None, 0, xpow_minus1_sigma(module), amounts, out, cols, rmax, cols,
            psize, res_size, base2k, base2k, block, lay)
    LAUNCHES["fused_mxu_br_block_step"] += 1
    return out
