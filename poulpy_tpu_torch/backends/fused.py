"""Fused GLWE × GGSW product: CUDA kernel (`csrc/fused_product.cu`) and its
plain PyTorch twin.

Replaces the product call pattern of `poulpy_tpu/backends/pallas_fused.py`
(`_pipe_fn` → `_kernel_pipe` via `fused_glwe_product`: block 1, no rotate,
no `small`, no `small64`).  One launch computes, per ciphertext,

    big_normalize(idft(vmp(dft(a), pmat)))

from int64 limbs to normalized int64 limbs, for any dsize (the dsize > 1
digit grouping is folded into the matrix by `pm_kernel_layout_dsize`).  The
plain version, `fused_glwe_product_ref`, is the stage chain of
`poulpy_tpu/core/external_product.py` built from plain parts only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from poulpy_tpu_torch.backends import LAUNCHES, _lib
from poulpy_tpu_torch.backends.ntt import kernel_tables
from poulpy_tpu_torch.backends.vmp import vmp_apply_ref
from poulpy_tpu_torch.hal.dft import dft_limbs
from poulpy_tpu_torch.hal.module import Module
from poulpy_tpu_torch.hal.normalization import vec_znx_normalize_full
from poulpy_tpu_torch.hal.ntt import add_mod, garner_lift, ntt_forward, ntt_inverse, to_residues

SMEM_LIMIT = 232448     # bytes of shared memory one block may use on sm_90
MAX_PRIMES = 8          # compile-time bounds of the kernel's per-thread arrays
MAX_LIMBS = 16


def pm_kernel_layout(pmat, rmax: int):
    """[rows, ci, co, psize, P, N] Montgomery pmat → [P, KK=ci·rmax,
    M=co·psize, N] int32 (ci-major, row-minor)."""
    pm = pmat[:rmax].permute(4, 1, 0, 2, 3, 5)           # [P, ci, rmax, co, psize, N]
    P, ci, r, co, psize, n = pm.shape
    return pm.reshape(P, ci * r, co * psize, n).to(torch.int32).contiguous()


def pm_kernel_layout_dsize(pmat, rmax: int, dsize: int):
    """dsize > 1 kernel layout: input limb ℓ meets gadget row ℓ // dsize with
    the output-limb shift di = dsize−1−(ℓ mod dsize), zero past psize, so
    the grouped-limb product is one bilinear form Σ_ℓ a_ℓ · PM[ℓ, m]."""
    rows, ci, co, psize = pmat.shape[:4]
    entries = []
    zero = torch.zeros_like(pmat[0])
    for limb in range(rmax):
        r = limb // dsize
        di = dsize - 1 - (limb % dsize)
        if r >= rows or di >= psize:
            entries.append(zero)
        else:
            sl = pmat[r, :, :, di:]
            entries.append(F.pad(sl, (0, 0, 0, 0, 0, psize - sl.shape[2])))
    pm = torch.stack(entries, dim=1)                      # [ci, rmax, co, psize, P, N]
    pm = pm.permute(4, 0, 1, 2, 3, 5)                     # [P, ci, rmax, co, psize, N]
    P, ci_, r_, co_, ps, n = pm.shape
    return pm.reshape(P, ci_ * r_, co_ * ps, n).to(torch.int32).contiguous()


def _dft_plain(module, a, step=1, offset=0, res_size=None):
    t = module.tables
    idx, res_size = dft_limbs(a.shape[-2], step, offset, res_size)
    r = ntt_forward(t, to_residues(t, a[..., idx, :]))
    if len(idx) < res_size:
        r = F.pad(r, (0, 0, 0, 0, 0, res_size - len(idx)))
    return r


def fused_glwe_product_ref(module: Module, a_data, pmat, res_size: int, res_base2k: int,
                           pm_base2k: int, dsize: int = 1):
    """Plain version: dft → vmp (per digit for dsize > 1) → idft → normalize,
    every stage in plain PyTorch."""
    if dsize == 1:
        res_dft = vmp_apply_ref(module, _dft_plain(module, a_data), pmat)
    else:
        dnum, a_size = pmat.shape[0], a_data.shape[-2]
        res_dft = None
        for di in range(dsize):
            ai_size = min((a_size + di) // dsize, dnum)
            if ai_size == 0:
                continue
            ai = _dft_plain(module, a_data, dsize, dsize - 1 - di, ai_size)
            part = vmp_apply_ref(module, ai, pmat, limb_offset=di)
            res_dft = part if res_dft is None else add_mod(res_dft, part, module.tables.p[:, None])
    big = garner_lift(module.tables, ntt_inverse(module.tables, res_dft))
    return vec_znx_normalize_full(res_size, res_base2k, 0, big, pm_base2k)


def fused_smem_bytes(kk: int, mdim: int, nprimes: int, n: int) -> int:
    """Shared memory of one block: the KK input rows of one prime, then the
    M output rows of every prime (all live for the Garner lift)."""
    return 4 * n * (kk + nprimes * mdim)


def fused_glwe_product(module: Module, a_data, pmat, res_size: int, res_base2k: int,
                       pm_base2k: int, dsize: int = 1):
    """`a_data` [..., ci, size_a, N] int64 limbs × `pmat` [rows, ci, co, psize,
    P, N] → [..., co, res_size, N] normalized int64 limbs in base
    2^res_base2k.  Plain version on CPU tensors, one CUDA launch on CUDA."""
    if a_data.device.type == "cpu":
        return fused_glwe_product_ref(module, a_data, pmat, res_size, res_base2k,
                                      pm_base2k, dsize)
    P, n = module.nprimes, module.n
    rows, ci, co, psize = pmat.shape[:4]
    lead = a_data.shape[:-3]
    a_size = a_data.shape[-2]
    rmax = min(rows * dsize, a_size)
    kk, mdim = ci * rmax, co * psize
    if a_data.shape[-3] != ci or a_data.shape[-1] != n:
        raise ValueError(f"a_data: expected [..., {ci}, size, {n}], got {tuple(a_data.shape)}")
    if P > MAX_PRIMES or psize > MAX_LIMBS or res_size > MAX_LIMBS:
        raise ValueError(f"fused kernel bounds: P ≤ {MAX_PRIMES}, psize and res_size ≤ {MAX_LIMBS}")
    smem = fused_smem_bytes(kk, mdim, P, n)
    if smem > SMEM_LIMIT:
        raise ValueError(f"fused kernel needs {smem} B of shared memory > {SMEM_LIMIT}")
    if pmat.device != a_data.device or module.device != a_data.device:
        raise ValueError("a_data, pmat and module must be on one device")
    pm = pm_kernel_layout(pmat, rmax) if dsize == 1 else pm_kernel_layout_dsize(pmat, rmax, dsize)
    B = a_data.numel() // (ci * a_size * n) if a_data.numel() else 0
    a = a_data.reshape(B, ci, a_size, n)
    _lib.require(a, "a_data", torch.int64)
    out = torch.empty(lead + (co, res_size, n), dtype=torch.int64, device=a_data.device)
    if B == 0:
        return out
    if rmax == 0:
        return out.zero_()
    tw, consts = kernel_tables(module.tables)
    err = _lib.library().poulpy_fused_product(
        a.data_ptr(), pm.data_ptr(), out.data_ptr(), tw.data_ptr(), consts.data_ptr(),
        B, ci, a_size, rmax, co, psize, res_size, res_base2k, pm_base2k, P,
        module.log_n, smem, _lib.stream())
    _lib.check(err, "poulpy_fused_product")
    LAUNCHES["fused_product"] += 1
    return out
