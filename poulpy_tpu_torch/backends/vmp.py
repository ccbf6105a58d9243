"""Vector-matrix product (VMP): CUDA kernel (`csrc/vmp.cu`) and its plain
PyTorch twin.

Replaces `poulpy_tpu/backends/pallas_vmp.py` (`_vmp_fn` → `_vmp_kernel`,
entry `pallas_vmp_apply`).  Both compute, per prime,

    res[..., co, j, p, n] = Σ_{ci, r} a[..., ci, r, p, n] · pmat[r, ci, co, j + limb_offset, p, n] · R^{-1} mod p

on int32 residues, with `pmat` in Montgomery form.

The kernel has two designs (`csrc/vmp.cu`): the tile design, which the
paths run (one thread per column, its pm words in registers, a chunk of
batch rows per block, `tile_layout`), and the parent design (one thread per
output word), kept as the reference and reached only through the
keyword-only `design="parent"` of `vmp_kernel` / `vmp_apply`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from poulpy_tpu_torch.backends import LAUNCHES, _lib
from poulpy_tpu_torch.backends.ntt import kernel_tables
from poulpy_tpu_torch.hal.module import Module
from poulpy_tpu_torch.hal.ntt import fold_mod, mont_mul


def _windows(a_dft, pmat, limb_offset, res_size):
    rows, cols_in, cols_out, psize = pmat.shape[:4]
    if a_dft.shape[-4] != cols_in:
        raise ValueError(f"a_dft has {a_dft.shape[-4]} columns, pmat takes {cols_in}")
    if res_size is None:
        res_size = psize
    rmax = min(rows, a_dft.shape[-3])
    out_cols = max(0, min(psize - limb_offset, res_size))
    return rmax, out_cols, res_size


def _zeros(module, a_dft, cols_out, res_size):
    return torch.zeros(a_dft.shape[:-4] + (cols_out, res_size, module.nprimes, module.n),
                       dtype=a_dft.dtype, device=a_dft.device)


def _pad_limbs(res, out_cols, res_size):
    if out_cols < res_size:
        res = F.pad(res, (0, 0, 0, 0, 0, res_size - out_cols))
    return res


def vmp_apply_ref(module: Module, a_dft, pmat, limb_offset: int = 0, res_size: int | None = None):
    """Plain version: one Montgomery product per (gadget row, term), summed
    lazily in int64 and folded once."""
    t = module.tables
    cols_out = pmat.shape[2]
    rmax, out_cols, res_size = _windows(a_dft, pmat, limb_offset, res_size)
    if out_cols == 0 or rmax == 0:
        return _zeros(module, a_dft, cols_out, res_size)
    p = t.p[:, None]
    qinv = t.qinv[:, None]
    acc = None
    for r in range(rmax):
        a_r = a_dft[..., :, r, None, None, :, :]          # [..., ci, 1, 1, P, N]
        pm_r = pmat[r, :, :, limb_offset : limb_offset + out_cols]  # [ci, co, j, P, N]
        prod = mont_mul(a_r, pm_r, p, qinv)
        s = torch.sum(prod.to(torch.int64), dim=-5)       # over ci
        acc = s if acc is None else acc + s
    res = fold_mod(acc, p, t.qinv[:, None], t.r2[:, None]).to(a_dft.dtype)
    return _pad_limbs(res, out_cols, res_size)


# (K, M) of the tile design's specialised instances (csrc/vmp.cu VmpShape):
# the "mxu" route's product and keyswitch, the non-wide CKKS mul
VMP_SHAPES = ((6, 8), (3, 8), (6, 12))
TILE_COLS = 128          # columns (threads) per block of the tile design
TILE_ROWS_MAX = 64       # batch rows per block at most
TILE_MIN_BLOCKS = 528    # four blocks per SM of the H100 where the batch allows
GRID_Y_MAX = 65535


def tile_layout(B: int, P: int, n: int) -> tuple[int, int, int]:
    """(rows per block, column blocks, row blocks) of the tile design: the
    most rows up to TILE_ROWS_MAX that still give TILE_MIN_BLOCKS blocks, at
    least one, and few enough row blocks for the grid's y limit."""
    col_blocks = -(-(P * n) // TILE_COLS)
    rows = max(1, min(TILE_ROWS_MAX, B * col_blocks // TILE_MIN_BLOCKS), -(-B // GRID_Y_MAX))
    return rows, col_blocks, -(-B // rows)


def vmp_kernel(module: Module, a, pm, *, design: str = "tile"):
    """Launch the CUDA VMP: a [B, K, P, N] × pm [K, M, P, N] → [B, M, P, N],
    all int32, pm in Montgomery form; `design` "tile" (the paths) or
    "parent" (the reference, for the comparisons of chip_smoke.py and the
    tests).  Counts a launch of the tile design only."""
    P, n = module.nprimes, module.n
    _lib.require(a, "a", torch.int32)
    _lib.require(pm, "pm", torch.int32)
    if a.dim() != 4 or tuple(a.shape[2:]) != (P, n):
        raise ValueError(f"a: expected [B, K, {P}, {n}], got {tuple(a.shape)}")
    B, K = a.shape[:2]
    if pm.dim() != 4 or pm.shape[0] != K or tuple(pm.shape[2:]) != (P, n):
        raise ValueError(f"pm: expected [{K}, M, {P}, {n}], got {tuple(pm.shape)}")
    M = pm.shape[1]
    out = torch.empty((B, M, P, n), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    _, consts = kernel_tables(module.tables)
    if design == "parent":
        err = _lib.library().poulpy_vmp(a.data_ptr(), pm.data_ptr(), out.data_ptr(),
                                        consts.data_ptr(), B, K, M, P, n, _lib.stream())
        _lib.check(err, "poulpy_vmp")
        return out
    if design != "tile":
        raise ValueError(f"unknown design {design!r}")
    rows = tile_layout(B, P, n)[0]
    err = _lib.library().poulpy_vmp_tile(a.data_ptr(), pm.data_ptr(), out.data_ptr(),
                                         consts.data_ptr(), B, K, M, P, n, rows, _lib.stream())
    _lib.check(err, "poulpy_vmp_tile")
    LAUNCHES["vmp"] += 1
    return out


def vmp_apply(module: Module, a_dft, pmat, limb_offset: int = 0, res_size: int | None = None,
              *, design: str = "tile"):
    """hal-layout VMP: plain version on CPU tensors, the CUDA kernel on CUDA
    (`design` as `vmp_kernel`'s)."""
    if a_dft.device.type == "cpu":
        return vmp_apply_ref(module, a_dft, pmat, limb_offset, res_size)
    P, n = module.nprimes, module.n
    cols_in, cols_out = pmat.shape[1:3]
    rmax, out_cols, res_size = _windows(a_dft, pmat, limb_offset, res_size)
    if out_cols == 0 or rmax == 0:
        return _zeros(module, a_dft, cols_out, res_size)
    lead = a_dft.shape[:-4]
    kdim, mdim = cols_in * rmax, cols_out * out_cols
    # a: [..., ci, r, P, N] → [B, ci·r, P, N]; pm: [r, ci, co, j, P, N] → [ci·r, co·j, P, N]
    a = a_dft[..., :rmax, :, :].reshape(-1, kdim, P, n).contiguous()
    pm = pmat[:rmax, :, :, limb_offset : limb_offset + out_cols].transpose(0, 1)
    pm = pm.reshape(kdim, mdim, P, n).contiguous()
    res = vmp_kernel(module, a, pm, design=design).reshape(lead + (cols_out, out_cols, P, n))
    return _pad_limbs(res, out_cols, res_size)
