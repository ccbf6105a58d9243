"""The fused pipeline in the sublane/lane-split layout (`csrc/fused_sl.cu`)
and its plain PyTorch twins.

Replaces the call patterns of `poulpy_tpu/backends/pallas_fused.py`
(`_pipe_fn` → `_kernel_pipe`) that `POULPY_TPU_SL=1` selects for N % 128 == 0
and N ≥ 128 (`pallas_fused.py:875-881`): every `[..., N]` operand seen as
`[..., N/128, 128]`, the transforms split into the stages across 128-wide rows
and those inside one 128-lane row (`_ntt_rows_sl`, `_intt_rows_sl`), with
Montgomery twiddle butterflies.  The switch sits in `_pipe_fn`, so it reaches
every caller of that kernel: the product with or without `small` / `small64`
(`fused_glwe_product_sl`) and the block step at steps 1 under each rot_mode
(`fused_br_block_step_sl`); the JAX kernel asserts that no chain runs in
this layout, and `steps` > 1 raises here.

The layout changes the stage schedule and the modular arithmetic, not the
result: the plain versions are `fused.fused_glwe_product_ref` and
`fused.fused_br_block_step_ref` with `ntt_rows_sl` / `intt_rows_sl` in place
of `hal.ntt`'s transforms, and they give the default pipeline's bits.  On
the card one warp owns one transform row in its registers, the stages with
half ≥ 32 pair two registers of a lane and the others two lanes through a
warp shuffle (csrc/fused_sl.cu).  A wrapper takes its plain version for a CPU
tensor and launches the kernel for a CUDA one (or raises where the kernel
does not take the shape: N outside 128..2048, rows past shared memory).
"""

from __future__ import annotations

import torch

from poulpy_tpu_torch.backends import LAUNCHES, _lib
from poulpy_tpu_torch.backends._lib import SMEM_LIMIT
from poulpy_tpu_torch.backends.fused import (
    MAX_LIMBS,
    Layout,
    _body,
    _check_bounds,
    _check_chain,
    block_rot_mode,
    fused_br_block_step_ref,
    fused_glwe_product_ref,
    pm_kernel_layout,
    pm_kernel_layout_dsize,
    xpow_shoup_table,
    xpow_tables,
)
from poulpy_tpu_torch.backends.ntt import kernel_tables
from poulpy_tpu_torch.hal.module import Module
from poulpy_tpu_torch.hal.ntt import NttTables

LANES = 128              # the TPU's lane width, the split's unit
SL_LOGN = range(7, 12)   # the kernel's N: 128 .. 2048 (csrc/fused_sl.cu poulpy_fused_sl)
SM_SMEM = 233472         # shared memory of one H100 SM, of which each block also takes 1 KB
SL_THREADS = 512         # threads of one SM's blocks (128 registers each)


def sl_applies(n: int) -> bool:
    """The JAX package's condition for the layout (`pallas_fused.py:879-880`):
    N % 128 == 0 and N ≥ 128."""
    return n % LANES == 0 and n >= LANES


# ---- the split transforms, plain ----

def _stage_twiddles(t: NttTables, inverse: bool) -> torch.Tensor:
    """Per-stage, per-point twiddles [log N, P, N] int64 (Montgomery), the JAX
    package's `_stage_twiddles`: point j of stage s carries its butterfly
    block's twiddle psi[2^s + (j >> (log N − s))]; the inverse's in execution
    order (row si is stage log N − 1 − si).  Made once per table set."""
    name = "_sl_twiddles_inv" if inverse else "_sl_twiddles"
    cached = getattr(t, name, None)
    if cached is None:
        src = (t.psi_inv_brv if inverse else t.psi_brv).to(torch.int64)
        j = torch.arange(t.n, device=src.device)
        rows = []
        for si in range(t.logn):
            s = t.logn - 1 - si if inverse else si
            rows.append(src[:, (1 << s) + (j >> (t.logn - s))])
        cached = torch.stack(rows)
        setattr(t, name, cached)
    return cached


def _consts(t: NttTables):
    """(p, qinv, lazy) of the transforms: [P, 1, 1] int64, and whether every
    prime is below 2^28 (the JAX package's `lazy_ok`: residues kept in
    [0, 2p) between stages)."""
    p = t.p.to(torch.int64)[:, None, None]
    return p, t.qinv.to(torch.int64)[:, None, None], max(t.basis.primes) < 1 << 28


def _redc(a, b, p, qinv, lazy: bool):
    """REDC_{2^30}(a·b): in [0, 2p) when `lazy` (the JAX package's
    `mont_mul_i32_lazy`, for a < 4p), else canonical (`mont_mul_i32`)."""
    x = a * b
    u = (x + (((x & ((1 << 30) - 1)) * qinv) & ((1 << 30) - 1)) * p) >> 30
    return u if lazy else torch.where(u >= p, u - p, u)


def _csub(x, m):
    return torch.where(x >= m, x - m, x)


def ntt_rows_sl(t: NttTables, x):
    """Forward negacyclic NTT of `x` [..., P, N] canonical residues in the
    split layout (`pallas_fused._ntt_rows_sl`): the stages with half ≥ 128
    on slices of [..., P, N/128, 128], those below with `torch.roll` and a
    mask inside each 128-point row; Montgomery butterflies, lazy in [0, 2p)
    for primes below 2^28.  Returns canonical residues of `x`'s dtype, equal
    to `hal.ntt.ntt_forward`'s.  N % 128 == 0."""
    n, logn = t.n, t.logn
    if not sl_applies(n):
        raise ValueError(f"the split layout needs N % 128 == 0 and N ≥ 128, got {n}")
    p, qinv, lazy = _consts(t)
    w_all = _stage_twiddles(t, False)
    S, nsub = n // LANES, (n // LANES).bit_length() - 1
    lead, P = x.shape[:-2], x.shape[-2]
    y = x.to(torch.int64).reshape(lead + (P, S, LANES))
    for s in range(nsub):                        # across 128-point rows
        hs = (n >> (s + 1)) // LANES
        parts = y.reshape(lead + (P, S // (2 * hs), 2, hs, LANES))
        lo, hi = parts[..., 0, :, :], parts[..., 1, :, :]
        w = w_all[s].reshape(P, S // (2 * hs), 2, hs, LANES)[:, :, 1]
        v = _redc(hi, w, p[..., None], qinv[..., None], lazy)
        p4 = p[..., None]
        if lazy:
            new = (_csub(lo + v, 2 * p4), _csub(lo - v + 2 * p4, 2 * p4))
        else:
            new = (_csub(lo + v, p4), torch.where(lo < v, lo - v + p4, lo - v))
        y = torch.stack(new, dim=-3).reshape(lead + (P, S, LANES))
    lane = torch.arange(LANES, device=y.device)
    for s in range(nsub, logn):                  # inside each 128-point row
        half = n >> (s + 1)
        mask = (lane & (2 * half - 1)) < half
        v = _redc(y, w_all[s].reshape(P, S, LANES), p, qinv, lazy)
        lo_new = y + torch.roll(v, LANES - half, dims=-1)
        hi_new = torch.roll(y, half, dims=-1) - v
        if lazy:
            y = _csub(torch.where(mask, lo_new, hi_new + 2 * p), 2 * p)
        else:
            y = torch.where(mask, _csub(lo_new, p), torch.where(hi_new < 0, hi_new + p, hi_new))
    if lazy:
        y = _csub(y, p)
    return y.reshape(x.shape).to(x.dtype)


def intt_rows_sl(t: NttTables, x):
    """Inverse of `ntt_rows_sl` with the N^{-1} scale
    (`pallas_fused._intt_rows_sl`): the lane stages first, then the stages
    across rows, then N^{-1} (Montgomery); canonical residues in and out,
    equal to `hal.ntt.ntt_inverse`'s."""
    n, logn = t.n, t.logn
    if not sl_applies(n):
        raise ValueError(f"the split layout needs N % 128 == 0 and N ≥ 128, got {n}")
    p, qinv, lazy = _consts(t)
    w_all = _stage_twiddles(t, True)
    S, nsub = n // LANES, (n // LANES).bit_length() - 1
    nlane = logn - nsub
    lead, P = x.shape[:-2], x.shape[-2]
    y = x.to(torch.int64).reshape(lead + (P, S, LANES))
    lane = torch.arange(LANES, device=y.device)
    for si in range(nlane):                      # inside each 128-point row
        half = n >> (logn - si)
        mask = (lane & (2 * half - 1)) < half
        partner = torch.where(mask, torch.roll(y, LANES - half, dims=-1),
                              torch.roll(y, half, dims=-1))
        w = w_all[si].reshape(P, S, LANES)
        if lazy:
            y = _csub(torch.where(mask, y + partner, _redc(partner - y + 2 * p, w, p, qinv, True)),
                      2 * p)
        else:
            d = partner - y
            y = torch.where(mask, _csub(y + partner, p),
                            _redc(torch.where(d < 0, d + p, d), w, p, qinv, False))
    for si in range(nlane, logn):                # across 128-point rows
        hs = (n >> (logn - si)) // LANES
        parts = y.reshape(lead + (P, S // (2 * hs), 2, hs, LANES))
        lo, hi = parts[..., 0, :, :], parts[..., 1, :, :]
        w = w_all[si].reshape(P, S // (2 * hs), 2, hs, LANES)[:, :, 1]
        p4, q4 = p[..., None], qinv[..., None]
        if lazy:
            new = (_csub(lo + hi, 2 * p4), _redc(lo - hi + 2 * p4, w, p4, q4, True))
        else:
            d = lo - hi
            new = (_csub(lo + hi, p4), _redc(torch.where(d < 0, d + p4, d), w, p4, q4, False))
        y = torch.stack(new, dim=-3).reshape(lead + (P, S, LANES))
    ninv = t.n_inv.to(torch.int64)[:, None, None]
    y = _redc(y, ninv, p, qinv, lazy)
    y = _csub(y, p) if lazy else y
    return y.reshape(x.shape).to(x.dtype)


SL_TRANSFORMS = (ntt_rows_sl, intt_rows_sl)


# ---- the plain pipeline ----

def fused_glwe_product_sl_ref(module: Module, a_data, pmat, res_size: int, res_base2k: int,
                              pm_base2k: int, dsize: int = 1, small=None, small64=None):
    """Plain version: `fused.fused_glwe_product_ref` with the split layout's
    transforms."""
    return fused_glwe_product_ref(module, a_data, pmat, res_size, res_base2k, pm_base2k, dsize,
                                  small, small64, transforms=SL_TRANSFORMS)


def fused_br_block_step_sl_ref(module: Module, acc, pmats, a_blk, res_size: int, base2k: int,
                               steps: int = 1, rot_mode: int | None = None):
    """Plain version: `fused.fused_br_block_step_ref` with the split layout's
    transforms, one block step (`steps` > 1 raises)."""
    _check_steps(steps)
    return fused_br_block_step_ref(module, acc, pmats, a_blk, res_size, base2k, 1, rot_mode,
                                   transforms=SL_TRANSFORMS)


def _check_steps(steps: int) -> None:
    """The JAX kernel's `assert ... not sl` for a chain, as a ValueError."""
    if steps != 1:
        raise ValueError(f"the split layout runs one block step per launch, got steps={steps}")


# ---- the kernel ----

def sl_smem_bytes(kk: int, mrows: int, nprimes: int, n: int, block: int = 0) -> int:
    """Shared memory of one block of `csrc/fused_sl.cu`: P regions of
    max(KK, mrows) rows (the VMP in place), then the block step's x-power
    rows [block] int32."""
    return 4 * nprimes * max(kk, mrows) * n + 4 * block


def sl_threads(smem: int) -> int:
    """Threads per block: SL_THREADS / b for the b blocks (1, 2 or 4) whose
    shared memory, with the kernel's static 2 KB at most, fits in an SM."""
    fit = SM_SMEM // (smem + 2048)
    return SL_THREADS // (4 if fit >= 4 else 2 if fit >= 2 else 1)


def sl_layout(kk: int, co: int, psize: int, nprimes: int, n: int, block: int = 0,
              split: bool = True) -> Layout | None:
    """The kernel's layout: the most output columns per block (any divisor
    of co if `split`, else co: the block step) whose rows fit in shared
    memory, `chunk` the threads per block (`sl_threads`), or None where the
    kernel does not take the shape (N outside 128..2048, more than MAX_LIMBS
    input rows, or not one column that fits)."""
    if n.bit_length() - 1 not in SL_LOGN or not 0 < kk <= MAX_LIMBS:
        return None
    for cpb in (range(co, 0, -1) if split else (co,)):
        smem = sl_smem_bytes(kk, cpb * psize, nprimes, n, block)
        if co % cpb == 0 and smem <= SMEM_LIMIT:
            return Layout("sl", cpb, smem, chunk=sl_threads(smem))
    return None


def _layout_or_raise(kk: int, co: int, psize: int, nprimes: int, n: int, block: int = 0,
                     split: bool = True) -> Layout:
    lay = sl_layout(kk, co, psize, nprimes, n, block, split)
    if lay is None:
        raise ValueError(f"csrc/fused_sl.cu takes 128 ≤ N ≤ 2048, KK ≤ {MAX_LIMBS} and rows "
                         f"that fit in shared memory; got N {n}, KK {kk}, co {co}, psize "
                         f"{psize}, P {nprimes}")
    return lay


def fused_glwe_product_sl(module: Module, a_data, pmat, res_size: int, res_base2k: int,
                          pm_base2k: int, dsize: int = 1, small=None, small64=None, pm_k=None):
    """`fused.fused_glwe_product` in the split layout: the same arguments and
    result; `pm_k` the key in kernel layout (made from `pmat` when not
    given).  Plain version on CPU tensors, one CUDA launch on CUDA, counted
    under "fused_sl_product"."""
    if small is not None and small64 is not None:
        raise ValueError("pass small or small64, not both")
    if a_data.device.type == "cpu":
        return fused_glwe_product_sl_ref(module, a_data, pmat, res_size, res_base2k, pm_base2k,
                                         dsize, small, small64)
    out, launch = _sl_product_launch(module, a_data, pmat, res_size, res_base2k, pm_base2k,
                                     dsize, small, small64, pm_k)
    if launch is not None:
        launch()
        LAUNCHES["fused_sl_product"] += 1
    return out


def _sl_product_launch(module: Module, a_data, pmat, res_size: int, res_base2k: int,
                       pm_base2k: int, dsize: int = 1, small=None, small64=None, pm_k=None):
    """(out, launch) of one product launch of `csrc/fused_sl.cu`, launch None
    where there is nothing to launch; the checks of `fused._product_launch`.
    Counts no launch."""
    P, n = module.nprimes, module.n
    rows, ci, co, psize = pmat.shape[:4]
    lead, a_size = a_data.shape[:-3], a_data.shape[-2]
    rmax = min(rows * dsize, a_size)
    kk = ci * rmax
    if a_data.shape[-3] != ci or a_data.shape[-1] != n:
        raise ValueError(f"a_data: expected [..., {ci}, size, {n}], got {tuple(a_data.shape)}")
    if pmat.device != a_data.device or module.device != a_data.device:
        raise ValueError("a_data, pmat and module must be on one device")
    s64 = 0 if small64 is None else small64.shape[-2]
    _check_bounds(P, max(psize, s64), res_size)
    B = a_data.numel() // (ci * a_size * n) if a_data.numel() else 0
    out = torch.empty(lead + (co, res_size, n), dtype=torch.int64, device=a_data.device)
    if B == 0:
        return out, None
    if rmax == 0 and small is None and small64 is None:
        return out.zero_(), None
    lay = _layout_or_raise(kk, co, psize, P, n)
    if pm_k is None:
        pm_k = pm_kernel_layout(pmat, rmax) if dsize == 1 else \
            pm_kernel_layout_dsize(pmat, rmax, dsize)
    if tuple(pm_k.shape) != (P, kk, co * psize, n):
        raise ValueError(f"pm_k: expected {(P, kk, co * psize, n)}, got {tuple(pm_k.shape)}")
    a = a_data.reshape(B, ci, a_size, n).contiguous()
    _lib.require(a, "a_data", torch.int64)
    _lib.require(pm_k, "pm_k", torch.int32)
    small, s_size, _ = _body(small, lead, B, n)
    if small64 is not None:
        if tuple(small64.shape) != tuple(lead) + (co, s64, n):
            raise ValueError(f"small64: expected {tuple(lead) + (co, s64, n)}, "
                             f"got {tuple(small64.shape)}")
        small64 = small64.reshape(B, co, s64, n).contiguous()
        _lib.require(small64, "small64", torch.int64)
    tw, consts = kernel_tables(module.tables)

    def launch():
        err = _lib.library().poulpy_fused_sl(
            a.data_ptr(), pm_k.data_ptr(), _lib.ptr(small), _lib.ptr(small64), None, None,
            out.data_ptr(), tw.data_ptr(), consts.data_ptr(), B, ci, a_size, rmax, co, psize,
            s_size, s64, res_size, res_base2k, pm_base2k, lay.cpb, P, module.log_n, 0, 0,
            lay.chunk, lay.smem, _lib.stream())
        _lib.check(err, "poulpy_fused_sl")

    return out, launch


def fused_br_block_step_sl(module: Module, acc, pmats, a_blk, res_size: int, base2k: int,
                           pm_k=None, steps: int = 1, rot_mode: int | None = None):
    """`fused.fused_br_block_step` in the split layout: the same arguments
    and result, one block step per launch (`steps` > 1 raises, as the JAX
    kernel asserts); `rot_mode` 0 (the x-power on the VMP's output rows), 1
    (Shoup, on its input rows, from `xpow_shoup_table`) or 2 (Montgomery, on
    its input rows), None the JAX package's default (`block_rot_mode`).
    Plain version on CPU tensors, one CUDA launch on CUDA, counted under
    "fused_sl_block_step"."""
    _check_steps(steps)
    rot_mode = block_rot_mode(module, rot_mode)
    if acc.device.type == "cpu":
        return fused_br_block_step_sl_ref(module, acc, pmats, a_blk, res_size, base2k, 1,
                                          rot_mode)
    out, launch = _sl_block_step_launch(module, acc, pmats, a_blk, res_size, base2k, pm_k,
                                        rot_mode)
    if launch is not None:
        launch()
        LAUNCHES["fused_sl_block_step"] += 1
    return out


def _sl_block_step_launch(module: Module, acc, pmats, a_blk, res_size: int, base2k: int,
                          pm_k=None, rot_mode: int = 2):
    """(out, launch) of one block-step launch of `csrc/fused_sl.cu`, the
    checks of `fused._block_step_launch` (`rot_mode` unchecked:
    `block_rot_mode` is the wrapper's).  Counts no launch."""
    P, n = module.nprimes, module.n
    nkeys, rows, cols, co, psize = pmats.shape[:5]
    lead, size = acc.shape[:-3], acc.shape[-2]
    _check_chain(1, nkeys, size, res_size)
    rmax = min(rows, size)
    kk, mdim = cols * rmax, cols * psize
    if co != cols or acc.shape[-3] != cols or acc.shape[-1] != n:
        raise ValueError(f"acc {tuple(acc.shape)} does not match the key's {cols} columns")
    if tuple(a_blk.shape) != tuple(lead) + (nkeys,):
        raise ValueError(f"a_blk: expected {tuple(lead) + (nkeys,)}, got {tuple(a_blk.shape)}")
    _check_bounds(P, psize, res_size)
    lay = _layout_or_raise(kk, cols, psize, P, n, nkeys, split=False)
    if pm_k is None:
        pm_k = pm_kernel_layout(pmats, rmax)
    if tuple(pm_k.shape) != (nkeys, P, kk, mdim, n):
        raise ValueError(f"pm_k: expected {(nkeys, P, kk, mdim, n)}, got {tuple(pm_k.shape)}")
    B = acc.numel() // (cols * size * n) if acc.numel() else 0
    a = acc.reshape(B, cols, size, n).contiguous()
    amounts = a_blk.reshape(B, nkeys).contiguous()
    _lib.require(a, "acc", torch.int64)
    _lib.require(amounts, "a_blk", torch.int64)
    _lib.require(pm_k, "pm_k", torch.int32)
    if module.device != acc.device or pm_k.device != acc.device:
        raise ValueError("acc, pm_k and module must be on one device")
    out = torch.empty(lead + (cols, res_size, n), dtype=torch.int64, device=acc.device)
    if B == 0:
        return out, None
    xpow = xpow_shoup_table(module) if rot_mode == 1 else xpow_tables(module)[1]
    tw, consts = kernel_tables(module.tables)

    def launch():
        err = _lib.library().poulpy_fused_sl(
            a.data_ptr(), pm_k.data_ptr(), None, None, xpow.data_ptr(), amounts.data_ptr(),
            out.data_ptr(), tw.data_ptr(), consts.data_ptr(), B, cols, size, rmax, cols, psize,
            0, 0, res_size, base2k, base2k, cols, P, module.log_n, nkeys, rot_mode, lay.chunk,
            lay.smem, _lib.stream())
        _lib.check(err, "poulpy_fused_sl")

    return out, launch
