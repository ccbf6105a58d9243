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
the card (csrc/fused_sl.cu) the split design runs the route: a group of
threads owns one transform row in its registers, the stages with half at
least the group's width pair two registers of a thread (the TPU's slice
arithmetic), one exchange through the row's words behind the group's own
barrier, then the stages inside each 128-point chunk in a warp; N 128 ..
8192, past 2048 with the rows in a global workspace (`split_layout`).  The
parent design (a warp per row, N 128 .. 2048, `parent_layout`) stays
selectable with `design="parent"`.  A wrapper takes its plain version for a
CPU tensor and launches the kernel for a CUDA one (or raises where the
design does not take the shape).
"""

from __future__ import annotations

import torch

from poulpy_tpu_torch.backends import LAUNCHES, _lib
from poulpy_tpu_torch.backends._lib import SMEM_LIMIT
from poulpy_tpu_torch.backends.fused import (
    MAX_LIMBS,
    STAGES,
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
DESIGNS = ("split", "parent")
# each design's log N (csrc/fused_sl.cu poulpy_fused_sl_split, poulpy_fused_sl)
SL_LOGN = {"split": range(7, 14), "parent": range(7, 12)}
SPLIT_SHARED_LOGN = 11   # the split design's shared layout; past it the global layout
SM_SMEM = 233472         # shared memory of one H100 SM, of which each block also takes 1 KB
SL_THREADS = 512         # the parent's threads of one SM's blocks (128 registers each)
SPLIT_THREADS = 512      # the split design's block, two to an SM (64 registers a thread)
SPLIT_BLOCKS = 2
SPLIT_TILE = 4           # the most ciphertexts per block of the split design
SPLIT_MR = 8             # its VMP's output rows per pass (csrc/fused_sl.cu split_vmp)
STATIC_SMEM = 2048       # a block's static shared memory (< 1 KB) and the SM's 1 KB per block


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
    """Shared memory of one block of the parent design: P regions of
    max(KK, mrows) rows (the VMP in place), then the block step's x-power
    rows [block] int32."""
    return 4 * nprimes * max(kk, mrows) * n + 4 * block


def sl_threads(smem: int) -> int:
    """The parent's threads per block: SL_THREADS / b for the b blocks (1, 2
    or 4) whose shared memory, with the kernel's static 2 KB at most, fits in
    an SM."""
    fit = SM_SMEM // (smem + STATIC_SMEM)
    return SL_THREADS // (4 if fit >= 4 else 2 if fit >= 2 else 1)


def split_group(n: int) -> int:
    """Threads of one row group of the split design (csrc/fused_sl.cu
    Split<LOGN>::G): N/4 up to N 512, 128 up to 2048, N/16 past it."""
    return n // 4 if n <= 512 else 128 if n <= 2048 else n // 16


def split_rows(kk: int, mrows: int) -> int:
    """Rows of one region of the split design: max(KK, mrows), the VMP in
    place, up to SPLIT_MR output rows; KK + mrows past it, the outputs after
    the inputs (csrc/fused_sl.cu split_vmp)."""
    return max(kk, mrows) if mrows <= SPLIT_MR else kk + mrows


def split_smem_bytes(tile: int, kk: int, mrows: int, nprimes: int, n: int,
                     block: int = 0) -> int:
    """Shared memory of one block of the split design.  Shared layout:
    `tile`·P regions of `split_rows` rows, the twiddles of one prime [N],
    the x-power rows [tile][block].  Global layout (N > 2048; `tile` 1): the
    twiddles, a row slot per group for the exchange, the x-power rows."""
    if n.bit_length() - 1 > SPLIT_SHARED_LOGN:
        return 4 * (n * (1 + SPLIT_THREADS // split_group(n)) + tile * block)
    return 4 * (tile * nprimes * split_rows(kk, mrows) * n + n + tile * block)


def split_layout(kk: int, co: int, psize: int, nprimes: int, n: int, block: int = 0,
                 split: bool = True) -> Layout | None:
    """The split design's layout, or None where it does not take the shape
    (N outside 128..8192, more than MAX_LIMBS input rows, rows past shared
    memory).  `chunk`: threads per block (SPLIT_THREADS).  The output
    columns per block (`cpb`: any divisor of co if `split`, else co: the
    block step) are the most whose rows take one VMP pass (at most
    SPLIT_MR), then (a column of more rows) the most of any count.  Shared
    layout (N ≤ 2048, kind "split"): the first such `cpb`, then the most
    ciphertexts per block (`tile`, up to SPLIT_TILE), whose rows let
    SPLIT_BLOCKS blocks share an SM (1,024 threads); where none does, one
    block.  Global layout (N 4096, 8192, kind "global"): the first `cpb`,
    one ciphertext per task, `ws_rows` = P·`split_rows` rows of workspace
    per block."""
    cpbs = sorted((c for c in (range(co, 0, -1) if split else (co,)) if co % c == 0),
                  key=lambda c: (c * psize > SPLIT_MR, -c))
    if n.bit_length() - 1 not in SL_LOGN["split"] or not 0 < kk <= MAX_LIMBS:
        return None
    if n.bit_length() - 1 > SPLIT_SHARED_LOGN:
        return Layout("global", cpbs[0],
                      split_smem_bytes(1, kk, cpbs[0] * psize, nprimes, n, block),
                      chunk=SPLIT_THREADS, ws_rows=nprimes * split_rows(kk, cpbs[0] * psize))
    for blocks in (SPLIT_BLOCKS, 1):
        for cpb in cpbs:
            for tile in range(SPLIT_TILE, 0, -1):
                smem = split_smem_bytes(tile, kk, cpb * psize, nprimes, n, block)
                if smem <= SMEM_LIMIT and blocks * (smem + STATIC_SMEM) <= SM_SMEM:
                    return Layout("split", cpb, smem, chunk=SPLIT_THREADS, tile=tile)
    return None


def parent_layout(kk: int, co: int, psize: int, nprimes: int, n: int, block: int = 0,
                  split: bool = True) -> Layout | None:
    """The parent design's layout: the most output columns per block (any
    divisor of co if `split`, else co) whose rows fit in shared memory,
    `chunk` the threads per block (`sl_threads`), or None where it does not
    take the shape (N outside 128..2048, more than MAX_LIMBS input rows, or
    not one column that fits)."""
    if n.bit_length() - 1 not in SL_LOGN["parent"] or not 0 < kk <= MAX_LIMBS:
        return None
    for cpb in (range(co, 0, -1) if split else (co,)):
        smem = sl_smem_bytes(kk, cpb * psize, nprimes, n, block)
        if co % cpb == 0 and smem <= SMEM_LIMIT:
            return Layout("sl", cpb, smem, chunk=sl_threads(smem))
    return None


def sl_layout(kk: int, co: int, psize: int, nprimes: int, n: int, block: int = 0,
              split: bool = True, design: str = "split") -> Layout | None:
    """The layout a launch of `design` takes (`split_layout` or
    `parent_layout`), None where that design does not take the shape."""
    if design not in DESIGNS:
        raise ValueError(f"design: one of {DESIGNS}, got {design!r}")
    return (split_layout if design == "split" else parent_layout)(kk, co, psize, nprimes, n,
                                                                  block, split)


def _layout_or_raise(kk: int, co: int, psize: int, nprimes: int, n: int, block: int = 0,
                     split: bool = True, design: str = "split") -> Layout:
    """The layout of a launch of `design`; raises where it does not take
    the shape."""
    lay = sl_layout(kk, co, psize, nprimes, n, block, split, design)
    if lay is None:
        raise ValueError(f"csrc/fused_sl.cu's {design} design does not take N {n}, KK {kk}, "
                         f"co {co}, psize {psize}, P {nprimes} (split: 128 ≤ N ≤ 8192; parent: "
                         f"N ≤ 2048; both: KK ≤ {MAX_LIMBS} and rows that fit in shared memory)")
    return lay


def _timed_ok(n: int, block_step: bool) -> bool:
    """The stage clock's instances (csrc/fused_sl.cu timed_shape): the
    paths' N, 1024 for both patterns and 2048 for the product."""
    return n == 1024 or (n == 2048 and not block_step)


def _launcher(module: Module, a, pm_k, out, lay: Layout, design: str, B: int, ptrs: tuple,
              ints: tuple, block_step: bool):
    """launch(timed=False) of one launch of `design` with the entry point's
    pointers (small, small64, xpow, amounts) and integers (ci … rot_mode,
    as poulpy_fused_sl takes them, threads and smem excluded); it returns
    the stage clock's stamps [blocks, len(STAGES)] when `timed`, else None."""
    tw, consts = kernel_tables(module.tables)
    n = module.n
    tasks = -(-B // lay.tile) * (ints[3] // lay.cpb)
    grid = min(tasks, SPLIT_BLOCKS * _lib.sm_count(a.device)) if lay.kind == "global" else tasks
    ws = torch.empty(grid * lay.ws_rows * n, dtype=torch.int32, device=a.device) \
        if lay.kind == "global" else None

    def launch(timed: bool = False):
        stamps = None
        if timed:
            if lay.kind == "global" or not _timed_ok(n, block_step):
                raise ValueError(f"the stage clock runs at the paths' shapes in shared memory "
                                 f"only (N 1024, or 2048 for the product), got N {n}")
            stamps = torch.zeros((grid, len(STAGES)), dtype=torch.int64, device=a.device)
        head = (a.data_ptr(), pm_k.data_ptr(), *ptrs, out.data_ptr(), tw.data_ptr(),
                consts.data_ptr())
        if design == "split":
            err = _lib.library().poulpy_fused_sl_split(
                *head, _lib.ptr(ws), _lib.ptr(stamps), B, *ints, lay.tile, grid, lay.chunk,
                lay.smem, _lib.stream())
        else:
            err = _lib.library().poulpy_fused_sl(*head, _lib.ptr(stamps), B, *ints, lay.chunk,
                                                 lay.smem, _lib.stream())
        _lib.check(err, f"poulpy_fused_sl ({design})")
        return stamps

    return launch


def fused_glwe_product_sl(module: Module, a_data, pmat, res_size: int, res_base2k: int,
                          pm_base2k: int, dsize: int = 1, small=None, small64=None, pm_k=None,
                          design: str = "split"):
    """`fused.fused_glwe_product` in the split layout: the same arguments and
    result; `pm_k` the key in kernel layout (made from `pmat` when not
    given); `design` the kernel's: "split" (the route's) or "parent".
    Plain version on CPU tensors, one CUDA launch on CUDA, counted under
    "fused_sl_product"."""
    if small is not None and small64 is not None:
        raise ValueError("pass small or small64, not both")
    if a_data.device.type == "cpu":
        return fused_glwe_product_sl_ref(module, a_data, pmat, res_size, res_base2k, pm_base2k,
                                         dsize, small, small64)
    out, launch = _sl_product_launch(module, a_data, pmat, res_size, res_base2k, pm_base2k,
                                     dsize, small, small64, pm_k, design)
    if launch is not None:
        launch()
        LAUNCHES["fused_sl_product"] += 1
    return out


def _sl_product_launch(module: Module, a_data, pmat, res_size: int, res_base2k: int,
                       pm_base2k: int, dsize: int = 1, small=None, small64=None, pm_k=None,
                       design: str = "split"):
    """(out, launch) of one product launch of `design` of `csrc/fused_sl.cu`,
    launch None where there is nothing to launch; the checks of
    `fused._product_launch`.  launch(timed=False) → the stage clock's stamps
    or None.  Counts no launch."""
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
    lay = _layout_or_raise(kk, co, psize, P, n, design=design)
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
    ptrs = (_lib.ptr(small), _lib.ptr(small64), None, None)
    ints = (ci, a_size, rmax, co, psize, s_size, s64, res_size, res_base2k, pm_base2k, lay.cpb, P,
            module.log_n, 0, 0)
    return out, _launcher(module, a, pm_k, out, lay, design, B, ptrs, ints, False)


def fused_br_block_step_sl(module: Module, acc, pmats, a_blk, res_size: int, base2k: int,
                           pm_k=None, steps: int = 1, rot_mode: int | None = None,
                           design: str = "split"):
    """`fused.fused_br_block_step` in the split layout: the same arguments
    and result, one block step per launch (`steps` > 1 raises, as the JAX
    kernel asserts); `rot_mode` 0 (the x-power on the VMP's output rows), 1
    (Shoup, on its input rows, from `xpow_shoup_table`) or 2 (Montgomery, on
    its input rows), None the JAX package's default (`block_rot_mode`);
    `design` as `fused_glwe_product_sl`'s.  Plain version on CPU tensors,
    one CUDA launch on CUDA, counted under "fused_sl_block_step"."""
    _check_steps(steps)
    rot_mode = block_rot_mode(module, rot_mode)
    if acc.device.type == "cpu":
        return fused_br_block_step_sl_ref(module, acc, pmats, a_blk, res_size, base2k, 1,
                                          rot_mode)
    out, launch = _sl_block_step_launch(module, acc, pmats, a_blk, res_size, base2k, pm_k,
                                        rot_mode, design)
    if launch is not None:
        launch()
        LAUNCHES["fused_sl_block_step"] += 1
    return out


def _sl_block_step_launch(module: Module, acc, pmats, a_blk, res_size: int, base2k: int,
                          pm_k=None, rot_mode: int = 2, design: str = "split"):
    """(out, launch) of one block-step launch of `design` of
    `csrc/fused_sl.cu`, the checks of `fused._block_step_launch` (`rot_mode`
    unchecked: `block_rot_mode` is the wrapper's).  launch(timed=False) →
    the stage clock's stamps or None.  Counts no launch."""
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
    lay = _layout_or_raise(kk, cols, psize, P, n, nkeys, split=False, design=design)
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
    ptrs = (None, None, xpow.data_ptr(), amounts.data_ptr())
    ints = (cols, size, rmax, cols, psize, 0, 0, res_size, base2k, base2k, cols, P, module.log_n,
            nkeys, rot_mode)
    return out, _launcher(module, a, pm_k, out, lay, design, B, ptrs, ints, True)


def stage_cycles(module: Module, *args, block_step: bool = False, design: str = "split",
                 **kw):
    """(out, stamps) of one launch of `design`'s stage clock instance on
    `fused_glwe_product_sl`'s arguments (`block_step`:
    `fused_br_block_step_sl`'s; `rot_mode` then as `_sl_block_step_launch`
    takes it, 2 by default): stamps [blocks, len(STAGES)] int64, the SM
    cycles each block spent in each stage (`fused.STAGES`; the entry's
    reduction runs inside the forward, so "entry" is the prologue), from
    thread 0 at the barriers that close them.  The paths' shapes only (N
    1024, or 2048 for the product).  For measurement only: no path calls
    it, and it counts no launch."""
    prepare = _sl_block_step_launch if block_step else _sl_product_launch
    out, launch = prepare(module, *args, design=design, **kw)
    return out, launch(timed=True)
