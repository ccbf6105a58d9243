"""Fused product kernels (`csrc/fused_product.cu`, `csrc/fused_product_tile.cu`,
`csrc/br_block_step.cu`, `csrc/tensor_product.cu`), the standalone exit
(`csrc/garner_exit.cu`) and their plain PyTorch twins.

Replace four call patterns of `poulpy_tpu/backends/pallas_fused.py`
(`_pipe_fn` → `_kernel_pipe`, and `_tensor_fn` → `_kernel_tensor`):

- the product (block 1, no rotate): `fused_glwe_product`,
      big_normalize(idft(vmp(dft(a), pmat)))
  for any dsize (the dsize > 1 digit grouping is folded into the matrix by
  `pm_kernel_layout_dsize`);
- the same with `small`, the keyswitch body added to column 0 of the big
  accumulator before the normalization (`fused_glwe_product(small=…)`), or
  with `small64`, the 64-bit linear terms of a tensor product added to every
  column over max(psize, s64) limbs (`fused_glwe_product(small64=…)`, the
  relinearization);
- the standard CGGI step: `fused_br_step`, the product of the
  unnormalized accumulator by one key element with the rotate-and-subtract
  of the JAX package's loop folded into its exit (`csrc/fused_product_tile.cu`,
  which also holds the product's instance at the circuit bootstrap trace's
  shape, `TILE_SHAPES`), and `fused_br_steps`, the loop of them,
      acc ← acc + X^a·tmp − tmp,  tmp = big_normalize(idft(vmp(dft(acc), BRK_i)));
- the block-binary CGGI step (block > 1, rotate, add_acc):
  `fused_br_block_step`,
      acc ← normalize(acc + idft(Σ_i NTT(X^{a_i} − 1) · (dft(acc) ⊡ BRK_i))),
  and `steps` such steps chained in one launch (`steps=2` is the JAX
  package's default launch; `chain_steps` says where the kernel takes it);
- the rank-1 tensor product: `fused_tensor_product`, the quadratic term's
  gadget digits and the raw 64-bit linear terms that feed `small64`
  (`csrc/tensor_product.cu`, its lazy design shared with
  `csrc/wide_tensor.cu` in `csrc/tensor.cuh`);

and `_kernel_b_fn` → `_kernel_b`, the exit of the "mxu" route on its own:
`garner_exit`, coefficient residues → Garner lift → + small → normalize.

Each wrapper takes its plain version for a CPU tensor and launches its
kernel for a CUDA one.  The plain versions (`*_ref`) are built from plain
parts only, so on a CUDA tensor they launch no kernel of `csrc/`.  The
fused kernels' wrappers choose a layout by formula (`kernel_layout`): the
shared one where a block's rows fit in shared memory, else the global one
(the rows in a device workspace, the transforms staged through shared
memory).  `fused_product.cu`, `br_block_step.cu` and the tensor kernels
have two designs: the lazy design (`lazy_layout`, `tensor_lazy_layout`:
every shape whose rows fit, 256 ≤ N ≤ 2048) and the parent design, which
takes the other shapes (its global layout past shared memory) and is the
stage clock's reference.  `stage_cycles` and `tensor_stage_cycles` read
either design's stage clock, for measurement only.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from poulpy_tpu_torch.backends import LAUNCHES, _lib
from poulpy_tpu_torch.backends._lib import SMEM_LIMIT
from poulpy_tpu_torch.backends.mxu import sigma_index
from poulpy_tpu_torch.backends.ntt import kernel_tables, shoup_tables
from poulpy_tpu_torch.backends.vmp import vmp_apply_ref
from poulpy_tpu_torch.hal.dft import _align_limbs, cnv_apply, dft_add, dft_limbs, dft_sub
from poulpy_tpu_torch.hal.module import Module
from poulpy_tpu_torch.hal.normalization import vec_znx_normalize_full
from poulpy_tpu_torch.hal.vec_znx import vec_znx_rotate
from poulpy_tpu_torch.hal.ntt import (
    _host_tables,
    add_mod,
    garner_lift,
    mont_mul,
    ntt_forward,
    ntt_inverse,
    to_mont,
    to_residues,
)
from poulpy_tpu_torch.hal.primes import R

MAX_PRIMES = 8          # compile-time bounds of the kernel's per-thread arrays
MAX_LIMBS = 16

# the stages of the butterfly kernels' stage clock (csrc/modarith.cuh BF_*)
STAGES = ("entry", "fwd", "vmp", "inv", "exit")
# the stages of the tensor kernels' stage clock (csrc/modarith.cuh TS_*)
TENSOR_STAGES = ("entry_fwd", "conv", "inv", "lift")
# The shapes with a specialised instance of the tensor kernels' lazy design
# (csrc/tensor_product.cu TensorShape, csrc/wide_tensor.cu WideTensorShape):
# (wide, log N, P, size_a, size_b, conv, dnum, lin limbs, pairs per task or 0
# for either, kr, ka), the relinearize path's and the CKKS-wide mul's.  Any
# other shape takes the runtime-shaped instance.
TENSOR_SHAPES = {(False, 11, 2, 6, 6, 11, 6, 11, 1, 17, 17),
                 (True, 11, 5, 2, 2, 3, 2, 3, 0, 52, 52)}
# shared bytes the lazy tensor kernel keeps beside its rows (its static
# __shared__ constants, csrc/tensor.cuh)
TENSOR_STATIC_SMEM = 2048
# The shapes with a specialised instance of the lazy design (csrc/fused_product.cu
# ProductShape, SmallShape, GateKsShape, RotateShape; csrc/fused_product_tile.cu
# CbtShape, CbtTraceShape; csrc/br_block_step.cu GateShape): (launch, log N,
# KK, cpb·psize, P, psize, res_size) → ciphertexts per block, launch
# "product" (`fused_glwe_product`, with or without the body), "step"
# (`fused_br_step`) or "block_step" (`fused_br_block_step`).  Any other shape
# takes the runtime-shaped instance, one ciphertext per block.
LAZY_SHAPES = {
    ("block_step", 10, 4, 8, 2, 4, 2): 2,    # the gate's block step
    ("product", 11, 6, 8, 2, 4, 3): 1,       # bench.py's product
    ("product", 11, 3, 8, 2, 4, 3): 1,       # the keyswitch path's product with the body
    ("product", 10, 2, 6, 2, 3, 2): 1,       # the gate's keyswitch
    ("product", 11, 6, 12, 2, 6, 6): 1,      # the CKKS rotation's keyswitch
    ("step", 10, 4, 8, 2, 4, 2): 1,          # the CBT's standard blind-rotation step
    ("product", 10, 2, 8, 2, 4, 2): 1,       # the CBT trace's keyswitch with the body
}
# the shapes of LAZY_SHAPES whose instances are csrc/fused_product_tile.cu's
# (CbtShape, CbtTraceShape; two blocks per SM); the step's other shapes take
# that file's RuntimeShape
TILE_SHAPES = {("step", 10, 4, 8, 2, 4, 2), ("product", 10, 2, 8, 2, 4, 2)}


def pm_kernel_layout(pmat, rmax: int):
    """[..., rows, ci, co, psize, P, N] Montgomery pmat → [..., P, KK=ci·rmax,
    M=co·psize, N] int32 (ci-major, row-minor)."""
    lead = pmat.dim() - 6
    pm = pmat[..., :rmax, :, :, :, :, :]
    pm = pm.permute(*range(lead), *(lead + d for d in (4, 1, 0, 2, 3, 5)))
    P, ci, r, co, psize, n = pm.shape[lead:]                # [..., P, ci, rmax, co, psize, N]
    return pm.reshape(pm.shape[:lead] + (P, ci * r, co * psize, n)).to(torch.int32).contiguous()


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


def product_dft_ref(module: Module, a_data, pmat, dsize: int = 1):
    """Plain dft → vmp of the fused products, in the DFT domain: one VMP for
    dsize 1, else the sum over digits di of the VMP of limbs
    dsize−1−di, 2·dsize−1−di, … at output limb offset di."""
    if dsize == 1:
        return vmp_apply_ref(module, _dft_plain(module, a_data), pmat)
    dnum, a_size = pmat.shape[0], a_data.shape[-2]
    res_dft = None
    for di in range(dsize):
        ai_size = min((a_size + di) // dsize, dnum)
        if ai_size == 0:
            continue
        ai = _dft_plain(module, a_data, dsize, dsize - 1 - di, ai_size)
        part = vmp_apply_ref(module, ai, pmat, limb_offset=di)
        res_dft = part if res_dft is None else add_mod(res_dft, part, module.tables.p[:, None])
    return res_dft


def fused_glwe_product_ref(module: Module, a_data, pmat, res_size: int, res_base2k: int,
                           pm_base2k: int, dsize: int = 1, small=None, small64=None):
    """Plain version: dft → vmp (per digit for dsize > 1) → idft → (+ small
    at column 0 | + small64 per column) → normalize, every stage in plain
    PyTorch."""
    res_dft = product_dft_ref(module, a_data, pmat, dsize)
    big = garner_lift(module.tables, ntt_inverse(module.tables, res_dft))
    if small is not None:   # garner_lift's output is fresh: add the body in place
        big[..., 0, :, :] += _align_limbs(small, big, big.shape[-2], limb_axis=-2)[0]
    if small64 is not None:
        s64 = small64.shape[-2]
        if s64 > big.shape[-2]:
            big = F.pad(big, (0, 0, 0, s64 - big.shape[-2]))
        big[..., :s64, :] += small64
    return vec_znx_normalize_full(res_size, res_base2k, 0, big, pm_base2k)


def fused_smem_bytes(kk: int, mrows: int, nprimes: int, n: int) -> int:
    """Shared memory of one block of the product kernels: the KK input rows
    of one prime, then the block's `mrows` output rows of every prime (all
    live for the Garner lift)."""
    return 4 * n * (kk + nprimes * mrows)


@dataclass(frozen=True)
class Layout:
    """Where a fused kernel keeps one block's residue rows (csrc/modarith.cuh).

    "shared": all of them in `smem` bytes of shared memory, `cpb` output
    columns per block, one block per task.  "tile" (the fused MXU kernel):
    the same for `tile` ciphertexts per block.  "global": in a global
    workspace slot of `ws_rows` rows of N words per block (all co columns in
    one task, the blocks walking the tasks), each transform staged through
    `smem` bytes of shared memory `chunk` rows at a time.  "lazy" (the
    tensor kernels): `chunk` rows of shared memory, `pairs` column pairs per
    task."""

    kind: str
    cpb: int
    smem: int
    chunk: int = 0
    ws_rows: int = 0
    tile: int = 1
    pairs: int = 0


def kernel_layout(co: int, shared_bytes, split: bool, ws_rows: int, stage_bytes,
                  max_chunk: int) -> Layout:
    """The shared layout with the most output columns per block whose
    `shared_bytes(cpb)` fit (any divisor of co if `split`, else co only);
    where none does, the global layout with the most rows per pass (up to
    `max_chunk`) whose `stage_bytes(chunk)` fit.  Raises if one row does not."""
    for cpb in (range(co, 0, -1) if split else (co,)):
        if co % cpb == 0 and shared_bytes(cpb) <= SMEM_LIMIT:
            return Layout("shared", cpb, shared_bytes(cpb))
    chunk = next((c for c in range(max_chunk, 0, -1) if stage_bytes(c) <= SMEM_LIMIT), 0)
    if not chunk:
        raise ValueError(f"one row of the global layout needs {stage_bytes(1)} B of shared "
                         f"memory > {SMEM_LIMIT}")
    return Layout("global", co, stage_bytes(chunk), chunk, ws_rows)


def product_layout(kk: int, co: int, psize: int, nprimes: int, n: int,
                   split: bool = True) -> Layout:
    """The layout of the butterfly product kernels (`fused_product.cu`,
    `wide_product.cu`; `br_block_step.cu` with `split` False): the global
    workspace holds the KK input rows and the P·co·psize output rows, the
    stage whole rows."""
    return kernel_layout(co, lambda cpb: fused_smem_bytes(kk, cpb * psize, nprimes, n), split,
                         kk + nprimes * co * psize, lambda c: 4 * n * c, max(kk, co * psize))


def launch_workspace(layout: Layout, tasks: int, n: int, device):
    """(workspace or None, grid) of a launch: the shared layout runs a block
    per task; the global layout a grid of at most two blocks per SM, each
    with a workspace slot of `ws_rows` rows of N words."""
    if layout.kind == "shared":
        return None, tasks
    grid = min(tasks, 2 * _lib.sm_count(device))
    return torch.empty((grid, layout.ws_rows, n), dtype=torch.int32, device=device), grid


def lazy_smem_bytes(tile: int, kk: int, mrows: int, nprimes: int, n: int, block: int = 0,
                    step_rows: int = 0) -> int:
    """Shared memory of one block of the lazy design: `tile`·P regions of
    max(KK, mrows) rows (the VMP writes its output rows over its input
    rows), then the normalized rows [tile·step_rows] int64 of the step or
    of a chain of block steps, and the block step's x-power rows
    [tile·block] int32."""
    return 4 * tile * nprimes * max(kk, mrows) * n + 4 * tile * block + 8 * tile * step_rows * n


def _launch_kind(block: int, step: bool) -> str:
    return "block_step" if block else "step" if step else "product"


def lazy_layout(kk: int, co: int, psize: int, nprimes: int, n: int, res_size: int,
                block: int = 0, split: bool = True, step: bool = False) -> Layout | None:
    """The lazy design's layout, or None where it does not take the shape
    (N outside 256..2048, more than MAX_LIMBS input or output rows, or no
    column group that fits): the most output columns per block (all co for
    the block step, `split` False) whose rows fit; ciphertexts per block
    from LAZY_SHAPES, else 1; `step`: the block's res_size normalized rows
    per column in shared memory too (`fused_br_step`'s launch, or with
    `block` a chain of block steps, `block` key elements in all)."""
    logn = n.bit_length() - 1
    if not 8 <= logn <= 11 or not 0 < kk <= MAX_LIMBS:
        return None
    for cpb in (range(co, 0, -1) if split else (co,)):
        mrows = cpb * psize
        if co % cpb or mrows > MAX_LIMBS:
            continue
        tile = LAZY_SHAPES.get((_launch_kind(block, step), logn, kk, mrows, nprimes, psize,
                                res_size), 1)
        smem = lazy_smem_bytes(tile, kk, mrows, nprimes, n, block, cpb * res_size if step else 0)
        if smem <= SMEM_LIMIT:
            return Layout("lazy", cpb, smem, tile=tile)
    return None


def butterfly_layout(kk: int, co: int, psize: int, nprimes: int, n: int, res_size: int,
                     block: int = 0, split: bool = True, design: str = "lazy",
                     step: bool = False) -> Layout:
    """The layout a launch of `fused_product.cu`, `fused_product_tile.cu` or
    `br_block_step.cu` takes: the lazy design's where it takes the shape
    (`design` "lazy"), else the parent design's `product_layout`."""
    if design not in ("lazy", "parent"):
        raise ValueError(f"design: 'lazy' or 'parent', got {design!r}")
    lay = lazy_layout(kk, co, psize, nprimes, n, res_size, block, split, step) if design == "lazy" \
        else None
    return lay or product_layout(kk, co, psize, nprimes, n, split)


def fused_supported(psize: int, res_base2k: int) -> bool:
    """The JAX package's condition for its fused (non-wide) product kernels
    (`pallas_fused.fused_supported`): the i32 window arithmetic of their
    exit.  The port's kernels take any such shape; the MXU routes ask it as
    the JAX package does."""
    return res_base2k + (psize + 1).bit_length() <= 31 and res_base2k <= 26


def _check_bounds(P: int, psize: int, res_size: int) -> None:
    """Raise on shapes past the kernels' compile-time bounds (shared memory
    is the layouts' business)."""
    if P > MAX_PRIMES or psize > MAX_LIMBS or res_size > MAX_LIMBS:
        raise ValueError(f"kernel bounds: P ≤ {MAX_PRIMES}, psize and res_size ≤ {MAX_LIMBS}")


def _body(small, lead, B: int, n: int):
    """The body `small` [*lead, s_size, N] int64 as the kernels take it:
    (contiguous [B, s_size, N] or None, s_size, its pointer or None)."""
    if small is None:
        return None, 0, None
    s_size = small.shape[-2]
    if tuple(small.shape) != tuple(lead) + (s_size, n):
        raise ValueError(f"small: expected {tuple(lead) + (s_size, n)}, got {tuple(small.shape)}")
    small = small.reshape(B, s_size, n).contiguous()
    _lib.require(small, "small", torch.int64)
    return small, s_size, small.data_ptr()


def product_fits(module: Module, kk: int, psize: int, res_size: int, ext: int) -> bool:
    """True when `fused_glwe_product`'s kernel takes these shapes: its
    compile-time bounds (any N: the global layout takes what shared memory
    does not)."""
    del kk
    return module.nprimes <= MAX_PRIMES and max(psize, res_size, ext) <= MAX_LIMBS


def fused_glwe_product(module: Module, a_data, pmat, res_size: int, res_base2k: int,
                       pm_base2k: int, dsize: int = 1, small=None, small64=None):
    """`a_data` [..., ci, size_a, N] int64 limbs × `pmat` [rows, ci, co, psize,
    P, N] → [..., co, res_size, N] normalized int64 limbs in base
    2^res_base2k.  `small` [..., s_size, N] int64, if given, is added to
    column 0 of the big accumulator (the keyswitch body, limbs past psize
    dropped); `small64` [..., co, s64, N] wrapping int64, if given, is added
    to every column, the accumulator extended with zero limbs to
    max(psize, s64) (a tensor product's linear terms).  Plain version on CPU
    tensors, one CUDA launch on CUDA."""
    if small is not None and small64 is not None:
        raise ValueError("pass small or small64, not both")
    if a_data.device.type == "cpu":
        return fused_glwe_product_ref(module, a_data, pmat, res_size, res_base2k,
                                      pm_base2k, dsize, small, small64)
    out, launch = _product_launch(module, a_data, pmat, res_size, res_base2k, pm_base2k, dsize,
                                  small, small64)
    if launch is not None:
        launch()
        LAUNCHES["fused_product_small" if small is not None
                 else "fused_product_small64" if small64 is not None else "fused_product"] += 1
    return out


def _stamps(timed: bool, blocks: int, device, stages: tuple = STAGES):
    return torch.zeros((blocks, len(stages)), dtype=torch.int64, device=device) if timed else None


def _product_launch(module: Module, a_data, pmat, res_size: int, res_base2k: int,
                    pm_base2k: int, dsize: int = 1, small=None, small64=None, amounts=None,
                    design: str = "lazy", pm_k=None, out=None):
    """The checked arguments of one `fused_glwe_product` launch, or with
    `amounts` one `fused_br_step` launch: (out, launch) with
    launch(timed=False) → the stage clock's stamps or None (launch None
    where there is nothing to launch); `design` "lazy" or "parent"
    (`butterfly_layout`), or "runtime", for measurement: the lazy layout
    without the instances of TILE_SHAPES, the runtime-shaped instance that
    they replace; `pm_k` the key in kernel layout (made from `pmat` when not
    given); `out` the output buffer (allocated when not given)."""
    P, n = module.nprimes, module.n
    rows, ci, co, psize = pmat.shape[:4]
    lead = a_data.shape[:-3]
    a_size = a_data.shape[-2]
    rmax = min(rows * dsize, a_size)
    kk = ci * rmax
    if a_data.shape[-3] != ci or a_data.shape[-1] != n:
        raise ValueError(f"a_data: expected [..., {ci}, size, {n}], got {tuple(a_data.shape)}")
    step = amounts is not None
    if step and (small is not None or small64 is not None or dsize != 1 or co != ci
                 or a_size != res_size):
        raise ValueError("the step takes an accumulator [..., cols, res_size, N] and a key of "
                         "cols columns, dsize 1, no small or small64")
    if design not in ("lazy", "runtime", "parent"):
        raise ValueError(f"design: 'lazy', 'runtime' or 'parent', got {design!r}")
    lay = butterfly_layout(kk, co, psize, P, n, res_size, design="parent" if design == "parent"
                           else "lazy", step=step)
    s64 = 0 if small64 is None else small64.shape[-2]
    _check_bounds(P, max(psize, s64), res_size)
    if pmat.device != a_data.device or module.device != a_data.device:
        raise ValueError("a_data, pmat and module must be on one device")
    if pm_k is None:
        pm_k = pm_kernel_layout(pmat, rmax) if dsize == 1 else \
            pm_kernel_layout_dsize(pmat, rmax, dsize)
    if tuple(pm_k.shape) != (P, kk, co * psize, n):
        raise ValueError(f"pm_k: expected {(P, kk, co * psize, n)}, got {tuple(pm_k.shape)}")
    B = a_data.numel() // (ci * a_size * n) if a_data.numel() else 0
    a = a_data.reshape(B, ci, a_size, n).contiguous()    # the keyswitch passes a column view
    _lib.require(a, "a_data", torch.int64)
    _lib.require(pm_k, "pm_k", torch.int32)
    small, s_size, _ = _body(small, lead, B, n)
    if small64 is not None:
        if tuple(small64.shape) != tuple(lead) + (co, s64, n):
            raise ValueError(f"small64: expected {tuple(lead) + (co, s64, n)}, "
                             f"got {tuple(small64.shape)}")
        small64 = small64.reshape(B, co, s64, n).contiguous()
        _lib.require(small64, "small64", torch.int64)
    astride = 0
    if step:
        if tuple(amounts.shape) != tuple(lead):
            raise ValueError(f"amounts: expected {tuple(lead)}, got {tuple(amounts.shape)}")
        amounts = amounts.reshape(B)         # a strided view of mod_switch_2n's output
        if amounts.dtype != torch.int64 or amounts.device != a.device:
            raise ValueError("amounts: expected int64 on the accumulator's device")
        astride = amounts.stride(0) if B > 1 else 1
    if out is None:
        out = torch.empty(lead + (co, res_size, n), dtype=torch.int64, device=a_data.device)
    elif tuple(out.shape) != tuple(lead) + (co, res_size, n) or not out.is_contiguous() \
            or out.data_ptr() == a.data_ptr():
        raise ValueError("out: a contiguous [..., co, res_size, N] buffer apart from the input")
    if B == 0:
        return out, None
    if rmax == 0 and small is None and small64 is None and not step:
        return out.zero_(), None
    tw, consts = kernel_tables(module.tables)
    tasks = B * (co // lay.cpb)
    sizes = (B, ci, a_size, rmax, co, psize, s_size, s64, res_size, res_base2k, pm_base2k,
             lay.cpb, P, module.log_n)

    tile_design = step or (design == "lazy" and lay.kind == "lazy" and small64 is None and (
        "product", module.log_n, kk, lay.cpb * psize, P, psize, res_size) in TILE_SHAPES)

    def launch(timed: bool = False, ptrs: tuple | None = None):
        # the closure holds every tensor whose pointer it passes; `ptrs`: the
        # (a_data, pm_k, amounts, out) pointers of other tensors of the same
        # shapes and strides (`fused_br_steps`), the caller keeping them alive
        a_p, pm_p, am_p, out_p = ptrs or (a.data_ptr(), pm_k.data_ptr(), _lib.ptr(amounts),
                                          out.data_ptr())
        lib, stream = _lib.library(), _lib.stream()
        stamps = _stamps(timed, tasks, a_data.device)
        if lay.kind == "lazy":
            shoup = shoup_tables(module.tables).data_ptr()
            if tile_design:     # csrc/fused_product_tile.cu
                err = lib.poulpy_fused_product_tile(
                    a_p, pm_p, _lib.ptr(small), am_p, out_p, shoup, consts.data_ptr(), B, ci,
                    a_size, rmax, co, psize, s_size, res_size, res_base2k, pm_base2k, lay.cpb, P,
                    module.log_n, astride, int(design == "lazy"), lay.smem,
                    _lib.ptr(stamps), stream)
            else:
                err = lib.poulpy_fused_product_lazy(
                    a_p, pm_p, _lib.ptr(small), _lib.ptr(small64), out_p, shoup,
                    consts.data_ptr(), *sizes, lay.smem, _lib.ptr(stamps), stream)
        else:
            if timed and lay.kind == "global":
                raise ValueError("the stage clock runs the shared layout only")
            ws, grid = launch_workspace(lay, tasks, n, a_data.device)
            if step:        # csrc/fused_product_tile.cu's parent design
                tmp = torch.empty((grid, lay.cpb * res_size, n), dtype=torch.int64,
                                  device=a_data.device)
                err = lib.poulpy_br_step(
                    a_p, pm_p, am_p, out_p, tmp.data_ptr(), tw.data_ptr(), consts.data_ptr(), B,
                    ci, a_size, rmax, psize, res_base2k, lay.cpb, P, module.log_n, astride,
                    lay.smem, _lib.ptr(ws), lay.chunk, grid, _lib.ptr(stamps), stream)
            else:
                err = lib.poulpy_fused_product(
                    a_p, pm_p, _lib.ptr(small), _lib.ptr(small64), out_p, tw.data_ptr(),
                    consts.data_ptr(), *sizes, lay.smem, _lib.ptr(ws), lay.chunk, grid,
                    _lib.ptr(stamps), stream)
        _lib.check(err, "poulpy_fused_product")
        return stamps

    return out, launch


def fused_br_step_ref(module: Module, acc, pmat, amounts, res_size: int, base2k: int):
    """Plain version of `fused_br_step`: the product (`fused_glwe_product_ref`),
    then acc + (X^a·tmp − tmp), the JAX package's standard blind-rotation
    loop body (`vec_znx_rotate`, wrapping int64)."""
    tmp = fused_glwe_product_ref(module, acc, pmat, res_size, base2k, base2k)
    return acc + (vec_znx_rotate(amounts[..., None, None], tmp) - tmp)


def fused_br_step(module: Module, acc, pmat, amounts, res_size: int, base2k: int, pm_k=None):
    """One step of the standard CGGI blind rotation for a batch:
    acc + X^{a}·tmp − tmp, tmp = the normalized product of the accumulator
    by one key element (`fused_glwe_product`), in wrapping int64.

    acc      [..., cols, res_size, N] int64 limbs, any values (unnormalized);
    pmat     [rows, cols, cols, psize, P, N] the key element (Montgomery);
    amounts  [...] int64 rotation amounts, any sign (a strided view is
             read in place);
    pm_k     [P, cols·rmax, cols·psize, N] int32: `pmat` in kernel layout
             (`pm_kernel_layout`), made from `pmat` when not given.
    → [..., cols, res_size, N] int64, a new tensor (the kernel reads the
    whole input accumulator in every block).  Plain version on CPU tensors,
    one CUDA launch on CUDA."""
    if acc.device.type == "cpu":
        return fused_br_step_ref(module, acc, pmat, amounts, res_size, base2k)
    out, launch = _product_launch(module, acc, pmat, res_size, base2k, base2k, amounts=amounts,
                                  pm_k=pm_k)
    if launch is not None:
        launch()
        LAUNCHES["fused_br_step"] += 1
    return out


def fused_br_steps(module: Module, acc, pmats, lwe_2n, res_size: int, base2k: int, pm_k=None):
    """The standard CGGI blind rotation's loop: `fused_br_step` by each key
    element pmats[i] in turn, with the amounts lwe_2n[..., i + 1]
    (`mod_switch_2n`'s output [..., n + 1]; column 0 is not read); `pm_k`
    [n, P, KK, M, N] the key in kernel layout (`pm_kernel_layout`, made
    from `pmats` when not given).  On CUDA the shapes are checked once and
    each step is one launch, out of place into two buffers used in turn;
    on the CPU each step is the plain version."""
    if acc.device.type == "cpu":
        for i in range(pmats.shape[0]):
            acc = fused_br_step_ref(module, acc, pmats[i], lwe_2n[..., i + 1], res_size, base2k)
        return acc
    return _br_steps_launch(module, acc, pmats, lwe_2n, res_size, base2k, pm_k)


def _br_steps_launch(module: Module, acc, pmats, lwe_2n, res_size: int, base2k: int,
                     pm_k=None):
    """`fused_br_steps`' launches, whatever the device (the CUDA emulation
    of tests/test_torch_cuda_emu.py runs them on CPU tensors)."""
    n = pmats.shape[0]
    if n == 0:
        return acc
    acc, lwe = acc.contiguous(), lwe_2n.contiguous()
    if pm_k is None:
        pm_k = pm_kernel_layout(pmats, min(pmats.shape[1], acc.shape[-2]))
    if pm_k.shape[0] != n or not pm_k.is_contiguous() or lwe.shape[-1] != n + 1:
        raise ValueError(f"pm_k {tuple(pm_k.shape)} / lwe_2n {tuple(lwe.shape)}: expected "
                         f"{n} contiguous key elements and {n + 1} amounts")
    bufs = (torch.empty_like(acc), torch.empty_like(acc))
    out, launch = _product_launch(module, acc, pmats[0], res_size, base2k, base2k,
                                  amounts=lwe[..., 1], pm_k=pm_k[0], out=bufs[0])
    if launch is None:
        return out
    pm_bytes, a_ptr = pm_k[0].numel() * pm_k.element_size(), acc.data_ptr()
    for i in range(n):
        out = bufs[i % 2]
        launch(ptrs=(a_ptr, pm_k.data_ptr() + i * pm_bytes,
                     lwe.data_ptr() + (i + 1) * lwe.element_size(), out.data_ptr()))
        LAUNCHES["fused_br_step"] += 1
        a_ptr = out.data_ptr()
    return out


# --------------------------------------------------------------------------
# The exit on its own: Garner lift → + small at column 0 → normalize
# --------------------------------------------------------------------------

def garner_exit_ref(module: Module, x, psize: int, res_size: int, res_base2k: int,
                    pm_base2k: int, small=None):
    """Plain version of `garner_exit`: the centred Garner lift of each limb,
    the body added at column 0, `vec_znx_normalize_full`."""
    del psize
    big = garner_lift(module.tables, x)
    if small is not None:   # garner_lift's output is fresh: add the body in place
        big[..., 0, :, :] += _align_limbs(small, big, big.shape[-2], limb_axis=-2)[0]
    return vec_znx_normalize_full(res_size, res_base2k, 0, big, pm_base2k)


# the shapes (P, psize, res_size, s_size, res_base2k, pm_base2k) of the exit's
# specialised instances (csrc/garner_exit.cu ExitShape): the "mxu" route's
# product and keyswitch (body of 3 limbs); any other takes the runtime-shaped one
EXIT_SHAPES = ((2, 4, 3, 0, 17, 17), (2, 4, 3, 3, 17, 17))


def garner_exit(module: Module, x, psize: int, res_size: int, res_base2k: int, pm_base2k: int,
                small=None):
    """`x` [..., co, psize, P, N] int32 coefficient residues (canonical, the
    inverse transform's N^{-1} applied) → [..., co, res_size, N] normalized
    int64 limbs of base 2^res_base2k; `small` [..., s_size, N] int64, if
    given, is added to column 0 (limbs past psize dropped).  Plain version on
    CPU tensors, one CUDA launch on CUDA (`csrc/garner_exit.cu`)."""
    if x.device.type == "cpu":
        return garner_exit_ref(module, x, psize, res_size, res_base2k, pm_base2k, small)
    out, launch = _exit_launch(module, x, psize, res_size, res_base2k, pm_base2k, small)
    if launch is not None:
        launch()
        LAUNCHES["garner_exit"] += 1
    return out


def _exit_launch(module: Module, x, psize: int, res_size: int, res_base2k: int, pm_base2k: int,
                 small=None, design: str = "tile"):
    """(out, launch) of one `garner_exit` launch on CUDA tensors, launch None
    for an empty batch: the "tile" design (the shapes of EXIT_SHAPES take
    their specialised instance, any other the runtime-shaped one) or its
    "parent".  Counts no launch."""
    if design not in ("tile", "parent"):
        raise ValueError(f"design must be 'tile' or 'parent', got {design!r}")
    P, n = module.nprimes, module.n
    lead, co = x.shape[:-4], x.shape[-4]
    if tuple(x.shape[-3:]) != (psize, P, n) or module.device != x.device:
        raise ValueError(f"x: expected [..., co, {psize}, {P}, {n}] on {module.device}, got "
                         f"{tuple(x.shape)} on {x.device}")
    _check_bounds(P, psize, res_size)
    B = x.numel() // (co * psize * P * n) if x.numel() else 0
    xm = x.reshape(B, co, psize, P, n).contiguous()
    _lib.require(xm, "x", torch.int32)
    small, s_size, sm_ptr = _body(small, lead, B, n)
    out = torch.empty(lead + (co, res_size, n), dtype=torch.int64, device=x.device)
    if B == 0:
        return out, None
    _, consts = kernel_tables(module.tables)
    entry = "poulpy_garner_exit_tile" if design == "tile" else "poulpy_garner_exit"

    def launch():
        err = getattr(_lib.library(), entry)(
            xm.data_ptr(), sm_ptr, out.data_ptr(), consts.data_ptr(), B, co, psize, s_size,
            res_size, res_base2k, pm_base2k, P, module.log_n, _lib.stream())
        _lib.check(err, entry)

    return out, launch


# --------------------------------------------------------------------------
# Rank-1 tensor product
# --------------------------------------------------------------------------

def fused_tensor_product_ref(module: Module, a_data, b_data, conv_size: int, dnum: int, kr: int,
                             ka: int):
    """Plain version: `glwe_tensor_product_big`'s rank-1 data flow (left
    operand standard NTT, right operand Montgomery NTT, limb convolution per
    column pair, Garner lift), then `big_normalize` of the quadratic term."""
    t = module.tables
    a_prep = ntt_forward(t, to_residues(t, a_data))
    b_prep = to_mont(t, ntt_forward(t, to_residues(t, b_data)))

    def conv(i, j):
        return cnv_apply(module, a_prep[..., i, :, :, :], b_prep[..., j, :, :, :], conv_size)

    terms = [conv(0, 0), dft_add(module, conv(0, 1), conv(1, 0)), conv(1, 1)]
    big = [garner_lift(t, ntt_inverse(t, x)) for x in terms]
    return vec_znx_normalize_full(dnum, kr, 0, big[2], ka), torch.stack(big[:2], dim=-3)


def tensor_smem_bytes(size_a: int, size_b: int, conv_size: int, n: int) -> int:
    """Shared memory of one block of the parent tensor design: the rows of
    one prime that the cross pair reads, or the conv_size rows written over
    them if more."""
    return 4 * n * max(2 * (size_a + size_b), conv_size)


def tensor_layout(size_a: int, size_b: int, conv_size: int, nprimes: int, n: int) -> Layout:
    """The parent design's layout of `tensor_product.cu` (one block per
    ciphertext and pair): shared where its workspace fits, else global, the
    workspace slot holding the input rows and the P·conv_size rows of the
    shared layout's scratch, the stage whole rows."""
    in_rows = 2 * (size_a + size_b)
    return kernel_layout(1, lambda _: tensor_smem_bytes(size_a, size_b, conv_size, n), False,
                         in_rows + nprimes * conv_size, lambda c: 4 * n * c,
                         max(in_rows, conv_size))


def tensor_lazy_layout(size_a: int, size_b: int, conv_size: int, nprimes: int, n: int,
                       pairs: int | None = None) -> Layout | None:
    """The tensor kernels' lazy design's layout (csrc/tensor.cuh), or None
    where it does not take the shape (N outside 256..2048, more than
    MAX_PRIMES primes or MAX_LIMBS limbs, or one prime's rows of a task past
    shared memory): all three column pairs per task where one prime's region
    of max(2·(size_a + size_b), 3·conv_size) rows fits, else one pair per
    task (max(2·(size_a + size_b), conv_size) rows for the cross pair); as
    many primes' regions as fit, `chunk` rows.  `pairs` (1 or 3) forces the
    task, for measurement."""
    logn = n.bit_length() - 1
    if not 8 <= logn <= 11 or nprimes > MAX_PRIMES or max(size_a, size_b, conv_size) > MAX_LIMBS:
        return None
    cap = (SMEM_LIMIT - TENSOR_STATIC_SMEM) // (4 * n)
    in_rows = 2 * (size_a + size_b)
    for g in ((3, 1) if pairs is None else (pairs,)):
        region = max(in_rows, g * conv_size)
        if region <= cap:
            rows = min(nprimes, cap // region) * region
            return Layout("lazy", 1, 4 * n * rows, chunk=rows, pairs=g)
    return None


def tensor_scratch_slots(lay: Layout, size_a: int, size_b: int, conv_size: int, nprimes: int,
                         B: int) -> int:
    """Scratch slots of a lazy tensor launch: one per task whose primes do
    not fit in one pass (the first tasks: the cross pairs, or every
    ciphertext), 0 if every task's do."""
    def passes_fit(region: int) -> bool:
        return lay.chunk // region >= nprimes

    if passes_fit(max(2 * (size_a + size_b), lay.pairs * conv_size)):
        return 0
    if lay.pairs == 3 or passes_fit(max(size_a + size_b, conv_size)):
        return B
    return 3 * B


def tensor_design_layout(size_a: int, size_b: int, conv_size: int, nprimes: int, n: int,
                         design: str = "lazy", pairs: int | None = None,
                         parent=tensor_layout) -> Layout:
    """The layout a launch of a tensor kernel takes: the lazy design's where
    it takes the shape (`design` "lazy"), else its parent design's, `parent`
    (`tensor_layout`, or `wide.tensor_wide_layout` for the wide kernel,
    whose parent keeps the conv rows in shared memory)."""
    if design not in ("lazy", "parent"):
        raise ValueError(f"design: 'lazy' or 'parent', got {design!r}")
    lay = tensor_lazy_layout(size_a, size_b, conv_size, nprimes, n, pairs) \
        if design == "lazy" else None
    return lay or parent(size_a, size_b, conv_size, nprimes, n)


def tensor_fits(module: Module, size_a: int, size_b: int, conv_size: int, dnum: int) -> bool:
    """True when `fused_tensor_product`'s kernel takes these shapes: its
    compile-time bounds (any N: the global layout takes what shared memory
    does not)."""
    return module.nprimes <= MAX_PRIMES and max(size_a, size_b, conv_size, dnum) <= MAX_LIMBS


def _tensor_operands(module: Module, a_data, b_data):
    """(lead, size_a, size_b, B, a, b) of a tensor launch: the batch shape,
    the limbs, and both operands as contiguous [B, 2, size, N] int64."""
    n = module.n
    lead = a_data.shape[:-3]
    size_a, size_b = a_data.shape[-2], b_data.shape[-2]
    if tuple(a_data.shape[-3:]) != (2, size_a, n) or tuple(b_data.shape) != tuple(lead) + (
            2, size_b, n):
        raise ValueError(f"a_data {tuple(a_data.shape)}, b_data {tuple(b_data.shape)}: expected "
                         f"rank-1 ciphertexts [..., 2, size, {n}] with one batch shape")
    if b_data.device != a_data.device or module.device != a_data.device:
        raise ValueError("a_data, b_data and module must be on one device")
    B = a_data.numel() // (2 * size_a * n) if a_data.numel() else 0
    a = a_data.reshape(B, 2, size_a, n).contiguous()
    b = b_data.reshape(B, 2, size_b, n).contiguous()
    _lib.require(a, "a_data", torch.int64)
    _lib.require(b, "b_data", torch.int64)
    return lead, size_a, size_b, B, a, b


def tensor_lazy_scratch(lay: Layout, size_a: int, size_b: int, conv_size: int, nprimes: int,
                        B: int, n: int, device):
    """The lazy tensor launch's scratch [slots, P, pairs·conv_size, N] int32,
    or None."""
    slots = tensor_scratch_slots(lay, size_a, size_b, conv_size, nprimes, B)
    if not slots:
        return None
    return torch.empty((slots, nprimes, lay.pairs * conv_size, n), dtype=torch.int32,
                       device=device)


def fused_tensor_product(module: Module, a_data, b_data, conv_size: int, dnum: int, kr: int,
                         ka: int):
    """Rank-1 tensor product of `a_data` [..., 2, size_a, N] and `b_data`
    [..., 2, size_b, N] int64 limbs (base 2^ka) → (d [..., dnum, N], the
    quadratic term a1·b1 normalized to `dnum` digits of base 2^kr; lin64
    [..., 2, conv_size, N], the wrapping-int64 linear terms a0·b0 and
    a0·b1 + a1·b0).  Plain version on CPU tensors, one CUDA launch on CUDA."""
    if a_data.device.type == "cpu":
        return fused_tensor_product_ref(module, a_data, b_data, conv_size, dnum, kr, ka)
    out, launch = _tensor_launch(module, a_data, b_data, conv_size, dnum, kr, ka)
    if launch is not None:
        launch()
        LAUNCHES["tensor_product"] += 1
    return out


def _tensor_launch(module: Module, a_data, b_data, conv_size: int, dnum: int, kr: int, ka: int,
                   design: str = "lazy", pairs: int | None = None):
    """The checked arguments of one `fused_tensor_product` launch: ((d, lin),
    launch) with launch(timed=False) → the stage clock's stamps or None
    (launch None for an empty batch); `design` "lazy" or "parent"
    (`tensor_design_layout`, `pairs` forcing the lazy design's task).
    Counts no launch."""
    P, n = module.nprimes, module.n
    if not tensor_fits(module, a_data.shape[-2], b_data.shape[-2], conv_size, dnum):
        raise ValueError(f"tensor kernel bounds: P ≤ {MAX_PRIMES}, limbs ≤ {MAX_LIMBS}")
    lead, size_a, size_b, B, a, b = _tensor_operands(module, a_data, b_data)
    lay = tensor_design_layout(size_a, size_b, conv_size, P, n, design, pairs)
    d = torch.empty(lead + (dnum, n), dtype=torch.int64, device=a_data.device)
    lin = torch.empty(lead + (2, conv_size, n), dtype=torch.int64, device=a_data.device)
    if B == 0:
        return (d, lin), None
    tw, consts = kernel_tables(module.tables)
    sizes = (B, size_a, size_b, conv_size, dnum, kr, ka, P, module.log_n)

    def launch(timed: bool = False):
        # the closure holds every tensor whose pointer it passes
        args = (a.data_ptr(), b.data_ptr(), d.data_ptr(), lin.data_ptr())
        if lay.kind == "lazy":
            scratch = tensor_lazy_scratch(lay, size_a, size_b, conv_size, P, B, n, a.device)
            stamps = _stamps(timed, B if lay.pairs == 3 else 3 * B, a.device, TENSOR_STAGES)
            err = _lib.library().poulpy_tensor_product_lazy(
                *args, _lib.ptr(scratch), shoup_tables(module.tables).data_ptr(),
                consts.data_ptr(), *sizes, lay.pairs, lay.chunk, lay.smem, _lib.ptr(stamps),
                _lib.stream())
        else:
            if timed and lay.kind == "global":
                raise ValueError("the stage clock runs the shared layout only")
            ws, grid = launch_workspace(lay, 3 * B, n, a.device)
            scratch = None if ws is not None else torch.empty((3 * B, P, conv_size, n),
                                                              dtype=torch.int32, device=a.device)
            stamps = _stamps(timed, 3 * B, a.device, TENSOR_STAGES)
            err = _lib.library().poulpy_tensor_product(
                *args, _lib.ptr(scratch), tw.data_ptr(), consts.data_ptr(), *sizes, lay.smem,
                _lib.ptr(ws), lay.chunk, grid, _lib.ptr(stamps), _lib.stream())
        _lib.check(err, "poulpy_tensor_product")
        return stamps

    return (d, lin), launch


def tensor_stage_cycles(module: Module, *args, design: str = "lazy"):
    """((d, lin), stamps) of one launch of the stage clock's instance on
    `fused_tensor_product`'s arguments: stamps [blocks, len(TENSOR_STAGES)]
    int64, the SM cycles each block spent in each stage.  For measurement
    only: no path calls it, and it counts no launch."""
    out, launch = _tensor_launch(module, *args, design=design)
    return out, launch(timed=True)


# --------------------------------------------------------------------------
# Block-binary CGGI step
# --------------------------------------------------------------------------

def _ntt_of_x(p: int, n: int) -> np.ndarray:
    """`hal.ntt.ntt_forward` of the monomial X for one prime, in numpy
    (the same psi tables and stage schedule), canonical [0, p)."""
    psi_t, _, _ = _host_tables((p,), n)
    src = psi_t[0] * pow(R, -1, p) % p                   # tables are Montgomery-form
    x = np.zeros(n, dtype=np.int64)
    x[1] = 1
    for s in range(n.bit_length() - 1):
        m, half = 1 << s, n >> (s + 1)
        w = src[m : 2 * m]
        xr = x.reshape(m, 2, half)
        lo, hi = xr[:, 0, :], xr[:, 1, :]
        v = hi * w[:, None] % p
        x = np.stack([(lo + v) % p, (lo - v) % p], axis=1).reshape(n)
    return x


@functools.lru_cache(maxsize=None)
def _xpow_table(n: int, primes: tuple) -> np.ndarray:
    """Montgomery NTT(X^j) for every j in [0, 2N): `[2N, P, N]` int64 numpy.
    NTT(X^j) = NTT(X)^{⊙j} pointwise, and X^{N+j} = −X^j."""
    out = np.zeros((2 * n, len(primes), n), dtype=np.int64)
    for pi, p in enumerate(primes):
        base = _ntt_of_x(p, n)
        row = np.full(n, R % p, dtype=np.int64)          # Montgomery(X^0)
        for j in range(n):
            out[j, pi] = row
            row = row * base % p                         # < 2^60: exact in int64
        out[n:, pi] = (p - out[:n, pi]) % p
    return out


@functools.lru_cache(maxsize=None)
def _xpow_minus1_table(n: int, primes: tuple) -> np.ndarray:
    """Montgomery NTT(X^j − 1) for every j in [0, 2N): `[2N, P, N]` int64
    numpy.  The block-step kernel folds CGGI's rotate-and-subtract into one
    multiply by a row of this table."""
    p_arr = np.array(primes, dtype=np.int64)[None, :, None]
    one_m = np.array([R % p for p in primes], dtype=np.int64)[None, :, None]
    return (_xpow_table(n, primes) - one_m) % p_arr


def xpow_tables(module: Module):
    """(`_xpow_table`, `_xpow_minus1_table`) as int32 tensors on the
    module's device, uploaded once per table set (16 MB each at N = 1024,
    P = 2)."""
    t = module.tables
    cached = getattr(t, "_xpow", None)
    if cached is None:
        primes = module.basis.primes
        cached = tuple(torch.from_numpy(f(module.n, primes).astype(np.int32)).to(module.device)
                       for f in (_xpow_table, _xpow_minus1_table))
        t._xpow = cached
    return cached


def xpow_minus1_sigma(module: Module):
    """`_xpow_minus1_table` in σ order (the order of the MXU transforms'
    NTT, `mxu.sigma_index`) as an int32 tensor on the module's device, made
    once per table set: the x-power rows of `fused_mxu_br_block_step`."""
    t = module.tables
    cached = getattr(t, "_xpm1_sigma", None)
    if cached is None:
        cached = xpow_tables(module)[1][..., sigma_index(t)].contiguous()
        t._xpm1_sigma = cached
    return cached


def _check_chain(steps: int, nkeys: int, size: int, res_size: int) -> int:
    """The block of a launch of `steps` chained block steps over `nkeys`
    key elements; raises where `steps` does not divide them, or where a
    chain's steps do not keep the accumulator's size (the JAX package's
    assertion)."""
    if steps < 1 or nkeys % steps:
        raise ValueError(f"steps={steps} does not divide the {nkeys} key elements")
    if steps > 1 and size != res_size:
        raise ValueError(f"chained steps need size == res_size, got {size} and {res_size}")
    return nkeys // steps


def fused_br_block_step_ref(module: Module, acc, pmats, a_blk, res_size: int, base2k: int,
                            steps: int = 1):
    """Plain version of `steps` block-binary CGGI steps in sequence, each
    the jnp `block_step` of `poulpy_tpu/binfhe/blind_rotation.py`: per key
    element i, the VMP of dft(acc) with BRK_i, times NTT(X^{a_i}), minus
    itself; the sum over i, idft, plus acc at the aligned limbs, normalized
    to `res_size` limbs.  Step st takes key elements st·block … st·block +
    block − 1 of `pmats` and `a_blk`."""
    block = _check_chain(steps, pmats.shape[0], acc.shape[-2], res_size)
    t = module.tables
    xpow, _ = xpow_tables(module)
    for st in range(steps):
        keys = slice(st * block, (st + 1) * block)
        acc_dft = _dft_plain(module, acc)
        add_dft = None
        for pm, a in zip(pmats[keys], a_blk[..., keys].unbind(-1)):
            vmp_res = vmp_apply_ref(module, acc_dft, pm)
            xp = xpow[a & (2 * module.n - 1)]                   # [..., P, N]
            rot = mont_mul(vmp_res, xp[..., None, None, :, :], t.p[:, None], t.qinv[:, None])
            term = dft_sub(module, rot, vmp_res)
            add_dft = term if add_dft is None else dft_add(module, add_dft, term)
        big = garner_lift(t, ntt_inverse(t, add_dft))
        big = big + _align_limbs(acc, big, big.shape[-2], limb_axis=-2)[0]
        acc = vec_znx_normalize_full(res_size, base2k, 0, big, base2k)
    return acc


def fused_br_block_step(module: Module, acc, pmats, a_blk, res_size: int, base2k: int,
                        pm_k=None, steps: int = 1):
    """`steps` block-binary CGGI steps for a batch, in one launch.

    acc    [..., cols, size, N] int64 limbs;
    pmats  [steps·block, rows, cols, cols, psize, P, N] the prepared BRK
           elements of the steps' blocks, in order (Montgomery);
    a_blk  [..., steps·block] int64 mod-switched rotation amounts, any sign;
    pm_k   [steps·block, P, cols·rmax, cols·psize, N] int32: `pmats` in
           kernel layout (`pm_kernel_layout`), made from `pmats` when not given;
    steps  block steps chained in the launch (the JAX package's `steps`):
           step st runs key elements st·block … st·block + block − 1 on the
           previous step's normalized accumulator, so size == res_size.
    → [..., cols, res_size, N] normalized limbs.  Plain version on CPU
    tensors, one CUDA launch on CUDA (the x-power factor gathered in the
    kernel from the device `_xpow_minus1_table` by `a & (2N − 1)`), counted
    under "br_block_step", or "br_block_chain" for steps > 1.  A chain runs
    only in the lazy design (`chain_steps`): elsewhere it raises."""
    if acc.device.type == "cpu":
        return fused_br_block_step_ref(module, acc, pmats, a_blk, res_size, base2k, steps)
    out, launch = _block_step_launch(module, acc, pmats, a_blk, res_size, base2k, pm_k, steps)
    if launch is not None:
        launch()
        LAUNCHES["br_block_chain" if steps > 1 else "br_block_step"] += 1
    return out


def _block_layout(module: Module, kk: int, cols: int, psize: int, res_size: int, block: int,
                  steps: int, design: str) -> Layout:
    """The layout of a launch of `steps` block steps (`butterfly_layout`;
    a chain keeps its normalized limbs in shared memory too)."""
    return butterfly_layout(kk, cols, psize, module.nprimes, module.n, res_size, steps * block,
                            split=False, design=design, step=steps > 1)


def chain_steps(module: Module, acc, pmats, res_size: int, block: int, steps: int) -> int:
    """`steps` where `fused_br_block_step` can chain that many block steps
    of `block` key elements on `acc` (always on the CPU, where the plain
    version runs; on CUDA where the lazy design takes the chain's shape),
    else 1."""
    if steps <= 1 or acc.device.type == "cpu":
        return steps
    cols, rmax, psize = acc.shape[-3], min(pmats.shape[1], acc.shape[-2]), pmats.shape[4]
    lay = _block_layout(module, cols * rmax, cols, psize, res_size, block, steps, "lazy")
    return steps if lay.kind == "lazy" and acc.shape[-2] == res_size else 1


def _block_step_launch(module: Module, acc, pmats, a_blk, res_size: int, base2k: int,
                       pm_k=None, steps: int = 1, design: str = "lazy"):
    """The checked arguments of one `fused_br_block_step` launch, as
    `_product_launch`'s; `steps` > 1 raises outside the lazy design."""
    P, n = module.nprimes, module.n
    nkeys, rows, cols, co, psize = pmats.shape[:5]
    lead, size = acc.shape[:-3], acc.shape[-2]
    block = _check_chain(steps, nkeys, size, res_size)
    rmax = min(rows, size)
    kk, mdim = cols * rmax, cols * psize
    if co != cols or acc.shape[-3] != cols or acc.shape[-1] != n:
        raise ValueError(f"acc {tuple(acc.shape)} does not match the key's {cols} columns")
    if tuple(a_blk.shape) != tuple(lead) + (nkeys,):
        raise ValueError(f"a_blk: expected {tuple(lead) + (nkeys,)}, got {tuple(a_blk.shape)}")
    lay = _block_layout(module, kk, cols, psize, res_size, block, steps, design)
    if steps > 1 and lay.kind != "lazy":
        raise ValueError(f"a chain of {steps} block steps runs in the lazy design only; "
                         f"this shape takes the {design} design's {lay.kind} layout")
    _check_bounds(P, psize, res_size)
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
    _, xpm1 = xpow_tables(module)
    tw, consts = kernel_tables(module.tables)

    def launch(timed: bool = False):
        args = (a.data_ptr(), pm_k.data_ptr(), xpm1.data_ptr(), amounts.data_ptr(),
                out.data_ptr())
        sizes = (B, cols, size, rmax, psize, res_size, base2k, block)
        if lay.kind == "lazy":
            stamps = _stamps(timed, -(-B // lay.tile), acc.device)
            err = _lib.library().poulpy_br_block_step_lazy(
                *args, shoup_tables(module.tables).data_ptr(), consts.data_ptr(), *sizes, steps,
                P, module.log_n, lay.tile, lay.smem, _lib.ptr(stamps), _lib.stream())
        else:
            if timed and lay.kind == "global":
                raise ValueError("the stage clock runs the shared layout only")
            stamps = _stamps(timed, B, acc.device)
            ws, grid = launch_workspace(lay, B, n, acc.device)
            err = _lib.library().poulpy_br_block_step(
                *args, tw.data_ptr(), consts.data_ptr(), *sizes, P, module.log_n, lay.smem,
                _lib.ptr(ws), lay.chunk, grid, _lib.ptr(stamps), _lib.stream())
        _lib.check(err, "poulpy_br_block_step")
        return stamps

    return out, launch


def stage_cycles(module: Module, *args, block_step: bool = False, design: str = "lazy"):
    """(out, stamps) of one launch of the stage clock's instance on
    `fused_glwe_product`'s arguments (`block_step`: `fused_br_block_step`'s):
    stamps [blocks, len(STAGES)] int64, the SM cycles each block spent in
    each stage, from thread 0 at the barriers that close them.  For
    measurement only: no path calls it, and it counts no launch."""
    prepare = _block_step_launch if block_step else _product_launch
    out, launch = prepare(module, *args, design=design)
    return out, launch(timed=True)
