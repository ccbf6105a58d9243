"""Wide fused kernels (`csrc/wide_product.cu`, `csrc/wide_tensor.cu`) and
their plain PyTorch twins.

Replace the two kernels of `poulpy_tpu/backends/pallas_wide.py`, whose big
values are exact 128-bit integers (the reference's NTT120 i128 accumulator,
for base2k up to ~52):

- `fused_glwe_product_wide` (`_pipe_wide_fn`):
      big_normalize_wide(idft_wide(vmp(dft(a), pmat)) [+ small per column], offset);
  two designs: the lazy one (`wide_lazy_layout`: the butterfly kernels' lazy
  body with the tensor kernels' 128-bit exit) where it takes the shape, and
  the parent one (`fused.product_layout`, its global layout past shared
  memory), which takes the rest and is the stage clock's reference;
- `fused_tensor_product_wide` (`_tensor_wide_fn`): the rank-1 ct × ct limb
  convolution, its quadratic term normalized to the relinearization's
  digits and its linear terms to ciphertext limbs, both with CKKS mul's
  landing offset; two designs, as `fused.fused_tensor_product`'s (the lazy
  one shared with it in `csrc/tensor.cuh`).

Each wrapper takes its plain version for a CPU tensor and launches its
kernel for a CUDA one.  The plain versions (`*_ref`) are built from plain
parts only (`hal/ntt.py`, `hal/wide.py`, `cnv_apply`), so on a CUDA tensor
they launch no kernel of `csrc/`.  The JAX kernels' lazy-prime condition
(p < 2^28, for Mosaic's digit products) is not a bound here: the kernels take
any basis the port supports.
"""

from __future__ import annotations

import torch

from poulpy_tpu_torch.backends import LAUNCHES, _lib
from poulpy_tpu_torch.backends._lib import SMEM_LIMIT
from poulpy_tpu_torch.backends.fused import (
    MAX_LIMBS,
    MAX_PRIMES,
    TENSOR_STAGES,
    Layout,
    _check_bounds,
    _stamps,
    _tensor_operands,
    kernel_layout,
    launch_workspace,
    pm_kernel_layout,
    pm_kernel_layout_dsize,
    product_dft_ref,
    product_layout,
    tensor_design_layout,
    tensor_lazy_scratch,
)
from poulpy_tpu_torch.backends.ntt import kernel_tables, shoup_tables
from poulpy_tpu_torch.hal.dft import cnv_apply, dft_add
from poulpy_tpu_torch.hal.module import Module
from poulpy_tpu_torch.hal.ntt import ntt_forward, ntt_inverse, to_mont, to_residues
from poulpy_tpu_torch.hal.wide import (
    garner_lift_wide,
    vec_znx_normalize_full_wide,
    wide_add_small,
)


# the stages of the wide product's stage clock (csrc/wide_product.cu WP_*)
WIDE_STAGES = ("entry_fwd", "vmp", "inv", "lift")
# The shapes with a specialised instance of the wide product's lazy design
# (csrc/wide_product.cu MulShape): (log N, KK, cpb·psize, P, psize, res_size,
# kr, ka), the CKKS-wide mul's relinearization.  Any other shape takes the
# runtime-shaped instance.
WIDE_SHAPES = {(11, 2, 6, 5, 3, 2, 52, 52)}
# shared bytes the lazy wide product keeps beside its rows (its static
# __shared__ constants: PrimeL per prime, row offsets, ExitPrimes)
WIDE_STATIC_SMEM = 2048


def fused_wide_supported(psize: int, res_base2k: int, a_base2k: int) -> bool:
    """The wide product's windows fit int64: res_base2k plus the carry bits
    of psize limbs, and both bases at most 59 bits."""
    return res_base2k + (psize + 1).bit_length() <= 63 and max(res_base2k, a_base2k) <= 59


def tensor_wide_supported(conv_size: int, kr: int, ka: int) -> bool:
    return max(kr, ka) + (conv_size + 1).bit_length() <= 63 and max(kr, ka) <= 59


def _idft_wide_plain(module: Module, res_dft):
    t = module.tables
    return garner_lift_wide(t, ntt_inverse(t, res_dft))


def fused_glwe_product_wide_ref(module: Module, a_data, pmat, res_size: int, res_base2k: int,
                                pm_base2k: int, small=None, res_offset: int = 0, dsize: int = 1):
    """Plain version: dft → vmp → idft_wide → (+ small per column) →
    normalize_wide, every stage in plain PyTorch."""
    pair = _idft_wide_plain(module, product_dft_ref(module, a_data, pmat, dsize))
    if small is not None:
        pair = wide_add_small(pair, small)
    return vec_znx_normalize_full_wide(res_size, res_base2k, res_offset, pair, pm_base2k)


def wide_lazy_layout(kk: int, co: int, psize: int, nprimes: int, n: int) -> Layout | None:
    """The lazy design's layout of `wide_product.cu`, or None where it does
    not take the shape (N outside 256..2048, no input row or more than
    MAX_LIMBS input or output rows, P past MAX_PRIMES, or no column group
    whose rows of one prime fit): the most output columns per block whose
    region of max(KK, cpb·psize) rows fits in shared memory, the primes in
    as few passes as fit, split evenly; `chunk` rows per pass."""
    logn = n.bit_length() - 1
    if not 8 <= logn <= 11 or not 0 < kk <= MAX_LIMBS or nprimes > MAX_PRIMES:
        return None
    cap = (SMEM_LIMIT - WIDE_STATIC_SMEM) // (4 * n)
    for cpb in range(co, 0, -1):
        region = max(kk, cpb * psize)
        if co % cpb or cpb * psize > MAX_LIMBS or region > cap:
            continue
        passes = -(-nprimes // (cap // region))
        rows = -(-nprimes // passes) * region
        return Layout("lazy", cpb, 4 * n * rows, chunk=rows)
    return None


def wide_design_layout(kk: int, co: int, psize: int, nprimes: int, n: int,
                       design: str = "lazy") -> Layout:
    """The layout a launch of `wide_product.cu` takes: the lazy design's
    where it takes the shape (`design` "lazy"), else the parent design's
    `product_layout`."""
    if design not in ("lazy", "parent"):
        raise ValueError(f"design: 'lazy' or 'parent', got {design!r}")
    lay = wide_lazy_layout(kk, co, psize, nprimes, n) if design == "lazy" else None
    return lay or product_layout(kk, co, psize, nprimes, n)


def wide_scratch(lay: Layout, kk: int, psize: int, nprimes: int, tasks: int, n: int, device):
    """The lazy launch's scratch [tasks, P, cpb·psize, N] int32 where its
    primes run in passes, else None."""
    mrows = lay.cpb * psize
    if lay.chunk // max(kk, mrows) >= nprimes:
        return None
    return torch.empty((tasks, nprimes, mrows, n), dtype=torch.int32, device=device)


def fused_glwe_product_wide(module: Module, a_data, pmat, res_size: int, res_base2k: int,
                            pm_base2k: int, small=None, res_offset: int = 0, dsize: int = 1):
    """`a_data` [..., ci, size_a, N] int64 limbs × `pmat` [rows, ci, co,
    psize, P, N] → [..., co, res_size, N] normalized limbs in base
    2^res_base2k, the value landed at 2^res_offset.  `small` [..., co,
    s_size, N] int64, if given, is added to each column's first limbs before
    the normalization.  Plain version on CPU tensors, one CUDA launch on CUDA."""
    psize = pmat.shape[3]
    if not fused_wide_supported(psize, res_base2k, pm_base2k):
        raise ValueError(f"wide product windows: base2k {res_base2k}/{pm_base2k}, psize {psize}")
    if a_data.device.type == "cpu":
        return fused_glwe_product_wide_ref(module, a_data, pmat, res_size, res_base2k,
                                           pm_base2k, small, res_offset, dsize)
    out, launch = _wide_product_launch(module, a_data, pmat, res_size, res_base2k, pm_base2k,
                                       small, res_offset, dsize)
    if launch is not None:
        launch()
        LAUNCHES["wide_product"] += 1
    return out


def _wide_product_launch(module: Module, a_data, pmat, res_size: int, res_base2k: int,
                         pm_base2k: int, small=None, res_offset: int = 0, dsize: int = 1,
                         design: str = "lazy"):
    """The checked arguments of one `fused_glwe_product_wide` launch: (out,
    launch) with launch(timed=False) → the stage clock's stamps or None
    (launch None for an empty batch); `design` "lazy" or "parent"
    (`wide_design_layout`).  Counts no launch."""
    rows, ci, co, psize = pmat.shape[:4]
    P, n = module.nprimes, module.n
    lead, a_size = a_data.shape[:-3], a_data.shape[-2]
    rmax = min(rows * dsize, a_size)
    kk = ci * rmax
    if a_data.shape[-3] != ci or a_data.shape[-1] != n:
        raise ValueError(f"a_data: expected [..., {ci}, size, {n}], got {tuple(a_data.shape)}")
    lay = wide_design_layout(kk, co, psize, P, n, design)
    _check_bounds(P, psize, res_size)
    if pmat.device != a_data.device or module.device != a_data.device:
        raise ValueError("a_data, pmat and module must be on one device")
    pm = pm_kernel_layout(pmat, rmax) if dsize == 1 else pm_kernel_layout_dsize(pmat, rmax, dsize)
    B = a_data.numel() // (ci * a_size * n) if a_data.numel() else 0
    a = a_data.reshape(B, ci, a_size, n).contiguous()
    _lib.require(a, "a_data", torch.int64)
    s_size = 0
    if small is not None:
        s_size = small.shape[-2]
        if tuple(small.shape) != tuple(lead) + (co, s_size, n):
            raise ValueError(f"small: expected {tuple(lead) + (co, s_size, n)}, "
                             f"got {tuple(small.shape)}")
        small = small.reshape(B, co, s_size, n).contiguous()
        _lib.require(small, "small", torch.int64)
    out = torch.empty(lead + (co, res_size, n), dtype=torch.int64, device=a_data.device)
    if B == 0:
        return out, None
    tw, consts = kernel_tables(module.tables)
    tasks = B * (co // lay.cpb)
    sizes = (B, ci, a_size, rmax, co, psize, s_size, res_size, res_base2k, pm_base2k, res_offset,
             lay.cpb, P, module.log_n)

    def launch(timed: bool = False):
        stamps = _stamps(timed, tasks, a.device, WIDE_STAGES)
        # the closure holds every tensor whose pointer it passes
        args = (a.data_ptr(), pm.data_ptr(), _lib.ptr(small), out.data_ptr())
        if lay.kind == "lazy":
            scratch = wide_scratch(lay, kk, psize, P, tasks, n, a.device)
            err = _lib.library().poulpy_wide_product_lazy(
                *args, _lib.ptr(scratch), shoup_tables(module.tables).data_ptr(),
                consts.data_ptr(), *sizes, lay.chunk, lay.smem, _lib.ptr(stamps), _lib.stream())
        else:
            if timed and lay.kind == "global":
                raise ValueError("the stage clock runs the shared layout only")
            ws, grid = launch_workspace(lay, tasks, n, a.device)
            err = _lib.library().poulpy_wide_product(
                *args, tw.data_ptr(), consts.data_ptr(), *sizes, lay.smem, _lib.ptr(ws),
                lay.chunk, grid, _lib.ptr(stamps), _lib.stream())
        _lib.check(err, "poulpy_wide_product")
        return stamps

    return out, launch


def wide_product_stage_cycles(module: Module, *args, design: str = "lazy"):
    """(out, stamps) of one launch of the stage clock's instance on
    `fused_glwe_product_wide`'s arguments: stamps [blocks, len(WIDE_STAGES)]
    int64, the SM cycles each block spent in each stage.  For measurement
    only: no path calls it, and it counts no launch."""
    out, launch = _wide_product_launch(module, *args, design=design)
    return out, launch(timed=True)


# --------------------------------------------------------------------------
# Rank-1 tensor product
# --------------------------------------------------------------------------

def fused_tensor_product_wide_ref(module: Module, a_data, b_data, conv_size: int, dnum: int,
                                  lin_size: int, kr: int, ka: int, offset: int = 0):
    """Plain version: `glwe_tensor_product_big(wide=True)`'s rank-1 data
    flow (left operand standard NTT, right operand Montgomery NTT, limb
    convolution per column pair, wide lift) and the two normalizations."""
    t = module.tables
    a_prep = ntt_forward(t, to_residues(t, a_data))
    b_prep = to_mont(t, ntt_forward(t, to_residues(t, b_data)))

    def conv(i, j):
        return cnv_apply(module, a_prep[..., i, :, :, :], b_prep[..., j, :, :, :], conv_size)

    terms = [conv(0, 0), dft_add(module, conv(0, 1), conv(1, 0)), conv(1, 1)]
    big = [_idft_wide_plain(module, x) for x in terms]
    d = vec_znx_normalize_full_wide(dnum, kr, offset, big[2], ka)
    lin = torch.stack([vec_znx_normalize_full_wide(lin_size, ka, offset, x, ka) for x in big[:2]],
                      dim=-3)
    return d, lin


def wide_tensor_smem_bytes(size_a: int, size_b: int, conv_size: int, nprimes: int, n: int) -> int:
    """Shared memory of one tensor block: both columns of both operands (one
    prime at a time), then one pair's conv_size rows for every prime."""
    return 4 * n * (2 * (size_a + size_b) + nprimes * conv_size)


def tensor_wide_layout(size_a: int, size_b: int, conv_size: int, nprimes: int, n: int) -> Layout:
    """The parent design's layout of `wide_tensor.cu` (one block per
    ciphertext and pair): the global workspace holds the same rows, the
    stage whole rows."""
    in_rows = 2 * (size_a + size_b)
    return kernel_layout(1, lambda _: wide_tensor_smem_bytes(size_a, size_b, conv_size, nprimes, n),
                         False, in_rows + nprimes * conv_size, lambda c: 4 * n * c,
                         max(in_rows, conv_size))


def fused_tensor_product_wide(module: Module, a_data, b_data, conv_size: int, dnum: int,
                              lin_size: int, kr: int, ka: int, offset: int = 0):
    """Rank-1 wide tensor product of `a_data` [..., 2, size_a, N] and
    `b_data` [..., 2, size_b, N] int64 limbs → (d [..., dnum, N], the
    quadratic term in `dnum` digits of base 2^kr; lin [..., 2, lin_size, N],
    the linear terms in limbs of base 2^ka), both landed at 2^offset.  Plain
    version on CPU tensors, one CUDA launch on CUDA."""
    if not tensor_wide_supported(conv_size, kr, ka):
        raise ValueError(f"wide tensor windows: base2k {kr}/{ka}, conv_size {conv_size}")
    if a_data.device.type == "cpu":
        return fused_tensor_product_wide_ref(module, a_data, b_data, conv_size, dnum, lin_size,
                                             kr, ka, offset)
    out, launch = _tensor_wide_launch(module, a_data, b_data, conv_size, dnum, lin_size, kr, ka,
                                      offset)
    if launch is not None:
        launch()
        LAUNCHES["wide_tensor"] += 1
    return out


def _tensor_wide_launch(module: Module, a_data, b_data, conv_size: int, dnum: int,
                        lin_size: int, kr: int, ka: int, offset: int = 0, design: str = "lazy",
                        pairs: int | None = None):
    """The checked arguments of one `fused_tensor_product_wide` launch, as
    `fused._tensor_launch`'s: ((d, lin), launch(timed=False) → stamps or
    None)."""
    P, n = module.nprimes, module.n
    lead, size_a, size_b, B, a, b = _tensor_operands(module, a_data, b_data)
    lay = tensor_design_layout(size_a, size_b, conv_size, P, n, design, pairs,
                               tensor_wide_layout)
    _check_bounds(P, conv_size, max(dnum, lin_size))
    d = torch.empty(lead + (dnum, n), dtype=torch.int64, device=a_data.device)
    lin = torch.empty(lead + (2, lin_size, n), dtype=torch.int64, device=a_data.device)
    if B == 0:
        return (d, lin), None
    tw, consts = kernel_tables(module.tables)
    sizes = (B, size_a, size_b, conv_size, dnum, lin_size, kr, ka, offset, P, module.log_n)

    def launch(timed: bool = False):
        # the closure holds every tensor whose pointer it passes
        args = (a.data_ptr(), b.data_ptr(), d.data_ptr(), lin.data_ptr())
        if lay.kind == "lazy":
            scratch = tensor_lazy_scratch(lay, size_a, size_b, conv_size, P, B, n, a.device)
            stamps = _stamps(timed, B if lay.pairs == 3 else 3 * B, a.device, TENSOR_STAGES)
            err = _lib.library().poulpy_wide_tensor_lazy(
                *args, _lib.ptr(scratch), shoup_tables(module.tables).data_ptr(),
                consts.data_ptr(), *sizes, lay.pairs, lay.chunk, lay.smem, _lib.ptr(stamps),
                _lib.stream())
        else:
            if timed and lay.kind == "global":
                raise ValueError("the stage clock runs the shared layout only")
            ws, grid = launch_workspace(lay, B * 3, n, a.device)
            stamps = _stamps(timed, 3 * B, a.device, TENSOR_STAGES)
            err = _lib.library().poulpy_wide_tensor(
                *args, tw.data_ptr(), consts.data_ptr(), *sizes, lay.smem, _lib.ptr(ws),
                lay.chunk, grid, _lib.ptr(stamps), _lib.stream())
        _lib.check(err, "poulpy_wide_tensor")
        return stamps

    return (d, lin), launch


def tensor_wide_stage_cycles(module: Module, *args, design: str = "lazy"):
    """((d, lin), stamps) of one launch of the stage clock's instance on
    `fused_tensor_product_wide`'s arguments, as `fused.tensor_stage_cycles`.
    For measurement only: no path calls it, and it counts no launch."""
    out, launch = _tensor_wide_launch(module, *args, design=design)
    return out, launch(timed=True)
