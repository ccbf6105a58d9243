"""Fused product kernels (`csrc/fused_product.cu`, `csrc/br_block_step.cu`,
`csrc/tensor_product.cu`), the standalone exit (`csrc/garner_exit.cu`) and
their plain PyTorch twins.

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
- the block-binary CGGI step (block > 1, rotate, add_acc):
  `fused_br_block_step`,
      acc ← normalize(acc + idft(Σ_i NTT(X^{a_i} − 1) · (dft(acc) ⊡ BRK_i)));
- the rank-1 tensor product: `fused_tensor_product`, the quadratic term's
  gadget digits and the raw 64-bit linear terms that feed `small64`;

and `_kernel_b_fn` → `_kernel_b`, the exit of the "mxu" route on its own:
`garner_exit`, coefficient residues → Garner lift → + small → normalize.

Each wrapper takes its plain version for a CPU tensor and launches its
kernel for a CUDA one.  The plain versions (`*_ref`) are built from plain
parts only, so on a CUDA tensor they launch no kernel of `csrc/`.  The
fused kernels' wrappers choose a layout by formula (`kernel_layout`): the
shared one where a block's rows fit in shared memory, else the global one
(the rows in a device workspace, the transforms staged through shared
memory).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from poulpy_tpu_torch.backends import LAUNCHES, _lib
from poulpy_tpu_torch.backends.mxu import sigma_index
from poulpy_tpu_torch.backends.ntt import kernel_tables
from poulpy_tpu_torch.backends.vmp import vmp_apply_ref
from poulpy_tpu_torch.hal.dft import _align_limbs, cnv_apply, dft_add, dft_limbs, dft_sub
from poulpy_tpu_torch.hal.module import Module
from poulpy_tpu_torch.hal.normalization import vec_znx_normalize_full
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

SMEM_LIMIT = 232448     # bytes of shared memory one block may use on sm_90
MAX_PRIMES = 8          # compile-time bounds of the kernel's per-thread arrays
MAX_LIMBS = 16


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
    columns per block, one block per task.  "global": in a global workspace
    slot of `ws_rows` rows of N words per block (all co columns in one task,
    the blocks walking the tasks), each transform staged through `smem`
    bytes of shared memory `chunk` rows at a time."""

    kind: str
    cpb: int
    smem: int
    chunk: int = 0
    ws_rows: int = 0


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
    grid = min(tasks, 2 * torch.cuda.get_device_properties(device).multi_processor_count)
    return torch.empty((grid, layout.ws_rows, n), dtype=torch.int32, device=device), grid


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
    P, n = module.nprimes, module.n
    rows, ci, co, psize = pmat.shape[:4]
    lead = a_data.shape[:-3]
    a_size = a_data.shape[-2]
    rmax = min(rows * dsize, a_size)
    kk = ci * rmax
    if a_data.shape[-3] != ci or a_data.shape[-1] != n:
        raise ValueError(f"a_data: expected [..., {ci}, size, {n}], got {tuple(a_data.shape)}")
    lay = product_layout(kk, co, psize, P, n)
    s64 = 0 if small64 is None else small64.shape[-2]
    _check_bounds(P, max(psize, s64), res_size)
    if pmat.device != a_data.device or module.device != a_data.device:
        raise ValueError("a_data, pmat and module must be on one device")
    pm = pm_kernel_layout(pmat, rmax) if dsize == 1 else pm_kernel_layout_dsize(pmat, rmax, dsize)
    B = a_data.numel() // (ci * a_size * n) if a_data.numel() else 0
    a = a_data.reshape(B, ci, a_size, n).contiguous()    # the keyswitch passes a column view
    _lib.require(a, "a_data", torch.int64)
    small, s_size, sm_ptr = _body(small, lead, B, n)
    s64_ptr = None
    if small64 is not None:
        if tuple(small64.shape) != tuple(lead) + (co, s64, n):
            raise ValueError(f"small64: expected {tuple(lead) + (co, s64, n)}, "
                             f"got {tuple(small64.shape)}")
        small64 = small64.reshape(B, co, s64, n).contiguous()
        _lib.require(small64, "small64", torch.int64)
        s64_ptr = small64.data_ptr()
    out = torch.empty(lead + (co, res_size, n), dtype=torch.int64, device=a_data.device)
    if B == 0:
        return out
    if rmax == 0 and small is None and small64 is None:
        return out.zero_()
    tw, consts = kernel_tables(module.tables)
    ws, grid = launch_workspace(lay, B * (co // lay.cpb), n, a_data.device)
    err = _lib.library().poulpy_fused_product(
        a.data_ptr(), pm.data_ptr(), sm_ptr, s64_ptr, out.data_ptr(), tw.data_ptr(),
        consts.data_ptr(), B, ci, a_size, rmax, co, psize, s_size, s64, res_size, res_base2k,
        pm_base2k, lay.cpb, P, module.log_n, lay.smem, _lib.ptr(ws), lay.chunk, grid,
        _lib.stream())
    _lib.check(err, "poulpy_fused_product")
    LAUNCHES["fused_product_small" if small is not None
             else "fused_product_small64" if small64 is not None else "fused_product"] += 1
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


def garner_exit(module: Module, x, psize: int, res_size: int, res_base2k: int, pm_base2k: int,
                small=None):
    """`x` [..., co, psize, P, N] int32 coefficient residues (canonical, the
    inverse transform's N^{-1} applied) → [..., co, res_size, N] normalized
    int64 limbs of base 2^res_base2k; `small` [..., s_size, N] int64, if
    given, is added to column 0 (limbs past psize dropped).  Plain version on
    CPU tensors, one CUDA launch on CUDA (`csrc/garner_exit.cu`)."""
    if x.device.type == "cpu":
        return garner_exit_ref(module, x, psize, res_size, res_base2k, pm_base2k, small)
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
        return out
    _, consts = kernel_tables(module.tables)
    err = _lib.library().poulpy_garner_exit(
        xm.data_ptr(), sm_ptr, out.data_ptr(), consts.data_ptr(), B, co, psize, s_size, res_size,
        res_base2k, pm_base2k, P, module.log_n, _lib.stream())
    _lib.check(err, "poulpy_garner_exit")
    LAUNCHES["garner_exit"] += 1
    return out


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
    """Shared memory of one tensor block: the rows of one prime that the
    cross pair reads, or the conv_size rows written over them if more."""
    return 4 * n * max(2 * (size_a + size_b), conv_size)


def tensor_fits(module: Module, size_a: int, size_b: int, conv_size: int, dnum: int) -> bool:
    """True when `fused_tensor_product`'s kernel takes these shapes."""
    return (module.nprimes <= MAX_PRIMES and max(size_a, size_b, conv_size, dnum) <= MAX_LIMBS
            and tensor_smem_bytes(size_a, size_b, conv_size, module.n) <= SMEM_LIMIT)


def fused_tensor_product(module: Module, a_data, b_data, conv_size: int, dnum: int, kr: int,
                         ka: int):
    """Rank-1 tensor product of `a_data` [..., 2, size_a, N] and `b_data`
    [..., 2, size_b, N] int64 limbs (base 2^ka) → (d [..., dnum, N], the
    quadratic term a1·b1 normalized to `dnum` digits of base 2^kr; lin64
    [..., 2, conv_size, N], the wrapping-int64 linear terms a0·b0 and
    a0·b1 + a1·b0).  Plain version on CPU tensors, one CUDA launch on CUDA."""
    if a_data.device.type == "cpu":
        return fused_tensor_product_ref(module, a_data, b_data, conv_size, dnum, kr, ka)
    P, n = module.nprimes, module.n
    lead = a_data.shape[:-3]
    size_a, size_b = a_data.shape[-2], b_data.shape[-2]
    if tuple(a_data.shape[-3:]) != (2, size_a, n) or tuple(b_data.shape) != tuple(lead) + (
            2, size_b, n):
        raise ValueError(f"a_data {tuple(a_data.shape)}, b_data {tuple(b_data.shape)}: expected "
                         f"rank-1 ciphertexts [..., 2, size, {n}] with one batch shape")
    if not tensor_fits(module, size_a, size_b, conv_size, dnum):
        raise ValueError(f"tensor kernel bounds: P ≤ {MAX_PRIMES}, limbs ≤ {MAX_LIMBS}, "
                         f"{tensor_smem_bytes(size_a, size_b, conv_size, n)} B of shared memory "
                         f"≤ {SMEM_LIMIT}")
    if b_data.device != a_data.device or module.device != a_data.device:
        raise ValueError("a_data, b_data and module must be on one device")
    B = a_data.numel() // (2 * size_a * n) if a_data.numel() else 0
    a = a_data.reshape(B, 2, size_a, n).contiguous()
    b = b_data.reshape(B, 2, size_b, n).contiguous()
    _lib.require(a, "a_data", torch.int64)
    _lib.require(b, "b_data", torch.int64)
    d = torch.empty(lead + (dnum, n), dtype=torch.int64, device=a_data.device)
    lin = torch.empty(lead + (2, conv_size, n), dtype=torch.int64, device=a_data.device)
    if B == 0:
        return d, lin
    scratch = torch.empty((B * 3, P, conv_size, n), dtype=torch.int32, device=a_data.device)
    tw, consts = kernel_tables(module.tables)
    err = _lib.library().poulpy_tensor_product(
        a.data_ptr(), b.data_ptr(), d.data_ptr(), lin.data_ptr(), scratch.data_ptr(),
        tw.data_ptr(), consts.data_ptr(), B, size_a, size_b, conv_size, dnum, kr, ka, P,
        module.log_n, tensor_smem_bytes(size_a, size_b, conv_size, n), _lib.stream())
    _lib.check(err, "poulpy_tensor_product")
    LAUNCHES["tensor_product"] += 1
    return d, lin


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


def fused_br_block_step_ref(module: Module, acc, pmats, a_blk, res_size: int, base2k: int):
    """Plain version of one block-binary CGGI step (the jnp `block_step` of
    `poulpy_tpu/binfhe/blind_rotation.py`): per key element i, the VMP of
    dft(acc) with BRK_i, times NTT(X^{a_i}), minus itself; the sum over i,
    idft, plus acc at the aligned limbs, normalized to `res_size` limbs."""
    t = module.tables
    xpow, _ = xpow_tables(module)
    acc_dft = _dft_plain(module, acc)
    add_dft = None
    for i in range(pmats.shape[0]):
        vmp_res = vmp_apply_ref(module, acc_dft, pmats[i])
        xp = xpow[a_blk[..., i] & (2 * module.n - 1)]       # [..., P, N]
        rot = mont_mul(vmp_res, xp[..., None, None, :, :], t.p[:, None], t.qinv[:, None])
        term = dft_sub(module, rot, vmp_res)
        add_dft = term if add_dft is None else dft_add(module, add_dft, term)
    big = garner_lift(t, ntt_inverse(t, add_dft))
    big = big + _align_limbs(acc, big, big.shape[-2], limb_axis=-2)[0]
    return vec_znx_normalize_full(res_size, base2k, 0, big, base2k)


def fused_br_block_step(module: Module, acc, pmats, a_blk, res_size: int, base2k: int,
                        pm_k=None):
    """One block-binary CGGI step for a batch.

    acc    [..., cols, size, N] int64 limbs;
    pmats  [block, rows, cols, cols, psize, P, N] the block's prepared BRK
           elements (Montgomery);
    a_blk  [..., block] int64 mod-switched rotation amounts, any sign;
    pm_k   [block, P, cols·rmax, cols·psize, N] int32: `pmats` in kernel
           layout (`pm_kernel_layout`), made from `pmats` when not given.
    → [..., cols, res_size, N] normalized limbs.  Plain version on CPU
    tensors, one CUDA launch on CUDA (the x-power factor gathered in the
    kernel from the device `_xpow_minus1_table` by `a & (2N − 1)`)."""
    if acc.device.type == "cpu":
        return fused_br_block_step_ref(module, acc, pmats, a_blk, res_size, base2k)
    P, n = module.nprimes, module.n
    block, rows, cols, co, psize = pmats.shape[:5]
    lead, size = acc.shape[:-3], acc.shape[-2]
    rmax = min(rows, size)
    kk, mdim = cols * rmax, cols * psize
    if co != cols or acc.shape[-3] != cols or acc.shape[-1] != n:
        raise ValueError(f"acc {tuple(acc.shape)} does not match the key's {cols} columns")
    if tuple(a_blk.shape) != tuple(lead) + (block,):
        raise ValueError(f"a_blk: expected {tuple(lead) + (block,)}, got {tuple(a_blk.shape)}")
    lay = product_layout(kk, cols, psize, P, n, split=False)
    _check_bounds(P, psize, res_size)
    if pm_k is None:
        pm_k = pm_kernel_layout(pmats, rmax)
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
    _, xpm1 = xpow_tables(module)
    tw, consts = kernel_tables(module.tables)
    ws, grid = launch_workspace(lay, B, n, acc.device)
    err = _lib.library().poulpy_br_block_step(
        a.data_ptr(), pm_k.data_ptr(), xpm1.data_ptr(), amounts.data_ptr(), out.data_ptr(),
        tw.data_ptr(), consts.data_ptr(), B, cols, size, rmax, psize, res_size, base2k, block,
        P, module.log_n, lay.smem, _lib.ptr(ws), lay.chunk, grid, _lib.stream())
    _lib.check(err, "poulpy_br_block_step")
    LAUNCHES["br_block_step"] += 1
    return out
