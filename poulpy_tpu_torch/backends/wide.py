"""Wide fused kernels (`csrc/wide_product.cu`, `csrc/wide_tensor.cu`) and
their plain PyTorch twins.

Replace the two kernels of `poulpy_tpu/backends/pallas_wide.py`, whose big
values are exact 128-bit integers (the reference's NTT120 i128 accumulator,
for base2k up to ~52):

- `fused_glwe_product_wide` (`_pipe_wide_fn`):
      big_normalize_wide(idft_wide(vmp(dft(a), pmat)) [+ small per column], offset);
- `fused_tensor_product_wide` (`_tensor_wide_fn`): the rank-1 ct × ct limb
  convolution, its quadratic term normalized to the relinearization's
  digits and its linear terms to ciphertext limbs, both with CKKS mul's
  landing offset.

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
from poulpy_tpu_torch.backends.fused import (
    Layout,
    _check_bounds,
    kernel_layout,
    launch_workspace,
    pm_kernel_layout,
    pm_kernel_layout_dsize,
    product_dft_ref,
    product_layout,
)
from poulpy_tpu_torch.backends.ntt import kernel_tables
from poulpy_tpu_torch.hal.dft import cnv_apply, dft_add
from poulpy_tpu_torch.hal.module import Module
from poulpy_tpu_torch.hal.ntt import ntt_forward, ntt_inverse, to_mont, to_residues
from poulpy_tpu_torch.hal.wide import (
    garner_lift_wide,
    vec_znx_normalize_full_wide,
    wide_add_small,
)


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


def fused_glwe_product_wide(module: Module, a_data, pmat, res_size: int, res_base2k: int,
                            pm_base2k: int, small=None, res_offset: int = 0, dsize: int = 1):
    """`a_data` [..., ci, size_a, N] int64 limbs × `pmat` [rows, ci, co,
    psize, P, N] → [..., co, res_size, N] normalized limbs in base
    2^res_base2k, the value landed at 2^res_offset.  `small` [..., co,
    s_size, N] int64, if given, is added to each column's first limbs before
    the normalization.  Plain version on CPU tensors, one CUDA launch on CUDA."""
    rows, ci, co, psize = pmat.shape[:4]
    if not fused_wide_supported(psize, res_base2k, pm_base2k):
        raise ValueError(f"wide product windows: base2k {res_base2k}/{pm_base2k}, psize {psize}")
    if a_data.device.type == "cpu":
        return fused_glwe_product_wide_ref(module, a_data, pmat, res_size, res_base2k,
                                           pm_base2k, small, res_offset, dsize)
    P, n = module.nprimes, module.n
    lead, a_size = a_data.shape[:-3], a_data.shape[-2]
    rmax = min(rows * dsize, a_size)
    kk = ci * rmax
    if a_data.shape[-3] != ci or a_data.shape[-1] != n:
        raise ValueError(f"a_data: expected [..., {ci}, size, {n}], got {tuple(a_data.shape)}")
    lay = product_layout(kk, co, psize, P, n)
    _check_bounds(P, psize, res_size)
    if pmat.device != a_data.device or module.device != a_data.device:
        raise ValueError("a_data, pmat and module must be on one device")
    pm = pm_kernel_layout(pmat, rmax) if dsize == 1 else pm_kernel_layout_dsize(pmat, rmax, dsize)
    B = a_data.numel() // (ci * a_size * n) if a_data.numel() else 0
    a = a_data.reshape(B, ci, a_size, n).contiguous()
    _lib.require(a, "a_data", torch.int64)
    s_size, sm_ptr = 0, None
    if small is not None:
        s_size = small.shape[-2]
        if tuple(small.shape) != tuple(lead) + (co, s_size, n):
            raise ValueError(f"small: expected {tuple(lead) + (co, s_size, n)}, "
                             f"got {tuple(small.shape)}")
        small = small.reshape(B, co, s_size, n).contiguous()
        _lib.require(small, "small", torch.int64)
        sm_ptr = small.data_ptr()
    out = torch.empty(lead + (co, res_size, n), dtype=torch.int64, device=a_data.device)
    if B == 0:
        return out
    tw, consts = kernel_tables(module.tables)
    ws, grid = launch_workspace(lay, B * (co // lay.cpb), n, a_data.device)
    err = _lib.library().poulpy_wide_product(
        a.data_ptr(), pm.data_ptr(), sm_ptr, out.data_ptr(), tw.data_ptr(), consts.data_ptr(),
        B, ci, a_size, rmax, co, psize, s_size, res_size, res_base2k, pm_base2k, res_offset,
        lay.cpb, P, module.log_n, lay.smem, _lib.ptr(ws), lay.chunk, grid, _lib.stream())
    _lib.check(err, "poulpy_wide_product")
    LAUNCHES["wide_product"] += 1
    return out


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
    """The layout of `wide_tensor.cu` (one block per ciphertext and pair):
    the global workspace holds the same rows, the stage whole rows."""
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
    P, n = module.nprimes, module.n
    lead = a_data.shape[:-3]
    size_a, size_b = a_data.shape[-2], b_data.shape[-2]
    if tuple(a_data.shape[-3:]) != (2, size_a, n) or tuple(b_data.shape) != tuple(lead) + (
            2, size_b, n):
        raise ValueError(f"a_data {tuple(a_data.shape)}, b_data {tuple(b_data.shape)}: expected "
                         f"rank-1 ciphertexts [..., 2, size, {n}] with one batch shape")
    lay = tensor_wide_layout(size_a, size_b, conv_size, P, n)
    _check_bounds(P, conv_size, max(dnum, lin_size))
    if b_data.device != a_data.device or module.device != a_data.device:
        raise ValueError("a_data, b_data and module must be on one device")
    B = a_data.numel() // (2 * size_a * n) if a_data.numel() else 0
    a = a_data.reshape(B, 2, size_a, n).contiguous()
    b = b_data.reshape(B, 2, size_b, n).contiguous()
    _lib.require(a, "a_data", torch.int64)
    _lib.require(b, "b_data", torch.int64)
    d = torch.empty(lead + (dnum, n), dtype=torch.int64, device=a_data.device)
    lin = torch.empty(lead + (2, lin_size, n), dtype=torch.int64, device=a_data.device)
    if B == 0:
        return d, lin
    tw, consts = kernel_tables(module.tables)
    ws, grid = launch_workspace(lay, B * 3, n, a_data.device)
    err = _lib.library().poulpy_wide_tensor(
        a.data_ptr(), b.data_ptr(), d.data_ptr(), lin.data_ptr(), tw.data_ptr(),
        consts.data_ptr(), B, size_a, size_b, conv_size, dnum, lin_size, kr, ka, offset, P,
        module.log_n, lay.smem, _lib.ptr(ws), lay.chunk, grid, _lib.stream())
    _lib.check(err, "poulpy_wide_tensor")
    LAUNCHES["wide_tensor"] += 1
    return d, lin
