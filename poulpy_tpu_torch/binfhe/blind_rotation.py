"""CGGI blind rotation: twin of `poulpy_tpu/binfhe/blind_rotation.py` for
lookup tables of one polynomial.

Standard path:      acc ← X^b·LUT;  for each LWE coefficient a_i:
                    acc += (X^{a_i} − 1)·(BRK_i ⊡ acc);  normalize once.
Block-binary path:  for each block of `block_size` key elements, one fused
                    step acc ← normalize(acc + idft(Σ_i NTT(X^{a_i} − 1)·
                    (dft(acc) ⊡ BRK_i))).

Every ciphertext of a batch rotates by its own amounts.  On CUDA the
standard path runs one fused product kernel per coefficient and the block
path one block-step kernel per block; on the CPU both take the plain
versions.  `route` picks the kernels: "fused" (the default) the butterfly
ones (`backends/fused.py`), "fused_mxu" those of the four-step int8
transforms (`backends/fused_mxu.py`, the JAX package's
POULPY_TPU_FUSED_MXU=1) where `br_route` allows it; "mxu" takes the
butterfly kernels, as the JAX package's POULPY_TPU_MXU=1 does not reach the
blind rotation.  The extended path (a LUT over several polynomials) is not
ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from poulpy_tpu_torch.backends.fused import (  # noqa: F401  (the x-power tables live with their kernel)
    _xpow_minus1_table,
    _xpow_table,
    fused_br_block_step,
    fused_glwe_product,
    fused_supported,
    pm_kernel_layout,
)
from poulpy_tpu_torch.backends.fused_mxu import (
    fused_mxu_br_block_step,
    fused_mxu_glwe_product,
    fused_mxu_supported,
)
from poulpy_tpu_torch.backends.mxu import sigma_index
from poulpy_tpu_torch.backends.mxu_product import ROUTES
from poulpy_tpu_torch.binfhe.lut import LookupTable, _single_poly
from poulpy_tpu_torch.core.encryption import ggsw_encrypt_sk
from poulpy_tpu_torch.core.layouts import LWECiphertext, _Replace
from poulpy_tpu_torch.core.prepared import GLWESecretPrepared
from poulpy_tpu_torch.hal import dft
from poulpy_tpu_torch.hal.module import Module
from poulpy_tpu_torch.hal.normalization import vec_znx_normalize
from poulpy_tpu_torch.hal.vec_znx import vec_znx_rotate


@dataclass(frozen=True)
class BlindRotationKeyPrepared(_Replace):
    """One prepared GGSW per LWE secret coefficient, stacked:
    pmats [n_lwe, dnum, rank+1, rank+1, size, P, N] (Montgomery)."""

    pmats: torch.Tensor
    base2k: int
    k: int
    dsize: int = 1
    dist: str = "binary_prob"

    @property
    def n_lwe(self) -> int:
        return self.pmats.shape[0]

    @property
    def rank(self) -> int:
        return self.pmats.shape[-4] - 1


def brk_kernel_layout(brk: BlindRotationKeyPrepared, rmax: int, sigma=None) -> torch.Tensor:
    """The key in the kernels' layout, [n_lwe, P, KK, M, N] int32
    (`pm_kernel_layout` of the first `rmax` gadget rows), its last axis
    gathered by the index `sigma` for the MXU kernels (σ order), made once
    per key, row count and order and kept on the key."""
    cache = brk.__dict__.setdefault("_pm_kernel", {})
    key = (rmax, sigma is not None)
    if key not in cache:
        pm = pm_kernel_layout(brk.pmats, rmax)
        cache[key] = pm if sigma is None else pm[..., sigma].contiguous()
    return cache[key]


def br_route(module: Module, route: str, psize: int, base2k: int, dsize: int,
             extra_bits: int) -> str:
    """The kernels a blind rotation takes when `route` is asked for:
    "fused_mxu" where the JAX package's `_use_fused_br` (dsize 1,
    `fused_supported`, base2k + bitlen(extra_bits + 2) ≤ 29: the MXU kernels
    wrap their input limbs to int32, and the standard path's accumulator,
    extra_bits = n_lwe there and 0 on the block path, stays unnormalized)
    and `_use_mxu_br` (`fused_mxu_supported`: N ≥ 256) both hold; "fused",
    the butterfly kernels, which take any int64 and give the same result,
    everywhere else."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if (route == "fused_mxu" and dsize == 1 and fused_supported(psize, base2k)
            and base2k + (extra_bits + 2).bit_length() <= 29
            and fused_mxu_supported(module, psize, base2k)):
        return "fused_mxu"
    return "fused"


def blind_rotation_key_encrypt_sk(module: Module, sk_lwe, sk_glwe: GLWESecretPrepared,
                                  base2k: int, k: int, dnum: int, source_xe, source_xa,
                                  dsize: int = 1, **kw) -> BlindRotationKeyPrepared:
    """BRK: GGSW(s_lwe[i]) for every i, batched through one encryption call."""
    sk_lwe = torch.as_tensor(sk_lwe, dtype=torch.int64).to(module.device)
    pt = torch.zeros((sk_lwe.shape[-1], module.n), dtype=torch.int64, device=module.device)
    pt[:, 0] = sk_lwe
    ggsw = ggsw_encrypt_sk(module, pt, sk_glwe, base2k, k, dnum, source_xe, source_xa,
                           dsize=dsize, **kw)
    return BlindRotationKeyPrepared(pmats=dft.vmp_prepare(module, ggsw.data), base2k=base2k,
                                    k=k, dsize=dsize)


def mod_switch_2n(two_n: int, lwe: LWECiphertext, rot_dir: str = "left"):
    """Round an LWE to Z_{2N} indices: int64 `[..., n_lwe+1]` with
    (b, a_1..a_n) in [-N, N]."""
    base2k = lwe.base2k
    log2n = two_n.bit_length()  # log2(two_n) + 1 for a power of two, as the reference
    data = -lwe.data if rot_dir == "left" else lwe.data
    if base2k > log2n:
        diff = base2k - (log2n - 1)
        return (data[..., 0, :] + (1 << (diff - 1))) >> diff
    size = -(-log2n // base2k)
    rem = base2k - (log2n % base2k)
    y = data[..., 0, :]
    for i in range(1, size):
        if i == size - 1 and rem != base2k:
            y = (y << (base2k - rem)) + (data[..., i, :] >> rem)
        else:
            y = (y << base2k) + data[..., i, :]
    return y


def _acc_init(b, lut: LookupTable, rank: int):
    """acc = (X^b·LUT, 0, …, 0): `[..., rank+1, size, N]`, b per batch element."""
    body = vec_znx_rotate(b[..., None], lut.data[0])
    mask = torch.zeros(tuple(b.shape) + (rank,) + tuple(lut.data.shape[1:]), dtype=torch.int64,
                       device=body.device)
    return torch.cat([body[..., None, :, :], mask], dim=-3)


def _kernel_key(module: Module, brk: BlindRotationKeyPrepared, acc, size: int, mxu: bool):
    """The key in its kernels' layout on CUDA (σ order for the MXU ones);
    None on the CPU, where the plain versions read `pmats`."""
    if acc.device.type != "cuda":
        return None
    return brk_kernel_layout(brk, min(brk.pmats.shape[-6], size),
                             sigma_index(module.tables) if mxu else None)


def blind_rotation_execute(module: Module, lwe: LWECiphertext, lut: LookupTable,
                           brk: BlindRotationKeyPrepared, route: str = "fused"):
    """Standard CGGI path: GLWE data `[..., rank+1, size, N]` (base2k =
    brk.base2k) encrypting X^{-dec(lwe)}·LUT.  The accumulator stays
    unnormalized between coefficients (the butterfly product takes any
    int64; `br_route` keeps the MXU one within int32)."""
    _single_poly(lut.extension_factor)
    base2k, size = brk.base2k, lut.size
    lwe_2n = mod_switch_2n(2 * module.n, lwe, lut.rot_dir)
    acc = _acc_init(lwe_2n[..., 0], lut, brk.rank)
    psize = brk.pmats.shape[-3]
    mxu = br_route(module, route, psize, base2k, brk.dsize, brk.n_lwe) == "fused_mxu"
    pm_k = _kernel_key(module, brk, acc, size, mxu) if mxu else None
    for i in range(brk.n_lwe):
        if mxu:
            tmp = fused_mxu_glwe_product(module, acc, brk.pmats[i], size, base2k, base2k,
                                         pm_k=None if pm_k is None else pm_k[i])
        else:
            tmp = fused_glwe_product(module, acc, brk.pmats[i], size, base2k, base2k)
        acc = acc + (vec_znx_rotate(lwe_2n[..., i + 1, None, None], tmp) - tmp)
    return vec_znx_normalize(base2k, acc)


def blind_rotation_execute_block(module: Module, lwe: LWECiphertext, lut: LookupTable,
                                 brk: BlindRotationKeyPrepared, block_size: int,
                                 route: str = "fused"):
    """Block-binary CGGI path for block-binary LWE secrets (at most one set
    coefficient per block): one fused step per block of the key."""
    _single_poly(lut.extension_factor)
    if brk.n_lwe % block_size:
        raise ValueError(f"n_lwe={brk.n_lwe} is not a multiple of block_size={block_size}")
    nblocks = brk.n_lwe // block_size
    base2k, size = brk.base2k, lut.size
    lwe_2n = mod_switch_2n(2 * module.n, lwe, lut.rot_dir)
    acc = _acc_init(lwe_2n[..., 0], lut, brk.rank)
    batch = tuple(lwe_2n.shape[:-1])
    # [nblocks, ..., block]: each step's amounts contiguous
    a_blocks = lwe_2n[..., 1:].reshape(batch + (nblocks, block_size)).movedim(-2, 0).contiguous()
    mxu = br_route(module, route, brk.pmats.shape[-3], base2k, brk.dsize, 0) == "fused_mxu"
    step = fused_mxu_br_block_step if mxu else fused_br_block_step
    # the kernel reads the key in its own layout, made once per key
    pm_k = _kernel_key(module, brk, acc, size, mxu)
    for j in range(nblocks):
        blk = slice(j * block_size, (j + 1) * block_size)
        acc = step(module, acc, brk.pmats[blk], a_blocks[j], size, base2k,
                   None if pm_k is None else pm_k[blk])
    return acc


def blind_rotation_dispatch(module: Module, lwe: LWECiphertext, lut: LookupTable,
                            brk: BlindRotationKeyPrepared, block_size: int = 1,
                            route: str = "fused"):
    """The block-binary path for block_size > 1 keys, else the standard one,
    through `route`.  A LUT over several polynomials (the extended path)
    raises."""
    if lut.extension_factor > 1:
        raise NotImplementedError("the extended blind rotation path is not ported")
    if block_size > 1:
        return blind_rotation_execute_block(module, lwe, lut, brk, block_size, route)
    return blind_rotation_execute(module, lwe, lut, brk, route)
