"""CGGI blind rotation: twin of `poulpy_tpu/binfhe/blind_rotation.py` for
lookup tables of one polynomial.

Standard path:      acc ← X^b·LUT;  for each LWE coefficient a_i:
                    acc += (X^{a_i} − 1)·(BRK_i ⊡ acc);  normalize once.
Block-binary path:  for each block of `block_size` key elements, one fused
                    step acc ← normalize(acc + idft(Σ_i NTT(X^{a_i} − 1)·
                    (dft(acc) ⊡ BRK_i))).

Every ciphertext of a batch rotates by its own amounts.  On CUDA the
standard path runs one fused product kernel per coefficient and the block
path one block-step kernel per block (`backends/fused.py`); on the CPU both
take the plain versions.  The extended path (a LUT over several
polynomials) is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from poulpy_tpu_torch.backends.fused import (  # noqa: F401  (the x-power tables live with their kernel)
    _xpow_minus1_table,
    _xpow_table,
    fused_br_block_step,
    fused_glwe_product,
    pm_kernel_layout,
)
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


def brk_kernel_layout(brk: BlindRotationKeyPrepared, rmax: int) -> torch.Tensor:
    """The key in the block-step kernel's layout, [n_lwe, P, KK, M, N] int32
    (`pm_kernel_layout` of the first `rmax` gadget rows), made once per key
    and row count and kept on the key."""
    cache = brk.__dict__.setdefault("_pm_kernel", {})
    if rmax not in cache:
        cache[rmax] = pm_kernel_layout(brk.pmats, rmax)
    return cache[rmax]


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


def blind_rotation_execute(module: Module, lwe: LWECiphertext, lut: LookupTable,
                           brk: BlindRotationKeyPrepared):
    """Standard CGGI path: GLWE data `[..., rank+1, size, N]` (base2k =
    brk.base2k) encrypting X^{-dec(lwe)}·LUT.  The accumulator stays
    unnormalized between coefficients (the product takes any int64)."""
    _single_poly(lut.extension_factor)
    base2k, size = brk.base2k, lut.size
    lwe_2n = mod_switch_2n(2 * module.n, lwe, lut.rot_dir)
    acc = _acc_init(lwe_2n[..., 0], lut, brk.rank)
    for i in range(brk.n_lwe):
        tmp = fused_glwe_product(module, acc, brk.pmats[i], size, base2k, base2k)
        acc = acc + (vec_znx_rotate(lwe_2n[..., i + 1, None, None], tmp) - tmp)
    return vec_znx_normalize(base2k, acc)


def blind_rotation_execute_block(module: Module, lwe: LWECiphertext, lut: LookupTable,
                                 brk: BlindRotationKeyPrepared, block_size: int):
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
    # the kernel reads the key in its own layout, made once per key; the
    # plain version reads `pmats`
    pm_k = brk_kernel_layout(brk, min(brk.pmats.shape[-6], size)) \
        if acc.device.type == "cuda" else None
    for j in range(nblocks):
        blk = slice(j * block_size, (j + 1) * block_size)
        acc = fused_br_block_step(module, acc, brk.pmats[blk], a_blocks[j], size, base2k,
                                  None if pm_k is None else pm_k[blk])
    return acc


def blind_rotation_dispatch(module: Module, lwe: LWECiphertext, lut: LookupTable,
                            brk: BlindRotationKeyPrepared, block_size: int = 1):
    """The block-binary path for block_size > 1 keys, else the standard one.
    A LUT over several polynomials (the extended path) raises."""
    if lut.extension_factor > 1:
        raise NotImplementedError("the extended blind rotation path is not ported")
    if block_size > 1:
        return blind_rotation_execute_block(module, lwe, lut, brk, block_size)
    return blind_rotation_execute(module, lwe, lut, brk)
