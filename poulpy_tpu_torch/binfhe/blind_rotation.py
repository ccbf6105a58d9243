"""CGGI blind rotation: twin of `poulpy_tpu/binfhe/blind_rotation.py`.

Standard path:      acc ← X^b·LUT;  for each LWE coefficient a_i:
                    acc += (X^{a_i} − 1)·(BRK_i ⊡ acc);  normalize once.
Block-binary path:  for each block of `block_size` key elements, one fused
                    step acc ← normalize(acc + idft(Σ_i NTT(X^{a_i} − 1)·
                    (dft(acc) ⊡ BRK_i))).
Extended path:      a LUT over ext polynomials (domain N·ext) as ext parts
                    of the accumulator, each block step through the NTT and
                    VMP kernels with the parts mixed in the NTT domain.

Every ciphertext of a batch rotates by its own amounts.  On CUDA the
standard path runs one fused step kernel per coefficient (the product with
the rotate-and-subtract in its exit, `fused_br_step`) and the block path
one block-step kernel per BR_STEPS blocks (the chain of
`fused_br_block_step(steps=…)`, the JAX package's default launch), the
nblocks % BR_STEPS trailing blocks one per launch; on the CPU both take
the plain versions.
`route` picks the kernels: "fused" (the default) the butterfly
ones (`backends/fused.py`), "fused_mxu" those of the four-step int8
transforms (`backends/fused_mxu.py`, the JAX package's
POULPY_TPU_FUSED_MXU=1) where `br_route` allows it; "mxu" takes the
butterfly kernels, as the JAX package's POULPY_TPU_MXU=1 does not reach the
blind rotation.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from poulpy_tpu_torch.backends.fused import (  # noqa: F401  (the x-power tables live with their kernel)
    _xpow_minus1_table,
    _xpow_table,
    chain_steps,
    fused_br_block_step,
    fused_br_steps,
    fused_supported,
    pm_kernel_layout,
    xpow_tables,
)
from poulpy_tpu_torch.backends.fused_mxu import (
    fused_mxu_br_block_step,
    fused_mxu_glwe_product,
    fused_mxu_supported,
)
from poulpy_tpu_torch.backends.mxu import sigma_index
from poulpy_tpu_torch.backends.mxu_product import ROUTES
from poulpy_tpu_torch.binfhe.lut import LookupTable
from poulpy_tpu_torch.core.compressed import (
    GGSWCompressed,
    ggsw_decompress,
    ggsw_encrypt_sk_compressed,
)
from poulpy_tpu_torch.core.encryption import ggsw_encrypt_sk
from poulpy_tpu_torch.core.layouts import LWECiphertext, _Replace
from poulpy_tpu_torch.core.prepared import GLWESecretPrepared
from poulpy_tpu_torch.hal import dft
from poulpy_tpu_torch.hal.module import Module
from poulpy_tpu_torch.hal.ntt import mont_mul
from poulpy_tpu_torch.hal.normalization import vec_znx_normalize
from poulpy_tpu_torch.hal.vec_znx import vec_znx_rotate
from poulpy_tpu_torch.parallel.auto import dp_shard

# block steps per launch of the block path's butterfly kernel: the JAX
# package's default POULPY_TPU_BR_STEPS
BR_STEPS = 2


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


@dataclass(frozen=True)
class BlindRotationKeyCompressed(_Replace):
    """Seeded BRK: one GGSWCompressed batched over the n_lwe coefficients,
    (rank+1)× smaller for transport; decompress and prepare on the card."""

    ggsw: GGSWCompressed
    dist: str = "binary_prob"


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
    ggsw = ggsw_encrypt_sk(module, _brk_plaintext(module, sk_lwe), sk_glwe, base2k, k, dnum,
                           source_xe, source_xa, dsize=dsize, **kw)
    return BlindRotationKeyPrepared(pmats=dft.vmp_prepare(module, ggsw.data), base2k=base2k,
                                    k=k, dsize=dsize)


def _brk_plaintext(module: Module, sk_lwe):
    sk_lwe = torch.as_tensor(sk_lwe, dtype=torch.int64).to(module.device)
    pt = torch.zeros((sk_lwe.shape[-1], module.n), dtype=torch.int64, device=module.device)
    pt[:, 0] = sk_lwe
    return pt


def blind_rotation_key_encrypt_sk_compressed(module: Module, sk_lwe, sk_glwe: GLWESecretPrepared,
                                             base2k: int, k: int, dnum: int, source_xe,
                                             source_xa, dsize: int = 1,
                                             **kw) -> BlindRotationKeyCompressed:
    """The BRK's GGSWs, seeded: bodies + one seed branched from `source_xa`."""
    ggsw = ggsw_encrypt_sk_compressed(module, _brk_plaintext(module, sk_lwe), sk_glwe, base2k, k,
                                      dnum, source_xe, source_xa, dsize=dsize, **kw)
    return BlindRotationKeyCompressed(ggsw=ggsw)


def blind_rotation_key_decompress(module: Module,
                                  key: BlindRotationKeyCompressed) -> BlindRotationKeyPrepared:
    """Regenerate the mask columns, then prepare (the NTT kernel on the card)."""
    ggsw = ggsw_decompress(module, key.ggsw)
    return BlindRotationKeyPrepared(pmats=dft.vmp_prepare(module, ggsw.data), base2k=ggsw.base2k,
                                    k=ggsw.k, dsize=ggsw.dsize, dist=key.dist)


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


def _check_one_poly(lut: LookupTable) -> None:
    if lut.extension_factor != 1:
        raise ValueError("a LUT over several polynomials takes the extended path "
                         "(blind_rotation_execute_extended)")


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
    unnormalized between coefficients (the butterfly step takes any int64;
    `br_route` keeps the MXU product within int32).  The butterfly route
    makes one `fused_br_step` launch per coefficient (`fused_br_steps`).  On
    a mesh-attached module the batch runs dp-sharded (parallel/auto.py), as
    on the two other paths."""
    if module.mesh is not None:
        return dp_shard(module, lambda l: blind_rotation_execute(
            module.local, l, lut, brk, route), lwe)
    _check_one_poly(lut)
    base2k, size = brk.base2k, lut.size
    lwe_2n = mod_switch_2n(2 * module.n, lwe, lut.rot_dir)
    acc = _acc_init(lwe_2n[..., 0], lut, brk.rank)
    psize = brk.pmats.shape[-3]
    mxu = br_route(module, route, psize, base2k, brk.dsize, brk.n_lwe) == "fused_mxu"
    # the kernels read the key in their own layout, made once per key
    pm_k = _kernel_key(module, brk, acc, size, mxu)
    if not mxu:
        return vec_znx_normalize(base2k, fused_br_steps(module, acc, brk.pmats, lwe_2n, size,
                                                        base2k, pm_k))
    for i in range(brk.n_lwe):
        tmp = fused_mxu_glwe_product(module, acc, brk.pmats[i], size, base2k, base2k,
                                     pm_k=None if pm_k is None else pm_k[i])
        acc = acc + (vec_znx_rotate(lwe_2n[..., i + 1, None, None], tmp) - tmp)
    return vec_znx_normalize(base2k, acc)


def blind_rotation_execute_block(module: Module, lwe: LWECiphertext, lut: LookupTable,
                                 brk: BlindRotationKeyPrepared, block_size: int,
                                 route: str = "fused"):
    """Block-binary CGGI path for block-binary LWE secrets (at most one set
    coefficient per block): a fused step per block of the key, BR_STEPS of
    them chained per launch of the butterfly kernel."""
    if module.mesh is not None:
        return dp_shard(module, lambda l: blind_rotation_execute_block(
            module.local, l, lut, brk, block_size, route), lwe)
    _check_one_poly(lut)
    if brk.n_lwe % block_size:
        raise ValueError(f"n_lwe={brk.n_lwe} is not a multiple of block_size={block_size}")
    nblocks = brk.n_lwe // block_size
    base2k, size = brk.base2k, lut.size
    lwe_2n = mod_switch_2n(2 * module.n, lwe, lut.rot_dir)
    acc = _acc_init(lwe_2n[..., 0], lut, brk.rank)
    mxu = br_route(module, route, brk.pmats.shape[-3], base2k, brk.dsize, 0) == "fused_mxu"
    # the kernel reads the key in its own layout, made once per key
    pm_k = _kernel_key(module, brk, acc, size, mxu)
    # the JAX package's grouping: spans of `steps` whole blocks, one chained
    # launch each, then the nblocks % steps trailing blocks one per launch;
    # the MXU kernel runs one block per launch, as the JAX package's does
    steps = 1 if mxu else chain_steps(module, acc, brk.pmats, size, block_size,
                                      max(1, min(BR_STEPS, nblocks)))
    batch, j = tuple(lwe_2n.shape[:-1]), 0
    for span, count in ((steps, nblocks // steps), (1, nblocks % steps)):
        # [count, ..., span·block]: each launch's amounts contiguous
        a_spans = lwe_2n[..., 1 + j * block_size:1 + (j + span * count) * block_size].reshape(
            batch + (count, span * block_size)).movedim(-2, 0).contiguous()
        for a_span in a_spans:
            keys = slice(j * block_size, (j + span) * block_size)
            args = (module, acc, brk.pmats[keys], a_span, size, base2k,
                    None if pm_k is None else pm_k[keys])
            acc = fused_mxu_br_block_step(*args) if mxu else fused_br_block_step(*args, span)
            j += span
    return acc


def blind_rotation_execute_extended(module: Module, lwe: LWECiphertext, lut: LookupTable,
                                    brk: BlindRotationKeyPrepared, block_size: int = 1):
    """Extended block-binary CGGI: the LUT spans ext = `extension_factor`
    degree-N polynomials (domain N·ext), held as an accumulator axis of ext
    parts.  For an amount q = hi·ext + lo in Z_{2N·ext}, output part i is
    part (i − lo) mod ext times X^{hi + (i < lo)}: a gather over the part
    axis and a rotation (by the x-power table in the NTT domain), the same
    for every a_i.  Per block: `dft_apply`, then per key element
    `vmp_apply`, the part mix and `dft_sub` / `dft_add`, then `idft_apply`
    and `big_normalize`, through the NTT and VMP kernels on the card."""
    if module.mesh is not None:
        return dp_shard(module, lambda l: blind_rotation_execute_extended(
            module.local, l, lut, brk, block_size), lwe)
    ext = lut.extension_factor
    n = module.n
    base2k, size, rank = brk.base2k, lut.size, brk.rank
    if brk.n_lwe % block_size:
        raise ValueError(f"n_lwe={brk.n_lwe} is not a multiple of block_size={block_size}")
    mask = 2 * n * ext - 1
    lwe_2n = mod_switch_2n(2 * n * ext, lwe, lut.rot_dir) & mask      # two's complement, as jnp
    batch = tuple(lwe_2n.shape[:-1])
    parts = torch.arange(ext, device=lwe_2n.device)

    def part_mix(x, pos, rotate):
        """x [..., ext, ...], pos [...] in [0, 2N·ext): part i of the result
        is rotate(x[(i − lo) mod ext], hi + (i < lo))."""
        hi, lo = pos // ext, pos % ext
        src = torch.remainder(parts - lo[..., None], ext)              # [..., ext]
        src = src.reshape(src.shape + (1,) * (x.dim() - src.dim())).expand(x.shape)
        return rotate(torch.gather(x, len(batch), src), hi[..., None] + (parts < lo[..., None]))

    def rot_coeff(x, expo):
        return vec_znx_rotate(expo[..., None], x)                      # x [..., ext, size, N]

    t = module.tables
    xpow = xpow_tables(module)[0]

    def rot_dft(x, expo):
        """x [..., ext, cols, size, P, N] times NTT(X^expo), pointwise."""
        xp = xpow[expo & (2 * n - 1)]                                  # [..., ext, P, N]
        return mont_mul(x, xp[..., :, None, None, :, :], t.p[:, None], t.qinv[:, None])

    lut_parts = lut.data.expand(batch + tuple(lut.data.shape))
    body = part_mix(lut_parts, lwe_2n[..., 0], rot_coeff)             # [..., ext, size, N]
    zeros = torch.zeros(batch + (ext, rank, size, n), dtype=torch.int64, device=body.device)
    acc = torch.cat([body[..., :, None, :, :], zeros], dim=-3)        # [..., ext, cols, size, N]
    for j in range(brk.n_lwe // block_size):
        acc_dft = dft.dft_apply(module, acc)
        add = None
        for i in range(j * block_size, (j + 1) * block_size):
            vmp_res = dft.vmp_apply(module, acc_dft, brk.pmats[i])
            term = dft.dft_sub(module, part_mix(vmp_res, lwe_2n[..., i + 1], rot_dft), vmp_res)
            add = term if add is None else dft.dft_add(module, add, term)
        big = dft.idft_apply(module, add)
        big = big + dft._align_limbs(acc, big, big.shape[-2], limb_axis=-2)[0]
        acc = dft.big_normalize(module, size, base2k, big, base2k)
    return acc[..., 0, :, :, :]


def blind_rotation_dispatch(module: Module, lwe: LWECiphertext, lut: LookupTable,
                            brk: BlindRotationKeyPrepared, block_size: int = 1,
                            route: str = "fused"):
    """The extended path for a LUT over several polynomials, the
    block-binary path for block_size > 1 keys, else the standard one;
    `route` picks the kernels of the last two."""
    if lut.extension_factor > 1:
        return blind_rotation_execute_extended(module, lwe, lut, brk, block_size)
    if block_size > 1:
        return blind_rotation_execute_block(module, lwe, lut, brk, block_size, route)
    return blind_rotation_execute(module, lwe, lut, brk, route)
