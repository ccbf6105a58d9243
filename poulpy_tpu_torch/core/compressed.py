"""Compressed (seeded) ciphertexts and keys: twin of `poulpy_tpu/core/compressed.py`.

A secret-key encryption can keep only its body column and the 32-byte seed
of its mask stream: the encrypt side draws `seed, child = source_xa.branch()`
and encrypts with `child`; `*_decompress` replays `Source(seed)` in the
keygen's order of draws, so the decompressed ciphertext equals the direct
encryption with `child` bit for bit.  That makes key material (rank+1)×
smaller for transport.

Each mask is drawn on the host in one call of `Source.uniform_digits`,
uploaded once and joined to the body on the module's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from poulpy_tpu_torch.core.conversion import lwe_secret_as_glwe
from poulpy_tpu_torch.core.encryption import (
    NoiseInfos,
    encrypt_sk_internal,
    gglwe_encrypt_sk,
    ggsw_encrypt_sk,
    lwe_encrypt_sk,
)
from poulpy_tpu_torch.core.layouts import (
    GGLWECiphertext,
    GGSWCiphertext,
    GLWECiphertext,
    GLWESecret,
    LWECiphertext,
    _Replace,
    glwe_size,
)
from poulpy_tpu_torch.core.prepared import (
    GGLWEPrepared,
    GLWESecretPrepared,
    gglwe_prepare,
    glwe_secret_prepare,
)
from poulpy_tpu_torch.hal import dft
from poulpy_tpu_torch.hal.module import Module
from poulpy_tpu_torch.hal.source import Source
from poulpy_tpu_torch.hal.vec_znx import vec_znx_automorphism


def _mask_digits(seed: bytes, base2k: int, shape: tuple) -> np.ndarray:
    """The mask stream of `seed` as one host draw of balanced digits."""
    return Source(seed).uniform_digits(base2k, shape)


@dataclass(frozen=True)
class GLWECompressed(_Replace):
    """Body column `[..., size, N]` + mask seed."""

    body: torch.Tensor
    seed: bytes
    base2k: int
    k: int
    rank: int = 1


def glwe_encrypt_sk_compressed(module: Module, pt, sk: GLWESecretPrepared, base2k: int, k: int,
                               source_xe: Source, source_xa: Source, batch_shape: tuple = (),
                               **kw) -> GLWECompressed:
    """Encrypt with a mask stream branched from `source_xa`; keep the body."""
    seed, child = source_xa.branch()
    noise = NoiseInfos(k=k, **{k_: v for k_, v in kw.items() if k_ in ("sigma", "bound")})
    data = encrypt_sk_internal(module, base2k, glwe_size(base2k, k),
                               None if pt is None else pt.data, 0, sk, noise, source_xe, child,
                               batch_shape)
    return GLWECompressed(body=data[..., 0, :, :], seed=seed, base2k=base2k, k=k, rank=sk.rank)


def glwe_decompress(module: Module, ct: GLWECompressed) -> GLWECiphertext:
    """The mask columns regenerated from the seed, on `module.device`."""
    *batch, size, n = ct.body.shape
    mask = torch.from_numpy(_mask_digits(ct.seed, ct.base2k, (*batch, ct.rank, size, n)))
    body = ct.body.to(module.device)
    data = torch.cat([body[..., None, :, :], mask.to(module.device)], dim=-3)
    return GLWECiphertext(data=data, base2k=ct.base2k, k=ct.k)


@dataclass(frozen=True)
class GGLWECompressed(_Replace):
    """Gadget-GLWE bodies `[dnum, rank_in, size, N]` + one mask seed."""

    body: torch.Tensor
    seed: bytes
    base2k: int
    k: int
    rank_out: int = 1
    dsize: int = 1


def gglwe_encrypt_sk_compressed(module: Module, pt, sk: GLWESecretPrepared, base2k: int, k: int,
                                dnum: int, source_xe: Source, source_xa: Source, dsize: int = 1,
                                **kw) -> GGLWECompressed:
    """`gglwe_encrypt_sk` with a branched mask stream; the bodies + seed."""
    seed, child = source_xa.branch()
    ct = gglwe_encrypt_sk(module, pt, sk, base2k, k, dnum, source_xe, child, dsize=dsize, **kw)
    return GGLWECompressed(body=ct.data[..., 0, :, :], seed=seed, base2k=base2k, k=k,
                           rank_out=sk.rank, dsize=dsize)


def gglwe_decompress(module: Module, ct: GGLWECompressed) -> GGLWECiphertext:
    """Every mask column regenerated from the seed in the keygen's order: one
    block `[dnum, rank_out, size, N]` per input column."""
    dnum, rank_in, size, n = ct.body.shape
    mask = _mask_digits(ct.seed, ct.base2k, (rank_in, dnum, ct.rank_out, size, n))
    mask = torch.from_numpy(mask).to(module.device).movedim(0, 1)   # [dnum, rank_in, rank_out, …]
    data = torch.cat([ct.body.to(module.device)[..., None, :, :], mask], dim=-3)
    return GGLWECiphertext(data=data, base2k=ct.base2k, k=ct.k, dsize=ct.dsize)


@dataclass(frozen=True)
class LWECompressed(_Replace):
    """LWE body limbs `[..., size, 1]` + mask seed (uniform digits are already
    normalized, so the stored mask equals the raw stream)."""

    body: torch.Tensor
    seed: bytes
    base2k: int
    k: int
    n_lwe: int = 0


def lwe_encrypt_sk_compressed(module_unused, pt, sk_lwe, base2k: int, k: int,
                              source_xe: Source, source_xa: Source, **kw) -> LWECompressed:
    seed, child = source_xa.branch()
    ct = lwe_encrypt_sk(None, pt, sk_lwe, base2k, k, source_xe, child, **kw)
    return LWECompressed(body=ct.data[..., :, 0:1], seed=seed, base2k=base2k, k=k,
                         n_lwe=int(torch.as_tensor(sk_lwe).shape[-1]))


def lwe_decompress(ct: LWECompressed) -> LWECiphertext:
    """The mask regenerated from the seed, on the body's device."""
    *batch, size, _ = ct.body.shape
    a = torch.from_numpy(_mask_digits(ct.seed, ct.base2k, (*batch, size, ct.n_lwe)))
    data = torch.cat([ct.body, a.to(ct.body.device)], dim=-1)
    return LWECiphertext(data=data, base2k=ct.base2k, k=ct.k)


def glwe_switching_key_encrypt_sk_compressed(module: Module, sk_in: GLWESecret,
                                             sk_out: GLWESecretPrepared, base2k: int, k: int,
                                             dnum: int, source_xe: Source, source_xa: Source,
                                             dsize: int = 1, **kw) -> GGLWECompressed:
    """Seeded switching key sk_in → sk_out."""
    return gglwe_encrypt_sk_compressed(module, sk_in.data, sk_out, base2k, k, dnum, source_xe,
                                       source_xa, dsize=dsize, **kw)


def glwe_automorphism_key_encrypt_sk_compressed(module: Module, p: int, sk: GLWESecret,
                                                base2k: int, k: int, dnum: int,
                                                source_xe: Source, source_xa: Source,
                                                dsize: int = 1,
                                                **kw) -> tuple[GGLWECompressed, int]:
    """Seeded automorphism key of Galois element p (the direct keygen's
    permuted secret).  Returns (key, p)."""
    p_inv = pow(int(p) % (2 * module.n), -1, 2 * module.n)
    sk_out = GLWESecret(data=vec_znx_automorphism(p_inv, sk.data), dist=sk.dist)
    key = gglwe_encrypt_sk_compressed(module, sk.data, glwe_secret_prepare(module, sk_out), base2k,
                                      k, dnum, source_xe, source_xa, dsize=dsize, **kw)
    return key, p


def glwe_to_lwe_key_encrypt_sk_compressed(module: Module, sk_lwe, sk_glwe: GLWESecret,
                                          base2k: int, k: int, dnum: int, source_xe: Source,
                                          source_xa: Source, **kw) -> GGLWECompressed:
    """Seeded switching key sk_glwe → embedded sk_lwe."""
    sk_emb_prep = glwe_secret_prepare(module, lwe_secret_as_glwe(module, sk_lwe))
    return glwe_switching_key_encrypt_sk_compressed(module, sk_glwe, sk_emb_prep, base2k, k,
                                                    dnum, source_xe, source_xa, **kw)


def lwe_to_glwe_key_encrypt_sk_compressed(module: Module, sk_lwe,
                                          sk_glwe_prepared: GLWESecretPrepared, base2k: int,
                                          k: int, dnum: int, source_xe: Source,
                                          source_xa: Source, **kw) -> GGLWECompressed:
    """Seeded switching key embedded sk_lwe → sk_glwe."""
    return glwe_switching_key_encrypt_sk_compressed(module, lwe_secret_as_glwe(module, sk_lwe),
                                                    sk_glwe_prepared, base2k, k, dnum,
                                                    source_xe, source_xa, **kw)


def _secret_product(module: Module, sk: GLWESecret, i: int, sj_p):
    """s_i·s_j, exact through the NTT (the coefficients are tiny)."""
    si_dft = dft.dft_apply(module, sk.data[i][None, :])
    return dft.idft_apply(module, dft.svp_apply(module, si_dft, sj_p))[0]


def glwe_tensor_key_encrypt_sk_compressed(module: Module, sk: GLWESecret,
                                          sk_prepared: GLWESecretPrepared, base2k: int, k: int,
                                          dnum: int, source_xe: Source, source_xa: Source,
                                          dsize: int = 1,
                                          **kw) -> dict[tuple[int, int], GGLWECompressed]:
    """Seeded tensor key: a seeded GGLWE of s_i·s_j per pair i ≤ j, each on
    its own branch of the mask stream."""
    keys = {}
    for i in range(sk.rank):
        for j in range(i, sk.rank):
            sisj = _secret_product(module, sk, i, dft.svp_prepare(module, sk.data[j]))
            keys[(i, j)] = gglwe_encrypt_sk_compressed(module, sisj[None, :], sk_prepared, base2k,
                                                       k, dnum, source_xe, source_xa,
                                                       dsize=dsize, **kw)
    return keys


def glwe_tensor_key_decompress(module: Module, keys: dict) -> dict:
    return {ij: gglwe_decompress(module, c) for ij, c in keys.items()}


def gglwe_to_ggsw_key_encrypt_sk_compressed(module: Module, sk: GLWESecret,
                                            sk_prepared: GLWESecretPrepared, base2k: int, k: int,
                                            dnum: int, source_xe: Source, source_xa: Source,
                                            dsize: int = 1, **kw) -> list[GGLWECompressed]:
    """Seeded GGLWE → GGSW key: per rank element j a seeded GGLWE of
    (s_j·s_0, …, s_j·s_{rank-1}), each on its own branch."""
    keys = []
    for j in range(sk.rank):
        sj_p = dft.svp_prepare(module, sk.data[j])
        pt = torch.stack([_secret_product(module, sk, i, sj_p) for i in range(sk.rank)])
        keys.append(gglwe_encrypt_sk_compressed(module, pt, sk_prepared, base2k, k, dnum,
                                                source_xe, source_xa, dsize=dsize, **kw))
    return keys


def gglwe_to_ggsw_key_decompress(module: Module,
                                 keys: list[GGLWECompressed]) -> list[GGLWEPrepared]:
    """The prepared key list, as the direct keygen returns it."""
    return [gglwe_prepare(module, gglwe_decompress(module, c)) for c in keys]


def lwe_switching_key_encrypt_sk_compressed(module: Module, sk_lwe_in, sk_lwe_out, base2k: int,
                                            k: int, dnum: int, source_xe: Source,
                                            source_xa: Source, **kw) -> GGLWECompressed:
    """Seeded rank-1 switching key between the embedded LWE secrets."""
    sk_out_prep = glwe_secret_prepare(module, lwe_secret_as_glwe(module, sk_lwe_out))
    return glwe_switching_key_encrypt_sk_compressed(module, lwe_secret_as_glwe(module, sk_lwe_in),
                                                    sk_out_prep, base2k, k, dnum, source_xe,
                                                    source_xa, **kw)


def lwe_switching_key_decompress(module: Module, c: GGLWECompressed) -> GGLWEPrepared:
    """Prepared form, ready for `keyswitching.lwe_keyswitch`."""
    return gglwe_prepare(module, gglwe_decompress(module, c))


@dataclass(frozen=True)
class GGSWCompressed(_Replace):
    """GGSW bodies `[..., dnum, rank+1 (pt cols), size, N]` + one mask seed.

    A plaintext in column j > 0 is realised against the raw uniform column,
    which the ciphertext stores as it is, so body + seed give every column."""

    body: torch.Tensor
    seed: bytes
    base2k: int
    k: int
    dsize: int = 1


def ggsw_encrypt_sk_compressed(module: Module, pt, sk: GLWESecretPrepared, base2k: int, k: int,
                               dnum: int, source_xe: Source, source_xa: Source, dsize: int = 1,
                               **kw) -> GGSWCompressed:
    """`ggsw_encrypt_sk` with a branched mask stream; the body column."""
    seed, child = source_xa.branch()
    ct = ggsw_encrypt_sk(module, pt, sk, base2k, k, dnum, source_xe, child, dsize=dsize, **kw)
    return GGSWCompressed(body=ct.data[..., 0, :, :], seed=seed, base2k=base2k, k=k, dsize=dsize)


def _ggsw_mask_shape(ct: GGSWCompressed) -> tuple:
    """The shape of `ggsw_decompress`'s one draw: `ggsw_encrypt_sk`'s mask
    blocks `batch + (dnum, rank, size, N)`, one per plaintext column j."""
    *batch, dnum, cols, size, n = ct.body.shape
    return (cols, *batch, dnum, cols - 1, size, n)


def ggsw_decompress(module: Module, ct: GGSWCompressed) -> GGSWCiphertext:
    """Replay `ggsw_encrypt_sk`'s draws, drawn at once and uploaded once."""
    mask = torch.from_numpy(_mask_digits(ct.seed, ct.base2k, _ggsw_mask_shape(ct)))
    return _ggsw_assemble(module, ct, mask.to(module.device))


def _ggsw_assemble(module: Module, ct: GGSWCompressed, mask) -> GGSWCiphertext:
    """The GGSW from its bodies and the uploaded draw of `_ggsw_mask_shape`."""
    mask = mask.movedim(0, -4)                        # [..., dnum, cols, rank, size, N]
    data = torch.cat([ct.body.to(module.device)[..., None, :, :], mask], dim=-3)
    return GGSWCiphertext(data=data, base2k=ct.base2k, k=ct.k, dsize=ct.dsize)
