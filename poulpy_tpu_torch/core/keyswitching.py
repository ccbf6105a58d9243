"""Key switching of GLWE, GGLWE, GGSW and LWE ciphertexts: twin of
`poulpy_tpu/core/keyswitching.py`.

The mask limbs go through one fused product with the prepared key and the
body is added to column 0 of the big accumulator before the normalization:
one CUDA launch for a CUDA batch (`fused_glwe_product(small=…)`, or the MXU
route that `route` asks for), the plain stage chain for a CPU one.  A key whose product bound exceeds 62 bits takes
the wide (i128-twin) exit, `fused_glwe_product_wide` with the body as
column 0 of its per-column `small`.  The GGLWE, GGSW and LWE keyswitches
are layers over `glwe_keyswitch` (the GGSW's rebuilds its other columns
through `conversion.ggsw_from_gglwe`).
"""

from __future__ import annotations

import torch

from poulpy_tpu_torch.backends.mxu_product import glwe_product
from poulpy_tpu_torch.backends.wide import fused_glwe_product_wide
from poulpy_tpu_torch.core.encryption import glwe_switching_key_encrypt_sk
from poulpy_tpu_torch.core.layouts import (
    GGLWECiphertext,
    GGSWCiphertext,
    GLWECiphertext,
    LWECiphertext,
    glwe_size,
)
from poulpy_tpu_torch.core.prepared import GGLWEPrepared, gglwe_prepare, glwe_secret_prepare
from poulpy_tpu_torch.hal import dft
from poulpy_tpu_torch.hal.module import Module
from poulpy_tpu_torch.hal.normalization import vec_znx_normalize_full
from poulpy_tpu_torch.parallel.auto import dp_shard


def gglwe_product_dft(module: Module, a_dft, key: GGLWEPrepared):
    """`a_dft` [..., cols_in, size_a, P, N] × the key matrix in the DFT
    domain.  dsize > 1 groups the limbs of `a` by digit residue:
    Σ_di vmp(a[dsize−1−di :: dsize], pmat, limb_offset=di)."""
    dsize = key.dsize
    if dsize == 1:
        return dft.vmp_apply(module, a_dft, key.pmat)
    a_size = a_dft.shape[-3]
    res = None
    for di in range(dsize):
        ai_size = min((a_size + di) // dsize, key.dnum)
        if ai_size == 0:
            continue
        ai = dft.dft_copy(a_dft, step=dsize, offset=dsize - di - 1, res_size=ai_size)
        part = dft.vmp_apply(module, ai, key.pmat, limb_offset=di)
        res = part if res is None else dft.dft_add(module, res, part)
    return res


def glwe_keyswitch(module: Module, a: GLWECiphertext, key: GGLWEPrepared,
                   res_base2k: int | None = None, res_k: int | None = None,
                   route: str = "fused") -> GLWECiphertext:
    """res = normalize(idft(gglwe_product(dft(a[1:]), key)) + a[0] at column 0).
    `route` as in `external_product.glwe_external_product`; on a
    mesh-attached module the batch runs dp-sharded (parallel/auto.py)."""
    if module.mesh is not None:
        return dp_shard(module, lambda a_: glwe_keyswitch(
            module.local, a_, key, res_base2k, res_k, route), a)
    res_base2k = a.base2k if res_base2k is None else res_base2k
    res_k = a.k if res_k is None else res_k
    res_size = glwe_size(res_base2k, res_k)
    if a.base2k != key.base2k:
        a = glwe_normalize(module, a, key.base2k, a.k)
    bits = dft.product_bits(key.base2k, key.base2k, module.log_n, key.dnum * max(1, a.rank))
    if dft.needs_wide(bits):
        co, psize = key.pmat.shape[2:4]
        body = a.data[..., 0, :min(a.size, psize), :]
        small = torch.zeros(body.shape[:-2] + (co,) + body.shape[-2:], dtype=body.dtype,
                            device=body.device)
        small[..., 0, :, :] = body
        res = fused_glwe_product_wide(module, a.data[..., 1:, :, :], key.pmat, res_size,
                                      res_base2k, key.base2k, small=small, dsize=key.dsize)
    else:
        res = glwe_product(module, route, a.data[..., 1:, :, :], key.pmat, res_size, res_base2k,
                           key.base2k, key.dsize, small=a.data[..., 0, :, :])
    return GLWECiphertext(data=res, base2k=res_base2k, k=res_k)


def glwe_normalize(module: Module, a: GLWECiphertext, base2k: int, k: int) -> GLWECiphertext:
    """Base-2^k conversion of a whole ciphertext."""
    del module
    data = vec_znx_normalize_full(glwe_size(base2k, k), base2k, 0, a.data, a.base2k)
    return GLWECiphertext(data=data, base2k=base2k, k=k)


def gglwe_keyswitch(module: Module, a: GGLWECiphertext, key: GGLWEPrepared,
                    res_base2k: int | None = None, res_k: int | None = None) -> GGLWECiphertext:
    """Every (row, column) sub-ciphertext of a GGLWE keyswitched, the
    (dnum, rank_in) axes as batch axes of one `glwe_keyswitch`."""
    if a.rank_out != key.rank_in:
        raise ValueError(f"a GGLWE of rank_out {a.rank_out} under a key of rank_in {key.rank_in}")
    ks = glwe_keyswitch(module, GLWECiphertext(data=a.data, base2k=a.base2k, k=a.k), key,
                        res_base2k, res_k)
    return GGLWECiphertext(data=ks.data, base2k=ks.base2k, k=ks.k, dsize=a.dsize)


def ggsw_keyswitch(module: Module, a: GGSWCiphertext, key: GGLWEPrepared, tsk,
                   res_base2k: int | None = None, res_k: int | None = None) -> GGSWCiphertext:
    """GGSW keyswitch s_in → s_out: column 0 of every gadget row keyswitched
    (batched over dnum), the other columns rebuilt from it through the
    GGLWE → GGSW key `tsk` under s_out (`conversion.ggsw_from_gglwe`)."""
    from poulpy_tpu_torch.core.conversion import ggsw_from_gglwe  # conversion imports this module

    col0 = GLWECiphertext(data=a.data[..., :, 0, :, :, :], base2k=a.base2k, k=a.k)
    ks = glwe_keyswitch(module, col0, key, res_base2k, res_k)
    gglwe = GGLWECiphertext(data=ks.data[..., :, None, :, :, :], base2k=ks.base2k, k=ks.k,
                            dsize=a.dsize)
    return ggsw_from_gglwe(module, gglwe, tsk)


def lwe_keyswitch(module: Module, a: LWECiphertext, ksk: GGLWEPrepared, n_lwe_out: int,
                  res_base2k: int | None = None, res_k: int | None = None) -> LWECiphertext:
    """LWE → LWE: embed into a rank-1 GLWE, keyswitch with the key between
    the embedded LWE secrets, extract coefficient 0."""
    from poulpy_tpu_torch.core.conversion import lwe_as_glwe, lwe_sample_extract

    ks = glwe_keyswitch(module, lwe_as_glwe(module, a), ksk, res_base2k, res_k)
    return lwe_sample_extract(ks, n_lwe_out, ks.k)


def lwe_switching_key_encrypt_sk(module: Module, sk_lwe_in, sk_lwe_out, base2k: int, k: int,
                                 dnum: int, source_xe, source_xa, **kw) -> GGLWEPrepared:
    """The prepared switching key between the φ_{-1}-embedded images of two
    LWE secrets."""
    from poulpy_tpu_torch.core.conversion import lwe_secret_as_glwe

    sk_out = glwe_secret_prepare(module, lwe_secret_as_glwe(module, sk_lwe_out))
    ksk = glwe_switching_key_encrypt_sk(module, lwe_secret_as_glwe(module, sk_lwe_in), sk_out,
                                        base2k, k, dnum, source_xe, source_xa, **kw)
    return gglwe_prepare(module, ksk)
