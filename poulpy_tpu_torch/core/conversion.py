"""Scheme-switch bridges GLWE ↔ LWE and GGLWE → GGSW: twin of
`poulpy_tpu/core/conversion.py`.

The LWE secret t is embedded as the rank-1 GLWE secret φ_{-1}(Σ t_j X^j),
which makes coefficient-0 extraction a plain copy: lwe = (b_0, a_0, …, a_{n-1}).
The GGLWE → GGSW expansion runs its transforms and products through the NTT
and VMP kernels on the card (`hal/dft.py`).
"""

from __future__ import annotations

import torch

from poulpy_tpu_torch.core.encryption import gglwe_encrypt_sk, glwe_switching_key_encrypt_sk
from poulpy_tpu_torch.core.keyswitching import gglwe_product_dft, glwe_keyswitch
from poulpy_tpu_torch.core.layouts import (
    GGLWECiphertext,
    GGSWCiphertext,
    GLWECiphertext,
    GLWESecret,
    LWECiphertext,
    glwe_size,
)
from poulpy_tpu_torch.core.operations import glwe_rotate
from poulpy_tpu_torch.core.prepared import (
    GGLWEPrepared,
    GLWESecretPrepared,
    gglwe_prepare,
    glwe_secret_prepare,
)
from poulpy_tpu_torch.hal import dft
from poulpy_tpu_torch.hal.module import Module
from poulpy_tpu_torch.hal.vec_znx import vec_znx_automorphism


def lwe_secret_as_glwe(module: Module, sk_lwe, dist: str = "ternary_prob") -> GLWESecret:
    """Embed an LWE secret (length ≤ N) as a rank-1 GLWE secret via φ_{-1}."""
    sk_lwe = torch.as_tensor(sk_lwe, dtype=torch.int64).to(module.device)
    data = torch.zeros((1, module.n), dtype=torch.int64, device=module.device)
    data[0, : sk_lwe.shape[-1]] = sk_lwe
    return GLWESecret(data=vec_znx_automorphism(-1, data), dist=dist)


def lwe_sample_extract(a: GLWECiphertext, n_lwe: int, k: int | None = None) -> LWECiphertext:
    """Coefficient-0 extraction of a rank-1 GLWE: lwe limb i =
    (body[i][0], mask[i][0..n_lwe])."""
    if a.rank != 1:
        raise ValueError(f"sample extraction takes a rank-1 GLWE, got rank {a.rank}")
    k = a.k if k is None else k
    size = min(glwe_size(a.base2k, k), a.size)
    body = a.data[..., 0, :size, 0:1]
    mask = a.data[..., 1, :size, :n_lwe]
    return LWECiphertext(data=torch.cat([body, mask], dim=-1), base2k=a.base2k, k=k)


def lwe_from_glwe(module: Module, a: GLWECiphertext, idx: int, key: GGLWEPrepared, n_lwe: int,
                  lwe_base2k: int | None = None, lwe_k: int | None = None) -> LWECiphertext:
    """Coefficient `idx` as an LWE under the LWE secret: rotate by X^{-idx},
    keyswitch to the embedded LWE secret, extract coefficient 0."""
    lwe_base2k = a.base2k if lwe_base2k is None else lwe_base2k
    lwe_k = a.k if lwe_k is None else lwe_k
    if idx != 0:
        a = glwe_rotate(-idx, a)
    return lwe_sample_extract(glwe_keyswitch(module, a, key, lwe_base2k, lwe_k), n_lwe, lwe_k)


def lwe_as_glwe(module: Module, lwe: LWECiphertext) -> GLWECiphertext:
    """An LWE as a rank-1 GLWE under the embedded LWE secret: the body in
    coefficient 0, the mask in coefficients 0..n_lwe of column 1."""
    batch = tuple(lwe.data.shape[:-2])
    data = torch.zeros(batch + (2, lwe.size, module.n), dtype=torch.int64,
                       device=lwe.data.device)
    data[..., 0, :, 0] = lwe.data[..., :, 0]
    data[..., 1, :, : lwe.n_lwe] = lwe.data[..., :, 1:]
    return GLWECiphertext(data=data, base2k=lwe.base2k, k=lwe.k)


def glwe_from_lwe(module: Module, lwe: LWECiphertext, key: GGLWEPrepared,
                  res_base2k: int | None = None, res_k: int | None = None) -> GLWECiphertext:
    """Embed an LWE into a rank-1 GLWE, then keyswitch to the GLWE secret."""
    return glwe_keyswitch(module, lwe_as_glwe(module, lwe), key, res_base2k, res_k)


def glwe_to_lwe_key_encrypt_sk(module: Module, sk_lwe, sk_glwe: GLWESecret, base2k: int, k: int,
                               dnum: int, source_xe, source_xa, **kw) -> GGLWEPrepared:
    """The prepared switching key sk_glwe → embedded sk_lwe."""
    sk_emb_prep = glwe_secret_prepare(module, lwe_secret_as_glwe(module, sk_lwe))
    ksk = glwe_switching_key_encrypt_sk(module, sk_glwe, sk_emb_prep, base2k, k, dnum,
                                        source_xe, source_xa, **kw)
    return gglwe_prepare(module, ksk)


def lwe_to_glwe_key_encrypt_sk(module: Module, sk_lwe, sk_glwe_prepared: GLWESecretPrepared,
                               base2k: int, k: int, dnum: int, source_xe, source_xa,
                               **kw) -> GGLWEPrepared:
    """The prepared switching key embedded sk_lwe → sk_glwe."""
    ksk = glwe_switching_key_encrypt_sk(module, lwe_secret_as_glwe(module, sk_lwe),
                                        sk_glwe_prepared, base2k, k, dnum, source_xe, source_xa,
                                        **kw)
    return gglwe_prepare(module, ksk)


def gglwe_to_ggsw_key_encrypt_sk(module: Module, sk: GLWESecret,
                                 sk_prepared: GLWESecretPrepared, base2k: int, k: int, dnum: int,
                                 source_xe, source_xa, dsize: int = 1,
                                 **kw) -> list[GGLWEPrepared]:
    """The GGLWE → GGSW (tensor) key: keys[j] is a prepared GGLWE with
    rank_in = rank encrypting (s_j·s_0, …, s_j·s_{rank−1}) under s, the
    exact products taken through the NTT (the coefficients are tiny)."""
    keys = []
    for j in range(sk.rank):
        sj_p = dft.svp_prepare(module, sk.data[j])
        pt = torch.stack([
            dft.idft_apply(module, dft.svp_apply(module, dft.dft_apply(module, sk.data[i][None, :]),
                                                 sj_p))[0]
            for i in range(sk.rank)])
        keys.append(gglwe_prepare(module, gglwe_encrypt_sk(
            module, pt, sk_prepared, base2k, k, dnum, source_xe, source_xa, dsize=dsize, **kw)))
    return keys


def ggsw_from_gglwe(module: Module, a: GGLWECiphertext,
                    tsk: list[GGLWEPrepared]) -> GGSWCiphertext:
    """GGLWE (rank_in 1) → GGSW: column 0 of each row is the GGLWE row
    itself; column j ≥ 1 is normalize(idft(gglwe_product(dft(row mask),
    tsk[j−1]))) with the row's body added into column j first."""
    rank = a.rank_out
    if len(tsk) != rank:
        raise ValueError(f"{len(tsk)} tensor keys for rank {rank}")
    rows = []
    for r in range(a.dnum):
        row = a.data[..., r, 0, :, :, :]                      # [..., rank+1, size, N]
        a_dft = dft.dft_apply(module, row[..., 1:, :, :])
        cols = [row]
        for col, key in enumerate(tsk, start=1):
            big = dft.idft_apply(module, gglwe_product_dft(module, a_dft, key))   # fresh
            big[..., col, :, :] += dft._align_limbs(row[..., 0, :, :], big[..., col, :, :],
                                                    big.shape[-2], limb_axis=-2)[0]
            cols.append(dft.big_normalize(module, a.size, a.base2k, big, key.base2k))
        rows.append(torch.stack(cols, dim=-4))
    return GGSWCiphertext(data=torch.stack(rows, dim=-5), base2k=a.base2k, k=a.k, dsize=a.dsize)
