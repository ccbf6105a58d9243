"""GLWE → LWE bridges: twin of `poulpy_tpu/core/conversion.py` (the port's
part).

The LWE secret t is embedded as the rank-1 GLWE secret φ_{-1}(Σ t_j X^j),
which makes coefficient-0 extraction a plain copy: lwe = (b_0, a_0, …, a_{n-1}).
"""

from __future__ import annotations

import torch

from poulpy_tpu_torch.core.encryption import glwe_switching_key_encrypt_sk
from poulpy_tpu_torch.core.layouts import GLWECiphertext, GLWESecret, LWECiphertext, glwe_size
from poulpy_tpu_torch.core.prepared import GGLWEPrepared, gglwe_prepare, glwe_secret_prepare
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


def glwe_to_lwe_key_encrypt_sk(module: Module, sk_lwe, sk_glwe: GLWESecret, base2k: int, k: int,
                               dnum: int, source_xe, source_xa, **kw) -> GGLWEPrepared:
    """The prepared switching key sk_glwe → embedded sk_lwe."""
    sk_emb_prep = glwe_secret_prepare(module, lwe_secret_as_glwe(module, sk_lwe))
    ksk = glwe_switching_key_encrypt_sk(module, sk_glwe, sk_emb_prep, base2k, k, dnum,
                                        source_xe, source_xa, **kw)
    return gglwe_prepare(module, ksk)
