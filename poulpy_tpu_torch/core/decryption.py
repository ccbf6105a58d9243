"""GLWE and LWE decryption: twin of `poulpy_tpu/core/decryption.py`.

pt = norm(ct[0] + Σ_i ct[i]·s_i): the big accumulator collects the exact
NTT products before a single carry normalization.
"""

from __future__ import annotations

import torch

from poulpy_tpu_torch.core.layouts import GLWECiphertext, GLWEPlaintext, LWECiphertext, glwe_size
from poulpy_tpu_torch.core.prepared import GLWESecretPrepared
from poulpy_tpu_torch.hal import dft
from poulpy_tpu_torch.hal.module import Module
from poulpy_tpu_torch.hal.normalization import vec_znx_normalize


def glwe_decrypt(module: Module, ct: GLWECiphertext, sk: GLWESecretPrepared,
                 pt_base2k: int | None = None, pt_k: int | None = None) -> GLWEPlaintext:
    pt_base2k = ct.base2k if pt_base2k is None else pt_base2k
    pt_k = ct.k if pt_k is None else pt_k
    pt_size = glwe_size(pt_base2k, pt_k)
    c0_big = torch.zeros(ct.batch_shape + (ct.size, module.n), dtype=torch.int64,
                         device=ct.data.device)
    for i in range(1, ct.rank + 1):
        ci_dft = dft.dft_apply(module, ct.data[..., i, :, :])
        ci_dft = dft.svp_apply(module, ci_dft, sk.data[i - 1])
        c0_big = c0_big + dft.idft_apply(module, ci_dft)
    c0_big = c0_big + ct.data[..., 0, :, :]
    pt = dft.big_normalize(module, pt_size, pt_base2k, c0_big, ct.base2k)
    return GLWEPlaintext(data=pt, base2k=pt_base2k, k=pt_k)


def lwe_decrypt(ct: LWECiphertext, sk_lwe):
    """pt limbs `[..., size]` = norm(b + <a, s>) in the ciphertext's base."""
    sk_lwe = torch.as_tensor(sk_lwe, dtype=torch.int64).to(ct.data.device)
    acc = ct.data[..., :, 0] + (ct.data[..., :, 1:] * sk_lwe).sum(dim=-1)
    return vec_znx_normalize(ct.base2k, acc[..., None])[..., 0]
