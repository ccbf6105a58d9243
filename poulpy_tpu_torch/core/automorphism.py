"""GLWE automorphisms: twin of `poulpy_tpu/core/automorphism.py`.

φ_p(ct): keyswitch with the automorphism key (a GGLWE of s under
φ_{p^{-1}}(s)), then the coefficient permutation X → X^p on every column.
The keyswitch is `glwe_keyswitch`: one fused product with the body added
(`fused_product_small`) on the card.  A GGSW's other columns are rebuilt
from the permuted column 0 by the GGLWE → GGSW expansion.
"""

from __future__ import annotations

from poulpy_tpu_torch.core.conversion import ggsw_from_gglwe
from poulpy_tpu_torch.core.keyswitching import glwe_keyswitch
from poulpy_tpu_torch.core.layouts import GGLWECiphertext, GGSWCiphertext, GLWECiphertext
from poulpy_tpu_torch.core.operations import glwe_add
from poulpy_tpu_torch.core.prepared import GLWEAutomorphismKeyPrepared
from poulpy_tpu_torch.hal.module import Module
from poulpy_tpu_torch.hal.vec_znx import vec_znx_automorphism


def glwe_automorphism(module: Module, a: GLWECiphertext, key: GLWEAutomorphismKeyPrepared,
                      res_base2k: int | None = None, res_k: int | None = None) -> GLWECiphertext:
    """φ_p(a): keyswitch, then permute."""
    ks = glwe_keyswitch(module, a, key.key, res_base2k, res_k)
    return ks.replace(data=vec_znx_automorphism(key.p, ks.data))


def ggsw_automorphism(module: Module, a: GGSWCiphertext, key: GLWEAutomorphismKeyPrepared,
                      tsk) -> GGSWCiphertext:
    """φ_p of a GGSW ciphertext: φ_p on column 0 of every gadget row (one
    keyswitch batched over the rows), then the other columns rebuilt through
    the GGLWE → GGSW key `tsk` (`conversion.ggsw_from_gglwe`)."""
    col0 = GLWECiphertext(data=a.data[..., :, 0, :, :, :], base2k=a.base2k, k=a.k)
    auto = glwe_automorphism(module, col0, key)
    gglwe = GGLWECiphertext(data=auto.data[..., :, None, :, :, :], base2k=auto.base2k, k=auto.k,
                            dsize=a.dsize)
    return ggsw_from_gglwe(module, gglwe, tsk)


def glwe_automorphism_key_automorphism(module: Module, a: GGLWECiphertext, a_p: int,
                                       key: GLWEAutomorphismKeyPrepared):
    """Composes the automorphism key `a` of element a_p with `key` into the
    key of a_p·key.p: per sub-ciphertext φ_{a_p}, the keyswitch under
    `key`, then φ_{a_p^{-1}}.  Returns (GGLWE, a_p·key.p mod 2N)."""
    order = 2 * module.n
    p = int(a_p) % order
    tmp = vec_znx_automorphism(p, a.data)
    ks = glwe_keyswitch(module, GLWECiphertext(data=tmp, base2k=a.base2k, k=a.k), key.key)
    out = vec_znx_automorphism(pow(p, -1, order), ks.data)
    return (GGLWECiphertext(data=out, base2k=ks.base2k, k=ks.k, dsize=a.dsize),
            (p * key.p) % order)


def glwe_automorphism_add(module: Module, res: GLWECiphertext,
                          key: GLWEAutomorphismKeyPrepared) -> GLWECiphertext:
    """res + φ_p(res), the trace step."""
    return glwe_add(res, glwe_automorphism(module, res, key, res.base2k, res.k))
