"""GLWE × GGSW external product and CMux.

Twin of `poulpy_tpu/core/external_product.py`.  Every product, any dsize,
goes through one fused wrapper: one CUDA launch for a CUDA batch, the plain
stage chain (dft → vmp → idft → normalize) for a CPU one.  A parameter set
whose product bound exceeds 62 bits takes the wide (i128-twin) exit,
`backends.wide.fused_glwe_product_wide`; the others
`backends.fused.fused_glwe_product`, or the MXU route that `route` asks for.
"""

from __future__ import annotations

from poulpy_tpu_torch.backends.mxu_product import glwe_product
from poulpy_tpu_torch.backends.wide import fused_glwe_product_wide
from poulpy_tpu_torch.core.layouts import GLWECiphertext, glwe_size
from poulpy_tpu_torch.core.operations import glwe_add, glwe_sub
from poulpy_tpu_torch.core.prepared import GGSWPrepared
from poulpy_tpu_torch.hal import dft
from poulpy_tpu_torch.hal.module import Module
from poulpy_tpu_torch.hal.normalization import vec_znx_normalize_full
from poulpy_tpu_torch.parallel.auto import dp_shard


def glwe_external_product(module: Module, a: GLWECiphertext, ggsw: GGSWPrepared,
                          res_base2k: int | None = None, res_k: int | None = None,
                          route: str = "fused") -> GLWECiphertext:
    """a ⊡ ggsw.  `route` picks the non-wide product's kernels: "fused" (the
    butterfly fused product, the default), "mxu" (the four-step transforms,
    VMP and exit as four launches) or "fused_mxu" (the four-step transforms
    in one fused launch), each where the JAX package's conditions allow it
    (`backends.mxu_product.mxu_route`); a wide product always takes the wide
    exit.  On a mesh-attached module the batch runs dp-sharded
    (parallel/auto.py)."""
    if module.mesh is not None:
        return dp_shard(module, lambda a_: glwe_external_product(
            module.local, a_, ggsw, res_base2k, res_k, route), a)
    res_base2k = a.base2k if res_base2k is None else res_base2k
    res_k = a.k if res_k is None else res_k
    res_size = glwe_size(res_base2k, res_k)
    if a.base2k != ggsw.base2k:
        data = vec_znx_normalize_full(glwe_size(ggsw.base2k, a.k), ggsw.base2k, 0, a.data,
                                      a.base2k)
        a = GLWECiphertext(data=data, base2k=ggsw.base2k, k=a.k)
    bits = dft.product_bits(ggsw.base2k, ggsw.base2k, module.log_n, ggsw.dnum * (ggsw.rank + 1))
    if dft.needs_wide(bits):
        res = fused_glwe_product_wide(module, a.data, ggsw.pmat, res_size, res_base2k,
                                      ggsw.base2k, dsize=ggsw.dsize)
    else:
        res = glwe_product(module, route, a.data, ggsw.pmat, res_size, res_base2k, ggsw.base2k,
                           ggsw.dsize)
    return GLWECiphertext(data=res, base2k=res_base2k, k=res_k)


def glwe_cmux(module: Module, sel: GGSWPrepared, ct1: GLWECiphertext,
              ct0: GLWECiphertext) -> GLWECiphertext:
    """CMux(sel, ct1, ct0) = ct0 + sel ⊡ (ct1 − ct0)."""
    diff = glwe_sub(ct1, ct0)
    prod = glwe_external_product(module, diff, sel, ct0.base2k, ct0.k)
    return glwe_add(ct0, prod)
