"""GLWE add / sub: twins of the two `poulpy_tpu/core/operations.py`
functions that `glwe_cmux` needs."""

from __future__ import annotations

from poulpy_tpu_torch.core.layouts import GLWECiphertext, glwe_size
from poulpy_tpu_torch.hal.vec_znx import vec_znx_add, vec_znx_sub


def _binary(ct_a: GLWECiphertext, ct_b: GLWECiphertext, op):
    if ct_a.base2k != ct_b.base2k:
        raise ValueError("align base2k first")
    k = max(ct_a.k, ct_b.k)
    size = glwe_size(ct_a.base2k, k)
    return GLWECiphertext(data=op(ct_a.data, ct_b.data, size), base2k=ct_a.base2k, k=k)


def glwe_add(a: GLWECiphertext, b: GLWECiphertext) -> GLWECiphertext:
    return _binary(a, b, lambda x, y, s: vec_znx_add(x, y, res_size=s))


def glwe_sub(a: GLWECiphertext, b: GLWECiphertext) -> GLWECiphertext:
    return _binary(a, b, lambda x, y, s: vec_znx_sub(x, y, res_size=s))
