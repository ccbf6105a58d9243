"""CKKS plaintext forms: twin of `poulpy_tpu/ckks/plaintext.py`.

Four plaintext representations, as in the reference:
  VecRnx  float coefficient polynomial before quantization
  VecZnx  quantized torus-limb polynomial (`CKKSPlaintext`, ckks/layouts.py)
  CstRnx  float scalar constant re + im·i
  CstZnx  quantized scalar constant
with their conversions and the ct × pt multiplies that take them.
Quantization is host numpy; the multiplies run the convolution and scalar
paths of `ckks/ops.py` and `core/operations.py`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from poulpy_tpu_torch.ckks.layouts import CKKSCiphertext, CKKSMeta, CKKSPlaintext
from poulpy_tpu_torch.ckks.ops import _checked_sub, mul_plain
from poulpy_tpu_torch.core.layouts import GLWEPlaintext, _Replace, glwe_size
from poulpy_tpu_torch.core.operations import glwe_add, glwe_mul_scalar, glwe_rotate
from poulpy_tpu_torch.hal import vec_znx
from poulpy_tpu_torch.hal.module import Module


@dataclass(frozen=True)
class CKKSPlaintextVecRnx(_Replace):
    """Float coefficient polynomial before quantization; leading axes batch."""

    coeffs: torch.Tensor  # float64 [..., N]

    @property
    def n(self) -> int:
        return self.coeffs.shape[-1]


@dataclass(frozen=True)
class CKKSPlaintextCstRnx(_Replace):
    """Scalar constant re + im·i in float form; either part may be absent."""

    re: float | None = None
    im: float | None = None


@dataclass(frozen=True)
class CKKSPlaintextCstZnx(_Replace):
    """Quantized scalar constant: round(re·2^log_delta), round(im·2^log_delta)
    and their meta."""

    re: int | None = None
    im: int | None = None
    meta: CKKSMeta | None = None


def vec_rnx_to_znx(pt: CKKSPlaintextVecRnx, base2k: int, k_pt: int,
                   meta: CKKSMeta) -> CKKSPlaintext:
    """Quantize: the digits of round(coeffs · 2^log_delta) at torus precision
    effective_k ≤ 62, on the coefficients' device."""
    if meta.effective_k > 62:
        raise ValueError("effective_k > 62 needs the wide encode path")
    coeffs = torch.as_tensor(pt.coeffs, dtype=torch.float64)
    q = np.rint(coeffs.cpu().numpy() * float(2.0 ** meta.log_delta)).astype(np.int64)
    data = vec_znx.encode_vec_i64(base2k, meta.effective_k, glwe_size(base2k, k_pt),
                                  torch.from_numpy(q).to(coeffs.device))
    return CKKSPlaintext(pt=GLWEPlaintext(data=data, base2k=base2k, k=k_pt), meta=meta)


def vec_rnx_from_znx(pt: CKKSPlaintext) -> CKKSPlaintextVecRnx:
    """Dequantize back to float coefficients."""
    q = vec_znx.decode_vec_i64(pt.pt.base2k, pt.meta.effective_k, pt.pt.data)
    return CKKSPlaintextVecRnx(coeffs=q.to(torch.float64) / float(2.0 ** pt.meta.log_delta))


def cst_rnx_to_znx(cst: CKKSPlaintextCstRnx, meta: CKKSMeta) -> CKKSPlaintextCstZnx:
    """Quantize a scalar constant."""
    s = 2.0 ** meta.log_delta
    return CKKSPlaintextCstZnx(re=None if cst.re is None else int(round(cst.re * s)),
                               im=None if cst.im is None else int(round(cst.im * s)), meta=meta)


def mul_plain_rnx(module: Module, a: CKKSCiphertext, pt_rnx: CKKSPlaintextVecRnx,
                  meta: CKKSMeta) -> CKKSCiphertext:
    """ct × float polynomial: quantized at `meta` (stored at its effective_k),
    then the convolution ct × pt of `ops.mul_plain`."""
    return mul_plain(module, a, vec_rnx_to_znx(pt_rnx, a.glwe.base2k, meta.effective_k, meta))


def mul_cst_znx(module: Module, a: CKKSCiphertext, cst: CKKSPlaintextCstZnx) -> CKKSCiphertext:
    """ct × quantized scalar constant: re·ct + X^{N/2}·(im·ct), since the
    rotation by N/2 multiplies every slot by i.  The integer multiply is the
    scale landing: effective_k drops by the constant's log_delta."""
    del module
    budget = _checked_sub("mul_cst_znx", a.log_budget, cst.meta.log_delta)
    if cst.re is None and cst.im is None:
        glwe = a.glwe.replace(data=torch.zeros_like(a.glwe.data))
    elif cst.im is None:
        glwe = glwe_mul_scalar(cst.re, a.glwe)
    elif cst.re is None:
        glwe = glwe_rotate(a.glwe.n // 2, glwe_mul_scalar(cst.im, a.glwe))
    else:
        glwe = glwe_add(glwe_mul_scalar(cst.re, a.glwe),
                        glwe_rotate(a.glwe.n // 2, glwe_mul_scalar(cst.im, a.glwe)))
    return CKKSCiphertext(glwe=glwe, meta=CKKSMeta(log_delta=a.meta.log_delta, log_budget=budget))


def mul_cst_rnx(module: Module, a: CKKSCiphertext, cst: CKKSPlaintextCstRnx,
                meta: CKKSMeta) -> CKKSCiphertext:
    """ct × float scalar constant: quantized at `meta`, then `mul_cst_znx`."""
    return mul_cst_znx(module, a, cst_rnx_to_znx(cst, meta))
