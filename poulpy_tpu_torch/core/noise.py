"""Noise: the closed-form variance model and the measured noise of GLWE,
GGLWE and GGSW ciphertexts.  Twin of `poulpy_tpu/core/noise.py`.

The formulas are plain `math`, the same floats as the JAX package's.  The
measured noise decrypts on the module's device (the NTT kernels on the
card) and decodes the difference on the host (`utils/stats.py`).
"""

from __future__ import annotations

import math

import torch

from poulpy_tpu_torch.core.decryption import glwe_decrypt
from poulpy_tpu_torch.core.layouts import GLWECiphertext, GLWEPlaintext
from poulpy_tpu_torch.hal import dft
from poulpy_tpu_torch.hal.normalization import vec_znx_normalize
from poulpy_tpu_torch.hal.vec_znx import vec_znx_sub
from poulpy_tpu_torch.utils.stats import Stats, vec_znx_stats


def var_noise_gglwe_product(n: float, base2k: int, var_xs: float, var_msg: float,
                            var_a_err: float, var_gct_err_lhs: float, var_gct_err_rhs: float,
                            rank_in: float, a_logq: int, b_logq: int) -> float:
    """Output noise variance of a GGLWE product (keyswitch, external product)."""
    a_logq = min(a_logq, b_logq)
    b_scale = 2.0 ** b_logq
    a_scale = 2.0 ** (b_logq - a_logq)
    a_cols = -(-a_logq // base2k)
    base = 2.0 ** base2k
    var_base = base * base / 12.0
    noise = a_cols * n * var_base * (var_gct_err_lhs + var_xs * var_gct_err_rhs)
    noise += var_msg * var_a_err * a_scale * a_scale * n
    noise *= rank_in
    noise /= b_scale * b_scale
    return noise


def log2_std_noise_gglwe_product(n: float, base2k: int, var_xs: float, var_msg: float,
                                 var_a_err: float, var_gct_err_lhs: float,
                                 var_gct_err_rhs: float, rank_in: float, a_logq: int,
                                 b_logq: int) -> float:
    """log2 of the standard deviation of `var_noise_gglwe_product`."""
    return log2_std(var_noise_gglwe_product(n, base2k, var_xs, var_msg, var_a_err,
                                            var_gct_err_lhs, var_gct_err_rhs, rank_in, a_logq,
                                            b_logq))


def var_sigma(sigma: float, k: int) -> float:
    """Variance of fresh encryption noise at torus scale 2^-k."""
    return (sigma / 2.0 ** k) ** 2


XS_VAR = {"ternary_prob": 0.5, "binary_prob": 0.25, "binary_block": 0.25}


def var_noise_keyswitch(n: float, base2k: int, k_ct: int, k_ksk: int, dnum: int, dsize: int,
                        rank_in: int, sigma_key: float = 3.2,
                        var_xs: float = XS_VAR["ternary_prob"]) -> float:
    """Output noise variance of a GLWE keyswitch."""
    base = 2.0 ** (dsize * base2k)
    var_base = base * base / 12.0
    scale = 2.0 ** k_ksk
    var_gct = sigma_key * sigma_key
    noise = dnum * n * var_base * var_gct
    noise *= rank_in
    noise /= scale * scale
    return noise


def var_noise_external_product(n: float, base2k: int, k_ct: int, k_ggsw: int, dnum: int,
                               dsize: int, rank: int, sigma_key: float = 3.2,
                               var_xs: float = XS_VAR["ternary_prob"]) -> float:
    """Output noise variance of a GLWE × GGSW external product: rank+1 input
    columns pass through the gadget."""
    return var_noise_keyswitch(n, base2k, k_ct, k_ggsw, dnum, dsize, rank + 1, sigma_key, var_xs)


def log2_std(v: float) -> float:
    return 0.5 * math.log2(max(v, 1e-300))


def glwe_noise(module, ct: GLWECiphertext, pt_want: GLWEPlaintext, sk_prepared) -> Stats:
    """Measured noise of a GLWE against the plaintext it should decrypt to:
    decrypt, subtract, normalize, stats."""
    assert pt_want.base2k == ct.base2k, "pt_want must share the ct base2k"
    pt_have = glwe_decrypt(module, ct, sk_prepared)
    d = vec_znx_normalize(ct.base2k, vec_znx_sub(pt_have.data, pt_want.data))
    return vec_znx_stats(ct.base2k, d)


def _gadget_plaintext(gadget, row: int, pt_scalar):
    """Expected plaintext limbs of gadget row `row`: the scalar at limb
    (dsize-1) + row·dsize."""
    pt = torch.zeros(pt_scalar.shape[:-1] + (gadget.size, gadget.n), dtype=torch.int64,
                     device=pt_scalar.device)
    pt[..., (gadget.dsize - 1) + row * gadget.dsize, :] = pt_scalar
    return pt


def gglwe_noise(module, gglwe, row: int, col: int, pt_want_scalar, sk_prepared) -> Stats:
    """Measured noise of GGLWE gadget row (row, col) against the `[N]` scalar
    of input column `col` at that digit."""
    pt_want_scalar = torch.as_tensor(pt_want_scalar, dtype=torch.int64).to(module.device)
    ct = GLWECiphertext(data=gglwe.data[..., row, col, :, :, :], base2k=gglwe.base2k, k=gglwe.k)
    pt = GLWEPlaintext(data=_gadget_plaintext(gglwe, row, pt_want_scalar), base2k=gglwe.base2k,
                       k=gglwe.k)
    return glwe_noise(module, ct, pt, sk_prepared)


def ggsw_noise(module, ggsw, row: int, col: int, pt_want_scalar, sk_prepared) -> Stats:
    """Measured noise of GGSW row (row, col): the expected value is m·s_col
    at the row's digit, s_0 = 1, so for col > 0 the digit plaintext is
    multiplied by sk[col-1] in the NTT domain first."""
    pt_want_scalar = torch.as_tensor(pt_want_scalar, dtype=torch.int64).to(module.device)
    pt_limbs = _gadget_plaintext(ggsw, row, pt_want_scalar)
    if col > 0:
        pt_dft = dft.svp_apply(module, dft.dft_apply(module, pt_limbs), sk_prepared.data[col - 1])
        pt_limbs = dft.big_normalize(module, ggsw.size, ggsw.base2k,
                                     dft.idft_apply(module, pt_dft), ggsw.base2k)
    ct = GLWECiphertext(data=ggsw.data[..., row, col, :, :, :], base2k=ggsw.base2k, k=ggsw.k)
    pt = GLWEPlaintext(data=pt_limbs, base2k=ggsw.base2k, k=ggsw.k)
    return glwe_noise(module, ct, pt, sk_prepared)
