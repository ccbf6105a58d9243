"""GLWE arithmetic: twin of `poulpy_tpu/core/operations.py`: add / sub /
negate, plaintext adds, rotations, shifts, normalization, scalar and
plaintext products, the tensor product and its relinearization.

`glwe_tensor_relinearize` takes, for a rank-1, non-wide product whose
tensor key shares the ciphertexts' base2k and whose shapes the kernels
take, the fused pair of `backends/fused.py` (one `tensor_product` and one
`fused_product_small64` launch on the card); otherwise the unfused data
flow (NTT and VMP kernels on the card).  The two routes give equal results.
CKKS `mul` (`ckks/ops.py`) relinearizes with its own landing shift, as the
JAX package's does.
"""

from __future__ import annotations

import torch

from poulpy_tpu_torch.backends.fused import (
    fused_glwe_product,
    fused_tensor_product,
    product_fits,
    tensor_fits,
)
from poulpy_tpu_torch.backends.fused_sl import fused_glwe_product_sl
from poulpy_tpu_torch.backends.mxu_product import mxu_route
from poulpy_tpu_torch.core.keyswitching import gglwe_product_dft
from poulpy_tpu_torch.core.layouts import GLWECiphertext, GLWEPlaintext, glwe_size
from poulpy_tpu_torch.core.prepared import GLWETensorKeyPrepared
from poulpy_tpu_torch.hal import dft
from poulpy_tpu_torch.hal.module import Module
from poulpy_tpu_torch.hal.normalization import vec_znx_normalize, vec_znx_normalize_full
from poulpy_tpu_torch.hal.vec_znx import (
    vec_znx_add,
    vec_znx_mul_xp_minus_one,
    vec_znx_rotate,
    vec_znx_sub,
)
from poulpy_tpu_torch.hal.wide import wadd


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


def glwe_negate(a: GLWECiphertext) -> GLWECiphertext:
    return a.replace(data=-a.data)


def _set_body(a: GLWECiphertext, body) -> GLWECiphertext:
    data = a.data.clone()
    data[..., 0, :, :] = body
    return a.replace(data=data)


def glwe_add_plain(a: GLWECiphertext, pt: GLWEPlaintext) -> GLWECiphertext:
    if a.base2k != pt.base2k:
        raise ValueError("align base2k first")
    return _set_body(a, vec_znx_add(a.data[..., 0, :, :], pt.data, res_size=a.size))


def glwe_sub_plain(a: GLWECiphertext, pt: GLWEPlaintext) -> GLWECiphertext:
    if a.base2k != pt.base2k:
        raise ValueError("align base2k first")
    return _set_body(a, vec_znx_sub(a.data[..., 0, :, :], pt.data, res_size=a.size))


def glwe_rotate(p, a: GLWECiphertext) -> GLWECiphertext:
    """ct · X^p; `p` may be batched."""
    return a.replace(data=vec_znx_rotate(p, a.data))


def ggsw_rotate(p, a):
    """GGSW · X^p: every (row, column) sub-GLWE rotated, which multiplies the
    GGSW plaintext by X^p; `p` may be batched."""
    return a.replace(data=vec_znx_rotate(p, a.data))


def glwe_mul_xp_minus_one(p, a: GLWECiphertext) -> GLWECiphertext:
    """(X^p − 1)·ct, the CGGI accumulator update."""
    return a.replace(data=vec_znx_mul_xp_minus_one(p, a.data))


def glwe_lsh(k_shift: int, a: GLWECiphertext) -> GLWECiphertext:
    """ct · 2^{k_shift} (the CKKS rescale primitive)."""
    return a.replace(data=vec_znx_normalize_full(a.size, a.base2k, k_shift, a.data, a.base2k))


def glwe_rsh(k_shift: int, a: GLWECiphertext) -> GLWECiphertext:
    return a.replace(data=vec_znx_normalize_full(a.size, a.base2k, -k_shift, a.data, a.base2k))


def glwe_lsh_add(k_shift: int, a: GLWECiphertext, b: GLWECiphertext) -> GLWECiphertext:
    """a·2^k + b."""
    return glwe_add(glwe_lsh(k_shift, a), b)


def glwe_lsh_sub(k_shift: int, a: GLWECiphertext, b: GLWECiphertext) -> GLWECiphertext:
    """a·2^k − b."""
    return glwe_sub(glwe_lsh(k_shift, a), b)


def glwe_normalize_inplace(a: GLWECiphertext) -> GLWECiphertext:
    return a.replace(data=vec_znx_normalize(a.base2k, a.data))


def glwe_mul_scalar(c: int, a: GLWECiphertext) -> GLWECiphertext:
    """Multiply by a small integer constant, renormalized."""
    return a.replace(data=vec_znx_normalize(a.base2k, a.data * c))


def glwe_mul_plain(module: Module, a: GLWECiphertext, pt: GLWEPlaintext,
                   res_size: int | None = None) -> GLWECiphertext:
    """ct × plaintext polynomial through the bivariate convolution; the
    product's torus scale is a.k + pt.k − base2k (the scheme layer lands it)."""
    if a.base2k != pt.base2k:
        raise ValueError("align base2k first")
    base2k = a.base2k
    res_size = a.size if res_size is None else res_size
    prod = dft.cnv_apply(module, dft.cnv_prepare_left(module, a.data),
                         dft.cnv_prepare_right(module, pt.data), a.size + pt.size - 1)
    bits = dft.product_bits(base2k, base2k, module.log_n, min(a.size, pt.size))
    if dft.needs_wide(bits):
        assert bits + 1 < module.basis.modulus.bit_length()
        data = dft.big_normalize_wide(module, res_size, base2k, dft.idft_apply_wide(module, prod),
                                      base2k)
    else:
        data = dft.big_normalize(module, res_size, base2k, dft.idft_apply(module, prod), base2k)
    return GLWECiphertext(data=data, base2k=base2k, k=min(a.k + pt.k, res_size * base2k))


def tensor_product_bits(module: Module, a: GLWECiphertext, b: GLWECiphertext) -> int:
    """Exact-value bound (bits) of one tensor-product convolution limb."""
    return dft.product_bits(a.base2k, b.base2k, module.log_n, 2 * min(a.size, b.size))


def glwe_tensor_product_big(module: Module, a: GLWECiphertext, b: GLWECiphertext, res_size: int,
                            wide: bool = False):
    """Pairwise bivariate convolution of the ciphertext polynomials.

    For rank 1, (a0, a1) ⊗ (b0, b1) gives the big-domain linear terms
    [a0·b0, a0·b1 + a1·b0] and the quadratic term {(0, 0): a1·b1},
    decryptable under (1, s, s²); a general rank gives every symmetric
    product.  `wide` takes the (hi, lo) pair exit of `hal/wide.py`."""
    rank = a.rank
    a_prep = dft.cnv_prepare_left(module, a.data)
    b_prep = dft.cnv_prepare_right(module, b.data)
    idft = dft.idft_apply_wide if wide else dft.idft_apply

    def conv(i, j):
        return dft.cnv_apply(module, a_prep[..., i, :, :, :], b_prep[..., j, :, :, :], res_size)

    out = [conv(0, 0)]
    for i in range(1, rank + 1):
        out.append(dft.dft_add(module, conv(0, i), conv(i, 0)))
    terms = {}
    for i in range(1, rank + 1):
        for j in range(i, rank + 1):
            t = conv(i, j)
            if i != j:
                t = dft.dft_add(module, t, conv(j, i))
            terms[(i - 1, j - 1)] = t
    lin = [idft(module, x) for x in out]
    quad = {k: idft(module, v) for k, v in terms.items()}
    return lin, quad


def glwe_tensor_square_big(module: Module, a: GLWECiphertext, res_size: int, wide: bool = False):
    """The a == b case of `glwe_tensor_product_big`."""
    return glwe_tensor_product_big(module, a, a, res_size, wide=wide)


def glwe_tensor_relinearize(module: Module, a: GLWECiphertext, b: GLWECiphertext,
                            tensor_key: GLWETensorKeyPrepared, res_base2k: int | None = None,
                            res_k: int | None = None, route: str = "fused") -> GLWECiphertext:
    """ct × ct: the tensor product, each s_i·s_j term keyswitched back to s
    through the tensor key, the linear terms added per column.  `route`
    "fused_sl" takes the fused pair's product in the sublane/lane-split
    layout where `mxu_route` gives it (the JAX package's POULPY_TPU_SL=1,
    the only knob that reaches its relinearize); every other route the
    default kernels.

    The result is the product of the ciphertexts' unreduced values pt + I
    (I the integer part of Σ c_i·s_i), so it carries the mask-wrap cross
    terms I_a·pt_b + I_b·pt_a above pt_a·pt_b; CKKS `mul` is the consumer
    that lands the product below them."""
    if a.base2k != b.base2k:
        raise ValueError("align base2k first")
    base2k = a.base2k
    res_base2k = base2k if res_base2k is None else res_base2k
    res_k = min(a.k + b.k, a.size * base2k + b.size * base2k) if res_k is None else res_k
    rank = a.rank
    conv_size = a.size + b.size - 1
    any_key = next(iter(tensor_key.keys.values()))
    bits = max(tensor_product_bits(module, a, b),
               dft.product_bits(any_key.base2k, any_key.base2k, module.log_n,
                                any_key.dnum * rank * (rank + 1)))
    wide = dft.needs_wide(bits)
    if wide:
        assert bits + 1 < module.basis.modulus.bit_length()
    res_size = glwe_size(res_base2k, res_k)

    if not wide and rank == 1:
        key1 = tensor_key.keys[(0, 0)]
        dnum, psize = key1.dnum * key1.dsize, key1.pmat.shape[3]
        if (key1.base2k == base2k and a.data.shape[:-3] == b.data.shape[:-3]
                and tensor_fits(module, a.size, b.size, conv_size, dnum)
                and product_fits(module, dnum, psize, res_size, max(psize, conv_size))):
            d, lin64 = fused_tensor_product(module, a.data, b.data, conv_size, dnum,
                                            key1.base2k, base2k)
            sl = mxu_route(module, route, psize, res_base2k, key1.dsize) == "fused_sl"
            product = fused_glwe_product_sl if sl else fused_glwe_product
            data = product(module, d[..., None, :, :], key1.pmat, res_size, res_base2k, base2k,
                           dsize=key1.dsize, small64=lin64)
            return GLWECiphertext(data=data, base2k=res_base2k, k=res_k)

    lin, quad = glwe_tensor_product_big(module, a, b, conv_size, wide=wide)
    norm = dft.big_normalize_wide if wide else dft.big_normalize
    acc = None
    for (i, j), big in quad.items():
        key = tensor_key.keys[(min(i, j), max(i, j))]
        d = norm(module, key.dnum * key.dsize, key.base2k, big, base2k)
        part = gglwe_product_dft(module, dft.dft_apply(module, d[..., None, :, :]), key)
        acc = part if acc is None else dft.dft_add(module, acc, part)

    if wide:
        ks_hi, ks_lo = dft.idft_apply_wide(module, acc)
        hi_cols, lo_cols = [], []
        for c in range(rank + 1):
            m = max(ks_hi.shape[-2], lin[c][0].shape[-2])
            ch, ah = dft._align_limbs(ks_hi[..., c, :, :], lin[c][0], m, limb_axis=-2)
            cl, al = dft._align_limbs(ks_lo[..., c, :, :], lin[c][1], m, limb_axis=-2)
            nh, nl = wadd(ch, cl, ah, al)
            hi_cols.append(nh)
            lo_cols.append(nl)
        data = dft.big_normalize_wide(module, res_size, res_base2k,
                                      (torch.stack(hi_cols, dim=-3), torch.stack(lo_cols, dim=-3)),
                                      base2k)
        return GLWECiphertext(data=data, base2k=res_base2k, k=res_k)

    ks_big = dft.idft_apply(module, acc)      # [..., rank+1, size_key, N]
    cols = []
    for c in range(rank + 1):
        m = max(ks_big.shape[-2], lin[c].shape[-2])
        col, add = dft._align_limbs(ks_big[..., c, :, :], lin[c], m, limb_axis=-2)
        cols.append(col + add)
    data = dft.big_normalize(module, res_size, res_base2k, torch.stack(cols, dim=-3), base2k)
    return GLWECiphertext(data=data, base2k=res_base2k, k=res_k)
