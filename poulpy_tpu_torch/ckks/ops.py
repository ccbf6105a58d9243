"""Leveled CKKS operations: twin of `poulpy_tpu/ckks/ops.py`.

Meta bookkeeping follows the reference:
  add/sub     → align budgets
  rescale(k)  → glwe_lsh(k); budget −= k
  mul         → budget' = min(b1, b2) − max(d1, d2), delta' = min(d1, d2),
                realized as a bivariate-convolution tensor product and a
                tensor-key relinearization, with a pure bit-shift landing the
                product at the new scale (no modulus switch).

`mul` takes, as the JAX package does:
  - wide (an exact bound over 62 bits), rank 1, key base2k equal to the
    ciphertext's, windows within the kernels' bounds and 2·min(size) ≤ 16:
    the fused wide pair of `backends/wide.py` (one tensor launch, one
    relinearize launch on the card);
  - other wide shapes: the unfused wide data flow (`hal/wide.py` pairs);
  - otherwise the unfused data flow (NTT and VMP kernels on the card).

`rotate`, `rotate_by` and `conjugate` are GLWE automorphisms: a keyswitch
(one `fused_product_small` launch on the card) and a permutation.
"""

from __future__ import annotations

import numpy as np
import torch

from poulpy_tpu_torch.backends.wide import (
    fused_glwe_product_wide,
    fused_tensor_product_wide,
    fused_wide_supported,
    tensor_wide_supported,
)
from poulpy_tpu_torch.ckks.encoder import Encoder
from poulpy_tpu_torch.ckks.layouts import CKKSCiphertext, CKKSMeta, CKKSPlaintext
from poulpy_tpu_torch.core import decryption as core_dec
from poulpy_tpu_torch.core import encryption as core_enc
from poulpy_tpu_torch.core.automorphism import glwe_automorphism
from poulpy_tpu_torch.core.keyswitching import gglwe_product_dft
from poulpy_tpu_torch.core.layouts import GLWECiphertext, GLWEPlaintext, glwe_size
from poulpy_tpu_torch.core.operations import (
    glwe_add,
    glwe_add_plain,
    glwe_lsh,
    glwe_mul_scalar,
    glwe_negate,
    glwe_sub,
    glwe_sub_plain,
    glwe_tensor_product_big,
    tensor_product_bits,
)
from poulpy_tpu_torch.hal import dft, vec_znx
from poulpy_tpu_torch.hal.module import Module
from poulpy_tpu_torch.hal.ntt import canonical_device
from poulpy_tpu_torch.hal.wide import wadd, wfrom_i64
from poulpy_tpu_torch.parallel.auto import dp_shard


class CKKSError(ValueError):
    """Base class of the composition errors (the reference's
    CKKSCompositionError); subclasses mirror its variants."""


class InsufficientHomomorphicCapacity(CKKSError):
    """An operation needs more log_budget than remains."""

    def __init__(self, op: str, available_log_budget: int, required_bits: int):
        self.op = op
        self.available_log_budget = available_log_budget
        self.required_bits = required_bits
        super().__init__(f"{op}: insufficient log_budget {available_log_budget} < {required_bits}")


class PlaintextBase2KMismatch(CKKSError):
    """Operands use different limb radices."""

    def __init__(self, op: str, ct_base2k: int, pt_base2k: int):
        self.op = op
        super().__init__(f"{op}: base2k mismatch ct={ct_base2k} vs {pt_base2k}")


class PlaintextAlignmentImpossible(CKKSError):
    """Metadata cannot be aligned into the destination."""

    def __init__(self, op: str, detail: str):
        self.op = op
        super().__init__(f"{op}: cannot align operands ({detail})")


class MissingAutomorphismKey(CKKSError):
    """A rotation / conjugation key is absent from the key map."""

    def __init__(self, op: str, rotation: int):
        self.op = op
        self.rotation = rotation
        super().__init__(f"{op}: no automorphism key for rotation {rotation}")


def _checked_sub(op: str, budget: int, bits: int) -> int:
    if budget < bits:
        raise InsufficientHomomorphicCapacity(op, budget, bits)
    return budget - bits


def encode(encoder: Encoder, z, base2k: int, k_ct: int, log_delta: int, log_budget: int,
           device="cuda") -> CKKSPlaintext:
    """Slots → CKKSPlaintext limbs at torus precision effective_k, on `device`."""
    meta = CKKSMeta(log_delta=log_delta, log_budget=log_budget)
    coeffs = torch.from_numpy(encoder.encode(np.asarray(z), log_delta))
    data = vec_znx.encode_vec_i64(base2k, meta.effective_k, glwe_size(base2k, k_ct),
                                  coeffs.to(canonical_device(device)))
    return CKKSPlaintext(pt=GLWEPlaintext(data=data, base2k=base2k, k=k_ct), meta=meta)


def decode(encoder: Encoder, pt: CKKSPlaintext) -> np.ndarray:
    coeffs = vec_znx.decode_vec_i64(pt.pt.base2k, pt.meta.effective_k, pt.pt.data)
    return encoder.decode(coeffs.cpu().numpy(), pt.meta.log_delta)


def encrypt_sk(module: Module, pt: CKKSPlaintext, sk_prepared, k_ct: int, source_xe, source_xa,
               **kw) -> CKKSCiphertext:
    glwe = core_enc.glwe_encrypt_sk(module, pt.pt, sk_prepared, pt.pt.base2k, k_ct, source_xe,
                                    source_xa, **kw)
    return CKKSCiphertext(glwe=glwe, meta=pt.meta)


def decrypt(module: Module, ct: CKKSCiphertext, sk_prepared) -> CKKSPlaintext:
    pt = core_dec.glwe_decrypt(module, ct.glwe, sk_prepared, ct.glwe.base2k, ct.meta.effective_k)
    return CKKSPlaintext(pt=pt, meta=ct.meta)


def _aligned(a: CKKSCiphertext, b: CKKSCiphertext, op: str):
    """Equalize budgets by shifting the larger-budget operand up."""
    if a.meta.log_delta != b.meta.log_delta:
        raise PlaintextAlignmentImpossible(op, "log_delta mismatch")
    if a.log_budget > b.log_budget:
        a = rescale(a, a.log_budget - b.log_budget)
    elif b.log_budget > a.log_budget:
        b = rescale(b, b.log_budget - a.log_budget)
    return a, b


def add(a: CKKSCiphertext, b: CKKSCiphertext) -> CKKSCiphertext:
    a, b = _aligned(a, b, "add")
    return CKKSCiphertext(glwe=glwe_add(a.glwe, b.glwe), meta=a.meta)


def sub(a: CKKSCiphertext, b: CKKSCiphertext) -> CKKSCiphertext:
    a, b = _aligned(a, b, "sub")
    return CKKSCiphertext(glwe=glwe_sub(a.glwe, b.glwe), meta=a.meta)


def negate(a: CKKSCiphertext) -> CKKSCiphertext:
    return CKKSCiphertext(glwe=glwe_negate(a.glwe), meta=a.meta)


def _check_plain_meta(op: str, a: CKKSCiphertext, pt: CKKSPlaintext) -> None:
    if pt.meta.effective_k != a.meta.effective_k or pt.meta.log_delta != a.meta.log_delta:
        raise PlaintextAlignmentImpossible(op, "meta mismatch")


def add_plain(a: CKKSCiphertext, pt: CKKSPlaintext) -> CKKSCiphertext:
    _check_plain_meta("add_plain", a, pt)
    return CKKSCiphertext(glwe=glwe_add_plain(a.glwe, pt.pt), meta=a.meta)


def sub_plain(a: CKKSCiphertext, pt: CKKSPlaintext) -> CKKSCiphertext:
    _check_plain_meta("sub_plain", a, pt)
    return CKKSCiphertext(glwe=glwe_sub_plain(a.glwe, pt.pt), meta=a.meta)


def mul_pow2(a: CKKSCiphertext, bits: int) -> CKKSCiphertext:
    """ct · 2^bits: a pure limb shift at fixed (log_delta, log_budget)."""
    return CKKSCiphertext(glwe=glwe_lsh(bits, a.glwe), meta=a.meta)


def div_pow2(a: CKKSCiphertext, bits: int) -> CKKSCiphertext:
    """ct / 2^bits: no data movement, the scale is re-declared
    (log_delta += bits, log_budget −= bits)."""
    budget = _checked_sub("div_pow2", a.log_budget, bits)
    return CKKSCiphertext(glwe=a.glwe,
                          meta=CKKSMeta(log_delta=a.meta.log_delta + bits, log_budget=budget))


def rescale(a: CKKSCiphertext, k: int) -> CKKSCiphertext:
    """ct·2^k with budget −= k (a pure bit shift)."""
    budget = _checked_sub("rescale", a.log_budget, k)
    return CKKSCiphertext(glwe=glwe_lsh(k, a.glwe),
                          meta=CKKSMeta(log_delta=a.meta.log_delta, log_budget=budget))


def _truncate_to_eff(data, base2k: int, eff_k: int):
    """Cut a limb tensor [..., size, N] to exactly eff_k bits of torus
    precision: keep ceil(eff_k/base2k) limbs and mask the bottom limb's low
    bits.  Load-bearing for ct × ct: with operands exact multiples of
    2^-eff_k, every mask-wrap cross term becomes an integer under the landing
    shift and wraps away exactly mod 1."""
    size = -(-eff_k // base2k)
    if size > data.shape[-2]:
        raise ValueError(f"effective_k={eff_k} needs {size} limbs, ct stores {data.shape[-2]}")
    d = data[..., :size, :]
    r = eff_k % base2k
    if r:
        d = d.clone()
        d[..., size - 1, :] &= (-1) << (base2k - r)
    return d


def mul(module: Module, a: CKKSCiphertext, b: CKKSCiphertext, tensor_key,
        res_k: int | None = None) -> CKKSCiphertext:
    """ct × ct with relinearization.  The torus product A·B (the exact
    bivariate convolution of the operands cut to their effective precision)
    is landed at the new scale by one power-of-two offset inside the final
    normalization: the bit-shift rescale that replaces RNS modulus switching.
    On a mesh-attached module both operands' batch runs dp-sharded
    (parallel/auto.py)."""
    if module.mesh is not None:
        return dp_shard(module, lambda a_, b_: mul(module.local, a_, b_, tensor_key, res_k),
                        a, b)
    ga, gb = a.glwe, b.glwe
    if ga.base2k != gb.base2k:
        raise PlaintextBase2KMismatch("mul", ga.base2k, gb.base2k)
    base2k = ga.base2k
    res_k = max(ga.k, gb.k) if res_k is None else res_k
    ga = GLWECiphertext(data=_truncate_to_eff(ga.data, base2k, a.meta.effective_k), base2k=base2k,
                        k=min(ga.k, -(-a.meta.effective_k // base2k) * base2k))
    gb = GLWECiphertext(data=_truncate_to_eff(gb.data, base2k, b.meta.effective_k), base2k=base2k,
                        k=min(gb.k, -(-b.meta.effective_k // base2k) * base2k))

    d1, d2 = a.meta.log_delta, b.meta.log_delta
    res_budget = _checked_sub("mul", min(a.meta.log_budget, b.meta.log_budget), max(d1, d2))
    res_delta = min(d1, d2)
    res_offset = max(0, (res_budget + res_delta) - res_k)
    res_budget = _checked_sub("mul", res_budget, res_offset)
    e_res = res_budget + res_delta
    off_bits = (a.effective_k + b.effective_k) - max(d1, d2) - e_res
    offset = off_bits - base2k
    res_size = glwe_size(base2k, res_k)
    rank = ga.rank
    conv_size = ga.size + gb.size - 1
    meta = CKKSMeta(log_delta=res_delta, log_budget=res_budget)

    any_key = next(iter(tensor_key.keys.values()))
    bits = max(tensor_product_bits(module, ga, gb),
               dft.product_bits(any_key.base2k, any_key.base2k, module.log_n,
                                any_key.dnum * rank * (rank + 1)))
    wide = dft.needs_wide(bits)
    if wide:
        assert bits + 1 < module.basis.modulus.bit_length()

    if wide and rank == 1:
        key1 = tensor_key.keys[(0, 0)]
        psize = key1.pmat.shape[3]
        if (key1.base2k == base2k and fused_wide_supported(psize, base2k, key1.base2k)
                and tensor_wide_supported(conv_size, key1.base2k, base2k)
                and 2 * min(ga.size, gb.size) <= 16):
            d, lin_n = fused_tensor_product_wide(module, ga.data, gb.data, conv_size,
                                                 key1.dnum * key1.dsize, psize, key1.base2k,
                                                 base2k, offset=offset)
            data = fused_glwe_product_wide(module, d[..., None, :, :], key1.pmat, res_size,
                                           base2k, key1.base2k, small=lin_n, dsize=key1.dsize)
            return CKKSCiphertext(glwe=GLWECiphertext(data=data, base2k=base2k, k=res_k),
                                  meta=meta)

    norm = dft.big_normalize_wide if wide else dft.big_normalize
    lin, quad = glwe_tensor_product_big(module, ga, gb, conv_size, wide=wide)

    # relinearize the quadratic terms, the landing offset applied inside the
    # digit normalization (the keyswitch is linear, so the shift goes first
    # to keep precision)
    acc = None
    for (i, j), big in quad.items():
        key = tensor_key.keys[(min(i, j), max(i, j))]
        d = norm(module, key.dnum * key.dsize, key.base2k, big, base2k, res_offset=offset)
        part = gglwe_product_dft(module, dft.dft_apply(module, d[..., None, :, :]), key)
        acc = part if acc is None else dft.dft_add(module, acc, part)

    if wide:
        ks_hi, ks_lo = dft.idft_apply_wide(module, acc)
        lin_shifted = [norm(module, ks_hi.shape[-2], base2k, t, base2k, res_offset=offset)
                       for t in lin]
        hi_cols, lo_cols = [], []
        for c in range(rank + 1):
            nh, nl = wadd(ks_hi[..., c, :, :], ks_lo[..., c, :, :], *wfrom_i64(lin_shifted[c]))
            hi_cols.append(nh)
            lo_cols.append(nl)
        data = dft.big_normalize_wide(module, res_size, base2k,
                                      (torch.stack(hi_cols, dim=-3), torch.stack(lo_cols, dim=-3)),
                                      base2k)
        return CKKSCiphertext(glwe=GLWECiphertext(data=data, base2k=base2k, k=res_k), meta=meta)

    ks_big = dft.idft_apply(module, acc)
    lin_shifted = [dft.big_normalize(module, ks_big.shape[-2], base2k, t, base2k,
                                     res_offset=offset) for t in lin]
    cols = []
    for c in range(rank + 1):
        col, add_t = ks_big[..., c, :, :], lin_shifted[c]
        m_size = max(col.shape[-2], add_t.shape[-2])
        col, add_t = dft._align_limbs(col, add_t, m_size, limb_axis=-2)
        cols.append(col + add_t)
    data = dft.big_normalize(module, res_size, base2k, torch.stack(cols, dim=-3), base2k)
    return CKKSCiphertext(glwe=GLWECiphertext(data=data, base2k=base2k, k=res_k), meta=meta)


def mul_plain(module: Module, a: CKKSCiphertext, pt: CKKSPlaintext) -> CKKSCiphertext:
    """ct × pt: budget' = b_a − d_pt, delta' = d_a (the plaintext's scale is
    divided out)."""
    ga = a.glwe
    if ga.base2k != pt.pt.base2k:
        raise PlaintextBase2KMismatch("mul_plain", ga.base2k, pt.pt.base2k)
    base2k = ga.base2k
    res_budget = _checked_sub("mul_plain", a.log_budget, pt.meta.log_delta)
    res_delta = a.meta.log_delta
    e_res = res_budget + res_delta
    off_bits = (a.effective_k + pt.meta.effective_k) - pt.meta.log_delta - e_res

    ct_data = _truncate_to_eff(ga.data, base2k, a.meta.effective_k)
    pt_data = _truncate_to_eff(pt.pt.data, base2k, pt.meta.effective_k)
    pt_prep = dft.cnv_prepare_right(module, pt_data)
    ct_prep = dft.cnv_prepare_left(module, ct_data)
    prod = dft.cnv_apply(module, ct_prep, pt_prep, ct_data.shape[-2] + pt_data.shape[-2] - 1)
    bits = dft.product_bits(base2k, base2k, module.log_n, min(ga.size, pt.pt.size))
    if dft.needs_wide(bits):
        assert bits + 1 < module.basis.modulus.bit_length()
        data = dft.big_normalize_wide(module, ga.size, base2k, dft.idft_apply_wide(module, prod),
                                      base2k, res_offset=off_bits - base2k)
    else:
        data = dft.big_normalize(module, ga.size, base2k, dft.idft_apply(module, prod), base2k,
                                 res_offset=off_bits - base2k)
    return CKKSCiphertext(glwe=GLWECiphertext(data=data, base2k=base2k, k=ga.k),
                          meta=CKKSMeta(log_delta=res_delta, log_budget=res_budget))


def rotate(module: Module, a: CKKSCiphertext, auto_key, steps_unused: int = 0) -> CKKSCiphertext:
    """Slot rotation: the automorphism X → X^{5^r} of the key's Galois
    element 5^r rotates the slots by r."""
    glwe = glwe_automorphism(module, a.glwe, auto_key, a.glwe.base2k, a.glwe.k)
    return CKKSCiphertext(glwe=glwe, meta=a.meta)


def rotate_by(module: Module, a: CKKSCiphertext, key_map: dict, r: int) -> CKKSCiphertext:
    """Slot rotation by `r` with a key map {r: automorphism key}; raises
    MissingAutomorphismKey when `r` has no key."""
    if r not in key_map:
        raise MissingAutomorphismKey("rotate", r)
    return rotate(module, a, key_map[r])


def conjugate(module: Module, a: CKKSCiphertext, auto_key) -> CKKSCiphertext:
    """Complex conjugation of the slots: the automorphism X → X^{-1}."""
    glwe = glwe_automorphism(module, a.glwe, auto_key, a.glwe.base2k, a.glwe.k)
    return CKKSCiphertext(glwe=glwe, meta=a.meta)


# ---- composite operations ----------------------------------------------------

def add_many(cts: list[CKKSCiphertext]) -> CKKSCiphertext:
    out = cts[0]
    for c in cts[1:]:
        out = add(out, c)
    return out


def mul_add(module, a, b, c, tensor_key):
    """a·b + c."""
    return add(mul(module, a, b, tensor_key), c)


def mul_sub(module, a, b, c, tensor_key):
    """a·b − c."""
    return sub(mul(module, a, b, tensor_key), c)


def dot_product(module, xs, ys, tensor_key):
    """Σ x_i·y_i."""
    return add_many([mul(module, x, y, tensor_key) for x, y in zip(xs, ys)])


def mul_many(module, cts: list[CKKSCiphertext], tensor_key,
             res_k: int | None = None) -> CKKSCiphertext:
    """Balanced binary-tree product of n ciphertexts: depth ⌈log2 n⌉.  The
    products of each subtree are cut to its surviving precision, k_sub =
    min_eff_k − ⌈log2 n_sub⌉·Δ, as the reference allocates its scratch
    GLWEs; feeding a full-k product into the next level would carry its
    mask-wrap cross terms there."""
    if not cts:
        raise ValueError("mul_many: inputs must contain at least one ct")
    if any(c.meta.log_delta != cts[0].meta.log_delta for c in cts):
        raise ValueError("mul_many: all inputs must share log_delta")
    if len(cts) == 1:
        return cts[0]
    if len(cts) == 2:
        return mul(module, cts[0], cts[1], tensor_key, res_k=res_k)
    log_delta = cts[0].meta.log_delta

    def branch(part):
        if len(part) == 1:
            return part[0]
        sub_k = (min(c.meta.effective_k for c in part)
                 - (len(part) - 1).bit_length() * log_delta)
        return mul_many(module, part, tensor_key, res_k=sub_k)

    mid = len(cts) // 2
    return mul(module, branch(cts[:mid]), branch(cts[mid:]), tensor_key, res_k=res_k)


def mul_const(a: CKKSCiphertext, c: float, log_delta_c: int) -> CKKSCiphertext:
    """ct × scalar constant: multiply the limbs by round(c·2^log_delta_c);
    the budget decrement is that scale's landing (effective_k drops by
    log_delta_c), with no extra shift."""
    ci = int(round(c * (1 << log_delta_c)))
    budget = _checked_sub("mul_const", a.log_budget, log_delta_c)
    return CKKSCiphertext(glwe=glwe_mul_scalar(ci, a.glwe),
                          meta=CKKSMeta(log_delta=a.meta.log_delta, log_budget=budget))


def add_const(a: CKKSCiphertext, c: float) -> CKKSCiphertext:
    """ct + scalar constant: c·Δ added to the body's degree-0 coefficient at
    the ciphertext's scale (every slot shifts by c)."""
    ci = int(round(c * (1 << a.meta.log_delta)))
    data = a.glwe.data
    coeffs = torch.zeros(a.glwe.n, dtype=torch.int64, device=data.device)
    coeffs[0] = ci
    pt = vec_znx.encode_vec_i64(a.glwe.base2k, a.meta.effective_k, a.glwe.size, coeffs)
    data = data.clone()
    data[..., 0, :, :] += pt
    return a.replace(glwe=a.glwe.replace(data=data))
