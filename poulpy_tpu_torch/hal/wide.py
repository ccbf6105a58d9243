"""Wide (128-bit) big accumulators: the NTT120-family i128 twin.

Twin of `poulpy_tpu/hal/wide.py`.  Parameter sets with base2k up to ~52
(the reference's CKKS demo) have exact convolution values beyond int64, so
their big vectors are (hi, lo) int64 pairs with `lo` the unsigned low 64
bits: value = hi·2^64 + u64(lo), wrapping mod 2^128.  These are the plain
versions of every wide exit; the CUDA kernels of `backends/wide.py` compute
the same with a native `__int128`.

Every shift amount is static.  The branches on it are the JAX code's: a
shift by 64 or more is spelt out, and left shifts go through `_shl_wrap`, so
nothing depends on how a backend treats over-wide or negative shifts.
"""

from __future__ import annotations

import torch

from poulpy_tpu_torch.hal.normalization import _shl_wrap, vec_znx_normalize
from poulpy_tpu_torch.hal.ntt import mont_mul, sub_mod

I64_MIN = -(1 << 63)
MASK64 = (1 << 64) - 1


def i64c(v: int) -> int:
    """Python int → signed value of its low 64 bits."""
    return ((v & MASK64) ^ (1 << 63)) - (1 << 63)


def _ult(a, b):
    """Unsigned a < b of two int64 bit patterns."""
    return (a ^ I64_MIN) < (b ^ I64_MIN)


def wadd(h1, l1, h2, l2):
    lo = l1 + l2
    return h1 + h2 + _ult(lo, l1).to(torch.int64), lo


def wsub(h1, l1, h2, l2):
    return h1 - h2 - _ult(l1, l2).to(torch.int64), l1 - l2


def wfrom_i64(x):
    """Sign-extend an int64 tensor into a pair."""
    return x >> 63, x


def _lsr64(x, s: int):
    """Logical right shift of an int64 bit pattern by static 0 ≤ s < 64."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def wshr_lo64(h, l, s: int):
    """Low 64 bits of the arithmetic 128-bit shift (h:l) >> s, static s ≥ 0."""
    if s == 0:
        return l
    if s < 64:
        return _lsr64(l, s) | _shl_wrap(h, 64 - s)
    if s == 64:
        return h
    if s < 128:
        return h >> (s - 64)
    return h >> 63


def wshl(h, l, s: int):
    """(h:l) << s wrapping mod 2^128, static s ≥ 0."""
    if s == 0:
        return h, l
    if s < 64:
        return _shl_wrap(h, s) | _lsr64(l, 64 - s), _shl_wrap(l, s)
    if s < 128:
        return _shl_wrap(l, s - 64), torch.zeros_like(l)
    return torch.zeros_like(h), torch.zeros_like(l)


def wmul_d_w128(d, w: int):
    """(d · w) mod 2^128 as a pair, for 0 ≤ d < 2^31 and static 0 ≤ w < 2^128:
    a 32-bit digit schoolbook, every partial product d·w_k < 2^63."""
    hi = torch.zeros_like(d)
    lo = torch.zeros_like(d)
    for k in range(4):
        wk = (w >> (32 * k)) & 0xFFFFFFFF
        if wk == 0:
            continue
        ph, plo = wshl(torch.zeros_like(d), d * wk, 32 * k)
        hi, lo = wadd(hi, lo, ph, plo)
    return hi, lo


def garner_lift_wide(t, r):
    """Centred CRT lift of residues `[..., P, N]` into (hi, lo) pairs
    `[..., N]`: `hal.ntt.garner_lift`'s digit recurrence with a 128-bit
    reconstruction, exact whenever |value| < M/2."""
    r = r.to(torch.int64)
    P = r.shape[-2]
    p = t.p
    digits = []
    for i in range(P):
        x = r[..., i, :]
        for j in range(i):
            x = sub_mod(x, mont_mul(digits[j], t.garner_pprod_mont[i, j], p[i], t.qinv[i]), p[i])
        if i > 0:
            x = mont_mul(x, t.garner_inv_mont[i], p[i], t.qinv[i])
        digits.append(x)

    hi = torch.zeros_like(digits[0])
    lo = digits[0]
    prod = 1
    for i in range(1, P):
        prod *= int(t.basis.primes[i - 1])
        ph, plo = wmul_d_w128(digits[i], prod & ((1 << 128) - 1))
        hi, lo = wadd(hi, lo, ph, plo)

    gt = torch.zeros(lo.shape, dtype=torch.bool, device=lo.device)
    eq = torch.ones(lo.shape, dtype=torch.bool, device=lo.device)
    for i in range(P - 1, -1, -1):
        gt = gt | (eq & (digits[i] > t.half_digits[i]))
        eq = eq & (digits[i] == t.half_digits[i])
    m128 = t.basis.modulus & ((1 << 128) - 1)
    zero = torch.zeros_like(lo)
    mh = torch.where(gt, torch.full_like(lo, i64c(m128 >> 64)), zero)
    ml = torch.where(gt, torch.full_like(lo, i64c(m128)), zero)
    return wsub(hi, lo, mh, ml)


def wide_add_small(pair, small, limb_axis: int = -2):
    """pair[..., j, :] += sign-extend(small[..., j, :]) over the common limbs."""
    hi, lo = pair
    upto = min(hi.shape[limb_axis], small.shape[limb_axis])
    sh, sl = wfrom_i64(small.narrow(limb_axis, 0, upto))
    nh, nl = wadd(hi.narrow(limb_axis, 0, upto), lo.narrow(limb_axis, 0, upto), sh, sl)
    rest = hi.shape[limb_axis] - upto
    return (torch.cat([nh, hi.narrow(limb_axis, upto, rest)], dim=limb_axis),
            torch.cat([nl, lo.narrow(limb_axis, upto, rest)], dim=limb_axis))


def wide_big_add(a, b):
    """Pair + pair with limb alignment (the wide vec_znx_big_add)."""
    from poulpy_tpu_torch.hal.dft import _align_limbs

    ah, al = a
    bh, bl = b
    res_size = max(ah.shape[-2], bh.shape[-2])
    ah, bh = _align_limbs(ah, bh, res_size, limb_axis=-2)
    al, bl = _align_limbs(al, bl, res_size, limb_axis=-2)
    return wadd(ah, al, bh, bl)


def vec_znx_normalize_full_wide(res_size: int, res_base2k: int, res_offset: int, pair,
                                a_base2k: int):
    """`hal.normalization.vec_znx_normalize_full` on (hi, lo) pairs: each
    (input limb, output limb) window is the low-`res_base2k`-bit field of an
    arithmetic 128-bit shift, in [0, 2^res_base2k), so the window sums and
    the final carry scan run in plain int64."""
    hi, lo = pair
    a_size = hi.shape[-2]
    kr, ka = res_base2k, a_base2k
    assert kr + (a_size + 1).bit_length() <= 63
    mask_kr = (1 << kr) - 1
    acc = []
    for i in range(res_size):
        w = (i + 1) * kr
        acc_i = None
        for j in range(a_size):
            t = w - ((j + 1) * ka - res_offset)
            if t >= kr:
                continue
            if t > 0:
                piece = _shl_wrap(lo[..., j, :] & ((1 << (kr - t)) - 1), t)
            else:
                piece = wshr_lo64(hi[..., j, :], lo[..., j, :], -t) & mask_kr
            acc_i = piece if acc_i is None else acc_i + piece
        acc.append(torch.zeros_like(lo[..., 0, :]) if acc_i is None else acc_i)
    return vec_znx_normalize(kr, torch.stack(acc, dim=-2))
