"""Base-2^k carry-propagation normalization.

Twin of `poulpy_tpu/hal/normalization.py`: the reference first/middle/final
carry schedule (`vec_znx_normalize`) and the bit-window telescoping
conversion (`vec_znx_normalize_full`), on wrapping int64 tensors
`[..., size, N]` (limb 0 = most significant).

Every shift amount here is static and kept in [0, 63]: a shift of 64 or more
is spelt out (`_shl_wrap` → 0, right shift clamped to 63), so the result does
not depend on how a backend treats over-wide shifts.
"""

from __future__ import annotations

import torch

# torch.bitwise_*_shift rather than `<<` / `>>`: on a DTensor (a batch
# sharded over a mesh, parallel/) the operators by a Python int return their
# input unchanged, the functions shift.
_shl = torch.bitwise_left_shift
_sar = torch.bitwise_right_shift


def get_digit(base2k: int, x):
    """Sign-extended low `base2k` bits of x."""
    sh = 64 - base2k
    return _sar(_shl(x, sh), sh)


def get_carry(base2k: int, x, digit):
    """(x - digit) >> base2k, arithmetic."""
    return _sar(x - digit, base2k)


def first_step(base2k: int, lsh: int, a):
    k = base2k - lsh
    digit = get_digit(k, a)
    carry = get_carry(k, a, digit)
    return _shl(digit, lsh), carry


def middle_step(base2k: int, lsh: int, a, c):
    k = base2k - lsh
    digit = get_digit(k, a)
    carry = get_carry(k, a, digit)
    digit_plus_c = _shl(digit, lsh) + c
    x1 = get_digit(base2k, digit_plus_c)
    return x1, carry + get_carry(base2k, digit_plus_c, x1)


def final_step(base2k: int, lsh: int, a, c):
    """Top limb; the outgoing carry is dropped (mod 1)."""
    k = base2k - lsh
    return get_digit(base2k, _shl(get_digit(k, a), lsh) + c)


def vec_znx_normalize(base2k: int, a, lsh: int = 0):
    """Same-base same-size normalization of `[..., size, N]` with an optional
    fused left shift `lsh`."""
    size = a.shape[-2]
    if size == 1:
        z = torch.zeros_like(a[..., 0, :])
        return final_step(base2k, lsh, a[..., 0, :], z)[..., None, :]
    out = [None] * size
    x, c = first_step(base2k, lsh, a[..., size - 1, :])
    out[size - 1] = x
    for j in range(size - 2, 0, -1):
        x, c = middle_step(base2k, lsh, a[..., j, :], c)
        out[j] = x
    out[0] = final_step(base2k, lsh, a[..., 0, :], c)
    return torch.stack(out, dim=-2)


def _shl_wrap(x, s: int):
    """x << s with wrapping i64 semantics for any s ≥ 0 (s ≥ 64 → 0)."""
    if s >= 64:
        return torch.zeros_like(x)
    return _shl(x, s)


def _window(d, t: int, kr: int):
    """Signed kr-bit window of d·2^t at bit range [0, kr), telescoped:
    (d·2^t) − 2^kr·(d·2^{t−kr}), negative shifts arithmetic (floor)."""
    def ash(x, s: int):
        if s >= 0:
            return _shl_wrap(x, s)
        return _sar(x, min(-s, 63))

    return ash(d, t) - _shl_wrap(ash(d, t - kr), kr)


def vec_znx_normalize_full(res_size: int, res_base2k: int, res_offset: int, a, a_base2k: int):
    """Write `a · 2^{res_offset}` (base 2^a_base2k, `[..., a_size, N]`) as a
    normalized `[..., res_size, N]` vector in base 2^res_base2k: output limb
    i collects the exact bit-window of every input limb j at depth
    ((i)·kr, (i+1)·kr], then one carry scan rebalances the digits."""
    a_size = a.shape[-2]
    kr = res_base2k
    ka = a_base2k
    if res_offset == 0 and kr == ka and res_size == a_size:
        return vec_znx_normalize(kr, a)
    acc = []
    for i in range(res_size):
        w = (i + 1) * kr
        acc_i = None
        for j in range(a_size):
            t = w - ((j + 1) * ka - res_offset)
            piece = _window(a[..., j, :], t, kr)
            acc_i = piece if acc_i is None else acc_i + piece
        acc.append(acc_i)
    return vec_znx_normalize(kr, torch.stack(acc, dim=-2))
