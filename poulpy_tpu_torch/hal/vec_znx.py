"""Limb-vector ("vec_znx") operations and encode/decode.

Twin of `poulpy_tpu/hal/vec_znx.py`.  A vec_znx is `[..., size, N]` int64
(limb 0 = most significant).  Differing-size
operands: sum over the common limbs, copy the longer tail, zero beyond.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from poulpy_tpu_torch.hal import znx
from poulpy_tpu_torch.hal.ntt import canonical_device
from poulpy_tpu_torch.hal.normalization import vec_znx_normalize, vec_znx_normalize_full


def _pad_to(x, res_size: int):
    size = x.shape[-2]
    if size == res_size:
        return x
    if size > res_size:
        return x[..., :res_size, :]
    return F.pad(x, (0, 0, 0, res_size - size))


def vec_znx_add(a, b, res_size: int | None = None):
    if res_size is None:
        res_size = max(a.shape[-2], b.shape[-2])
    return _pad_to(a, res_size) + _pad_to(b, res_size)


def vec_znx_sub(a, b, res_size: int | None = None):
    if res_size is None:
        res_size = max(a.shape[-2], b.shape[-2])
    return _pad_to(a, res_size) - _pad_to(b, res_size)


def vec_znx_negate(a):
    return -a


def vec_znx_rotate(p, a):
    """Multiply every limb by X^p; `p` may be batched (see znx.znx_rotate)."""
    return znx.znx_rotate(p, a)


def vec_znx_automorphism(p: int, a):
    """X → X^p on every limb."""
    return znx.znx_automorphism(p, a)


def vec_znx_mul_xp_minus_one(p, a):
    """(X^p − 1)·a; `p` may be batched as in `vec_znx_rotate`."""
    return znx.znx_rotate(p, a) - a


def vec_znx_switch_ring(n_out: int, a):
    """Every limb to the ring of degree `n_out` (see znx.znx_switch_ring)."""
    return znx.znx_switch_ring(n_out, a)


def vec_znx_lsh(base2k: int, k: int, a, res_size: int | None = None):
    """a · 2^k, renormalized (the CKKS rescale primitive)."""
    if res_size is None:
        res_size = a.shape[-2]
    return vec_znx_normalize_full(res_size, base2k, k, a, base2k)


def vec_znx_rsh(base2k: int, k: int, a, res_size: int | None = None):
    """a · 2^{-k}, renormalized."""
    if res_size is None:
        res_size = a.shape[-2]
    return vec_znx_normalize_full(res_size, base2k, -k, a, base2k)


def vec_znx_normalize_op(base2k: int, a, res_size: int | None = None):
    """Normalize `a`, cut or extended to `res_size` limbs."""
    if res_size is None or res_size == a.shape[-2]:
        return vec_znx_normalize(base2k, a)
    return vec_znx_normalize_full(res_size, base2k, 0, a, base2k)


def vec_znx_split_ring(n_out: int, a):
    """Split a degree-N vector into N/n_out vectors of degree n_out: part i
    = switch_ring(a · X^{-i}).  Returns `[parts, ..., size, n_out]`."""
    n_in = a.shape[-1]
    assert n_out < n_in and n_in % n_out == 0
    parts = [znx.znx_switch_ring(n_out, a if i == 0 else znx.znx_rotate(-i, a))
             for i in range(n_in // n_out)]
    return torch.stack(parts, dim=0)


def vec_znx_merge_rings(parts):
    """Inverse of `vec_znx_split_ring`: embed each part, rotating by X^{-1}
    between parts, then by X^{parts} at the end."""
    k, n_in = parts.shape[0], parts.shape[-1]
    res = torch.zeros(parts.shape[1:-1] + (k * n_in,), dtype=parts.dtype, device=parts.device)
    for i in range(k):
        res = znx.znx_rotate(-1, res + znx.znx_switch_ring(k * n_in, parts[i]))
    return znx.znx_rotate(k, res)


def encode_vec_i64(base2k: int, k: int, size: int, data):
    """Encode integer coefficients at torus precision 2^-k into a normalized
    `size`-limb vector: place data at limb ceil(k/base2k)-1 and normalize
    with the fused shift (base2k - k % base2k) % base2k."""
    data = torch.as_tensor(data, dtype=torch.int64)
    enc_size = -(-k // base2k)
    assert enc_size <= size, f"k={k} needs {enc_size} limbs > size={size}"
    n = data.shape[-1]
    a = torch.zeros(data.shape[:-1] + (size, n), dtype=torch.int64, device=data.device)
    a[..., enc_size - 1, :] = data
    k_rem = (base2k - (k % base2k)) % base2k
    if enc_size == size:
        return vec_znx_normalize(base2k, a, lsh=k_rem)
    head = vec_znx_normalize(base2k, a[..., :enc_size, :], lsh=k_rem)
    return torch.cat([head, a[..., enc_size:, :]], dim=-2)


def _div_round(x, sh: int):
    """x / 2^sh, truncating, then rounded half away from zero."""
    if sh == 0:
        return x
    trunc = torch.where(x >= 0, x >> sh, -((-x) >> sh))
    r = x - (trunc << sh)
    bump = torch.where(2 * torch.abs(r) >= (1 << sh), torch.sign(x), torch.zeros_like(x))
    return trunc + bump


def decode_vec_i64(base2k: int, k: int, a):
    """Decode limbs back to integers at precision k."""
    size = -(-k // base2k)
    rem = base2k - (k % base2k) if k % base2k != 0 else base2k
    data = a[..., 0, :]
    if k < base2k:
        return _div_round(data, base2k - k)
    for i in range(1, size):
        if i == size - 1 and rem != base2k:
            k_rem = base2k - rem
            data = (data << k_rem) + _div_round(a[..., i, :], rem)
        else:
            data = (data << base2k) + a[..., i, :]
    return data


def decode_vec_float(base2k: int, a) -> np.ndarray:
    """Decode to float64 torus values (host numpy): Σ_j a[j]·2^{-(j+1)·base2k}."""
    a = (a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)).astype(np.float64)
    scale = np.array([2.0 ** (-(j + 1) * base2k) for j in range(a.shape[-2])])
    return np.tensordot(np.moveaxis(a, -2, -1), scale, axes=([-1], [0]))


def decode_vec_i128(base2k: int, k: int, a) -> list:
    """Decode at any precision k into Python ints (host side, exact), one
    per coefficient of a `[size, N]` vector."""
    size = -(-k // base2k)
    arr = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    rem = base2k - (k % base2k) if k % base2k != 0 else base2k
    out = []
    for c in range(arr.shape[-1]):
        v = int(arr[..., 0, c])
        for i in range(1, size):
            if i == size - 1 and rem != base2k:
                x = int(arr[..., i, c])
                half = 1 << (rem - 1)
                q = (x + half) >> rem if x >= 0 else -((-x + half) >> rem)
                v = (v << (base2k - rem)) + q
            else:
                v = (v << base2k) + int(arr[..., i, c])
        out.append(v)
    return out


def encode_vec_i128(base2k: int, k: int, size: int, data: list, device="cuda"):
    """Encode Python ints of any size at precision k: balanced base-2^base2k
    digits on the host (exact), then the normalization with the fused shift
    on `device`."""
    n = len(data)
    enc_size = -(-k // base2k)
    digits = np.zeros((size, n), dtype=np.int64)
    half = 1 << (base2k - 1)
    for c, v0 in enumerate(data):
        v = int(v0)
        for j in range(enc_size - 1, -1, -1):
            d = ((v + half) % (1 << base2k)) - half
            digits[j, c] = d
            v = (v - d) >> base2k
    k_rem = (base2k - (k % base2k)) % base2k
    return vec_znx_normalize(base2k, torch.from_numpy(digits).to(canonical_device(device)),
                             lsh=k_rem)
