"""Exact negacyclic NTT over a CRT prime basis + Montgomery arithmetic.

Twin of `poulpy_tpu/hal/ntt.py` in plain PyTorch int64 ops.  These are the
plain versions that the CUDA kernels of `backends/` are held against:
residue tensors are `[..., P, N]` in standard form `[0, p)`; prepared
operands (twiddles, SVP/VMP matrices) are in Montgomery form `b·R mod p`
with R = 2^30, so one REDC per product returns a standard-form result.
The forward NTT leaves its output in the same bit-reversed order as the
JAX package's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from poulpy_tpu_torch.hal.primes import MASK30, R, PrimeBasis, psi_2n

I64 = torch.int64


# --------------------------------------------------------------------------
# Modular scalar kernels (p / qinv broadcast along trailing dims)
# --------------------------------------------------------------------------

def mont_mul(a, b_mont, p, qinv):
    """REDC_{R=2^30}(a · b_mont) = a·b mod p, for 0 ≤ a, b < p < 2^30.

    Intermediates stay below 2^61 in int64.  The result has `a`'s dtype.
    """
    t = a.to(I64) * b_mont.to(I64)
    m = ((t & MASK30) * qinv) & MASK30
    u = (t + m * p) >> 30
    return torch.where(u >= p, u - p, u).to(a.dtype)


def add_mod(a, b, p):
    p = torch.as_tensor(p, device=a.device).to(a.dtype)  # keep a's dtype
    s = a + b
    return torch.where(s >= p, s - p, s)


def sub_mod(a, b, p):
    p = torch.as_tensor(p, device=a.device).to(a.dtype)
    d = a - b
    return torch.where(d < 0, d + p, d)


def neg_mod(a, p):
    p = torch.as_tensor(p, device=a.device).to(a.dtype)
    return torch.where(a == 0, a, p - a)


def mul_mod(a, b, p):
    """Plain (a·b) mod p for 0 ≤ a, b < p < 2^30 (not Montgomery)."""
    return torch.remainder(a * b, p)


def fold_mod(acc, p, qinv, r2):
    """Non-negative int64 accumulator (< 2^59) → [0, p), division-free:
    one REDC, then ·R²·R^{-1}."""
    m = ((acc & MASK30) * qinv) & MASK30
    u = (acc + m * p) >> 30
    for _ in range(3):
        u = torch.where(u >= p, u - p, u)
    return mont_mul(u, r2, p, qinv)


def reduce_i64(x, p, qinv, r2, t40):
    """Any signed int64 → residue in [0, p), division-free: split at bit 40,
    fold with 2^40 mod p, offset by p·2^29, one REDC, three conditional
    subtracts, then ·R²·R^{-1}."""
    x_lo = x & ((1 << 40) - 1)
    x_hi = x >> 40
    y = x_hi * t40 + x_lo
    yp = y + (p << 29)
    m = ((yp & MASK30) * qinv) & MASK30
    u = (yp + m * p) >> 30
    for _ in range(3):
        u = torch.where(u >= p, u - p, u)
    return mont_mul(u, r2, p, qinv)


# --------------------------------------------------------------------------
# Twiddle tables
# --------------------------------------------------------------------------

def _bit_reverse(i: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (i & 1)
        i >>= 1
    return r


@functools.lru_cache(maxsize=None)
def _host_tables(primes: tuple[int, ...], n: int):
    """Host twiddle tables (numpy int64, Montgomery form):
    psi_brv_mont[P][j] = psi^{bitrev(j)}·R mod p, its inverse-root twin, and
    N^{-1}·R mod p per prime."""
    logn = n.bit_length() - 1
    P = len(primes)
    psi_t = np.zeros((P, n), dtype=np.int64)
    psi_inv_t = np.zeros((P, n), dtype=np.int64)
    n_inv = np.zeros((P,), dtype=np.int64)
    for k, p in enumerate(primes):
        psi = psi_2n(p, 2 * n)
        psi_inv = pow(psi, -1, p)
        for j in range(n):
            b = _bit_reverse(j, logn)
            psi_t[k, j] = pow(psi, b, p) * R % p
            psi_inv_t[k, j] = pow(psi_inv, b, p) * R % p
        n_inv[k] = pow(n, -1, p) * R % p
    return psi_t, psi_inv_t, n_inv


def canonical_device(device) -> torch.device:
    """`device` with its index filled in ("cuda" → "cuda:<current>"), so that
    it compares equal to the device of the tensors made on it.  A CUDA device
    on a machine without one raises: nothing falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but no CUDA device is available; "
                               "pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


class NttTables:
    """Twiddle and CRT tables for one (prime basis, N), resident on `device`."""

    def __init__(self, basis: PrimeBasis, n: int, device="cuda"):
        assert n & (n - 1) == 0 and n >= 4, "N must be a power of two >= 4"
        self.basis = basis
        self.n = n
        self.logn = n.bit_length() - 1
        self.device = canonical_device(device)

        psi, psi_inv, n_inv = _host_tables(basis.primes, n)
        dev = self._upload
        self.psi_brv = dev(psi)              # [P, N] Montgomery
        self.psi_inv_brv = dev(psi_inv)      # [P, N] Montgomery
        self.n_inv = dev(n_inv)              # [P]    Montgomery
        self.p = dev(basis.p_arr)            # [P]
        self.qinv = dev(basis.qinv_arr)
        self.r2 = dev(basis.r2_arr)
        self.two40_mod_p = dev(basis.two40_mod_p_arr)
        self._crt_constants()

    def _upload(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64)).to(self.device)

    def _crt_constants(self) -> None:
        basis, dev = self.basis, self._upload
        self.garner_inv_mont = dev(basis.garner_inv_mont)      # [P]
        self.garner_pprod_mont = dev(basis.garner_pprod_mont)  # [P, P]
        self.garner_weight = dev(basis.garner_weight_u64)      # [P] wrapping
        self.modulus_u64 = dev(basis.modulus_u64)              # scalar
        self.half_digits = dev(basis.half_digits)              # [P]

    def sliced(self, lo: int, hi: int) -> "NttTables":
        """The tables of primes lo … hi − 1 on the same device: the per-prime
        rows (twiddles, N^{-1}, p, the Montgomery and reduction constants)
        are views of these tables' rows, the CRT constants those of the
        sub-basis (a rank's primes under prime sharding, parallel/sharded.py)."""
        t = object.__new__(NttTables)
        t.basis = PrimeBasis(self.basis.primes[lo:hi])
        t.n, t.logn, t.device = self.n, self.logn, self.device
        for name in ("psi_brv", "psi_inv_brv", "n_inv", "p", "qinv", "r2", "two40_mod_p"):
            setattr(t, name, getattr(self, name)[lo:hi])
        t._crt_constants()
        return t


# --------------------------------------------------------------------------
# Forward / inverse negacyclic NTT (plain versions of backends/ntt.py)
# --------------------------------------------------------------------------

def ntt_forward(t: NttTables, x):
    """Negacyclic forward NTT per prime: `[..., P, N]` residues → the same
    shape in bit-reversed frequency order.  Cooley–Tukey with merged psi
    powers: stage m has m blocks of half-length N/(2m); block i uses
    psi^{brv(m+i)}."""
    n = t.n
    p = t.p[:, None, None]
    qinv = t.qinv[:, None, None]
    lead = x.shape[:-2]
    P = x.shape[-2]
    for s in range(t.logn):
        m = 1 << s
        half = n >> (s + 1)
        w = t.psi_brv[:, m : 2 * m, None]      # [P, m, 1]
        xr = x.reshape(lead + (P, m, 2, half))
        lo = xr[..., 0, :]
        hi = xr[..., 1, :]
        v = mont_mul(hi, w, p, qinv)
        nlo = add_mod(lo, v, p)
        nhi = sub_mod(lo, v, p)
        x = torch.stack([nlo, nhi], dim=-2).reshape(lead + (P, n))
    return x


def ntt_inverse(t: NttTables, x):
    """Inverse of `ntt_forward` (Gentleman–Sande, then scale by N^{-1})."""
    n = t.n
    p = t.p[:, None, None]
    qinv = t.qinv[:, None, None]
    lead = x.shape[:-2]
    P = x.shape[-2]
    for s in range(t.logn - 1, -1, -1):
        m = 1 << s
        half = n >> (s + 1)
        w = t.psi_inv_brv[:, m : 2 * m, None]
        xr = x.reshape(lead + (P, m, 2, half))
        lo = xr[..., 0, :]
        hi = xr[..., 1, :]
        u = add_mod(lo, hi, p)
        d = sub_mod(lo, hi, p)
        v = mont_mul(d, w, p, qinv)
        x = torch.stack([u, v], dim=-2).reshape(lead + (P, n))
    return mont_mul(x, t.n_inv[:, None], t.p[:, None], t.qinv[:, None])


# --------------------------------------------------------------------------
# Basis entry / exit
# --------------------------------------------------------------------------

def to_residues(t: NttTables, x):
    """int64 `[..., N]` → standard residues `[..., P, N]`, int32 at rest."""
    return reduce_i64(
        x[..., None, :], t.p[:, None], t.qinv[:, None], t.r2[:, None],
        t.two40_mod_p[:, None],
    ).to(torch.int32)


def to_mont(t: NttTables, r):
    """Standard residues → Montgomery form (for prepared operands)."""
    return mont_mul(r, t.r2[:, None], t.p[:, None], t.qinv[:, None])


def garner_lift(t: NttTables, r):
    """Centred CRT lift: residues `[..., P, N]` → wrapping int64 `[..., N]`.

    Garner's mixed-radix digits d_i in [0, p_i), value Σ d_i·W_i mod 2^64,
    centred by subtracting M when the digit vector exceeds floor(M/2).
    """
    r = r.to(I64)
    P = r.shape[-2]
    p = t.p
    digits = []
    for i in range(P):
        x = r[..., i, :]
        for j in range(i):
            x = sub_mod(
                x, mont_mul(digits[j], t.garner_pprod_mont[i, j], p[i], t.qinv[i]), p[i]
            )
        if i > 0:
            x = mont_mul(x, t.garner_inv_mont[i], p[i], t.qinv[i])
        digits.append(x)
    v = torch.zeros_like(r[..., 0, :])
    for i in range(P):
        v = v + digits[i] * t.garner_weight[i]
    gt = torch.zeros(v.shape, dtype=torch.bool, device=v.device)
    eq = torch.ones(v.shape, dtype=torch.bool, device=v.device)
    for i in range(P - 1, -1, -1):
        gt = gt | (eq & (digits[i] > t.half_digits[i]))
        eq = eq & (digits[i] == t.half_digits[i])
    return v - torch.where(gt, t.modulus_u64, torch.zeros_like(t.modulus_u64))
