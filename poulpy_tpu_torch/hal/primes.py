"""NTT-friendly prime basis generation and host-side CRT constants.

Twin of `poulpy_tpu/hal/primes.py`: the same primes (the largest `count`
primes p < 2^prime_bits with p ≡ 1 mod 2^17), the same Montgomery radix
R = 2^30 and the same Garner constants, so that every residue and every
lifted value equals the JAX package's.  Pure numpy / Python big ints; the
device copies live in `hal.ntt.NttTables`.

Constants that are uint64 by nature (`garner_weight_u64`, `modulus_u64`) are
kept as wrapping int64 (`.view(np.int64)`): torch has no uint64 arithmetic,
and wrapping int64 multiply-add gives the same bits.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

LOG_N_MAX = 16
PSI_ORDER = 1 << (LOG_N_MAX + 1)

R_BITS = 30
R = 1 << R_BITS
MASK30 = R - 1


def _is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


@functools.lru_cache(maxsize=None)
def ntt_primes(count: int, below: int = 1 << 30) -> tuple[int, ...]:
    """Largest `count` primes p < below with p ≡ 1 (mod 2^(LOG_N_MAX+1))."""
    primes = []
    c = (below - 1) // PSI_ORDER
    while len(primes) < count and c > 0:
        p = c * PSI_ORDER + 1
        if _is_prime(p):
            primes.append(p)
        c -= 1
    if len(primes) < count:
        raise ValueError(f"not enough NTT primes below {below}")
    return tuple(primes)


def _find_primitive_root(p: int) -> int:
    """Smallest generator of (Z/p)^*."""
    factors = []
    phi = p - 1
    n = phi
    d = 2
    while d * d <= n:
        if n % d == 0:
            factors.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        factors.append(n)
    g = 2
    while True:
        if all(pow(g, phi // f, p) != 1 for f in factors):
            return g
        g += 1


@functools.lru_cache(maxsize=None)
def psi_2n(p: int, two_n: int) -> int:
    """A primitive (2N)-th root of unity mod p (fixed deterministically)."""
    assert (p - 1) % two_n == 0
    g = _find_primitive_root(p)
    return pow(g, (p - 1) // two_n, p)


@dataclass(frozen=True)
class PrimeBasis:
    """Host-side CRT constants for a fixed prime set (all int64-safe)."""

    primes: tuple[int, ...]

    @property
    def nprimes(self) -> int:
        return len(self.primes)

    @property
    def modulus(self) -> int:
        m = 1
        for p in self.primes:
            m *= p
        return m

    @functools.cached_property
    def p_arr(self) -> np.ndarray:
        return np.array(self.primes, dtype=np.int64)

    @functools.cached_property
    def qinv_arr(self) -> np.ndarray:
        """-p^{-1} mod R per prime (Montgomery REDC constant)."""
        return np.array([(-pow(p, -1, R)) % R for p in self.primes], dtype=np.int64)

    @functools.cached_property
    def r2_arr(self) -> np.ndarray:
        """R^2 mod p per prime (to enter the Montgomery domain)."""
        return np.array([R * R % p for p in self.primes], dtype=np.int64)

    @functools.cached_property
    def two40_mod_p_arr(self) -> np.ndarray:
        """2^40 mod p (first-stage fold of full-range i64 inputs)."""
        return np.array([(1 << 40) % p for p in self.primes], dtype=np.int64)

    @functools.cached_property
    def garner_inv(self) -> np.ndarray:
        """garner_inv[i] = (p_0·…·p_{i-1})^{-1} mod p_i (index 0 unused)."""
        out = np.zeros(self.nprimes, dtype=np.int64)
        prod = 1
        for i, p in enumerate(self.primes):
            if i > 0:
                out[i] = pow(prod % p, -1, p)
            prod *= p
        return out

    @functools.cached_property
    def garner_pprod_mod(self) -> np.ndarray:
        """garner_pprod_mod[i][j] = (p_0·…·p_{j-1}) mod p_i."""
        P = self.nprimes
        out = np.zeros((P, P), dtype=np.int64)
        for i, p in enumerate(self.primes):
            prod = 1
            for j in range(P):
                out[i][j] = prod % p
                prod *= self.primes[j]
        return out

    @functools.cached_property
    def garner_pprod_mont(self) -> np.ndarray:
        """Montgomery form of garner_pprod_mod (division-free Garner)."""
        P = self.nprimes
        out = np.zeros((P, P), dtype=np.int64)
        for i, p in enumerate(self.primes):
            for j in range(P):
                out[i][j] = int(self.garner_pprod_mod[i][j]) * R % p
        return out

    @functools.cached_property
    def garner_inv_mont(self) -> np.ndarray:
        out = np.zeros(self.nprimes, dtype=np.int64)
        for i, p in enumerate(self.primes):
            if i > 0:
                out[i] = int(self.garner_inv[i]) * R % p
        return out

    @functools.cached_property
    def garner_weight_u64(self) -> np.ndarray:
        """W_i = (p_0·…·p_{i-1}) mod 2^64, as wrapping int64."""
        out = np.zeros(self.nprimes, dtype=np.uint64)
        prod = 1
        for i in range(self.nprimes):
            out[i] = prod % (1 << 64)
            prod *= self.primes[i]
        return out.view(np.int64)

    @functools.cached_property
    def modulus_u64(self) -> np.int64:
        """M mod 2^64 as wrapping int64 (for the centering subtraction)."""
        return np.uint64(self.modulus % (1 << 64)).view(np.int64)

    @functools.cached_property
    def half_digits(self) -> np.ndarray:
        """Mixed-radix digits of floor(M/2) in basis (p_0, p_1, …)."""
        h = self.modulus // 2
        out = np.zeros(self.nprimes, dtype=np.int64)
        for i, p in enumerate(self.primes):
            out[i] = h % p
            h //= p
        return out


def required_nprimes(base2k: int, log_n: int, log_rows: int = 7) -> int:
    """Number of ~30-bit primes for exact VMP / convolution accumulation:
    the basis modulus must exceed twice the bound N · 2^(base2k-1) ·
    2^(base2k-1) · 2^log_rows on one accumulated output coefficient."""
    need_bits = 2 * base2k - 2 + log_n + log_rows + 2
    count = 1
    while PrimeBasis(ntt_primes(count)).modulus <= (1 << need_bits):
        count += 1
    return count
