"""CKKS slot encoder: a host numpy copy of `poulpy_tpu/ckks/encoder.py`.

Maps m = N/2 complex slots onto a real negacyclic polynomial through the
canonical embedding restricted to the Galois-generator (5^k) orbit of
primitive 2N-th roots of unity; conjugate symmetry makes the coefficients
real.  Host-side numpy f64 FFTs: the encoder runs at data ingress and
egress only, as in the reference.

Slot order (the JAX package's documented contract, kept as is): slot k
sits at the generator-orbit root ζ^{5^k}, indexed directly in orbit order.
The reference stores the same orbit in bit-reversed table order
(poulpy-ckks/src/encoding/reim.rs:31-38); the two layouts differ by that
fixed permutation of slot indices.  Under both, X → X^{5^r} is the cyclic
slot rotation np.roll(slots, -r) and X → X^{-1} slotwise conjugation.
"""

from __future__ import annotations

import numpy as np


class Encoder:
    def __init__(self, n: int):
        assert n & (n - 1) == 0 and n >= 4
        self.n = n
        self.m = n // 2
        two_n = 2 * n
        # slot k evaluates at zeta^{t_k}, t_k = 5^k mod 2N
        t = np.zeros(self.m, dtype=np.int64)
        e = 1
        for k in range(self.m):
            t[k] = e
            e = (e * 5) % two_n
        self.t = t
        # positions in the length-N "odd spectrum": t = 2s+1 -> s
        self.s = (t - 1) // 2
        self.s_conj = ((two_n - t) - 1) // 2  # conjugate root positions
        self.twist = np.exp(1j * np.pi * np.arange(n) / n)

    def encode_rnx(self, z: np.ndarray) -> np.ndarray:
        """Complex slots [..., m] → FLOAT coefficients [..., N], the
        pre-quantization VecRnx form (plaintext/vec.rs:21 — the slot
        encoder produces/consumes this form; quantization happens later in
        vec_rnx_to_znx).  This is the ONE copy of the orbit/twist
        transform; the integer forms compose it with scaling so the
        slot-ordering contract cannot drift between them."""
        z = np.asarray(z, dtype=np.complex128)
        assert z.shape[-1] == self.m
        spec = np.zeros(z.shape[:-1] + (self.n,), dtype=np.complex128)
        spec[..., self.s] = z
        spec[..., self.s_conj] = np.conj(z)
        # p_twisted = fft(spec)/N inverts ev_s = N·ifft(twisted)[s]
        p = np.fft.fft(spec, axis=-1) / self.n
        return np.real(p / self.twist)

    def decode_rnx(self, coeffs: np.ndarray) -> np.ndarray:
        """Float coefficients [..., N] → complex slots [..., m]."""
        p = np.asarray(coeffs, dtype=np.float64) * self.twist
        ev = self.n * np.fft.ifft(p, axis=-1)
        return ev[..., self.s]

    def encode(self, z: np.ndarray, log_delta: int) -> np.ndarray:
        """Complex slots [..., m] → integer coefficients [..., N] scaled by
        2^log_delta."""
        return np.rint(
            self.encode_rnx(z) * float(2**log_delta)
        ).astype(np.int64)

    def decode(self, coeffs: np.ndarray, log_delta: int) -> np.ndarray:
        """Integer coefficients [..., N] → complex slots [..., m]."""
        return self.decode_rnx(coeffs) / float(2**log_delta)
