"""Four-step digit-plane NTT: the plain PyTorch twin of
`poulpy_tpu/backends/mxu_ntt4.py`.

N = N1·N2 (n = n1 + N1·n2, k = k2 + N2·k1, ψ a 2N-th root of unity):

    Y[k] = Σ_{n1} ψ^{n1(1+2k)} · A[k2, n1]              (step B, contract n1)
    A[k2, n1] = Σ_{n2} x[n1+N1·n2]·ψ^{N1·n2·(1+2k2)}    (step A, contract n2)

and the inverse mirrors it with N^{-1} folded in.  Every twiddle is folded
into the weight tensors, and each step is an exact digit-plane product with
the reduction folding of `mxu_ntt.py` (assemble, then ÷2^60 by two
Montgomery reductions).  Outputs are in σ order: position k2·N1 + k1 holds
frequency k2 + N2·k1; `sigma_from_hal` relates it to the butterfly NTT's
order.  The products run in float64, exact (every partial is an integer
below 2^23 in magnitude).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from poulpy_tpu_torch.backends.mxu_ntt import NDIG, _fold_digits, _redc2
from poulpy_tpu_torch.hal.ntt import NttTables, _host_tables
from poulpy_tpu_torch.hal.primes import R, psi_2n


def _split(n: int) -> tuple[int, int]:
    """(N1, N2): N1 the step-B contraction size."""
    n1 = min(128, max(2, n // 8))
    return n1, n // n1


def _wrap32(v):
    """int64 tensor → the int32 value with the same low 32 bits, as int64."""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def digitize_planes(x, nd: int, axis: int = 1):
    """int tensor (int32 range; wider values wrap to int32 as a cast does) →
    int8 balanced base-256 planes stacked at `axis`, with the JAX package's
    int32 arithmetic (each step's difference wraps to int32)."""
    v = _wrap32(x.to(torch.int64))
    planes = []
    for _ in range(nd):
        d = ((v + 128) & 255) - 128
        planes.append(d.to(torch.int8))
        v = _wrap32(v - d) >> 8
    return torch.stack(planes, dim=axis)


def _assemble_ax(partials, axis: int, p, qinv):
    """int partials with a length-NDIG axis at `axis` → canonical residues
    int32 (v = Σ_d P_d·2^{8d}, then ·2^{-60} mod p)."""
    o = torch.movedim(partials, axis, -1).to(torch.int64)
    v = o[..., 0] + (o[..., 1] << 8) + (o[..., 2] << 16) + (o[..., 3] << 24)
    return _redc2(v, p, qinv).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _psi_pows(p: int, two_n: int) -> np.ndarray:
    """[2N] int64: ψ^i mod p."""
    psi = psi_2n(p, two_n)
    out = np.empty(two_n, dtype=np.int64)
    acc = 1
    for i in range(two_n):
        out[i] = acc
        acc = acc * psi % p
    return out


def _digits_folded(mat: np.ndarray, p: int) -> np.ndarray:
    """[rows, cols] mod-p matrix → int8 [rows, NDIG(i), NDIG(d), cols],
    entry digit_d(centred(2^{8i}·mat·2^60 mod p))."""
    return _fold_digits(mat, p).transpose(1, 0, 2, 3)


class Mxu4Weights:
    """Weight tensors of the four-step transforms for one (basis, N), numpy
    int8 in the einsum layouts of the JAX package:

        ua [n2, i, P, dA, k2]   vb [n1, P, j, k2, dB, k1]
        wa [P, k1, i, dA, n1]   wb [P, n1, j, k2, dB, n2]
    """

    def __init__(self, primes: tuple[int, ...], n: int):
        P = len(primes)
        n1, n2 = _split(n)
        self.n, self.n1, self.n2 = n, n1, n2
        D = NDIG
        ua = np.zeros((P, n2, D, D, n2), dtype=np.int8)
        vb = np.zeros((P, n1, D, D, n2, n1), dtype=np.int8)
        wa = np.zeros((P, n1, D, D, n1), dtype=np.int8)
        wb = np.zeros((P, n1, D, D, n2, n2), dtype=np.int8)
        i2 = np.arange(n2, dtype=np.int64)
        i1 = np.arange(n1, dtype=np.int64)
        for pi, p in enumerate(primes):
            pw = _psi_pows(p, 2 * n)
            ninv = pow(n, -1, p)
            e = (n1 * i2[:, None] * (1 + 2 * i2[None, :])) % (2 * n)          # UA[n2, k2]
            ua[pi] = _digits_folded(pw[e], p)
            k = i2[:, None] + n2 * i1[None, :]                                  # VB[n1, (k2, k1)]
            e = (i1[:, None, None] * (1 + 2 * k[None])) % (2 * n)
            vb[pi] = _digits_folded(pw[e].reshape(n1, n2 * n1), p).reshape(n1, D, D, n2, n1)
            e = (-2 * n2 * i1[:, None] * i1[None, :]) % (2 * n)                 # WA[k1, n1]
            wa[pi] = _digits_folded(pw[e], p)
            e = (-(i1[:, None, None] + n1 * i2[None, None, :])                  # WB[n1, (k2, n2)]
                 * (1 + 2 * i2[None, :, None])) % (2 * n)
            m = pw[e].reshape(n1, n2 * n2) * ninv % p
            wb[pi] = _digits_folded(m, p).reshape(n1, D, D, n2, n2)
        self.ua = np.ascontiguousarray(np.transpose(ua, (1, 2, 0, 3, 4)))
        self.vb = np.ascontiguousarray(np.transpose(vb, (1, 0, 2, 4, 3, 5)))
        self.wa = wa
        self.wb = np.ascontiguousarray(np.transpose(wb, (0, 1, 2, 4, 3, 5)))


@functools.lru_cache(maxsize=None)
def _weights(primes: tuple[int, ...], n: int) -> Mxu4Weights:
    return Mxu4Weights(primes, n)


def get_weights4(t: NttTables) -> Mxu4Weights:
    return _weights(t.basis.primes, t.n)


def _np_hal_ntt_probe(p: int, n: int) -> np.ndarray:
    """`hal.ntt.ntt_forward` of the monomial X for one prime, in numpy (the
    same psi tables and stage schedule)."""
    psi_t, _, _ = _host_tables((p,), n)
    src = psi_t[0] * pow(R, -1, p) % p                   # tables are Montgomery
    x = np.zeros(n, dtype=np.int64)
    x[1] = 1
    for s in range(n.bit_length() - 1):
        m, half = 1 << s, n >> (s + 1)
        w = src[m : 2 * m]
        xr = x.reshape(m, 2, half)
        lo, hi = xr[:, 0, :], xr[:, 1, :]
        v = hi * w[:, None] % p
        x = np.stack([(lo + v) % p, (lo - v) % p], axis=1).reshape(n)
    return x


@functools.lru_cache(maxsize=None)
def sigma_from_hal(primes: tuple[int, ...], n: int) -> np.ndarray:
    """π with mxu4_forward(x) == ntt_forward(x)[..., π] for every x.

    hal's output at position q is the evaluation at ψ^{2τ(q)+1}; probing with
    X recovers τ, and π[pos] = τ^{-1}(σ(pos)) with σ(k2·N1 + k1) = k2 + N2·k1.
    Checked on every other prime."""
    n1, n2 = _split(n)
    vals = np.stack([_np_hal_ntt_probe(p, n) for p in primes])
    pw = _psi_pows(primes[0], 2 * n)
    lookup = {int(pw[2 * k + 1]): k for k in range(n)}
    tau = np.array([lookup[int(v)] for v in vals[0]], dtype=np.int64)
    tau_inv = np.empty(n, dtype=np.int64)
    tau_inv[tau] = np.arange(n)
    pos = np.arange(n)
    k_of_pos = (pos % n1) * n2 + pos // n1
    pi = tau_inv[k_of_pos]
    for idx in range(1, len(primes)):
        want = _psi_pows(primes[idx], 2 * n)[(2 * k_of_pos + 1) % (2 * n)]
        np.testing.assert_array_equal(vals[idx][pi], want)
    return pi


def _einsum_i8(spec: str, a, w: np.ndarray):
    """Exact int8 einsum (float64 products) → int64."""
    wt = torch.from_numpy(w).to(device=a.device, dtype=torch.float64)
    return torch.einsum(spec, a.to(torch.float64), wt).to(torch.int64)


def mxu4_ntt_forward_limbs(t: NttTables, x, nd_in: int = NDIG):
    """int limbs [..., N] (int32 range, covered by nd_in digit planes) →
    σ-order residues [..., P, N] int32."""
    w = get_weights4(t)
    n, n1, n2 = w.n, w.n1, w.n2
    P = t.basis.nprimes
    p, qinv = t.p[:, None, None], t.qinv[:, None, None]
    lead = x.shape[:-1]
    d = digitize_planes(x.reshape(-1, n2, n1), nd_in)                    # [R, i, n2, n1]
    pa = _einsum_i8("rimn,mipdk->rpdkn", d, w.ua[:, :nd_in])             # [R, P, dA, k2, n1]
    da = digitize_planes(_assemble_ax(pa, 2, p, qinv), NDIG)             # [R, j, P, k2, n1]
    pb = _einsum_i8("rjpkn,npjkbl->rpkbl", da, w.vb)                     # [R, P, k2, dB, k1]
    return _assemble_ax(pb, -2, p, qinv).reshape(lead + (P, n))


def mxu4_ntt_inverse(t: NttTables, y):
    """σ-order residues [..., P, N] → coefficient residues [..., P, N]
    (canonical, == ntt_inverse of the same values)."""
    w = get_weights4(t)
    n, n1, n2 = w.n, w.n1, w.n2
    P = t.basis.nprimes
    p, qinv = t.p[:, None, None], t.qinv[:, None, None]
    lead = y.shape[:-2]
    d = digitize_planes(y.reshape(-1, P, n2, n1), NDIG)                  # [R, i, P, k2, k1]
    pa = _einsum_i8("ripkl,plidn->rpdkn", d, w.wa)                       # [R, P, dA, k2, n1]
    da = digitize_planes(_assemble_ax(pa, 2, p, qinv), NDIG)             # [R, j, P, k2, n1]
    pb = _einsum_i8("rjpkn,pnjkbm->rpbmn", da, w.wb)                     # [R, P, dB, n2, n1]
    return _assemble_ax(pb, 2, p, qinv).reshape(lead + (P, n))
