"""Dense digit-plane NTT: the plain PyTorch twin of
`poulpy_tpu/backends/mxu_ntt.py`.

The negacyclic NTT is a fixed linear map y = x·W (mod p), W the exact
[N, N] matrix of `hal.ntt.ntt_forward` (or `ntt_inverse`, N^{-1} folded
in), built by running the same butterfly schedule on the identity basis.
It is evaluated as exact integer products of balanced base-256 digit
planes: the weights hold digit_d(2^{8i}·W·2^60 mod p) ("reduction
folding"), so one product of the input's NDIG planes with the weights gives
NDIG partials P_d with Σ_d P_d·2^{8d} ≡ y·2^60 (mod p), and the epilogue is
an assemble and two Montgomery reductions (÷2^60).  The result is the
canonical residue, equal to the butterfly NTT's.

This path has no kernel and no caller outside the tests; the four-step form
(`mxu_ntt4.py`) is the one the MXU route runs.  Its [4N, 4N] weights are
64 MiB per prime and direction at N 2048, so it suits small N only.

The digit products run in float64, exact: every partial is an integer of
magnitude at most 4N·2^14 < 2^53 (PyTorch has no integer matmul on CUDA).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from poulpy_tpu_torch.hal.ntt import NttTables, _host_tables
from poulpy_tpu_torch.hal.primes import MASK30, R

NDIG = 4          # balanced base-256 digit planes: cover |v| < 2^31
MXU_MIN_N = 512   # the JAX package's threshold of the "mxu" route


def _np_digitize(v: np.ndarray, nd: int) -> np.ndarray:
    """Balanced base-256 digits (int8), digit axis first: [...] → [nd, ...].

    Exact: Σ_d out[d]·2^{8d} == v for |v| < 128·(2^{8nd}−1)/255 + 1."""
    out = np.zeros((nd,) + v.shape, dtype=np.int8)
    v = v.astype(np.int64).copy()
    for d in range(nd):
        dig = ((v + 128) & 255) - 128
        out[d] = dig.astype(np.int8)
        v = (v - dig) >> 8
    assert not v.any(), "value out of digit range"
    return out


def _fold_digits(mat: np.ndarray, p: int) -> np.ndarray:
    """[rows, cols] mod-p matrix → int8 [NDIG(i), rows, NDIG(d), cols], entry
    digit_d(centred(2^{8i}·mat·2^60 mod p)): the reduction-folded weights."""
    base = mat * pow(2, 60, p) % p
    out = []
    for i in range(NDIG):
        c = (base << (8 * i)) % p
        out.append(_np_digitize(np.where(c > p // 2, c - p, c), NDIG))     # [d, rows, cols]
    return np.stack(out).transpose(0, 2, 1, 3)


def _np_ntt_matrix(primes: tuple[int, ...], n: int, inverse: bool) -> np.ndarray:
    """Exact [P, N, N] int64 matrix of ntt_forward / ntt_inverse: out = x @ W,
    from the butterfly schedule of `hal.ntt` run on the identity basis."""
    psi_t, psi_inv_t, n_inv = _host_tables(primes, n)
    logn = n.bit_length() - 1
    w_all = np.zeros((len(primes), n, n), dtype=np.int64)
    for pi, p in enumerate(primes):
        src = (psi_inv_t if inverse else psi_t)[pi] * pow(R, -1, p) % p   # tables are Montgomery
        x = np.eye(n, dtype=np.int64)
        stages = range(logn - 1, -1, -1) if inverse else range(logn)
        for s in stages:
            m, half = 1 << s, n >> (s + 1)
            w = src[m : 2 * m]
            xr = x.reshape(n, m, 2, half)
            lo, hi = xr[:, :, 0, :], xr[:, :, 1, :]
            if inverse:
                pair = [(lo + hi) % p, (lo - hi) % p * w[None, :, None] % p]
            else:
                v = hi * w[None, :, None] % p
                pair = [(lo + v) % p, (lo - v) % p]
            x = np.stack(pair, axis=2).reshape(n, n)
        if inverse:
            x = x * (int(n_inv[pi]) * pow(R, -1, p) % p) % p
        w_all[pi] = x
    return w_all


@functools.lru_cache(maxsize=None)
def _np_weights(primes: tuple[int, ...], n: int, inverse: bool) -> np.ndarray:
    """int8 [P, NDIG·N, NDIG·N]: rows i·N + n, columns d·N + k, entry
    digit_d(centred(2^{8i}·W[n, k]·2^60 mod p))."""
    w = _np_ntt_matrix(primes, n, inverse)
    return np.stack([_fold_digits(w[pi], p).reshape(NDIG * n, NDIG * n)
                     for pi, p in enumerate(primes)])


class MxuWeights:
    """Digitized NTT matrices for one (basis, N), as numpy int8."""

    def __init__(self, primes: tuple[int, ...], n: int):
        self.primes, self.n = primes, n
        P = len(primes)
        fwd = _np_weights(primes, n, False)
        # the forward's input digits are prime-independent: primes side by side in columns
        self.fwd = np.ascontiguousarray(np.transpose(fwd, (1, 0, 2)).reshape(NDIG * n,
                                                                            P * NDIG * n))
        self.inv = _np_weights(primes, n, True)      # [P, 4N, 4N]


@functools.lru_cache(maxsize=None)
def get_weights(primes: tuple[int, ...], n: int) -> MxuWeights:
    return MxuWeights(primes, n)


def digitize(x, nd: int = NDIG):
    """[..., N] int → int8 [..., nd·N] balanced base-256 planes (plane-major)."""
    v = x.to(torch.int64)
    planes = []
    for _ in range(nd):
        d = ((v + 128) & 255) - 128
        planes.append(d.to(torch.int8))
        v = (v - d) >> 8
    return torch.cat(planes, dim=-1)


def _redc2(v, p, qinv):
    """Exact v·2^{-60} mod p in [0, p) for −2^52 < v < 2^52 (int64)."""
    for _ in range(2):
        m = ((v & MASK30) * qinv) & MASK30
        v = (v + m * p) >> 30
    v = torch.where(v < 0, v + p, v)
    return torch.where(v >= p, v - p, v)


def _assemble(partials, p, qinv):
    """int [..., NDIG, N] partials → canonical residues int32."""
    o = partials.to(torch.int64)
    v = o[..., 0, :] + (o[..., 1, :] << 8) + (o[..., 2, :] << 16) + (o[..., 3, :] << 24)
    return _redc2(v, p, qinv).to(torch.int32)


def _dot_i8(a, w: np.ndarray):
    """int8 [R, K] × numpy int8 [K, M] → exact int64 [R, M] (float64 products)."""
    wt = torch.from_numpy(w).to(device=a.device, dtype=torch.float64)
    return (a.to(torch.float64) @ wt).to(torch.int64)


def mxu_ntt_forward_limbs(t: NttTables, x):
    """int64 limbs [..., N] (|x| < 2^31) → ntt_forward(to_residues(x)) [..., P, N]
    int32: the digits of a signed limb stand for its class mod every prime."""
    n, P = t.n, t.basis.nprimes
    w = get_weights(t.basis.primes, n)
    lead = x.shape[:-1]
    out = _dot_i8(digitize(x.reshape(-1, n)), w.fwd).reshape(-1, P, NDIG, n)
    return _assemble(out, t.p[:, None], t.qinv[:, None]).reshape(lead + (P, n))


def _per_prime(t: NttTables, r, mats):
    n, P = t.n, t.basis.nprimes
    lead = r.shape[:-2]
    outs = []
    for pi in range(P):
        o = _dot_i8(digitize(r[..., pi, :].reshape(-1, n)), mats[pi]).reshape(-1, NDIG, n)
        outs.append(_assemble(o, t.p[pi], t.qinv[pi]))
    return torch.stack(outs, dim=-2).reshape(lead + (P, n))


def mxu_ntt_inverse(t: NttTables, r):
    """Residues [..., P, N] → ntt_inverse(r), bit-exact, int32."""
    return _per_prime(t, r, get_weights(t.basis.primes, t.n).inv)


def mxu_ntt_forward(t: NttTables, r):
    """Residues [..., P, N] → ntt_forward(r), bit-exact, int32."""
    n, P = t.n, t.basis.nprimes
    wf = get_weights(t.basis.primes, n).fwd.reshape(NDIG * n, P, NDIG * n)
    return _per_prime(t, r, [wf[:, pi, :] for pi in range(P)])
