"""Negacyclic NTT: CUDA kernel (`csrc/ntt.cu`) and its plain PyTorch twin.

Replaces `poulpy_tpu/backends/pallas_ntt.py` (`ntt_fn` → `_ntt_kernel` /
`_ntt_kernel_paired`, entries `pallas_ntt_forward` / `pallas_ntt_inverse`).
The plain versions are `ntt_forward_ref` / `ntt_inverse_ref`
(= `hal.ntt.ntt_forward` / `ntt_inverse`).  Residues are `[..., P, N]`
int32 in [0, p), in and out.
"""

from __future__ import annotations

import math

import torch

from poulpy_tpu_torch.backends import LAUNCHES, NTT_ROWS, _lib
from poulpy_tpu_torch.hal.ntt import NttTables
from poulpy_tpu_torch.hal.ntt import ntt_forward as ntt_forward_ref
from poulpy_tpu_torch.hal.ntt import ntt_inverse as ntt_inverse_ref
from poulpy_tpu_torch.hal.primes import R
from poulpy_tpu_torch.hal.wide import i64c

CONSTS_PER_PRIME = 10


def kernel_tables(t: NttTables):
    """(twiddles, constants) in the layout the kernels read, made once per
    table set on its device:

    tw      int32 [2, P, N]: forward / inverse bit-reversed psi powers (Montgomery);
    consts  int64 [P·10 + P·P]: per prime (p, qinv, N^{-1}·R, garner_inv·R,
            half_digit, W mod 2^64, M mod 2^64, W's bits 64–127, M's bits 64–127,
            0), then garner_pprod·R [P, P]; W = garner weight, M = modulus.
    """
    cached = getattr(t, "_kernel_tables", None)
    if cached is None:
        b = t.basis
        P = b.nprimes
        tw = torch.stack([t.psi_brv, t.psi_inv_brv]).to(torch.int32).contiguous()
        per = torch.zeros(P, CONSTS_PER_PRIME, dtype=torch.int64, device=t.device)
        per[:, 0] = t.p
        per[:, 1] = t.qinv
        per[:, 2] = t.n_inv
        per[:, 3] = t.garner_inv_mont
        per[:, 4] = t.half_digits
        per[:, 5] = t.garner_weight
        per[:, 6] = t.modulus_u64
        weights = [math.prod(b.primes[:i]) for i in range(P)]
        per[:, 7] = torch.tensor([i64c(w >> 64) for w in weights])
        per[:, 8] = i64c(b.modulus >> 64)
        consts = torch.cat([per.reshape(-1), t.garner_pprod_mont.reshape(-1)]).contiguous()
        cached = (tw, consts)
        t._kernel_tables = cached
    return cached


def shoup_tables(t: NttTables):
    """The twiddles of `kernel_tables` in standard form with Shoup's
    quotients, as the lazy design of the butterfly kernels reads them (made
    once per table set): int32 [2, P, N, 2], forward / inverse, each entry
    (w, ⌊w·2^32/p⌋) with w = the Montgomery twiddle · R^{-1} mod p; the
    quotient is a u32 bit pattern."""
    cached = getattr(t, "_shoup_tables", None)
    if cached is None:
        tw, _ = kernel_tables(t)
        primes = t.basis.primes
        rinv = torch.tensor([pow(R, -1, p) for p in primes], dtype=torch.int64,
                            device=t.device)[:, None]
        p = torch.tensor(primes, dtype=torch.int64, device=t.device)[:, None]
        w = tw.to(torch.int64) * rinv % p                  # < 2^60: exact in int64
        wq = (w << 32) // p                                # < 2^32
        wq = torch.where(wq >= 2**31, wq - 2**32, wq)
        cached = torch.stack([w, wq], dim=-1).to(torch.int32).contiguous()
        t._shoup_tables = cached
    return cached


def _launch(t: NttTables, x, inverse: bool):
    P, n = t.basis.nprimes, t.n
    _lib.require(x, "x", torch.int32)
    if x.dim() < 2 or tuple(x.shape[-2:]) != (P, n):
        raise ValueError(f"x: expected [..., {P}, {n}], got {tuple(x.shape)}")
    if x.device != t.device:
        raise ValueError(f"x on {x.device}, tables on {t.device}")
    rows = x.numel() // (P * n)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    tw, consts = kernel_tables(t)
    lib = _lib.library()
    err = lib.poulpy_ntt(x.data_ptr(), out.data_ptr(), tw.data_ptr(), consts.data_ptr(),
                         rows, P, t.logn, int(inverse), _lib.stream())
    _lib.check(err, "poulpy_ntt")
    name = "ntt_inverse" if inverse else "ntt_forward"
    LAUNCHES[name] += 1
    NTT_ROWS[(name, P, n, rows)] += 1
    return out


def ntt_forward(t: NttTables, x):
    """Forward NTT: plain version on CPU tensors, the CUDA kernel on CUDA ones."""
    if x.device.type == "cpu":
        return ntt_forward_ref(t, x)
    return _launch(t, x, inverse=False)


def ntt_inverse(t: NttTables, x):
    """Inverse NTT (scaled by N^{-1}): plain on CPU, the CUDA kernel on CUDA."""
    if x.device.type == "cpu":
        return ntt_inverse_ref(t, x)
    return _launch(t, x, inverse=True)
