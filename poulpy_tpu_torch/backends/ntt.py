"""Negacyclic NTT: CUDA kernel (`csrc/ntt.cu`) and its plain PyTorch twin.

Replaces `poulpy_tpu/backends/pallas_ntt.py` (`ntt_fn` → `_ntt_kernel` /
`_ntt_kernel_paired`, entries `pallas_ntt_forward` / `pallas_ntt_inverse`).
The plain versions are `ntt_forward_ref` / `ntt_inverse_ref`
(= `hal.ntt.ntt_forward` / `ntt_inverse`).  Residues are `[..., P, N]`
int32 in [0, p), in and out.

The kernel has two designs (`csrc/ntt.cu`): the lazy design, which the
paths run wherever `lazy_layout` gives it (256 ≤ N ≤ 8192: a block of 256
threads per max(1, 2048 / N) rows, two register passes behind one block
barrier, Shoup twiddles), and the parent design (one block per row, one
barrier per stage), which takes every other N and is reached otherwise only
through the keyword-only `design="parent"`, as the reference the lazy design
is held and timed against.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

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
            N^{-1} + ⌊N^{-1}·2^32/p⌋·2^32 mod 2^64: N^{-1}'s Shoup pair), then
            garner_pprod·R [P, P]; W = garner weight, M = modulus.
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
        ninv = [pow(t.n, -1, p) for p in b.primes]
        per[:, 9] = torch.tensor([i64c(w + (((w << 32) // p) << 32))
                                  for w, p in zip(ninv, b.primes)])
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


DESIGNS = ("lazy", "parent")
LAZY_LOGN = range(8, 14)     # the lazy design's N: 256 .. 8192 (csrc/ntt.cu launch_lazy_n)
LAZY_THREADS = 256           # threads per block of the lazy design
LAZY_POINTS = 2048           # points per block of the lazy design below N 2048


@dataclass(frozen=True)
class NttLayout:
    """A launch of `csrc/ntt.cu`: its design, rows (of N points, one prime
    each) per block, threads per block, shared bytes per block, blocks."""

    design: str
    rows_per_block: int
    threads: int
    smem: int
    blocks: int


@functools.lru_cache(maxsize=1024)
def lazy_layout(rows: int, P: int, n: int) -> NttLayout:
    """The layout of a transform of `rows` rows per prime over P primes:
    the lazy design for 256 ≤ N ≤ 8192 (max(1, 2048 / N) rows per block, so
    that the 8 warps of a block each hold eight points of every row in the
    low pass and 2^K / min(2^K, 8) (row, low byte) columns in the high pass;
    4 bytes per point of shared memory), else the parent design (a row per
    block, N/2 threads up to 1024, the row in shared memory)."""
    total = rows * P
    if n.bit_length() - 1 in LAZY_LOGN:
        rpb = max(1, LAZY_POINTS // n)
        return NttLayout("lazy", rpb, LAZY_THREADS, 4 * rpb * n, -(-total // rpb))
    return parent_layout(rows, P, n)


@functools.lru_cache(maxsize=1024)
def parent_layout(rows: int, P: int, n: int) -> NttLayout:
    """The parent design's layout (`csrc/ntt.cu poulpy_ntt`)."""
    return NttLayout("parent", 1, min(n // 2, 1024), 4 * n, rows * P)


def _launch(t: NttTables, x, inverse: bool, design: str = "lazy"):
    """Launch `csrc/ntt.cu` on x [..., P, N]: `design` "lazy" takes
    `lazy_layout`'s design for the shape and counts the launch; "parent"
    forces the parent design and counts nothing."""
    P, n = t.basis.nprimes, t.n
    _lib.require(x, "x", torch.int32)
    if x.dim() < 2 or tuple(x.shape[-2:]) != (P, n):
        raise ValueError(f"x: expected [..., {P}, {n}], got {tuple(x.shape)}")
    if x.device != t.device:
        raise ValueError(f"x on {x.device}, tables on {t.device}")
    if design not in DESIGNS:
        raise ValueError(f"unknown design {design!r}")
    rows = x.numel() // (P * n)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lay = lazy_layout(rows, P, n) if design == "lazy" else parent_layout(rows, P, n)
    tw, consts = kernel_tables(t)
    lib = _lib.library()
    if lay.design == "lazy":
        if x.data_ptr() % 16:
            raise ValueError("x: the lazy NTT reads 16-byte groups; expected a 16-byte aligned tensor")
        err = lib.poulpy_ntt_lazy(x.data_ptr(), out.data_ptr(), shoup_tables(t).data_ptr(),
                                  consts.data_ptr(), rows * P, P, t.logn, int(inverse),
                                  lay.rows_per_block, lay.threads, lay.smem, _lib.stream())
        _lib.check(err, "poulpy_ntt_lazy")
    else:
        err = lib.poulpy_ntt(x.data_ptr(), out.data_ptr(), tw.data_ptr(), consts.data_ptr(),
                             rows, P, t.logn, int(inverse), _lib.stream())
        _lib.check(err, "poulpy_ntt")
    if design == "lazy":
        name = "ntt_inverse" if inverse else "ntt_forward"
        LAUNCHES[name] += 1
        NTT_ROWS[(name, P, n, rows, t.basis.primes[0].bit_length())] += 1
    return out


def ntt_forward(t: NttTables, x, *, design: str = "lazy"):
    """Forward NTT: plain version on CPU tensors, the CUDA kernel on CUDA
    ones (`design` as `_launch`'s)."""
    if x.device.type == "cpu":
        return ntt_forward_ref(t, x)
    return _launch(t, x, False, design)


def ntt_inverse(t: NttTables, x, *, design: str = "lazy"):
    """Inverse NTT (scaled by N^{-1}): plain on CPU, the CUDA kernel on CUDA
    (`design` as `_launch`'s)."""
    if x.device.type == "cpu":
        return ntt_inverse_ref(t, x)
    return _launch(t, x, True, design)
