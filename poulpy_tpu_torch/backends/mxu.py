"""Four-step digit-plane NTT kernels (`csrc/mxu_ntt.cu`) and their plain
PyTorch twins.

Replace `poulpy_tpu/backends/pallas_mxu.py` (`_fwd_fn` → `_kernel_fwd`,
`_inv_fn` → `_kernel_inv`; entries `pallas_mxu4_forward_limbs` /
`pallas_mxu4_inverse`).  Per row of N = n1·n2 coefficients and per prime:

  forward  x ──nd_in digit planes──► [n1, nd_in·n2] × ua ──assemble, REDC²──►
           A[n1, k2] ──⊙ tf (Montgomery)──4 planes──► [k2, 4·n1] × v0
           ──assemble, REDC²──► y[k2, k1]                      (σ order)
  inverse  y ──4 planes──► [k2, 4·n1] × wa ──► B[k2, n1] ──⊙ ti──4 planes──►
           [n1, 4·n2] × w0 (N^{-1} folded in) ──► x[n2, n1]

The inter-step twiddle is an elementwise Montgomery product, so each step is
one plain product per prime.  The weights hold the reduction-folded digits
of `mxu_ntt.py` (one product gives the NDIG partials of an output), and
balanced digits in [−128, 127] keep every partial below 2^23 in magnitude:
the int8 products with int32 sums of the tensor cores are exact.  The plain
versions do the digit products in float64, exact as well.

The wrappers take the plain version for a CPU tensor and launch the kernel
for a CUDA one; counters `mxu_forward` / `mxu_inverse`.  Each transform has
two designs: "wg" (wgmma, a persistent block per SM; `fwd_layout`,
`wg_layout`, `wg_tables`) for the N of `WG_LOGN`, and
"parent" (mma.sync, 4 rows per block) for the other N; the private
`_forward_launch(design=)`, `_inverse_launch(design=)` and `stage_cycles`
reach either, for the comparisons and the stage clocks of `chip_smoke.py`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from poulpy_tpu_torch.backends import LAUNCHES, _lib
from poulpy_tpu_torch.backends._lib import SMEM_LIMIT
from poulpy_tpu_torch.backends.mxu_ntt import NDIG, _fold_digits
from poulpy_tpu_torch.backends.mxu_ntt4 import (
    _assemble_ax,
    _psi_pows,
    _split,
    digitize_planes,
    sigma_from_hal,
)
from poulpy_tpu_torch.backends.ntt import kernel_tables
from poulpy_tpu_torch.hal.ntt import NttTables, mont_mul
from poulpy_tpu_torch.hal.primes import R

ROWS_PER_BLOCK = 4   # rows of N coefficients per block of the forward and the parent inverse
PAD = 16             # bytes after each int8 operand row in shared memory (csrc/mxu.cuh)
WEIGHTS = ("ua", "v0", "wa", "w0")


def _fold_digits_2d(mat: np.ndarray, p: int) -> np.ndarray:
    """[rows, cols] mod-p → int8 [NDIG·rows, NDIG·cols] with
    out[i·rows + r, d·cols + c] = digit_d(centred(2^{8i}·mat[r, c]·2^60 mod p))."""
    rows, cols = mat.shape
    return _fold_digits(mat, p).reshape(NDIG * rows, NDIG * cols)


@functools.lru_cache(maxsize=None)
def _host_tables_mxu(primes: tuple[int, ...], n: int) -> dict:
    """Numpy weight tables (int8 unless noted), per basis and N:

      ua [P, NDIG·n2, NDIG·n2]  step A       ψ^{N1·n2·(1+2k2)}
      v0 [P, NDIG·n1, NDIG·n1]  step B       ψ^{2·N2·n1·k1}
      tf [P, n1, n2] int32      fwd twiddle  ψ^{n1(1+2k2)}·R
      wa [P, NDIG·n1, NDIG·n1]  inv step A   ψ^{-2·N2·n1·k1}
      w0 [P, NDIG·n2, NDIG·n2]  inv step B   N^{-1}·ψ^{-N1·n2·(1+2k2)}
      ti [P, n1, n2] int32      inv twiddle  ψ^{-n1(1+2k2)}·R
    """
    n1, n2 = _split(n)
    P = len(primes)
    i1 = np.arange(n1, dtype=np.int64)
    i2 = np.arange(n2, dtype=np.int64)
    out = {
        "ua": np.zeros((P, NDIG * n2, NDIG * n2), np.int8),
        "v0": np.zeros((P, NDIG * n1, NDIG * n1), np.int8),
        "wa": np.zeros((P, NDIG * n1, NDIG * n1), np.int8),
        "w0": np.zeros((P, NDIG * n2, NDIG * n2), np.int8),
        "tf": np.zeros((P, n1, n2), np.int32),
        "ti": np.zeros((P, n1, n2), np.int32),
    }
    two_n = 2 * n
    for pi, p in enumerate(primes):
        pw = _psi_pows(p, two_n)
        ninv = pow(n, -1, p)
        out["ua"][pi] = _fold_digits_2d(pw[(n1 * i2[:, None] * (1 + 2 * i2[None, :])) % two_n], p)
        out["v0"][pi] = _fold_digits_2d(pw[(2 * n2 * i1[:, None] * i1[None, :]) % two_n], p)
        out["tf"][pi] = pw[(i1[:, None] * (1 + 2 * i2[None, :])) % two_n] * R % p
        out["wa"][pi] = _fold_digits_2d(pw[(-2 * n2 * i1[:, None] * i1[None, :]) % two_n], p)
        out["w0"][pi] = _fold_digits_2d(
            pw[(-n1 * i2[None, :] * (1 + 2 * i2[:, None])) % two_n] * ninv % p, p)
        out["ti"][pi] = pw[(-i1[:, None] * (1 + 2 * i2[None, :])) % two_n] * R % p
    return out


def fragments(w: np.ndarray) -> np.ndarray:
    """int8 weights [..., K, C] → the operand order of the kernels' int8 MMA
    (m16n8k32, B operand): [..., C/8, K/32, 32 lanes, 8 bytes], where lane
    4·g + t holds column 8·ct + g, rows 32·ks + 4·t + (0..3) in bytes 0–3 and
    rows 32·ks + 16 + 4·t + (0..3) in bytes 4–7, so that each lane loads its
    two fragment registers as one 8-byte word."""
    *lead, K, C = w.shape
    x = w.reshape(*lead, K // 32, 2, 4, 4, C // 8, 8)           # [.., ks, h, t, b, ct, g]
    nl = len(lead)
    x = x.transpose(*range(nl), nl + 4, nl, nl + 5, nl + 2, nl + 1, nl + 3)
    return np.ascontiguousarray(x).reshape(*lead, C // 8, K // 32, 32, 8)


def _cached(t: NttTables, attr: str, build):
    cached = getattr(t, attr, None)
    if cached is None:
        cached = build()
        setattr(t, attr, cached)
    return cached


def plain_tables(t: NttTables) -> dict:
    """The four weight tables as float64 and the twiddles as int64, on the
    tables' device (the plain versions' operands)."""
    def build():
        tabs = _host_tables_mxu(t.basis.primes, t.n)
        out = {k: torch.from_numpy(tabs[k].astype(np.float64)).to(t.device) for k in WEIGHTS}
        out.update({k: torch.from_numpy(tabs[k].astype(np.int64)).to(t.device)
                    for k in ("tf", "ti")})
        return out
    return _cached(t, "_mxu_plain_tables", build)


def device_tables(t: NttTables) -> dict:
    """The four weight tables in fragment order (int8) and the twiddles
    (int32), on the tables' device (the kernels' operands)."""
    def build():
        tabs = _host_tables_mxu(t.basis.primes, t.n)
        out = {k: torch.from_numpy(fragments(tabs[k])).to(t.device) for k in WEIGHTS}
        out.update({k: torch.from_numpy(tabs[k]).to(t.device) for k in ("tf", "ti")})
        return out
    return _cached(t, "_mxu_device_tables", build)


def sigma_index(t: NttTables):
    """`sigma_from_hal` as an int64 index tensor on the tables' device: the
    σ order of a butterfly-NTT operand is `x[..., sigma_index(t)]`."""
    return _cached(t, "_mxu_sigma", lambda: torch.from_numpy(
        sigma_from_hal(t.basis.primes, t.n)).to(t.device))


def _dot(lhs, w):
    """Exact int8 [M, K] × float64 [K, C] → int64 [M, C]."""
    return (lhs.to(torch.float64) @ w).to(torch.int64)


def mxu4_forward_limbs_ref(t: NttTables, x, nd_in: int = NDIG):
    """Plain version of the forward kernel: int limbs [..., N] (wrapped to
    int32, covered by nd_in digit planes) → σ-order residues [..., P, N]
    int32, step by step as `_kernel_fwd`."""
    n, P = t.n, t.basis.nprimes
    n1, n2 = _split(n)
    tabs = plain_tables(t)
    lead = x.shape[:-1]
    xm = x.reshape(-1, n2, n1).to(torch.int32).transpose(1, 2)            # [R, n1, n2]
    rows = xm.shape[0]
    lhs_a = digitize_planes(xm, nd_in, axis=2).reshape(rows * n1, nd_in * n2)
    out = []
    for pi in range(P):
        p, qinv = t.p[pi], t.qinv[pi]
        pa = _dot(lhs_a, tabs["ua"][pi, : nd_in * n2]).reshape(rows, n1, NDIG, n2)
        a = mont_mul(_assemble_ax(pa, 2, p, qinv), tabs["tf"][pi], p, qinv)   # [R, n1, k2]
        lhs_b = digitize_planes(a.transpose(1, 2), NDIG, axis=2).reshape(rows * n2, NDIG * n1)
        pb = _dot(lhs_b, tabs["v0"][pi]).reshape(rows, n2, NDIG, n1)
        out.append(_assemble_ax(pb, 2, p, qinv).reshape(rows, n))           # [R, k2·n1 + k1]
    return torch.stack(out, dim=1).reshape(lead + (P, n))


def mxu4_inverse_ref(t: NttTables, y):
    """Plain version of the inverse kernel: σ-order residues [..., P, N] →
    coefficient residues [..., P, N] int32 (N^{-1} included), step by step
    as `_kernel_inv`."""
    n, P = t.n, t.basis.nprimes
    n1, n2 = _split(n)
    tabs = plain_tables(t)
    lead = y.shape[:-2]
    ym = y.reshape(-1, P, n2, n1)
    rows = ym.shape[0]
    out = []
    for pi in range(P):
        p, qinv = t.p[pi], t.qinv[pi]
        lhs_a = digitize_planes(ym[:, pi], NDIG, axis=2).reshape(rows * n2, NDIG * n1)
        pa = _dot(lhs_a, tabs["wa"][pi]).reshape(rows, n2, NDIG, n1)
        b = _assemble_ax(pa, 2, p, qinv).transpose(1, 2)                     # [R, n1, k2]
        b = mont_mul(b, tabs["ti"][pi], p, qinv)
        lhs_b = digitize_planes(b, NDIG, axis=2).reshape(rows * n1, NDIG * n2)
        pb = _dot(lhs_b, tabs["w0"][pi]).reshape(rows, n1, NDIG, n2)
        out.append(_assemble_ax(pb, 2, p, qinv).transpose(1, 2).reshape(rows, n))
    return torch.stack(out, dim=1).reshape(lead + (P, n))


def transform_smem_bytes(n: int, rows: int = ROWS_PER_BLOCK) -> int:
    """Shared memory of one block of the transform kernels: the int8 operand
    rows of both steps, [rows·n1, NDIG·n2 + PAD] and [rows·n2, NDIG·n1 + PAD]."""
    n1, n2 = _split(n)
    return rows * n1 * (NDIG * n2 + PAD) + rows * n2 * (NDIG * n1 + PAD)


# ---- the inverse's wg design (csrc/mxu_ntt.cu mxu_inverse_wg_kernel) ----

WG_MB = 128              # rows·n2 of one task: the N of step A's wgmma
WG_LOGN = range(9, 14)   # the N of its instances (WgShape<LOGN>)


def wg_layout(n: int, rows: int, P: int, sms: int) -> tuple[int, int, int, int]:
    """(rows per task, tasks, grid, shared bytes) of the wg design: a task is
    one prime of WG_MB / n2 rows, one block per SM walks them."""
    n1, n2 = _split(n)
    per_task = WG_MB // n2
    tasks = -(-rows // per_task) * P
    smem = WG_MB * NDIG * n1 + per_task * n * 4 + per_task * n1 * NDIG * n2
    return per_task, tasks, max(1, min(tasks, sms)), smem


def wg_supported(n: int) -> bool:
    return n.bit_length() - 1 in WG_LOGN


# the split fold where the weights allow it; tests set False to run the int64 fold
WG_SPLIT = True


@functools.lru_cache(maxsize=None)
def _host_wg_tables(primes: tuple[int, ...], n: int, split: bool = True,
                    forward: bool = False) -> dict:
    """Numpy tables of the wg designs, per basis and N.  The inverse's:

      wa    [P, pairs, ksteps, 2, 128, 4] int32  step A's weights as the A
            operand of wgmma: thread 32w + 4g + t of tile h of pair q,
            k-step s, register e + 2·kh holds bytes b = 0..3 of
            wa[32s + 16kh + 4t + b, (2h + e)·n1 + 32q + 8w + g]
      w0    [P, 16·n2²] int8  step B's weights w0 [4·n2 (k), 4·n2 (d·n2 + n2i)]
            as wgmma's B operand in shared memory: column ν = 8·(4·cg + d) + c8
            for output n2i = 8·cg + c8, element (ν, k) at byte (ν // 8)·32·n2
            + (k // 16)·128 + (ν % 8)·16 + k % 16
      tw    [P, n1, n2, 4] int32 (as u32)  step A's output constants: c =
            ψ^{-n1(1+2k2)}·2^{-60} and c·2^s mod p (s of the prime's step-A
            fold), each with its Shoup quotient ⌊·2^32/p⌋
      primes [P, 12] int32 (as u32)  per prime the folds of steps A and B
            (split, K low and high word, 0) and step B's constants (2^{-60},
            its quotient, 2^{s - 60}, its quotient)

    The forward's (`forward`) mirror them: v0 (step B's weights, the [4·n1]²
    register operand) in wa's order, ua (step A's, [4·n2]², in shared memory)
    in w0's order, tw from tf (ψ^{n1(1+2k2)}·2^{-60}), the folds of ua (step
    A, whose epilogue twiddles) and v0 (step B).

    A step's fold is "split" where its weights bound both halves of the
    partials' sum, |P_0 + 2^8·P_1| ≤ A = 257·128·max_col Σ_k |w|, with 2A + p
    ≤ 2^32: the halves + K = p·⌈A/p⌉ are the two words, s = 16; else the
    int64 sum + p·⌈2^48/p⌉ split into words, s = 32 (csrc/mxu_ntt.cu
    fold_words).
    """
    n1, n2 = _split(n)
    P = len(primes)
    host = _host_tables_mxu(primes, n)
    if forward:
        w_step_a, w_step_b, twiddle, names = host["ua"], host["v0"], host["tf"], ("v0", "ua")
        regs, smem = w_step_b, w_step_a
    else:
        w_step_a, w_step_b, twiddle, names = host["wa"], host["w0"], host["ti"], ("wa", "w0")
        regs, smem = w_step_a, w_step_b
    pairs, ksteps = n1 // 32, NDIG * n1 // 32
    q, s, h, w, g, t, kh, e, b = np.ix_(*(np.arange(k) for k in
                                         (pairs, ksteps, 2, 4, 8, 4, 2, 2, 4)))
    k = 32 * s + 16 * kh + 4 * t + b
    col = (2 * h + e) * n1 + 32 * q + 8 * w + g
    frag = regs[:, k, col]                                        # [P, q, s, h, w, g, t, kh, e, b]
    frag = np.ascontiguousarray(frag).reshape(P, pairs, ksteps, 2, 128, 4, 4)
    nb = NDIG * n2
    nu, kk = np.ix_(np.arange(nb), np.arange(nb))
    cols = (nu // 8 % 4) * n2 + 8 * (nu // 32) + nu % 8
    smem_order = np.zeros((P, nb * nb), np.int8)
    at = (nu // 8) * 32 * n2 + (kk // 16) * 128 + (nu % 8) * 16 + kk % 16
    smem_order[:, at] = smem[:, kk, cols]
    tw = np.zeros((P, n1, n2, 4), np.uint32)
    consts = np.zeros((P, 12), np.uint32)

    def fold(p, weights):
        bound = 257 * 128 * int(np.abs(weights.astype(np.int64)).sum(axis=0).max())
        if split and 2 * bound + p <= 2**32:
            return (1, p * -(-bound // p)), 16
        return (0, p * -(-2**48 // p)), 32

    def shoup(c, p):
        return c, c * 2**32 // p

    for pi, p in enumerate(primes):
        (split_a, k_a), s_a = fold(p, w_step_a[pi])
        (split_b, k_b), s_b = fold(p, w_step_b[pi])
        c = twiddle[pi].astype(object) * pow(2, -90, p) % p       # ψ^{...}·R, R = 2^30
        c_hi = c * 2**s_a % p
        for i, v in enumerate((c, c * 2**32 // p, c_hi, c_hi * 2**32 // p)):
            tw[pi, ..., i] = v.astype(np.uint64)
        consts[pi] = (split_a, k_a & 0xFFFFFFFF, k_a >> 32, 0, split_b, k_b & 0xFFFFFFFF,
                      k_b >> 32, 0, *shoup(pow(2, -60, p), p), *shoup(pow(2, s_b - 60, p), p))
    return {names[0]: frag.view(np.int32)[..., 0], names[1]: smem_order,
            "tw": tw.view(np.int32), "primes": consts.view(np.int32)}


def wg_tables(t: NttTables, forward: bool = False) -> dict:
    """The wg design's tables on the tables' device (the folds as WG_SPLIT
    allows), the inverse's or (`forward`) the forward's."""
    def build():
        tabs = _host_wg_tables(t.basis.primes, t.n, WG_SPLIT, forward)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(t.device) for k, v in tabs.items()}
    return _cached(t, f"_mxu_wg_tables_{WG_SPLIT}_{forward}", build)


def _fwd_smem(n1: int, n2: int, mb: int, ua_slots: int) -> int:
    """Shared bytes of the forward's wg design at MB = rows·n2: the staged
    limbs [rows][N] int64, step B's operand [MB][4·n1] and step A's weights
    [4·n2]² of `ua_slots` primes (csrc/mxu_ntt.cu fwd_smem)."""
    return mb // n2 * n1 * n2 * 8 + mb * NDIG * n1 + ua_slots * (NDIG * n2) ** 2


def fwd_layout(n: int, rows: int, P: int, sms: int) -> tuple[int, int, int, int]:
    """(rows per task, tasks, grid, shared bytes) of the forward's wg design:
    a task is one prime of MB / n2 rows (MB = WG_MB, or half of it where
    WG_MB's shared bytes would not fit: N 8192); one block per SM walks them,
    with every prime's step-A weights in shared memory where they fit, else
    one prime's."""
    n1, n2 = _split(n)
    mb = WG_MB if _fwd_smem(n1, n2, WG_MB, 1) <= SMEM_LIMIT else WG_MB // 2
    per_task = mb // n2
    tasks = -(-rows // per_task) * P
    slots = P if _fwd_smem(n1, n2, mb, P) <= SMEM_LIMIT else 1
    return per_task, tasks, max(1, min(tasks, sms)), _fwd_smem(n1, n2, mb, slots)


def _check_split(n: int) -> None:
    n1, n2 = _split(n)
    if n1 % 8 or n2 % 8:
        raise ValueError(f"the transform kernels need n1, n2 multiples of 8 (N ≥ 64), got N {n}")


# the stages of the forward kernels' stage clock per design (csrc/mxu_ntt.cu
# INV_* and FWD_*): the wg design's wait for its staged limbs, step A, and
# step B split into its products and its epilogues (thread 0's warpgroup)
FWD_STAGES = {"parent": ("planes", "step_a", "step_b"),
              "wg": ("input", "step_a", "step_b_products", "step_b_epilogue")}


def _forward_launch(t: NttTables, x, nd_in: int = NDIG, design: str | None = None):
    """(out, launch) for the forward kernel on CUDA limbs x [..., N]:
    launch(timed=False) runs the kernel of `design` ("wg" where
    `wg_supported`, the default there; "parent" elsewhere) into out
    [..., P, N] and returns the stage clock's stamps [blocks,
    len(FWD_STAGES[design])] (timed) or None.  Counts no launch."""
    n, P = t.n, t.basis.nprimes
    _check_split(n)
    if not 1 <= nd_in <= NDIG:
        raise ValueError(f"nd_in must lie in [1, {NDIG}], got {nd_in}")
    if x.shape[-1] != n or x.device != t.device:
        raise ValueError(f"x: expected [..., {n}] on {t.device}, got {tuple(x.shape)} on {x.device}")
    design = design or ("wg" if wg_supported(n) else "parent")
    if design not in ("wg", "parent") or (design == "wg" and not wg_supported(n)):
        raise ValueError(f"design {design!r} does not take N {n}")
    xm = x.reshape(-1, n).to(torch.int64).contiguous()
    _lib.require(xm, "x", torch.int64)
    rows = xm.shape[0]
    out = torch.empty((rows, P, n), dtype=torch.int32, device=x.device)

    def launch(timed: bool = False):
        if design == "wg":
            grid = fwd_layout(n, rows, P, _lib.sm_count(x.device))[2]
        else:
            grid = -(-rows // ROWS_PER_BLOCK)
        stamps = (torch.zeros((grid, len(FWD_STAGES[design])), dtype=torch.int64,
                              device=x.device) if timed else None)
        if not rows:
            return stamps
        _, consts = kernel_tables(t)
        if design == "wg":
            wg = wg_tables(t, forward=True)
            err = _lib.library().poulpy_mxu_forward_wg(
                xm.data_ptr(), out.data_ptr(), wg["v0"].data_ptr(), wg["ua"].data_ptr(),
                wg["tw"].data_ptr(), wg["primes"].data_ptr(), consts.data_ptr(), rows, nd_in, P,
                t.logn, grid, _lib.ptr(stamps), _lib.stream())
            _lib.check(err, "poulpy_mxu_forward_wg")
        else:
            tabs = device_tables(t)
            err = _lib.library().poulpy_mxu_forward(
                xm.data_ptr(), out.data_ptr(), tabs["ua"].data_ptr(), tabs["v0"].data_ptr(),
                tabs["tf"].data_ptr(), consts.data_ptr(), rows, nd_in, P, t.logn, ROWS_PER_BLOCK,
                transform_smem_bytes(n), _lib.ptr(stamps), _lib.stream())
            _lib.check(err, "poulpy_mxu_forward")
        return stamps

    return out.reshape(x.shape[:-1] + (P, n)), launch


def mxu4_forward_limbs(t: NttTables, x, nd_in: int = NDIG):
    """int limbs [..., N] → σ-order residues [..., P, N] int32: plain version
    on CPU tensors, one CUDA launch on CUDA (int64 limbs read and wrapped to
    int32 in the kernel)."""
    if x.device.type == "cpu":
        return mxu4_forward_limbs_ref(t, x, nd_in)
    out, launch = _forward_launch(t, x, nd_in)
    if out.numel():
        launch()
        LAUNCHES["mxu_forward"] += 1
    return out


# the stages of the inverse kernels' stage clock per design (csrc/mxu_ntt.cu
# INV_* and WG_*): the wg design splits step A into its products and its
# epilogues (thread 0's warpgroup)
STAGES = {"parent": ("planes", "step_a", "step_b"),
          "wg": ("planes", "step_a_products", "step_a_epilogue", "step_b")}


def _inverse_launch(t: NttTables, y, design: str | None = None):
    """(out, launch) for the inverse kernel on CUDA residues y [..., P, N]:
    launch(timed=False) runs the kernel of `design` ("wg" where
    `wg_supported`, the default there; "parent" elsewhere) into out
    [..., P, N] and returns the stage clock's stamps [blocks,
    len(STAGES[design])] (timed) or None.  Counts no launch."""
    n, P = t.n, t.basis.nprimes
    _check_split(n)
    if y.dim() < 2 or tuple(y.shape[-2:]) != (P, n) or y.device != t.device:
        raise ValueError(f"y: expected [..., {P}, {n}] on {t.device}, got {tuple(y.shape)} "
                         f"on {y.device}")
    design = design or ("wg" if wg_supported(n) else "parent")
    if design not in ("wg", "parent") or (design == "wg" and not wg_supported(n)):
        raise ValueError(f"design {design!r} does not take N {n}, P {P}")
    ym = y.reshape(-1, P, n).contiguous()
    _lib.require(ym, "y", torch.int32)
    rows = ym.shape[0]
    out = torch.empty_like(ym)

    def launch(timed: bool = False):
        if design == "wg":
            grid = wg_layout(n, rows, P, _lib.sm_count(y.device))[2]
        else:
            grid = -(-rows // ROWS_PER_BLOCK)
        stamps = (torch.zeros((grid, len(STAGES[design])), dtype=torch.int64, device=y.device)
                  if timed else None)
        if not rows:
            return stamps
        _, consts = kernel_tables(t)
        if design == "wg":
            wg = wg_tables(t)
            err = _lib.library().poulpy_mxu_inverse_wg(
                ym.data_ptr(), out.data_ptr(), wg["wa"].data_ptr(), wg["w0"].data_ptr(),
                wg["tw"].data_ptr(), wg["primes"].data_ptr(), consts.data_ptr(), rows, P, t.logn,
                grid, _lib.ptr(stamps), _lib.stream())
            _lib.check(err, "poulpy_mxu_inverse_wg")
        else:
            tabs = device_tables(t)
            err = _lib.library().poulpy_mxu_inverse(
                ym.data_ptr(), out.data_ptr(), tabs["wa"].data_ptr(), tabs["w0"].data_ptr(),
                tabs["ti"].data_ptr(), consts.data_ptr(), rows, P, t.logn, ROWS_PER_BLOCK,
                transform_smem_bytes(n), _lib.ptr(stamps), _lib.stream())
            _lib.check(err, "poulpy_mxu_inverse")
        return stamps

    return out.reshape(y.shape), launch


def stage_cycles(t: NttTables, y, design: str | None = None, forward: bool = False,
                 nd_in: int = NDIG):
    """(out, stamps) of one launch of the inverse kernel's (`forward`: the
    forward kernel's on limbs y with nd_in planes) stage clock instance:
    stamps [blocks, len(STAGES[design])] (FWD_STAGES for the forward) int64,
    the SM cycles each block spent in each stage, from thread 0 at the
    barriers that close them.  For measurement only: no path calls it, and
    it counts no launch."""
    out, launch = _forward_launch(t, y, nd_in, design) if forward else _inverse_launch(t, y, design)
    return out, launch(timed=True)


def mxu4_inverse(t: NttTables, y):
    """σ-order residues [..., P, N] → coefficient residues [..., P, N] int32:
    plain version on CPU tensors, one CUDA launch on CUDA."""
    if y.device.type == "cpu":
        return mxu4_inverse_ref(t, y)
    out, launch = _inverse_launch(t, y)
    if out.numel():
        launch()
        LAUNCHES["mxu_inverse"] += 1
    return out
