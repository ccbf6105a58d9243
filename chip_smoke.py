#!/usr/bin/env python3
"""Smoke run of poulpy_tpu_torch on one CUDA card: each ported path, once.

    python3 chip_smoke.py

Twelve paths of the port run, each with the launch counters set to 0 just
before it and read just after:

- the product path, the headline operation of bench.py: a batched GLWE ×
  GGSW external product at N = 2048, base2k = 17, ciphertext k = 51 (3
  limbs), GGSW k = 68 (dnum 3, rank 1, dsize 1), on get_module(2048, 2, 28);
- the gate path, bench_full.py's gate bootstrap: GateParams(n_lwe=568,
  block_size=8) (N 1024, base2k 17, k_ct 34, BRK k 68 dnum 4, KSK k 51
  dnum 2, get_module(1024, 2, 28)) at batch 1024: block-binary blind
  rotation, GLWE → LWE keyswitch, sample extraction;
- the keyswitch path, bench_full.py's keyswitch: N = 2048,
  get_module(2048, 2) (30-bit primes), ciphertext k 51, key k 68, dnum 3;
- the ckks_wide path, bench_full.py's bench_ckks_mul_wide (the reference's
  CKKS demo parameters): N 2048, base2k 52, ct k 95, tensor key k 156 dnum 2,
  ternary secret of Hamming weight 192, get_module(2048, 5, 28), batch 256:
  ct × ct multiply through the fused wide pair (tensor, relinearize);
- the ckks path, bench_full.py's bench_ckks_mul: base2k 17, ct k 95, key k 95
  dnum 6, get_module(2048, 2, 28), batch 256: multiply (NTT and VMP kernels)
  then rescale(5);
- the relinearize path, on the ckks path's keys and ciphertexts:
  glwe_tensor_relinearize of a ciphertext pair at batch 256 through the fused
  pair (the tensor kernel, then the product kernel with the small64 add);
- the ckks_rotate path, on the same keys and ciphertexts with the
  automorphism keys of galois_element(1) and −1 (base2k 17, k 95, dnum 6):
  CKKS rotate and conjugate at batch 256, each one keyswitch through the
  product kernel with the body add, its output columns split across blocks;
- product_mxu and product_fused_mxu, on the product path's keys and batch:
  the product through `route="mxu"` (four-step forward, VMP, four-step
  inverse, Garner exit: four launches) and `route="fused_mxu"` (one fused
  launch);
- keyswitch_mxu and keyswitch_fused_mxu, on the keyswitch path's keys: the
  keyswitch through the same two routes;
- gate_fused_mxu, on the gate path's keys and batch: the gate bootstrap
  through `route="fused_mxu"` (one fused MXU block step per block of the
  blind rotation, the keyswitch through the fused MXU product).

The seven paths before the MXU paths run as they would without them: the
three set-ups the MXU paths reuse wait on the host meanwhile, and the MXU
kernels' checks (3′, with their float64 plain versions and cuBLAS
yardstick) and the large-N checks come last.  Each set-up is freed after
its last use.

Phases, each printing JSON lines, in this order (3′ last):

  1. device      card name and power limit (nvidia-smi), torch and CUDA versions;
  2. build       nvcc build of the kernels of csrc/ (sm_90a);
  3. kernels     each CUDA kernel against its plain PyTorch version on the same
                 CUDA inputs at its path's shapes, tolerance 0, with its time,
                 the plain version's time and the bound (the least time the
                 card could take: bytes over 3.35 TB/s or modular products
                 over the int32 rate or int8 multiply-adds over the tensor
                 cores' int8 rate, the largest; the wide kernels at the
                 wide CKKS mul's shapes, the tensor kernel and the small64
                 and small products at the relinearize and ckks_rotate
                 paths' shapes, batch 256);
  3′. kernels    the same for the MXU route's kernels, after the last path: at
                 the product path's shapes, the fused MXU product with the
                 body at the keyswitch path's, batch 256, and the block step
                 at the gate path's, batch 1024, each with the time of
                 torch._int_mm on its step-B-shaped digit product as a
                 library yardstick of the product part alone;
  3″. kernels_large_n  each product kernel at a shape whose rows do not fit
                 in shared memory (N 8192 for bench.py's product, N 4096
                 for the CKKS key's keyswitch and relinearization exits,
                 the gate's block steps and the CKKS-wide pair), batch 2–4,
                 against its plain version, tolerance 0, with the layout it
                 takes (it must be the global one) and its time;
  4. verify      product path: stage by stage (NTT → VMP → inverse NTT
                 kernels, plain Garner and normalize) equals the fused kernel
                 at batch 64, and the fused result decrypts to X·m exactly;
  5. bench       product path: bench.py's workload at B = 16384: keygen,
                 encryption, key preparation, 1 + 30 chained products; the
                 checksum sum(|out| mod 65536) must equal 6596757198292, the
                 value the JAX package's runs record (BENCH_r04/r05.json);
  6. gate_verify gate path at batch 64: the block-step kernel's blind
                 rotation equals the plain block path, NAND decrypts to
                 1 − (b1 & b2); the standard path (one fused product per
                 coefficient) at n_lwe 64, batch 64, passes the same check;
  7. gate_bench  gate path at batch 1024: keygen and encryption from
                 bench_full.py's seeds, 1 warm-up NAND whose fingerprint
                 sum(|data| mod 65536) must equal GATE_FINGERPRINT (the JAX
                 package's value on the CPU) and whose bits must be right,
                 then 5 timed chained NANDs out ← NAND(out, c2), ending in a
                 host checksum, decrypted against host-tracked bits;
  8. keyswitch   keyswitch path: the keyswitch kernel equals the plain
                 keyswitch at batch 8 and decrypts exactly; 16 chained
                 single-ciphertext keyswitches; 1 + 10 chained keyswitches at
                 batch 256;
  9. ckks_wide   set-up from bench_full.py's seeds; 1 warm-up mul of its pair
                 (c1, c2) broadcast to batch 256, whose row-0 fingerprint
                 sum(|data| mod 65536) must equal CKKS_WIDE_FINGERPRINT (the
                 JAX package's value on the CPU), every row equal, its decode
                 error against z·z printed; then 5 timed muls, each on a
                 distinct batch of 256 encrypted in set-up, ending in a host
                 checksum; then a profiled mul (torch.profiler, after a
                 warm-up step);
 10. ckks        the same for the non-wide mul + rescale(5) (CKKS_FINGERPRINT);
 11. relinearize 1 warm-up relinearization of the ckks path's pair (c1, c2)
                 broadcast to batch 256: RELIN_FINGERPRINT of row 0, every row
                 equal, the decryption against d0 + d1·s + d2·s² (log2 of the
                 torus error under RELIN_LOG2_ERR_MAX), the kernel route equal
                 to the unfused route at batch 8; then 5 timed
                 relinearizations on the ckks path's distinct batches, ending
                 in a host checksum; then a profiled one;
 12. ckks_rotate automorphism keys from Source 0x05 / 0x06; rotate and
                 conjugate of c1 broadcast to batch 256: ROTATE_FINGERPRINT
                 and CONJUGATE_FINGERPRINT of row 0, every row equal, the
                 decode error against np.roll(z, −1) and conj(z); then 5 timed
                 rotations on distinct batches, ending in a host checksum; then
                 a profiled one;
 13. verify_<route>, bench_<route> (product_mxu, product_fused_mxu): bench.py's
                 MXU A/B gate on phase 4's batch of 64 (the route equals the
                 butterfly fused kernel bit for bit and decrypts to X·m), then
                 phase 5's 1 + 30 chained products at B = 16384 on its keys
                 and batch through the route (checksum 6596757198292), then a
                 profiled product;
 14. keyswitch_<route> (keyswitch_mxu, keyswitch_fused_mxu): on phase 8's
                 keys, the route equals the butterfly route at batch 8 and
                 decrypts exactly; 1 + 10 chained keyswitches at batch 256,
                 whose checksum equals the butterfly route's;
 15. gate_fused_mxu  on phase 6–7's keys: at batch 64 the block path through
                 the route equals its plain MXU block path and the butterfly
                 block path, the standard path (n_lwe 64) through the route
                 equals the butterfly's, NAND truth on both; at batch 1024
                 the warm-up NAND's fingerprint equals GATE_FINGERPRINT, 5
                 timed chained NANDs decrypt to the tracked bits (gates/s
                 beside phase 7's), then a profiled NAND.

Only the five *_mxu paths may launch an MXU kernel.  Then one line
{"kernels": [...]} (launches summed over the paths' runs)
and, last, {"ok": true, "device": {...}}.  Any failure exits non-zero
before that line.  Without a CUDA device, or without the poulpy_tpu_torch
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N, BASE2K, K_CT, K_PT, K_KEY, DNUM = 2048, 17, 51, 34, 68, 3
NPRIMES, PRIME_BITS = 2, 28
BATCH, ITERS, VERIFY_BATCH = 16384, 30, 64
CHECKSUM = 6596757198292
PLAIN_CHUNK = 2048          # batch chunk of the plain versions of the VMP and the fused product

# gate path: bench_full.py bench_gate_bootstrap
GATE_N_LWE, GATE_BLOCK, GATE_BATCH, GATE_ITERS = 568, 8, 1024, 5
GATE_VERIFY_BATCH, STD_N_LWE = 64, 64
# sum(|data| mod 65536) of gate_nand(keys, c1, c2) at bench_full.py's gate
# configuration and seeds, batch 1024, computed by the JAX package on the CPU
# (tests/test_torch_binfhe.py::test_gate_fingerprint_full_config recomputes it)
GATE_FINGERPRINT = 38199110968
# keyswitch path: bench_full.py _keyswitch_setup / bench_keyswitch_*
KS_N, KS_K_KEY, KS_DNUM = 2048, 68, 3
KS_VERIFY_BATCH, KS_CHAIN, KS_REPS, KS_BATCH, KS_ITERS = 8, 16, 5, 256, 10


@dataclass(frozen=True)
class CkksConfig:
    """A CKKS multiply benchmark of bench_full.py: its parameters and seeds."""

    n: int
    nprimes: int
    base2k: int
    k_ct: int
    k_key: int
    log_delta: int
    log_budget: int
    dnum: int
    hw: int | None          # Hamming weight of a ternary_hw secret; None: ternary_prob
    seed: int               # np.random.default_rng seed of the slots
    rescale: int | None     # rescale(k) after the multiply


# bench_full.py bench_ckks_mul_wide and bench_ckks_mul (prime_bits 28 for both)
CKKS_WIDE = CkksConfig(2048, 5, 52, 95, 156, 30, 35, 2, 192, 5, None)
CKKS = CkksConfig(2048, 2, 17, 95, 95, 22, 30, 6, None, 3, 5)
CKKS_BATCH, CKKS_ITERS = 256, 5
# sum(|data| mod 65536) of one multiply (+ rescale) of bench_full.py's pair at
# each configuration, computed by the JAX package on the CPU
# (tests/test_torch_ckks.py::test_ckks_fingerprint_full_config recomputes them)
CKKS_WIDE_FINGERPRINT = 270715177
CKKS_FINGERPRINT = 808555351
# sum(|data| mod 65536) of glwe_tensor_relinearize(c1.glwe, c2.glwe) and of
# rotate(c1) / conjugate(c1) at the ckks configuration, computed by the JAX
# package on the CPU (tests/test_torch_relin.py::
# test_relinearize_and_rotation_fingerprints_full_config recomputes them)
RELIN_FINGERPRINT = 1476054215
ROTATE_FINGERPRINT = 797964655
CONJUGATE_FINGERPRINT = 802332334
# log2 of the torus error of the relinearization against d0 + d1·s + d2·s²:
# the JAX package reads −64.0 on the CPU at this configuration (float64
# rounding of the decode; the keyswitch noise of the k 95 key lies below it)
RELIN_LOG2_ERR_MAX = -50
# the wide mul's landing offset off_bits − base2k = (65 + 65) − 30 − 35 − 52
WIDE_OFFSET = 13

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
# int32 multiply rate of an H100 SXM: 132 SMs × 64 int32 lanes × 1.98 GHz
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int8 multiply-adds of the H100 SXM's tensor cores: 1,979 T dense int8 ops/s
INT8_MACS_PER_S = 1979e12 / 2
# the MXU routes of the product and keyswitch paths (core route keyword)
ROUTES = ("mxu", "fused_mxu")

_FUSED = "poulpy_tpu/backends/pallas_fused.py:951"
_WIDE = "poulpy_tpu/backends/pallas_wide.py"
_FUSED_MXU = "poulpy_tpu/backends/pallas_fused_mxu.py:271"
KERNELS = {
    "ntt_forward": ("poulpy_tpu_torch/csrc/ntt.cu", "poulpy_tpu/backends/pallas_ntt.py:407"),
    "ntt_inverse": ("poulpy_tpu_torch/csrc/ntt.cu", "poulpy_tpu/backends/pallas_ntt.py:407"),
    "vmp": ("poulpy_tpu_torch/csrc/vmp.cu", "poulpy_tpu/backends/pallas_vmp.py:67"),
    "fused_product": ("poulpy_tpu_torch/csrc/fused_product.cu", _FUSED),
    "fused_product_small": ("poulpy_tpu_torch/csrc/fused_product.cu", _FUSED),
    "fused_product_small64": ("poulpy_tpu_torch/csrc/fused_product.cu", _FUSED),
    "br_block_step": ("poulpy_tpu_torch/csrc/br_block_step.cu", _FUSED),
    "tensor_product": ("poulpy_tpu_torch/csrc/tensor_product.cu",
                       "poulpy_tpu/backends/pallas_fused.py:1403"),
    "wide_product": ("poulpy_tpu_torch/csrc/wide_product.cu", f"{_WIDE}:496"),
    "wide_tensor": ("poulpy_tpu_torch/csrc/wide_tensor.cu", f"{_WIDE}:718"),
    "mxu_forward": ("poulpy_tpu_torch/csrc/mxu_ntt.cu", "poulpy_tpu/backends/pallas_mxu.py:268"),
    "mxu_inverse": ("poulpy_tpu_torch/csrc/mxu_ntt.cu", "poulpy_tpu/backends/pallas_mxu.py:311"),
    "garner_exit": ("poulpy_tpu_torch/csrc/garner_exit.cu", "poulpy_tpu/backends/pallas_fused.py:1030"),
    "fused_mxu_product": ("poulpy_tpu_torch/csrc/fused_mxu.cu", _FUSED_MXU),
    "fused_mxu_product_small": ("poulpy_tpu_torch/csrc/fused_mxu.cu", _FUSED_MXU),
    "fused_mxu_br_block_step": ("poulpy_tpu_torch/csrc/fused_mxu.cu", _FUSED_MXU),
}
MXU_KERNELS = ("mxu_forward", "mxu_inverse", "garner_exit", "fused_mxu_product",
               "fused_mxu_product_small", "fused_mxu_br_block_step")
# the kernels each path must launch
PATHS = {
    "product": ("ntt_forward", "ntt_inverse", "vmp", "fused_product"),
    "gate": ("ntt_forward", "fused_product", "fused_product_small", "br_block_step"),
    "keyswitch": ("ntt_forward", "fused_product_small"),
    "ckks_wide": ("wide_tensor", "wide_product"),
    "ckks": ("ntt_forward", "ntt_inverse", "vmp"),
    "relinearize": ("tensor_product", "fused_product_small64"),
    "ckks_rotate": ("ntt_forward", "fused_product_small"),
    "product_mxu": ("fused_product", "mxu_forward", "vmp", "mxu_inverse", "garner_exit"),
    "product_fused_mxu": ("fused_product", "fused_mxu_product"),
    "keyswitch_mxu": ("fused_product_small", "mxu_forward", "vmp", "mxu_inverse",
                      "garner_exit"),
    "keyswitch_fused_mxu": ("fused_product_small", "fused_mxu_product_small"),
    "gate_fused_mxu": ("br_block_step", "fused_product", "fused_mxu_br_block_step",
                       "fused_mxu_product", "fused_mxu_product_small"),
}


def emit(**row):
    print(json.dumps(row), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of `fn()` over `reps` runs after one warm-up, by CUDA events."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def moved(obj, device):
    """`obj` with every tensor in it (through tuples and the port's frozen
    dataclasses) on `device`; anything else as it is."""
    import dataclasses

    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple):
        return tuple(moved(o, device) for o in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: moved(getattr(obj, f.name), device)
                                           for f in dataclasses.fields(obj)})
    return obj


def bound(nbytes: float, ops: float, macs: float = 0) -> dict:
    """The least time the card could take: bytes read once and written once
    over the memory rate, modular products over the int32 multiply rate
    (each needs at least one 32-bit multiply), or int8 multiply-adds over the
    tensor cores' int8 rate, whichever is largest."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / INT32_OPS_PER_S, macs / INT8_MACS_PER_S) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops, int8_macs=macs)


def split(n: int) -> tuple[int, int]:
    """The four-step split (n1, n2) of the MXU transforms."""
    n1 = min(128, max(2, n // 8))
    return n1, n // n1


def mxu_macs(rows: int, P: int, n: int, nd: int = 4) -> int:
    """int8 multiply-adds of the four-step transform of `rows` rows over P
    primes: step A [n1, nd·n2] × [nd·n2, 4·n2] and step B [n2, 4·n1] ×
    [4·n1, 4·n1] (the inverse: the same two shapes with nd 4)."""
    n1, n2 = split(n)
    return rows * P * (n1 * nd * n2 * 4 * n2 + n2 * 16 * n1 * n1)


def int_mm_ms(rows: int, n: int, device) -> float:
    """The library yardstick of the MXU kernels: one torch._int_mm of a
    [rows, 4·n1] int8 operand by a [4·n1, 4·n1] int8 matrix (the step-B digit
    product alone, without the digit planes, the epilogues or the VMP)."""
    import torch

    k = 4 * split(n)[0]
    a = torch.randint(-128, 128, (rows, k), dtype=torch.int8, device=device)
    w = torch.randint(-128, 128, (k, k), dtype=torch.int8, device=device)
    ms = cuda_ms(lambda: torch._int_mm(a, w), 5)
    del a, w
    torch.cuda.empty_cache()
    return ms


def ntt_ops(rows: int, n: int, inverse: bool = False) -> int:
    """Modular products of `rows` NTTs of n points (+ the N^{-1} scale)."""
    return rows * ((n // 2) * (n.bit_length() - 1) + (n if inverse else 0))


def fused_ops(B: int, kk: int, mdim: int, P: int, n: int, block: int = 1) -> int:
    """Modular products of the fused kernels: forward NTT of kk rows, the
    block·kk·mdim VMP, the x-power factor (block steps), inverse NTT of mdim
    rows, per prime and ciphertext (Garner and the exit not counted)."""
    rot = block * mdim * n if block > 1 else 0
    return B * P * (ntt_ops(kk, n) + block * kk * mdim * n + rot + ntt_ops(mdim, n, True))


def chunked(fn, a, *args):
    """fn over batch chunks of `a` (every plain version here is batch-wise)."""
    import torch

    return torch.cat([fn(a[i : i + PLAIN_CHUNK], *args) for i in range(0, a.shape[0], PLAIN_CHUNK)])


def keys_and_ciphertexts(m, batch: int, seed: int):
    """bench.py's set-up: secret, `batch` encryptions of random 16-bit data,
    and the prepared GGSW of X^1, from the same seeds."""
    import numpy as np
    import torch

    from poulpy_tpu_torch.core import encryption as enc
    from poulpy_tpu_torch.core.layouts import GLWEPlaintext
    from poulpy_tpu_torch.core.prepared import ggsw_prepare, glwe_secret_prepare
    from poulpy_tpu_torch.hal import vec_znx
    from poulpy_tpu_torch.hal.source import Source

    src = Source(bytes(32))
    xe, xa = Source(b"\x01" * 32), Source(b"\x02" * 32)
    skp = glwe_secret_prepare(m, enc.secret_new(m, 1, src))
    data = torch.from_numpy(
        np.random.default_rng(seed).integers(-(2**15), 2**15, size=(batch, N), dtype=np.int64)
    ).to(m.device)
    pt = GLWEPlaintext(data=vec_znx.encode_vec_i64(BASE2K, K_PT, 3, data), base2k=BASE2K, k=K_PT)
    ct = enc.glwe_encrypt_sk(m, pt, skp, BASE2K, K_CT, xe, xa, batch_shape=(batch,))
    ptg = np.zeros(N, dtype=np.int64)
    ptg[1] = 1
    ggswp = ggsw_prepare(m, enc.ggsw_encrypt_sk(m, ptg, skp, BASE2K, K_KEY, dnum=DNUM,
                                                source_xe=xe, source_xa=xa))
    return skp, data, ct, ggswp


def tensor_ops(B: int, P: int, n: int, size_a: int, size_b: int) -> int:
    """Modular products of the rank-1 tensor product: forward NTT of the
    2·(size_a + size_b) operand rows, the 4·size_a·size_b products of the
    three column-pair convolutions, inverse NTT of their 3·conv_size rows,
    per prime and ciphertext pair (the 128-bit Garner lift and the exit not
    counted)."""
    conv = size_a + size_b - 1
    return B * P * (ntt_ops(2 * (size_a + size_b), n) + 4 * size_a * size_b * n
                    + ntt_ops(3 * conv, n, True))


def check_kernels(cases: dict) -> dict:
    """Run each case (kernel, plain version, bound[, rows of its step-B digit
    product]) once and compare, tolerance 0; time the kernel (5 launches),
    the plain version (1 run) and the torch._int_mm yardstick where given;
    emit one line per case and return their numbers."""
    import torch

    out = {}
    for name, (kernel, plain, bnd, *gemm_rows) in cases.items():
        have, want = kernel(), plain()
        torch.cuda.synchronize()
        if isinstance(have, tuple):                 # the tensor step's (d, lin)
            have, want = (torch.cat([x.flatten() for x in t]) for t in (have, want))
        err = int((have.to(torch.int64) - want.to(torch.int64)).abs().max())
        equal = bool(torch.equal(have, want))
        shape = list(have.shape)
        ms, plain_ms = cuda_ms(kernel, 5), cuda_ms(plain, 1)
        library_ms = int_mm_ms(gemm_rows[0], N, torch.device("cuda")) if gemm_rows else None
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd["bound_ms"],
                         bound_by=bnd["bound_by"], library_ms=library_ms)
        emit(phase="kernels", kernel=name, shape=shape, equal=equal, tolerance=0,
             max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bnd,
             share_of_bound=bnd["bound_ms"] / ms)
        if not equal:
            raise SystemExit(f"kernel {name} disagrees with its plain version")
        del have, want
    return out


def phase_kernels(m, gm, wm) -> dict:
    """Each kernel against its plain version at its path's shapes: the
    product path's on `m`, the gate path's on `gm` at batch GATE_BATCH, the
    wide CKKS mul's on `wm` at batch CKKS_BATCH, the relinearize and
    ckks_rotate paths' on `m` (the ckks configuration's basis) at batch
    CKKS_BATCH."""
    import torch

    from poulpy_tpu_torch.backends import fused, ntt, vmp, wide

    gen = torch.Generator(device=m.device).manual_seed(5)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=m.device, dtype=torch.int64)

    def residues(mod, shape):
        primes = torch.tensor(mod.basis.primes, device=mod.device)[:, None]
        return (ints(0, 1 << 62, shape) % primes).to(torch.int32)

    t = m.tables
    # the encryption of the batch transforms [B, 3 limbs, P, N] residues; the
    # product's matrix is [rows 3, ci 2, co 2, psize 4, P, N]
    x = residues(m, (BATCH, 3, NPRIMES, N))
    a_dft = residues(m, (BATCH, 2, 3, NPRIMES, N))
    pmat = residues(m, (DNUM, 2, 2, 4, NPRIMES, N))
    a = ints(-(2**16), 2**16, (BATCH, 2, 3, N))
    # the gate path: the keyswitch [ci 1, k_ct 34: 2 limbs] × KSK [dnum 2, 1,
    # 2, psize 3] with the body added, and one block step of the BRK [block 8,
    # dnum 4, 2, 2, psize 4] on acc [2, 2 limbs]
    gn, gp = gm.n, gm.nprimes
    ks_a = ints(-(2**16), 2**16, (GATE_BATCH, 1, 2, gn))
    ks_body = ints(-(2**16), 2**16, (GATE_BATCH, 2, gn))
    ks_pmat = residues(gm, (2, 1, 2, 3, gp, gn))
    acc = ints(-(2**16), 2**16, (GATE_BATCH, 2, 2, gn))
    brk = residues(gm, (GATE_BLOCK, 4, 2, 2, 4, gp, gn))
    amounts = ints(-gn, gn + 1, (GATE_BATCH, GATE_BLOCK))
    pm_k = fused.pm_kernel_layout(brk, 2)
    rows_used = int(torch.unique(amounts & (2 * gn - 1)).numel())
    # the wide CKKS mul (2 limbs of 52 bits, tensor key dnum 2, psize 3, P 5):
    # the tensor step on both ciphertexts, then the relinearization of its
    # 2 digits [ci 1, 2 rows] × [rows 2, ci 1, co 2, psize 3] with the 3 lin
    # limbs of each column added, to res_size 2
    c = CKKS_WIDE
    wn, wp, wb = c.n, c.nprimes, CKKS_BATCH
    ca = ints(-(2**51), 2**51, (wb, 2, 2, wn))
    cb = ints(-(2**51), 2**51, (wb, 2, 2, wn))
    digits = ints(-(2**51), 2**51, (wb, 1, c.dnum, wn))
    lin = ints(-(2**51), 2**51, (wb, 2, 3, wn))
    tkey = residues(wm, (c.dnum, 1, 2, 3, wp, wn))
    # the relinearize path (ciphertexts of 6 limbs of 17 bits, tensor key k 95
    # dnum 6, psize 6): the tensor step on both ciphertexts, conv 11, then the
    # product of its 6 digits [ci 1, 6 rows] × [rows 6, ci 1, co 2, psize 6]
    # with the 11 linear limbs of each column added, to res_size 12; the
    # ckks_rotate path: the keyswitch of the mask [ci 1, 6 limbs] by the
    # automorphism key [6, 1, 2, 6] with the 6-limb body, to 6 limbs.  Both
    # products split their two output columns over two blocks.
    k, rb, kp = CKKS, CKKS_BATCH, CKKS.nprimes
    ra = ints(-(2**16), 2**16, (rb, 2, 6, N))
    rbb = ints(-(2**16), 2**16, (rb, 2, 6, N))
    rdig = ints(-(2**16), 2**16, (rb, 1, k.dnum, N))
    rlin = ints(-(2**47), 2**47, (rb, 2, 11, N))
    rkey = residues(m, (k.dnum, 1, 2, 6, kp, N))
    rot_a = ints(-(2**16), 2**16, (rb, 1, 6, N))
    rot_body = ints(-(2**16), 2**16, (rb, 6, N))
    i32, i64 = 4, 8
    cases = {
        "ntt_forward": (lambda: ntt.ntt_forward(t, x), lambda: ntt.ntt_forward_ref(t, x),
                        bound(2 * x.numel() * i32, ntt_ops(x.numel() // N, N))),
        "ntt_inverse": (lambda: ntt.ntt_inverse(t, x), lambda: ntt.ntt_inverse_ref(t, x),
                        bound(2 * x.numel() * i32, ntt_ops(x.numel() // N, N, True))),
        "vmp": (lambda: vmp.vmp_apply(m, a_dft, pmat),
                lambda: chunked(lambda c: vmp.vmp_apply_ref(m, c, pmat), a_dft),
                bound((a_dft.numel() + pmat.numel() + BATCH * 2 * 4 * NPRIMES * N) * i32,
                      BATCH * 6 * 8 * NPRIMES * N)),
        "fused_product": (
            lambda: fused.fused_glwe_product(m, a, pmat, 3, BASE2K, BASE2K),
            lambda: chunked(lambda c: fused.fused_glwe_product_ref(m, c, pmat, 3, BASE2K, BASE2K), a),
            bound(2 * a.numel() * i64 + pmat[:3].numel() * i32, fused_ops(BATCH, 6, 8, NPRIMES, N))),
        "fused_product_small": (
            lambda: fused.fused_glwe_product(gm, ks_a, ks_pmat, 2, BASE2K, BASE2K, small=ks_body),
            lambda: fused.fused_glwe_product_ref(gm, ks_a, ks_pmat, 2, BASE2K, BASE2K,
                                                 small=ks_body),
            bound((ks_a.numel() + ks_body.numel() + GATE_BATCH * 2 * 2 * gn) * i64
                  + ks_pmat.numel() * i32, fused_ops(GATE_BATCH, 2, 6, gp, gn))),
        "br_block_step": (
            lambda: fused.fused_br_block_step(gm, acc, brk, amounts, 2, BASE2K, pm_k),
            lambda: fused.fused_br_block_step_ref(gm, acc, brk, amounts, 2, BASE2K),
            bound(2 * acc.numel() * i64 + amounts.numel() * i64 + pm_k.numel() * i32
                  + rows_used * gp * gn * i32,
                  fused_ops(GATE_BATCH, 4, 8, gp, gn, GATE_BLOCK))),
        "wide_tensor": (
            lambda: wide.fused_tensor_product_wide(wm, ca, cb, 3, c.dnum, 3, c.base2k, c.base2k,
                                                   WIDE_OFFSET),
            lambda: wide.fused_tensor_product_wide_ref(wm, ca, cb, 3, c.dnum, 3, c.base2k,
                                                       c.base2k, WIDE_OFFSET),
            bound((ca.numel() + cb.numel() + wb * (c.dnum + 2 * 3) * wn) * i64,
                  tensor_ops(wb, wp, wn, 2, 2))),
        "wide_product": (
            lambda: wide.fused_glwe_product_wide(wm, digits, tkey, 2, c.base2k, c.base2k,
                                                 small=lin),
            lambda: wide.fused_glwe_product_wide_ref(wm, digits, tkey, 2, c.base2k, c.base2k,
                                                     small=lin),
            bound((digits.numel() + lin.numel() + wb * 2 * 2 * wn) * i64 + tkey.numel() * i32,
                  fused_ops(wb, c.dnum, 6, wp, wn))),
        "tensor_product": (
            lambda: fused.fused_tensor_product(m, ra, rbb, 11, k.dnum, k.base2k, k.base2k),
            lambda: fused.fused_tensor_product_ref(m, ra, rbb, 11, k.dnum, k.base2k, k.base2k),
            bound((ra.numel() + rbb.numel() + rb * (k.dnum + 2 * 11) * N) * i64,
                  tensor_ops(rb, kp, N, 6, 6))),
        "fused_product_small64": (
            lambda: fused.fused_glwe_product(m, rdig, rkey, 12, k.base2k, k.base2k, small64=rlin),
            lambda: fused.fused_glwe_product_ref(m, rdig, rkey, 12, k.base2k, k.base2k,
                                                 small64=rlin),
            bound((rdig.numel() + rlin.numel() + rb * 2 * 12 * N) * i64 + rkey.numel() * i32,
                  fused_ops(rb, k.dnum, 12, kp, N))),
        "fused_product_small@ckks_rotate": (
            lambda: fused.fused_glwe_product(m, rot_a, rkey, 6, k.base2k, k.base2k,
                                             small=rot_body),
            lambda: fused.fused_glwe_product_ref(m, rot_a, rkey, 6, k.base2k, k.base2k,
                                                 small=rot_body),
            bound((rot_a.numel() + rot_body.numel() + rb * 2 * 6 * N) * i64
                  + rkey.numel() * i32, fused_ops(rb, 6, 12, kp, N))),
    }
    return check_kernels(cases)


def phase_kernels_mxu(m, km, gm) -> dict:
    """The MXU route's kernels against their plain versions: the product
    path's shapes on `m`, the fused product with the body at the keyswitch
    path's on `km`, and the block step at the gate path's on `gm` (inputs of
    their own)."""
    import torch

    from poulpy_tpu_torch.backends import fused, fused_mxu, mxu

    gen = torch.Generator(device=m.device).manual_seed(6)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=m.device, dtype=torch.int64)

    def residues(mod, shape):
        primes = torch.tensor(mod.basis.primes, device=mod.device)[:, None]
        return (ints(0, 1 << 62, shape) % primes).to(torch.int32)

    t = m.tables
    a = ints(-(2**16), 2**16, (BATCH, 2, 3, N))
    pmat = residues(m, (DNUM, 2, 2, 4, NPRIMES, N))
    # the MXU route of the product path (B 16384): the forward of the 6 input
    # rows of each ciphertext with 3 digit planes (a), the inverse of its 8
    # output rows, the exit of its [co 2, psize 4] residues, the fused MXU
    # product; and the fused MXU product with the body at the keyswitch
    # path's shape (30-bit basis, mask [ci 1, 3 limbs] × [3, 1, 2, psize 4],
    # body 3 limbs, batch KS_BATCH)
    kp = km.nprimes
    y_mxu = residues(m, (BATCH * 8, NPRIMES, N))
    x_exit = residues(m, (BATCH, 2, 4, NPRIMES, N))
    ks_mask = ints(-(2**16), 2**16, (KS_BATCH, 1, 3, N))
    ks_body3 = ints(-(2**16), 2**16, (KS_BATCH, 3, N))
    ks_key = residues(km, (KS_DNUM, 1, 2, 4, kp, N))
    # the block step at the gate shape (acc [2, 2 limbs] at N 1024, BRK [block
    # 8, dnum 4, 2, 2, psize 4], P 2, batch GATE_BATCH), the key in σ order
    gn, gp = gm.n, gm.nprimes
    acc = ints(-(2**16), 2**16, (GATE_BATCH, 2, 2, gn))
    brk = residues(gm, (GATE_BLOCK, 4, 2, 2, 4, gp, gn))
    amounts = ints(-gn, gn + 1, (GATE_BATCH, GATE_BLOCK))
    pm_k = fused.pm_kernel_layout(brk[..., mxu.sigma_index(gm.tables)], 2)
    rows_used = int(torch.unique(amounts & (2 * gn - 1)).numel())
    n2 = split(N)[1]
    garner_products = NPRIMES * (NPRIMES - 1) // 2 + NPRIMES - 1   # per limb
    i32, i64 = 4, 8
    return check_kernels({
        "mxu_forward": (
            lambda: mxu.mxu4_forward_limbs(t, a, 3),
            lambda: chunked(lambda c: mxu.mxu4_forward_limbs_ref(t, c, 3), a),
            bound(a.numel() * (i64 + NPRIMES * i32), a.numel() * NPRIMES,
                  mxu_macs(BATCH * 6, NPRIMES, N, 3)),
            BATCH * 6 * NPRIMES * n2),
        "mxu_inverse": (
            lambda: mxu.mxu4_inverse(t, y_mxu),
            lambda: chunked(lambda c: mxu.mxu4_inverse_ref(t, c), y_mxu),
            bound(2 * y_mxu.numel() * i32, y_mxu.numel(), mxu_macs(BATCH * 8, NPRIMES, N)),
            BATCH * 8 * NPRIMES * n2),
        "garner_exit": (
            lambda: fused.garner_exit(m, x_exit, 4, 3, BASE2K, BASE2K),
            lambda: chunked(lambda c: fused.garner_exit_ref(m, c, 4, 3, BASE2K, BASE2K), x_exit),
            bound(x_exit.numel() * i32 + BATCH * 2 * 3 * N * i64, BATCH * 2 * 4 * N * garner_products)),
        "fused_mxu_product": (
            lambda: fused_mxu.fused_mxu_glwe_product(m, a, pmat, 3, BASE2K, BASE2K),
            lambda: chunked(lambda c: fused_mxu.fused_mxu_glwe_product_ref(m, c, pmat, 3, BASE2K,
                                                                           BASE2K), a),
            bound(2 * a.numel() * i64 + pmat[:3].numel() * i32,
                  BATCH * NPRIMES * (6 * 8 + 6 + 8) * N,
                  mxu_macs(BATCH * 6, NPRIMES, N) + mxu_macs(BATCH * 8, NPRIMES, N)),
            BATCH * (6 + 8) * NPRIMES * n2),
        "fused_mxu_product_small": (
            lambda: fused_mxu.fused_mxu_glwe_product(km, ks_mask, ks_key, 3, BASE2K, BASE2K,
                                                     small=ks_body3),
            lambda: fused_mxu.fused_mxu_glwe_product_ref(km, ks_mask, ks_key, 3, BASE2K, BASE2K,
                                                         small=ks_body3),
            bound((ks_mask.numel() + ks_body3.numel() + KS_BATCH * 2 * 3 * N) * i64
                  + ks_key.numel() * i32, KS_BATCH * kp * (3 * 8 + 3 + 8) * N,
                  mxu_macs(KS_BATCH * 3, kp, N) + mxu_macs(KS_BATCH * 8, kp, N)),
            KS_BATCH * (3 + 8) * kp * n2),
        # modular products: the block's VMP and x-power factor and the
        # twiddles of 4 forward and 8 inverse rows (the transforms are int8
        # multiply-adds), per prime and ciphertext
        "fused_mxu_br_block_step": (
            lambda: fused_mxu.fused_mxu_br_block_step(gm, acc, brk, amounts, 2, BASE2K, pm_k),
            lambda: fused_mxu.fused_mxu_br_block_step_ref(gm, acc, brk, amounts, 2, BASE2K),
            bound(2 * acc.numel() * i64 + amounts.numel() * i64 + pm_k.numel() * i32
                  + rows_used * gp * gn * i32,
                  GATE_BATCH * gp * GATE_BLOCK * (4 * 8 + 8) * gn + GATE_BATCH * gp * 12 * gn,
                  mxu_macs(GATE_BATCH * 4, gp, gn) + mxu_macs(GATE_BATCH * 8, gp, gn)),
            GATE_BATCH * (4 + 8) * gp * split(gn)[1]),
    })


def phase_kernels_large_n() -> None:
    """Each product kernel at a shape whose rows do not fit in shared memory
    (bench.py's product at N 8192; the CKKS key's keyswitch, the gate's
    block step and the CKKS-wide pair at N 4096), batch 2–4, against its
    plain version, tolerance 0, with the layout its launch takes (the
    wrappers' own formula) and its time."""
    import torch

    from poulpy_tpu_torch.backends import fused, fused_mxu, mxu, wide
    from poulpy_tpu_torch.hal.module import get_module

    gen = torch.Generator(device="cuda").manual_seed(8)

    def ints(lim, shape):
        return torch.randint(-lim, lim, shape, generator=gen, device="cuda", dtype=torch.int64)

    def residues(mod, shape):
        primes = torch.tensor(mod.basis.primes, device="cuda")[:, None]
        return (ints(1 << 62, shape).abs() % primes).to(torch.int32)

    m8, m4, w4 = (get_module(8192, 2, 28, "cuda"), get_module(4096, 2, 28, "cuda"),
                  get_module(4096, 5, 28, "cuda"))
    a8, pmat8 = ints(2**16, (2, 2, 3, 8192)), residues(m8, (3, 2, 2, 4, 2, 8192))
    ks_a, ks_key, ks_body = (ints(2**16, (4, 1, 6, 4096)), residues(m4, (6, 1, 2, 6, 2, 4096)),
                             ints(2**16, (4, 6, 4096)))
    acc, brk = ints(2**16, (4, 2, 2, 4096)), residues(m4, (GATE_BLOCK, 4, 2, 2, 4, 2, 4096))
    amounts = ints(3 * 4096, (4, GATE_BLOCK))
    pm_k = fused.pm_kernel_layout(brk[..., mxu.sigma_index(m4.tables)], 2)
    wd, wkey, wlin = (ints(2**51, (2, 1, 2, 4096)), residues(w4, (2, 1, 2, 3, 5, 4096)),
                      ints(2**51, (2, 2, 3, 4096)))
    wa, wb = ints(2**51, (2, 2, 2, 4096)), ints(2**51, (2, 2, 2, 4096))

    def flat(fn, *args):
        return lambda: torch.cat([x.flatten() for x in fn(*args)])

    cases = {
        "fused_product": (fused.product_layout(6, 2, 4, 2, 8192),
                          lambda: fused.fused_glwe_product(m8, a8, pmat8, 3, BASE2K, BASE2K),
                          lambda: fused.fused_glwe_product_ref(m8, a8, pmat8, 3, BASE2K, BASE2K)),
        "fused_product_small": (
            fused.product_layout(6, 2, 6, 2, 4096),
            lambda: fused.fused_glwe_product(m4, ks_a, ks_key, 6, BASE2K, BASE2K, small=ks_body),
            lambda: fused.fused_glwe_product_ref(m4, ks_a, ks_key, 6, BASE2K, BASE2K,
                                                 small=ks_body)),
        "fused_product_small64": (
            fused.product_layout(6, 2, 6, 2, 4096),
            lambda: fused.fused_glwe_product(m4, ks_a, ks_key, 12, BASE2K, BASE2K,
                                             small64=ks_body[:, None].expand(4, 2, 6, 4096)),
            lambda: fused.fused_glwe_product_ref(m4, ks_a, ks_key, 12, BASE2K, BASE2K,
                                                 small64=ks_body[:, None].expand(4, 2, 6, 4096))),
        "br_block_step": (fused.product_layout(4, 2, 4, 2, 4096, split=False),
                          lambda: fused.fused_br_block_step(m4, acc, brk, amounts, 2, BASE2K),
                          lambda: fused.fused_br_block_step_ref(m4, acc, brk, amounts, 2, BASE2K)),
        "wide_product": (fused.product_layout(2, 2, 3, 5, 4096),
                         lambda: wide.fused_glwe_product_wide(w4, wd, wkey, 2, 52, 52, small=wlin),
                         lambda: wide.fused_glwe_product_wide_ref(w4, wd, wkey, 2, 52, 52,
                                                                  small=wlin)),
        "wide_tensor": (wide.tensor_wide_layout(2, 2, 3, 5, 4096),
                        flat(wide.fused_tensor_product_wide, w4, wa, wb, 3, 2, 3, 52, 52,
                             WIDE_OFFSET),
                        flat(wide.fused_tensor_product_wide_ref, w4, wa, wb, 3, 2, 3, 52, 52,
                             WIDE_OFFSET)),
        "fused_mxu_product": (
            fused_mxu.mxu_layout(6, 2, 4, 2, 8192),
            lambda: fused_mxu.fused_mxu_glwe_product(m8, a8, pmat8, 3, BASE2K, BASE2K),
            lambda: fused_mxu.fused_mxu_glwe_product_ref(m8, a8, pmat8, 3, BASE2K, BASE2K)),
        "fused_mxu_product_small": (
            fused_mxu.mxu_layout(6, 2, 6, 2, 4096),
            lambda: fused_mxu.fused_mxu_glwe_product(m4, ks_a, ks_key, 6, BASE2K, BASE2K,
                                                     small=ks_body),
            lambda: fused_mxu.fused_mxu_glwe_product_ref(m4, ks_a, ks_key, 6, BASE2K, BASE2K,
                                                         small=ks_body)),
        "fused_mxu_br_block_step": (
            fused_mxu.mxu_layout(4, 2, 4, 2, 4096, split=False),
            lambda: fused_mxu.fused_mxu_br_block_step(m4, acc, brk, amounts, 2, BASE2K, pm_k),
            lambda: fused_mxu.fused_mxu_br_block_step_ref(m4, acc, brk, amounts, 2, BASE2K)),
    }
    for name, (lay, kernel, plain) in cases.items():
        have, want = kernel(), plain()
        torch.cuda.synchronize()
        equal = bool(torch.equal(have, want))
        emit(phase="kernels_large_n", kernel=name, shape=list(have.shape), layout=lay.kind,
             smem=lay.smem, rows_per_pass=lay.chunk, cols_per_block=lay.cpb, equal=equal,
             tolerance=0, max_abs_err=int((have - want).abs().max()), ms=cuda_ms(kernel, 3))
        if not equal or lay.kind != "global":
            raise SystemExit(f"large-N {name}: layout {lay.kind}, equal {equal}")


def decrypts_to_x_m(m, skp, data, out) -> bool:
    """The product by the GGSW of X decrypts to X·m exactly."""
    import torch

    from poulpy_tpu_torch.core.decryption import glwe_decrypt
    from poulpy_tpu_torch.core.layouts import GLWECiphertext
    from poulpy_tpu_torch.hal import vec_znx, znx

    ptd = glwe_decrypt(m, GLWECiphertext(data=out, base2k=BASE2K, k=K_CT), skp)
    got = vec_znx.decode_vec_i64(BASE2K, K_PT, ptd.data)
    return bool(torch.equal(got, znx.znx_rotate(1, data)))


def phase_verify(m) -> tuple:
    """bench.py verify_on_device: stage by stage equals fused; decrypt exact.
    Returns the set-up (secret, data, ciphertexts, GGSW) for the MXU gates."""
    import torch

    from poulpy_tpu_torch.backends.fused import fused_glwe_product
    from poulpy_tpu_torch.hal import dft

    skp, data, ct, ggswp = keys_and_ciphertexts(m, VERIFY_BATCH, seed=7)
    res_size = ct.data.shape[-2]
    a_dft = dft.dft_apply(m, ct.data)
    big = dft.idft_apply(m, dft.vmp_apply(m, a_dft, ggswp.pmat))
    want = dft.big_normalize(m, res_size, BASE2K, big, BASE2K)
    have = fused_glwe_product(m, ct.data, ggswp.pmat, res_size, BASE2K, BASE2K)
    exact = bool(torch.equal(have, want))
    dec_ok = decrypts_to_x_m(m, skp, data, have)
    emit(phase="verify", fused_vs_stages_bit_exact=exact, decrypt_exact=dec_ok,
         batch=VERIFY_BATCH)
    if not (exact and dec_ok):
        raise SystemExit("verify failed")
    return skp, data, ct, ggswp


def phase_route_verify(m, setup, route: str) -> None:
    """bench.py's MXU A/B gate at VERIFY_BATCH: the route's product equals the
    butterfly fused kernel's bit for bit and decrypts to X·m."""
    import torch

    from poulpy_tpu_torch.backends.fused import fused_glwe_product
    from poulpy_tpu_torch.core.external_product import glwe_external_product

    skp, data, ct, ggswp = setup
    want = fused_glwe_product(m, ct.data, ggswp.pmat, ct.data.shape[-2], BASE2K, BASE2K)
    have = glwe_external_product(m, ct, ggswp, route=route).data
    exact = bool(torch.equal(have, want))
    dec_ok = decrypts_to_x_m(m, skp, data, have)
    emit(phase=f"verify_{route}", route=route, route_vs_fused_bit_exact=exact,
         decrypt_exact=dec_ok, batch=VERIFY_BATCH)
    if not (exact and dec_ok):
        raise SystemExit(f"the {route} route's A/B gate failed")


def chain_bench(m, ct, ggswp, route: str, phase: str, profile: bool) -> None:
    """1 warm-up + ITERS timed chained products through `route`, ending in
    the checksum; with `profile`, one more product under torch.profiler."""
    import torch

    from poulpy_tpu_torch.core.external_product import glwe_external_product

    def checksum(c):
        return int((c.data.abs() % 65536).sum())

    out = glwe_external_product(m, ct, ggswp, route=route)
    checksum(out)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = glwe_external_product(m, out, ggswp, route=route)
    value = checksum(out)
    dt = time.perf_counter() - t0
    emit(phase=phase, route=route, batch=BATCH, iters=ITERS, products_per_s=BATCH * ITERS / dt,
         ms_per_iter=dt / ITERS * 1e3, checksum=value, checksum_expected=CHECKSUM,
         shape=list(out.data.shape), peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    if value != CHECKSUM:
        raise SystemExit(f"{phase}: checksum {value} != {CHECKSUM}")
    if profile:
        profile_once(f"{phase}_profile", lambda: glwe_external_product(m, out, ggswp, route=route),
                     dt / ITERS * 1e3)


def phase_bench(m) -> tuple:
    """bench.py main(): 1 warm-up + 30 timed chained products at B = 16384.
    Returns the batch and the GGSW for the MXU routes' runs."""
    import torch

    t0 = time.perf_counter()
    ct, ggswp = keys_and_ciphertexts(m, BATCH, seed=0)[2:]   # the 256 MiB of messages go
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    emit(phase="setup", batch=BATCH, keygen_encrypt_prepare_s=setup_s,
         allocated_gib=torch.cuda.memory_allocated() / 2**30)
    chain_bench(m, ct, ggswp, "fused", "bench", profile=False)
    return ct, ggswp


def gate_setup(params, batch: int, device):
    """bench_full.py bench_gate_bootstrap's set-up: keygen from bytes(32), the
    bits from default_rng(0) and (1), encrypted from Source 0x05 / 0x06."""
    import numpy as np

    from poulpy_tpu_torch.binfhe import gates
    from poulpy_tpu_torch.hal.source import Source

    keys, sk = gates.keygen(params, bytes(32), device=device)
    xe, xa = Source(b"\x05" * 32), Source(b"\x06" * 32)
    b1 = np.random.default_rng(0).integers(0, 2, batch)
    b2 = np.random.default_rng(1).integers(0, 2, batch)
    c1 = gates.encrypt_bit(params, b1, sk, xe, xa)
    c2 = gates.encrypt_bit(params, b2, sk, xe, xa)
    return keys, sk, b1, b2, c1, c2


def plain_block_rotation(keys, lwe, step_ref):
    """The block path with the plain step `step_ref` (fused_br_block_step_ref
    or fused_mxu_br_block_step_ref) in place of the kernel (the same mod
    switch, accumulator and blocks as blind_rotation_execute_block)."""
    from poulpy_tpu_torch.binfhe.blind_rotation import _acc_init, mod_switch_2n

    m, brk, lut, block = keys.module, keys.brk, keys.lut, keys.params.block_size
    lwe_2n = mod_switch_2n(2 * m.n, lwe, lut.rot_dir)
    acc = _acc_init(lwe_2n[..., 0], lut, brk.rank)
    for j in range(brk.n_lwe // block):
        blk = slice(j * block, (j + 1) * block)
        acc = step_ref(m, acc, brk.pmats[blk], lwe_2n[..., 1:][..., blk], lut.size, brk.base2k)
    return acc


def phase_gate_verify(setup, std_params, batch: int, route: str = "fused") -> None:
    """Block path through `route` == its plain block path (and, for an MXU
    route, == the butterfly route); NAND truth on both BR paths, the
    standard path through the route == the butterfly's."""
    import numpy as np
    import torch

    from poulpy_tpu_torch.backends.fused import fused_br_block_step_ref
    from poulpy_tpu_torch.backends.fused_mxu import fused_mxu_br_block_step_ref
    from poulpy_tpu_torch.binfhe import gates
    from poulpy_tpu_torch.binfhe.blind_rotation import (
        blind_rotation_execute,
        blind_rotation_execute_block,
    )
    from poulpy_tpu_torch.core.layouts import LWECiphertext
    from poulpy_tpu_torch.hal.normalization import vec_znx_normalize

    def linear(p, c1, c2):
        return LWECiphertext(data=vec_znx_normalize(p.base2k, gates._const_lwe(p, 1, 3, c1)
                                                    - c1.data - c2.data), base2k=p.base2k,
                             k=p.k_ct)

    keys, sk, b1, b2, c1, c2 = setup
    p = keys.params
    c1, c2, b1, b2 = (c1.replace(data=c1.data[:batch]), c2.replace(data=c2.data[:batch]),
                      b1[:batch], b2[:batch])
    lin = linear(p, c1, c2)
    have = blind_rotation_execute_block(keys.module, lin, keys.lut, keys.brk, p.block_size, route)
    step_ref = fused_mxu_br_block_step_ref if route == "fused_mxu" else fused_br_block_step_ref
    checks = {"block_kernel_vs_plain_bit_exact": bool(torch.equal(
        have, plain_block_rotation(keys, lin, step_ref)))}
    if route != "fused":
        checks["block_route_vs_butterfly_bit_exact"] = bool(torch.equal(
            have, blind_rotation_execute_block(keys.module, lin, keys.lut, keys.brk,
                                               p.block_size)))
    checks["block_nand_truth"] = bool(np.array_equal(
        gates.decrypt_bit(gates.gate_nand(keys, c1, c2, route=route), sk), 1 - (b1 & b2)))
    skeys, ssk, sb1, sb2, sc1, sc2 = gate_setup(std_params, batch, keys.module.device)
    if route != "fused":
        slin = linear(std_params, sc1, sc2)
        checks["standard_route_vs_butterfly_bit_exact"] = bool(torch.equal(
            blind_rotation_execute(skeys.module, slin, skeys.lut, skeys.brk, route),
            blind_rotation_execute(skeys.module, slin, skeys.lut, skeys.brk)))
    checks["standard_nand_truth"] = bool(np.array_equal(
        gates.decrypt_bit(gates.gate_nand(skeys, sc1, sc2, route=route), ssk), 1 - (sb1 & sb2)))
    emit(phase="gate_verify" if route == "fused" else f"gate_verify_{route}", batch=batch,
         standard_n_lwe=std_params.n_lwe, **checks)
    if not all(checks.values()):
        raise SystemExit(f"gate verify through the {route} route failed")


def phase_gate_bench(setup, iters: int, fingerprint: int | None, route: str = "fused",
                     butterfly_gates_per_s: float | None = None) -> float:
    """1 warm-up NAND (fingerprint, truth) + `iters` timed chained NANDs
    through `route`; returns the gates/s."""
    import numpy as np
    import torch

    from poulpy_tpu_torch.backends import LAUNCHES
    from poulpy_tpu_torch.binfhe import gates

    keys, sk, b1, b2, c1, c2 = setup
    device = keys.module.device
    batch = len(b1)
    name = "gate" if route == "fused" else f"gate_{route}"

    def checksum(ct):
        return int((ct.data.abs() % 65536).sum())

    out = gates.gate_nand(keys, c1, c2, route=route)
    value = checksum(out)
    truth = bool(np.array_equal(gates.decrypt_bit(out, sk), 1 - (b1 & b2)))
    emit(phase=f"{name}_warmup", fingerprint=value, fingerprint_expected=fingerprint,
         nand_truth=truth, shape=list(out.data.shape))
    if not truth or (fingerprint is not None and value != fingerprint):
        raise SystemExit(f"{name} warm-up failed: fingerprint {value}, truth {truth}")
    expect = 1 - (b1 & b2)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    before = dict(LAUNCHES)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = gates.gate_nand(keys, out, c2, route=route)
        expect = 1 - (expect & b2)
    value = checksum(out)
    dt = time.perf_counter() - t0
    per_nand = {k: (LAUNCHES[k] - before[k]) / iters for k in LAUNCHES if LAUNCHES[k] != before[k]}
    truth = bool(np.array_equal(gates.decrypt_bit(out, sk), expect))
    extra = {} if butterfly_gates_per_s is None else {
        "butterfly_gates_per_s": butterfly_gates_per_s}
    emit(phase=f"{name}_bench", route=route, batch=batch, iters=iters,
         gates_per_s=batch * iters / dt, **extra, ms_per_batch=dt / iters * 1e3, checksum=value,
         decrypt_matches_tracked_bits=truth, launches_per_nand=per_nand,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else None)
    if not truth:
        raise SystemExit("chained NANDs decrypt to the wrong bits")
    if device.type == "cuda":
        profile_once(f"{name}_profile", lambda: gates.gate_nand(keys, out, c2, route=route),
                     dt / iters * 1e3)
    return batch * iters / dt


def profile_once(phase: str, fn, timed_ms: float) -> None:
    """Two more calls of `fn` under torch.profiler, the first a warm-up step
    that takes the profiler's own start-up: the second's wall time, device
    busy time (the sum of kernel and copy times, CUDA activity) and the
    kernels that take it.  The profiler's host-side tracing lengthens the
    wall time of a call made of many small launches, so the busy time is
    also given as a share of `timed_ms`, the same call's time in the
    unprofiled timed loop.  The trace now and then lacks some of the step's
    kernels; it is taken again (3 tries at most) until it holds one event
    per csrc/ kernel launched in the step."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from poulpy_tpu_torch.backends import LAUNCHES

    for attempt in range(1, 4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                launched = sum(LAUNCHES.values())
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
                launched = sum(LAUNCHES.values()) - launched
                prof.step()
        device = {}                               # kernel or copy name → [ms, count]
        for e in prof.events():
            # the schedule's ProfilerStep range spans the step: not device work
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.name.startswith("ProfilerStep")):
                entry = device.setdefault(e.name, [0.0, 0])
                entry[0] += e.time_range.elapsed_us() / 1e3
                entry[1] += 1
        # the kernels of csrc/ (each in an anonymous namespace) against torch's own (a
        # template kernel's name starts with its return type: "void (anonymous namespace)::…")
        csrc = [v for k, v in device.items() if "(anonymous namespace)::" in k]
        if sum(c for _, c in csrc) >= launched:
            break
    busy_ms = sum(ms for ms, _ in device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1][0])[:6]
    emit(phase=phase, wall_ms=wall_ms, device_busy_ms=busy_ms, busy_share=busy_ms / wall_ms,
         timed_ms=timed_ms, busy_share_of_timed=busy_ms / timed_ms,
         csrc_kernels_ms=sum(ms for ms, _ in csrc), csrc_launches=launched,
         csrc_events=sum(c for _, c in csrc), tries=attempt,
         device_events=sum(c for _, c in device.values()),
         top=[dict(name=k[:90], device_ms=ms, count=c) for k, (ms, c) in top])


def ks_chain(m, c, ksk, count: int, route: str = "fused") -> int:
    """`count` chained keyswitches through `route`, then a host-materialized
    checksum."""
    from poulpy_tpu_torch.core.keyswitching import glwe_keyswitch

    for _ in range(count):
        c = glwe_keyswitch(m, c, ksk, route=route)
    return int((c.data.abs() % 65536).sum())


def phase_keyswitch(device, n: int) -> tuple:
    """bench_full.py's keyswitch at its configuration: the kernel against the
    plain keyswitch at batch 8 (and an exact decrypt), chained single
    keyswitches, chained batched keyswitches.  Returns the set-up for the MXU
    routes' runs."""
    import numpy as np
    import torch

    from poulpy_tpu_torch.backends.fused import fused_glwe_product_ref
    from poulpy_tpu_torch.core import encryption as enc
    from poulpy_tpu_torch.core.decryption import glwe_decrypt
    from poulpy_tpu_torch.core.keyswitching import glwe_keyswitch
    from poulpy_tpu_torch.core.layouts import GLWEPlaintext
    from poulpy_tpu_torch.core.prepared import gglwe_prepare, glwe_secret_prepare
    from poulpy_tpu_torch.hal import vec_znx
    from poulpy_tpu_torch.hal.module import get_module
    from poulpy_tpu_torch.hal.source import Source

    m = get_module(n, 2, device=device)
    src = Source(bytes(32))
    xe, xa = src.branch()[1], src.branch()[1]
    sk1, sk2 = enc.secret_new(m, 1, src), enc.secret_new(m, 1, src)
    sk1p, sk2p = glwe_secret_prepare(m, sk1), glwe_secret_prepare(m, sk2)
    ksk = gglwe_prepare(m, enc.glwe_switching_key_encrypt_sk(
        m, sk1, sk2p, BASE2K, KS_K_KEY, dnum=KS_DNUM, source_xe=xe, source_xa=xa))

    def encrypt(data):
        pt = GLWEPlaintext(data=vec_znx.encode_vec_i64(BASE2K, K_PT, 3, torch.from_numpy(data)
                                                       .to(m.device)), base2k=BASE2K, k=K_PT)
        return enc.glwe_encrypt_sk(m, pt, sk1p, BASE2K, K_CT, xe, xa,
                                   batch_shape=data.shape[:-1])

    data = np.random.default_rng(2).integers(-(2**15), 2**15, (KS_VERIFY_BATCH, n))
    ct = encrypt(data)
    have = glwe_keyswitch(m, ct, ksk)
    want = fused_glwe_product_ref(m, ct.data[..., 1:, :, :], ksk.pmat, 3, BASE2K, BASE2K,
                                  small=ct.data[..., 0, :, :])
    exact = bool(torch.equal(have.data, want))
    got = vec_znx.decode_vec_i64(BASE2K, K_PT, glwe_decrypt(m, have, sk2p).data)
    dec_ok = bool(torch.equal(got.cpu(), torch.from_numpy(data)))

    def chain(c, count):
        return ks_chain(m, c, ksk, count)

    single = encrypt(np.random.default_rng(0).integers(-(2**15), 2**15, n))
    chain(single, 1)
    lat = []
    for _ in range(KS_REPS):
        t0 = time.perf_counter()
        chain(single, KS_CHAIN)
        lat.append((time.perf_counter() - t0) / KS_CHAIN * 1e3)
    batched = single.replace(data=single.data.expand((KS_BATCH,) + single.data.shape)
                             .contiguous())
    chain(batched, 1)
    t0 = time.perf_counter()
    chain(batched, KS_ITERS)
    dt = time.perf_counter() - t0
    emit(phase="keyswitch", n=n, kernel_vs_plain_bit_exact=exact, decrypt_exact=dec_ok,
         verify_batch=KS_VERIFY_BATCH, chain=KS_CHAIN, single_ms_median=float(np.median(lat)),
         single_ms=lat, batch=KS_BATCH, iters=KS_ITERS, cts_per_s=KS_BATCH * KS_ITERS / dt)
    if not (exact and dec_ok):
        raise SystemExit("keyswitch verify failed")
    return m, ksk, sk2p, data, ct, batched


def phase_keyswitch_route(setup, route: str) -> None:
    """The keyswitch path through `route`: equal to the butterfly route at
    batch KS_VERIFY_BATCH (and an exact decrypt), then 1 + KS_ITERS chained
    keyswitches at batch KS_BATCH."""
    import torch

    from poulpy_tpu_torch.core.decryption import glwe_decrypt
    from poulpy_tpu_torch.core.keyswitching import glwe_keyswitch
    from poulpy_tpu_torch.hal import vec_znx

    m, ksk, sk2p, data, ct, batched = setup
    have = glwe_keyswitch(m, ct, ksk, route=route)
    exact = bool(torch.equal(have.data, glwe_keyswitch(m, ct, ksk).data))
    got = vec_znx.decode_vec_i64(BASE2K, K_PT, glwe_decrypt(m, have, sk2p).data)
    dec_ok = bool(torch.equal(got.cpu(), torch.from_numpy(data)))
    ks_chain(m, batched, ksk, 1, route)
    t0 = time.perf_counter()
    value = ks_chain(m, batched, ksk, KS_ITERS, route)
    dt = time.perf_counter() - t0
    want = ks_chain(m, batched, ksk, KS_ITERS)
    emit(phase=f"keyswitch_{route}", route=route, route_vs_fused_bit_exact=exact,
         decrypt_exact=dec_ok, verify_batch=KS_VERIFY_BATCH, batch=KS_BATCH, iters=KS_ITERS,
         cts_per_s=KS_BATCH * KS_ITERS / dt, checksum=value, checksum_fused=want)
    if not (exact and dec_ok and value == want):
        raise SystemExit(f"keyswitch through the {route} route failed")


def ckks_setup(cfg: CkksConfig, batch: int, iters: int, device):
    """bench_full.py's CKKS set-up: the secret from bytes(32), the tensor key
    from Source 0x01 / 0x02, the slots z from default_rng(seed), its pair
    (c1, c2) of encryptions of z; then `iters` distinct pairs of batches of
    `batch` encryptions of z, drawn on from the same sources."""
    import numpy as np

    from poulpy_tpu_torch.ckks import ops as ck
    from poulpy_tpu_torch.ckks.encoder import Encoder
    from poulpy_tpu_torch.core import encryption as enc
    from poulpy_tpu_torch.core.prepared import glwe_secret_prepare, glwe_tensor_key_prepare
    from poulpy_tpu_torch.hal.module import get_module
    from poulpy_tpu_torch.hal.source import Source

    m = get_module(cfg.n, cfg.nprimes, 28, device)
    dist = {"dist": "ternary_hw", "hw": cfg.hw} if cfg.hw else {}
    sk = enc.secret_new(m, 1, Source(bytes(32)), **dist)
    skp = glwe_secret_prepare(m, sk)
    xe, xa = Source(b"\x01" * 32), Source(b"\x02" * 32)
    tsk = glwe_tensor_key_prepare(m, enc.glwe_tensor_key_encrypt_sk(
        m, sk, skp, cfg.base2k, cfg.k_key, dnum=cfg.dnum, source_xe=xe, source_xa=xa))
    encoder = Encoder(cfg.n)
    rng = np.random.default_rng(cfg.seed)
    z = rng.normal(size=cfg.n // 2) + 1j * rng.normal(size=cfg.n // 2)
    pt = ck.encode(encoder, z, cfg.base2k, cfg.k_ct, cfg.log_delta, cfg.log_budget,
                   device=m.device)
    pair = [ck.encrypt_sk(m, pt, skp, cfg.k_ct, xe, xa) for _ in range(2)]
    timed = [ck.encrypt_sk(m, pt, skp, cfg.k_ct, xe, xa, batch_shape=(iters, batch))
             for _ in range(2)]
    return m, skp, tsk, encoder, z, pair, timed


def ckks_mul(m, a, b, tsk, cfg: CkksConfig):
    """bench_full.py's timed step: mul, then rescale(cfg.rescale) if set."""
    from poulpy_tpu_torch.ckks import ops as ck

    out = ck.mul(m, a, b, tsk)
    return ck.rescale(out, cfg.rescale) if cfg.rescale else out


def run_ckks_path(name: str, cfg: CkksConfig, device, batch: int, iters: int,
                  fingerprint: int | None) -> tuple:
    """Set-up, 1 warm-up mul of bench_full.py's pair broadcast to `batch`
    rows (fingerprint of row 0, every row equal, decode error), `iters`
    timed muls on distinct batches ending in a host checksum, and one
    profiled mul.  Returns the set-up (`ckks_setup`'s tuple) for the paths
    that share it."""
    import numpy as np
    import torch

    from poulpy_tpu_torch.backends import LAUNCHES
    from poulpy_tpu_torch.ckks import ops as ck

    t0 = time.perf_counter()
    m, skp, tsk, encoder, z, (c1, c2), (t1, t2) = ckks_setup(cfg, batch, iters, device)
    sync(device)
    setup_s = time.perf_counter() - t0
    key = tsk.keys[(0, 0)]
    emit(phase=f"{name}_setup", batch=batch, iters=iters, setup_s=setup_s,
         tensor_key_mib=key.pmat.numel() * key.pmat.element_size() / 2**20)

    def rows(c, data):
        return c.replace(glwe=c.glwe.replace(data=data))

    def err(ct):
        got = ck.decode(encoder, ck.decrypt(m, rows(ct, ct.glwe.data[0]), skp))
        return float(np.abs(got - z * z).max())

    shape = (batch,) + tuple(c1.glwe.data.shape)
    out = ckks_mul(m, rows(c1, c1.glwe.data.expand(shape).contiguous()),
                   rows(c2, c2.glwe.data.expand(shape).contiguous()), tsk, cfg)
    data = out.glwe.data
    value = int((data[0].abs() % 65536).sum())
    rows_equal = bool((data == data[:1]).all())
    warm_err = err(out)
    emit(phase=f"{name}_warmup", fingerprint=value, fingerprint_expected=fingerprint,
         rows_equal=rows_equal, decode_err_vs_z2=warm_err, shape=list(data.shape),
         log_delta=out.meta.log_delta, log_budget=out.meta.log_budget)
    if not rows_equal or (fingerprint is not None and value != fingerprint):
        raise SystemExit(f"{name} warm-up failed: fingerprint {value}, rows equal {rows_equal}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    before = dict(LAUNCHES)
    sync(device)
    t0 = time.perf_counter()
    for i in range(iters):
        out = ckks_mul(m, rows(t1, t1.glwe.data[i]), rows(t2, t2.glwe.data[i]), tsk, cfg)
    value = int((out.glwe.data.abs() % 65536).sum())
    dt = time.perf_counter() - t0
    per_mul = {k: (LAUNCHES[k] - before[k]) / iters for k in LAUNCHES if LAUNCHES[k] != before[k]}
    timed_err = err(out)
    emit(phase=name, batch=batch, iters=iters, muls_per_s=batch * iters / dt,
         ms_per_batch=dt / iters * 1e3, checksum=value, decode_err_vs_z2=timed_err,
         launches_per_mul=per_mul,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else None)
    if not timed_err <= 4 * warm_err:    # fresh noise, the same parameters: the same scale
        raise SystemExit(f"{name}: the timed product decodes {timed_err} away from z·z, "
                         f"the warm-up {warm_err}")
    if device.type == "cuda":
        profile_once(f"{name}_profile",
                     lambda: ckks_mul(m, rows(t1, t1.glwe.data[0]), rows(t2, t2.glwe.data[0]),
                                      tsk, cfg), dt / iters * 1e3)
    return m, skp, tsk, encoder, z, (c1, c2), (t1, t2)


def broadcast(ct, batch: int):
    """A GLWE ciphertext repeated to `batch` rows, in contiguous memory."""
    return ct.replace(data=ct.data.expand((batch,) + tuple(ct.data.shape)).contiguous())


def relin_log2_err(m, skp, a, b, prod) -> float:
    """log2 of the largest torus distance between the decryption of `prod`
    and d0 + d1·s + d2·s², the tensor product of `a` and `b` decrypted
    exactly (tests/test_core.py test_tensor_relinearize)."""
    import numpy as np

    from poulpy_tpu_torch.core.decryption import glwe_decrypt
    from poulpy_tpu_torch.core.operations import glwe_tensor_product_big
    from poulpy_tpu_torch.hal import dft
    from poulpy_tpu_torch.hal.normalization import vec_znx_normalize
    from poulpy_tpu_torch.hal.vec_znx import decode_vec_float

    base2k = a.base2k
    have = glwe_decrypt(m, prod, skp)
    lin, quad = glwe_tensor_product_big(m, a, b, a.size + b.size - 1)

    def times_s(big):
        return dft.idft_apply(m, dft.svp_apply(m, dft.dft_apply(m, vec_znx_normalize(base2k, big)),
                                               skp.data[0]))

    total = lin[0] + times_s(lin[1]) + times_s(times_s(quad[(0, 0)]))
    want = dft.big_normalize(m, have.data.shape[-2], base2k, total, base2k)
    err = decode_vec_float(base2k, have.data) - decode_vec_float(base2k, want)
    err -= np.round(err)
    return float(np.log2(max(np.abs(err).max(), 2.0**-200)))


def run_relinearize_path(setup, batch: int, iters: int, fingerprint: int | None) -> None:
    """On the ckks path's set-up: 1 warm-up relinearization of its pair
    broadcast to `batch` rows (fingerprint, rows equal, the algebraic check,
    kernel route == unfused route at batch 8), `iters` timed ones on the
    distinct batches, and one profiled."""
    import torch

    from poulpy_tpu_torch.backends import LAUNCHES
    from poulpy_tpu_torch.core import operations as ops

    m, skp, tsk, _, _, (c1, c2), (t1, t2) = setup
    device = m.device
    a, b = broadcast(c1.glwe, batch), broadcast(c2.glwe, batch)
    out = ops.glwe_tensor_relinearize(m, a, b, tsk)
    data = out.data
    value = int((data[0].abs() % 65536).sum())
    rows_equal = bool((data == data[:1]).all())
    log2_err = relin_log2_err(m, skp, c1.glwe, c2.glwe, out.replace(data=data[0]))
    small = 8
    fused_small = ops.glwe_tensor_relinearize(m, broadcast(c1.glwe, small),
                                              broadcast(c2.glwe, small), tsk)
    fits = ops.tensor_fits
    ops.tensor_fits = lambda *args: False        # the unfused data flow, for comparison
    try:
        unfused = ops.glwe_tensor_relinearize(m, broadcast(c1.glwe, small),
                                              broadcast(c2.glwe, small), tsk)
    finally:
        ops.tensor_fits = fits
    routes_equal = bool(torch.equal(fused_small.data, unfused.data))
    emit(phase="relinearize_warmup", fingerprint=value, fingerprint_expected=fingerprint,
         rows_equal=rows_equal, log2_err_vs_tensor=log2_err, log2_err_max=RELIN_LOG2_ERR_MAX,
         kernel_route_vs_unfused_bit_exact=routes_equal, shape=list(data.shape), k=out.k)
    if (not rows_equal or not routes_equal or log2_err > RELIN_LOG2_ERR_MAX
            or (fingerprint is not None and value != fingerprint)):
        raise SystemExit(f"relinearize warm-up failed: fingerprint {value}, rows equal "
                         f"{rows_equal}, routes equal {routes_equal}, log2 err {log2_err}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    before = dict(LAUNCHES)
    sync(device)
    t0 = time.perf_counter()
    for i in range(iters):
        out = ops.glwe_tensor_relinearize(m, t1.glwe.replace(data=t1.glwe.data[i]),
                                          t2.glwe.replace(data=t2.glwe.data[i]), tsk)
    value = int((out.data.abs() % 65536).sum())
    dt = time.perf_counter() - t0
    per_op = {k: (LAUNCHES[k] - before[k]) / iters for k in LAUNCHES if LAUNCHES[k] != before[k]}
    emit(phase="relinearize", batch=batch, iters=iters, relins_per_s=batch * iters / dt,
         ms_per_batch=dt / iters * 1e3, checksum=value, launches_per_op=per_op,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else None)
    if device.type == "cuda":
        profile_once("relinearize_profile",
                     lambda: ops.glwe_tensor_relinearize(m, t1.glwe.replace(data=t1.glwe.data[0]),
                                                         t2.glwe.replace(data=t2.glwe.data[0]),
                                                         tsk), dt / iters * 1e3)


def run_rotate_path(setup, batch: int, iters: int, fingerprints: dict | None) -> None:
    """On the ckks path's set-up: the automorphism keys of galois_element(1)
    and −1 from Source 0x05 / 0x06 (tests/test_ckks.py's seeds), rotate and
    conjugate of c1 broadcast to `batch` rows (fingerprints, rows equal,
    decode errors), then `iters` timed rotations on distinct batches."""
    import numpy as np
    import torch

    from poulpy_tpu_torch.backends import LAUNCHES
    from poulpy_tpu_torch.ckks import ops as ck
    from poulpy_tpu_torch.core import encryption as enc
    from poulpy_tpu_torch.core.prepared import GLWEAutomorphismKeyPrepared, gglwe_prepare
    from poulpy_tpu_torch.hal.source import Source

    m, skp, _, encoder, z, (c1, _), (t1, _) = setup
    device, cfg = m.device, CKKS
    t0 = time.perf_counter()
    sk = enc.secret_new(m, 1, Source(bytes(32)))        # the ckks path's secret, drawn again
    xe, xa = Source(b"" * 32), Source(b"" * 32)
    keys = {}
    for name, p in (("rotate", m.galois_element(1)), ("conjugate", -1)):
        key, _ = enc.glwe_automorphism_key_encrypt_sk(m, p, sk, cfg.base2k, cfg.k_key, cfg.dnum,
                                                      xe, xa)
        keys[name] = GLWEAutomorphismKeyPrepared(key=gglwe_prepare(m, key), p=p)
    sync(device)
    emit(phase="ckks_rotate_setup", automorphism_keys_s=time.perf_counter() - t0)
    cb = c1.replace(glwe=broadcast(c1.glwe, batch))
    checks = {}
    for name, want in (("rotate", np.roll(z, -1)), ("conjugate", np.conj(z))):
        data = getattr(ck, name)(m, cb, keys[name]).glwe.data
        row0 = c1.replace(glwe=c1.glwe.replace(data=data[0]))
        checks[name] = dict(fingerprint=int((data[0].abs() % 65536).sum()),
                            rows_equal=bool((data == data[:1]).all()),
                            decode_err=float(np.abs(ck.decode(encoder, ck.decrypt(m, row0, skp))
                                                    - want).max()))
    emit(phase="ckks_rotate_warmup", fingerprints_expected=fingerprints, **checks)
    for name, c in checks.items():
        if (not c["rows_equal"] or c["decode_err"] > 1e-4
                or (fingerprints is not None and c["fingerprint"] != fingerprints[name])):
            raise SystemExit(f"ckks_rotate warm-up failed: {name} {c}")
    before = dict(LAUNCHES)
    sync(device)
    t0 = time.perf_counter()
    for i in range(iters):
        out = ck.rotate(m, t1.replace(glwe=t1.glwe.replace(data=t1.glwe.data[i])), keys["rotate"])
    value = int((out.glwe.data.abs() % 65536).sum())
    dt = time.perf_counter() - t0
    per_op = {k: (LAUNCHES[k] - before[k]) / iters for k in LAUNCHES if LAUNCHES[k] != before[k]}
    emit(phase="ckks_rotate", batch=batch, iters=iters, rotations_per_s=batch * iters / dt,
         ms_per_batch=dt / iters * 1e3, checksum=value, launches_per_op=per_op)
    if device.type == "cuda":
        profile_once("ckks_rotate_profile",
                     lambda: ck.rotate(m, t1.replace(glwe=t1.glwe.replace(data=t1.glwe.data[0])),
                                       keys["rotate"]), dt / iters * 1e3)


def run_gate_path(device, n_lwe: int, batch: int, verify_batch: int, std_n_lwe: int,
                  iters: int, fingerprint: int | None) -> tuple:
    """The gate path: set-up, gate_verify, gate_bench.  Returns the set-up
    and the bench's gates/s, for the MXU gate path."""
    from poulpy_tpu_torch.binfhe.gates import GateParams

    t0 = time.perf_counter()
    setup = gate_setup(GateParams(n_lwe=n_lwe, block_size=GATE_BLOCK), batch, device)
    sync(device)
    brk = setup[0].brk
    emit(phase="gate_setup", batch=batch, keygen_encrypt_s=time.perf_counter() - t0,
         brk_pmats_mib=brk.pmats.numel() * brk.pmats.element_size() / 2**20)
    phase_gate_verify(setup, GateParams(n_lwe=std_n_lwe, block_size=1), verify_batch)
    return setup, phase_gate_bench(setup, iters, fingerprint)


def run_gate_route_path(gate, verify_batch: int, std_n_lwe: int, iters: int,
                        fingerprint: int | None, route: str) -> None:
    """The gate path through `route` on the gate path's set-up: verify at
    `verify_batch`, then the warm-up (fingerprint), the timed chained NANDs
    beside the butterfly's gates/s and a profiled NAND."""
    from poulpy_tpu_torch.binfhe.gates import GateParams

    setup, butterfly_gates_per_s = gate
    phase_gate_verify(setup, GateParams(n_lwe=std_n_lwe, block_size=1), verify_batch, route)
    phase_gate_bench(setup, iters, fingerprint, route, butterfly_gates_per_s)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "poulpy_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the poulpy_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from poulpy_tpu_torch.backends import LAUNCHES, _lib, reset_launches
    from poulpy_tpu_torch.hal.module import get_module

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit(phase="device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _lib.library()
    emit(phase="build", seconds=time.perf_counter() - t0, built=_lib.build_info["built"],
         library=str(Path(_lib.build_info["path"]).relative_to(ROOT)))

    m = get_module(N, NPRIMES, PRIME_BITS, "cuda")
    gm = get_module(1024, 2, 28, "cuda")          # GateParams' n_glwe, nprimes, prime_bits
    wm = get_module(CKKS_WIDE.n, CKKS_WIDE.nprimes, 28, "cuda")
    timings = phase_kernels(m, gm, wm)
    torch.cuda.empty_cache()

    shared = {}     # set-ups of the product, keyswitch and ckks paths, for the paths after them

    def on_card(key: str):
        shared[key] = moved(shared[key], m.device)
        return shared[key]

    runs = {
        # the verify set-up waits on the host while the bench runs
        "product": lambda: shared.update(verify=moved(phase_verify(m), torch.device("cpu")),
                                         bench=phase_bench(m)),
        "gate": lambda: shared.update(gate=run_gate_path(
            m.device, GATE_N_LWE, GATE_BATCH, GATE_VERIFY_BATCH, STD_N_LWE, GATE_ITERS,
            GATE_FINGERPRINT)),
        "keyswitch": lambda: shared.update(keyswitch=phase_keyswitch(m.device, KS_N)),
        "ckks_wide": lambda: run_ckks_path("ckks_wide", CKKS_WIDE, m.device, CKKS_BATCH,
                                           CKKS_ITERS, CKKS_WIDE_FINGERPRINT),
        "ckks": lambda: shared.update(ckks=run_ckks_path("ckks", CKKS, m.device, CKKS_BATCH,
                                                         CKKS_ITERS, CKKS_FINGERPRINT)),
        "relinearize": lambda: run_relinearize_path(shared["ckks"], CKKS_BATCH, CKKS_ITERS,
                                                    RELIN_FINGERPRINT),
        "ckks_rotate": lambda: run_rotate_path(shared["ckks"], CKKS_BATCH, CKKS_ITERS,
                                               {"rotate": ROTATE_FINGERPRINT,
                                                "conjugate": CONJUGATE_FINGERPRINT}),
        **{f"product_{route}": lambda route=route: (
            phase_route_verify(m, on_card("verify"), route),
            chain_bench(m, *on_card("bench"), route, f"bench_{route}", profile=True))
           for route in ROUTES},
        **{f"keyswitch_{route}": lambda route=route: phase_keyswitch_route(
            on_card("keyswitch"), route) for route in ROUTES},
        "gate_fused_mxu": lambda: run_gate_route_path(on_card("gate"), GATE_VERIFY_BATCH,
                                                      STD_N_LWE, GATE_ITERS, GATE_FINGERPRINT,
                                                      "fused_mxu"),
    }
    # after each path: the set-ups it parks on the host until the MXU paths,
    # and those it leaves behind for the last time
    park = {"product": ("bench",), "gate": ("gate",), "keyswitch": ("keyswitch",)}
    last_use = {f"product_{ROUTES[-1]}": ("verify", "bench"),
                f"keyswitch_{ROUTES[-1]}": ("keyswitch",), "ckks_rotate": ("ckks",),
                "gate_fused_mxu": ("gate",)}
    launches = dict.fromkeys(LAUNCHES, 0)
    for path, run in runs.items():
        reset_launches()
        run()
        counts = dict(LAUNCHES)
        emit(phase="launches", path=path, **counts)
        missing = [k for k in PATHS[path] if counts[k] == 0]
        if missing:
            raise SystemExit(f"the {path} path never launched: {missing}")
        stray = [k for k in MXU_KERNELS if counts[k] and not path.endswith("mxu")]
        if stray:
            raise SystemExit(f"the {path} path launched the MXU route's {stray}")
        for k, v in counts.items():
            launches[k] += v
        for key in park.get(path, ()):
            shared[key] = moved(shared[key], torch.device("cpu"))
        for key in last_use.get(path, ()):
            del shared[key]
        torch.cuda.empty_cache()
    # the keyswitch path's basis (30-bit primes), the gate path's
    timings.update(phase_kernels_mxu(m, get_module(KS_N, 2, device="cuda"), gm))
    phase_kernels_large_n()
    if not all(launches.values()):
        raise SystemExit(f"kernels never launched: {[k for k, v in launches.items() if not v]}")

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep, launches=launches[name],
             **timings[name])
        for name, (src, rep) in KERNELS.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
