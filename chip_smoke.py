#!/usr/bin/env python3
"""Smoke run of poulpy_tpu_torch on one CUDA card: the main path, once.

    python3 chip_smoke.py

The main path is the headline operation of bench.py: a batched GLWE × GGSW
external product at N = 2048, base2k = 17, ciphertext k = 51 (3 limbs),
GGSW k = 68 (dnum 3, rank 1, dsize 1), on get_module(2048, 2, 28).
Phases, each printing one JSON line:

  1. device   card name and power limit (nvidia-smi), torch and CUDA versions;
  2. build    nvcc build of the three kernels from csrc/ (sm_90a);
  3. kernels  each CUDA kernel against its plain PyTorch version on the same
              CUDA inputs at the main path's shapes, tolerance 0, with times;
  4. verify   with the launch counters reset: stage by stage (NTT → VMP →
              inverse NTT kernels, plain Garner and normalize) equals the
              fused kernel at batch 64, and the fused result decrypts to
              X·m exactly (bench.py verify_on_device);
  5. bench    bench.py's workload at B = 16384 from the same seeds: keygen,
              encryption, key preparation, 1 + 30 chained products; the
              checksum sum(|out| mod 65536) must equal 6596757198292, the
              value the JAX package's runs record (BENCH_r04/r05.json).

Then one line {"kernels": [...]} (launches counted over phases 4–5) and, last,
{"ok": true, "device": {...}}.  Any failure exits non-zero before that line.
Without a CUDA device, or without the poulpy_tpu_torch package beside this
file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N, BASE2K, K_CT, K_PT, K_KEY, DNUM = 2048, 17, 51, 34, 68, 3
NPRIMES, PRIME_BITS = 2, 28
BATCH, ITERS, VERIFY_BATCH = 16384, 30, 64
CHECKSUM = 6596757198292
PLAIN_CHUNK = 2048          # batch chunk of the plain versions of the VMP and the fused product

KERNELS = {
    "ntt_forward": ("poulpy_tpu_torch/csrc/ntt.cu", "poulpy_tpu/backends/pallas_ntt.py:407"),
    "ntt_inverse": ("poulpy_tpu_torch/csrc/ntt.cu", "poulpy_tpu/backends/pallas_ntt.py:407"),
    "vmp": ("poulpy_tpu_torch/csrc/vmp.cu", "poulpy_tpu/backends/pallas_vmp.py:67"),
    "fused_product": ("poulpy_tpu_torch/csrc/fused_product.cu",
                      "poulpy_tpu/backends/pallas_fused.py:951"),
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


def phase_kernels(m) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from poulpy_tpu_torch.backends import fused, ntt, vmp

    gen = torch.Generator(device=m.device).manual_seed(5)
    t = m.tables
    primes = torch.tensor(m.basis.primes, device=m.device)[:, None]

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=m.device, dtype=torch.int64)

    def residues(shape):
        return (ints(0, 1 << 62, shape) % primes).to(torch.int32)

    # the encryption of the batch transforms [B, 3 limbs, P, N] residues; the
    # product's matrix is [rows 3, ci 2, co 2, psize 4, P, N]
    x = residues((BATCH, 3, NPRIMES, N))
    a_dft = residues((BATCH, 2, 3, NPRIMES, N))
    pmat = residues((DNUM, 2, 2, 4, NPRIMES, N))
    a = ints(-(2**16), 2**16, (BATCH, 2, 3, N))
    cases = {
        "ntt_forward": (lambda: ntt.ntt_forward(t, x), lambda: ntt.ntt_forward_ref(t, x)),
        "ntt_inverse": (lambda: ntt.ntt_inverse(t, x), lambda: ntt.ntt_inverse_ref(t, x)),
        "vmp": (lambda: vmp.vmp_apply(m, a_dft, pmat),
                lambda: chunked(lambda c: vmp.vmp_apply_ref(m, c, pmat), a_dft)),
        "fused_product": (
            lambda: fused.fused_glwe_product(m, a, pmat, 3, BASE2K, BASE2K),
            lambda: chunked(lambda c: fused.fused_glwe_product_ref(m, c, pmat, 3, BASE2K, BASE2K), a)),
    }
    out = {}
    for name, (kernel, plain) in cases.items():
        have, want = kernel(), plain()
        torch.cuda.synchronize()
        err = int((have.to(torch.int64) - want.to(torch.int64)).abs().max())
        equal = bool(torch.equal(have, want))
        ms, plain_ms = cuda_ms(kernel, 5), cuda_ms(plain, 1)
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        emit(phase="kernels", kernel=name, shape=list(have.shape), equal=equal, tolerance=0,
             max_abs_err=err, ms=ms, plain_ms=plain_ms)
        if not equal:
            raise SystemExit(f"kernel {name} disagrees with its plain version")
        del have, want
    return out


def phase_verify(m) -> None:
    """bench.py verify_on_device: stage by stage equals fused; decrypt exact."""
    import torch

    from poulpy_tpu_torch.backends.fused import fused_glwe_product
    from poulpy_tpu_torch.core.decryption import glwe_decrypt
    from poulpy_tpu_torch.core.layouts import GLWECiphertext
    from poulpy_tpu_torch.hal import dft, vec_znx, znx

    skp, data, ct, ggswp = keys_and_ciphertexts(m, VERIFY_BATCH, seed=7)
    res_size = ct.data.shape[-2]
    a_dft = dft.dft_apply(m, ct.data)
    big = dft.idft_apply(m, dft.vmp_apply(m, a_dft, ggswp.pmat))
    want = dft.big_normalize(m, res_size, BASE2K, big, BASE2K)
    have = fused_glwe_product(m, ct.data, ggswp.pmat, res_size, BASE2K, BASE2K)
    exact = bool(torch.equal(have, want))
    ptd = glwe_decrypt(m, GLWECiphertext(data=have, base2k=BASE2K, k=K_CT), skp)
    got = vec_znx.decode_vec_i64(BASE2K, K_PT, ptd.data)
    dec_ok = bool(torch.equal(got, znx.znx_rotate(1, data)))
    emit(phase="verify", fused_vs_stages_bit_exact=exact, decrypt_exact=dec_ok,
         batch=VERIFY_BATCH)
    if not (exact and dec_ok):
        raise SystemExit("verify failed")


def phase_bench(m) -> None:
    """bench.py main(): 1 warm-up + 30 timed chained products at B = 16384."""
    import torch

    from poulpy_tpu_torch.core.external_product import glwe_external_product

    t0 = time.perf_counter()
    _, _, ct, ggswp = keys_and_ciphertexts(m, BATCH, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    emit(phase="setup", batch=BATCH, keygen_encrypt_prepare_s=setup_s)

    def checksum(c):
        return int((c.data.abs() % 65536).sum())

    out = glwe_external_product(m, ct, ggswp)
    checksum(out)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = glwe_external_product(m, out, ggswp)
    value = checksum(out)
    dt = time.perf_counter() - t0
    emit(phase="bench", batch=BATCH, iters=ITERS, products_per_s=BATCH * ITERS / dt,
         ms_per_iter=dt / ITERS * 1e3, checksum=value, checksum_expected=CHECKSUM,
         shape=list(out.data.shape), peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    if value != CHECKSUM:
        raise SystemExit(f"checksum {value} != {CHECKSUM}")


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
    timings = phase_kernels(m)
    torch.cuda.empty_cache()

    reset_launches()
    phase_verify(m)
    phase_bench(m)
    launches = dict(LAUNCHES)
    emit(phase="launches", **launches)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise SystemExit(f"main path never launched: {missing}")

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
