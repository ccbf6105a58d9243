"""The port's native host tier: `kernels.cpp` through ctypes.

The card runs the port's CUDA kernels; around it, the host draws every key,
noise and mask stream from `Source`'s ChaCha8 keystream, which numpy
computes one state word at a time.  `kernels.cpp` computes it block by
block in C++, beside exact coefficient-domain kernels (znx rotate and
automorphism, base-2^k normalization, the i128 negacyclic convolution, the
Montgomery NTT), each bit for bit equal to its plain version in the port
(`hal/source.py`, `hal/znx.py`, `hal/normalization.py`, `hal/ntt.py`).

The library is built with `g++` at first use into `build/native/<key>/` at
the root of the checkout (listed in `.gitignore`), beside the CUDA kernels'
`build/kernels/`.  The key covers the source, the compiler flags and the
host CPU: `-march=native` code from another host could die by SIGILL, which
no exception catches.  Concurrent builds (one per test worker) each write a
file of their own and move it into place.  A failed build raises
`RuntimeError` with the compiler's output: nothing falls back to numpy.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().with_name("kernels.cpp")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
FLAGS = ("-O3", "-march=native", "-std=c++20", "-shared", "-fPIC")

# name → argument types of each C entry point (all return void)
_U32P = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_U64P = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_I64, _U64 = ctypes.c_int64, ctypes.c_uint64
_SIGNATURES = {
    "chacha8_blocks": [_U32P, _U64, _U64, _U32P],
    "znx_rotate_i64": [_I64, _I64P, _I64P, _I64, _I64],
    "znx_automorphism_i64": [_I64, _I64P, _I64P, _I64, _I64],
    "vec_znx_normalize_i64": [_I64, _I64, _I64P, _I64, _I64],
    "negacyclic_conv_i128": [_I64P, _I64P, _I64P, _U64P, _I64],
    "negacyclic_conv_i128_batch": [_I64P, _I64P, _I64P, _U64P, _I64, _I64],
    "ntt_forward_i64": [_I64P, _I64, _I64, _I64P, _I64, _I64],
    "ntt_inverse_i64": [_I64P, _I64, _I64, _I64, _I64P, _I64, _I64],
}

build_info: dict = {}


def host_cpu() -> dict:
    """The host CPU's architecture, model and feature flags (the last two
    from /proc/cpuinfo's first processor, where the system has one; a
    virtual machine may name its model "unknown", and the model is then
    its vendor, family and model numbers)."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    model = fields.get("model name", "unknown")
    if model == "unknown" and "cpu family" in fields:
        model = (f"{fields.get('vendor_id', '')} family {fields['cpu family']} "
                 f"model {fields.get('model', '?')} (model name unknown)").strip()
    return {"machine": platform.machine(), "model": model,
            "flags": fields.get("flags", fields.get("Features", ""))}


def build_key() -> str:
    """Hash of the source, the compiler flags and the host CPU."""
    cpu = host_cpu()
    digest = hashlib.sha256(SRC.read_bytes())
    for part in (CXX, *FLAGS, cpu["machine"], cpu["flags"]):
        digest.update(b"\0" + part.encode())
    return digest.hexdigest()[:16]


@functools.cache
def library() -> ctypes.CDLL:
    """The compiled host library, built on first call; raises RuntimeError
    if it cannot be built."""
    out_dir = BUILD_ROOT / build_key()
    so = out_dir / "libpoulpy_native.so"
    t0 = time.perf_counter()
    built = False
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"tmp{os.getpid()}.so"
        try:
            proc = subprocess.run([CXX, *FLAGS, str(SRC), "-o", str(tmp)],
                                  capture_output=True, text=True)
        except OSError as err:
            raise RuntimeError(f"the native host library needs {CXX}: {err}") from err
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed ({proc.returncode}) on {SRC.name}:\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, so)
        built = True
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    build_info.update(path=str(so), built=built, seconds=time.perf_counter() - t0)
    return lib


def available() -> bool:
    """Whether the library is built and loaded (building it if need be)."""
    try:
        library()
    except RuntimeError:
        return False
    return True


# ---------------------------------------------------------------------------
# numpy-facing wrappers (inputs are never mutated)
# ---------------------------------------------------------------------------

def chacha8_blocks(key_words: np.ndarray, counter0: int, nblocks: int,
                   out: np.ndarray | None = None) -> np.ndarray:
    """ChaCha8 blocks `counter0 … counter0 + nblocks − 1` as [nblocks, 16]
    uint32 (hal.source._chacha_blocks), written into `out` when given (a
    C-contiguous [nblocks, 16] uint32 array)."""
    key_words = np.ascontiguousarray(key_words, np.uint32)
    if key_words.shape != (8,):
        raise ValueError(f"a ChaCha8 key is 8 words, not {key_words.shape}")
    if out is None:
        out = np.empty((nblocks, 16), dtype=np.uint32)
    elif out.shape != (nblocks, 16) or out.dtype != np.uint32 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous ({nblocks}, 16) uint32 array")
    library().chacha8_blocks(key_words, int(counter0), int(nblocks), out)
    return out


def _rows(a: np.ndarray) -> tuple[np.ndarray, int, int]:
    a = np.ascontiguousarray(a, np.int64)
    n = a.shape[-1]
    if n < 1 or n & (n - 1):
        raise ValueError(f"N must be a power of two, not {n}")
    return a, a.size // n, n


def znx_rotate(p: int, a: np.ndarray) -> np.ndarray:
    """a · X^p in Z[X]/(X^N+1), [..., N] int64 (hal.znx.znx_rotate)."""
    a, rows, n = _rows(a)
    out = np.empty_like(a)
    library().znx_rotate_i64(int(p), a, out, rows, n)
    return out


def znx_automorphism(p: int, a: np.ndarray) -> np.ndarray:
    """a(X^p) in Z[X]/(X^N+1), p odd (hal.znx.znx_automorphism)."""
    a, rows, n = _rows(a)
    if not p & 1:
        raise ValueError(f"an automorphism's exponent is odd, not {p}")
    out = np.empty_like(a)
    library().znx_automorphism_i64(int(p) & (2 * n - 1), a, out, rows, n)
    return out


def vec_znx_normalize(base2k: int, a: np.ndarray, lsh: int = 0) -> np.ndarray:
    """Carry-propagation normalization of [..., size, N] int64 with a fused
    left shift (hal.normalization.vec_znx_normalize)."""
    if not 0 <= lsh < base2k <= 64:
        raise ValueError(f"need 0 <= lsh < base2k <= 64, not lsh {lsh}, base2k {base2k}")
    out = np.array(a, dtype=np.int64, order="C")
    size, n = out.shape[-2], out.shape[-1]
    lib = library()
    for poly in out.reshape(-1, size, n):
        lib.vec_znx_normalize_i64(int(base2k), int(lsh), poly, size, n)
    return out


def negacyclic_conv_i128(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Exact a ⊛ b in Z[X]/(X^N+1) of [..., N] int64 rows with __int128
    accumulation, as (hi, lo): int64 / uint64 arrays [..., N] holding the
    signed 128-bit results.  The caller guarantees N · max|a| · max|b| <
    2^127."""
    a, rows, n = _rows(a)
    b = np.ascontiguousarray(b, np.int64)
    if b.shape != a.shape:
        raise ValueError(f"operands of shapes {a.shape} and {b.shape}")
    hi = np.empty(a.shape, dtype=np.int64)
    lo = np.empty(a.shape, dtype=np.uint64)
    library().negacyclic_conv_i128_batch(a, b, hi, lo, rows, n)
    return hi, lo


def negacyclic_mul_exact(a, b) -> list[int]:
    """Exact negacyclic product of two int coefficient lists, through the
    i128 kernel; raises OverflowError where the result may not fit."""
    a, b = [int(v) for v in a], [int(v) for v in b]
    bound = len(a) * max(1, max(map(abs, a), default=0)) * max(1, max(map(abs, b), default=0))
    if bound >= 1 << 126:
        raise OverflowError("the product may exceed the i128 range")
    hi, lo = negacyclic_conv_i128(np.array(a, dtype=np.int64), np.array(b, dtype=np.int64))
    return [(int(h) << 64) | int(l) for h, l in zip(hi, lo)]


def ntt_forward(psi_mont: np.ndarray, p: int, qinv: int, x: np.ndarray) -> np.ndarray:
    """Forward negacyclic NTT of one prime (hal.ntt.ntt_forward): `psi_mont`
    is that prime's row of hal.ntt._host_tables, x [..., N] residues in
    [0, p)."""
    x, rows, n = _rows(x)
    psi = np.ascontiguousarray(psi_mont, np.int64)
    if psi.shape != (n,):
        raise ValueError(f"twiddle row of shape {psi.shape} for N {n}")
    out = x.copy()
    library().ntt_forward_i64(psi, int(p), int(qinv), out, rows, n)
    return out


def ntt_inverse(psi_inv_mont: np.ndarray, ninv_mont: int, p: int, qinv: int,
                x: np.ndarray) -> np.ndarray:
    """Inverse of `ntt_forward` (hal.ntt.ntt_inverse), N^{-1} in Montgomery
    form."""
    x, rows, n = _rows(x)
    psi = np.ascontiguousarray(psi_inv_mont, np.int64)
    if psi.shape != (n,):
        raise ValueError(f"twiddle row of shape {psi.shape} for N {n}")
    out = x.copy()
    library().ntt_inverse_i64(psi, int(ninv_mont), int(p), int(qinv), out, rows, n)
    return out
