"""Build, load and call the CUDA kernels of `csrc/`.

The sources are compiled at first use with `nvcc` for `sm_90a` into one
shared library with a plain C interface, loaded with `ctypes`.  The library
goes to `build/kernels/<hash of the sources>/` at the root of the checkout
(listed in `.gitignore`), so a changed source builds anew and an unchanged
one is built once per checkout.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH = "arch=compute_90a,code=sm_90a"

# name → argument types of each C entry point (all return a cudaError_t)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "poulpy_ntt": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "poulpy_vmp": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "poulpy_fused_product": [_P] * 6 + [_I] * 13 + [_P],
    "poulpy_br_block_step": [_P] * 7 + [_I] * 11 + [_P],
}

build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


@functools.cache
def library() -> ctypes.CDLL:
    """The compiled kernel library, built on first call."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        digest.update(f.name.encode() + b"\0" + f.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    so = out_dir / "libpoulpy_kernels.so"
    t0 = time.perf_counter()
    built = False
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"tmp{os.getpid()}.so"
        cmd = [_nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
               *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        (out_dir / "nvcc.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, so)
        built = True
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_info.update(path=str(so), built=built, seconds=time.perf_counter() - t0)
    return lib


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def require(x: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    """Raise unless `x` is a contiguous CUDA tensor of `dtype`."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
