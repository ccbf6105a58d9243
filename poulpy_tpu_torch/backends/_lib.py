"""Build, load and call the CUDA kernels of `csrc/`.

The sources are compiled at first use with `nvcc` for `sm_90a`, one process
per source, all started together, and linked into one shared library with a
plain C interface, loaded with `ctypes`.  The library goes to
`build/kernels/<hash of the sources>/` at the root of the checkout (listed
in `.gitignore`), so a changed source builds anew and an unchanged one is
built once per checkout.
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
SMEM_LIMIT = 232448     # bytes of shared memory one block may use on sm_90

# name → argument types of each C entry point (all return a cudaError_t)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "poulpy_ntt": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "poulpy_ntt_lazy": [_P] * 4 + [_I] * 7 + [_P],
    "poulpy_vmp": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "poulpy_vmp_tile": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "poulpy_fused_product": [_P] * 7 + [_I] * 15 + [_P, _I, _I, _P, _P],
    "poulpy_fused_product_lazy": [_P] * 7 + [_I] * 15 + [_P, _P],
    "poulpy_fused_product_tile": [_P] * 7 + [_I] * 16 + [_P, _P],
    "poulpy_br_step": [_P] * 7 + [_I] * 11 + [_P, _I, _I, _P, _P],
    "poulpy_br_block_step": [_P] * 7 + [_I] * 11 + [_P, _I, _I, _P, _P],
    "poulpy_br_block_step_lazy": [_P] * 7 + [_I] * 13 + [_P, _P],
    "poulpy_wide_product": [_P] * 6 + [_I] * 15 + [_P, _I, _I, _P, _P],
    "poulpy_wide_product_lazy": [_P] * 7 + [_I] * 16 + [_P, _P],
    "poulpy_wide_tensor": [_P] * 6 + [_I] * 12 + [_P, _I, _I, _P, _P],
    "poulpy_wide_tensor_lazy": [_P] * 7 + [_I] * 14 + [_P, _P],
    "poulpy_tensor_product": [_P] * 7 + [_I] * 10 + [_P, _I, _I, _P, _P],
    "poulpy_tensor_product_lazy": [_P] * 7 + [_I] * 12 + [_P, _P],
    "poulpy_mxu_forward": [_P] * 6 + [_I] * 6 + [_P, _P],
    "poulpy_mxu_forward_wg": [_P] * 7 + [_I] * 5 + [_P, _P],
    "poulpy_mxu_inverse": [_P] * 6 + [_I] * 5 + [_P, _P],
    "poulpy_mxu_inverse_wg": [_P] * 7 + [_I] * 4 + [_P, _P],
    "poulpy_garner_exit": [_P] * 4 + [_I] * 9 + [_P],
    "poulpy_garner_exit_tile": [_P] * 4 + [_I] * 9 + [_P],
    "poulpy_fused_mxu_product": [_P] * 13 + [_I] * 16 + [_P, _I, _I, _P, _P],
    "poulpy_fused_mxu_tile": [_P] * 13 + [_I] * 17 + [_P, _P],
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
        tag = f"tmp{os.getpid()}"
        nvcc = _nvcc()
        # one nvcc per source, all at once, then one link
        objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources]
        procs = [subprocess.Popen([nvcc, "-gencode", ARCH, "-std=c++17", "-O3", "-c",
                                   "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for src, obj in zip(sources, objs)]
        logs = [(src.name, proc.communicate()[0], proc.returncode)
                for src, proc in zip(sources, procs)]
        (out_dir / "nvcc.log").write_text("".join(f"== {name}\n{log}" for name, log, _ in logs))
        failed = [(name, log) for name, log, rc in logs if rc != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed[0][0]}:\n{failed[0][1][-4000:]}")
        tmp = out_dir / f"{tag}.so"
        link = subprocess.run([nvcc, "-gencode", ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr[-4000:]}")
        os.replace(tmp, so)
        for obj in objs:
            obj.unlink()
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


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of the card (the persistent grids' size)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def ptr(x: torch.Tensor | None) -> int | None:
    """The data pointer of `x`, or None (a null pointer) for no tensor."""
    return None if x is None else x.data_ptr()


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
