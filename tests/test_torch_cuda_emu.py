"""The fused MXU kernel's CUDA source (`csrc/fused_mxu.cu`), run on the CPU
through an emulation of the CUDA execution model, against the plain
versions, bit for bit.

The source is compiled with the host's g++ against `tests/cuda_emu/
cuda_runtime.h` (one thread per CUDA thread, a block barrier, shared memory
per block, the int8 `mma.sync` tile from its lanes' fragments), after three
textual rewrites: launches, the inline mma asm, the dynamic shared-memory
declaration.  The launches go through the port's own wrappers
(`_product_launch`, `_block_step_launch`), so their layout formula, tile and
arguments are the ones the card gets; only `_lib`'s loader, stream and
device check are replaced.  Small shapes: the specialised instances of the
gate and keyswitch shapes, the runtime-shaped instance at N 256 / 512, and
the parent design.  It says nothing of speed, and the `cuda` tests of
tests/test_torch_mxu_tiles.py remain the check on the card.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from poulpy_tpu_torch.backends import _lib
from poulpy_tpu_torch.backends import fused_mxu as tfm
from poulpy_tpu_torch.hal.module import get_module as t_get_module

EMU = Path(__file__).resolve().parent / "cuda_emu"
CSRC = Path(__file__).resolve().parents[1] / "poulpy_tpu_torch" / "csrc"


def _rewrite(src: str) -> str:
    src = re.sub(r"(\w+(?:<[^<>]*>)?)<<<([^>]*)>>>\(",
                 lambda m: f"emu_launch({m.group(1)}, {m.group(2)}, ", src)
    src = re.sub(r"asm volatile\(.*?\);", "emu_mma_s8(c, a, b);", src, flags=re.S)
    return re.sub(r"extern __shared__ __align__\(16\) (\w+) smem\[\];",
                  r"\1* const smem = (\1*)emu_dyn_smem;", src)


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("cuda_emu")
    for f in [CSRC / "fused_mxu.cu", *CSRC.glob("*.cuh")]:
        (out / f.name).write_text(_rewrite(f.read_text()))
    so = out / "libfused_mxu_emu.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-pthread", "-w", f"-I{EMU}",
                    f"-I{out}", "-x", "c++", "-o", str(so), str(out / "fused_mxu.cu")],
                   check=True)
    lib = ctypes.CDLL(str(so))
    for name in ("poulpy_fused_mxu_product", "poulpy_fused_mxu_tile"):
        getattr(lib, name).argtypes = _lib._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


@pytest.fixture
def emulated(emu_lib, monkeypatch):
    monkeypatch.setattr(_lib, "library", lambda: emu_lib)
    monkeypatch.setattr(_lib, "stream", lambda: 0)
    monkeypatch.setattr(_lib, "require", lambda x, name, dtype: None)


def _residues(rng, primes, shape):
    out = np.zeros(shape, dtype=np.int64)
    for i, p in enumerate(primes):
        out[..., i, :] = rng.integers(0, p, size=shape[:-2] + shape[-1:])
    return torch.from_numpy(out.astype(np.int32))


def _limbs(rng, shape):
    """int64 limbs, those of the first ciphertext's first row past int32."""
    x = torch.from_numpy(rng.integers(-(2**16), 2**16, size=shape))
    x[0, 0, 0, :4] += torch.tensor([2**33, -(2**35), 2**31, -(2**31) - 1])
    return x


@pytest.mark.parametrize("n,nprimes,prime_bits,batch,block,design,tile", [
    (1024, 2, 28, 3, 8, "tile", 2),     # the gate shape: its specialised instance
    (256, 2, 28, 5, 2, "tile", 4),      # the runtime-shaped instance, a partial tile
    (256, 3, 30, 3, 4, "tile", 3),
    (256, 2, 28, 2, 2, "parent", 1),
])
def test_emulated_block_step_matches_plain(emulated, n, nprimes, prime_bits, batch, block,
                                           design, tile):
    m = t_get_module(n, nprimes, prime_bits, "cpu")
    rng = np.random.default_rng(81)
    acc = _limbs(rng, (batch, 2, 2, n))
    pmats = _residues(rng, m.basis.primes, (block, 4, 2, 2, 4, nprimes, n))
    amounts = torch.from_numpy(rng.integers(-n, 3 * n, size=(batch, block)))
    if design == "tile":
        assert tfm.tile_layout(4, 2, 4, nprimes, n, 2, batch, block, split=False).tile == tile
    out, launch = tfm._block_step_launch(m, acc, pmats, amounts, 2, 17, None, design=design)
    launch()
    assert torch.equal(out, tfm.fused_mxu_br_block_step_ref(m, acc, pmats, amounts, 2, 17))


@pytest.mark.parametrize("n,nprimes,prime_bits,batch,ci,s_size,design", [
    (2048, 2, 30, 2, 1, 3, "tile"),     # the keyswitch's shape: its specialised instance
    (512, 3, 30, 3, 2, 0, "tile"),      # the runtime-shaped instance, 3 per block
    (256, 2, 28, 2, 2, 0, "parent"),
])
def test_emulated_product_matches_plain(emulated, n, nprimes, prime_bits, batch, ci, s_size,
                                        design):
    m = t_get_module(n, nprimes, prime_bits, "cpu")
    rng = np.random.default_rng(82)
    a = _limbs(rng, (batch, ci, 3, n))
    pmat = _residues(rng, m.basis.primes, (3, ci, 2, 4, nprimes, n))
    small = torch.from_numpy(rng.integers(-(2**16), 2**16, size=(batch, s_size, n))) if s_size \
        else None
    out, launch = tfm._product_launch(m, a, pmat, 3, 17, 17, small, None, design=design)
    launch()
    assert torch.equal(out, tfm.fused_mxu_glwe_product_ref(m, a, pmat, 3, 17, 17, small))


def test_emulated_stage_clock(emulated):
    """The TIMED instance of the gate shape: the same output, a positive
    count per block and stage."""
    m = t_get_module(1024, 2, 28, "cpu")
    rng = np.random.default_rng(83)
    acc = _limbs(rng, (2, 2, 2, 1024))
    pmats = _residues(rng, m.basis.primes, (8, 4, 2, 2, 4, 2, 1024))
    amounts = torch.from_numpy(rng.integers(-1024, 3072, size=(2, 8)))
    out, stamps = tfm.stage_cycles(m, acc, pmats, amounts, 2, 17, None, block_step=True)
    assert torch.equal(out, tfm.fused_mxu_br_block_step_ref(m, acc, pmats, amounts, 2, 17))
    assert stamps.shape == (1, len(tfm.STAGES)) and bool((stamps > 0).all())
