"""The fused kernels' CUDA sources (`csrc/fused_mxu.cu`, `csrc/fused_product.cu`,
`csrc/br_block_step.cu`), run on the CPU through an emulation of the CUDA
execution model, against the plain versions, bit for bit.

Each source is compiled with the host's g++ against `tests/cuda_emu/
cuda_runtime.h` (one thread per CUDA thread, block and warp barriers,
shared memory per block, the int8 `mma.sync` tile from its lanes'
fragments), after three textual rewrites: launches, the inline mma asm, the
dynamic shared-memory declaration.  The launches go through the port's own
wrappers (`_product_launch`, `_block_step_launch` of `fused_mxu` and of
`fused`), so their layout formula, tile and arguments are the ones the card
gets; only `_lib`'s loader, stream and device check are replaced.  Small
shapes: the specialised instances of the gate, keyswitch and bench shapes,
the runtime-shaped instances at N 256 / 512, and the parent designs.  It
says nothing of speed, and the `cuda` tests of tests/test_torch_mxu_tiles.py
and tests/test_torch_fused_tiles.py remain the check on the card.
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
from poulpy_tpu_torch.backends import fused as tfused
from poulpy_tpu_torch.backends import fused_mxu as tfm
from poulpy_tpu_torch.hal.module import get_module as t_get_module

EMU = Path(__file__).resolve().parent / "cuda_emu"
CSRC = Path(__file__).resolve().parents[1] / "poulpy_tpu_torch" / "csrc"


def _rewrite(src: str) -> str:
    src = re.sub(r"(\w+(?:<[^<>]*>)?)<<<([^>]*)>>>\(",
                 lambda m: f"emu_launch({m.group(1)}, {m.group(2)}, ", src)
    src = re.sub(r"asm volatile\(.*?\);", "emu_mma_s8(c, a, b);", src, flags=re.S)
    return re.sub(r"extern __shared__ (?:__align__\(16\) )?(\w+) smem\[\];",
                  r"\1* const smem = (\1*)emu_dyn_smem;", src)


# the emulated sources and their entry points
SOURCES = {
    "fused_mxu": ("poulpy_fused_mxu_product", "poulpy_fused_mxu_tile"),
    "fused_product": ("poulpy_fused_product", "poulpy_fused_product_lazy"),
    "br_block_step": ("poulpy_br_block_step", "poulpy_br_block_step_lazy"),
}


class _Libs:
    """The emulated libraries' entry points under one name space, as `_lib.library()`'s."""

    def __init__(self, libs):
        for lib, names in libs:
            for name in names:
                fn = getattr(lib, name)
                fn.argtypes = _lib._SIGNATURES[name]
                fn.restype = ctypes.c_int
                setattr(self, name, fn)


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("cuda_emu")
    for f in [*(CSRC / f"{stem}.cu" for stem in SOURCES), *CSRC.glob("*.cuh")]:
        (out / f.name).write_text(_rewrite(f.read_text()))
    builds = {stem: subprocess.Popen(
        [gxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-pthread", "-w", f"-I{EMU}", f"-I{out}",
         "-x", "c++", "-o", str(out / f"lib{stem}_emu.so"), str(out / f"{stem}.cu")])
        for stem in SOURCES}
    for stem, proc in builds.items():
        if proc.wait() != 0:
            raise RuntimeError(f"g++ failed on the emulated {stem}.cu")
    return _Libs((ctypes.CDLL(str(out / f"lib{stem}_emu.so")), names)
                 for stem, names in SOURCES.items())


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


# --------------------------------------------------------------------------
# The butterfly kernels (fused_product.cu, br_block_step.cu): both designs
# --------------------------------------------------------------------------

INT64_EDGES = [-(2**63), 2**63 - 1, -1, 2**62, -(2**62) - 3]


def _edge_limbs(rng, shape, lim=2**16):
    """int64 limbs, the first ciphertext's first row starting with INT64_MIN,
    INT64_MAX and other words far past any prime."""
    x = torch.from_numpy(rng.integers(-lim, lim, size=shape))
    x[0, 0, 0, :len(INT64_EDGES)] = torch.tensor(INT64_EDGES)
    return x


@pytest.mark.parametrize(
    "n,nprimes,prime_bits,batch,ci,rows,size_a,psize,res_size,s_size,s64,dsize,design,cpb", [
        (2048, 2, 28, 1, 2, 3, 3, 4, 3, 0, 0, 1, "lazy", 2),    # bench.py's shape: ProductShape
        (1024, 2, 28, 2, 1, 2, 2, 3, 2, 2, 0, 1, "lazy", 2),    # the gate keyswitch: GateKsShape
        (256, 2, 28, 3, 1, 3, 3, 4, 3, 3, 0, 1, "lazy", 2),     # small, runtime-shaped
        (512, 5, 30, 2, 1, 3, 3, 4, 6, 0, 6, 1, "lazy", 2),     # small64, s64 > psize, P 5
        (256, 1, 30, 2, 2, 4, 3, 4, 3, 0, 0, 1, "lazy", 2),     # P 1, rows > size_a
        (256, 8, 28, 1, 1, 2, 4, 3, 4, 4, 0, 2, "lazy", 2),     # P 8, dsize 2
        (256, 2, 28, 2, 1, 6, 6, 10, 6, 6, 0, 1, "lazy", 1),    # a column per block
        (256, 2, 28, 2, 2, 3, 3, 4, 3, 0, 0, 1, "parent", 2),
    ])
def test_emulated_fused_product_matches_plain(emulated, n, nprimes, prime_bits, batch, ci, rows,
                                              size_a, psize, res_size, s_size, s64, dsize,
                                              design, cpb):
    m = t_get_module(n, nprimes, prime_bits, "cpu")
    rng = np.random.default_rng(84)
    a = _edge_limbs(rng, (batch, ci, size_a, n))
    pmat = _residues(rng, m.basis.primes, (rows, ci, 2, psize, nprimes, n))
    small = torch.from_numpy(rng.integers(-(2**40), 2**40, size=(batch, s_size, n))) if s_size \
        else None
    small64 = torch.from_numpy(rng.integers(-(2**62), 2**62, size=(batch, 2, s64, n))) if s64 \
        else None
    kk = ci * min(rows * dsize, size_a)
    lay = tfused.butterfly_layout(kk, 2, psize, nprimes, n, res_size, design=design)
    assert (lay.kind, lay.cpb) == ("lazy" if design == "lazy" else "shared", cpb)
    out, launch = tfused._product_launch(m, a, pmat, res_size, 17, 17, dsize, small, small64,
                                         design=design)
    launch()
    assert torch.equal(out, tfused.fused_glwe_product_ref(m, a, pmat, res_size, 17, 17, dsize,
                                                          small, small64))


@pytest.mark.parametrize("n,nprimes,prime_bits,batch,block,design,tile", [
    (1024, 2, 28, 3, 8, "lazy", 2),     # the gate shape: GateShape, a partial tile
    (256, 2, 28, 1, 1, "lazy", 1),      # runtime-shaped, one key element
    (512, 3, 30, 3, 8, "lazy", 1),
    (256, 2, 28, 2, 2, "parent", 1),
])
def test_emulated_br_block_step_matches_plain(emulated, n, nprimes, prime_bits, batch, block,
                                              design, tile):
    m = t_get_module(n, nprimes, prime_bits, "cpu")
    rng = np.random.default_rng(85)
    acc = _edge_limbs(rng, (batch, 2, 2, n))
    pmats = _residues(rng, m.basis.primes, (block, 4, 2, 2, 4, nprimes, n))
    amounts = torch.from_numpy(rng.integers(-n, 3 * n, size=(batch, block)))
    lay = tfused.butterfly_layout(4, 2, 4, nprimes, n, 2, block, split=False, design=design)
    assert (lay.kind, lay.tile) == ("lazy" if design == "lazy" else "shared", tile)
    out, launch = tfused._block_step_launch(m, acc, pmats, amounts, 2, 17, design=design)
    launch()
    assert torch.equal(out, tfused.fused_br_block_step_ref(m, acc, pmats, amounts, 2, 17))


@pytest.mark.parametrize("design", ["lazy", "parent"])
def test_emulated_butterfly_stage_clock(emulated, design):
    """The TIMED instances of both designs at a small product and block step:
    the same output as the plain version, a positive count per block and
    stage."""
    m = t_get_module(256, 2, 28, "cpu")
    rng = np.random.default_rng(86)
    a = _edge_limbs(rng, (3, 2, 3, 256))
    pmat = _residues(rng, m.basis.primes, (3, 2, 2, 4, 2, 256))
    out, stamps = tfused.stage_cycles(m, a, pmat, 3, 17, 17, design=design)
    assert torch.equal(out, tfused.fused_glwe_product_ref(m, a, pmat, 3, 17, 17))
    assert stamps.shape == (3, len(tfused.STAGES)) and bool((stamps > 0).all())
    acc = a[:, :, :2]
    pmats = _residues(rng, m.basis.primes, (2, 4, 2, 2, 4, 2, 256))
    amounts = torch.from_numpy(rng.integers(-256, 768, size=(3, 2)))
    out, stamps = tfused.stage_cycles(m, acc, pmats, amounts, 2, 17, block_step=True,
                                      design=design)
    assert torch.equal(out, tfused.fused_br_block_step_ref(m, acc, pmats, amounts, 2, 17))
    assert stamps.shape == (3, len(tfused.STAGES)) and bool((stamps > 0).all())
