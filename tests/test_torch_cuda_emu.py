"""The CUDA sources of the fused kernels (`csrc/fused_mxu.cu`,
`csrc/fused_product.cu`, `csrc/fused_product_tile.cu`, `csrc/br_block_step.cu`,
`csrc/wide_product.cu`),
of the MXU transforms
(`csrc/mxu_ntt.cu`), of the VMP (`csrc/vmp.cu`), of the Garner exit
(`csrc/garner_exit.cu`), of the tensor kernels and of the standalone NTT
(`csrc/ntt.cu`), run on the CPU through an emulation of the CUDA
execution model, against the plain versions, bit for bit.

Each source is compiled with the host's g++ against `tests/cuda_emu/
cuda_runtime.h` (one fiber per CUDA thread, all on the test's own thread,
block and warp barriers, shared memory per block, the int8 `mma.sync` tile
from its lanes' fragments, the warpgroup product `wgmma` from its operands'
documented layouts), after three textual rewrites: launches, the inline asm, the
dynamic shared-memory declaration.  The launches go through the port's own
wrappers (`_product_launch`, `_block_step_launch` of `fused_mxu` and of
`fused`), so their layout formula, tile and arguments are the ones the card
gets; only `_lib`'s loader, stream, device check and SM count (3 here, so
the persistent grid walks several tasks per block) are replaced.  Small
shapes: the specialised instances of the gate, keyswitch and bench shapes,
the runtime-shaped instances at N 256 / 512, both transforms' wg designs
at N 512 … 4096 (ragged tasks, 1 to 4 digit planes, limbs at INT64_MIN /
INT64_MAX, both folds), the exit's specialised and runtime-shaped
instances (P 1 / 5 / 8, psize 16, with and without the body), the wide
product's lazy design (the CKKS-wide mul's instance at N 2048, the
runtime-shaped one at N 256 / 512 with P 2 and 5, ci 2, dsize 2, primes in
passes, a column per block), the TIMED instances, the NTT's lazy design at N 256 … 8192
(ragged blocks, residues 0 and p − 1), and the parent designs.  It
says nothing of speed, and the `cuda` tests of tests/test_torch_mxu_tiles.py,
tests/test_torch_fused_tiles.py and tests/test_torch_transform_tiles.py
remain the check on the card.
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
from poulpy_tpu_torch.backends import fused_sl as tsl
from poulpy_tpu_torch.backends import mxu as tmxu
from poulpy_tpu_torch.backends import ntt as tntt
from poulpy_tpu_torch.backends import vmp as tvmp
from poulpy_tpu_torch.hal.module import get_module as t_get_module
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

EMU = Path(__file__).resolve().parent / "cuda_emu"
CSRC = Path(__file__).resolve().parents[1] / "poulpy_tpu_torch" / "csrc"


# each inline asm by its instruction: the emulated call, or nothing for a
# fence, commit or wait (the emulation runs every copy and product to its end)
_ASM = {"mma.sync": "emu_mma_s8(c, a, b);",
        "wgmma.mma_async": "emu_wgmma_rs(d, a, desc, scale);",
        "cp.async.cg": "emu_cp_async16(dst, src);",
        "bar.sync": "emu_bar_sync(id, nthreads);",
}


def _emu_asm(m: re.Match) -> str:
    if "wgmma.mma_async" in m.group(0) and "desc_a" in m.group(0):
        return "emu_wgmma_ss(d, desc_a, desc_b, scale);"
    return next((call for op, call in _ASM.items() if op in m.group(0)), "")


def _rewrite(src: str) -> str:
    src = re.sub(r"(\w+(?:<[^<>]*>)?)<<<([^>]*)>>>\(",
                 lambda m: f"emu_launch({m.group(1)}, {m.group(2)}, ", src)
    src = re.sub(r"asm volatile\(.*?\);", _emu_asm, src, flags=re.S)
    return re.sub(r"extern __shared__ (?:__align__\(\d+\) )?(\w+) smem\[\];",
                  r"\1* const smem = (\1*)emu_dyn_smem;", src)


# the emulated sources and their entry points
SOURCES = {
    "ntt": ("poulpy_ntt", "poulpy_ntt_lazy"),
    "fused_mxu": ("poulpy_fused_mxu_product", "poulpy_fused_mxu_tile"),
    "fused_product": ("poulpy_fused_product", "poulpy_fused_product_lazy"),
    "fused_product_tile": ("poulpy_fused_product_tile", "poulpy_br_step"),
    "br_block_step": ("poulpy_br_block_step", "poulpy_br_block_step_lazy"),
    "fused_sl": ("poulpy_fused_sl", "poulpy_fused_sl_split"),
    "mxu_ntt": ("poulpy_mxu_forward", "poulpy_mxu_forward_wg", "poulpy_mxu_inverse",
                "poulpy_mxu_inverse_wg"),
    "vmp": ("poulpy_vmp", "poulpy_vmp_tile"),
    "garner_exit": ("poulpy_garner_exit", "poulpy_garner_exit_tile"),
    "tensor_product": ("poulpy_tensor_product", "poulpy_tensor_product_lazy"),
    "wide_tensor": ("poulpy_wide_tensor", "poulpy_wide_tensor_lazy"),
    "wide_product": ("poulpy_wide_product", "poulpy_wide_product_lazy"),
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
    monkeypatch.setattr(_lib, "sm_count", lambda device: 3)


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
        (1024, 2, 28, 3, 2, 3, 2, 4, 2, 0, 0, 1, "lazy", 2),    # the CBT's blind-rotation key
        (1024, 2, 28, 3, 1, 3, 2, 4, 2, 2, 0, 1, "lazy", 2),    # its trace's: CbtTraceShape
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


@pytest.mark.parametrize("n,design,amounts", [
    (256, "lazy", (0, 255, 256, 511, -7)),              # runtime-shaped
    (1024, "lazy", (2047, -1021, 1024)),                # CbtShape
    (1024, "runtime", (1023, 0, -1024)),                # the runtime-shaped one it replaces
    (256, "parent", (-256, 3, 1023)),
])
def test_emulated_br_step_matches_plain(emulated, n, design, amounts):
    """The standard blind-rotation step (the product with the STEP exit) at
    the CBT's key shape against its plain version, the accumulator's limbs
    at INT64_MIN / INT64_MAX, amounts of either sign and past N read through
    a strided view."""
    m = t_get_module(n, 2, 28, "cpu")
    rng = np.random.default_rng(87)
    batch = len(amounts)
    acc = _edge_limbs(rng, (batch, 2, 2, n), 2**40)
    pmat = _residues(rng, m.basis.primes, (3, 2, 2, 4, 2, n))
    lwe_2n = torch.from_numpy(rng.integers(-n, n, size=(batch, 3)))
    lwe_2n[:, 1] = torch.tensor(amounts)
    lay = tfused.butterfly_layout(4, 2, 4, 2, n, 2, design="parent" if design == "parent"
                                  else "lazy", step=True)
    assert (lay.kind, lay.tile) == ("shared" if design == "parent" else "lazy", 1)
    out, launch = tfused._product_launch(m, acc, pmat, 2, 13, 13, design=design,
                                         amounts=lwe_2n[:, 1])
    launch()
    assert torch.equal(out, tfused.fused_br_step_ref(m, acc, pmat, lwe_2n[:, 1], 2, 13))


@pytest.mark.parametrize("n", [256, 1024])
def test_emulated_br_steps_match_plain(emulated, n):
    """The standard blind rotation's loop of steps, one launch each into two
    buffers in turn, the key and the amounts read at each step's offset:
    the plain steps' result, runtime-shaped (N 256) and at CbtShape."""
    m = t_get_module(n, 2, 28, "cpu")
    rng = np.random.default_rng(88)
    acc = _edge_limbs(rng, (2, 2, 2, n), 2**20)
    pmats = _residues(rng, m.basis.primes, (3, 3, 2, 2, 4, 2, n))
    lwe_2n = torch.from_numpy(rng.integers(-n, n + 1, size=(2, 4)))
    want = acc
    for i in range(3):
        want = tfused.fused_br_step_ref(m, want, pmats[i], lwe_2n[:, i + 1], 2, 13)
    assert torch.equal(tfused._br_steps_launch(m, acc, pmats, lwe_2n, 2, 13), want)


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


@pytest.mark.parametrize("n,nprimes,prime_bits,batch,size,rows,block,steps,tile", [
    (1024, 2, 28, 3, 2, 4, 8, 2, 2),    # the gate's chain: GateShape, a ragged tile
    (256, 2, 28, 2, 3, 3, 3, 2, 1),     # runtime-shaped
    (512, 3, 30, 1, 2, 4, 2, 3, 1),     # runtime-shaped, three steps, one in place
])
def test_emulated_br_block_chain_matches_plain(emulated, n, nprimes, prime_bits, batch, size,
                                               rows, block, steps, tile):
    """The lazy design's chain of `steps` block steps in one launch, its
    accumulator in shared memory between steps: the plain chain's result and
    that of `steps` single plain steps, bit for bit; the TIMED instance too."""
    m = t_get_module(n, nprimes, prime_bits, "cpu")
    rng = np.random.default_rng(89)
    acc = _edge_limbs(rng, (batch, 2, size, n))
    pmats = _residues(rng, m.basis.primes, (steps * block, rows, 2, 2, 4, nprimes, n))
    amounts = torch.from_numpy(rng.integers(-n, 3 * n, size=(batch, steps * block)))
    lay = tfused._block_layout(m, 2 * min(rows, size), 2, 4, size, block, steps, "lazy")
    assert (lay.kind, lay.tile) == ("lazy", tile)
    args = (m, acc, pmats, amounts, size, 17)
    out, launch = tfused._block_step_launch(*args, None, steps)
    launch()
    want = acc
    for st in range(steps):
        keys = slice(st * block, (st + 1) * block)
        want = tfused.fused_br_block_step_ref(m, want, pmats[keys], amounts[:, keys], size, 17)
    assert torch.equal(out, want)
    assert torch.equal(out, tfused.fused_br_block_step_ref(*args, steps))
    timed, stamps = tfused.stage_cycles(*args, None, steps, block_step=True)
    assert torch.equal(timed, want)
    assert stamps.shape == (-(-batch // tile), len(tfused.STAGES)) and bool((stamps > 0).all())


@pytest.mark.parametrize("n,design", [(4096, "lazy"), (256, "parent")])
def test_emulated_br_block_chain_refused_outside_lazy_design(emulated, n, design):
    """The global layout (N 4096) and the parent design run one block step
    per launch: a chain there raises (as one whose steps do not divide the
    key elements), and the chain's layout is the lazy design's only up to N
    2048, where `chain_steps` lets the blind rotation chain on CUDA."""
    m = t_get_module(n, 2, 28, "cpu")
    rng = np.random.default_rng(90)
    acc = _edge_limbs(rng, (1, 2, 2, n))
    pmats = _residues(rng, m.basis.primes, (4, 4, 2, 2, 4, 2, n))
    amounts = torch.from_numpy(rng.integers(-n, n, size=(1, 4)))
    with pytest.raises(ValueError, match="lazy design only"):
        tfused._block_step_launch(m, acc, pmats, amounts, 2, 17, None, 2, design=design)
    with pytest.raises(ValueError, match="does not divide"):
        tfused._block_step_launch(m, acc, pmats[:3], amounts[:, :3], 2, 17, None, 2)
    lay = tfused._block_layout(m, 4, 2, 4, 2, 2, 2, "lazy")
    assert (lay.kind == "lazy") == (n <= 2048)


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


@pytest.mark.parametrize("n,batch,size,rows,block,steps,tile", [
    (1024, 3, 2, 4, 8, 1, 2),     # the gate's and the CBT's step: GateShape, a ragged tile
    (1024, 3, 2, 4, 8, 2, 2),     # their chain
    (256, 2, 3, 3, 7, 1, 1),      # fheuint_prepare's block 7 (KK 6, res 3): runtime-shaped
    (256, 2, 3, 3, 7, 2, 1),      # its chain
])
def test_emulated_br_block_step_shoup_matches_plain(emulated, n, batch, size, rows, block, steps,
                                                    tile):
    """The lazy design's Shoup instances (rot_mode 1: the x-power from the
    two-plane table by Shoup's product), single and chained, against the
    plain rot_mode 1 step and the plain default one, bit for bit; the
    launch counted as a Shoup instance."""
    m = t_get_module(n, 2, 28, "cpu")
    rng = np.random.default_rng(91)
    acc = _edge_limbs(rng, (batch, 2, size, n))
    pmats = _residues(rng, m.basis.primes, (steps * block, rows, 2, 2, 4, 2, n))
    amounts = torch.from_numpy(rng.integers(-n, 3 * n, size=(batch, steps * block)))
    amounts[0, :3] = torch.tensor([-n, 2 * n - 1, 0])
    lay = tfused._block_layout(m, 2 * min(rows, size), 2, 4, size, block, steps, "lazy")
    assert (lay.kind, lay.tile) == ("lazy", tile)
    args = (m, acc, pmats, amounts, size, 17)
    out, launch = tfused._block_step_launch(*args, None, steps, rot_mode=1)
    assert launch.counter == ("br_block_chain_shoup" if steps > 1 else "br_block_step_shoup")
    launch()
    assert torch.equal(out, tfused.fused_br_block_step_ref(*args, steps, rot_mode=1))
    assert torch.equal(out, tfused.fused_br_block_step_ref(*args, steps))


# --------------------------------------------------------------------------
# The split layout's kernel (fused_sl.cu): every flag combination
# --------------------------------------------------------------------------

@pytest.mark.parametrize(
    "n,nprimes,prime_bits,batch,ci,rows,size_a,psize,res_size,s_size,s64,dsize,cpb", [
        (256, 2, 28, 2, 2, 3, 3, 4, 3, 0, 0, 1, 2),      # the product
        (512, 2, 28, 2, 1, 3, 3, 4, 3, 3, 0, 1, 2),      # small
        (256, 5, 30, 2, 1, 3, 3, 4, 6, 0, 6, 1, 2),      # small64, s64 > psize, P 5
        (512, 2, 28, 2, 1, 2, 4, 3, 4, 4, 0, 2, 2),      # dsize 2
        (128, 1, 30, 3, 2, 2, 2, 2, 2, 0, 0, 1, 2),      # N 128, P 1
        (2048, 2, 28, 1, 2, 3, 3, 4, 3, 0, 0, 1, 2),     # bench.py's product
        (1024, 2, 28, 2, 1, 2, 2, 3, 2, 2, 0, 1, 2),     # the gate's keyswitch
        (2048, 4, 28, 1, 1, 6, 6, 6, 6, 6, 0, 1, 1),     # a column per block
    ])
def test_emulated_fused_sl_product_matches_plain(emulated, n, nprimes, prime_bits, batch, ci,
                                                 rows, size_a, psize, res_size, s_size, s64,
                                                 dsize, cpb):
    """The split layout's product, `small` and `small64` patterns, both
    designs, against their plain version and the default pipeline's plain
    version, bit for bit, limbs at INT64_MIN / INT64_MAX; `cpb` the parent's
    columns per block."""
    m = t_get_module(n, nprimes, prime_bits, "cpu")
    rng = np.random.default_rng(92)
    a = _edge_limbs(rng, (batch, ci, size_a, n))
    pmat = _residues(rng, m.basis.primes, (rows, ci, 2, psize, nprimes, n))
    small = torch.from_numpy(rng.integers(-(2**40), 2**40, size=(batch, s_size, n))) if s_size \
        else None
    small64 = torch.from_numpy(rng.integers(-(2**62), 2**62, size=(batch, 2, s64, n))) if s64 \
        else None
    kk = ci * min(rows * dsize, size_a)
    assert tsl.sl_layout(kk, 2, psize, nprimes, n, design="parent").cpb == cpb
    want = tsl.fused_glwe_product_sl_ref(m, a, pmat, res_size, 17, 17, dsize, small, small64)
    assert torch.equal(want, tfused.fused_glwe_product_ref(m, a, pmat, res_size, 17, 17, dsize,
                                                           small, small64))
    for design in tsl.DESIGNS:
        out, launch = tsl._sl_product_launch(m, a, pmat, res_size, 17, 17, dsize, small, small64,
                                             design=design)
        launch()
        assert torch.equal(out, want), design


@pytest.mark.parametrize("n,nprimes,prime_bits,batch,size,rows,block,rot_mode", [
    (256, 2, 28, 2, 2, 4, 3, 0),
    (256, 2, 28, 2, 2, 4, 3, 1),
    (256, 2, 28, 2, 2, 4, 3, 2),
    (512, 3, 30, 2, 3, 3, 2, 0),       # 30-bit primes: rot_mode 0 only
    (1024, 2, 28, 2, 2, 4, 8, 1),      # the gate's block step
    (1024, 2, 28, 2, 2, 4, 8, 2),
])
def test_emulated_fused_sl_block_step_matches_plain(emulated, n, nprimes, prime_bits, batch,
                                                    size, rows, block, rot_mode):
    """The split layout's block step under each rot_mode, both designs,
    against its plain version and the default plain step, bit for bit."""
    m = t_get_module(n, nprimes, prime_bits, "cpu")
    rng = np.random.default_rng(93)
    acc = _edge_limbs(rng, (batch, 2, size, n))
    pmats = _residues(rng, m.basis.primes, (block, rows, 2, 2, 4, nprimes, n))
    amounts = torch.from_numpy(rng.integers(-n, 3 * n, size=(batch, block)))
    args = (m, acc, pmats, amounts, size, 17)
    want = tsl.fused_br_block_step_sl_ref(*args, 1, rot_mode)
    assert torch.equal(want, tfused.fused_br_block_step_ref(*args))
    for design in tsl.DESIGNS:
        out, launch = tsl._sl_block_step_launch(*args, None, rot_mode, design)
        launch()
        assert torch.equal(out, want), design


@pytest.mark.parametrize("n,nprimes,prime_bits,batch,ci,rows,size_a,psize,res_size,extra,tile", [
    (128, 1, 30, 7, 2, 2, 2, 2, 2, 0, 4),       # the product, one warp per row: 4 + a ragged 3
    (256, 2, 28, 5, 2, 3, 3, 4, 3, 0, 4),       # two warps per row
    (512, 2, 28, 5, 1, 3, 3, 4, 3, -3, 3),      # small: 3 + a ragged 2
    (1024, 2, 28, 3, 1, 2, 2, 3, 2, -2, 2),     # the gate's keyswitch: 2 + 1
    (256, 5, 30, 3, 1, 3, 3, 4, 6, 6, 2),       # small64, s64 > psize, P 5
    (2048, 2, 28, 3, 1, 3, 3, 1, 3, 2, 2),      # small64 at N 2048: 2 + 1
])
def test_emulated_fused_sl_split_tiles(emulated, n, nprimes, prime_bits, batch, ci, rows, size_a,
                                       psize, res_size, extra, tile):
    """The split design's product patterns with `tile` ciphertexts per block
    and a ragged last tile (`extra` < 0: a body of −extra limbs; > 0:
    small64 of extra limbs): == the plain version, bit for bit."""
    m = t_get_module(n, nprimes, prime_bits, "cpu")
    rng = np.random.default_rng(105)
    a = _edge_limbs(rng, (batch, ci, size_a, n))
    pmat = _residues(rng, m.basis.primes, (rows, ci, 2, psize, nprimes, n))
    kw = {}
    if extra < 0:
        kw["small"] = torch.from_numpy(rng.integers(-(2**40), 2**40, size=(batch, -extra, n)))
    elif extra:
        kw["small64"] = torch.from_numpy(rng.integers(-(2**62), 2**62, size=(batch, 2, extra, n)))
    lay = tsl.sl_layout(ci * min(rows, size_a), 2, psize, nprimes, n)
    assert (lay.kind, lay.tile) == ("split", tile)
    out, launch = tsl._sl_product_launch(m, a, pmat, res_size, 17, 17, **kw)
    launch()
    assert torch.equal(out, tsl.fused_glwe_product_sl_ref(m, a, pmat, res_size, 17, 17, **kw))


@pytest.mark.parametrize("n,nprimes,prime_bits,batch,size,rows,psize,block,rot_mode,tile", [
    (128, 2, 28, 5, 2, 4, 4, 3, 0, 4),
    (256, 2, 28, 5, 2, 4, 4, 3, 1, 4),
    (512, 3, 30, 3, 3, 3, 4, 2, 0, 2),      # 30-bit primes: rot_mode 0 only
    (512, 2, 28, 5, 2, 4, 4, 2, 2, 3),
    (1024, 2, 28, 4, 3, 2, 2, 3, 1, 3),     # rows 2 < size: KK 4, M 4
])
def test_emulated_fused_sl_split_block_step_tiles(emulated, n, nprimes, prime_bits, batch, size,
                                                  rows, psize, block, rot_mode, tile):
    """The split design's block step under each rot_mode with `tile`
    ciphertexts per block and a ragged last tile: == the plain step."""
    m = t_get_module(n, nprimes, prime_bits, "cpu")
    rng = np.random.default_rng(106)
    acc = _edge_limbs(rng, (batch, 2, size, n))
    pmats = _residues(rng, m.basis.primes, (block, rows, 2, 2, psize, nprimes, n))
    amounts = torch.from_numpy(rng.integers(-n, 3 * n, size=(batch, block)))
    amounts[0, :2] = torch.tensor([2 * n - 1, -n])
    args = (m, acc, pmats, amounts, size, 17)
    lay = tsl.sl_layout(2 * min(rows, size), 2, psize, nprimes, n, block, split=False)
    assert (lay.kind, lay.tile) == ("split", tile)
    out, launch = tsl._sl_block_step_launch(*args, None, rot_mode)
    launch()
    assert torch.equal(out, tsl.fused_br_block_step_sl_ref(*args, 1, rot_mode))


def test_emulated_fused_sl_split_global(emulated, monkeypatch):
    """The split design's global layout at N 4096 (a workspace slot per
    block, the exchange through a shared slot per row group, one block
    walking three tasks): the product with its body and the block step,
    == the plain versions; the parent design refuses N 4096."""
    monkeypatch.setattr(_lib, "sm_count", lambda device: 1)
    m = t_get_module(4096, 2, 28, "cpu")
    rng = np.random.default_rng(107)
    a = _edge_limbs(rng, (3, 1, 2, 4096))
    pmat = _residues(rng, m.basis.primes, (2, 1, 2, 3, 2, 4096))
    small = torch.from_numpy(rng.integers(-(2**40), 2**40, size=(3, 2, 4096)))
    assert tsl.sl_layout(2, 2, 3, 2, 4096).kind == "global"
    out, launch = tsl._sl_product_launch(m, a, pmat, 2, 17, 17, small=small)
    launch()
    assert torch.equal(out, tsl.fused_glwe_product_sl_ref(m, a, pmat, 2, 17, 17, small=small))
    acc = _edge_limbs(rng, (2, 2, 2, 4096))
    pmats = _residues(rng, m.basis.primes, (2, 2, 2, 2, 2, 2, 4096))
    amounts = torch.from_numpy(rng.integers(-4096, 3 * 4096, size=(2, 2)))
    args = (m, acc, pmats, amounts, 2, 17)
    out, launch = tsl._sl_block_step_launch(*args, None, 2)
    launch()
    assert torch.equal(out, tsl.fused_br_block_step_sl_ref(*args, 1, 2))
    with pytest.raises(ValueError, match="parent design does not take N 4096"):
        tsl._sl_block_step_launch(*args, None, 2, "parent")


@pytest.mark.parametrize("design", ["split", "parent"])
def test_emulated_fused_sl_stage_clock(emulated, design):
    """The TIMED instances of both designs at N 1024 (the product with its
    body, the block step): the untimed output, a positive count per block
    and stage; other N refuse the stage clock."""
    m = t_get_module(1024, 2, 28, "cpu")
    rng = np.random.default_rng(108)
    a = _edge_limbs(rng, (3, 1, 2, 1024))
    pmat = _residues(rng, m.basis.primes, (2, 1, 2, 3, 2, 1024))
    small = torch.from_numpy(rng.integers(-(2**40), 2**40, size=(3, 2, 1024)))
    out, stamps = tsl.stage_cycles(m, a, pmat, 2, 17, 17, small=small, design=design)
    assert torch.equal(out, tsl.fused_glwe_product_sl_ref(m, a, pmat, 2, 17, 17, small=small))
    tile = tsl.sl_layout(2, 2, 3, 2, 1024, design=design).tile
    assert stamps.shape == (-(-3 // tile), len(tfused.STAGES)) and bool((stamps > 0).all())
    acc = _edge_limbs(rng, (2, 2, 2, 1024))
    pmats = _residues(rng, m.basis.primes, (2, 2, 2, 2, 4, 2, 1024))
    amounts = torch.from_numpy(rng.integers(-1024, 3072, size=(2, 2)))
    args = (m, acc, pmats, amounts, 2, 17)
    out, stamps = tsl.stage_cycles(*args, block_step=True, design=design)
    assert torch.equal(out, tsl.fused_br_block_step_sl_ref(*args))
    tile = tsl.sl_layout(4, 2, 4, 2, 1024, 2, split=False, design=design).tile
    assert stamps.shape == (-(-2 // tile), len(tfused.STAGES)) and bool((stamps > 0).all())
    small_m = t_get_module(512, 2, 28, "cpu")
    with pytest.raises(ValueError, match="stage clock"):
        tsl.stage_cycles(small_m, a[..., :512], pmat[..., :512], 2, 17, 17, design=design)


@pytest.mark.parametrize("rot_mode", [None, 0, 1])
def test_emulated_fused_sl_wide_column(emulated, rot_mode):
    """A column group of more output rows than the split design's VMP sums
    in one pass (the product's psize 10, the block step's 2 × 5 > SPLIT_MR):
    the outputs go after the inputs, two passes; both designs == the plain
    version (rot_mode None: the product)."""
    m = t_get_module(256, 2, 28, "cpu")
    rng = np.random.default_rng(111)
    if rot_mode is None:
        a = _edge_limbs(rng, (2, 1, 3, 256))
        pmat = _residues(rng, m.basis.primes, (3, 1, 2, 10, 2, 256))
        args = (m, a, pmat, 4, 17, 17)
        launch_fn, want = tsl._sl_product_launch, tsl.fused_glwe_product_sl_ref(*args)
        kw = {}
    else:
        acc = _edge_limbs(rng, (2, 2, 2, 256))
        pmats = _residues(rng, m.basis.primes, (2, 2, 2, 2, 5, 2, 256))
        amounts = torch.from_numpy(rng.integers(-256, 3 * 256, size=(2, 2)))
        args = (m, acc, pmats, amounts, 2, 17)
        launch_fn, want = tsl._sl_block_step_launch, tsl.fused_br_block_step_sl_ref(*args, 1,
                                                                                     rot_mode)
        kw = {"rot_mode": rot_mode}
    for design in tsl.DESIGNS:
        out, launch = launch_fn(*args, design=design, **kw)
        launch()
        assert torch.equal(out, want), design


def _fused_sl_mutant(tmp_path, monkeypatch, old: str, new: str) -> None:
    """Build fused_sl.cu against a copy of the emulation's header with `old`
    replaced by `new`, and make it the library the wrappers call."""
    gxx = shutil.which("g++")
    header = (EMU / "cuda_runtime.h").read_text()
    assert old in header
    (tmp_path / "cuda_runtime.h").write_text(header.replace(old, new))
    for f in [CSRC / "fused_sl.cu", *CSRC.glob("*.cuh")]:
        (tmp_path / f.name).write_text(_rewrite(f.read_text()))
    so = tmp_path / "libfused_sl_mut.so"
    subprocess.run([gxx, "-std=c++17", "-O0", "-fPIC", "-shared", "-w", f"-I{tmp_path}", "-x",
                    "c++", "-o", str(so), str(tmp_path / "fused_sl.cu")], check=True)
    monkeypatch.setattr(_lib, "library", lambda: _Libs([(ctypes.CDLL(str(so)),
                                                         SOURCES["fused_sl"])]))


def _fused_sl_product_case(seed: int, n: int = 256):
    m = t_get_module(n, 2, 28, "cpu")
    rng = np.random.default_rng(seed)
    a = _edge_limbs(rng, (1, 2, 3, n))
    pmat = _residues(rng, m.basis.primes, (3, 2, 2, 4, 2, n))
    return m, a, pmat, tsl.fused_glwe_product_sl_ref(m, a, pmat, 3, 17, 17)


def test_emulated_shuffle_read_before_write_fails(emulated, tmp_path, monkeypatch):
    """The emulation's warp shuffle is what makes fused_sl.cu right: built
    against a copy of the header whose shuffle reads the partner's slot
    before the warp's first barrier (before the partner has written it),
    neither design equals its plain version any more."""
    published = "  memcpy(&emu_shfl[w][lane], &v, sizeof(T));\n  emu_warp_bar[w].wait();\n"
    _fused_sl_mutant(tmp_path, monkeypatch, published,
                     "  memcpy(&emu_shfl[w][lane], &v, sizeof(T));\n")
    m, a, pmat, want = _fused_sl_product_case(94)
    for design in tsl.DESIGNS:
        out, launch = tsl._sl_product_launch(m, a, pmat, 3, 17, 17, design=design)
        launch()
        assert not torch.equal(out, want), design


def test_emulated_group_barrier_removed_fails(emulated, tmp_path, monkeypatch):
    """The split design's exchange waits on its row group's named barrier
    alone: built against a copy of the header whose `bar.sync id, n` returns
    at once, the split design reads its rows before the group has written
    them (at N 512 and 4096) and no longer equals its plain version, while
    the parent design, which has no named barrier, still does."""
    _fused_sl_mutant(tmp_path, monkeypatch, "  if (b.count == 0) b.n = n;\n  b.wait();\n", "")
    m, a, pmat, want = _fused_sl_product_case(109, 512)
    out, launch = tsl._sl_product_launch(m, a, pmat, 3, 17, 17, design="parent")
    launch()
    assert torch.equal(out, want)
    out, launch = tsl._sl_product_launch(m, a, pmat, 3, 17, 17)
    launch()
    assert not torch.equal(out, want)
    m, a, pmat, want = _fused_sl_product_case(110, 4096)
    out, launch = tsl._sl_product_launch(m, a, pmat, 3, 17, 17)
    launch()
    assert not torch.equal(out, want)


# --------------------------------------------------------------------------
# The MXU inverse (mxu_ntt.cu, both designs) and the VMP (vmp.cu, both designs)
# --------------------------------------------------------------------------

def _edge_residues(rng, primes, shape):
    """Canonical residues [..., P, N], the first row p − 1 everywhere."""
    x = _residues(rng, primes, shape)
    x[0] = torch.tensor(primes, dtype=torch.int32)[:, None] - 1
    return x


@pytest.mark.parametrize("n,nprimes,prime_bits,rows,design,split", [
    (512, 2, 28, 19, "wg", True),       # 16 rows per task: a ragged second task, 4 tasks on 3 blocks
    (1024, 3, 30, 5, "wg", False),      # one ragged task per prime; the int64 fold
    (256, 2, 30, 5, "parent", True),    # below the wg design's N: the parent design
    (2048, 1, 28, 3, "parent", True),
])
def test_emulated_mxu_inverse_matches_plain(emulated, monkeypatch, n, nprimes, prime_bits, rows,
                                            design, split):
    monkeypatch.setattr(tmxu, "WG_SPLIT", split)
    m = t_get_module(n, nprimes, prime_bits, "cpu")
    y = _edge_residues(np.random.default_rng(87), m.basis.primes, (rows, nprimes, n))
    out, launch = tmxu._inverse_launch(m.tables, y, design)
    launch()
    assert torch.equal(out, tmxu.mxu4_inverse_ref(m.tables, y))


def _forward_limbs(rng, rows, n):
    """int64 limbs [rows, N], the first row starting with INT64_MIN, INT64_MAX
    and other words far past int32 (the forward wraps them to int32)."""
    x = torch.from_numpy(rng.integers(-(2**40), 2**40, size=(rows, n)))
    x[0, :len(INT64_EDGES)] = torch.tensor(INT64_EDGES)
    x[-1, -3:] = torch.tensor([2**31 - 1, -(2**31), 2**31])
    return x


@pytest.mark.parametrize("n,nprimes,prime_bits,rows,nd_in,design,split", [
    (512, 2, 28, 19, 3, "wg", True),        # 16 rows per task: a ragged second group, 4 tasks
    (1024, 3, 30, 17, 4, "wg", False),      # one row past a group; the int64 fold
    (2048, 2, 28, 9, 3, "wg", True),        # the path's N and planes: 8 rows + 1
    (2048, 1, 30, 5, 1, "wg", True),        # one plane, one ragged task
    (512, 2, 30, 33, 2, "wg", True),        # 6 tasks on 3 blocks
    (4096, 3, 30, 5, 3, "wg", True),        # step A's weights one prime at a time
    (256, 2, 28, 5, 3, "parent", True),     # below the wg design's N: the parent design
    (2048, 1, 28, 3, 4, "parent", True),
])
def test_emulated_mxu_forward_matches_plain(emulated, monkeypatch, n, nprimes, prime_bits, rows,
                                            nd_in, design, split):
    monkeypatch.setattr(tmxu, "WG_SPLIT", split)
    m = t_get_module(n, nprimes, prime_bits, "cpu")
    x = _forward_limbs(np.random.default_rng(90), rows, n)
    out, launch = tmxu._forward_launch(m.tables, x, nd_in, design)
    launch()
    assert torch.equal(out, tmxu.mxu4_forward_limbs_ref(m.tables, x, nd_in))


@pytest.mark.parametrize("n,prime_bits,rows,design", [(2048, 28, 9, "wg"), (512, 30, 5, "parent")])
def test_emulated_mxu_forward_stage_clock(emulated, n, prime_bits, rows, design):
    """The forward's TIMED instances (the wg design's at N 2048, the path
    shape), a ragged task: the same output as the plain version, a positive
    count per block and stage."""
    m = t_get_module(n, 2, prime_bits, "cpu")
    x = _forward_limbs(np.random.default_rng(94), rows, n)
    out, stamps = tmxu.stage_cycles(m.tables, x, design, forward=True, nd_in=3)
    assert torch.equal(out, tmxu.mxu4_forward_limbs_ref(m.tables, x, 3))
    assert stamps.shape[1] == len(tmxu.FWD_STAGES[design]) and bool((stamps > 0).all())


@pytest.mark.parametrize("n,prime_bits,rows,design", [(2048, 30, 9, "wg"), (512, 28, 5, "parent")])
def test_emulated_mxu_inverse_stage_clock(emulated, n, prime_bits, rows, design):
    """The TIMED instances (the wg design's at N 2048, the path shape), a
    ragged task: the same output as the plain version, a positive count per
    block and stage."""
    m = t_get_module(n, 2, prime_bits, "cpu")
    y = _edge_residues(np.random.default_rng(88), m.basis.primes, (rows, 2, n))
    out, stamps = tmxu.stage_cycles(m.tables, y, design)
    assert torch.equal(out, tmxu.mxu4_inverse_ref(m.tables, y))
    assert stamps.shape[1] == len(tmxu.STAGES[design]) and bool((stamps > 0).all())


@pytest.mark.parametrize("n,nprimes,prime_bits,batch,k,mo,min_blocks,design", [
    (256, 2, 28, 5, 6, 8, 1, "tile"),       # RouteShape, 5 rows per block
    (256, 2, 30, 7, 3, 8, 2, "tile"),       # KsShape, a ragged last block
    (256, 2, 28, 3, 6, 12, 528, "tile"),    # CkksShape, one row per block
    (256, 3, 30, 3, 12, 5, 1, "tile"),      # runtime-shaped: one fold at k 8
    (512, 1, 30, 2, 17, 9, 528, "tile"),    # runtime-shaped: two folds, M past one pass
    (256, 2, 30, 3, 12, 5, 528, "parent"),
])
def test_emulated_vmp_matches_plain(emulated, monkeypatch, n, nprimes, prime_bits, batch, k, mo,
                                    min_blocks, design):
    monkeypatch.setattr(tvmp, "TILE_MIN_BLOCKS", min_blocks)
    m = t_get_module(n, nprimes, prime_bits, "cpu")
    rng = np.random.default_rng(89)
    a = _edge_residues(rng, m.basis.primes, (batch, k, nprimes, n))
    pm = _residues(rng, m.basis.primes, (k, mo, nprimes, n))
    pm[:, :, :, :8] = torch.tensor(m.basis.primes, dtype=torch.int32)[:, None] - 1
    want = tvmp.vmp_apply_ref(m, a[:, :, None], pm[None, :, :, None]).reshape(batch, mo, nprimes, n)
    assert torch.equal(tvmp.vmp_kernel(m, a, pm, design=design), want)


# --------------------------------------------------------------------------
# The Garner exit (garner_exit.cu, both designs)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,nprimes,prime_bits,batch,co,psize,res_size,s_size,kr,ka,design", [
    (512, 2, 28, 3, 2, 4, 3, 0, 17, 17, "tile"),     # the product's instance (ProductExit)
    (512, 2, 30, 3, 2, 4, 3, 3, 17, 17, "tile"),     # the keyswitch's (KsExit): the body added
    (256, 1, 30, 2, 2, 3, 4, 2, 17, 17, "tile"),     # runtime-shaped: P 1, res > psize
    (256, 5, 28, 2, 1, 16, 12, 16, 19, 13, "tile"),  # P 5, psize 16, other bases
    (256, 8, 28, 1, 2, 6, 6, 9, 17, 17, "tile"),     # P 8, the body past psize
    (256, 2, 28, 2, 2, 4, 3, 3, 17, 17, "parent"),
])
def test_emulated_garner_exit_matches_plain(emulated, n, nprimes, prime_bits, batch, co, psize,
                                            res_size, s_size, kr, ka, design):
    """Both designs against the plain version; the residues of the first
    ciphertext at p − 1 (the lift's largest value and its centring)."""
    m = t_get_module(n, nprimes, prime_bits, "cpu")
    rng = np.random.default_rng(95)
    x = _edge_residues(rng, m.basis.primes, (batch, co, psize, nprimes, n))
    small = None
    if s_size:
        small = torch.from_numpy(rng.integers(-(2**62), 2**62, size=(batch, s_size, n)))
        small[0, 0, :len(INT64_EDGES)] = torch.tensor(INT64_EDGES)
    out, launch = tfused._exit_launch(m, x, psize, res_size, kr, ka, small, design)
    launch()
    assert torch.equal(out, tfused.garner_exit_ref(m, x, psize, res_size, kr, ka, small))


# --------------------------------------------------------------------------
# The rank-1 tensor kernels (tensor_product.cu, wide_tensor.cu), both designs
# --------------------------------------------------------------------------

def _tensor_operands(rng, batch, size_a, size_b, n, lim):
    """Both operands [batch, 2, size, N], the first row of a starting with
    INT64_MIN, INT64_MAX and other words far past any prime, and b's last row
    ending with them."""
    a = torch.from_numpy(rng.integers(-lim, lim, size=(batch, 2, size_a, n)))
    b = torch.from_numpy(rng.integers(-lim, lim, size=(batch, 2, size_b, n)))
    a[0, 0, 0, :len(INT64_EDGES)] = torch.tensor(INT64_EDGES)
    b[-1, 1, -1, -len(INT64_EDGES):] = torch.tensor(INT64_EDGES)
    return a, b


@pytest.mark.parametrize("n,nprimes,prime_bits,batch,size_a,size_b,dnum,kr,ka,design,pairs", [
    (2048, 2, 28, 2, 6, 6, 6, 17, 17, "lazy", 1),     # the relinearize path's: TensorShape
    (512, 2, 28, 2, 6, 6, 6, 17, 17, "lazy", 3),      # all three pairs, two primes in one pass
    (256, 5, 30, 2, 3, 5, 4, 13, 17, "lazy", 3),      # P 5, other bases, size_a ≠ size_b
    (256, 8, 28, 2, 8, 8, 6, 17, 17, "lazy", 3),      # conv 15, P 8: primes in passes of 5 + 3
    (512, 1, 30, 2, 4, 2, 3, 15, 17, "lazy", 3),      # P 1
    (256, 2, 28, 2, 5, 4, 5, 17, 17, "parent", 0),
])
def test_emulated_tensor_product_matches_plain(emulated, n, nprimes, prime_bits, batch, size_a,
                                               size_b, dnum, kr, ka, design, pairs):
    m = t_get_module(n, nprimes, prime_bits, "cpu")
    a, b = _tensor_operands(np.random.default_rng(96), batch, size_a, size_b, n, 2**40)
    conv = size_a + size_b - 1
    lay = tfused.tensor_design_layout(size_a, size_b, conv, nprimes, n, design)
    assert (lay.kind, lay.pairs) == ("lazy" if design == "lazy" else "shared", pairs)
    (d, lin), launch = tfused._tensor_launch(m, a, b, conv, dnum, kr, ka, design=design)
    launch()
    want = tfused.fused_tensor_product_ref(m, a, b, conv, dnum, kr, ka)
    assert torch.equal(d, want[0]) and torch.equal(lin, want[1])


@pytest.mark.parametrize("n,nprimes,size_a,size_b,pairs", [
    (2048, 2, 6, 6, 1),      # the path's shape, a pair per task, the cross pair in two passes
    (2048, 3, 6, 6, 1),      # every pair in passes (the cross pair in three)
    (512, 5, 2, 2, 1),
])
def test_emulated_tensor_product_pair_tasks(emulated, n, nprimes, size_a, size_b, pairs):
    """The lazy design with a pair per task (forced where all three fit)."""
    m = t_get_module(n, nprimes, 28, "cpu")
    a, b = _tensor_operands(np.random.default_rng(97), 2, size_a, size_b, n, 2**62)
    conv = size_a + size_b - 1
    (d, lin), launch = tfused._tensor_launch(m, a, b, conv, 6, 17, 17, pairs=pairs)
    launch()
    want = tfused.fused_tensor_product_ref(m, a, b, conv, 6, 17, 17)
    assert torch.equal(d, want[0]) and torch.equal(lin, want[1])


def test_emulated_tensor_product_staged(emulated, monkeypatch):
    """The parent design's global layout (shared memory cut so that its
    workspace does not fit): the STAGED instance, 5 rows per pass, the
    blocks walking the tasks."""
    monkeypatch.setattr(tfused, "SMEM_LIMIT", 4 * 256 * 5)
    m = t_get_module(256, 2, 28, "cpu")
    a, b = _tensor_operands(np.random.default_rng(98), 3, 4, 3, 256, 2**40)
    lay = tfused.tensor_design_layout(4, 3, 6, 2, 256)
    assert (lay.kind, lay.chunk, lay.ws_rows) == ("global", 5, 14 + 2 * 6)
    (d, lin), launch = tfused._tensor_launch(m, a, b, 6, 4, 17, 17)
    launch()
    want = tfused.fused_tensor_product_ref(m, a, b, 6, 4, 17, 17)
    assert torch.equal(d, want[0]) and torch.equal(lin, want[1])


@pytest.mark.parametrize("n,nprimes,batch,size_a,size_b,dnum,lin_size,kr,ka,offset,design", [
    (2048, 5, 2, 2, 2, 2, 3, 52, 52, 13, "lazy"),      # the CKKS-wide mul's: WideTensorShape
    (256, 5, 2, 2, 3, 3, 3, 52, 52, -9, "lazy"),       # runtime-shaped
    (512, 3, 2, 3, 3, 2, 4, 44, 52, 13, "lazy"),
    (256, 8, 2, 4, 4, 3, 5, 52, 52, 0, "lazy"),
    (256, 5, 2, 2, 2, 2, 3, 52, 52, 13, "parent"),
])
def test_emulated_wide_tensor_matches_plain(emulated, n, nprimes, batch, size_a, size_b, dnum,
                                            lin_size, kr, ka, offset, design):
    from poulpy_tpu_torch.backends import wide as twide

    m = t_get_module(n, nprimes, 28, "cpu")
    a, b = _tensor_operands(np.random.default_rng(99), batch, size_a, size_b, n, 2**51)
    conv = size_a + size_b - 1
    (d, lin), launch = twide._tensor_wide_launch(m, a, b, conv, dnum, lin_size, kr, ka, offset,
                                                 design=design)
    launch()
    want = twide.fused_tensor_product_wide_ref(m, a, b, conv, dnum, lin_size, kr, ka, offset)
    assert torch.equal(d, want[0]) and torch.equal(lin, want[1])


@pytest.mark.parametrize("design", ["lazy", "parent"])
def test_emulated_tensor_stage_clocks(emulated, design):
    """The TIMED instances of both kernels and both designs: the same output
    as the plain version, a positive count per block and stage."""
    from poulpy_tpu_torch.backends import wide as twide

    m = t_get_module(256, 2, 28, "cpu")
    a, b = _tensor_operands(np.random.default_rng(100), 2, 3, 3, 256, 2**20)
    (d, lin), stamps = tfused.tensor_stage_cycles(m, a, b, 5, 3, 17, 17, design=design)
    want = tfused.fused_tensor_product_ref(m, a, b, 5, 3, 17, 17)
    assert torch.equal(d, want[0]) and torch.equal(lin, want[1])
    assert stamps.shape[1] == len(tfused.TENSOR_STAGES) and bool((stamps > 0).all())
    (d, lin), stamps = twide.tensor_wide_stage_cycles(m, a, b, 5, 2, 3, 52, 52, 13, design=design)
    want = twide.fused_tensor_product_wide_ref(m, a, b, 5, 2, 3, 52, 52, 13)
    assert torch.equal(d, want[0]) and torch.equal(lin, want[1])
    assert stamps.shape[1] == len(tfused.TENSOR_STAGES) and bool((stamps > 0).all())


# --------------------------------------------------------------------------
# The wide fused product (wide_product.cu), both designs
# --------------------------------------------------------------------------

@pytest.mark.parametrize(
    "n,nprimes,batch,ci,rows,size_a,psize,res_size,kr,ka,s_size,offset,dsize,design,cpb", [
        (2048, 5, 1, 1, 2, 2, 3, 2, 52, 52, 3, 0, 1, "lazy", 2),   # the mul's shape: MulShape
        (256, 5, 2, 1, 2, 2, 3, 2, 52, 52, 3, 0, 1, "lazy", 2),    # runtime-shaped, both columns
        (512, 2, 3, 2, 3, 3, 4, 3, 44, 44, 2, -7, 1, "lazy", 2),   # ci 2, P 2
        (256, 5, 2, 1, 2, 4, 3, 2, 52, 52, 0, 13, 2, "lazy", 2),   # dsize 2, no small
        (512, 5, 2, 1, 2, 2, 3, 2, 52, 52, 3, 0, 1, "parent", 2),
        (256, 2, 2, 2, 2, 2, 3, 3, 26, 52, 0, 5, 1, "parent", 2),
    ])
def test_emulated_wide_product_matches_plain(emulated, n, nprimes, batch, ci, rows, size_a,
                                             psize, res_size, kr, ka, s_size, offset, dsize,
                                             design, cpb):
    """Both designs against the plain version, the first limbs at INT64_MIN,
    INT64_MAX and other words far past any prime, the small limbs too."""
    from poulpy_tpu_torch.backends import wide as twide

    m = t_get_module(n, nprimes, 28, "cpu")
    rng = np.random.default_rng(102)
    a = _edge_limbs(rng, (batch, ci, size_a, n), 2**51)
    pmat = _residues(rng, m.basis.primes, (rows, ci, 2, psize, nprimes, n))
    small = None
    if s_size:
        small = torch.from_numpy(rng.integers(-(2**51), 2**51, size=(batch, 2, s_size, n)))
        small[-1, 1, 0, -len(INT64_EDGES):] = torch.tensor(INT64_EDGES)
    kk = ci * min(rows * dsize, size_a)
    lay = twide.wide_design_layout(kk, 2, psize, nprimes, n, design)
    assert (lay.kind, lay.cpb) == ("lazy" if design == "lazy" else "shared", cpb)
    args = (m, a, pmat, res_size, kr, ka, small, offset, dsize)
    out, launch = twide._wide_product_launch(*args, design=design)
    launch()
    assert torch.equal(out, twide.fused_glwe_product_wide_ref(*args))


@pytest.mark.parametrize("nprimes,cap_rows,cpb,passes", [
    (5, 12, 2, 3),      # a ciphertext per block, two primes per pass: 2 + 2 + 1
    (5, 30, 2, 1),      # all five primes at once
    (2, 6, 2, 2),
    (5, 5, 1, 5),       # both columns' 6 rows past 5: a column per block, a prime per pass
])
def test_emulated_wide_product_primes_in_passes(emulated, monkeypatch, nprimes, cap_rows, cpb,
                                                passes):
    """The lazy design with shared memory cut so that its primes run in
    passes through the scratch slot, or its columns split over blocks."""
    from poulpy_tpu_torch.backends import wide as twide

    monkeypatch.setattr(twide, "SMEM_LIMIT", twide.WIDE_STATIC_SMEM + 4 * 256 * cap_rows)
    m = t_get_module(256, nprimes, 28, "cpu")
    rng = np.random.default_rng(103)
    a = _edge_limbs(rng, (2, 1, 2, 256), 2**51)
    pmat = _residues(rng, m.basis.primes, (2, 1, 2, 3, nprimes, 256))
    small = torch.from_numpy(rng.integers(-(2**51), 2**51, size=(2, 2, 3, 256)))
    lay = twide.wide_lazy_layout(2, 2, 3, nprimes, 256)
    assert lay.cpb == cpb and -(-nprimes // (lay.chunk // max(2, 3 * cpb))) == passes
    args = (m, a, pmat, 2, 52, 52, small, 0, 1)
    out, launch = twide._wide_product_launch(*args)
    launch()
    assert torch.equal(out, twide.fused_glwe_product_wide_ref(*args))


@pytest.mark.parametrize("design", ["lazy", "parent"])
def test_emulated_wide_product_stage_clock(emulated, design):
    """The TIMED instances of both designs (a block per ciphertext at N
    256): the same output as the plain version, a positive count per block
    and stage."""
    from poulpy_tpu_torch.backends import wide as twide

    m = t_get_module(256, 5, 28, "cpu")
    rng = np.random.default_rng(104)
    a = _edge_limbs(rng, (2, 1, 2, 256), 2**51)
    pmat = _residues(rng, m.basis.primes, (2, 1, 2, 3, 5, 256))
    small = torch.from_numpy(rng.integers(-(2**51), 2**51, size=(2, 2, 3, 256)))
    args = (m, a, pmat, 2, 52, 52, small, 13)
    out, stamps = twide.wide_product_stage_cycles(*args, design=design)
    assert torch.equal(out, twide.fused_glwe_product_wide_ref(*args))
    assert stamps.shape == (2, len(twide.WIDE_STAGES)) and bool((stamps > 0).all())


# --------------------------------------------------------------------------
# The standalone NTT (ntt.cu, both designs)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,nprimes,prime_bits,rows", [
    (256, 1, 30, 5),        # K 0: 8 rows per block, one ragged block, no barrier
    (256, 5, 28, 2),        # 10 rows: a full block and a ragged one
    (512, 5, 30, 13),       # 4 rows per block: 65 rows, the 17th block ragged
    (1024, 1, 28, 3),       # 2 rows per block: a ragged second block
    (2048, 2, 28, 4),       # the paths' N: a row per block
    (2048, 1, 30, 1),
    (4096, 1, 30, 1),       # K 4: two chunks per warp
    (8192, 2, 28, 1),       # K 5: 32 points per thread, four chunks per warp
])
def test_emulated_ntt_matches_plain(emulated, n, nprimes, prime_bits, rows):
    """Both directions of both designs against the plain version, tolerance
    0, the first row at p − 1 and the last half of the last row at 0, and
    inverse(forward(x)) == x."""
    t = t_get_module(n, nprimes, prime_bits, "cpu").tables
    x = _edge_residues(np.random.default_rng(101), t.basis.primes, (rows, nprimes, n))
    x[-1, -1, n // 2:] = 0
    assert tntt.lazy_layout(rows, nprimes, n).design == "lazy"
    want_f, want_i = tntt.ntt_forward_ref(t, x), tntt.ntt_inverse_ref(t, x)
    for design in tntt.DESIGNS:
        f = tntt._launch(t, x, False, design)
        assert torch.equal(f, want_f), design
        assert torch.equal(tntt._launch(t, x, True, design), want_i), design
        assert torch.equal(tntt._launch(t, f, True, design), x), design
