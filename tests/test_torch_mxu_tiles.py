"""The tile design of the fused MXU kernel (`csrc/fused_mxu.cu`
`fused_mxu_tile_kernel`): its layout formula, and its CUDA launches at the
edges of a tile against the plain versions.

CPU part: `fused_mxu.tile_layout` at every shape the paths of
`chip_smoke.py` launch (ciphertexts per block, shared bytes within the
card's 232,448, the global layout where one ciphertext's rows do not fit),
and the specialised shapes of the Python table against the C++ source.

CUDA part (`-m cuda`, skipped without a card): batches of 1, 3 and not a
multiple of the tile, block 1, 2 and 8, N 512, 1024 and 2048, P 2 and 3
(30-bit primes), with and without the body, input limbs past int32: each
launch equals its plain version bit for bit.  These tests do not touch JAX;
on the machine with the card run them with

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_mxu_tiles.py -q
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from poulpy_tpu_torch.backends import LAUNCHES, reset_launches
from poulpy_tpu_torch.backends import fused as tfused
from poulpy_tpu_torch.backends import fused_mxu as tfm
from poulpy_tpu_torch.hal.module import get_module as t_get_module

CSRC = Path(__file__).resolve().parents[1] / "poulpy_tpu_torch" / "csrc" / "fused_mxu.cu"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (kk, co, psize, P, N, res_size, batch, block, split) → (ciphertexts per block,
# output columns per block) at the shapes the paths of chip_smoke.py launch
PATH_SHAPES = {
    "block_step@gate": ((4, 2, 4, 2, 1024, 2, 1024, 8, False), (2, 2)),
    "product@bench": ((6, 2, 4, 2, 2048, 3, 16384, 0, True), (1, 2)),
    "small@keyswitch": ((3, 2, 4, 2, 2048, 3, 256, 0, True), (1, 2)),
    "small@gate_keyswitch": ((2, 2, 3, 2, 1024, 3, 1024, 0, True), (2, 2)),
    "product@gate_standard": ((4, 2, 4, 2, 1024, 2, 64, 0, True), (2, 2)),
    "block_step@gate_verify": ((4, 2, 4, 2, 1024, 2, 64, 8, False), (2, 2)),
    "small@ckks_keyswitch": ((6, 2, 6, 2, 2048, 6, 256, 0, True), (1, 1)),
}


@pytest.mark.parametrize("name", PATH_SHAPES)
def test_tile_layout_at_path_shapes(name):
    """Every path shape takes the tile design, its bytes by the formula and
    within the card's shared memory, the output columns of the parent
    formula, and the tile of its specialised instance or the most that fit."""
    (kk, co, psize, P, n, res_size, batch, block, split), (tile, cpb) = PATH_SHAPES[name]
    lay = tfm.tile_layout(kk, co, psize, P, n, res_size, batch, block, split)
    assert (lay.kind, lay.tile, lay.cpb) == ("tile", tile, cpb)
    assert lay.smem == tfm.tile_smem_bytes(tile, kk, cpb * psize, P, n, block) <= tfused.SMEM_LIMIT
    assert lay.cpb == tfm.mxu_layout(kk, co, psize, P, n, split).cpb
    if tile < tfm.TILE_MAX:
        assert tfm.tile_smem_bytes(tile + 1, kk, cpb * psize, P, n, block) > tfused.SMEM_LIMIT


def test_tile_bytes_of_the_gate_and_bench_shapes():
    """The gate's block step: two ciphertexts per block in 231,488 B (the
    x-power rows, 64 B; the residues of prime 0, 65,536 B; the staging
    region, 165,888 B); bench.py's product: one, in the parent's 215,040 B."""
    assert tfm.tile_smem_bytes(2, 4, 8, 2, 1024, 8) == 64 + 65536 + 165888 == 231488
    assert tfm.tile_smem_bytes(1, 6, 8, 2, 2048) == tfm.fused_mxu_smem_bytes(6, 8, 2, 2048)
    assert tfm.tile_smem_bytes(1, 4, 8, 2, 1024, 8) == 32 + tfm.fused_mxu_smem_bytes(4, 8, 2, 1024)


@pytest.mark.parametrize("batch,tile", [(1, 1), (2, 2), (3, 3), (1024, 3)])
def test_tile_of_the_runtime_instance(batch, tile):
    """A shape without a specialised instance (the block step at N 512)
    takes the most ciphertexts per block that fit, up to the batch."""
    lay = tfm.tile_layout(4, 2, 4, 2, 512, 2, batch, 8, split=False)
    assert (lay.kind, lay.tile) == ("tile", tile)
    assert tfm.tile_smem_bytes(4, 4, 8, 2, 512, 8) > tfused.SMEM_LIMIT


@pytest.mark.parametrize("args", [
    (4, 2, 4, 2, 4096, 2, 4, 8, False),     # the gate's block step at N 4096
    (6, 2, 4, 2, 8192, 3, 2, 0, True),      # bench.py's product at N 8192
    (6, 2, 6, 2, 4096, 6, 4, 0, True),      # the CKKS key's keyswitch at N 4096
])
def test_tile_layout_global_where_nothing_fits(args):
    """Where one ciphertext's rows pass shared memory, the global layout of
    the parent design (modarith.cuh STAGED)."""
    kk, co, psize, P, n, _, _, block, split = args
    lay = tfm.tile_layout(*args)
    assert lay == tfm.mxu_layout(kk, co, psize, P, n, split) and lay.kind == "global"
    assert tfm.tile_smem_bytes(1, kk, lay.cpb * psize, P, n, block) > tfused.SMEM_LIMIT


def test_tile_shapes_match_the_kernel_source():
    """TILE_SHAPES lists exactly the specialised instances of the source:
    Shape<T, log N, KK, cpb·psize, P, block, psize, res_size>."""
    src = CSRC.read_text()
    shapes = {}
    for name, dims in re.findall(r"using (\w+Shape) = Shape<([\d, ]+)>;", src):
        t, logn, kk, mr, P, block, psize, res = map(int, dims.split(","))
        if t:
            shapes[(block > 0, logn, kk, mr, P, block, psize, res)] = t
    assert shapes == tfm.TILE_SHAPES
    assert re.search(r"constexpr int THREADS = 512;", src)


def test_stage_names():
    """The stage clock's stages, in the kernel's order."""
    src = CSRC.read_text()
    enum = re.search(r"enum \{ (ST_\w+(?:, ST_\w+)*), NSTAGES \};", src).group(1)
    assert tuple(e[3:].lower() for e in enum.split(", ")) == (
        "planes", "fwd_a", "fwd_b", "vmp", "inv_a", "inv_b", "exit") == tfm.STAGES


# --------------------------------------------------------------------------
# CUDA: the tile design at the edges of a tile
# --------------------------------------------------------------------------

def _residues(rng, primes, shape):
    out = np.zeros(shape, dtype=np.int64)
    for i, p in enumerate(primes):
        out[..., i, :] = rng.integers(0, p, size=shape[:-2] + shape[-1:])
    return out.astype(np.int32)


def _wrap(x):
    """Limbs past int32 in the first ciphertext (they wrap to int32 in the kernel)."""
    x[0, 0, 0, :4] += torch.tensor([2**33, -(2**35), 2**31, -(2**31) - 1], device=x.device)
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("n,nprimes,prime_bits,batch,block,size,rows,psize,res_size", [
    (1024, 2, 28, 1, 8, 2, 4, 4, 2),     # the gate shape (specialised, 2 per block), batch 1
    (1024, 2, 28, 3, 8, 2, 4, 4, 2),     # a batch not a multiple of the tile
    (1024, 2, 28, 4, 1, 2, 4, 4, 2),     # one key element
    (1024, 2, 28, 5, 2, 2, 4, 4, 2),
    (512, 2, 28, 5, 8, 2, 4, 4, 2),      # 3 per block at N 512
    (2048, 2, 28, 3, 2, 2, 4, 4, 2),
    (1024, 3, 30, 3, 4, 3, 3, 4, 3),     # P 3, 30-bit primes
])
def test_cuda_tile_block_step_matches_plain(cuda, n, nprimes, prime_bits, batch, block, size,
                                            rows, psize, res_size):
    m = t_get_module(n, nprimes, prime_bits, cuda)
    rng = np.random.default_rng(71)
    acc = _wrap(torch.from_numpy(rng.integers(-(2**16), 2**16, size=(batch, 2, size, n))).to(cuda))
    pmats = torch.from_numpy(_residues(rng, m.basis.primes,
                                       (block, rows, 2, 2, psize, nprimes, n))).to(cuda)
    amounts = torch.from_numpy(rng.integers(-n, 3 * n, size=(batch, block))).to(cuda)
    lay = tfm.tile_layout(2 * min(rows, size), 2, psize, nprimes, n, res_size, batch, block,
                          split=False)
    assert lay.kind == "tile"
    args = (m, acc, pmats, amounts, res_size, 17)
    reset_launches()
    have = tfm.fused_mxu_br_block_step(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_mxu_br_block_step"] == 1
    assert torch.equal(have, tfm.fused_mxu_br_block_step_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("n,nprimes,prime_bits,batch,ci,rows,size_a,psize,res_size,s_size", [
    (2048, 2, 28, 1, 2, 3, 3, 4, 3, 0),    # bench.py's shape (specialised), batch 1
    (2048, 2, 28, 3, 2, 3, 3, 4, 3, 0),
    (2048, 2, 30, 3, 1, 3, 3, 4, 3, 3),    # the keyswitch's shape with the body (specialised)
    (2048, 2, 28, 3, 1, 6, 6, 6, 6, 6),    # one output column per block
    (1024, 2, 28, 7, 2, 4, 3, 4, 3, 0),    # rows > size_a, 2 per block
    (512, 3, 30, 5, 2, 3, 3, 4, 3, 0),     # P 3, 30-bit primes
    (512, 3, 30, 5, 1, 3, 3, 4, 3, 3),
])
def test_cuda_tile_product_matches_plain(cuda, n, nprimes, prime_bits, batch, ci, rows, size_a,
                                         psize, res_size, s_size):
    m = t_get_module(n, nprimes, prime_bits, cuda)
    rng = np.random.default_rng(72)
    a = _wrap(torch.from_numpy(rng.integers(-(2**16), 2**16, size=(batch, ci, size_a, n))).to(cuda))
    pmat = torch.from_numpy(_residues(rng, m.basis.primes, (rows, ci, 2, psize, nprimes, n)))
    pmat = pmat.to(cuda)
    small = (torch.from_numpy(rng.integers(-(2**16), 2**16, size=(batch, s_size, n))).to(cuda)
             if s_size else None)
    args = (m, a, pmat, res_size, 17, 17)
    reset_launches()
    have = tfm.fused_mxu_glwe_product(*args, small=small)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_mxu_product_small" if s_size else "fused_mxu_product"] == 1
    assert torch.equal(have, tfm.fused_mxu_glwe_product_ref(*args, small=small))


@pytest.mark.cuda
@pytest.mark.parametrize("block_step", [False, True])
def test_cuda_tile_equals_parent_design_and_stage_clock(cuda, block_step):
    """At the gate and bench shapes (batch 5): the tile design equals the
    parent design; the stage clock's instance gives the same output and a
    positive cycle count per block and stage."""
    rng = np.random.default_rng(73)
    if block_step:
        m = t_get_module(1024, 2, 28, cuda)
        acc = torch.from_numpy(rng.integers(-(2**16), 2**16, size=(5, 2, 2, 1024))).to(cuda)
        pmats = torch.from_numpy(_residues(rng, m.basis.primes, (8, 4, 2, 2, 4, 2, 1024)))
        amounts = torch.from_numpy(rng.integers(-1024, 3072, size=(5, 8)))
        args = (m, acc, pmats.to(cuda), amounts.to(cuda), 2, 17, None)
        prepare = tfm._block_step_launch
    else:
        m = t_get_module(2048, 2, 28, cuda)
        a = torch.from_numpy(rng.integers(-(2**16), 2**16, size=(5, 2, 3, 2048))).to(cuda)
        pmat = torch.from_numpy(_residues(rng, m.basis.primes, (3, 2, 2, 4, 2, 2048)))
        args = (m, a, pmat.to(cuda), 3, 17, 17, None, None)
        prepare = tfm._product_launch
    outs = {}
    for design in ("parent", "tile"):
        out, launch = prepare(*args, design=design)
        launch()
        outs[design] = out
    timed, stamps = tfm.stage_cycles(*args, block_step=block_step)
    torch.cuda.synchronize()
    assert torch.equal(outs["tile"], outs["parent"]) and torch.equal(timed, outs["tile"])
    assert stamps.shape == (3 if block_step else 5, len(tfm.STAGES)) and bool((stamps > 0).all())
