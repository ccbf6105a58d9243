"""The lazy design of the butterfly kernels (`csrc/fused_product.cu`,
`csrc/br_block_step.cu`): its layout formula, and its CUDA launches at the
design's edges against the plain versions and the parent design.

CPU part: `fused.butterfly_layout` at every shape the paths of
`chip_smoke.py` launch (design, output columns and ciphertexts per block,
shared bytes within the card's 232,448), the parent's global layout where
the lazy design does not take a shape, and the specialised shapes and stage
names of the Python tables against the C++ sources.

CUDA part (`-m cuda`, skipped without a card): the paths' shapes, limbs
anywhere in int64 (INT64_MIN and INT64_MAX included), P 1, 2, 5 and 8,
psize up to 16 limbs, `small64` with s64 > psize, a dsize-2 key layout,
block 1 and 8, N 256 to 2048, batches of 1, T − 1, T + 1 and odd: each
launch of the lazy design equals the plain version and the parent design
bit for bit, and its stage clock's instance the untimed one.  These tests
do not touch JAX; on the machine with the card run them with

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_fused_tiles.py -q
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from poulpy_tpu_torch.backends import LAUNCHES, reset_launches
from poulpy_tpu_torch.backends import fused as tfused
from poulpy_tpu_torch.hal.module import get_module as t_get_module

CSRC = Path(__file__).resolve().parents[1] / "poulpy_tpu_torch" / "csrc"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (kk, co, psize, P, N, res_size, block, split) → (cpb, ciphertexts per block,
# shared bytes) of the lazy design at the shapes the paths of chip_smoke.py launch
PATH_SHAPES = {
    "product@bench": ((6, 2, 4, 2, 2048, 3, 0, True), (2, 1, 131072)),
    "small@keyswitch": ((3, 2, 4, 2, 2048, 3, 0, True), (2, 1, 131072)),
    "small@gate_keyswitch": ((2, 2, 3, 2, 1024, 2, 0, True), (2, 1, 49152)),
    "product@gate_standard": ((4, 2, 4, 2, 1024, 2, 0, True), (2, 1, 65536)),
    "small@ckks_rotate": ((6, 2, 6, 2, 2048, 6, 0, True), (2, 1, 196608)),
    "small64@relinearize": ((6, 2, 6, 2, 2048, 12, 0, True), (2, 1, 196608)),
    "block_step@gate": ((4, 2, 4, 2, 1024, 2, 8, False), (2, 2, 131136)),
}


@pytest.mark.parametrize("name", PATH_SHAPES)
def test_lazy_layout_at_path_shapes(name):
    """Every path shape takes the lazy design with all its output columns in
    one block (the rotation's and the relinearization's too, which the
    parent design splits over two), its bytes by the formula and within the
    card's shared memory."""
    (kk, co, psize, P, n, res_size, block, split), (cpb, tile, smem) = PATH_SHAPES[name]
    lay = tfused.butterfly_layout(kk, co, psize, P, n, res_size, block, split)
    assert (lay.kind, lay.cpb, lay.tile, lay.smem) == ("lazy", cpb, tile, smem)
    assert smem == tfused.lazy_smem_bytes(tile, kk, cpb * psize, P, n, block) <= tfused.SMEM_LIMIT
    parent = tfused.butterfly_layout(kk, co, psize, P, n, res_size, block, split, "parent")
    assert parent == tfused.product_layout(kk, co, psize, P, n, split)


def test_lazy_bytes_of_the_bench_and_gate_shapes():
    """bench.py's product: 2 regions of 8 rows of 2048 words, 131,072 B
    against the parent's 180,224; the gate's block step: two ciphertexts in
    131,072 B and their 16 x-power rows."""
    assert tfused.lazy_smem_bytes(1, 6, 8, 2, 2048) == 2 * 8 * 2048 * 4 == 131072
    assert tfused.fused_smem_bytes(6, 8, 2, 2048) == 180224
    assert tfused.lazy_smem_bytes(2, 4, 8, 2, 1024, 8) == 131072 + 64


@pytest.mark.parametrize("args,reason", [
    ((6, 2, 4, 2, 8192, 3, 0, True), "N 8192"),
    ((4, 2, 4, 2, 4096, 2, 8, False), "N 4096"),
    ((6, 2, 6, 2, 4096, 6, 0, True), "N 4096"),
    ((2, 1, 4, 2, 128, 3, 0, True), "N 128"),
    ((18, 2, 4, 2, 512, 3, 0, True), "KK 18"),
    ((4, 1, 17, 2, 512, 3, 0, True), "17 output rows"),
])
def test_parent_design_where_the_lazy_one_does_not_fit(args, reason):
    """Outside 256 ≤ N ≤ 2048, past 16 input or output rows, the parent
    design's layout (shared, or global past shared memory)."""
    kk, co, psize, P, n, res_size, block, split = args
    assert tfused.lazy_layout(*args) is None, reason
    assert tfused.butterfly_layout(*args) == tfused.product_layout(kk, co, psize, P, n, split)


def test_lazy_design_splits_columns_only_past_its_rows():
    """A column group per block only where all co columns pass 16 output
    rows (or shared memory)."""
    assert tfused.lazy_layout(6, 2, 10, 2, 256, 6).cpb == 1      # 20 rows
    assert tfused.lazy_layout(6, 2, 8, 2, 1024, 6).cpb == 2
    assert tfused.lazy_layout(6, 2, 8, 2, 2048, 6).cpb == 1      # 262,144 B for both
    assert tfused.lazy_layout(6, 4, 4, 2, 1024, 3).cpb == 4
    assert tfused.lazy_layout(6, 4, 4, 2, 2048, 3).cpb == 2


def test_lazy_shapes_match_the_kernel_sources():
    """LAZY_SHAPES lists exactly the specialised instances of the sources,
    BfShape<log N, KK, cpb·psize, P, psize, res_size>, with the gate's two
    ciphertexts per block."""
    shapes = {}
    for stem, block_step in (("fused_product", False), ("br_block_step", True)):
        src = (CSRC / f"{stem}.cu").read_text()
        for name, dims in re.findall(r"using (\w+Shape) = BfShape<([\d, ]+)>;", src):
            logn, kk, mr, P, psize, res = map(int, dims.split(","))
            if logn:
                tile = re.search(rf"launch_lazy<{name}, (\d+)>", src)
                shapes[(block_step, logn, kk, mr, P, psize, res)] = int(tile.group(1)) if tile \
                    else 1
    assert shapes == tfused.LAZY_SHAPES


def test_stage_names():
    """The stage clock's stages, in the kernels' order (modarith.cuh)."""
    src = (CSRC / "modarith.cuh").read_text()
    enum = re.search(r"enum \{ (BF_\w+(?:, BF_\w+)*), BF_NSTAGES \};", src).group(1)
    assert tuple(e[3:].lower() for e in enum.split(", ")) == tfused.STAGES


# --------------------------------------------------------------------------
# CUDA: the lazy design at its edges
# --------------------------------------------------------------------------

EDGES = [-(2**63), 2**63 - 1, -1, 2**62, -(2**62) - 3]


def _residues(rng, primes, shape):
    out = np.zeros(shape, dtype=np.int64)
    for i, p in enumerate(primes):
        out[..., i, :] = rng.integers(0, p, size=shape[:-2] + shape[-1:])
    return out.astype(np.int32)


def _limbs(rng, shape, lim, device):
    x = torch.from_numpy(rng.integers(-lim, lim, size=shape))
    x[0, 0, 0, :len(EDGES)] = torch.tensor(EDGES)
    return x.to(device)


def _designs_agree(prepare, m, args, block_step):
    """The parent design's output, and the stage clock's instance of the
    lazy design against its untimed output."""
    outs = {}
    for design in ("parent", "lazy"):
        out, launch = prepare(m, *args, design=design)
        launch()
        outs[design] = out
    timed, stamps = tfused.stage_cycles(m, *args, block_step=block_step)
    torch.cuda.synchronize()
    assert torch.equal(timed, outs["lazy"]) and bool((stamps > 0).all())
    return outs["parent"]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,nprimes,prime_bits,batch,ci,rows,size_a,psize,res_size,s_size,s64,dsize,lim", [
        (2048, 2, 28, 1, 2, 3, 3, 4, 3, 0, 0, 1, 2**16),     # bench.py's shape, batch 1
        (2048, 2, 28, 5, 2, 3, 3, 4, 3, 0, 0, 1, 2**62),     # limbs anywhere in int64
        (2048, 2, 30, 3, 1, 3, 3, 4, 3, 3, 0, 1, 2**16),     # the keyswitch path's
        (2048, 2, 28, 3, 1, 6, 6, 6, 6, 6, 0, 1, 2**16),     # the rotation's, one block
        (2048, 2, 28, 3, 1, 6, 6, 6, 12, 0, 11, 1, 2**16),   # the relinearization's
        (1024, 2, 28, 7, 1, 2, 2, 3, 2, 2, 0, 1, 2**40),     # the gate keyswitch's
        (256, 1, 30, 4, 2, 4, 3, 4, 3, 0, 0, 1, 2**16),      # P 1, rows > size_a
        (512, 5, 30, 3, 1, 3, 3, 4, 6, 0, 6, 1, 2**20),      # P 5, s64 > psize
        (256, 8, 28, 2, 1, 2, 4, 3, 4, 4, 0, 2, 2**16),      # P 8, dsize 2
        (512, 2, 28, 3, 1, 16, 16, 16, 16, 16, 0, 1, 2**16),  # 16 limbs, a column per block
    ])
def test_cuda_lazy_product_matches_plain_and_parent(cuda, n, nprimes, prime_bits, batch, ci,
                                                    rows, size_a, psize, res_size, s_size, s64,
                                                    dsize, lim):
    m = t_get_module(n, nprimes, prime_bits, cuda)
    rng = np.random.default_rng(91)
    a = _limbs(rng, (batch, ci, size_a, n), lim, cuda)
    pmat = torch.from_numpy(_residues(rng, m.basis.primes, (rows, ci, 2, psize, nprimes, n)))
    small = (torch.from_numpy(rng.integers(-lim, lim, size=(batch, s_size, n))).to(cuda)
             if s_size else None)
    small64 = (torch.from_numpy(rng.integers(-(2**62), 2**62, size=(batch, 2, s64, n))).to(cuda)
               if s64 else None)
    args = (a, pmat.to(cuda), res_size, 17, 17, dsize, small, small64)
    assert tfused.butterfly_layout(ci * min(rows * dsize, size_a), 2, psize, nprimes, n,
                                   res_size).kind == "lazy"
    reset_launches()
    have = tfused.fused_glwe_product(m, *args[:5], dsize=dsize, small=small, small64=small64)
    torch.cuda.synchronize()
    assert sum(LAUNCHES.values()) == 1
    assert torch.equal(have, tfused.fused_glwe_product_ref(m, *args))
    assert torch.equal(have, _designs_agree(tfused._product_launch, m, args, False))


@pytest.mark.cuda
@pytest.mark.parametrize("n,nprimes,prime_bits,batch,block,size,rows,psize,res_size", [
    (1024, 2, 28, 1, 8, 2, 4, 4, 2),     # the gate shape (two per block): batch T − 1
    (1024, 2, 28, 3, 8, 2, 4, 4, 2),     # T + 1
    (1024, 2, 28, 64, 1, 2, 4, 4, 2),    # one key element
    (256, 2, 28, 5, 8, 2, 4, 4, 2),      # runtime-shaped, one per block
    (2048, 2, 30, 3, 2, 3, 3, 4, 3),
    (512, 5, 30, 2, 8, 2, 4, 4, 2),      # P 5
])
def test_cuda_lazy_block_step_matches_plain_and_parent(cuda, n, nprimes, prime_bits, batch,
                                                       block, size, rows, psize, res_size):
    m = t_get_module(n, nprimes, prime_bits, cuda)
    rng = np.random.default_rng(92)
    acc = _limbs(rng, (batch, 2, size, n), 2**16, cuda)
    pmats = torch.from_numpy(_residues(rng, m.basis.primes,
                                       (block, rows, 2, 2, psize, nprimes, n))).to(cuda)
    amounts = torch.from_numpy(rng.integers(-n, 3 * n, size=(batch, block))).to(cuda)
    assert tfused.butterfly_layout(2 * min(rows, size), 2, psize, nprimes, n, res_size, block,
                                   split=False).kind == "lazy"
    args = (acc, pmats, amounts, res_size, 17)
    reset_launches()
    have = tfused.fused_br_block_step(m, *args)
    torch.cuda.synchronize()
    assert LAUNCHES["br_block_step"] == 1
    assert torch.equal(have, tfused.fused_br_block_step_ref(m, *args))
    assert torch.equal(have, _designs_agree(tfused._block_step_launch, m, args, True))
