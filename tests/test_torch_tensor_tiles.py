"""The lazy design of the rank-1 tensor kernels (`csrc/tensor.cuh`, shared by
`csrc/tensor_product.cu` and `csrc/wide_tensor.cu`): its layout formula, and
its CUDA launches at the design's edges against the plain versions and the
parent design.

CPU part: `fused.tensor_design_layout` (with either kernel's parent layout)
at the relinearize path's and the CKKS-wide mul's shapes (pairs per task,
shared rows, scratch slots), the parent design where the lazy one does not
take a shape (N 4096, rows past shared memory), and the specialised shapes
and stage names of the Python tables against the C++ sources.

CUDA part (`-m cuda`, skipped without a card): both paths' shapes, limbs
anywhere in int64 (INT64_MIN and INT64_MAX included), P 1, 2, 3, 5 and 8,
up to 8 + 8 limbs (conv 15), a pair per task and all three, primes in
passes, the wide landing offset: each launch of the lazy design equals the
plain version and the parent design bit for bit, and its stage clock's
instance the untimed one.  These tests do not touch JAX; on the machine with
the card run them with

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_tensor_tiles.py -q
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from poulpy_tpu_torch.backends import LAUNCHES, reset_launches
from poulpy_tpu_torch.backends import fused as tfused
from poulpy_tpu_torch.backends import wide as twide
from poulpy_tpu_torch.hal.module import get_module as t_get_module

CSRC = Path(__file__).resolve().parents[1] / "poulpy_tpu_torch" / "csrc"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (size_a, size_b, conv, P, N) → (pairs per task, shared rows, shared bytes,
# scratch slots at batch 256) of the lazy design at the paths' shapes
PATH_SHAPES = {
    # 33 conv rows per prime for all three pairs pass 28 rows: a pair per
    # task, a0·b0 and a1·b1 both primes at once, the cross pair one at a time
    "tensor@relinearize": ((6, 6, 11, 2, 2048), (1, 24, 196608, 256)),
    # 9 rows per prime for all three pairs: 3 primes per pass, two passes
    "wide_tensor@ckks_wide": ((2, 2, 3, 5, 2048), (3, 27, 221184, 256)),
}


@pytest.mark.parametrize("name", PATH_SHAPES)
def test_lazy_tensor_layout_at_path_shapes(name):
    (sa, sb, conv, P, n), (pairs, rows, smem, slots) = PATH_SHAPES[name]
    lay = tfused.tensor_design_layout(sa, sb, conv, P, n)
    assert (lay.kind, lay.pairs, lay.chunk, lay.smem) == ("lazy", pairs, rows, smem)
    assert smem + tfused.TENSOR_STATIC_SMEM <= tfused.SMEM_LIMIT
    assert tfused.tensor_design_layout(sa, sb, conv, P, n, parent=twide.tensor_wide_layout) == lay
    assert tfused.tensor_scratch_slots(lay, sa, sb, conv, P, 256) == slots
    assert tfused.tensor_design_layout(sa, sb, conv, P, n, "parent") == \
        tfused.tensor_layout(sa, sb, conv, P, n)


def test_all_three_pairs_do_not_fit_at_the_relinearize_shape():
    """In place, all three pairs of one prime need 33 rows of 8 KB, 270,336
    B, over the 232,448 a block may have; a pair per task fits."""
    assert 4 * 2048 * 33 == 270336 > tfused.SMEM_LIMIT
    assert tfused.tensor_lazy_layout(6, 6, 11, 2, 2048, pairs=3) is None
    assert tfused.tensor_lazy_layout(6, 6, 11, 2, 2048, pairs=1).pairs == 1


@pytest.mark.parametrize("args,pairs,slots", [
    ((6, 6, 11, 2, 1024), 3, 256),      # 33 rows of 4 KB: one prime per pass
    ((6, 6, 11, 2, 512), 3, 0),         # both primes at once
    ((8, 8, 15, 8, 256), 3, 256),       # 45 rows: 5 primes, then 3
    ((6, 6, 11, 3, 2048), 1, 768),      # every pair in passes
    ((2, 2, 3, 5, 1024), 3, 0),
])
def test_lazy_tensor_layout_elsewhere(args, pairs, slots):
    lay = tfused.tensor_lazy_layout(*args)
    assert lay.pairs == pairs
    sa, sb, conv, P, n = args
    assert tfused.tensor_scratch_slots(lay, sa, sb, conv, P, 256) == slots


@pytest.mark.parametrize("args,kind,reason", [
    ((6, 6, 11, 2, 4096), "global", "N 4096"),
    ((2, 2, 3, 5, 4096), "shared", "N 4096"),
    ((8, 8, 15, 2, 2048), "global", "the cross pair's 32 rows"),
    ((6, 6, 11, 2, 128), "shared", "N 128"),
    ((6, 6, 11, 9, 512), "shared", "P 9"),
])
def test_parent_design_where_the_lazy_one_does_not_take_the_shape(args, kind, reason):
    assert tfused.tensor_lazy_layout(*args) is None, reason
    assert tfused.tensor_design_layout(*args) == tfused.tensor_layout(*args)
    assert tfused.tensor_layout(*args).kind == kind
    assert tfused.tensor_design_layout(*args, parent=twide.tensor_wide_layout) == \
        twide.tensor_wide_layout(*args)


def test_tensor_shapes_match_the_kernel_sources():
    """TENSOR_SHAPES lists exactly the specialised instances of the sources,
    TsShape<log N, P, size_a, size_b, conv, dnum, lin limbs, pairs, kr, ka>."""
    shapes = set()
    for stem, wide in (("tensor_product", False), ("wide_tensor", True)):
        src = (CSRC / f"{stem}.cu").read_text()
        for dims in re.findall(r"using \w+Shape = TsShape<([\d, ]+)>;", src):
            shapes.add((wide, *map(int, dims.split(","))))
    assert shapes == tfused.TENSOR_SHAPES


def test_tensor_stage_names():
    """The stage clock's stages, in the kernels' order (modarith.cuh)."""
    src = (CSRC / "modarith.cuh").read_text()
    enum = re.search(r"enum \{ (TS_\w+(?:, TS_\w+)*), TS_NSTAGES \};", src).group(1)
    assert tuple(e[3:].lower() for e in enum.split(", ")) == tfused.TENSOR_STAGES


def test_static_shared_memory_reserve():
    """The lazy kernel's static __shared__ constants fit in the bytes the
    layout reserves beside its rows: PrimeL (8 words) and r3 per prime, 32
    row offsets, and ExitPrimes."""
    words = 8 * 8 + 8 + 32 + (5 * 8 + 64) + 2 * (2 * 8 + 2)
    assert 4 * words <= tfused.TENSOR_STATIC_SMEM


# --------------------------------------------------------------------------
# CUDA: the lazy design at its edges
# --------------------------------------------------------------------------

EDGES = [-(2**63), 2**63 - 1, -1, 2**62, -(2**62) - 3]


def _operands(rng, batch, size_a, size_b, n, lim, device):
    a = torch.from_numpy(rng.integers(-lim, lim, size=(batch, 2, size_a, n)))
    b = torch.from_numpy(rng.integers(-lim, lim, size=(batch, 2, size_b, n)))
    a[0, 0, 0, :len(EDGES)] = torch.tensor(EDGES)
    b[-1, 1, -1, -len(EDGES):] = torch.tensor(EDGES)
    return a.to(device), b.to(device)


def _designs_agree(prepare, stage_cycles, m, args, pairs):
    """The lazy design's output (every `pairs` setting), which must equal
    the parent design's and the stage clock's instance's."""
    outs = []
    for design, pr in [("parent", None)] + [("lazy", p) for p in pairs]:
        out, launch = prepare(m, *args, design=design, pairs=pr)
        launch()
        outs.append(torch.cat([x.flatten() for x in out]))
    timed, stamps = stage_cycles(m, *args)
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert torch.equal(torch.cat([x.flatten() for x in timed]), outs[0])
    assert bool((stamps > 0).all())
    return outs[0]


@pytest.mark.cuda
@pytest.mark.parametrize("n,nprimes,prime_bits,batch,size_a,size_b,dnum,kr,ka,lim,pairs", [
    (2048, 2, 28, 3, 6, 6, 6, 17, 17, 2**16, (1,)),       # the relinearize path's shape
    (2048, 2, 28, 5, 6, 6, 6, 17, 17, 2**62, (1,)),       # limbs anywhere in int64
    (2048, 3, 30, 2, 6, 6, 6, 17, 17, 2**16, (1,)),       # every pair in passes
    (1024, 2, 30, 3, 6, 6, 6, 17, 17, 2**40, (3, 1)),     # all three pairs, in passes
    (512, 5, 30, 2, 8, 8, 6, 13, 17, 2**20, (3, 1)),      # conv 15, P 5
    (256, 8, 28, 3, 8, 8, 8, 17, 17, 2**16, (3, 1)),      # P 8 in passes
    (256, 1, 30, 2, 3, 5, 4, 15, 17, 2**16, (3, 1)),      # P 1, size_a ≠ size_b
])
def test_cuda_lazy_tensor_matches_plain_and_parent(cuda, n, nprimes, prime_bits, batch, size_a,
                                                   size_b, dnum, kr, ka, lim, pairs):
    m = t_get_module(n, nprimes, prime_bits, cuda)
    a, b = _operands(np.random.default_rng(101), batch, size_a, size_b, n, lim, cuda)
    conv = size_a + size_b - 1
    args = (a, b, conv, dnum, kr, ka)
    assert tfused.tensor_design_layout(size_a, size_b, conv, nprimes, n).kind == "lazy"
    reset_launches()
    have = tfused.fused_tensor_product(m, *args)
    torch.cuda.synchronize()
    assert sum(LAUNCHES.values()) == LAUNCHES["tensor_product"] == 1
    want = tfused.fused_tensor_product_ref(m, *args)
    assert torch.equal(have[0], want[0]) and torch.equal(have[1], want[1])
    parent = _designs_agree(tfused._tensor_launch, tfused.tensor_stage_cycles, m, args, pairs)
    assert torch.equal(torch.cat([x.flatten() for x in have]), parent)


@pytest.mark.cuda
@pytest.mark.parametrize("n,nprimes,batch,size_a,size_b,dnum,lin_size,kr,ka,offset,pairs", [
    (2048, 5, 3, 2, 2, 2, 3, 52, 52, 13, (3, 1)),     # the CKKS-wide mul's shape
    (2048, 5, 2, 3, 3, 2, 4, 44, 52, -9, (3, 1)),
    (512, 8, 2, 4, 4, 3, 5, 52, 52, 0, (3, 1)),
    (256, 3, 5, 2, 3, 3, 3, 52, 52, 13, (3, 1)),
])
def test_cuda_lazy_wide_tensor_matches_plain_and_parent(cuda, n, nprimes, batch, size_a, size_b,
                                                        dnum, lin_size, kr, ka, offset, pairs):
    m = t_get_module(n, nprimes, 28, cuda)
    a, b = _operands(np.random.default_rng(102), batch, size_a, size_b, n, 2**51, cuda)
    conv = size_a + size_b - 1
    args = (a, b, conv, dnum, lin_size, kr, ka, offset)
    assert tfused.tensor_design_layout(size_a, size_b, conv, nprimes, n).kind == "lazy"
    reset_launches()
    have = twide.fused_tensor_product_wide(m, *args)
    torch.cuda.synchronize()
    assert sum(LAUNCHES.values()) == LAUNCHES["wide_tensor"] == 1
    want = twide.fused_tensor_product_wide_ref(m, *args)
    assert torch.equal(have[0], want[0]) and torch.equal(have[1], want[1])
    parent = _designs_agree(twide._tensor_wide_launch, twide.tensor_wide_stage_cycles, m, args,
                            pairs)
    assert torch.equal(torch.cat([x.flatten() for x in have]), parent)


@pytest.mark.cuda
def test_cuda_tensor_product_global_layout(cuda):
    """N 4096, 6 + 6 limbs: the parent design's global layout (the repair
    that lets glwe_tensor_relinearize take the kernel there)."""
    m = t_get_module(4096, 2, 28, cuda)
    a, b = _operands(np.random.default_rng(103), 3, 6, 6, 4096, 2**16, cuda)
    assert tfused.tensor_design_layout(6, 6, 11, 2, 4096).kind == "global"
    have = tfused.fused_tensor_product(m, a, b, 11, 6, 17, 17)
    torch.cuda.synchronize()
    want = tfused.fused_tensor_product_ref(m, a, b, 11, 6, 17, 17)
    assert torch.equal(have[0], want[0]) and torch.equal(have[1], want[1])
