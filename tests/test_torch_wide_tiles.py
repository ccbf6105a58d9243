"""The lazy design of the wide fused product (`csrc/wide_product.cu`): its
layout formula, and its CUDA launches at the design's edges against the
plain version and the parent design.

CPU part: `wide.wide_design_layout` at the CKKS-wide mul's shape (a
ciphertext per block, its primes in two passes, 147,456 B) and elsewhere,
the parent design where the lazy one does not take a shape (N 64, N 4096,
rows past its bounds), the specialised
shapes and stage names of the Python tables against the C++ source, and
the wrapper's plain version on CPU tensors.

CUDA part (`-m cuda`, skipped without a card): N 256 to 2048, P 1, 2, 4, 5
and 8, 28- and 30-bit primes, s_size 0, 2 and 3, offsets −7, 0 and 13, ci
2, dsize 2, batches of 1 and of an odd size, limbs at INT64_MIN and
INT64_MAX, primes in one pass and in two: each launch of the lazy design
equals the plain version and the parent design bit for bit, and its stage
clock's instance the untimed one; the parent's global layout
at N 4096.  These tests do not touch JAX; on the machine with the card run
them with

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_wide_tiles.py -q
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


def test_lazy_layout_at_the_ckks_wide_shape():
    """The mul's relinearization (KK 2, co 2, psize 3, P 5, N 2048): a block
    takes a ciphertext, both columns; 28 rows fit, so 4 primes' regions of 6
    rows, and the 5 primes go in two passes split 3 + 2 (147,456 B), the
    first pass's rows in a scratch slot per block."""
    lay = twide.wide_design_layout(2, 2, 3, 5, 2048)
    assert (lay.kind, lay.cpb, lay.smem, lay.chunk) == ("lazy", 2, 147456, 18)
    assert 4 * 2048 * 5 * 6 == 245760 > tfused.SMEM_LIMIT
    assert lay.smem + twide.WIDE_STATIC_SMEM <= tfused.SMEM_LIMIT
    scratch = twide.wide_scratch(lay, 2, 3, 5, 256, 2048, "cpu")
    assert tuple(scratch.shape) == (256, 5, 6, 2048)
    assert twide.wide_design_layout(2, 2, 3, 5, 2048, "parent") == \
        tfused.product_layout(2, 2, 3, 5, 2048)


def test_no_scratch_where_every_prime_fits():
    lay = twide.wide_lazy_layout(2, 2, 3, 5, 1024)
    assert (lay.cpb, lay.chunk) == (2, 30)
    assert twide.wide_scratch(lay, 2, 3, 5, 256, 1024, "cpu") is None


@pytest.mark.parametrize("args,cpb,rows", [
    ((2, 2, 3, 4, 2048), 2, 24),        # the 30-bit wide keyswitch: every prime at once
    ((4, 2, 4, 5, 2048), 2, 24),        # an external product, ci 2: 3 + 2 primes
    ((6, 2, 4, 8, 1024), 2, 32),        # P 8: 4 + 4 primes
    ((2, 2, 9, 5, 2048), 1, 27),        # 18 output rows: a column per block, 3 + 2
    ((16, 2, 8, 8, 256), 2, 128),       # 16 input and 16 output rows
    ((2, 2, 3, 5, 256), 2, 30),
])
def test_lazy_layout_elsewhere(args, cpb, rows):
    lay = twide.wide_lazy_layout(*args)
    assert (lay.cpb, lay.chunk, lay.smem) == (cpb, rows, 4 * args[-1] * rows)
    assert twide.wide_design_layout(*args) == lay


@pytest.mark.parametrize("args,kind,reason", [
    ((2, 2, 3, 5, 64), "shared", "N 64"),
    ((2, 2, 3, 5, 128), "shared", "N 128"),
    ((2, 2, 3, 5, 4096), "global", "N 4096"),
    ((0, 2, 3, 5, 2048), "shared", "no input row"),
    ((17, 1, 3, 2, 256), "shared", "17 input rows"),
    ((2, 1, 17, 5, 2048), "global", "17 output rows"),
    ((2, 2, 3, 9, 512), "shared", "P 9"),
])
def test_parent_design_where_the_lazy_one_does_not_take_the_shape(args, kind, reason):
    assert twide.wide_lazy_layout(*args) is None, reason
    assert twide.wide_design_layout(*args) == tfused.product_layout(*args)
    assert tfused.product_layout(*args).kind == kind


def test_design_keyword():
    with pytest.raises(ValueError):
        twide.wide_design_layout(2, 2, 3, 5, 2048, "tile")


def test_wide_shapes_match_the_kernel_source():
    """WIDE_SHAPES lists exactly the specialised instances of the source,
    WideShape<log N, KK, cpb·psize, P, psize, res_size, kr, ka>."""
    src = (CSRC / "wide_product.cu").read_text()
    shapes = {tuple(map(int, dims.split(",")))
              for dims in re.findall(r"using \w+ = WideShape<([\d, ]+)>;", src)}
    assert shapes - {(0,) * 8} == twide.WIDE_SHAPES
    assert (0,) * 8 in shapes


def test_wide_stage_names():
    """The stage clock's stages, in the kernel's order (wide_product.cu)."""
    src = (CSRC / "wide_product.cu").read_text()
    enum = re.search(r"enum \{ (WP_\w+(?:, WP_\w+)*), WP_NSTAGES \};", src).group(1)
    assert tuple(e[3:].lower() for e in enum.split(", ")) == twide.WIDE_STAGES


def test_static_shared_memory_reserve():
    """The lazy kernel's static __shared__ constants fit in the bytes the
    layout reserves beside its rows: PrimeL (8 words) per prime, 16 row
    offsets, and ExitPrimes."""
    words = 8 * 8 + 16 + (5 * 8 + 64) + 2 * (2 * 8 + 2)
    assert 4 * words <= twide.WIDE_STATIC_SMEM


def test_cpu_wrapper_takes_the_plain_version():
    """On CPU tensors the wrapper is the plain version and counts no launch."""
    m = t_get_module(64, 5, 28, "cpu")
    rng = np.random.default_rng(110)
    a = torch.from_numpy(rng.integers(-(2**51), 2**51, size=(2, 1, 2, 64)))
    pmat = torch.from_numpy(_residues(rng, m.basis.primes, (2, 1, 2, 3, 5, 64)))
    small = torch.from_numpy(rng.integers(-(2**51), 2**51, size=(2, 2, 3, 64)))
    reset_launches()
    have = twide.fused_glwe_product_wide(m, a, pmat, 2, 52, 52, small, 13)
    assert sum(LAUNCHES.values()) == 0
    assert torch.equal(have, twide.fused_glwe_product_wide_ref(m, a, pmat, 2, 52, 52, small, 13))
    with pytest.raises(ValueError):
        twide.fused_glwe_product_wide(m, a, pmat, 2, 62, 52)


# --------------------------------------------------------------------------
# CUDA: the lazy design at its edges
# --------------------------------------------------------------------------

EDGES = [-(2**63), 2**63 - 1, -1, 2**62, -(2**62) - 3]


def _residues(rng, primes, shape):
    out = np.zeros(shape, dtype=np.int64)
    for i, p in enumerate(primes):
        out[..., i, :] = rng.integers(0, p, size=shape[:-2] + shape[-1:])
    return out.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,nprimes,bits,batch,ci,rows,size_a,psize,res_size,kr,ka,s_size,offset,dsize", [
        (2048, 5, 28, 3, 1, 2, 2, 3, 2, 52, 52, 3, 0, 1),     # the CKKS-wide mul: MulShape
        (2048, 5, 28, 1, 1, 2, 2, 3, 2, 52, 52, 3, 13, 1),    # batch 1, an offset
        (2048, 4, 30, 5, 1, 3, 2, 3, 2, 44, 44, 2, 0, 1),     # a 30-bit wide keyswitch
        (1024, 8, 28, 3, 2, 3, 3, 4, 3, 44, 44, 0, -7, 1),    # P 8, ci 2
        (512, 2, 30, 5, 2, 2, 2, 3, 3, 26, 52, 2, 5, 1),      # kr 26
        (256, 1, 30, 2, 1, 3, 3, 3, 4, 52, 52, 3, -7, 1),     # P 1
        (256, 5, 28, 3, 1, 2, 4, 3, 2, 52, 52, 0, 13, 2),     # dsize 2
    ])
def test_cuda_lazy_wide_product_matches_plain_and_parent(cuda, n, nprimes, bits, batch, ci, rows,
                                                         size_a, psize, res_size, kr, ka, s_size,
                                                         offset, dsize):
    m = t_get_module(n, nprimes, bits, cuda)
    rng = np.random.default_rng(111)
    lim = 1 << (ka - 1)
    a = torch.from_numpy(rng.integers(-lim, lim, size=(batch, ci, size_a, n)))
    a[0, 0, 0, :len(EDGES)] = torch.tensor(EDGES)
    pmat = torch.from_numpy(_residues(rng, m.basis.primes, (rows, ci, 2, psize, nprimes, n)))
    small = None
    if s_size:
        small = torch.from_numpy(rng.integers(-lim, lim, size=(batch, 2, s_size, n)))
        small[-1, 1, 0, -len(EDGES):] = torch.tensor(EDGES)
        small = small.to(cuda)
    args = (m, a.to(cuda), pmat.to(cuda), res_size, kr, ka, small, offset, dsize)
    kk = ci * min(rows * dsize, size_a)
    assert twide.wide_design_layout(kk, 2, psize, nprimes, n).kind == "lazy"
    reset_launches()
    have = twide.fused_glwe_product_wide(*args)
    torch.cuda.synchronize()
    assert sum(LAUNCHES.values()) == LAUNCHES["wide_product"] == 1
    assert torch.equal(have, twide.fused_glwe_product_wide_ref(*args))
    for design in ("parent", "lazy"):
        out, launch = twide._wide_product_launch(*args, design=design)
        launch()
        timed, stamps = twide.wide_product_stage_cycles(*args, design=design)
        torch.cuda.synchronize()
        assert torch.equal(out, have) and torch.equal(timed, have), design
        assert bool((stamps > 0).all())


@pytest.mark.cuda
def test_cuda_wide_product_global_layout(cuda):
    """N 4096 at the mul's sizes: the parent design's global layout."""
    m = t_get_module(4096, 5, 28, cuda)
    rng = np.random.default_rng(112)
    a = torch.from_numpy(rng.integers(-(2**51), 2**51, size=(2, 1, 2, 4096))).to(cuda)
    pmat = torch.from_numpy(_residues(rng, m.basis.primes, (2, 1, 2, 3, 5, 4096))).to(cuda)
    small = torch.from_numpy(rng.integers(-(2**51), 2**51, size=(2, 2, 3, 4096))).to(cuda)
    assert twide.wide_design_layout(2, 2, 3, 5, 4096).kind == "global"
    have = twide.fused_glwe_product_wide(m, a, pmat, 2, 52, 52, small)
    torch.cuda.synchronize()
    assert torch.equal(have, twide.fused_glwe_product_wide_ref(m, a, pmat, 2, 52, 52, small))
