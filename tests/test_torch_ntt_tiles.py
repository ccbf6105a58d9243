"""The two designs of the standalone NTT (`csrc/ntt.cu`): the lazy design
(`ntt_lazy_kernel`, 256 ≤ N ≤ 8192) and the parent design (`ntt_kernel`),
chosen per shape by `backends/ntt.py lazy_layout`.

CPU part: the layout formula at every N and at the shapes the paths of
`chip_smoke.py` launch the NTT at (threads, shared bytes, blocks),
`LAZY_LOGN` and `LAZY_THREADS` against the source, and the wrappers taking the plain version on CPU tensors, counting
nothing.

CUDA part (`-m cuda`, skipped without a card): both directions of both
designs against the plain version, tolerance 0, at N 256 … 8192 with P 1,
2 and 5 on 28- and 30-bit primes, residues 0 and p − 1, ragged last blocks,
inverse(forward(x)) == x; the launches counted for the lazy design only;
the parent design below N 256; a tensor the lazy design cannot read in
16-byte groups refused.  These tests do not touch JAX; on the machine with
the card run them with

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_ntt_tiles.py -q
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from poulpy_tpu_torch.backends import LAUNCHES, NTT_ROWS, reset_launches
from poulpy_tpu_torch.backends import ntt as tntt
from poulpy_tpu_torch.hal.module import get_module as t_get_module

CSRC = Path(__file__).resolve().parents[1] / "poulpy_tpu_torch" / "csrc"
SMEM_STATIC = 48 * 1024        # the lazy C entry takes no more (no opt-in attribute)

# (P, N, rows per prime) of every NTT launch of chip_smoke.py's paths (its
# `ntt_shapes` lines on an NVIDIA H100 80GB HBM3: 32 shapes, 195 launches)
PATH_SHAPES = [(2, 1024, r) for r in (1, 6, 12, 1024, 4096, 9088, 36352)] + [
    (2, 2048, r) for r in (1, 3, 6, 11, 12, 24, 36, 48, 72, 88, 96, 192, 384, 512, 1536, 1792,
                           2048, 3072, 7680, 49152)] + [(5, 2048, r) for r in (1, 2, 6, 12, 2560)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("logn", range(2, 16))
def test_lazy_layout_per_n(logn):
    """The lazy design exactly at 256 ≤ N ≤ 8192: 256 threads, 2048 points
    per block up to N 2048 and one row past it, within the C entry's shared
    bytes; the parent design elsewhere: a row per block, N/2 threads up to
    1024."""
    n = 1 << logn
    for rows, P in [(1, 1), (7, 2), (49152, 2), (3, 5)]:
        lay = tntt.lazy_layout(rows, P, n)
        if 8 <= logn <= 13:
            assert lay.design == "lazy" and lay.threads == 256
            assert lay.rows_per_block * n == max(n, 2048)
            assert lay.smem == 4 * lay.rows_per_block * n <= SMEM_STATIC
            assert lay.blocks == -(-(rows * P) // lay.rows_per_block)
        else:
            assert lay == tntt.parent_layout(rows, P, n)
            assert (lay.rows_per_block, lay.threads, lay.smem, lay.blocks) == (
                1, min(n // 2, 1024), 4 * n, rows * P)


@pytest.mark.parametrize("P,n,rows", PATH_SHAPES)
def test_lazy_layout_at_path_shapes(P, n, rows):
    """Every shape the paths launch takes the lazy design; every warp of a
    block has a chunk of each of its rows in the low pass, every thread a
    (row, low byte) column in the high pass; the last block is the only
    ragged one."""
    lay = tntt.lazy_layout(rows, P, n)
    assert lay.design == "lazy"
    warps, chunks = lay.threads // 32, lay.rows_per_block * n // 256
    assert chunks % warps == 0 and (lay.rows_per_block * 256) % lay.threads == 0
    assert (lay.blocks - 1) * lay.rows_per_block < rows * P <= lay.blocks * lay.rows_per_block


def test_layout_constants_match_source():
    src = (CSRC / "ntt.cu").read_text()
    cases = sorted(int(k) for k in re.findall(r"case (\d+): return launch_lazy<", src))
    assert cases == list(tntt.LAZY_LOGN)
    assert f"constexpr int LAZY_THREADS = {tntt.LAZY_THREADS};" in src


@pytest.mark.parametrize("design", tntt.DESIGNS)
def test_cpu_wrappers_take_the_plain_version(design):
    t = t_get_module(256, 2, 28, "cpu").tables
    rng = np.random.default_rng(102)
    x = torch.from_numpy(np.stack([rng.integers(0, p, size=(3, 256)) for p in t.basis.primes],
                                  axis=1).astype(np.int32))
    reset_launches()
    f = tntt.ntt_forward(t, x, design=design)
    assert torch.equal(f, tntt.ntt_forward_ref(t, x))
    assert torch.equal(tntt.ntt_inverse(t, f, design=design), x)
    assert LAUNCHES["ntt_forward"] == LAUNCHES["ntt_inverse"] == 0 and not NTT_ROWS


# --------------------------------------------------------------------------
# CUDA: both designs against the plain version on the card
# --------------------------------------------------------------------------

def _edge_residues(primes, shape, device, seed):
    """Residues [rows, P, N]: random, the first row p − 1, the second half of
    the last row 0."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, p, size=(shape[0], shape[2])) for p in primes], axis=1)
    x[0] = np.asarray(primes)[:, None] - 1
    x[-1, :, shape[2] // 2:] = 0
    return torch.from_numpy(x.astype(np.int32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n,nprimes,prime_bits,rows", [
    (256, 1, 30, 13),       # K 0: 8 rows per block, a ragged second block
    (256, 5, 28, 3),
    (512, 2, 30, 5),        # 4 rows per block, ragged
    (1024, 2, 28, 5),       # the gate path's N
    (1024, 5, 30, 1),
    (2048, 2, 28, 7),       # the paths' N
    (2048, 5, 28, 3),
    (2048, 1, 30, 2),
    (4096, 2, 30, 3),
    (8192, 1, 28, 2),
    (8192, 5, 30, 1),
])
def test_cuda_ntt_designs_match_plain(cuda, n, nprimes, prime_bits, rows):
    t = t_get_module(n, nprimes, prime_bits, cuda).tables
    x = _edge_residues(t.basis.primes, (rows, nprimes, n), cuda, 103)
    want_f, want_i = tntt.ntt_forward_ref(t, x), tntt.ntt_inverse_ref(t, x)
    for design in tntt.DESIGNS:
        reset_launches()
        f = tntt.ntt_forward(t, x, design=design)
        i = tntt.ntt_inverse(t, x, design=design)
        back = tntt.ntt_inverse(t, f, design=design)
        torch.cuda.synchronize()
        assert torch.equal(f, want_f) and torch.equal(i, want_i) and torch.equal(back, x), design
        counted = 1 if design == "lazy" else 0
        assert (LAUNCHES["ntt_forward"], LAUNCHES["ntt_inverse"]) == (counted, 2 * counted)
        assert sum(NTT_ROWS.values()) == 3 * counted


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 128])
def test_cuda_ntt_below_256_takes_the_parent(cuda, n):
    """Below the lazy design's N the formula's launch is the parent design's,
    equal to the plain version and counted."""
    t = t_get_module(n, 2, 28, cuda).tables
    x = _edge_residues(t.basis.primes, (5, 2, n), cuda, 104)
    assert tntt.lazy_layout(5, 2, n).design == "parent"
    reset_launches()
    f = tntt.ntt_forward(t, x)
    assert torch.equal(f, tntt.ntt_forward_ref(t, x))
    assert torch.equal(tntt.ntt_inverse(t, f), x)
    assert LAUNCHES["ntt_forward"] == LAUNCHES["ntt_inverse"] == 1


@pytest.mark.cuda
def test_cuda_lazy_ntt_refuses_an_unaligned_tensor(cuda):
    t = t_get_module(2048, 2, 28, cuda).tables
    flat = torch.zeros(2 * 2048 + 1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        tntt.ntt_forward(t, flat[1:].view(1, 2, 2048))
    assert torch.equal(tntt.ntt_forward(t, flat[1:].view(1, 2, 2048), design="parent"),
                       torch.zeros(1, 2, 2048, dtype=torch.int32, device=cuda))
