"""The second designs of the MXU transforms (`csrc/mxu_ntt.cu`
`mxu_forward_wg_kernel` and `mxu_inverse_wg_kernel`, the "wg" designs), of
the VMP (`csrc/vmp.cu` `vmp_tile_kernel`, the "tile" design) and of the
Garner exit (`csrc/garner_exit.cu` `garner_exit_tile_kernel`, the "tile"
design): their layout formulas and tables, and their CUDA launches at the
edges of a task or tile.

CPU part: `mxu.fwd_layout` and `mxu.wg_layout` (rows per task, tasks, grid,
shared bytes within the card's 232,448) at every N of the wg designs'
instances and at the paths' shapes, the instances and stage names against
the source, the tables of `mxu.wg_tables` (each a permutation or a
Montgomery twin of the parent's tables), `vmp.tile_layout` at the paths'
shapes and `VMP_SHAPES` against the source, `fused.EXIT_SHAPES` against the
source.

CUDA part (`-m cuda`, skipped without a card): both wg designs against the
plain version and the parent design at N 512 … 8192, one row, a task's rows
± 1, P 1 and 3 on 30-bit primes, residues p − 1 or limbs past int32, 1 to 4
digit planes, both folds, and their stage clocks; the
tile VMP against the plain version at K 1 … 17 (the runtime-shaped
instance's folds), M 1 … 13, one row, ragged row blocks, both bases, every
specialised shape; the tile exit against the plain version and its parent
at both specialised shapes and the runtime-shaped one.  These tests do not
touch JAX; on the machine with the card run them with

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_transform_tiles.py -q
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from poulpy_tpu_torch.backends import LAUNCHES, reset_launches
from poulpy_tpu_torch.backends import fused as tfused
from poulpy_tpu_torch.backends import mxu as tmxu
from poulpy_tpu_torch.backends import vmp as tvmp
from poulpy_tpu_torch.backends.mxu_ntt4 import _split
from poulpy_tpu_torch.hal.module import get_module as t_get_module
from poulpy_tpu_torch.hal.primes import R

CSRC = Path(__file__).resolve().parents[1] / "poulpy_tpu_torch" / "csrc"
H100_SMS = 132


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# --------------------------------------------------------------------------
# The wg design of the MXU inverse
# --------------------------------------------------------------------------

@pytest.mark.parametrize("logn", list(tmxu.WG_LOGN))
def test_wg_layout_fits_every_instance(logn):
    """A task is WG_MB / n2 rows of one prime: the N of step A's wgmma is
    128 at every N; its shared bytes (planes, staged input, step B's operand,
    each 512·n1) fit the card."""
    n = 1 << logn
    n1, n2 = _split(n)
    per_task, tasks, grid, smem = tmxu.wg_layout(n, 1000, 2, H100_SMS)
    assert per_task * n2 == tmxu.WG_MB
    assert tasks == -(-1000 // per_task) * 2 and grid == min(tasks, H100_SMS)
    assert smem == 3 * 512 * n1 <= tfused.SMEM_LIMIT


@pytest.mark.parametrize("rows,P,tasks,grid", [
    (131072, 2, 32768, 132),   # the product path's inverse: 16384 ciphertexts × 8 rows
    (2048, 2, 512, 132),       # the keyswitch path's (batch 256)
    (9, 1, 2, 2),              # a ragged task
    (1, 3, 3, 3),
])
def test_wg_layout_at_path_shapes(rows, P, tasks, grid):
    assert tmxu.wg_layout(2048, rows, P, H100_SMS) == (8, tasks, grid, 196608)


def test_wg_design_takes_its_instances_and_the_parent_the_rest():
    assert [n for n in (256, 512, 1024, 2048, 4096, 8192, 16384) if tmxu.wg_supported(n)] == [
        512, 1024, 2048, 4096, 8192]


def test_wg_instances_and_stages_match_the_source():
    """The source instantiates WgShape<LOGN> for exactly WG_LOGN, with the
    same task width; the stage names follow its enums."""
    src = (CSRC / "mxu_ntt.cu").read_text()
    assert sorted(map(int, re.findall(r"POULPY_WG\((\d+)\)", src))) == list(tmxu.WG_LOGN)
    assert re.search(rf"constexpr int WG_MB = {tmxu.WG_MB};", src)
    for design, prefix in (("parent", "INV"), ("wg", "WG")):
        enum = re.search(rf"enum \{{ ({prefix}_\w+(?:, {prefix}_\w+)*), {prefix}_NSTAGES \}};",
                         src).group(1)
        assert tuple(e[len(prefix) + 1:].lower() for e in enum.split(", ")) == \
            tmxu.STAGES[design]


@pytest.mark.parametrize("n,bits,split", [(512, 28, True), (2048, 30, True), (2048, 28, False)])
def test_wg_tables_rearrange_the_parent_tables(n, bits, split):
    """The step-A fragments and step-B weights hold the parent's weight bytes
    in another order (every byte once); step A's output constants are the
    parent's twiddles ti·R^{-1}·2^{-60} and that times 2^s; each fold's K is
    a multiple of p past the partials' bound (split, s 16) or 2^48 (s 32)."""
    m = t_get_module(n, 2, bits, "cpu")
    primes = m.basis.primes
    host = tmxu._host_tables_mxu(primes, n)
    wg = tmxu._host_wg_tables(primes, n, split)
    n1, n2 = _split(n)
    for pi, p in enumerate(primes):
        frag = wg["wa"][pi].view(np.int8).ravel()
        assert np.array_equal(np.sort(frag), np.sort(host["wa"][pi].ravel()))
        assert np.array_equal(np.sort(wg["w0"][pi]), np.sort(host["w0"][pi].ravel()))
        c = wg["primes"][pi].view(np.uint32).astype(object)
        shifts = []
        for fold, weights in ((c[0:4], host["wa"][pi]), (c[4:8], host["w0"][pi])):
            big = int(fold[2]) << 32 | int(fold[1])
            bound = 257 * 128 * int(np.abs(weights.astype(np.int64)).sum(axis=0).max())
            assert fold[0] == split and big % p == 0
            if split:
                assert bound <= big < bound + p and 2 * bound + p <= 2**32
            else:
                assert 2**48 <= big < 2**48 + p
            shifts.append(16 if split else 32)
        tw = wg["tw"][pi].view(np.uint32).astype(object)
        assert np.array_equal(tw[..., 0] * R * 2**60 % p, host["ti"][pi].astype(object))
        assert np.array_equal(tw[..., 2], tw[..., 0] * 2**shifts[0] % p)
        assert (c[8] * 2**60 % p, c[10]) == (1, c[8] * 2**shifts[1] % p)
        for val, quo in ((tw[..., 0], tw[..., 1]), (tw[..., 2], tw[..., 3]), (c[8], c[9]),
                         (c[10], c[11])):
            assert np.array_equal(quo, val * 2**32 // p)
    assert wg["wa"].shape == (2, n1 // 32, n1 // 8, 2, 128, 4)


def test_wg_fragment_of_one_thread():
    """Thread 32w + 4g + t of tile h, pair q, k-step s holds in register
    e + 2·kh the bytes wa[32s + 16kh + 4t + b, (2h + e)·n1 + 32q + 8w + g]."""
    n = 512
    m = t_get_module(n, 1, 28, "cpu")
    wa = tmxu._host_tables_mxu(m.basis.primes, n)["wa"][0]
    frag = tmxu._host_wg_tables(m.basis.primes, n)["wa"][0]
    n1 = _split(n)[0]
    q, s, h, w, g, t, kh, e = 1, 3, 1, 2, 5, 3, 1, 0
    word = int(frag[q, s, h, 32 * w + 4 * g + t, e + 2 * kh]) & 0xFFFFFFFF
    want = [int(wa[32 * s + 16 * kh + 4 * t + b, (2 * h + e) * n1 + 32 * q + 8 * w + g]) & 255
            for b in range(4)]
    assert [(word >> (8 * b)) & 255 for b in range(4)] == want


# --------------------------------------------------------------------------
# The wg design of the MXU forward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("logn", list(tmxu.WG_LOGN))
@pytest.mark.parametrize("P", [1, 2, 3, 8])
def test_fwd_layout_fits_every_instance(logn, P):
    """A task is one prime of 128 / n2 rows (64 / n2 at N 8192, where 128
    would not fit); its shared bytes (the staged int64 limbs, step B's
    operand, step A's weights of every prime where they fit, else of one)
    fit the card."""
    n = 1 << logn
    n1, n2 = _split(n)
    per_task, tasks, grid, smem = tmxu.fwd_layout(n, 1000, P, H100_SMS)
    mb = 64 if n == 8192 else 128
    assert per_task * n2 == mb
    assert tasks == -(-1000 // per_task) * P
    assert grid == min(tasks, H100_SMS)
    stage = per_task * n * 8                          # the staged limbs
    slots = P if stage + mb * 4 * n1 + P * (4 * n2) ** 2 <= tfused.SMEM_LIMIT else 1
    assert smem == stage + mb * 4 * n1 + slots * (4 * n2) ** 2 <= tfused.SMEM_LIMIT


@pytest.mark.parametrize("rows,P,groups", [
    (16384 * 6, 2, 12288),     # the product path's forward: 16384 ciphertexts × 6 input rows
    (256 * 3, 2, 96),          # the keyswitch path's (batch 256, 3 mask limbs)
    (64 * 6, 2, 48),           # the product path's verify batch
    (8 * 3, 2, 3),             # the keyswitch path's verify batch
    (9, 1, 2),                 # a ragged task
])
def test_fwd_layout_at_path_shapes(rows, P, groups):
    tasks = groups * P
    smem = 8 * 2048 * 8 + 128 * 512 + P * 64 * 64     # limbs, step B's operand, P primes' ua
    assert tmxu.fwd_layout(2048, rows, P, H100_SMS) == (8, tasks, min(tasks, H100_SMS), smem)


def test_fwd_instances_and_stages_match_the_source():
    """The source instantiates the forward's wg design for exactly WG_LOGN;
    its stage names follow its enum; its shared bytes follow fwd_smem."""
    src = (CSRC / "mxu_ntt.cu").read_text()
    assert sorted(map(int, re.findall(r"POULPY_FWD\((\d+)\)", src))) == list(tmxu.WG_LOGN)
    enum = re.search(r"enum \{ (FWD_\w+(?:, FWD_\w+)*), FWD_NSTAGES \};", src).group(1)
    assert tuple(e[4:].lower() for e in enum.split(", ")) == tmxu.FWD_STAGES["wg"]
    assert "return mb / n2 * n1 * n2 * 8 + mb * NDIG * n1 + ua_slots * NDIG * n2 * NDIG * n2;" in src


@pytest.mark.parametrize("n,bits,split", [(512, 28, True), (2048, 30, True), (2048, 28, False)])
def test_fwd_tables_rearrange_the_parent_tables(n, bits, split):
    """The forward's step-B fragments and step-A weights hold the parent's
    v0 and ua bytes in another order (every byte once); step A's output
    constants are the parent's twiddles tf·R^{-1}·2^{-60} and that times
    2^s; each fold's K as the inverse's."""
    m = t_get_module(n, 2, bits, "cpu")
    primes = m.basis.primes
    host = tmxu._host_tables_mxu(primes, n)
    wg = tmxu._host_wg_tables(primes, n, split, forward=True)
    n1, n2 = _split(n)
    assert set(wg) == {"v0", "ua", "tw", "primes"}
    assert wg["v0"].shape == (2, n1 // 32, n1 // 8, 2, 128, 4)
    for pi, p in enumerate(primes):
        assert np.array_equal(np.sort(wg["v0"][pi].view(np.int8).ravel()),
                              np.sort(host["v0"][pi].ravel()))
        assert np.array_equal(np.sort(wg["ua"][pi]), np.sort(host["ua"][pi].ravel()))
        c = wg["primes"][pi].view(np.uint32).astype(object)
        shifts = []
        for fold, weights in ((c[0:4], host["ua"][pi]), (c[4:8], host["v0"][pi])):
            big = int(fold[2]) << 32 | int(fold[1])
            bound = 257 * 128 * int(np.abs(weights.astype(np.int64)).sum(axis=0).max())
            assert fold[0] == (split and 2 * bound + p <= 2**32) and big % p == 0
            shifts.append(16 if fold[0] else 32)
        tw = wg["tw"][pi].view(np.uint32).astype(object)
        assert np.array_equal(tw[..., 0] * R * 2**60 % p, host["tf"][pi].astype(object))
        assert np.array_equal(tw[..., 2], tw[..., 0] * 2**shifts[0] % p)
        assert (c[8] * 2**60 % p, c[10]) == (1, c[8] * 2**shifts[1] % p)


# --------------------------------------------------------------------------
# The tile design of the Garner exit
# --------------------------------------------------------------------------

def test_exit_shapes_match_the_source():
    src = (CSRC / "garner_exit.cu").read_text()
    shapes = {tuple(map(int, d.split(","))) for d in
              re.findall(r"= ExitShape<(\d+, \d+, \d+, \d+, \d+, \d+)>;", src)}
    assert shapes - {(0,) * 6} == set(tfused.EXIT_SHAPES)


@pytest.mark.parametrize("shape", list(tfused.EXIT_SHAPES))
def test_exit_shapes_are_the_routes(shape):
    """Each specialised exit is the "mxu" route's at one of its paths: the
    product (bench.py: P 2, GGSW psize 4, 3 output limbs, base 17, no body)
    and the keyswitch (its 3-limb body added)."""
    P, psize, res_size, s_size, kr, ka = shape
    assert (P, psize, res_size, kr, ka) == (2, 4, 3, 17, 17) and s_size in (0, 3)


# --------------------------------------------------------------------------
# The tile design of the VMP
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B,P,n,rows,blocks", [
    (16384, 2, 2048, 64, 32 * 256),    # the "mxu" route's product
    (256, 2, 2048, 15, 32 * 18),       # the non-wide CKKS mul and the "mxu" keyswitch
    (64, 2, 2048, 3, 32 * 22),         # the product path's verify batch
    (1, 2, 256, 1, 4),
    (10**7, 1, 256, 153, 2 * 65360),   # the grid's y limit
])
def test_vmp_tile_layout(B, P, n, rows, blocks):
    """As many rows per block as TILE_MIN_BLOCKS blocks allow, up to
    TILE_ROWS_MAX, at least one, and no more row blocks than the grid takes."""
    got_rows, col_blocks, row_blocks = tvmp.tile_layout(B, P, n)
    assert (got_rows, col_blocks * row_blocks) == (rows, blocks)
    assert col_blocks == -(-(P * n) // tvmp.TILE_COLS) and row_blocks <= tvmp.GRID_Y_MAX


def test_vmp_shapes_match_the_source():
    src = (CSRC / "vmp.cu").read_text()
    shapes = {tuple(map(int, d.split(","))) for d in re.findall(r"= VmpShape<(\d+, \d+)>;", src)}
    assert shapes - {(0, 0)} == set(tvmp.VMP_SHAPES)
    assert re.search(rf"constexpr int TILE_COLS = {tvmp.TILE_COLS};", src)


# --------------------------------------------------------------------------
# CUDA: both designs at their edges
# --------------------------------------------------------------------------

def _residues(rng, primes, shape, edge=True):
    out = np.zeros(shape, dtype=np.int64)
    for i, p in enumerate(primes):
        out[..., i, :] = rng.integers(0, p, size=shape[:-2] + shape[-1:])
    if edge:
        out[0] = np.array(primes)[:, None] - 1
    return torch.from_numpy(out.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n,nprimes,prime_bits,rows,split", [
    (2048, 2, 28, 131, True),    # the path shape, ragged: 16 tasks and a 3-row one per prime
    (2048, 2, 30, 8, True),      # exactly one task per prime, 30-bit primes
    (2048, 2, 30, 9, False),     # the int64 fold
    (2048, 1, 28, 1, True),
    (512, 3, 30, 17, True),      # 16 rows per task + 1
    (1024, 2, 28, 15, False),    # 16 rows per task − 1
    (4096, 1, 30, 5, True),
    (8192, 2, 28, 3, True),      # past the parent design's shared memory
])
def test_cuda_wg_inverse_matches_plain_and_parent(cuda, monkeypatch, n, nprimes, prime_bits, rows,
                                                  split):
    monkeypatch.setattr(tmxu, "WG_SPLIT", split)
    m = t_get_module(n, nprimes, prime_bits, cuda)
    y = _residues(np.random.default_rng(91), m.basis.primes, (rows, nprimes, n)).to(cuda)
    want = tmxu.mxu4_inverse_ref(m.tables, y)
    reset_launches()
    have = tmxu.mxu4_inverse(m.tables, y)
    torch.cuda.synchronize()
    assert LAUNCHES["mxu_inverse"] == 1
    assert torch.equal(have, want)
    if n <= 4096:
        out, launch = tmxu._inverse_launch(m.tables, y, "parent")
        launch()
        assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["wg", "parent"])
def test_cuda_inverse_stage_clock(cuda, design):
    """The TIMED instance: the untimed output, a positive count per block and stage."""
    m = t_get_module(2048, 2, 28, cuda)
    y = _residues(np.random.default_rng(92), m.basis.primes, (300, 2, 2048)).to(cuda)
    out, stamps = tmxu.stage_cycles(m.tables, y, design)
    torch.cuda.synchronize()
    assert torch.equal(out, tmxu.mxu4_inverse_ref(m.tables, y))
    assert stamps.shape[1] == len(tmxu.STAGES[design]) and bool((stamps > 0).all())


def _limbs(rng, rows, n):
    """int64 limbs [rows, N], the first row starting with INT64_MIN, INT64_MAX
    and words past int32 (the forward wraps them to int32)."""
    x = rng.integers(-(2**40), 2**40, size=(rows, n))
    x[0, :4] = [-(2**63), 2**63 - 1, 2**31, -(2**31) - 1]
    return torch.from_numpy(x)


@pytest.mark.cuda
@pytest.mark.parametrize("n,nprimes,prime_bits,rows,nd_in,split", [
    (2048, 2, 28, 131, 3, True),     # the path's N and planes, ragged: 16 tasks and a 3-row one
    (2048, 2, 30, 8, 3, True),       # exactly one task, 30-bit primes
    (2048, 2, 30, 9, 4, False),      # the int64 fold
    (2048, 1, 28, 1, 1, True),
    (512, 3, 30, 17, 2, True),       # 16 rows per task + 1
    (1024, 2, 28, 15, 3, False),     # 16 rows per task − 1
    (4096, 3, 30, 5, 3, True),       # step A's weights one prime at a time
    (8192, 2, 28, 3, 4, True),       # 64 / n2 rows per task; past the parent's shared memory
])
def test_cuda_wg_forward_matches_plain_and_parent(cuda, monkeypatch, n, nprimes, prime_bits, rows,
                                                  nd_in, split):
    monkeypatch.setattr(tmxu, "WG_SPLIT", split)
    m = t_get_module(n, nprimes, prime_bits, cuda)
    x = _limbs(np.random.default_rng(96), rows, n).to(cuda)
    want = tmxu.mxu4_forward_limbs_ref(m.tables, x, nd_in)
    reset_launches()
    have = tmxu.mxu4_forward_limbs(m.tables, x, nd_in)
    torch.cuda.synchronize()
    assert LAUNCHES["mxu_forward"] == 1
    assert torch.equal(have, want)
    if n <= 4096:
        out, launch = tmxu._forward_launch(m.tables, x, nd_in, "parent")
        launch()
        assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["wg", "parent"])
def test_cuda_forward_stage_clock(cuda, design):
    """The TIMED instance: the untimed output, a positive count per block and stage."""
    m = t_get_module(2048, 2, 28, cuda)
    x = _limbs(np.random.default_rng(97), 300, 2048).to(cuda)
    out, stamps = tmxu.stage_cycles(m.tables, x, design, forward=True, nd_in=3)
    torch.cuda.synchronize()
    assert torch.equal(out, tmxu.mxu4_forward_limbs_ref(m.tables, x, 3))
    assert stamps.shape[1] == len(tmxu.FWD_STAGES[design]) and bool((stamps > 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,nprimes,prime_bits,B,co,psize,res_size,s_size,kr,ka", [
    (2048, 2, 28, 100, 2, 4, 3, 0, 17, 17),     # the product's instance
    (2048, 2, 30, 9, 2, 4, 3, 3, 17, 17),       # the keyswitch's: the body added
    (256, 2, 30, 3, 2, 4, 3, 3, 17, 17),        # its instance at N 256: one coefficient tile
    (1024, 5, 28, 3, 1, 16, 12, 16, 19, 13),    # runtime-shaped: P 5, psize 16, other bases
    (512, 1, 30, 2, 2, 3, 4, 2, 17, 17),        # runtime-shaped: P 1
    (512, 8, 28, 2, 2, 6, 6, 9, 17, 17),        # runtime-shaped: P 8, the body past psize
])
def test_cuda_exit_matches_plain_and_parent(cuda, n, nprimes, prime_bits, B, co, psize, res_size,
                                            s_size, kr, ka):
    m = t_get_module(n, nprimes, prime_bits, cuda)
    rng = np.random.default_rng(98)
    x = _residues(rng, m.basis.primes, (B, co, psize, nprimes, n)).to(cuda)
    small = None
    if s_size:
        body = rng.integers(-(2**62), 2**62, size=(B, s_size, n))
        body[0, 0, :2] = [-(2**63), 2**63 - 1]
        small = torch.from_numpy(body).to(cuda)
    want = tfused.garner_exit_ref(m, x, psize, res_size, kr, ka, small)
    reset_launches()
    have = tfused.garner_exit(m, x, psize, res_size, kr, ka, small)
    torch.cuda.synchronize()
    assert LAUNCHES["garner_exit"] == 1
    assert torch.equal(have, want)
    out, launch = tfused._exit_launch(m, x, psize, res_size, kr, ka, small, design="parent")
    launch()
    assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,nprimes,prime_bits,B,K,M", [
    (2048, 2, 28, 1000, 6, 8),     # RouteShape, ragged row blocks
    (2048, 2, 30, 257, 3, 8),      # KsShape
    (2048, 2, 28, 255, 6, 12),     # CkksShape
    (256, 1, 30, 1, 1, 1),         # runtime-shaped, one row
    (1024, 3, 30, 33, 16, 13),     # runtime-shaped: one fold, two output passes
    (512, 2, 30, 7, 17, 5),        # runtime-shaped: two folds
    (4096, 2, 28, 3, 12, 24),      # pm past shared memory: read through L1
])
def test_cuda_vmp_tile_matches_plain(cuda, n, nprimes, prime_bits, B, K, M):
    m = t_get_module(n, nprimes, prime_bits, cuda)
    rng = np.random.default_rng(93)
    a = _residues(rng, m.basis.primes, (B, K, nprimes, n)).to(cuda)
    pm = _residues(rng, m.basis.primes, (K, M, nprimes, n)).to(cuda)
    want = tvmp.vmp_apply_ref(m, a[:, :, None], pm[None, :, :, None]).reshape(B, M, nprimes, n)
    reset_launches()
    have = tvmp.vmp_kernel(m, a, pm)
    torch.cuda.synchronize()
    assert LAUNCHES["vmp"] == 1
    assert torch.equal(have, want)
    assert torch.equal(tvmp.vmp_kernel(m, a, pm, design="parent"), want)
