"""poulpy_tpu_torch kernels: plain versions against the JAX Pallas kernels,
and the CUDA kernels against their plain versions.

CPU part: the port's plain NTT, VMP and fused product equal the JAX
package's Pallas kernels run in TPU-interpret mode (as tests/test_fused.py
runs them), tolerance 0.

CUDA part (`-m cuda`, skipped without a card): each hand-written kernel
equals its plain PyTorch version on the same CUDA inputs, tolerance 0.  The
machine with the card has no JAX, so these tests do not touch it; run them
there with

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from poulpy_tpu_torch.backends import LAUNCHES
from poulpy_tpu_torch.backends import fused as tfused
from poulpy_tpu_torch.backends import ntt as tntt
from poulpy_tpu_torch.backends import vmp as tvmp
from poulpy_tpu_torch.backends import wide as twide
from poulpy_tpu_torch.hal.module import get_module as t_get_module
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BASES = [(2, 28), (2, 30)]


def _residues(rng, primes, shape):
    """Random standard-form residues [..., P, N] (int32)."""
    out = np.zeros(shape, dtype=np.int64)
    for i, p in enumerate(primes):
        out[..., i, :] = rng.integers(0, p, size=shape[:-2] + shape[-1:])
    return out.astype(np.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# --------------------------------------------------------------------------
# CPU: plain versions against the Pallas kernels in interpret mode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nprimes,prime_bits", BASES)
def test_plain_ntt_matches_pallas(nprimes, prime_bits):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from poulpy_tpu.backends import pallas_ntt
    from poulpy_tpu.hal.module import get_module

    n = 128
    t = get_module(n, nprimes, prime_bits).tables
    r = _residues(np.random.default_rng(11), t.basis.primes, (3, 2, nprimes, n))
    with pltpu.force_tpu_interpret_mode():
        want_f = np.asarray(pallas_ntt.pallas_ntt_forward(t, jnp.asarray(r)))
        want_i = np.asarray(pallas_ntt.pallas_ntt_inverse(t, jnp.asarray(r)))
    tt = t_get_module(n, nprimes, prime_bits, "cpu").tables
    assert np.array_equal(tntt.ntt_forward(tt, torch.from_numpy(r)).numpy(), want_f)
    assert np.array_equal(tntt.ntt_inverse(tt, torch.from_numpy(r)).numpy(), want_i)


@pytest.mark.parametrize("nprimes,prime_bits", BASES)
def test_plain_vmp_matches_pallas(nprimes, prime_bits):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from poulpy_tpu.backends.pallas_vmp import pallas_vmp_apply
    from poulpy_tpu.hal.module import get_module

    n = 64
    m = get_module(n, nprimes, prime_bits)
    rng = np.random.default_rng(12)
    a = _residues(rng, m.basis.primes, (3, 2, 3, nprimes, n))        # [B, ci, size, P, N]
    pmat = _residues(rng, m.basis.primes, (3, 2, 2, 4, nprimes, n))  # [rows, ci, co, psize]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_vmp_apply(m, jnp.asarray(a), jnp.asarray(pmat), 1, 4))
    tm = t_get_module(n, nprimes, prime_bits, "cpu")
    have = tvmp.vmp_apply(tm, torch.from_numpy(a), torch.from_numpy(pmat), 1, 4)
    assert np.array_equal(have.numpy(), want)


@pytest.mark.parametrize("nprimes,prime_bits", BASES)
@pytest.mark.parametrize("dsize,rows,size_a", [(1, 3, 3), (2, 3, 6)])
def test_plain_fused_matches_pallas(nprimes, prime_bits, dsize, rows, size_a):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from poulpy_tpu.backends.pallas_fused import fused_glwe_product
    from poulpy_tpu.hal.module import get_module

    n = 128
    m = get_module(n, nprimes, prime_bits)
    rng = np.random.default_rng(13)
    a = rng.integers(-(2**26), 2**26, size=(4, 2, size_a, n), dtype=np.int64)
    pmat = _residues(rng, m.basis.primes, (rows, 2, 2, 4, nprimes, n))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused_glwe_product(m, jnp.asarray(a), jnp.asarray(pmat), 3, 17, 17,
                                             t_tile=2, dsize=dsize))
    tm = t_get_module(n, nprimes, prime_bits, "cpu")
    have = tfused.fused_glwe_product_ref(tm, torch.from_numpy(a), torch.from_numpy(pmat), 3,
                                         17, 17, dsize=dsize)
    assert np.array_equal(have.numpy(), want)


def test_pm_kernel_layouts_match_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from poulpy_tpu.backends import pallas_fused as pf

    pmat = np.random.default_rng(14).integers(0, 1 << 28, size=(3, 2, 2, 4, 2, 16))
    for dsize, rmax in [(1, 3), (1, 2), (2, 6), (2, 5), (3, 4)]:
        want = pf.pm_kernel_layout(jnp.asarray(pmat), rmax) if dsize == 1 else \
            pf.pm_kernel_layout_dsize(jnp.asarray(pmat), rmax, dsize)
        have = tfused.pm_kernel_layout(torch.from_numpy(pmat), rmax) if dsize == 1 else \
            tfused.pm_kernel_layout_dsize(torch.from_numpy(pmat), rmax, dsize)
        assert np.array_equal(have.numpy(), np.asarray(want))


def test_cpu_wrappers_take_the_plain_version():
    m = t_get_module(64, 2, 28, "cpu")
    rng = np.random.default_rng(15)
    a = torch.from_numpy(rng.integers(-(2**20), 2**20, size=(2, 2, 3, 64)))
    pmat = torch.from_numpy(_residues(rng, m.basis.primes, (3, 2, 2, 4, 2, 64)))
    before = dict(LAUNCHES)
    have = tfused.fused_glwe_product(m, a, pmat, 3, 17, 17)
    want = tfused.fused_glwe_product_ref(m, a, pmat, 3, 17, 17)
    assert torch.equal(have, want)
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        tvmp.vmp_kernel(m, torch.zeros(1, 1, 2, 64, dtype=torch.int32),
                        torch.zeros(1, 1, 2, 64, dtype=torch.int32))


@pytest.mark.parametrize("nprimes,prime_bits", BASES)
def test_plain_fused_small_matches_pallas(nprimes, prime_bits):
    """The keyswitch pattern: the body added at column 0 before the
    normalization (as tests/test_fused.py runs it)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from poulpy_tpu.backends.pallas_fused import fused_glwe_product
    from poulpy_tpu.hal.module import get_module

    n = 128
    m = get_module(n, nprimes, prime_bits)
    rng = np.random.default_rng(16)
    a = rng.integers(-(2**16), 2**16, size=(3, 1, 3, n), dtype=np.int64)
    body = rng.integers(-(2**16), 2**16, size=(3, 3, n), dtype=np.int64)
    pmat = _residues(rng, m.basis.primes, (3, 1, 2, 4, nprimes, n))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused_glwe_product(m, jnp.asarray(a), jnp.asarray(pmat), 3, 17, 17,
                                             small=jnp.asarray(body), t_tile=2))
    tm = t_get_module(n, nprimes, prime_bits, "cpu")
    have = tfused.fused_glwe_product_ref(tm, torch.from_numpy(a), torch.from_numpy(pmat), 3, 17,
                                         17, small=torch.from_numpy(body))
    assert np.array_equal(have.numpy(), want)


def test_plain_br_block_step_matches_pallas():
    """The block-binary step (rot_mode 2, the reference's default) at one
    small shape, as tests/test_fused.py runs it."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from poulpy_tpu.backends.pallas_fused import fused_br_block_step, pm_kernel_layout
    from poulpy_tpu.binfhe.blind_rotation import _xpow_minus1_table
    from poulpy_tpu.hal.module import get_module

    n, nprimes, base2k, cols, size, rows, psize, block = 128, 2, 17, 2, 3, 3, 4, 4
    m = get_module(n, nprimes, 28)
    rng = np.random.default_rng(17)
    acc = rng.integers(-(2**16), 2**16, size=(3, cols, size, n), dtype=np.int64)
    pmats = _residues(rng, m.basis.primes, (block, rows, cols, cols, psize, nprimes, n))
    a_vals = rng.integers(-n, n + 1, size=(3, block), dtype=np.int64)
    with pltpu.force_tpu_interpret_mode():
        pm_k = jnp.swapaxes(pm_kernel_layout(jnp.asarray(pmats), min(rows, size)), 0, 1)
        xp = jnp.take(_xpow_minus1_table(n, m.basis.primes), a_vals & (2 * n - 1), axis=0)
        want = np.asarray(fused_br_block_step(m, jnp.asarray(acc), pm_k, xp.astype(jnp.int32),
                                              size, base2k, t_tile=2, rot_mode=2))
    tm = t_get_module(n, nprimes, 28, "cpu")
    have = tfused.fused_br_block_step_ref(tm, torch.from_numpy(acc), torch.from_numpy(pmats),
                                          torch.from_numpy(a_vals), size, base2k)
    assert np.array_equal(have.numpy(), want)


def test_cpu_gate_wrappers_take_the_plain_version():
    m = t_get_module(64, 2, 28, "cpu")
    rng = np.random.default_rng(18)
    a = torch.from_numpy(rng.integers(-(2**20), 2**20, size=(2, 1, 2, 64)))
    body = torch.from_numpy(rng.integers(-(2**16), 2**16, size=(2, 2, 64)))
    pmat = torch.from_numpy(_residues(rng, m.basis.primes, (2, 1, 2, 3, 2, 64)))
    acc = torch.from_numpy(rng.integers(-(2**16), 2**16, size=(2, 2, 2, 64)))
    pmats = torch.from_numpy(_residues(rng, m.basis.primes, (4, 4, 2, 2, 4, 2, 64)))
    amounts = torch.from_numpy(rng.integers(-64, 65, size=(2, 4)))
    before = dict(LAUNCHES)
    assert torch.equal(tfused.fused_glwe_product(m, a, pmat, 2, 17, 17, small=body),
                       tfused.fused_glwe_product_ref(m, a, pmat, 2, 17, 17, small=body))
    assert torch.equal(tfused.fused_br_block_step(m, acc, pmats, amounts, 2, 17),
                       tfused.fused_br_block_step_ref(m, acc, pmats, amounts, 2, 17))
    assert LAUNCHES == before


# --------------------------------------------------------------------------
# CUDA: each kernel against its plain version on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("nprimes,prime_bits", BASES + [(4, 30)])
@pytest.mark.parametrize("n", [16, 2048])
def test_cuda_ntt_matches_plain(cuda, nprimes, prime_bits, n):
    t = t_get_module(n, nprimes, prime_bits, cuda).tables
    x = torch.from_numpy(_residues(np.random.default_rng(21), t.basis.primes,
                                   (5, 3, nprimes, n))).to(cuda)
    f = tntt.ntt_forward(t, x)
    assert torch.equal(f, tntt.ntt_forward_ref(t, x))
    i = tntt.ntt_inverse(t, f)
    assert torch.equal(i, tntt.ntt_inverse_ref(t, f))
    assert torch.equal(i, x)


@pytest.mark.cuda
@pytest.mark.parametrize("nprimes,prime_bits", BASES)
@pytest.mark.parametrize("rows,size_a,limb_offset,res_size", [
    (3, 3, 0, None), (3, 2, 1, 4), (4, 3, 0, 2), (16, 16, 0, None)])
def test_cuda_vmp_matches_plain(cuda, nprimes, prime_bits, rows, size_a, limb_offset, res_size):
    # (16, 16): K = 32 terms of up to 2^60 each, past 2^63 on the 30-bit basis
    n = 256
    m = t_get_module(n, nprimes, prime_bits, cuda)
    rng = np.random.default_rng(22)
    a = torch.from_numpy(_residues(rng, m.basis.primes, (3, 2, size_a, nprimes, n))).to(cuda)
    pmat = torch.from_numpy(_residues(rng, m.basis.primes,
                                      (rows, 2, 2, 4, nprimes, n))).to(cuda)
    have = tvmp.vmp_apply(m, a, pmat, limb_offset, res_size)
    want = tvmp.vmp_apply_ref(m, a, pmat, limb_offset, res_size)
    assert torch.equal(have, want)


@pytest.mark.cuda
@pytest.mark.parametrize("nprimes,prime_bits", BASES)
@pytest.mark.parametrize("n,rows,size_a,psize,res_size,kr,ka,dsize", [
    (2048, 3, 3, 4, 3, 17, 17, 1),     # the headline shape
    (256, 3, 3, 3, 3, 17, 17, 1),      # res_size == psize: the reference schedule
    (256, 4, 3, 4, 5, 13, 19, 1),      # base change, rows > a_size
    (256, 3, 6, 4, 3, 17, 17, 2),      # dsize 2
    (256, 2, 6, 2, 2, 17, 17, 3),      # dsize 3, zero rows in the layout
])
def test_cuda_fused_matches_plain(cuda, nprimes, prime_bits, n, rows, size_a, psize, res_size,
                                  kr, ka, dsize):
    m = t_get_module(n, nprimes, prime_bits, cuda)
    rng = np.random.default_rng(23)
    a = torch.from_numpy(rng.integers(-(2**26), 2**26, size=(7, 2, size_a, n))).to(cuda)
    pmat = torch.from_numpy(_residues(rng, m.basis.primes,
                                      (rows, 2, 2, psize, nprimes, n))).to(cuda)
    before = LAUNCHES["fused_product"]
    have = tfused.fused_glwe_product(m, a, pmat, res_size, kr, ka, dsize)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_product"] == before + 1
    want = tfused.fused_glwe_product_ref(m, a, pmat, res_size, kr, ka, dsize)
    assert torch.equal(have, want)


@pytest.mark.cuda
@pytest.mark.parametrize("nprimes,prime_bits", BASES)
@pytest.mark.parametrize("n,rows,size_a,psize,s_size,res_size,dsize", [
    (1024, 2, 2, 3, 2, 2, 1),     # the gate keyswitch (k_ksk 51, dnum 2, k_ct 34)
    (2048, 3, 3, 4, 3, 3, 1),     # bench_full.py's keyswitch (k 68, dnum 3, k_ct 51)
    (256, 2, 6, 4, 6, 3, 2),      # dsize 2, body longer than the product
    (256, 3, 3, 4, 1, 4, 1),      # one body limb
])
def test_cuda_fused_small_matches_plain(cuda, nprimes, prime_bits, n, rows, size_a, psize,
                                        s_size, res_size, dsize):
    m = t_get_module(n, nprimes, prime_bits, cuda)
    rng = np.random.default_rng(24)
    a = torch.from_numpy(rng.integers(-(2**16), 2**16, size=(7, 1, size_a, n))).to(cuda)
    body = torch.from_numpy(rng.integers(-(2**16), 2**16, size=(7, s_size, n))).to(cuda)
    pmat = torch.from_numpy(_residues(rng, m.basis.primes,
                                      (rows, 1, 2, psize, nprimes, n))).to(cuda)
    before = LAUNCHES["fused_product_small"]
    have = tfused.fused_glwe_product(m, a, pmat, res_size, 17, 17, dsize, small=body)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_product_small"] == before + 1
    want = tfused.fused_glwe_product_ref(m, a, pmat, res_size, 17, 17, dsize, small=body)
    assert torch.equal(have, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,nprimes,prime_bits,size,rows,psize,res_size,block", [
    (1024, 2, 28, 2, 4, 4, 2, 8),   # the gate shape (k_ct 34, k_brk 68, dnum 4, block 8)
    (256, 2, 30, 3, 3, 4, 3, 4),
    (256, 4, 30, 2, 4, 4, 2, 7),
    (128, 2, 28, 3, 2, 2, 3, 1),    # acc longer than the product: its tail is dropped
])
def test_cuda_br_block_step_matches_plain(cuda, n, nprimes, prime_bits, size, rows, psize,
                                          res_size, block):
    m = t_get_module(n, nprimes, prime_bits, cuda)
    rng = np.random.default_rng(25)
    acc = torch.from_numpy(rng.integers(-(2**16), 2**16, size=(5, 2, size, n))).to(cuda)
    pmats = torch.from_numpy(_residues(rng, m.basis.primes,
                                       (block, rows, 2, 2, psize, nprimes, n))).to(cuda)
    amounts = rng.integers(-n, n + 1, size=(5, block))
    amounts[:3, 0] = [-n, n, 2 * n + 3]     # both ends, and past 2N
    amounts = torch.from_numpy(amounts).to(cuda)
    before = LAUNCHES["br_block_step"]
    have = tfused.fused_br_block_step(m, acc, pmats, amounts, res_size, 17)
    torch.cuda.synchronize()
    assert LAUNCHES["br_block_step"] == before + 1
    want = tfused.fused_br_block_step_ref(m, acc, pmats, amounts, res_size, 17)
    assert torch.equal(have, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,nprimes,prime_bits,batch,size,rows,block,steps", [
    (1024, 2, 28, 1023, 2, 4, 8, 2),   # the gate's chain: GateShape, a ragged tile
    (1024, 2, 28, 32, 3, 4, 7, 2),     # fheuint_prepare's (KK 6, res 3), runtime-shaped
    (256, 2, 30, 5, 3, 3, 4, 3),       # three steps, one in place
])
def test_cuda_br_block_chain_matches_plain(cuda, n, nprimes, prime_bits, batch, size, rows,
                                           block, steps):
    """`steps` block steps in one chained launch equal the plain chain,
    counted once under "br_block_chain" and never under "br_block_step"."""
    m = t_get_module(n, nprimes, prime_bits, cuda)
    rng = np.random.default_rng(26)
    acc = torch.from_numpy(rng.integers(-(2**16), 2**16, size=(batch, 2, size, n))).to(cuda)
    pmats = torch.from_numpy(_residues(rng, m.basis.primes,
                                       (steps * block, rows, 2, 2, 4, nprimes, n))).to(cuda)
    amounts = torch.from_numpy(rng.integers(-n, 3 * n, size=(batch, steps * block))).to(cuda)
    before = dict(LAUNCHES)
    have = tfused.fused_br_block_step(m, acc, pmats, amounts, size, 17, None, steps)
    torch.cuda.synchronize()
    assert LAUNCHES["br_block_chain"] == before["br_block_chain"] + 1
    assert LAUNCHES["br_block_step"] == before["br_block_step"]
    assert torch.equal(have, tfused.fused_br_block_step_ref(m, acc, pmats, amounts, size, 17,
                                                            steps))


@pytest.mark.cuda
@pytest.mark.parametrize("n,batch,size,rows,block,steps", [
    (1024, 1023, 2, 4, 8, 1),     # the gate's and the CBT's step: GateShape, a ragged tile
    (1024, 1023, 2, 4, 8, 2),     # their chain
    (1024, 32, 3, 4, 7, 1),       # fheuint_prepare's block 7 (KK 6, res 3), runtime-shaped
    (1024, 32, 3, 4, 7, 2),
])
def test_cuda_br_block_step_shoup_matches_plain(cuda, n, batch, size, rows, block, steps):
    """The Shoup instances (rot_mode 1) equal the plain rot_mode 1 step and
    the Montgomery instances' output, counted under the "_shoup" entries."""
    m = t_get_module(n, 2, 28, cuda)
    rng = np.random.default_rng(27)
    acc = torch.from_numpy(rng.integers(-(2**16), 2**16, size=(batch, 2, size, n))).to(cuda)
    pmats = torch.from_numpy(_residues(rng, m.basis.primes,
                                       (steps * block, rows, 2, 2, 4, 2, n))).to(cuda)
    amounts = torch.from_numpy(rng.integers(-n, 3 * n, size=(batch, steps * block))).to(cuda)
    args = (m, acc, pmats, amounts, size, 17, None, steps)
    name = "br_block_chain" if steps > 1 else "br_block_step"
    before = dict(LAUNCHES)
    have = tfused.fused_br_block_step(*args, rot_mode=1)
    torch.cuda.synchronize()
    assert LAUNCHES[name + "_shoup"] == before[name + "_shoup"] + 1
    assert LAUNCHES[name] == before[name]
    assert torch.equal(have, tfused.fused_br_block_step_ref(m, acc, pmats, amounts, size, 17,
                                                            steps, rot_mode=1))
    assert torch.equal(have, tfused.fused_br_block_step(*args, rot_mode=2))


@pytest.mark.cuda
@pytest.mark.parametrize("pattern,n,batch,ci,rows,size_a,psize,res_size,extra", [
    ("product", 2048, 64, 2, 3, 3, 4, 3, 0),      # bench.py's product
    ("small", 1024, 64, 1, 2, 2, 3, 2, 2),        # the gate's keyswitch with its body
    ("small64", 2048, 8, 1, 6, 6, 6, 12, 11),     # the relinearization
    ("product", 128, 5, 2, 3, 3, 4, 3, 0),
    ("product", 512, 3, 1, 2, 4, 4, 4, 0),        # rows < size_a
])
def test_cuda_fused_sl_product_matches_plain(cuda, pattern, n, batch, ci, rows, size_a, psize,
                                             res_size, extra):
    """The split layout's product, `small` and `small64` equal their plain
    version and the default kernel's output in both designs, one
    "fused_sl_product" launch each."""
    from poulpy_tpu_torch.backends import fused_sl as tsl

    m = t_get_module(n, 2, 28, cuda)
    rng = np.random.default_rng(28)
    a = torch.from_numpy(rng.integers(-(2**16), 2**16, size=(batch, ci, size_a, n))).to(cuda)
    pmat = torch.from_numpy(_residues(rng, m.basis.primes,
                                      (rows, ci, 2, psize, 2, n))).to(cuda)
    kw = {}
    if pattern == "small":
        kw["small"] = torch.from_numpy(rng.integers(-(2**16), 2**16,
                                                    size=(batch, extra, n))).to(cuda)
    elif pattern == "small64":
        kw["small64"] = torch.from_numpy(rng.integers(-(2**47), 2**47,
                                                      size=(batch, 2, extra, n))).to(cuda)
    args = (m, a, pmat, res_size, 17, 17)
    want = tsl.fused_glwe_product_sl_ref(*args, **kw)
    assert torch.equal(want, tfused.fused_glwe_product(*args, **kw))
    for design in tsl.DESIGNS:
        before = LAUNCHES["fused_sl_product"]
        have = tsl.fused_glwe_product_sl(*args, **kw, design=design)
        torch.cuda.synchronize()
        assert LAUNCHES["fused_sl_product"] == before + 1
        assert torch.equal(have, want), design


@pytest.mark.cuda
@pytest.mark.parametrize("n,prime_bits,batch,size,rows,block,rot_mode", [
    (1024, 28, 1023, 2, 4, 8, 2),      # the gate's block step
    (1024, 28, 1023, 2, 4, 8, 1),
    (1024, 28, 32, 3, 4, 7, 0),        # fheuint_prepare's block 7
    (256, 30, 5, 3, 3, 4, 0),
])
def test_cuda_fused_sl_block_step_matches_plain(cuda, n, prime_bits, batch, size, rows, block,
                                                rot_mode):
    """The split layout's block step equals its plain version and the
    default kernel's output under each rot_mode in both designs, one
    "fused_sl_block_step" launch each; a chain raises."""
    from poulpy_tpu_torch.backends import fused_sl as tsl

    m = t_get_module(n, 2, prime_bits, cuda)
    rng = np.random.default_rng(29)
    acc = torch.from_numpy(rng.integers(-(2**16), 2**16, size=(batch, 2, size, n))).to(cuda)
    pmats = torch.from_numpy(_residues(rng, m.basis.primes,
                                       (block, rows, 2, 2, 4, 2, n))).to(cuda)
    amounts = torch.from_numpy(rng.integers(-n, 3 * n, size=(batch, block))).to(cuda)
    args = (m, acc, pmats, amounts, size, 17)
    want = tsl.fused_br_block_step_sl_ref(*args, 1, rot_mode)
    assert torch.equal(want, tfused.fused_br_block_step(*args))
    for design in tsl.DESIGNS:
        before = LAUNCHES["fused_sl_block_step"]
        have = tsl.fused_br_block_step_sl(*args, rot_mode=rot_mode, design=design)
        torch.cuda.synchronize()
        assert LAUNCHES["fused_sl_block_step"] == before + 1
        assert torch.equal(have, want), design
    with pytest.raises(ValueError, match="one block step per launch"):
        tsl.fused_br_block_step_sl(*args, steps=2)


@pytest.mark.cuda
@pytest.mark.parametrize("n,pattern,rot_mode", [
    (4096, "small", 2), (8192, "product", 2), (4096, "block", 1), (8192, "block", 0),
])
def test_cuda_fused_sl_split_global_layout(cuda, n, pattern, rot_mode):
    """The split design past shared memory (N 4096 and 8192: the rows in a
    workspace slot per block, the blocks walking the tasks) equals the plain
    version; the parent design raises there."""
    from poulpy_tpu_torch.backends import fused_sl as tsl

    m = t_get_module(n, 2, 28, cuda)
    rng = np.random.default_rng(30)
    if pattern == "block":
        acc = torch.from_numpy(rng.integers(-(2**16), 2**16, size=(3, 2, 2, n))).to(cuda)
        pmats = torch.from_numpy(_residues(rng, m.basis.primes, (8, 4, 2, 2, 4, 2, n))).to(cuda)
        amounts = torch.from_numpy(rng.integers(-n, 3 * n, size=(3, 8))).to(cuda)
        args = (m, acc, pmats, amounts, 2, 17)
        assert tsl.sl_layout(4, 2, 4, 2, n, 8, split=False).kind == "global"
        have = tsl.fused_br_block_step_sl(*args, rot_mode=rot_mode)
        torch.cuda.synchronize()
        assert torch.equal(have, tsl.fused_br_block_step_sl_ref(*args, 1, rot_mode))
        with pytest.raises(ValueError, match="parent design"):
            tsl.fused_br_block_step_sl(*args, rot_mode=rot_mode, design="parent")
        return
    a = torch.from_numpy(rng.integers(-(2**16), 2**16, size=(3, 2, 3, n))).to(cuda)
    pmat = torch.from_numpy(_residues(rng, m.basis.primes, (3, 2, 2, 4, 2, n))).to(cuda)
    kw = {} if pattern == "product" else {
        "small": torch.from_numpy(rng.integers(-(2**16), 2**16, size=(3, 3, n))).to(cuda)}
    args = (m, a, pmat, 3, 17, 17)
    have = tsl.fused_glwe_product_sl(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(have, tsl.fused_glwe_product_sl_ref(*args, **kw))
    with pytest.raises(ValueError, match="parent design"):
        tsl.fused_glwe_product_sl(*args, **kw, design="parent")


@pytest.mark.cuda
@pytest.mark.parametrize("n,rot_mode", [(1024, None), (2048, None), (1024, 1), (4096, 0)])
def test_cuda_fused_sl_wide_column(cuda, n, rot_mode):
    """A column group of more output rows than the split design's VMP sums
    in one pass (the product's psize 10, the block step's 2 × 5): both
    designs (the parent to N 2048) equal the plain version (rot_mode None:
    the product)."""
    from poulpy_tpu_torch.backends import fused_sl as tsl

    m = t_get_module(n, 2, 28, cuda)
    rng = np.random.default_rng(31)
    if rot_mode is None:
        a = torch.from_numpy(rng.integers(-(2**16), 2**16, size=(5, 1, 3, n))).to(cuda)
        pmat = torch.from_numpy(_residues(rng, m.basis.primes, (3, 1, 2, 10, 2, n))).to(cuda)
        args = (m, a, pmat, 4, 17, 17)
        run, want = tsl.fused_glwe_product_sl, tsl.fused_glwe_product_sl_ref(*args)
        kw = {}
    else:
        acc = torch.from_numpy(rng.integers(-(2**16), 2**16, size=(5, 2, 2, n))).to(cuda)
        pmats = torch.from_numpy(_residues(rng, m.basis.primes, (4, 2, 2, 2, 5, 2, n))).to(cuda)
        amounts = torch.from_numpy(rng.integers(-n, 3 * n, size=(5, 4))).to(cuda)
        args = (m, acc, pmats, amounts, 2, 17)
        run, want = tsl.fused_br_block_step_sl, tsl.fused_br_block_step_sl_ref(*args, 1, rot_mode)
        kw = {"rot_mode": rot_mode}
    for design in tsl.DESIGNS if n <= 2048 else ("split",):
        have = run(*args, **kw, design=design)
        torch.cuda.synchronize()
        assert torch.equal(have, want), design


@pytest.mark.cuda
@pytest.mark.parametrize("block", [4, 1])
def test_cuda_gate_nand_matches_cpu(cuda, block):
    """The port's whole gate on the card equals the port's on the CPU."""
    from poulpy_tpu_torch.binfhe import gates
    from poulpy_tpu_torch.hal.source import Source

    params = gates.GateParams(n_glwe=256, n_lwe=16, nprimes=2, prime_bits=28, block_size=block)
    outs = []
    for device in ("cpu", cuda):
        keys, sk = gates.keygen(params, device=device)
        c1 = gates.encrypt_bit(params, [0, 0, 1, 1], sk, Source(b"\x05" * 32), Source(b"\x06" * 32))
        c2 = gates.encrypt_bit(params, [0, 1, 0, 1], sk, Source(b"\x07" * 32), Source(b"\x08" * 32))
        out = gates.gate_nand(keys, c1, c2)
        assert np.array_equal(gates.decrypt_bit(out, sk), [1, 1, 1, 0])
        outs.append(out.data.cpu())
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n,nprimes,prime_bits,ci,co,rows,size_a,psize,kr,ka,s_size,offset,dsize", [
    (64, 5, 28, 1, 2, 2, 2, 3, 52, 52, 0, 0, 1),      # tests/test_wide.py's five shapes
    (64, 5, 28, 1, 2, 2, 2, 3, 52, 52, 3, 0, 1),
    (64, 5, 28, 2, 2, 3, 3, 4, 44, 44, 0, 0, 1),
    (64, 5, 28, 1, 2, 3, 3, 3, 52, 52, 2, -7, 1),
    (64, 5, 28, 2, 2, 2, 2, 3, 26, 52, 0, 5, 1),
    (2048, 5, 28, 1, 2, 2, 2, 3, 52, 52, 3, 0, 1),    # the CKKS mul's relinearization
    (2048, 4, 30, 2, 2, 3, 2, 3, 44, 44, 0, 0, 1),    # a wide external product, 30-bit primes
    (256, 4, 30, 1, 2, 3, 2, 3, 44, 44, 2, 0, 1),     # a wide keyswitch (body in column 0)
    (256, 5, 28, 2, 2, 2, 4, 3, 52, 52, 0, 0, 2),     # dsize 2
])
def test_cuda_wide_product_matches_plain(cuda, n, nprimes, prime_bits, ci, co, rows, size_a,
                                         psize, kr, ka, s_size, offset, dsize):
    from poulpy_tpu_torch.backends import wide as twide

    m = t_get_module(n, nprimes, prime_bits, cuda)
    rng = np.random.default_rng(26)
    lim = 1 << (ka - 1)
    a = torch.from_numpy(rng.integers(-lim, lim, size=(6, ci, size_a, n))).to(cuda)
    pmat = torch.from_numpy(_residues(rng, m.basis.primes,
                                      (rows, ci, co, psize, nprimes, n))).to(cuda)
    small = None
    if s_size:
        small = torch.from_numpy(rng.integers(-lim, lim, size=(6, co, s_size, n))).to(cuda)
    before = LAUNCHES["wide_product"]
    have = twide.fused_glwe_product_wide(m, a, pmat, 2, kr, ka, small, offset, dsize)
    torch.cuda.synchronize()
    assert LAUNCHES["wide_product"] == before + 1
    want = twide.fused_glwe_product_wide_ref(m, a, pmat, 2, kr, ka, small, offset, dsize)
    assert torch.equal(have, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,size_a,size_b,dnum,lin_size,kr,ka,offset", [
    (64, 2, 2, 2, 3, 52, 52, 0),      # tests/test_wide.py's three shapes
    (64, 2, 3, 3, 3, 52, 52, -9),
    (64, 3, 3, 2, 4, 44, 52, 13),
    (2048, 2, 2, 2, 3, 52, 52, 13),   # the CKKS mul (k 95, tensor key dnum 2, landing offset 13)
])
def test_cuda_wide_tensor_matches_plain(cuda, n, size_a, size_b, dnum, lin_size, kr, ka, offset):
    from poulpy_tpu_torch.backends import wide as twide

    m = t_get_module(n, 5, 28, cuda)
    rng = np.random.default_rng(27)
    lim = 1 << (ka - 1)
    a = torch.from_numpy(rng.integers(-lim, lim, size=(6, 2, size_a, n))).to(cuda)
    b = torch.from_numpy(rng.integers(-lim, lim, size=(6, 2, size_b, n))).to(cuda)
    conv_size = size_a + size_b - 1
    before = LAUNCHES["wide_tensor"]
    have = twide.fused_tensor_product_wide(m, a, b, conv_size, dnum, lin_size, kr, ka, offset)
    torch.cuda.synchronize()
    assert LAUNCHES["wide_tensor"] == before + 1
    want = twide.fused_tensor_product_wide_ref(m, a, b, conv_size, dnum, lin_size, kr, ka, offset)
    assert torch.equal(have[0], want[0]) and torch.equal(have[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [True, False])
def test_cuda_ckks_mul_matches_cpu(cuda, wide):
    """The port's CKKS mul (fused wide pair, or NTT and VMP kernels) on the
    card equals the port's on the CPU."""
    from poulpy_tpu_torch.ckks import ops as ck
    from poulpy_tpu_torch.ckks.encoder import Encoder
    from poulpy_tpu_torch.core import encryption as enc
    from poulpy_tpu_torch.core.prepared import glwe_secret_prepare, glwe_tensor_key_prepare
    from poulpy_tpu_torch.hal.source import Source

    n = 256
    base2k, k_ct, k_key, ld, lb, dnum, nprimes = ((52, 95, 156, 30, 35, 2, 5) if wide
                                                  else (17, 95, 95, 22, 30, 6, 2))
    z = np.random.default_rng(28).normal(size=n // 2) + 0.5j
    outs = []
    for device in ("cpu", cuda):
        m = t_get_module(n, nprimes, 28, device)
        dist = {"dist": "ternary_hw", "hw": 32} if wide else {}
        sk = enc.secret_new(m, 1, Source(bytes(32)), **dist)
        skp = glwe_secret_prepare(m, sk)
        xe, xa = Source(b"\x01" * 32), Source(b"\x02" * 32)
        tsk = glwe_tensor_key_prepare(m, enc.glwe_tensor_key_encrypt_sk(
            m, sk, skp, base2k, k_key, dnum=dnum, source_xe=xe, source_xa=xa))
        pt = ck.encode(Encoder(n), z, base2k, k_ct, ld, lb, device=device)
        c = ck.encrypt_sk(m, pt, skp, k_ct, xe, xa, batch_shape=(3,))
        before = dict(LAUNCHES)
        out = ck.mul(m, c, c, tsk)
        if device != "cpu":
            torch.cuda.synchronize()
            used = {k for k in LAUNCHES if LAUNCHES[k] != before[k]}
            assert used == ({"wide_tensor", "wide_product"} if wide
                            else {"ntt_forward", "ntt_inverse", "vmp"})
        got = ck.decode(Encoder(n), ck.decrypt(m, out, skp))
        assert np.abs(got - z * z).max() < 1e-3
        outs.append(out.glwe.data.cpu())
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_cuda_wide_keyswitch_and_product_match_cpu(cuda):
    """tests/test_wide.py's wide keyswitch parameters (base2k 44, N 64,
    4 primes of 30 bits): the keyswitch and an external product by the GGSW
    of X on the card (one wide_product launch each) equal the CPU's."""
    from poulpy_tpu_torch.core import encryption as enc
    from poulpy_tpu_torch.core.external_product import glwe_external_product
    from poulpy_tpu_torch.core.keyswitching import glwe_keyswitch
    from poulpy_tpu_torch.core.prepared import gglwe_prepare, ggsw_prepare, glwe_secret_prepare
    from poulpy_tpu_torch.hal.source import Source

    outs = []
    for device in ("cpu", cuda):
        m = t_get_module(64, 4, 30, device)
        sk1 = enc.secret_new(m, 1, Source(b"\x01" * 32), dist="ternary_hw", hw=16)
        sk2p = glwe_secret_prepare(m, enc.secret_new(m, 1, Source(b"\x02" * 32),
                                                     dist="ternary_hw", hw=16))
        sk1p = glwe_secret_prepare(m, sk1)
        xe, xa = Source(b"\x03" * 32), Source(b"\x04" * 32)
        ct = enc.glwe_encrypt_sk(m, None, sk1p, 44, 88, xe, xa, batch_shape=(3,))
        ksk = gglwe_prepare(m, enc.glwe_switching_key_encrypt_sk(m, sk1, sk2p, 44, 132, 3, xe, xa))
        ptg = np.zeros(64, dtype=np.int64)
        ptg[1] = 1
        ggsw = ggsw_prepare(m, enc.ggsw_encrypt_sk(m, ptg, sk1p, 44, 132, 3, xe, xa))
        before = LAUNCHES["wide_product"]
        ks, prod = glwe_keyswitch(m, ct, ksk), glwe_external_product(m, ct, ggsw)
        if device != "cpu":
            torch.cuda.synchronize()
            assert LAUNCHES["wide_product"] == before + 2
        outs.append((ks.data.cpu(), prod.data.cpu()))
    assert all(torch.equal(c, g) for c, g in zip(*outs))


# --------------------------------------------------------------------------
# The column split, the small64 exit and the rank-1 tensor kernel
# --------------------------------------------------------------------------

def test_column_split_and_tensor_shared_memory():
    """The product kernels split output columns over blocks only where all
    of co does not fit (the CKKS keyswitch and relinearization: KK 6, co 2,
    psize 6, P 2, N 2048); the tensor kernel's parent workspace at the
    relinearize path's shape, and its bounds."""
    assert tfused.product_layout(6, 2, 4, 2, 2048).cpb == 2      # the headline product
    assert tfused.product_layout(2, 2, 3, 2, 1024).cpb == 2      # the gate keyswitch
    assert tfused.fused_smem_bytes(6, 2 * 6, 2, 2048) == 245760 > tfused.SMEM_LIMIT
    assert tfused.product_layout(6, 2, 6, 2, 2048).cpb == 1
    assert tfused.fused_smem_bytes(6, 6, 2, 2048) == 147456
    assert tfused.product_layout(6, 4, 3, 2, 2048).cpb == 2
    # one output column past shared memory: the global layout, no column split
    lay = tfused.product_layout(6, 2, 16, 8, 2048)
    assert (lay.kind, lay.cpb) == ("global", 2)
    assert tfused.tensor_smem_bytes(6, 6, 11, 2048) == 196608
    m = t_get_module(2048, 2, 28, "cpu")
    # past shared memory the tensor kernel takes its global layout: only its
    # compile-time bounds (P ≤ 8, limbs ≤ 16) remain
    assert tfused.tensor_fits(m, 6, 6, 11, 6) and tfused.tensor_fits(m, 8, 8, 15, 6)
    assert tfused.tensor_design_layout(8, 8, 15, 2, 2048).kind == "global"
    assert not tfused.tensor_fits(m, 9, 9, 17, 6)
    assert tfused.product_fits(m, 6, 6, 12, 11) and not tfused.product_fits(m, 6, 6, 12, 17)


@pytest.mark.cuda
@pytest.mark.parametrize("n,nprimes,prime_bits,size_a,size_b,dnum,kr,ka,lim", [
    (64, 2, 28, 3, 3, 4, 17, 17, 40),
    (64, 2, 30, 2, 3, 3, 13, 17, 40),
    (256, 3, 30, 4, 2, 5, 15, 17, 16),
    (2048, 2, 28, 6, 6, 6, 17, 17, 16),   # the relinearize path (k 95, conv 11, dnum 6)
])
def test_cuda_tensor_product_matches_plain(cuda, n, nprimes, prime_bits, size_a, size_b, dnum,
                                           kr, ka, lim):
    m = t_get_module(n, nprimes, prime_bits, cuda)
    rng = np.random.default_rng(29)
    a = torch.from_numpy(rng.integers(-(2**lim), 2**lim, size=(5, 2, size_a, n))).to(cuda)
    b = torch.from_numpy(rng.integers(-(2**lim), 2**lim, size=(5, 2, size_b, n))).to(cuda)
    conv_size = size_a + size_b - 1
    before = LAUNCHES["tensor_product"]
    have = tfused.fused_tensor_product(m, a, b, conv_size, dnum, kr, ka)
    torch.cuda.synchronize()
    assert LAUNCHES["tensor_product"] == before + 1
    want = tfused.fused_tensor_product_ref(m, a, b, conv_size, dnum, kr, ka)
    assert torch.equal(have[0], want[0]) and torch.equal(have[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n,nprimes,prime_bits,rows,psize,s64,res_size,dsize", [
    (256, 2, 28, 3, 4, 7, 8, 1),      # linear terms longer than the product
    (256, 2, 30, 3, 4, 3, 5, 1),      # and shorter
    (256, 3, 30, 4, 3, 6, 6, 2),      # dsize 2
    (2048, 2, 28, 6, 6, 11, 12, 1),   # the relinearize path: two blocks per ciphertext
])
def test_cuda_fused_small64_matches_plain(cuda, n, nprimes, prime_bits, rows, psize, s64,
                                          res_size, dsize):
    m = t_get_module(n, nprimes, prime_bits, cuda)
    rng = np.random.default_rng(30)
    a = torch.from_numpy(rng.integers(-(2**16), 2**16, size=(6, 1, rows * dsize, n))).to(cuda)
    small64 = torch.from_numpy(rng.integers(-(2**47), 2**47, size=(6, 2, s64, n))).to(cuda)
    pmat = torch.from_numpy(_residues(rng, m.basis.primes,
                                      (rows, 1, 2, psize, nprimes, n))).to(cuda)
    before = LAUNCHES["fused_product_small64"]
    have = tfused.fused_glwe_product(m, a, pmat, res_size, 17, 17, dsize, small64=small64)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_product_small64"] == before + 1
    want = tfused.fused_glwe_product_ref(m, a, pmat, res_size, 17, 17, dsize, small64=small64)
    assert torch.equal(have, want)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["product", "small", "small64"])
def test_cuda_fused_column_split_matches_plain(cuda, pattern):
    """N 2048, P 2, KK 6, co 2, psize 6: all of co needs 245,760 B of shared
    memory, so each output column takes a block of its own."""
    m = t_get_module(2048, 2, 28, cuda)
    rng = np.random.default_rng(31)
    a = torch.from_numpy(rng.integers(-(2**16), 2**16, size=(9, 1, 6, 2048))).to(cuda)
    pmat = torch.from_numpy(_residues(rng, m.basis.primes, (6, 1, 2, 6, 2, 2048))).to(cuda)
    kw = {}
    if pattern == "small":
        kw["small"] = torch.from_numpy(rng.integers(-(2**16), 2**16, size=(9, 6, 2048))).to(cuda)
    elif pattern == "small64":
        kw["small64"] = torch.from_numpy(rng.integers(-(2**47), 2**47,
                                                      size=(9, 2, 11, 2048))).to(cuda)
    counter = {"product": "fused_product", "small": "fused_product_small",
               "small64": "fused_product_small64"}[pattern]
    before = LAUNCHES[counter]
    have = tfused.fused_glwe_product(m, a, pmat, 6, 17, 17, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES[counter] == before + 1
    assert torch.equal(have, tfused.fused_glwe_product_ref(m, a, pmat, 6, 17, 17, **kw))


def _ckks_keys(device, n):
    """The ckks configuration's secret, tensor key and automorphism keys (5
    and −1) at degree n, and two encryptions of random slots (batch 3)."""
    from poulpy_tpu_torch.ckks import ops as ck
    from poulpy_tpu_torch.ckks.encoder import Encoder
    from poulpy_tpu_torch.core import encryption as enc
    from poulpy_tpu_torch.core.prepared import (
        GLWEAutomorphismKeyPrepared,
        gglwe_prepare,
        glwe_secret_prepare,
        glwe_tensor_key_prepare,
    )
    from poulpy_tpu_torch.hal.source import Source

    m = t_get_module(n, 2, 28, device)
    sk = enc.secret_new(m, 1, Source(bytes(32)))
    skp = glwe_secret_prepare(m, sk)
    xe, xa = Source(b"\x01" * 32), Source(b"\x02" * 32)
    tsk = glwe_tensor_key_prepare(m, enc.glwe_tensor_key_encrypt_sk(m, sk, skp, 17, 95, 6, xe, xa))
    atk = {}
    for p in (m.galois_element(1), -1):
        key, _ = enc.glwe_automorphism_key_encrypt_sk(m, p, sk, 17, 95, 6, xe, xa)
        atk[p] = GLWEAutomorphismKeyPrepared(key=gglwe_prepare(m, key), p=p)
    z = np.random.default_rng(32).normal(size=n // 2) + 0.25j
    pt = ck.encode(Encoder(n), z, 17, 95, 22, 30, device=device)
    cts = [ck.encrypt_sk(m, pt, skp, 95, xe, xa, batch_shape=(3,)) for _ in range(2)]
    return m, tsk, atk, cts


@pytest.mark.cuda
def test_cuda_relinearize_and_rotations_match_cpu(cuda):
    """glwe_tensor_relinearize (one tensor_product and one
    fused_product_small64 launch), and CKKS rotate / conjugate and the
    keyswitch under them (one fused_product_small launch each) at the ckks
    configuration (key k 95, dnum 6) on N 2048, where the keyswitch's
    product needs the column split, equal the port's CPU results (which
    equal the JAX package's: tests/test_torch_relin.py,
    tests/test_torch_automorphism.py)."""
    from poulpy_tpu_torch.ckks import ops as ck
    from poulpy_tpu_torch.core.keyswitching import glwe_keyswitch
    from poulpy_tpu_torch.core.operations import glwe_tensor_relinearize

    outs = []
    for device in ("cpu", cuda):
        m, tsk, atk, (c1, c2) = _ckks_keys(device, 2048)
        before = dict(LAUNCHES)
        res = [glwe_tensor_relinearize(m, c1.glwe, c2.glwe, tsk).data]
        if device != "cpu":
            torch.cuda.synchronize()
            used = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
            assert used == {"tensor_product": 1, "fused_product_small64": 1}
        for p, key in atk.items():
            before = LAUNCHES["fused_product_small"]
            res.append((ck.rotate if p != -1 else ck.conjugate)(m, c1, key).glwe.data)
            res.append(glwe_keyswitch(m, c1.glwe, key.key).data)
            if device != "cpu":
                assert LAUNCHES["fused_product_small"] == before + 2
        outs.append([r.cpu() for r in res])
    assert all(torch.equal(c, g) for c, g in zip(*outs))


# --------------------------------------------------------------------------
# The global layout: each product kernel past shared memory
# --------------------------------------------------------------------------

# (kernel, N, P, its layout) at the shapes whose rows do not fit in shared
# memory: bench.py's product at N 8192, the CKKS key's keyswitch and
# relinearization exits and the gate's block step at N 4096, the CKKS-wide
# pair at N 4096
LARGE_N = {
    "fused_product": (8192, 2, lambda: tfused.product_layout(6, 2, 4, 2, 8192)),
    "fused_product_small": (4096, 2, lambda: tfused.product_layout(6, 2, 6, 2, 4096)),
    "fused_product_small64": (4096, 2, lambda: tfused.product_layout(6, 2, 6, 2, 4096)),
    "br_block_step": (4096, 2, lambda: tfused.product_layout(4, 2, 4, 2, 4096, split=False)),
    "wide_product": (4096, 5, lambda: tfused.product_layout(2, 2, 3, 5, 4096)),
    "wide_tensor": (4096, 5, lambda: twide.tensor_wide_layout(2, 2, 3, 5, 4096)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", LARGE_N)
def test_cuda_global_layout_matches_plain(cuda, kernel):
    """Each butterfly product kernel at a shape past shared memory takes the
    global layout, launches once and equals its plain version (batch 2–3)."""
    n, P, layout = LARGE_N[kernel]
    assert layout().kind == "global"
    m = t_get_module(n, P, 28, cuda)
    rng = np.random.default_rng(29)

    def ints(lim, shape):
        return torch.from_numpy(rng.integers(-lim, lim, size=shape)).to(cuda)

    def residues(shape):
        return torch.from_numpy(_residues(rng, m.basis.primes, shape)).to(cuda)

    if kernel == "fused_product":
        args = (m, ints(2**16, (2, 2, 3, n)), residues((3, 2, 2, 4, P, n)), 3, 17, 17)
        run, plain = (lambda: tfused.fused_glwe_product(*args),
                      lambda: tfused.fused_glwe_product_ref(*args))
    elif kernel == "fused_product_small":
        args = (m, ints(2**16, (3, 1, 6, n)), residues((6, 1, 2, 6, P, n)), 6, 17, 17)
        body = ints(2**16, (3, 6, n))
        run, plain = (lambda: tfused.fused_glwe_product(*args, small=body),
                      lambda: tfused.fused_glwe_product_ref(*args, small=body))
    elif kernel == "fused_product_small64":
        args = (m, ints(2**16, (2, 1, 6, n)), residues((6, 1, 2, 6, P, n)), 12, 17, 17)
        lin = ints(2**47, (2, 2, 11, n))
        run, plain = (lambda: tfused.fused_glwe_product(*args, small64=lin),
                      lambda: tfused.fused_glwe_product_ref(*args, small64=lin))
    elif kernel == "br_block_step":
        amounts = torch.from_numpy(rng.integers(-n, 3 * n, size=(2, 8))).to(cuda)
        args = (m, ints(2**16, (2, 2, 2, n)), residues((8, 4, 2, 2, 4, P, n)), amounts, 2, 17)
        run, plain = (lambda: tfused.fused_br_block_step(*args),
                      lambda: tfused.fused_br_block_step_ref(*args))
    elif kernel == "wide_product":
        args = (m, ints(2**51, (2, 1, 2, n)), residues((2, 1, 2, 3, P, n)), 2, 52, 52)
        lin = ints(2**51, (2, 2, 3, n))
        run, plain = (lambda: twide.fused_glwe_product_wide(*args, small=lin),
                      lambda: twide.fused_glwe_product_wide_ref(*args, small=lin))
    else:
        args = (m, ints(2**51, (2, 2, 2, n)), ints(2**51, (2, 2, 2, n)), 3, 2, 3, 52, 52, 13)
        def flat(fn):
            return lambda: torch.cat([x.flatten() for x in fn(*args)])

        run, plain = (flat(twide.fused_tensor_product_wide),
                      flat(twide.fused_tensor_product_wide_ref))
    before = LAUNCHES[kernel]
    have = run()
    torch.cuda.synchronize()
    assert LAUNCHES[kernel] == before + 1
    assert torch.equal(have, plain())
