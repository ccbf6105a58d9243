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
from poulpy_tpu_torch.hal.module import get_module as t_get_module

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
    tt = t_get_module(n, nprimes, prime_bits).tables
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
    tm = t_get_module(n, nprimes, prime_bits)
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
    tm = t_get_module(n, nprimes, prime_bits)
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
    m = t_get_module(64, 2, 28)
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
