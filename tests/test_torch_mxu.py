"""The MXU route of poulpy_tpu_torch (four-step digit-plane NTT, Garner
exit, fused MXU product) against the JAX package, bit for bit, and its CUDA
kernels against their plain versions.

CPU part: seeded numpy inputs through both packages, tolerance 0.  The JAX
package's Pallas kernels run in TPU-interpret mode, as its own tests run
them; its jnp four-step and dense transforms and its jnp product path are
the other references.  Small N only.

CUDA part (`-m cuda`, skipped without a card): each new kernel equals its
plain version on the same CUDA inputs, tolerance 0, and both routes equal
the butterfly route.  These tests do not touch JAX; on the machine with the
card run them with

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_mxu.py -q
"""

import numpy as np
import pytest
import torch

from poulpy_tpu_torch.backends import LAUNCHES, reset_launches
from poulpy_tpu_torch.backends import fused as tfused
from poulpy_tpu_torch.backends import fused_mxu as tfm
from poulpy_tpu_torch.backends import mxu as tmx
from poulpy_tpu_torch.backends import mxu_ntt as tdense
from poulpy_tpu_torch.backends import mxu_ntt4 as t4
from poulpy_tpu_torch.backends import mxu_product as tmp
from poulpy_tpu_torch.hal.module import get_module as t_get_module


def _residues(rng, primes, shape):
    """Random standard-form residues [..., P, N] (int32)."""
    out = np.zeros(shape, dtype=np.int64)
    for i, p in enumerate(primes):
        out[..., i, :] = rng.integers(0, p, size=shape[:-2] + shape[-1:])
    return out.astype(np.int32)


def _jax_reference_product(jm, a, pmat, res_size, kr, ka, small=None):
    """The JAX package's jnp product path, jitted: dft → vmp → idft → (+ small
    at column 0) → big_normalize."""
    import jax

    from poulpy_tpu.hal import dft

    def product(a, pmat, small):
        big = dft.idft_apply(jm, dft.vmp_apply(jm, dft.dft_apply(jm, a), pmat))
        if small is not None:
            upto = min(small.shape[-2], pmat.shape[3])
            big = big.at[..., 0, :upto, :].add(small[..., :upto, :])
        return dft.big_normalize(jm, res_size, kr, big, ka)

    return np.asarray(jax.jit(product)(a, pmat, small))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# --------------------------------------------------------------------------
# CPU: the ops paths and the tables
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,nprimes,prime_bits", [(64, 2, 28), (64, 4, 30), (256, 2, 30)])
def test_mxu4_transforms_match_jax(n, nprimes, prime_bits):
    from poulpy_tpu.backends import mxu_ntt4 as j4
    from poulpy_tpu.hal.module import get_module

    t = get_module(n, nprimes, prime_bits).tables
    tt = t_get_module(n, nprimes, prime_bits, "cpu").tables
    rng = np.random.default_rng(21)
    x = rng.integers(-(2**29), 2**29, size=(3, 2, n))
    small = rng.integers(-(2**16), 2**16, size=(2, n))
    want = np.array(j4.mxu4_ntt_forward_limbs(t, x))     # a writable copy for torch
    assert np.array_equal(t4.mxu4_ntt_forward_limbs(tt, torch.from_numpy(x)).numpy(), want)
    assert np.array_equal(t4.mxu4_ntt_forward_limbs(tt, torch.from_numpy(small), 3).numpy(),
                          np.asarray(j4.mxu4_ntt_forward_limbs(t, small, 3)))
    assert np.array_equal(t4.mxu4_ntt_inverse(tt, torch.from_numpy(want)).numpy(),
                          np.asarray(j4.mxu4_ntt_inverse(t, want)))


@pytest.mark.parametrize("nprimes,prime_bits", [(2, 28), (4, 30)])
def test_sigma_and_tables_match_jax(nprimes, prime_bits):
    from poulpy_tpu.backends import mxu_ntt4 as j4
    from poulpy_tpu.backends import pallas_mxu as pmx
    from poulpy_tpu.hal.module import get_module

    n = 256
    t = get_module(n, nprimes, prime_bits).tables
    primes = t.basis.primes
    assert primes == t_get_module(n, nprimes, prime_bits, "cpu").basis.primes
    assert np.array_equal(t4.sigma_from_hal(primes, n), j4.sigma_from_hal(primes, n))
    want, have = pmx._host_tables_mxu(primes, n), tmx._host_tables_mxu(primes, n)
    assert sorted(want) == sorted(have)
    for k in want:
        assert want[k].dtype == have[k].dtype and np.array_equal(want[k], have[k]), k
    jw, tw = j4.get_weights4(t), t4._weights(primes, n)
    for k in ("ua", "vb", "wa", "wb"):
        assert np.array_equal(getattr(jw, k), getattr(tw, k)), k


def test_dense_mxu_ntt_matches_jax():
    from poulpy_tpu.backends import mxu_ntt as jdense
    from poulpy_tpu.hal.module import get_module

    n = 64
    t = get_module(n, 2).tables
    tt = t_get_module(n, 2, 30, "cpu").tables
    x = np.random.default_rng(22).integers(-(2**30), 2**30, size=(3, n))
    r = np.array(jdense.mxu_ntt_forward_limbs(t, x))
    assert np.array_equal(tdense.mxu_ntt_forward_limbs(tt, torch.from_numpy(x)).numpy(), r)
    assert np.array_equal(tdense.mxu_ntt_inverse(tt, torch.from_numpy(r)).numpy(),
                          np.asarray(jdense.mxu_ntt_inverse(t, r)))
    assert np.array_equal(tdense.mxu_ntt_forward(tt, torch.from_numpy(r)).numpy(),
                          np.asarray(jdense.mxu_ntt_forward(t, r)))
    assert np.array_equal(tdense._np_weights(t.basis.primes, n, True),
                          jdense._np_weights(t.basis.primes, n, True))


def test_fragment_order():
    """`fragments` puts W[32·ks + 16·h + 4·t + b, 8·ct + g] at lane 4·g + t,
    byte 4·h + b (the m16n8k32 B-operand layout)."""
    w = np.random.default_rng(23).integers(-128, 128, size=(2, 64, 32)).astype(np.int8)
    f = tmx.fragments(w)
    assert f.shape == (2, 4, 2, 32, 8)
    ct, ks, g, t, h, b = np.meshgrid(*map(np.arange, (4, 2, 8, 4, 2, 4)), indexing="ij")
    got = f[1, ct, ks, 4 * g + t, 4 * h + b]
    assert np.array_equal(got, w[1][32 * ks + 16 * h + 4 * t + b, 8 * ct + g])


# --------------------------------------------------------------------------
# CPU: plain versions against the Pallas kernels in interpret mode
# --------------------------------------------------------------------------

def test_plain_mxu_transforms_match_pallas():
    from jax.experimental.pallas import tpu as pltpu

    from poulpy_tpu.backends import pallas_mxu as pmx
    from poulpy_tpu.hal.module import get_module

    n = 256
    t = get_module(n, 2, 28).tables
    tt = t_get_module(n, 2, 28, "cpu").tables
    rng = np.random.default_rng(31)
    x = rng.integers(-(2**16), 2**16, size=(5, n))
    y = _residues(rng, t.basis.primes, (5, 2, n))
    with pltpu.force_tpu_interpret_mode():
        want_f = np.asarray(pmx.pallas_mxu4_forward_limbs(t, x, 3, tr=4))
        want_i = np.asarray(pmx.pallas_mxu4_inverse(t, y, tr=4))
    assert np.array_equal(tmx.mxu4_forward_limbs(tt, torch.from_numpy(x), 3).numpy(), want_f)
    assert np.array_equal(tmx.mxu4_inverse(tt, torch.from_numpy(y)).numpy(), want_i)


@pytest.mark.parametrize("s_size", [0, 3])
def test_plain_garner_exit_matches_pallas(s_size):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from poulpy_tpu.backends.pallas_fused import _kernel_b_fn
    from poulpy_tpu.hal.module import get_module

    n, P, B, co, psize, res_size, kr = 128, 2, 2, 2, 4, 3, 17
    m = get_module(n, P, 28)
    rng = np.random.default_rng(32)
    x = _residues(rng, m.basis.primes, (B, co, psize, P, n))
    small = rng.integers(-(2**16), 2**16, size=(B, s_size, n)) if s_size else None
    xj = jnp.asarray(np.moveaxis(x, 3, 0).reshape(P, B * co * psize, n))
    smj = None
    if s_size:   # the JAX layout: the body spread to per-(b, co) rows, zero at co > 0
        spread = np.zeros((B, co, s_size, n), dtype=np.int32)
        spread[:, 0] = small
        smj = jnp.asarray(spread.reshape(B * co * s_size, n))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_kernel_b_fn(n, m.basis.primes, psize, s_size, res_size, kr, kr, 0,
                                       4)(xj, smj)).reshape(B, co, res_size, n)
    tm = t_get_module(n, P, 28, "cpu")
    have = tfused.garner_exit(tm, torch.from_numpy(x), psize, res_size, kr, kr,
                              None if small is None else torch.from_numpy(small))
    assert np.array_equal(have.numpy(), want)


# --------------------------------------------------------------------------
# CPU: the two product routes against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nprimes,prime_bits", [(2, 28), (4, 30)])
@pytest.mark.parametrize("s_size", [0, 3])
def test_mxu_products_match_jax(nprimes, prime_bits, s_size):
    """mxu_glwe_product and fused_mxu_glwe_product (with and without the body)
    against the JAX package's jnp product path."""
    from poulpy_tpu.hal.module import get_module

    n, ci, co, rows, size_a, psize, res_size, kr = 256, 2, 2, 3, 3, 4, 3, 17
    jm = get_module(n, nprimes, prime_bits)
    rng = np.random.default_rng(41 + s_size)
    a = rng.integers(-(2**16), 2**16, size=(3, ci if not s_size else 1, size_a, n))
    pmat = _residues(rng, jm.basis.primes, (rows, a.shape[1], co, psize, nprimes, n))
    small = rng.integers(-(2**16), 2**16, size=(3, s_size, n)) if s_size else None
    want = _jax_reference_product(jm, a, pmat, res_size, kr, kr, small)
    tm = t_get_module(n, nprimes, prime_bits, "cpu")
    args = (torch.from_numpy(a), torch.from_numpy(pmat), res_size, kr, kr)
    tsmall = None if small is None else torch.from_numpy(small)
    assert np.array_equal(tmp.mxu_glwe_product(tm, *args, small=tsmall, in_bits=23).numpy(),
                          want)
    assert np.array_equal(tfm.fused_mxu_glwe_product(tm, *args, small=tsmall).numpy(), want)


def test_mxu_product_matches_jax_interpret():
    """The JAX package's mxu_glwe_product (Pallas transforms, VMP and kernel
    B in interpret mode) against the port's, with the body."""
    from jax.experimental.pallas import tpu as pltpu

    from poulpy_tpu.backends.mxu_product import mxu_glwe_product
    from poulpy_tpu.hal.module import get_module

    n, P = 128, 2
    jm = get_module(n, P, 28)
    rng = np.random.default_rng(43)
    a = rng.integers(-(2**16), 2**16, size=(3, 2, 3, n))
    pmat = _residues(rng, jm.basis.primes, (3, 2, 2, 4, P, n))
    small = rng.integers(-(2**20), 2**20, size=(3, 3, n))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(mxu_glwe_product(jm, a, pmat, 3, 17, 17, small=small, in_bits=21))
    have = tmp.mxu_glwe_product(t_get_module(n, P, 28, "cpu"), torch.from_numpy(a),
                                torch.from_numpy(pmat), 3, 17, 17, small=torch.from_numpy(small),
                                in_bits=21)
    assert np.array_equal(have.numpy(), want)


def test_fused_mxu_product_matches_jax_interpret_and_wraps_to_int32():
    """The JAX package's fused MXU kernel in interpret mode against the
    port's plain version, with the body and with limbs outside int32 range,
    which both packages wrap to int32 (`astype` / `Tensor.to`)."""
    from jax.experimental.pallas import tpu as pltpu

    from poulpy_tpu.backends.pallas_fused_mxu import fused_mxu_glwe_product
    from poulpy_tpu.hal.module import get_module

    n, P = 256, 2
    jm = get_module(n, P, 28)
    rng = np.random.default_rng(44)
    a = rng.integers(-(2**16), 2**16, size=(2, 1, 3, n))
    a[0, 0, 1, :8] += np.array([2**33, -(2**35), 2**31, -(2**31) - 1, 2**40, 3 << 32, -5, 7])
    pmat = _residues(rng, jm.basis.primes, (3, 1, 2, 4, P, n))
    small = rng.integers(-(2**16), 2**16, size=(2, 3, n))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused_mxu_glwe_product(jm, a, pmat, 3, 17, 17, small=small, t_tile=2))
    have = tfm.fused_mxu_glwe_product(t_get_module(n, P, 28, "cpu"), torch.from_numpy(a),
                                      torch.from_numpy(pmat), 3, 17, 17,
                                      small=torch.from_numpy(small))
    assert np.array_equal(have.numpy(), want)
    # the wrap changes the result: the butterfly route reduces the full int64
    butterfly = tfused.fused_glwe_product_ref(t_get_module(n, P, 28, "cpu"), torch.from_numpy(a),
                                              torch.from_numpy(pmat), 3, 17, 17,
                                              small=torch.from_numpy(small))
    assert not np.array_equal(butterfly.numpy(), want)


# --------------------------------------------------------------------------
# CPU: the route keyword of the entry points
# --------------------------------------------------------------------------

N_ROUTE = 512


@pytest.fixture(scope="module")
def route_keys():
    """JAX keys and ciphertexts at N 512 (base2k 17, ct k 51, GGSW and
    switching key k 68, dnum 3), their JAX default results, and the same
    objects carried into the port by `interop`."""
    import jax

    from poulpy_tpu.core import encryption as jenc
    from poulpy_tpu.core import external_product as jext
    from poulpy_tpu.core import keyswitching as jks
    from poulpy_tpu.core import prepared as jprep
    from poulpy_tpu.hal.module import get_module
    from poulpy_tpu.hal.source import Source
    from poulpy_tpu_torch.utils import interop

    m = get_module(N_ROUTE, 2, 28)
    src = Source(b"\x0b" * 32)
    xe, xa = src.branch()[1], src.branch()[1]
    sk1, sk2 = jenc.secret_new(m, 1, src), jenc.secret_new(m, 1, src)
    sprep = jax.jit(jprep.glwe_secret_prepare, static_argnums=0)
    sk1p, sk2p = sprep(m, sk1), sprep(m, sk2)
    ptg = np.zeros(N_ROUTE, dtype=np.int64)
    ptg[1] = 1
    objs = {
        "ggsw": jax.jit(jprep.ggsw_prepare, static_argnums=0)(
            m, jenc.ggsw_encrypt_sk(m, ptg, sk1p, 17, 68, dnum=3, source_xe=xe, source_xa=xa)),
        "ksk": jax.jit(jprep.gglwe_prepare, static_argnums=0)(
            m, jenc.glwe_switching_key_encrypt_sk(m, sk1, sk2p, 17, 68, 3, xe, xa)),
        "ct": jenc.glwe_encrypt_sk(m, None, sk1p, 17, 51, xe, xa, batch_shape=(2,)),
    }
    want = {"product": np.asarray(jext.glwe_external_product(m, objs["ct"], objs["ggsw"]).data),
            "keyswitch": np.asarray(jks.glwe_keyswitch(m, objs["ct"], objs["ksk"]).data)}
    port = {k: interop.from_fields(*interop.to_fields(v), device="cpu") for k, v in objs.items()}
    return port, want


@pytest.mark.parametrize("route", ["fused", "mxu", "fused_mxu"])
def test_routes_match_jax_default(route_keys, route):
    from poulpy_tpu_torch.core.external_product import glwe_external_product
    from poulpy_tpu_torch.core.keyswitching import glwe_keyswitch

    port, want = route_keys
    m = t_get_module(N_ROUTE, 2, 28, "cpu")
    assert tmp.mxu_route(m, route, 4, 17, 1) == route
    prod = glwe_external_product(m, port["ct"], port["ggsw"], route=route)
    ks = glwe_keyswitch(m, port["ct"], port["ksk"], route=route)
    assert np.array_equal(prod.data.numpy(), want["product"])
    assert np.array_equal(ks.data.numpy(), want["keyswitch"])


def test_route_falls_back_where_the_jax_conditions_fail():
    """dsize 2, N below a route's threshold or a base the fused exit does
    not take: the default kernel, as in the JAX package; an unknown route
    raises."""
    from poulpy_tpu_torch.core import encryption as enc
    from poulpy_tpu_torch.core.external_product import glwe_external_product
    from poulpy_tpu_torch.core.prepared import ggsw_prepare, glwe_secret_prepare
    from poulpy_tpu_torch.hal.source import Source

    m = t_get_module(256, 2, 28, "cpu")
    assert tmp.mxu_route(m, "mxu", 4, 17, 1) == "fused"          # N < MXU_MIN_N
    assert tmp.mxu_route(m, "fused_mxu", 4, 17, 1) == "fused_mxu"
    assert tmp.mxu_route(m, "fused_mxu", 4, 17, 2) == "fused"    # dsize 2
    assert tmp.mxu_route(m, "fused_mxu", 4, 27, 1) == "fused"    # res_base2k > 26
    with pytest.raises(ValueError):
        tmp.mxu_route(m, "tpu", 4, 17, 1)
    src, xe, xa = Source(b"\x0c" * 32), Source(b"\x0d" * 32), Source(b"\x0e" * 32)
    skp = glwe_secret_prepare(m, enc.secret_new(m, 1, src))
    ptg = np.zeros(256, dtype=np.int64)
    ptg[0] = 1
    g = ggsw_prepare(m, enc.ggsw_encrypt_sk(m, torch.as_tensor(ptg), skp, 17, 68, dnum=2,
                                            source_xe=xe, source_xa=xa, dsize=2))
    ct = enc.glwe_encrypt_sk(m, None, skp, 17, 51, xe, xa, batch_shape=(2,))
    want = glwe_external_product(m, ct, g).data
    for route in ("mxu", "fused_mxu"):
        assert torch.equal(glwe_external_product(m, ct, g, route=route).data, want)


def test_cpu_wrappers_launch_nothing():
    n, P = 256, 2
    m = t_get_module(n, P, 28, "cpu")
    rng = np.random.default_rng(45)
    a = torch.from_numpy(rng.integers(-(2**16), 2**16, size=(2, 1, 3, n)))
    pmat = torch.from_numpy(_residues(rng, m.basis.primes, (3, 1, 2, 4, P, n)))
    body = torch.from_numpy(rng.integers(-(2**16), 2**16, size=(2, 3, n)))
    reset_launches()
    tmp.mxu_glwe_product(m, a, pmat, 3, 17, 17, small=body, in_bits=23)
    tfm.fused_mxu_glwe_product(m, a, pmat, 3, 17, 17)
    tfm.fused_mxu_glwe_product(m, a, pmat, 3, 17, 17, small=body)
    assert not any(LAUNCHES.values())


def test_fused_mxu_shared_memory_and_column_split():
    """The fused MXU kernel's shared memory: the bench shape in one block
    per ciphertext; the CKKS keyswitch shape (KK 6, co 2, psize 6) split
    into one output column per block."""
    n, P = 2048, 2
    assert tfm.fused_mxu_smem_bytes(6, 8, P, n) == 215040 <= tfused.SMEM_LIMIT
    assert tfm.mxu_layout(6, 2, 4, P, n).cpb == 2
    assert tfm.fused_mxu_smem_bytes(6, 12, P, n) > tfused.SMEM_LIMIT
    assert tfm.mxu_layout(6, 2, 6, P, n).cpb == 1
    assert tmx.transform_smem_bytes(n) == 74752


# --------------------------------------------------------------------------
# CUDA: each kernel against its plain version on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 512, 2048])
@pytest.mark.parametrize("nprimes,prime_bits", [(2, 28), (4, 30)])
@pytest.mark.parametrize("nd_in,rows", [(3, 6), (4, 7)])
def test_cuda_mxu_transforms_match_plain(cuda, n, nprimes, prime_bits, nd_in, rows):
    m = t_get_module(n, nprimes, prime_bits, cuda)
    t = m.tables
    rng = np.random.default_rng(51)
    lim = 2**23 if nd_in == 3 else 2**31
    x = torch.from_numpy(rng.integers(-lim, lim, size=(rows, n))).to(cuda)
    y = torch.from_numpy(_residues(rng, m.basis.primes, (rows, nprimes, n))).to(cuda)
    reset_launches()
    have_f, have_i = tmx.mxu4_forward_limbs(t, x, nd_in), tmx.mxu4_inverse(t, y)
    torch.cuda.synchronize()
    assert LAUNCHES["mxu_forward"] == 1 and LAUNCHES["mxu_inverse"] == 1
    assert torch.equal(have_f, tmx.mxu4_forward_limbs_ref(t, x, nd_in))
    assert torch.equal(have_i, tmx.mxu4_inverse_ref(t, y))
    assert torch.equal(tmx.mxu4_inverse(t, have_f), tmx.mxu4_inverse_ref(t, have_f))


@pytest.mark.cuda
@pytest.mark.parametrize("nprimes,prime_bits", [(2, 28), (4, 30)])
@pytest.mark.parametrize("s_size", [0, 2, 5])
def test_cuda_garner_exit_matches_plain(cuda, nprimes, prime_bits, s_size):
    n, B, co, psize, res_size = 1024, 5, 2, 4, 3
    m = t_get_module(n, nprimes, prime_bits, cuda)
    rng = np.random.default_rng(52)
    x = torch.from_numpy(_residues(rng, m.basis.primes, (B, co, psize, nprimes, n))).to(cuda)
    small = (torch.from_numpy(rng.integers(-(2**40), 2**40, size=(B, s_size, n))).to(cuda)
             if s_size else None)
    have = tfused.garner_exit(m, x, psize, res_size, 17, 17, small)
    torch.cuda.synchronize()
    assert torch.equal(have, tfused.garner_exit_ref(m, x, psize, res_size, 17, 17, small))


@pytest.mark.cuda
@pytest.mark.parametrize("n,nprimes,prime_bits", [(256, 2, 28), (2048, 2, 28), (1024, 4, 30)])
@pytest.mark.parametrize("ci,co,rows,size_a,psize,res_size,s_size", [
    (2, 2, 3, 3, 4, 3, 0),       # the bench shape
    (2, 2, 4, 3, 4, 3, 0),       # rows > size_a
    (1, 2, 3, 3, 4, 3, 3),       # the keyswitch path's shape, with the body
    (1, 2, 6, 6, 6, 6, 6),       # the CKKS keyswitch shape: one column per block at N 2048
])
def test_cuda_mxu_products_match_plain(cuda, n, nprimes, prime_bits, ci, co, rows, size_a, psize,
                                       res_size, s_size):
    m = t_get_module(n, nprimes, prime_bits, cuda)
    rng = np.random.default_rng(53)
    a = torch.from_numpy(rng.integers(-(2**16), 2**16, size=(5, ci, size_a, n))).to(cuda)
    a[0, 0, 0, :4] += torch.tensor([2**33, -(2**35), 2**31, -(2**31) - 1], device=cuda)
    pmat = torch.from_numpy(_residues(rng, m.basis.primes, (rows, ci, co, psize, nprimes, n)))
    pmat = pmat.to(cuda)
    small = (torch.from_numpy(rng.integers(-(2**16), 2**16, size=(5, s_size, n))).to(cuda)
             if s_size else None)
    args = (m, a, pmat, res_size, 17, 17)
    have = tfm.fused_mxu_glwe_product(*args, small=small)
    torch.cuda.synchronize()
    assert torch.equal(have, tfm.fused_mxu_glwe_product_ref(*args, small=small))
    a_norm = a.clone()
    a_norm[0, 0, 0, :4] = 0
    args = (m, a_norm, pmat, res_size, 17, 17)
    want = tfused.fused_glwe_product(*args, small=small)
    assert torch.equal(tfm.fused_mxu_glwe_product(*args, small=small), want)
    if n >= 512:
        assert torch.equal(tmp.mxu_glwe_product(*args, small=small, in_bits=23), want)


# --------------------------------------------------------------------------
# CUDA: the block-step pattern, the blind rotation's MXU branches and the
# global layout
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n,nprimes,prime_bits,size,rows,psize,res_size,block,batch", [
    (1024, 2, 28, 2, 4, 4, 2, 8, 8),     # the gate shape (k_ct 34, k_brk 68, dnum 4, block 8)
    (4096, 2, 28, 2, 4, 4, 2, 8, 2),     # the same at N 4096: the global layout
    (256, 4, 30, 3, 3, 4, 3, 4, 5),
    (256, 2, 28, 2, 4, 4, 2, 1, 3),      # one key element
])
def test_cuda_fused_mxu_br_block_step_matches_plain(cuda, n, nprimes, prime_bits, size, rows,
                                                    psize, res_size, block, batch):
    """The block-step pattern equals its plain version and, on int32-range
    limbs, the butterfly block step; one launch, the layout by the formula."""
    m = t_get_module(n, nprimes, prime_bits, cuda)
    rng = np.random.default_rng(54)
    acc = torch.from_numpy(rng.integers(-(2**16), 2**16, size=(batch, 2, size, n))).to(cuda)
    pmats = torch.from_numpy(_residues(rng, m.basis.primes,
                                       (block, rows, 2, 2, psize, nprimes, n))).to(cuda)
    amounts = rng.integers(-n, 3 * n, size=(batch, block))
    amounts[:2, 0] = [-n, 2 * n + 3]     # negative, and past 2N
    amounts = torch.from_numpy(amounts).to(cuda)
    kind = tfm.mxu_layout(2 * min(rows, size), 2, psize, nprimes, n, split=False).kind
    assert kind == ("global" if n == 4096 else "shared")
    args = (m, acc, pmats, amounts, res_size, 17)
    reset_launches()
    have = tfm.fused_mxu_br_block_step(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_mxu_br_block_step"] == 1
    assert torch.equal(have, tfm.fused_mxu_br_block_step_ref(*args))
    assert torch.equal(have, tfused.fused_br_block_step(*args))


@pytest.mark.cuda
def test_cuda_blind_rotation_route_equals_butterfly(cuda):
    """At N 256 (n_lwe 16, block 4): the block path, the standard path and a
    NAND through route="fused_mxu" equal the butterfly route on the card,
    through the MXU kernels only (the NAND's keyswitch included)."""
    from poulpy_tpu_torch.binfhe import blind_rotation as tbr
    from poulpy_tpu_torch.binfhe import gates
    from poulpy_tpu_torch.hal.source import Source

    params = gates.GateParams(n_glwe=256, n_lwe=16, nprimes=2, prime_bits=28, block_size=4)
    keys, sk = gates.keygen(params, device=cuda)
    c1 = gates.encrypt_bit(params, [0, 0, 1, 1], sk, Source(b"\x05" * 32), Source(b"\x06" * 32))
    c2 = gates.encrypt_bit(params, [0, 1, 0, 1], sk, Source(b"\x07" * 32), Source(b"\x08" * 32))
    m, lut, brk = keys.module, keys.lut, keys.brk
    runs = {
        "block": lambda route: tbr.blind_rotation_execute_block(m, c1, lut, brk, 4, route),
        "standard": lambda route: tbr.blind_rotation_execute(m, c1, lut, brk, route),
        "nand": lambda route: gates.gate_nand(keys, c1, c2, route=route).data,
    }
    expect = {"block": {"fused_mxu_br_block_step": 4},
              "standard": {"fused_mxu_product": 16},
              "nand": {"fused_mxu_br_block_step": 4, "fused_mxu_product_small": 1}}
    for name, run in runs.items():
        want = run("fused")
        reset_launches()
        have = run("fused_mxu")
        torch.cuda.synchronize()
        assert {k: v for k, v in LAUNCHES.items() if v} == expect[name], name
        assert torch.equal(have, want), name
    out = gates.gate_nand(keys, c1, c2, route="fused_mxu")
    assert np.array_equal(gates.decrypt_bit(out, sk), [1, 1, 1, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("n,ci,rows,size_a,psize,s_size", [
    (8192, 2, 3, 3, 4, 0),       # bench.py's product at N 8192
    (4096, 1, 6, 6, 6, 6),       # the CKKS key's keyswitch at N 4096
])
def test_cuda_fused_mxu_global_layout_matches_plain(cuda, n, ci, rows, size_a, psize, s_size):
    """The fused MXU product past shared memory takes the global layout and
    equals its plain version."""
    m = t_get_module(n, 2, 28, cuda)
    rng = np.random.default_rng(55)
    a = torch.from_numpy(rng.integers(-(2**16), 2**16, size=(2, ci, size_a, n))).to(cuda)
    pmat = torch.from_numpy(_residues(rng, m.basis.primes, (rows, ci, 2, psize, 2, n))).to(cuda)
    small = (torch.from_numpy(rng.integers(-(2**16), 2**16, size=(2, s_size, n))).to(cuda)
             if s_size else None)
    assert tfm.mxu_layout(ci * min(rows, size_a), 2, psize, 2, n).kind == "global"
    args = (m, a, pmat, psize, 17, 17)
    have = tfm.fused_mxu_glwe_product(*args, small=small)
    torch.cuda.synchronize()
    assert torch.equal(have, tfm.fused_mxu_glwe_product_ref(*args, small=small))
