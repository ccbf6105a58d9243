"""poulpy_tpu_torch's wide (i128-twin) exit against the JAX package, bit for
bit (tolerance 0): the (hi, lo) pair primitives of `hal/wide.py`, the plain
versions of the two wide fused kernels against the JAX package's jnp wide
data flow, and the wide external product and keyswitch.  Small shapes
(N 64); the JAX side runs its jnp path, as it does on the CPU.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poulpy_tpu.hal import dft as jdft
from poulpy_tpu.hal import wide as jwide
from poulpy_tpu.hal.module import get_module as j_get_module
from poulpy_tpu_torch.backends import LAUNCHES
from poulpy_tpu_torch.backends import fused as tfused
from poulpy_tpu_torch.backends import wide as twb
from poulpy_tpu_torch.hal import wide as twide
from poulpy_tpu_torch.hal.module import get_module as t_get_module

N = 64


def _eq(have, want):
    if isinstance(have, tuple):
        return all(_eq(h, w) for h, w in zip(have, want))
    have = have.cpu().numpy() if isinstance(have, torch.Tensor) else np.asarray(have)
    want = np.asarray(want)
    return have.shape == want.shape and np.array_equal(have, want)


def _pair(rng, shape):
    """Random (hi, lo) int64 pairs over the whole 128-bit range, and small."""
    hi = rng.integers(-(2**63), 2**63, size=shape, dtype=np.int64)
    hi[..., ::3] = rng.integers(-2, 2, size=hi[..., ::3].shape)
    lo = rng.integers(-(2**63), 2**63, size=shape, dtype=np.int64)
    return hi, lo


def _both(x):
    """(JAX array, torch tensor) of a numpy array."""
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


def _residues(rng, primes, shape):
    out = np.zeros(shape, dtype=np.int64)
    for i, p in enumerate(primes):
        out[..., i, :] = rng.integers(0, p, size=shape[:-2] + shape[-1:])
    return out


# ---- hal/wide.py primitives ------------------------------------------------------

SHIFTS = [0, 1, 17, 63, 64, 65, 100, 127, 128, 140]


@pytest.mark.parametrize("op", ["wadd", "wsub", "wfrom_i64", "wshr_lo64", "wshl", "wmul_d_w128"])
def test_wide_primitive(op):
    rng = np.random.default_rng(31)
    (jh1, th1), (jl1, tl1) = map(_both, _pair(rng, (4, N)))
    (jh2, th2), (jl2, tl2) = map(_both, _pair(rng, (4, N)))
    if op in ("wadd", "wsub"):
        have = getattr(twide, op)(th1, tl1, th2, tl2)
        want = getattr(jwide, op)(jh1, jl1, jh2, jl2)
        assert _eq(have, want)
    elif op == "wfrom_i64":
        assert _eq(twide.wfrom_i64(tl1), jwide.wfrom_i64(jl1))
    elif op == "wshr_lo64":
        for s in SHIFTS:
            assert _eq(twide.wshr_lo64(th1, tl1, s), jwide.wshr_lo64(jh1, jl1, s)), s
    elif op == "wshl":
        for s in SHIFTS:
            assert _eq(twide.wshl(th1, tl1, s), jwide.wshl(jh1, jl1, s)), s
    else:
        jd, td = _both(rng.integers(0, 2**31, size=(4, N), dtype=np.int64))
        for w in (1, (1 << 128) - 1, 0xFFFFFFFF00000001 << 40, 3 << 96, 12345678901234567890):
            assert _eq(twide.wmul_d_w128(td, w), jwide.wmul_d_w128(jd, w)), w


@pytest.mark.parametrize("nprimes,bits", [(2, 30), (4, 30), (5, 28)])
def test_garner_lift_wide(nprimes, bits):
    jm, tm = j_get_module(N, nprimes, bits), t_get_module(N, nprimes, bits, "cpu")
    r = _residues(np.random.default_rng(32), jm.basis.primes, (3, nprimes, N))
    jr, tr = _both(r)
    assert _eq(twide.garner_lift_wide(tm.tables, tr.to(torch.int32)),
               jwide.garner_lift_wide(jm.tables, jr))


@pytest.mark.parametrize("res_size,kr,ka,off", [
    (3, 52, 52, -7), (3, 17, 17, 0), (5, 13, 19, -4), (2, 21, 17, 3), (4, 44, 52, 13),
    (2, 59, 52, 0)])
def test_vec_znx_normalize_full_wide(res_size, kr, ka, off):
    rng = np.random.default_rng(33)
    (jh, th), (jl, tl) = map(_both, _pair(rng, (2, 3, N)))
    have = twide.vec_znx_normalize_full_wide(res_size, kr, off, (th, tl), ka)
    want = jwide.vec_znx_normalize_full_wide(res_size, kr, off, (jh, jl), ka)
    assert _eq(have, want)


def test_wide_add_small_and_big_add():
    rng = np.random.default_rng(34)
    (jh, th), (jl, tl) = map(_both, _pair(rng, (2, 2, 3, N)))
    (jh2, th2), (jl2, tl2) = map(_both, _pair(rng, (2, 2, 4, N)))
    for s_size in (2, 3, 5):
        js, ts = _both(rng.integers(-(2**62), 2**62, size=(2, 2, s_size, N), dtype=np.int64))
        assert _eq(twide.wide_add_small((th, tl), ts), jwide.wide_add_small((jh, jl), js))
    assert _eq(twide.wide_big_add((th, tl), (th2, tl2)), jwide.wide_big_add((jh, jl), (jh2, jl2)))


# ---- the plain versions of the two wide kernels ----------------------------------

# the JAX package's jnp data flows run op by op; under jit each compiles once
@functools.partial(jax.jit, static_argnums=(0, 4, 5, 6, 7))
def _j_product_wide(m, a, pmat, small, res_size, kr, ka, offset):
    hi, lo = jdft.idft_apply_wide(m, jdft.vmp_apply(m, jdft.dft_apply(m, a), pmat))
    if small is not None:
        hi, lo = jwide.wide_add_small((hi, lo), small)
    return jdft.big_normalize_wide(m, res_size, kr, (hi, lo), ka, res_offset=offset)


@functools.partial(jax.jit, static_argnums=(0, 3, 4, 5, 6, 7, 8))
def _j_tensor_wide(m, a, b, conv_size, dnum, lin_size, kr, ka, offset):
    from poulpy_tpu.core.layouts import GLWECiphertext
    from poulpy_tpu.core.operations import glwe_tensor_product_big

    lin, quad = glwe_tensor_product_big(m, GLWECiphertext(data=a, base2k=ka, k=a.shape[-2] * ka),
                                        GLWECiphertext(data=b, base2k=ka, k=b.shape[-2] * ka),
                                        conv_size, wide=True)
    d = jdft.big_normalize_wide(m, dnum, kr, quad[(0, 0)], ka, res_offset=offset)
    return d, jnp.stack([jdft.big_normalize_wide(m, lin_size, ka, t, ka, res_offset=offset)
                         for t in lin], axis=-3)


@pytest.mark.parametrize("ci,co,rows,size_a,psize,kr,ka,s_size,offset,batch", [
    (1, 2, 2, 2, 3, 52, 52, 0, 0, 3),    # relinearize shape
    (1, 2, 2, 2, 3, 52, 52, 3, 0, 2),    # + per-column small
    (2, 2, 3, 3, 4, 44, 44, 0, 0, 1),    # external product shape
    (1, 2, 3, 3, 3, 52, 52, 2, -7, 2),   # landing offset
    (2, 2, 2, 2, 3, 26, 52, 0, 5, 2),    # kr < 32 output windows
])
def test_fused_glwe_product_wide_plain(ci, co, rows, size_a, psize, kr, ka, s_size, offset,
                                       batch):
    """The wrapper on CPU tensors (its plain version) against the JAX
    package's jnp wide pipeline, tests/test_wide.py's shapes."""
    jm, tm = j_get_module(N, 5, 28), t_get_module(N, 5, 28, "cpu")
    rng = np.random.default_rng(35)
    lim = 1 << (ka - 1)
    ja, ta = _both(rng.integers(-lim, lim, size=(batch, ci, size_a, N), dtype=np.int64))
    jp, tp = _both(_residues(rng, jm.basis.primes, (rows, ci, co, psize, 5, N)))
    js = ts = None
    if s_size:
        js, ts = _both(rng.integers(-lim, lim, size=(batch, co, s_size, N), dtype=np.int64))
    want = _j_product_wide(jm, ja, jp, js, 3, kr, ka, offset)
    before = dict(LAUNCHES)
    have = twb.fused_glwe_product_wide(tm, ta, tp.to(torch.int32), 3, kr, ka, small=ts,
                                       res_offset=offset)
    assert _eq(have, want)
    assert LAUNCHES == before


@pytest.mark.parametrize("size_a,size_b,dnum,lin_size,kr,ka,offset", [
    (2, 2, 2, 3, 52, 52, 0),
    (2, 3, 3, 3, 52, 52, -9),
    (3, 3, 2, 4, 44, 52, 13),
])
def test_fused_tensor_product_wide_plain(size_a, size_b, dnum, lin_size, kr, ka, offset):
    """Against glwe_tensor_product_big(wide=True) and the two wide
    normalizations of the JAX package, tests/test_wide.py's shapes."""
    jm, tm = j_get_module(N, 5, 28), t_get_module(N, 5, 28, "cpu")
    rng = np.random.default_rng(36)
    lim = 1 << (ka - 1)
    ja, ta = _both(rng.integers(-lim, lim, size=(2, 2, size_a, N), dtype=np.int64))
    jb, tb = _both(rng.integers(-lim, lim, size=(2, 2, size_b, N), dtype=np.int64))
    conv_size = size_a + size_b - 1
    want_d, want_lin = _j_tensor_wide(jm, ja, jb, conv_size, dnum, lin_size, kr, ka, offset)
    have_d, have_lin = twb.fused_tensor_product_wide(tm, ta, tb, conv_size, dnum, lin_size, kr,
                                                     ka, offset=offset)
    assert _eq(have_d, want_d)
    assert _eq(have_lin, want_lin)


def test_tensor_product_big_wide():
    """core.operations.glwe_tensor_product_big(wide=True): every (hi, lo)
    term equals the JAX package's."""
    from poulpy_tpu.core import layouts as jlay
    from poulpy_tpu.core import operations as jops
    from poulpy_tpu_torch.core import layouts as tlay
    from poulpy_tpu_torch.core import operations as tops

    jm, tm = j_get_module(N, 5, 28), t_get_module(N, 5, 28, "cpu")
    rng = np.random.default_rng(37)
    ja, ta = _both(rng.integers(-(2**51), 2**51, size=(2, 2, 2, N), dtype=np.int64))
    jb, tb = _both(rng.integers(-(2**51), 2**51, size=(2, 2, 3, N), dtype=np.int64))
    jlin, jquad = jax.jit(lambda a, b: jops.glwe_tensor_product_big(
        jm, jlay.GLWECiphertext(data=a, base2k=52, k=104),
        jlay.GLWECiphertext(data=b, base2k=52, k=156), 4, wide=True))(ja, jb)
    tlin, tquad = tops.glwe_tensor_product_big(tm, tlay.GLWECiphertext(data=ta, base2k=52, k=104),
                                               tlay.GLWECiphertext(data=tb, base2k=52, k=156),
                                               4, wide=True)
    assert all(_eq(h, w) for h, w in zip(tlin, jlin))
    assert tquad.keys() == jquad.keys() and _eq(tquad[(0, 0)], jquad[(0, 0)])


def test_wide_wrappers_check_their_bounds():
    tm = t_get_module(N, 5, 28, "cpu")
    a = torch.zeros(1, 2, 2, N, dtype=torch.int64)
    with pytest.raises(ValueError, match="windows"):
        twb.fused_tensor_product_wide(tm, a, a, 3, 2, 3, 60, 52)
    with pytest.raises(ValueError, match="windows"):
        twb.fused_glwe_product_wide(tm, a[:, :1], torch.zeros(2, 1, 2, 3, 5, N, dtype=torch.int32),
                                    2, 61, 52)
    # the mul shape fits one output column per block, not two
    assert tfused.product_layout(2, 2, 3, 5, 2048).cpb == 1
    assert tfused.product_layout(2, 2, 3, 5, 1024).cpb == 2
    assert twb.wide_tensor_smem_bytes(2, 2, 3, 5, 2048) == 188416


# ---- the wide external product and keyswitch --------------------------------------

BASE2K, K_CT, K_KEY, K_PT = 44, 88, 132, 44


class _JitPrepare:
    """The JAX package's prepare functions, each compiled once."""

    def __init__(self, prep):
        for name in ("glwe_secret_prepare", "gglwe_prepare", "ggsw_prepare"):
            setattr(self, name, jax.jit(getattr(prep, name), static_argnums=0))


def _wide_keys(pkg):
    """tests/test_wide.py's keyswitch parameters (base2k 44, N 64, 4 primes of
    30 bits, ternary_hw 16 secrets), a switching key, a GGSW of X and a
    ciphertext, in one package."""
    if pkg == "jax":
        from poulpy_tpu.core import encryption as enc
        from poulpy_tpu.core import layouts as lay
        from poulpy_tpu.core import prepared as prep
        from poulpy_tpu.hal import vec_znx as vz
        from poulpy_tpu.hal.source import Source

        m, arr = j_get_module(N, 4), jnp.asarray
        prep = _JitPrepare(prep)
    else:
        from poulpy_tpu_torch.core import encryption as enc
        from poulpy_tpu_torch.core import layouts as lay
        from poulpy_tpu_torch.core import prepared as prep
        from poulpy_tpu_torch.hal import vec_znx as vz
        from poulpy_tpu_torch.hal.source import Source

        m, arr = t_get_module(N, 4, 30, "cpu"), torch.as_tensor
    sk1 = enc.secret_new(m, 1, Source(b"\x01" * 32), dist="ternary_hw", hw=16)
    sk2 = enc.secret_new(m, 1, Source(b"\x02" * 32), dist="ternary_hw", hw=16)
    sk1p, sk2p = prep.glwe_secret_prepare(m, sk1), prep.glwe_secret_prepare(m, sk2)
    data = np.random.default_rng(38).integers(-(2**20), 2**20, (2, N), dtype=np.int64)
    pt = lay.GLWEPlaintext(data=vz.encode_vec_i64(BASE2K, K_PT, 2, arr(data)), base2k=BASE2K,
                           k=K_PT)
    xe, xa = Source(b"\x03" * 32), Source(b"\x04" * 32)
    ct = enc.glwe_encrypt_sk(m, pt, sk1p, BASE2K, K_CT, xe, xa)
    ksk = prep.gglwe_prepare(m, enc.glwe_switching_key_encrypt_sk(
        m, sk1, sk2p, BASE2K, K_KEY, dnum=3, source_xe=Source(b"\x05" * 32),
        source_xa=Source(b"\x06" * 32)))
    ptg = np.zeros(N, dtype=np.int64)
    ptg[1] = 1
    ggsw = prep.ggsw_prepare(m, enc.ggsw_encrypt_sk(m, arr(ptg), sk1p, BASE2K, K_KEY, dnum=3,
                                                    source_xe=xe, source_xa=xa))
    return m, sk1p, sk2p, ct, ksk, ggsw, data, vz


@pytest.fixture(scope="module")
def wide_keys():
    return _wide_keys("jax"), _wide_keys("torch")


def test_wide_external_product(wide_keys):
    from poulpy_tpu.core import external_product as jext
    from poulpy_tpu_torch.core import decryption as tdec
    from poulpy_tpu_torch.core import external_product as text

    (jm, _, _, jct, _, jg, _, _), (tm, tsk1p, _, tct, _, tg, data, tvz) = wide_keys
    assert jdft.needs_wide(jdft.product_bits(BASE2K, BASE2K, jm.log_n, 3 * 2))
    assert _eq(tg.pmat, jg.pmat) and _eq(tct.data, jct.data)
    have = text.glwe_external_product(tm, tct, tg)
    assert _eq(have.data, jext.glwe_external_product(jm, jct, jg).data)
    got = tvz.decode_vec_i64(BASE2K, K_PT, tdec.glwe_decrypt(tm, have, tsk1p).data).numpy()
    want = np.roll(data, 1, axis=-1)
    want[:, 0] *= -1
    assert np.abs(got - want).max() <= 2


def test_wide_keyswitch(wide_keys):
    from poulpy_tpu.core import keyswitching as jks
    from poulpy_tpu_torch.core import decryption as tdec
    from poulpy_tpu_torch.core import keyswitching as tks

    (jm, _, _, jct, jksk, _, _, _), (tm, _, tsk2p, tct, tksk, _, data, tvz) = wide_keys
    assert _eq(tksk.pmat, jksk.pmat)
    have = tks.glwe_keyswitch(tm, tct, tksk)
    assert _eq(have.data, jks.glwe_keyswitch(jm, jct, jksk).data)
    got = tvz.decode_vec_i64(BASE2K, K_PT, tdec.glwe_decrypt(tm, have, tsk2p).data).numpy()
    assert np.abs(got - data).max() <= 2
