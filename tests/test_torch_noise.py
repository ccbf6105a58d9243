"""poulpy_tpu_torch.core.noise and poulpy_tpu_torch.utils.stats against the JAX
package's, float for float (tolerance 0).

The variance formulas on a grid of parameters; `vec_znx_stats` and
`noise_stats` on seeded limbs; `glwe_noise`, `gglwe_noise` (every row) and
`ggsw_noise` (every row and column) at tests/test_core.py's configuration
(N 64 on get_module(64, 4), base2k 17, a GLWE of k 51, a GGLWE and a GGSW of
k 68 with dnum 3, the secret of Source 0): the port makes the ciphertexts
on the CPU, the JAX package measures the same ones carried over by their
fields, and each `Stats` is equal; every row also reads as fresh noise, as
tests/test_core.py asserts.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poulpy_tpu.core import encryption as jenc
from poulpy_tpu.core import layouts as jlay
from poulpy_tpu.core import noise as jnoise
from poulpy_tpu.core.prepared import glwe_secret_prepare as j_secret_prepare
from poulpy_tpu.hal.module import get_module as j_get_module
from poulpy_tpu.hal.source import Source as JSource
from poulpy_tpu.utils import stats as jstats
from poulpy_tpu_torch.core import encryption as enc
from poulpy_tpu_torch.core import noise
from poulpy_tpu_torch.core.layouts import GLWEPlaintext
from poulpy_tpu_torch.core.prepared import glwe_secret_prepare
from poulpy_tpu_torch.hal import vec_znx
from poulpy_tpu_torch.hal.module import get_module
from poulpy_tpu_torch.hal.source import Source
from poulpy_tpu_torch.utils import stats

N, BASE2K, K_CT, K_PT, K_KEY, DNUM = 64, 17, 51, 34, 68, 3

j_prepare = jax.jit(j_secret_prepare, static_argnums=0)


def _same_stats(have, want) -> bool:
    return (dataclasses.astuple(have) == dataclasses.astuple(want)
            and (have.log2_std, have.log2_max) == (want.log2_std, want.log2_max))


# ---- the variance model ---------------------------------------------------------------------

@pytest.mark.parametrize("n,base2k,a_logq,b_logq", [(1024, 17, 34, 68), (2048, 13, 52, 39),
                                                    (64, 52, 95, 156), (4096, 15, 30, 30)])
def test_var_noise_gglwe_product(n, base2k, a_logq, b_logq):
    for var_xs, var_msg, rank_in in itertools.product((0.25, 0.5), (1.0, 2.0 ** -20), (1, 2)):
        args = (n, base2k, var_xs, var_msg, 3.2 ** 2 / 2.0 ** 70, 2.0 ** -100, 2.0 ** -110,
                rank_in, a_logq, b_logq)
        assert noise.var_noise_gglwe_product(*args) == jnoise.var_noise_gglwe_product(*args)
        assert (noise.log2_std_noise_gglwe_product(*args)
                == jnoise.log2_std_noise_gglwe_product(*args))


@pytest.mark.parametrize("n,base2k,k_ct,k_key,dnum,dsize,rank", [
    (64, 17, 51, 68, 3, 1, 1), (1024, 17, 34, 51, 2, 1, 1), (2048, 17, 95, 95, 6, 1, 2),
    (2048, 13, 52, 52, 2, 2, 1)])
def test_var_noise_keyswitch_and_external_product(n, base2k, k_ct, k_key, dnum, dsize, rank):
    for dist, sigma in itertools.product(noise.XS_VAR, (3.2, 1.0)):
        var_xs = noise.XS_VAR[dist]
        args = (n, base2k, k_ct, k_key, dnum, dsize, rank, sigma, var_xs)
        assert noise.var_noise_keyswitch(*args) == jnoise.var_noise_keyswitch(*args)
        assert noise.var_noise_external_product(*args) == jnoise.var_noise_external_product(*args)
    assert noise.XS_VAR == jnoise.XS_VAR


@pytest.mark.parametrize("sigma,k", [(3.2, 68), (3.2, 51), (1.0, 17), (3.2, 156)])
def test_var_sigma_and_log2_std(sigma, k):
    v = noise.var_sigma(sigma, k)
    assert v == jnoise.var_sigma(sigma, k)
    assert noise.log2_std(v) == jnoise.log2_std(v)
    assert noise.log2_std(0.0) == jnoise.log2_std(0.0)


# ---- stats ------------------------------------------------------------------------------------

@pytest.mark.parametrize("base2k,size", [(17, 3), (13, 4), (52, 2)])
def test_vec_znx_stats_and_noise_stats(base2k, size):
    rng = np.random.default_rng(base2k + size)
    half = 1 << (base2k - 1)
    limbs = rng.integers(-half, half, (2, size, N))
    want_float = rng.uniform(-0.5, 0.5, (2, N))
    assert _same_stats(stats.vec_znx_stats(base2k, torch.from_numpy(limbs)),
                       jstats.vec_znx_stats(base2k, jnp.asarray(limbs)))
    for want in (want_float, torch.from_numpy(want_float)):
        assert _same_stats(stats.noise_stats(base2k, torch.from_numpy(limbs), want),
                           jstats.noise_stats(base2k, jnp.asarray(limbs), want_float))


# ---- measured noise -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def cts():
    """tests/test_core.py's set-up in both packages, and the port's GLWE,
    GGLWE and GGSW from Source 0x01 / 0x02 with their JAX twins.  While the
    module's tests run, the decryption and dft calls inside the JAX
    package's noise functions run under `jax.jit` (the same functions:
    eagerly, each op compiles on its own)."""
    from poulpy_tpu.core import decryption as jdec
    from poulpy_tpu.hal import dft as jdft

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdec, "glwe_decrypt", jax.jit(jdec.glwe_decrypt, static_argnums=0))
        for name, static in (("dft_apply", (0,)), ("svp_apply", (0,)), ("idft_apply", (0,)),
                             ("big_normalize", (0, 1, 2, 4))):
            mp.setattr(jdft, name, jax.jit(getattr(jdft, name), static_argnums=static))
        yield _cts()


def _cts():
    tm, jm = get_module(N, 4, device="cpu"), j_get_module(N, 4)
    sk = enc.secret_new(tm, 1, Source(bytes(32)))
    jsk = jenc.secret_new(jm, 1, JSource(bytes(32)))
    xe, xa = Source(b"\x01" * 32), Source(b"\x02" * 32)
    rng = np.random.default_rng(7)
    data = rng.integers(-(2**15), 2**15, size=N, dtype=np.int64)
    pt = GLWEPlaintext(data=vec_znx.encode_vec_i64(BASE2K, K_PT, 3, torch.from_numpy(data)),
                       base2k=BASE2K, k=K_PT)
    skp = glwe_secret_prepare(tm, sk)
    scalar = torch.from_numpy(rng.integers(-2, 3, size=(1, N), dtype=np.int64))
    out = dict(tm=tm, jm=jm, skp=skp, jskp=j_prepare(jm, jsk), pt=pt, scalar=scalar,
               glwe=enc.glwe_encrypt_sk(tm, pt, skp, BASE2K, K_CT, xe, xa),
               gglwe=enc.gglwe_encrypt_sk(tm, scalar, skp, BASE2K, K_KEY, DNUM, xe, xa),
               ggsw=enc.ggsw_encrypt_sk(tm, scalar[0], skp, BASE2K, K_KEY, DNUM, xe, xa))
    for name, cls in (("glwe", jlay.GLWECiphertext), ("gglwe", jlay.GGLWECiphertext),
                      ("ggsw", jlay.GGSWCiphertext), ("pt", jlay.GLWEPlaintext)):
        fields = {f.name: getattr(out[name], f.name) for f in dataclasses.fields(out[name])}
        fields["data"] = jnp.asarray(fields["data"].numpy())
        out["j" + name] = cls(**fields)
    return out


def test_glwe_noise(cts):
    have = noise.glwe_noise(cts["tm"], cts["glwe"], cts["pt"], cts["skp"])
    assert _same_stats(have, jnoise.glwe_noise(cts["jm"], cts["jglwe"], cts["jpt"], cts["jskp"]))
    assert have.log2_max <= np.log2(6 * 3.2) - K_CT + 0.5


@pytest.mark.parametrize("row", range(DNUM))
def test_gglwe_noise(cts, row):
    have = noise.gglwe_noise(cts["tm"], cts["gglwe"], row, 0, cts["scalar"][0], cts["skp"])
    want = jnoise.gglwe_noise(cts["jm"], cts["jgglwe"], row, 0,
                              jnp.asarray(cts["scalar"][0].numpy()), cts["jskp"])
    assert _same_stats(have, want)
    assert have.log2_max <= np.log2(6 * 3.2) - K_KEY + 0.5


@pytest.mark.parametrize("row,col", [(r, c) for r in range(DNUM) for c in range(2)])
def test_ggsw_noise(cts, row, col):
    """Column 1 multiplies the digit plaintext by the secret through the
    port's dft / svp / idft / big_normalize."""
    have = noise.ggsw_noise(cts["tm"], cts["ggsw"], row, col, cts["scalar"][0], cts["skp"])
    want = jnoise.ggsw_noise(cts["jm"], cts["jggsw"], row, col,
                             jnp.asarray(cts["scalar"][0].numpy()), cts["jskp"])
    assert _same_stats(have, want)
    assert have.log2_max <= np.log2(6 * 3.2) - K_KEY + 1.0
