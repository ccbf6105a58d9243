"""poulpy_tpu_torch's trace, packing, GGLWE → GGSW expansion and the
keyswitches built on them against poulpy_tpu's, bit for bit (tolerance 0).

At N 64 on get_module(64, 4) as tests/test_core.py: base2k 17, ciphertext k
51, automorphism and tensor keys k 68 with dnum 3 (the GGSW keyswitch's at k
102 with dnum 6).  The port makes the keys and ciphertexts from numpy-seeded
data and `Source` seeds (its encryption equals the JAX package's, see
tests/test_torch_core.py) and carries them into the JAX package's layouts
through `interop.to_fields`; the new key functions are also held against
the JAX package's own from the same seeds.  Covered: the trace's Galois
elements, `glwe_trace`, `glwe_pack` (with the branches where a partner is
missing), `GLWEPacker`, the GGLWE → GGSW key and `ggsw_from_gglwe`,
`gglwe_keyswitch`, `ggsw_keyswitch`, `lwe_keyswitch` and the LWE ↔ GLWE
bridges.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poulpy_tpu.core import conversion as jconv
from poulpy_tpu.core import encryption as jenc
from poulpy_tpu.core import keyswitching as jks
from poulpy_tpu.core import layouts as jlay
from poulpy_tpu.core import packing as jpack
from poulpy_tpu.core import prepared as jprep
from poulpy_tpu.hal.module import get_module as j_get_module
from poulpy_tpu.hal.source import Source as JSource
from poulpy_tpu_torch.backends import LAUNCHES
from poulpy_tpu_torch.core import conversion as tconv
from poulpy_tpu_torch.core import encryption as tenc
from poulpy_tpu_torch.core import keyswitching as tks
from poulpy_tpu_torch.core import layouts as tlay
from poulpy_tpu_torch.core import packing as tpack
from poulpy_tpu_torch.core import prepared as tprep
from poulpy_tpu_torch.hal import vec_znx as tvz
from poulpy_tpu_torch.hal.module import get_module as t_get_module
from poulpy_tpu_torch.hal.source import Source as TSource
from poulpy_tpu_torch.utils import interop

N = 64
BASE2K, K_CT, K_PT, K_KEY, DNUM = 17, 51, 34, 68, 3
K_TSK, DNUM_TSK = 102, 6
N_LWE = 24

# the JAX package's functions run eagerly op by op, which compiles every op
# (half a minute for the dft / idft of one shape); under jit they compile
# once.  A key function's `Source` arguments are static: its draws happen
# once, while tracing, in the order of the eager call.
j_secret_prepare = jax.jit(jprep.glwe_secret_prepare, static_argnums=0)
j_trace = jax.jit(jpack.glwe_trace, static_argnums=(0, 3))
j_pack = jax.jit(jpack.glwe_pack, static_argnums=(0, 3))
j_ggsw_from_gglwe = jax.jit(jconv.ggsw_from_gglwe, static_argnums=0)
j_tsk_encrypt = jax.jit(jconv.gglwe_to_ggsw_key_encrypt_sk, static_argnums=(0, 3, 4, 5, 6, 7))
j_gglwe_keyswitch = jax.jit(jks.gglwe_keyswitch, static_argnums=0)
j_ggsw_keyswitch = jax.jit(jks.ggsw_keyswitch, static_argnums=0)
j_lwe_ksk_encrypt = jax.jit(jks.lwe_switching_key_encrypt_sk, static_argnums=(0, 3, 4, 5, 6, 7))
j_lwe_keyswitch = jax.jit(jks.lwe_keyswitch, static_argnums=(0, 3))
j_to_glwe_encrypt = jax.jit(jconv.lwe_to_glwe_key_encrypt_sk, static_argnums=(0, 3, 4, 5, 6, 7))
j_lwe_from_glwe = jax.jit(jconv.lwe_from_glwe, static_argnums=(0, 2, 4))
j_glwe_from_lwe = jax.jit(jconv.glwe_from_lwe, static_argnums=(0, 3, 4))
JAX_CLASSES = {cls.__name__: cls for cls in (jlay.GLWECiphertext, jlay.GGLWECiphertext,
                                             jlay.GGSWCiphertext, jlay.LWECiphertext,
                                             jprep.GGLWEPrepared,
                                             jprep.GLWEAutomorphismKeyPrepared)}


def _eq(have, want):
    have = have.cpu().numpy() if isinstance(have, torch.Tensor) else np.asarray(have)
    want = np.asarray(want)
    return have.shape == want.shape and np.array_equal(have, want)


def _jax(obj):
    """The JAX package's twin of a port object (or of a dict or list of
    them), through `interop.to_fields`."""
    if isinstance(obj, dict):
        return {k: _jax(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_jax(v) for v in obj]
    return _jax_fields(*interop.to_fields(obj))


def _jax_fields(name: str, fields: dict):
    def conv(v):
        if isinstance(v, np.ndarray):
            return jnp.asarray(v)
        return _jax_fields(*v) if interop._is_fields(v) else v

    return JAX_CLASSES[name](**{k: conv(v) for k, v in fields.items()})


def _jax_secret(setup):
    sk = setup["sk"]
    return jlay.GLWESecret(data=jnp.asarray(sk.data.numpy()), dist=sk.dist)


def _same(have, want):
    """Equal data and parameters of a port layout and a JAX one."""
    params = [f for f in ("base2k", "k", "dsize") if hasattr(want, f)]
    return _eq(have.data, want.data) and all(getattr(have, f) == getattr(want, f) for f in params)


def _sources(tag: int):
    return TSource(bytes([tag]) * 32), TSource(bytes([tag + 1]) * 32)


@pytest.fixture(scope="module")
def setup():
    """The port's module, secret, trace keys of every level and tensor
    keys, and the JAX package's module with those keys."""
    tm, jm = t_get_module(N, 4, device="cpu"), j_get_module(N, 4)
    sk = tenc.secret_new(tm, 1, TSource(bytes(32)))
    skp = tprep.glwe_secret_prepare(tm, sk)
    xe, xa = _sources(3)
    keys = {}
    for p in tpack.trace_galois_elements(tm):
        key, _ = tenc.glwe_automorphism_key_encrypt_sk(tm, p, sk, BASE2K, K_KEY, DNUM, xe, xa)
        keys[p] = tprep.GLWEAutomorphismKeyPrepared(key=tprep.gglwe_prepare(tm, key), p=p)
    tsk = tconv.gglwe_to_ggsw_key_encrypt_sk(tm, sk, skp, BASE2K, K_KEY, DNUM, xe, xa)
    return dict(tm=tm, jm=jm, sk=sk, skp=skp, keys=keys, jkeys=_jax(keys), tsk=tsk,
                jtsk=_jax(tsk))


def _cts(setup, batch: tuple = (2,), seed: int = 70):
    """Encryptions of random messages under the port's secret."""
    data = np.random.default_rng(seed).integers(-(2**15), 2**15, size=batch + (N,))
    pt = tlay.GLWEPlaintext(data=tvz.encode_vec_i64(BASE2K, K_PT, 3, torch.from_numpy(data)),
                            base2k=BASE2K, k=K_PT)
    return tenc.glwe_encrypt_sk(setup["tm"], pt, setup["skp"], BASE2K, K_CT, *_sources(seed),
                                batch_shape=batch)


# ---- trace and packing ----------------------------------------------------------------------

def test_trace_galois_elements(setup):
    tm, jm = setup["tm"], setup["jm"]
    assert tpack.trace_galois_elements(tm) == jpack.trace_galois_elements(jm)
    assert tpack.trace_galois_elements(tm)[:3] == [-1, 5, 25]


@pytest.mark.parametrize("skip", [0, 4])
def test_glwe_trace(setup, skip):
    """The full trace and a partial one, on a batch of two; no kernel
    launches on the CPU."""
    ct = _cts(setup)
    before = dict(LAUNCHES)
    have = tpack.glwe_trace(setup["tm"], ct, setup["keys"], skip=skip)
    assert LAUNCHES == before
    assert _same(have, j_trace(setup["jm"], _jax(ct), setup["jkeys"], skip=skip))


@pytest.mark.parametrize("log_gap_out", [0, 1])
def test_glwe_pack(setup, log_gap_out):
    """Slots 0, 2, 33 and 34: at level 0 the pair (0, 32) has only a, (1,
    33) only b, (2, 34) both."""
    ct = _cts(setup, (4,), seed=72)
    slots = [0, 2, 33, 34]
    cts = {j: ct.replace(data=ct.data[i]) for i, j in enumerate(slots)}
    have = tpack.glwe_pack(setup["tm"], cts, setup["keys"], log_gap_out)
    want = j_pack(setup["jm"], {j: _jax(c) for j, c in cts.items()}, setup["jkeys"],
                           log_gap_out)
    assert _same(have, want)


def test_glwe_packer(setup):
    """The streaming packer at log_batch 3 (8 slots, two of them empty),
    flushed, then full again after a second round."""
    ct = _cts(setup, (6,), seed=74)
    feed = [0, None, 1, 2, None, 3, 4, 5]
    tp, jp = tpack.GLWEPacker(setup["tm"], 3), jpack.GLWEPacker(setup["jm"], 3)
    for rnd in range(2):
        for i in feed:
            c = None if i is None else ct.replace(data=ct.data[(i + rnd) % 6])
            tp.add(c, setup["keys"])
            jp.add(None if c is None else _jax(c), setup["jkeys"])
        assert _same(tp.flush(), jp.flush())
    with pytest.raises(ValueError, match="not full"):
        tp.flush()


# ---- GGLWE → GGSW ----------------------------------------------------------------------------

def test_gglwe_to_ggsw_key(setup):
    """The port's tensor key equals the JAX package's from the same seeds."""
    tm, jm = setup["tm"], setup["jm"]
    jsk = jenc.secret_new(jm, 1, JSource(bytes(32)))
    assert _eq(setup["sk"].data, jsk.data)
    want = j_tsk_encrypt(jm, jsk, j_secret_prepare(jm, jsk), BASE2K, K_KEY,
                                              DNUM, JSource(b"\x09" * 32), JSource(b"\x0a" * 32))
    have = tconv.gglwe_to_ggsw_key_encrypt_sk(tm, setup["sk"], setup["skp"], BASE2K, K_KEY, DNUM,
                                              *_sources(9))
    assert len(have) == len(want) == 1
    assert _eq(have[0].pmat, want[0].pmat)
    assert (have[0].base2k, have[0].k, have[0].dsize) == (want[0].base2k, want[0].k, want[0].dsize)


def _gglwe(setup, batch: tuple = ()):
    """A GGLWE of X^2 (rank_in 1, k 68, dnum 3), batched."""
    msg = np.zeros(batch + (1, N), dtype=np.int64)
    msg[..., 0, 2] = 1
    out = [tenc.gglwe_encrypt_sk(setup["tm"], torch.from_numpy(m), setup["skp"], BASE2K, K_KEY,
                                 DNUM, *_sources(11)) for m in msg.reshape(-1, 1, N)]
    data = torch.stack([g.data for g in out]).reshape(batch + tuple(out[0].data.shape))
    return out[0].replace(data=data)


@pytest.mark.parametrize("batch", [(), (2,)], ids=["single", "batch2"])
def test_ggsw_from_gglwe(setup, batch):
    gglwe = _gglwe(setup, batch)
    have = tconv.ggsw_from_gglwe(setup["tm"], gglwe, setup["tsk"])
    want = j_ggsw_from_gglwe(setup["jm"], _jax(gglwe), setup["jtsk"])
    assert _same(have, want)
    assert tuple(have.data.shape) == batch + (DNUM, 2, 2, 4, N)


# ---- keyswitches -----------------------------------------------------------------------------

def test_gglwe_keyswitch(setup):
    tm, jm = setup["tm"], setup["jm"]
    sk2p = tprep.glwe_secret_prepare(tm, tenc.secret_new(tm, 1, TSource(b"\x05" * 32)))
    ksk = tprep.gglwe_prepare(tm, tenc.glwe_switching_key_encrypt_sk(
        tm, setup["sk"], sk2p, BASE2K, 85, 5, *_sources(13)))
    gglwe = _gglwe(setup)
    have = tks.gglwe_keyswitch(tm, gglwe, ksk)
    assert _same(have, j_gglwe_keyswitch(jm, _jax(gglwe), _jax(ksk)))
    assert (have.dnum, have.rank_in, have.rank_out) == (DNUM, 1, 1)


def test_ggsw_keyswitch(setup):
    """GGSW(X^5) switched to a second secret with the tensor key under it."""
    tm, jm = setup["tm"], setup["jm"]
    sk2 = tenc.secret_new(tm, 1, TSource(b"\x06" * 32))
    sk2p = tprep.glwe_secret_prepare(tm, sk2)
    ptg = np.zeros(N, dtype=np.int64)
    ptg[5] = 1
    ggsw = tenc.ggsw_encrypt_sk(tm, ptg, setup["skp"], BASE2K, K_KEY, DNUM, *_sources(15))
    ksk = tprep.gglwe_prepare(tm, tenc.glwe_switching_key_encrypt_sk(
        tm, setup["sk"], sk2p, BASE2K, K_TSK, DNUM_TSK, *_sources(17)))
    tsk = tconv.gglwe_to_ggsw_key_encrypt_sk(tm, sk2, sk2p, BASE2K, K_TSK, DNUM_TSK,
                                             *_sources(17))
    have = tks.ggsw_keyswitch(tm, ggsw, ksk, tsk)
    assert _same(have, j_ggsw_keyswitch(jm, _jax(ggsw), _jax(ksk), _jax(tsk)))


def _lwe_secret(tag: int):
    return TSource(bytes([tag]) * 32).ternary_prob((N_LWE,))


def test_lwe_keyswitch(setup):
    """The LWE switching key against the JAX package's from the same seeds,
    then an LWE → LWE keyswitch to 20 coefficients."""
    tm, jm = setup["tm"], setup["jm"]
    s_in, s_out = _lwe_secret(0x21), _lwe_secret(0x22)
    ksk = tks.lwe_switching_key_encrypt_sk(tm, s_in, s_out, BASE2K, K_KEY, DNUM, *_sources(19))
    want_ksk = j_lwe_ksk_encrypt(jm, jnp.asarray(s_in), jnp.asarray(s_out), BASE2K,
                                                K_KEY, DNUM, JSource(b"\x13" * 32),
                                                JSource(b"\x14" * 32))
    assert _eq(ksk.pmat, want_ksk.pmat)
    pt = np.random.default_rng(76).integers(-(2**10), 2**10, size=(3, 3, 1))
    lwe = tenc.lwe_encrypt_sk(None, pt, torch.from_numpy(s_in), BASE2K, K_CT, *_sources(21))
    have = tks.lwe_keyswitch(tm, lwe, ksk, 20)
    assert _same(have, j_lwe_keyswitch(jm, _jax(lwe), want_ksk, 20))
    assert tuple(have.data.shape) == (3, 3, 21)


@pytest.mark.parametrize("idx", [0, 3])
def test_lwe_glwe_bridges(setup, idx):
    """GLWE → LWE at coefficient idx and back, through keys held against
    the JAX package's from the same seeds."""
    tm, jm = setup["tm"], setup["jm"]
    s_lwe = _lwe_secret(0x0a)
    to_lwe = tconv.glwe_to_lwe_key_encrypt_sk(tm, s_lwe, setup["sk"], BASE2K, K_KEY, DNUM,
                                              *_sources(23))
    to_glwe = tconv.lwe_to_glwe_key_encrypt_sk(tm, s_lwe, setup["skp"], BASE2K, K_KEY, DNUM,
                                               *_sources(25))
    want_to_glwe = j_to_glwe_encrypt(
        jm, jnp.asarray(s_lwe), j_secret_prepare(jm, _jax_secret(setup)), BASE2K, K_KEY, DNUM,
        JSource(b"\x19" * 32), JSource(b"\x1a" * 32))
    assert _eq(to_glwe.pmat, want_to_glwe.pmat)
    ct = _cts(setup, seed=78)
    lwe = tconv.lwe_from_glwe(tm, ct, idx, to_lwe, N_LWE)
    assert _same(lwe, j_lwe_from_glwe(jm, _jax(ct), idx, _jax(to_lwe), N_LWE))
    back = tconv.glwe_from_lwe(tm, lwe, to_glwe, BASE2K, K_CT)
    assert _same(back, j_glwe_from_lwe(jm, _jax(lwe), want_to_glwe, BASE2K, K_CT))

