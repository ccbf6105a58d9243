"""poulpy_tpu_torch's automorphisms, rotations and CKKS plaintext forms
against poulpy_tpu's, bit for bit (tolerance 0).

At N 64 on chip_smoke.py's CKKS basis (2 primes of 28 bits; base2k 17,
ciphertext and key k 95, dnum 6): the Galois elements, the automorphism-key
encryption, `glwe_automorphism` (through the port's keyswitch, its plain
version here), `_add`, `_key_automorphism`, `ggsw_automorphism`, the GLWE /
GGSW rotations and (X^p − 1)·ct, CKKS `rotate` / `rotate_by` / `conjugate`
with their decoded slots, every function of `ckks/plaintext.py`, and the
interop of the new layouts.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poulpy_tpu.ckks import ops as jck
from poulpy_tpu.ckks import plaintext as jpt
from poulpy_tpu.core import automorphism as jauto
from poulpy_tpu.core import encryption as jenc
from poulpy_tpu.core import layouts as jlay
from poulpy_tpu.core import operations as jops
from poulpy_tpu.core import prepared as jprep
from poulpy_tpu.hal import vec_znx as jvz
from poulpy_tpu.hal.module import get_module as j_get_module
from poulpy_tpu.hal.source import Source as JSource
from poulpy_tpu_torch.backends import LAUNCHES
from poulpy_tpu_torch.ckks import ops as tck
from poulpy_tpu_torch.ckks import plaintext as tpt
from poulpy_tpu_torch.ckks.encoder import Encoder as TEncoder
from poulpy_tpu_torch.core import automorphism as tauto
from poulpy_tpu_torch.core import conversion as tconv
from poulpy_tpu_torch.core import encryption as tenc
from poulpy_tpu_torch.core import layouts as tlay
from poulpy_tpu_torch.core import operations as tops
from poulpy_tpu_torch.core import prepared as tprep
from poulpy_tpu_torch.hal import vec_znx as tvz
from poulpy_tpu_torch.hal.module import get_module as t_get_module
from poulpy_tpu_torch.hal.source import Source as TSource
from poulpy_tpu_torch.utils import interop

N = 64
BASE2K, K_CT, K_KEY, DNUM, LOG_DELTA, LOG_BUDGET = 17, 95, 95, 6, 22, 30

j_automorphism = jax.jit(jauto.glwe_automorphism, static_argnums=(0, 3, 4))
j_automorphism_add = jax.jit(jauto.glwe_automorphism_add, static_argnums=0)
j_ggsw_automorphism = jax.jit(jauto.ggsw_automorphism, static_argnums=0)
j_gglwe_prepare = jax.jit(jprep.gglwe_prepare, static_argnums=0)
j_mul_plain = jax.jit(jck.mul_plain, static_argnums=0)


def _eq(have, want):
    have = have.cpu().numpy() if isinstance(have, torch.Tensor) else np.asarray(have)
    want = np.asarray(want)
    return have.shape == want.shape and np.array_equal(have, want)


def _jkey(tkey):
    """The port's prepared automorphism key as the JAX package's layout."""
    k = tkey.key
    return jprep.GLWEAutomorphismKeyPrepared(
        key=jprep.GGLWEPrepared(pmat=jnp.asarray(k.pmat.numpy()), base2k=k.base2k, k=k.k,
                                dsize=k.dsize), p=tkey.p)


def _jct(tct):
    return jlay.GLWECiphertext(data=jnp.asarray(tct.data.numpy()), base2k=tct.base2k, k=tct.k)


@pytest.fixture(scope="module")
def setup():
    """The port's module, secret and automorphism keys (raw and prepared) of
    the rotation by one slot, by three slots back and the conjugation, from
    Source 0x05 / 0x06; the JAX package's module and its encryption of the
    first and last of those keys from the same seeds."""
    tm, jm = t_get_module(N, 2, 28, "cpu"), j_get_module(N, 2, 28)
    sk = tenc.secret_new(tm, 1, TSource(bytes(32)))
    xe, xa = TSource(b"\x05" * 32), TSource(b"\x06" * 32)
    keys = {}
    for name, p in (("rot1", tm.galois_element(1)), ("rot-3", tm.galois_element(-3)),
                    ("conj", -1)):
        key, p_out = tenc.glwe_automorphism_key_encrypt_sk(tm, p, sk, BASE2K, K_KEY, DNUM, xe, xa)
        keys[name] = (key, tprep.GLWEAutomorphismKeyPrepared(key=tprep.gglwe_prepare(tm, key),
                                                             p=p_out))
    jsk = jenc.secret_new(jm, 1, JSource(bytes(32)))
    jxe, jxa = JSource(b"\x05" * 32), JSource(b"\x06" * 32)
    jkeys = [jenc.glwe_automorphism_key_encrypt_sk(jm, p, jsk, BASE2K, K_KEY, DNUM, jxe, jxa)
             for p in (jm.galois_element(1), jm.galois_element(-3), -1)]
    return tm, jm, sk, jsk, keys, jkeys


def _cts(tm, sk, batch=2):
    """Encryptions of random limbs under the port's secret."""
    skp = tprep.glwe_secret_prepare(tm, sk)
    data = np.random.default_rng(70).integers(-(2**16), 2**16, size=(batch, 6, N))
    pt = tlay.GLWEPlaintext(data=torch.from_numpy(data), base2k=BASE2K, k=K_CT)
    return tenc.glwe_encrypt_sk(tm, pt, skp, BASE2K, K_CT, TSource(b"\x03" * 32),
                                TSource(b"\x04" * 32))


def test_galois_elements(setup):
    tm, jm = setup[:2]
    for e in (0, 1, 2, -1, -3, 100, -(2 * N)):
        assert tm.galois_element(e) == jm.galois_element(e)
        g = tm.galois_element(e)
        assert tm.galois_element_inv(g) == jm.galois_element_inv(g)


def test_automorphism_key_encrypt(setup):
    """The port's automorphism keys equal the JAX package's, data and p; the
    secret is the same."""
    tm, jm, sk, jsk, keys, jkeys = setup
    assert _eq(sk.data, jsk.data)
    for (key, prepared), (jkey, jp) in zip(keys.values(), jkeys):
        assert _eq(key.data, jkey.data) and (key.k, key.base2k, key.dsize) == (jkey.k, jkey.base2k,
                                                                              jkey.dsize)
        assert prepared.p == jp
    assert _eq(keys["rot1"][1].key.pmat, j_gglwe_prepare(jm, jkeys[0][0]).pmat)


@pytest.mark.parametrize("name", ["rot1", "rot-3", "conj"])
def test_glwe_automorphism(setup, name):
    tm, jm, sk, _, keys, _ = setup
    ct = _cts(tm, sk)
    key = keys[name][1]
    before = dict(LAUNCHES)
    have = tauto.glwe_automorphism(tm, ct, key)
    assert LAUNCHES == before
    want = j_automorphism(jm, _jct(ct), _jkey(key), None, None)
    assert _eq(have.data, want.data) and (have.base2k, have.k) == (want.base2k, want.k)
    add = tauto.glwe_automorphism_add(tm, ct, key)
    assert _eq(add.data, j_automorphism_add(jm, _jct(ct), _jkey(key)).data)


def test_automorphism_key_automorphism(setup):
    """The key of 5 composed with the key of −1 into the key of −5."""
    tm, jm, _, _, keys, _ = setup
    raw, prepared = keys["rot1"][0], keys["conj"][1]
    have, p_have = tauto.glwe_automorphism_key_automorphism(tm, raw, 5, prepared)
    jraw = jlay.GGLWECiphertext(data=jnp.asarray(raw.data.numpy()), base2k=raw.base2k, k=raw.k,
                                dsize=raw.dsize)
    want, p_want = jauto.glwe_automorphism_key_automorphism(jm, jraw, 5, _jkey(prepared))
    assert p_have == p_want == 2 * N - 5
    assert _eq(have.data, want.data) and (have.k, have.dsize) == (want.k, want.dsize)


def test_ggsw_automorphism_waits_for_circuit_bootstrapping(setup):
    """ggsw_automorphism, which came with circuit bootstrapping: φ_5 of a
    GGSW of X (k 68, dnum 3) through the rotation key and a GGLWE → GGSW
    key (k 95, dnum 6) made by the port, against the JAX package's on the
    same keys."""
    tm, jm, sk, _, keys, _ = setup
    skp = tprep.glwe_secret_prepare(tm, sk)
    ptg = np.zeros(N, dtype=np.int64)
    ptg[1] = 1
    xe, xa = TSource(b"\x07" * 32), TSource(b"\x08" * 32)
    ggsw = tenc.ggsw_encrypt_sk(tm, ptg, skp, BASE2K, 68, 3, xe, xa)
    tsk = tconv.gglwe_to_ggsw_key_encrypt_sk(tm, sk, skp, BASE2K, K_KEY, DNUM, xe, xa)
    have = tauto.ggsw_automorphism(tm, ggsw, keys["rot1"][1], tsk)
    jtsk = [jprep.GGLWEPrepared(pmat=jnp.asarray(k.pmat.numpy()), base2k=k.base2k, k=k.k,
                                dsize=k.dsize) for k in tsk]
    jggsw = jlay.GGSWCiphertext(data=jnp.asarray(ggsw.data.numpy()), base2k=ggsw.base2k,
                                k=ggsw.k, dsize=ggsw.dsize)
    want = j_ggsw_automorphism(jm, jggsw, _jkey(keys["rot1"][1]), jtsk)
    assert _eq(have.data, want.data) and (have.base2k, have.k, have.dsize) == (
        want.base2k, want.k, want.dsize)


@pytest.mark.parametrize("batched", [False, True])
def test_rotations(batched):
    """glwe_rotate, ggsw_rotate and glwe_mul_xp_minus_one, by one amount or
    one per ciphertext."""
    rng = np.random.default_rng(71)
    glwe = rng.integers(-(2**16), 2**16, size=(3, 2, 4, N))
    ggsw = rng.integers(-(2**16), 2**16, size=(3, 2, 2, 2, 4, N))
    p = rng.integers(-2 * N, 2 * N, size=(3,)) if batched else 37
    # a batched amount broadcasts against the leading axes of the layout
    tp_c, jp_c, tp_s, jp_s = p, p, p, p
    if batched:
        tp_c, jp_c = torch.from_numpy(p)[:, None, None], jnp.asarray(p)[:, None, None]
        tp_s, jp_s = tp_c[..., None, None], jp_c[..., None, None]
    tg = tlay.GLWECiphertext(data=torch.from_numpy(glwe), base2k=BASE2K, k=68)
    jg = jlay.GLWECiphertext(data=jnp.asarray(glwe), base2k=BASE2K, k=68)
    tgg = tlay.GGSWCiphertext(data=torch.from_numpy(ggsw), base2k=BASE2K, k=68)
    jgg = jlay.GGSWCiphertext(data=jnp.asarray(ggsw), base2k=BASE2K, k=68)
    assert _eq(tops.glwe_rotate(tp_c, tg).data, jops.glwe_rotate(jp_c, jg).data)
    assert _eq(tops.glwe_mul_xp_minus_one(tp_c, tg).data,
               jops.glwe_mul_xp_minus_one(jp_c, jg).data)
    assert _eq(tops.ggsw_rotate(tp_s, tgg).data, jops.ggsw_rotate(jp_s, jgg).data)


def test_vec_znx_helpers():
    a = np.random.default_rng(72).integers(-(2**16), 2**16, size=(2, 3, N))
    assert _eq(tvz.vec_znx_mul_xp_minus_one(-5, torch.from_numpy(a)),
               jvz.vec_znx_mul_xp_minus_one(-5, jnp.asarray(a)))
    assert np.array_equal(tvz.decode_vec_float(BASE2K, torch.from_numpy(a)),
                          jvz.decode_vec_float(BASE2K, a))


# ---- CKKS -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckks(setup):
    """Slots z, their encryption in the port and the same ciphertext as the
    JAX package's layout."""
    tm, jm, sk, _, _, _ = setup
    rng = np.random.default_rng(73)
    z = rng.normal(size=N // 2) + 1j * rng.normal(size=N // 2)
    skp = tprep.glwe_secret_prepare(tm, sk)
    pt = tck.encode(TEncoder(N), z, BASE2K, K_CT, LOG_DELTA, LOG_BUDGET, device="cpu")
    ct = tck.encrypt_sk(tm, pt, skp, K_CT, TSource(b"\x03" * 32), TSource(b"\x04" * 32))
    jct = jck.CKKSCiphertext(glwe=_jct(ct.glwe), meta=jck.CKKSMeta(LOG_DELTA, LOG_BUDGET))
    return z, skp, ct, jct


def _slots(tm, skp, ct):
    return tck.decode(TEncoder(N), tck.decrypt(tm, ct, skp))


def test_ckks_rotate_and_conjugate(setup, ckks):
    tm, jm, _, _, keys, _ = setup
    z, skp, ct, jct = ckks
    for name, op, expect in (("rot1", "rotate", np.roll(z, -1)), ("rot-3", "rotate", np.roll(z, 3)),
                             ("conj", "conjugate", np.conj(z))):
        key = keys[name][1]
        have = getattr(tck, op)(tm, ct, key)
        want = jax.jit(getattr(jck, op), static_argnums=0)(jm, jct, _jkey(key))
        assert _eq(have.glwe.data, want.glwe.data) and have.meta == ct.meta
        assert np.abs(_slots(tm, skp, have) - expect).max() < 1e-4, name


def test_ckks_rotate_by(setup, ckks):
    tm, _, _, _, keys, _ = setup
    z, skp, ct, _ = ckks
    key_map = {1: keys["rot1"][1], -3: keys["rot-3"][1]}
    assert torch.equal(tck.rotate_by(tm, ct, key_map, -3).glwe.data,
                       tck.rotate(tm, ct, key_map[-3]).glwe.data)
    with pytest.raises(tck.MissingAutomorphismKey) as err:
        tck.rotate_by(tm, ct, key_map, 2)
    assert err.value.rotation == 2 and isinstance(err.value, tck.CKKSError)
    with pytest.raises(jck.MissingAutomorphismKey):
        jck.rotate_by(None, None, {}, 2)


def test_plaintext_forms(setup, ckks):
    """Every function of ckks/plaintext.py."""
    tm, jm, _, _, _, _ = setup
    z, skp, ct, jct = ckks
    coeffs = np.random.default_rng(74).normal(size=(N,))
    meta = tck.CKKSMeta(LOG_DELTA, 20)
    jmeta = jck.CKKSMeta(LOG_DELTA, 20)
    vec, jvec = (tpt.CKKSPlaintextVecRnx(coeffs=torch.from_numpy(coeffs)),
                 jpt.CKKSPlaintextVecRnx(coeffs=jnp.asarray(coeffs)))
    pt, jp = tpt.vec_rnx_to_znx(vec, BASE2K, 68, meta), jpt.vec_rnx_to_znx(jvec, BASE2K, 68, jmeta)
    assert _eq(pt.pt.data, jp.pt.data) and pt.meta == meta and pt.pt.k == jp.pt.k
    back = tpt.vec_rnx_from_znx(pt)
    assert _eq(back.coeffs, jpt.vec_rnx_from_znx(jp).coeffs) and back.n == N
    assert np.abs(back.coeffs.numpy() - coeffs).max() < 2.0**-LOG_DELTA
    have = tpt.mul_plain_rnx(tm, ct, vec, meta)
    want = j_mul_plain(jm, jct, jpt.vec_rnx_to_znx(jvec, BASE2K, meta.effective_k, jmeta))
    assert _eq(have.glwe.data, want.glwe.data)
    assert (have.meta.log_delta, have.meta.log_budget) == (want.meta.log_delta,
                                                            want.meta.log_budget)
    for re, im in ((1.25, None), (None, -0.5), (0.75, 2.0), (None, None)):
        cst, jcst = tpt.CKKSPlaintextCstRnx(re=re, im=im), jpt.CKKSPlaintextCstRnx(re=re, im=im)
        q = tpt.cst_rnx_to_znx(cst, tck.CKKSMeta(8, 0))
        jq = jpt.cst_rnx_to_znx(jcst, jck.CKKSMeta(8, 0))
        assert (q.re, q.im) == (jq.re, jq.im) and q.meta == tck.CKKSMeta(8, 0)
        have = tpt.mul_cst_znx(tm, ct, q)
        assert _eq(have.glwe.data, jpt.mul_cst_znx(jm, jct, jq).glwe.data)
        have_r = tpt.mul_cst_rnx(tm, ct, cst, tck.CKKSMeta(8, 0))
        assert torch.equal(have_r.glwe.data, have.glwe.data) and have_r.meta == have.meta
        c = (re or 0) + 1j * (im or 0)
        assert np.abs(_slots(tm, skp, have) - c * z).max() < 1e-3, (re, im)


def test_interop(setup, ckks):
    """Automorphism keys, GGLWE ciphertexts and the float plaintext forms
    cross both ways; a JAX key drives the port's rotation."""
    tm, jm, _, _, keys, jkeys = setup
    z, skp, ct, jct = ckks
    jraw = jkeys[0][0]
    raw = interop.from_fields(*interop.to_fields(jraw), device="cpu")
    assert isinstance(raw, tlay.GGLWECiphertext) and _eq(raw.data, jraw.data)
    jprepared = jprep.GLWEAutomorphismKeyPrepared(key=j_gglwe_prepare(jm, jraw), p=jkeys[0][1])
    prepared = interop.from_fields(*interop.to_fields(jprepared), device="cpu")
    assert isinstance(prepared, tprep.GLWEAutomorphismKeyPrepared) and prepared.p == 5
    assert torch.equal(tck.rotate(tm, ct, prepared).glwe.data,
                       tck.rotate(tm, ct, keys["rot1"][1]).glwe.data)
    name, fields = interop.to_fields(keys["rot1"][1])
    assert name == "GLWEAutomorphismKeyPrepared" and fields["p"] == 5
    assert _eq(fields["key"][1]["pmat"], jprepared.key.pmat)
    for obj in (jpt.CKKSPlaintextVecRnx(coeffs=jnp.arange(N, dtype=jnp.float64)),
                jpt.CKKSPlaintextCstRnx(re=0.5), jpt.CKKSPlaintextCstZnx(re=3, im=-2,
                                                                       meta=jck.CKKSMeta(8, 4))):
        port = interop.from_fields(*interop.to_fields(obj), device="cpu")
        assert type(port).__name__ == type(obj).__name__
        back = interop.to_fields(port)[1]
        for k, v in interop.to_fields(obj)[1].items():
            assert np.array_equal(back[k], v) if isinstance(v, np.ndarray) else back[k] == v
