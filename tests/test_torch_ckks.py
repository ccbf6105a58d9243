"""poulpy_tpu_torch.ckks against poulpy_tpu.ckks, bit for bit (tolerance 0),
and the slice as a whole: keygen (a ternary_hw secret, the tensor key) →
encode → encrypt → ct × ct multiply → decrypt → decode in both packages.

Two configurations, at N 64: tests/test_ckks.py's `ctx` (base2k 17, k 119,
dnum 7: the non-wide mul) and tests/test_wide.py's CKKS parameters
(base2k 52, k 95, tensor key k 156, dnum 2, get_module(64, 5, 28): the wide
mul, where the port takes its fused wide pair and the JAX package, on the
CPU, its jnp data flow).  The `slow` test recomputes chip_smoke.py's two
CKKS fingerprints at bench_full.py's full configurations.
"""

import numpy as np
import pytest
import torch

import jax

from poulpy_tpu.ckks import ops as jck
from poulpy_tpu.ckks.encoder import Encoder as JEncoder
from poulpy_tpu.core import encryption as jenc
from poulpy_tpu.core import prepared as jprep
from poulpy_tpu.hal.module import get_module as j_get_module
from poulpy_tpu.hal.source import Source as JSource
from poulpy_tpu_torch.backends import LAUNCHES
from poulpy_tpu_torch.ckks import ops as tck
from poulpy_tpu_torch.ckks.encoder import Encoder as TEncoder
from poulpy_tpu_torch.core import encryption as tenc
from poulpy_tpu_torch.core import prepared as tprep
from poulpy_tpu_torch.hal.module import get_module as t_get_module
from poulpy_tpu_torch.hal.source import Source as TSource
from poulpy_tpu_torch.utils import interop

N = 64
# name → (base2k, k_ct, k_key, log_delta, log_budget, dnum, nprimes, prime_bits, hw)
CONFIGS = {
    "ctx": (17, 119, 119, 22, 30, 7, 4, 30, None),
    "wide": (52, 95, 156, 30, 35, 2, 5, 28, 16),
}

# the JAX package's eager steps, each compiled once
j_secret_prepare = jax.jit(jprep.glwe_secret_prepare, static_argnums=0)
j_tensor_key_prepare = jax.jit(jprep.glwe_tensor_key_prepare, static_argnums=0)
j_mul_plain = jax.jit(jck.mul_plain, static_argnums=0)


def _eq(have, want):
    have = have.cpu().numpy() if isinstance(have, torch.Tensor) else np.asarray(have)
    want = np.asarray(want)
    return have.shape == want.shape and np.array_equal(have, want)


def _slots(seed, count=1):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=N // 2) + 1j * rng.normal(size=N // 2) for _ in range(count)]


class _Ctx:
    """One configuration in one package: module, secret, tensor key, encoder."""

    def __init__(self, pkg: str, name: str):
        base2k, k_ct, k_key, ld, lb, dnum, nprimes, bits, hw = CONFIGS[name]
        self.pkg, self.base2k, self.k_ct, self.ld, self.lb = pkg, base2k, k_ct, ld, lb
        if pkg == "jax":
            self.m, self.S, self.ck, enc = j_get_module(N, nprimes, bits), JSource, jck, jenc
            self.encoder, sprep, tprep_ = JEncoder(N), j_secret_prepare, j_tensor_key_prepare
            self.kw = {}
        else:
            self.m, self.S, self.ck, enc = t_get_module(N, nprimes, bits, "cpu"), TSource, tck, tenc
            self.encoder, sprep, tprep_ = TEncoder(N), tprep.glwe_secret_prepare, \
                tprep.glwe_tensor_key_prepare
            self.kw = {"device": "cpu"}
        dist = {"dist": "ternary_hw", "hw": hw} if hw else {}
        self.sk = enc.secret_new(self.m, 1, self.S(bytes(32)), **dist)
        self.skp = sprep(self.m, self.sk)
        self.tk = enc.glwe_tensor_key_encrypt_sk(self.m, self.sk, self.skp, base2k, k_key,
                                                 dnum=dnum, source_xe=self.S(b"\x01" * 32),
                                                 source_xa=self.S(b"\x02" * 32))
        self.tsk = tprep_(self.m, self.tk)

    def encode(self, z, log_budget=None, log_delta=None):
        return self.ck.encode(self.encoder, z, self.base2k, self.k_ct,
                              self.ld if log_delta is None else log_delta,
                              self.lb if log_budget is None else log_budget, **self.kw)

    def encrypt(self, zs, log_budget=None, log_delta=None):
        xe, xa = self.S(b"\x03" * 32), self.S(b"\x04" * 32)
        return [self.ck.encrypt_sk(self.m, self.encode(z, log_budget, log_delta), self.skp,
                                   self.k_ct, xe, xa) for z in zs]

    def slots(self, ct):
        return self.ck.decode(self.encoder, self.ck.decrypt(self.m, ct, self.skp))


@pytest.fixture(scope="module")
def ctx():
    return _Ctx("jax", "ctx"), _Ctx("torch", "ctx")


@pytest.fixture(scope="module")
def wide():
    return _Ctx("jax", "wide"), _Ctx("torch", "wide")


@pytest.fixture(params=["ctx", "wide"])
def ctxs(request):
    """The non-wide and the wide configuration, in turn."""
    return request.getfixturevalue(request.param)


# ---- keys and the encoder -------------------------------------------------------

@pytest.mark.parametrize("n,hw", [(64, 16), (2048, 192)])
def test_source_ternary_hw(n, hw):
    j = JSource(b"\x07" * 32)
    t = TSource(b"\x07" * 32)
    x = t.ternary_hw(n, hw)
    assert np.array_equal(x, j.ternary_hw(n, hw))
    assert int(np.abs(x).sum()) == hw
    assert np.array_equal(t.u64_array(3), j.u64_array(3))    # the streams stay aligned


def test_secret_and_tensor_key(ctxs):
    """secret_new (ternary_hw for the wide configuration), the tensor key's
    GGLWE of s·s and its prepared matrix."""
    j, t = ctxs
    assert _eq(t.sk.data, j.sk.data) and t.sk.dist == j.sk.dist
    assert list(t.tk) == list(j.tk) == [(0, 0)]
    assert _eq(t.tk[(0, 0)].data, j.tk[(0, 0)].data)
    tkey, jkey = t.tsk.keys[(0, 0)], j.tsk.keys[(0, 0)]
    assert _eq(tkey.pmat, jkey.pmat)
    assert (tkey.base2k, tkey.k, tkey.dsize, tkey.dnum) == (jkey.base2k, jkey.k, jkey.dsize,
                                                            jkey.dnum)


def test_encoder():
    (z,) = _slots(40)
    je, te = JEncoder(N), TEncoder(N)
    coeffs = te.encode(z, 30)
    assert np.array_equal(coeffs, je.encode(z, 30))
    assert np.array_equal(te.decode(coeffs, 30), je.decode(coeffs, 30))
    assert np.abs(te.decode(coeffs, 30) - z).max() < 1e-6


def test_encode_encrypt_decrypt(ctxs):
    j, t = ctxs
    zs = _slots(41)
    assert _eq(t.encode(zs[0]).pt.data, j.encode(zs[0]).pt.data)
    (jc,), (tc,) = j.encrypt(zs), t.encrypt(zs)
    assert _eq(tc.glwe.data, jc.glwe.data) and tc.meta == tck.CKKSMeta(j.ld, j.lb)
    got = t.slots(tc)
    assert np.array_equal(got, j.slots(jc))
    assert np.abs(got - zs[0]).max() < 4e-6


# ---- ct × ct ----------------------------------------------------------------------

def test_mul(ctxs, monkeypatch):
    """ckks.mul: equal data and meta, and the decrypted product is z1·z2.
    The wide configuration goes through the port's fused wide pair (its
    plain versions on the CPU)."""
    j, t = ctxs
    z1, z2 = _slots(42, 2)
    (jc1, jc2), (tc1, tc2) = j.encrypt([z1, z2]), t.encrypt([z1, z2])
    calls = []
    fused = tck.fused_tensor_product_wide
    monkeypatch.setattr(tck, "fused_tensor_product_wide",
                        lambda *a, **k: calls.append(1) or fused(*a, **k))
    before = dict(LAUNCHES)
    have = tck.mul(t.m, tc1, tc2, t.tsk)
    want = jck.mul(j.m, jc1, jc2, j.tsk)
    assert LAUNCHES == before
    assert len(calls) == (t.base2k == 52)
    assert _eq(have.glwe.data, want.glwe.data)
    assert (have.meta.log_delta, have.meta.log_budget) == (want.meta.log_delta,
                                                            want.meta.log_budget)
    assert np.abs(t.slots(have) - z1 * z2).max() < 1e-3


def test_mul_wide_unfused_route(wide, monkeypatch):
    """The wide shapes the fused pair does not take run the unfused wide data
    flow, with the same result."""
    j, t = wide
    z1, z2 = _slots(43, 2)
    (jc1, jc2), (tc1, tc2) = j.encrypt([z1, z2]), t.encrypt([z1, z2])
    monkeypatch.setattr(tck, "tensor_wide_supported", lambda *a: False)
    have = tck.mul(t.m, tc1, tc2, t.tsk)
    assert _eq(have.glwe.data, jck.mul(j.m, jc1, jc2, j.tsk).glwe.data)


def test_mul_many_three(ctx):
    """The balanced tree of three (one sub-product cut to its precision):
    two levels of budget, at log_delta 18 and log_budget 40."""
    j, t = ctx
    zs = [0.5 * z for z in _slots(44, 3)]
    have = tck.mul_many(t.m, t.encrypt(zs, 40, 18), t.tsk)
    want = jck.mul_many(j.m, j.encrypt(zs, 40, 18), j.tsk)
    assert _eq(have.glwe.data, want.glwe.data) and have.meta == tck.CKKSMeta(
        want.meta.log_delta, want.meta.log_budget)
    assert np.abs(t.slots(have) - zs[0] * zs[1] * zs[2]).max() < 1e-3


def test_mul_plain_and_rescale(ctxs):
    j, t = ctxs
    z1, z2 = _slots(45, 2)
    (jc,), (tc,) = j.encrypt([z1]), t.encrypt([z1])
    have = tck.mul_plain(t.m, tc, t.encode(z2))
    want = j_mul_plain(j.m, jc, j.encode(z2))
    assert _eq(have.glwe.data, want.glwe.data)
    assert np.abs(t.slots(have) - z1 * z2).max() < 1e-3
    r_have, r_want = tck.rescale(tc, 5), jck.rescale(jc, 5)
    assert _eq(r_have.glwe.data, r_want.glwe.data) and r_have.log_budget == t.lb - 5
    assert np.abs(t.slots(r_have) - z1).max() < 4e-6


# ---- the other leveled operations (non-wide configuration) ------------------------

@pytest.mark.parametrize("op", ["add", "sub", "negate", "add_plain", "sub_plain", "mul_pow2",
                                "div_pow2", "mul_const", "add_const"])
def test_leveled_op(ctx, op):
    j, t = ctx
    z1, z2 = _slots(46, 2)
    (jc1, jc2), (tc1, tc2) = j.encrypt([z1, z2]), t.encrypt([z1, z2])
    # a second operand at a smaller budget exercises the alignment of add / sub
    (jc3,), (tc3,) = j.encrypt([z2], log_budget=25), t.encrypt([z2], log_budget=25)
    args = {
        "add": ((tc1, tc3), (jc1, jc3), z1 + z2),
        "sub": ((tc1, tc3), (jc1, jc3), z1 - z2),
        "negate": ((tc1,), (jc1,), -z1),
        "add_plain": ((tc1, t.encode(z2)), (jc1, j.encode(z2)), z1 + z2),
        "sub_plain": ((tc1, t.encode(z2)), (jc1, j.encode(z2)), z1 - z2),
        "mul_pow2": ((tc1, 3), (jc1, 3), 8 * z1),
        "div_pow2": ((tc1, 3), (jc1, 3), z1 / 8),
        "mul_const": ((tc1, 1.75, 8), (jc1, 1.75, 8), 1.75 * z1),
        "add_const": ((tc1, -0.5), (jc1, -0.5), z1 - 0.5),
    }
    targs, jargs, expect = args[op]
    have, want = getattr(tck, op)(*targs), getattr(jck, op)(*jargs)
    assert _eq(have.glwe.data, want.glwe.data)
    assert (have.meta.log_delta, have.meta.log_budget) == (want.meta.log_delta,
                                                            want.meta.log_budget)
    assert np.abs(t.slots(have) - expect).max() < 1e-4


def test_composite_ops(ctx):
    """mul_add, mul_sub and dot_product."""
    j, t = ctx
    zs = _slots(47, 3)
    jc, tc = j.encrypt(zs), t.encrypt(zs)
    have = tck.mul_add(t.m, tc[0], tc[1], tc[2], t.tsk)
    assert _eq(have.glwe.data, jck.mul_add(j.m, jc[0], jc[1], jc[2], j.tsk).glwe.data)
    assert np.abs(t.slots(have) - (zs[0] * zs[1] + zs[2])).max() < 1e-3
    have = tck.mul_sub(t.m, tc[0], tc[1], tc[2], t.tsk)
    assert _eq(have.glwe.data, jck.mul_sub(j.m, jc[0], jc[1], jc[2], j.tsk).glwe.data)
    have = tck.dot_product(t.m, tc[:2], tc[1:], t.tsk)
    assert _eq(have.glwe.data, jck.dot_product(j.m, jc[:2], jc[1:], j.tsk).glwe.data)
    assert np.abs(t.slots(have) - (zs[0] * zs[1] + zs[1] * zs[2])).max() < 1e-3


def test_composition_errors(ctx):
    j, t = ctx
    (tc,) = t.encrypt(_slots(48), log_budget=10)       # budget < delta
    with pytest.raises(tck.InsufficientHomomorphicCapacity):
        tck.mul(t.m, tc, tc, t.tsk)
    with pytest.raises(tck.PlaintextBase2KMismatch):
        tck.mul(t.m, tc, tc.replace(glwe=tc.glwe.replace(base2k=16)), t.tsk)
    with pytest.raises(tck.PlaintextAlignmentImpossible):
        tck.add(tc, tck.div_pow2(tc, 1))
    assert issubclass(tck.MissingAutomorphismKey, tck.CKKSError)


# ---- the core operations of this slice ------------------------------------------

OPS = ["glwe_rsh", "glwe_lsh_add", "glwe_lsh_sub", "glwe_normalize_inplace", "glwe_mul_plain",
       "glwe_mul_plain_wide", "glwe_tensor_square_big", "big_add", "big_sub"]


@pytest.mark.parametrize("op", OPS)
def test_core_operation(op):
    """core/operations.py and hal/dft.py's big ops against the JAX package's
    (compiled once each with jit), on random limbs."""
    from poulpy_tpu.core import layouts as jlay
    from poulpy_tpu.core import operations as jops
    from poulpy_tpu.hal import dft as jdft
    from poulpy_tpu_torch.core import layouts as tlay
    from poulpy_tpu_torch.core import operations as tops
    from poulpy_tpu_torch.hal import dft as tdft

    wide_op = op == "glwe_mul_plain_wide"
    base2k, nprimes, bits = (52, 5, 28) if wide_op else (17, 4, 30)
    jm, tm = j_get_module(N, nprimes, bits), t_get_module(N, nprimes, bits, "cpu")
    rng = np.random.default_rng(50 + OPS.index(op))
    a, b = (rng.integers(-(2**(base2k - 1)), 2**(base2k - 1), size=(2, 2, size, N))
            for size in (2, 3))
    pt = rng.integers(-(2**(base2k - 1)), 2**(base2k - 1), size=(2, N))

    def run(lay, ops, hdft, m, arr):
        ga = lay.GLWECiphertext(data=arr(a), base2k=base2k, k=2 * base2k)
        gb = lay.GLWECiphertext(data=arr(b), base2k=base2k, k=3 * base2k - 5)
        if op == "glwe_rsh":
            return ops.glwe_rsh(7, gb).data
        if op in ("glwe_lsh_add", "glwe_lsh_sub"):
            return getattr(ops, op)(9, ga, gb).data
        if op == "glwe_normalize_inplace":
            return ops.glwe_normalize_inplace(ga.replace(data=ga.data * 3000)).data
        if op.startswith("glwe_mul_plain"):
            plain = lay.GLWEPlaintext(data=arr(pt), base2k=base2k, k=2 * base2k)
            return ops.glwe_mul_plain(m, gb, plain).data
        if op == "glwe_tensor_square_big":
            lin, quad = ops.glwe_tensor_square_big(m, gb, 5)
            return lin + [quad[(0, 0)]]
        return getattr(hdft, op)(arr(a[:, 0]), arr(b[:, 1]))

    want = jax.jit(lambda: run(jlay, jops, jdft, jm, jax.numpy.asarray))()
    have = run(tlay, tops, tdft, tm, torch.from_numpy)
    if isinstance(have, list):
        assert len(have) == len(want) and all(_eq(h, w) for h, w in zip(have, want))
    else:
        assert _eq(have, want)


# ---- interop --------------------------------------------------------------------

def test_jax_tensor_key_and_ciphertexts_drive_the_port(wide):
    """A JAX tensor key and JAX ciphertexts, carried into the port, give the
    JAX package's product; the port's objects cross back unchanged."""
    j, t = wide
    z1, z2 = _slots(49, 2)
    jc1, jc2 = j.encrypt([z1, z2])
    tsk = interop.from_fields(*interop.to_fields(j.tsk), device="cpu")
    tc1, tc2 = (interop.from_fields(*interop.to_fields(c), device="cpu") for c in (jc1, jc2))
    assert isinstance(tsk, tprep.GLWETensorKeyPrepared) and isinstance(tc1, tck.CKKSCiphertext)
    assert tc1.meta == tck.CKKSMeta(j.ld, j.lb)
    have = tck.mul(t.m, tc1, tc2, tsk)
    assert _eq(have.glwe.data, jck.mul(j.m, jc1, jc2, j.tsk).glwe.data)
    name, fields = interop.to_fields(have)
    assert name == "CKKSCiphertext" and fields["meta"][1] == {"log_delta": have.meta.log_delta,
                                                             "log_budget": have.meta.log_budget}
    back = interop.from_fields(name, fields, device="cpu")
    assert torch.equal(back.glwe.data, have.glwe.data) and back.meta == have.meta
    pt = interop.from_fields(*interop.to_fields(j.encode(z1)), device="cpu")
    assert isinstance(pt, tck.CKKSPlaintext) and _eq(pt.pt.data, j.encode(z1).pt.data)
    name, fields = interop.to_fields(tsk)
    assert name == "GLWETensorKeyPrepared" and _eq(fields["keys"][(0, 0)][1]["pmat"],
                                                   j.tsk.keys[(0, 0)].pmat)


# ---- the chip_smoke.py CKKS fingerprints -----------------------------------------

def _bench_mul(pkg: str, wide: bool):
    """bench_full.py's bench_ckks_mul_wide / bench_ckks_mul set-up and one
    multiply (then rescale(5) for the non-wide one), one ciphertext pair."""
    import chip_smoke

    c = chip_smoke.CKKS_WIDE if wide else chip_smoke.CKKS
    if pkg == "jax":
        m, S, ck, enc, prep, E, kw = (j_get_module(c.n, c.nprimes, 28), JSource, jck, jenc,
                                      jprep, JEncoder, {})
    else:
        m, S, ck, enc, prep, E, kw = (t_get_module(c.n, c.nprimes, 28, "cpu"), TSource, tck, tenc,
                                      tprep, TEncoder, {"device": "cpu"})
    dist = {"dist": "ternary_hw", "hw": c.hw} if c.hw else {}
    sk = enc.secret_new(m, 1, S(bytes(32)), **dist)
    skp = prep.glwe_secret_prepare(m, sk)
    xe, xa = S(b"\x01" * 32), S(b"\x02" * 32)
    tsk = prep.glwe_tensor_key_prepare(m, enc.glwe_tensor_key_encrypt_sk(
        m, sk, skp, c.base2k, c.k_key, dnum=c.dnum, source_xe=xe, source_xa=xa))
    encoder = E(c.n)
    rng = np.random.default_rng(c.seed)
    z = rng.normal(size=c.n // 2) + 1j * rng.normal(size=c.n // 2)
    pt = ck.encode(encoder, z, c.base2k, c.k_ct, c.log_delta, c.log_budget, **kw)
    c1 = ck.encrypt_sk(m, pt, skp, c.k_ct, xe, xa)
    c2 = ck.encrypt_sk(m, pt, skp, c.k_ct, xe, xa)
    out = ck.mul(m, c1, c2, tsk)
    if c.rescale:
        out = ck.rescale(out, c.rescale)
    got = ck.decode(encoder, ck.decrypt(m, out, skp))
    return np.asarray(out.glwe.data), np.abs(got - z * z).max()


@pytest.mark.slow
@pytest.mark.parametrize("wide_cfg", [True, False], ids=["ckks_wide", "ckks"])
def test_ckks_fingerprint_full_config(wide_cfg):
    """chip_smoke.py's CKKS fingerprints: sum(|data| mod 65536) of one
    multiply at bench_full.py's configuration and seeds, recomputed by the
    JAX package on the CPU, and the port's plain path gives the same data."""
    import chip_smoke

    want, jerr = _bench_mul("jax", wide_cfg)
    have, terr = _bench_mul("torch", wide_cfg)
    expected = chip_smoke.CKKS_WIDE_FINGERPRINT if wide_cfg else chip_smoke.CKKS_FINGERPRINT
    assert int((np.abs(want) % 65536).sum()) == expected
    assert np.array_equal(have, want) and terr == jerr
