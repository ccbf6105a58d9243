"""poulpy_tpu_torch's BDD arithmetic (FheUint) against poulpy_tpu's, bit for
bit (tolerance 0).

bench_schemes.py's u32 add cut in N (64) and n_lwe (14, blocks of 7), at its
base2k 15 and its k and dnum: get_module(64, 2, 28), a block-binary LWE
secret, circuit-bootstrapping keys k 60 dnum 4, the GLWE → LWE key k 30
dnum 2, ciphertexts k 30, selectors k 45 dnum 3.  The port makes the keys
(the JAX package's keygen compiles for minutes on the CPU) and `interop`
carries them over; the JAX package prepares one operand under `jax.jit`
(one circuit bootstrap per file), the other comes from the port through
`interop`.  Covered: every circuit's nodes and root at widths 4–32, the
plain evaluation, `fheuint_encrypt` / `fheuint_decrypt`, `fheuint_prepare`,
`fheuint_prepared_encrypt_sk`, `fheuint_op` for the eleven ops at width 4
(decrypting to Python's int semantics), `fheuint_op_1w`, `blind_select`,
both blind rotations and the layouts' interop.  The `slow` test recomputes
chip_smoke.py's FHEUINT_ADD_FINGERPRINT with the JAX package at full size.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poulpy_tpu.binfhe import bdd as jbdd
from poulpy_tpu.binfhe import blind_rotation as jbr
from poulpy_tpu.binfhe import circuit_bootstrapping as jcbt
from poulpy_tpu.core import encryption as jenc
from poulpy_tpu.core import layouts as jlay
from poulpy_tpu.core import prepared as jprep
from poulpy_tpu.hal import vec_znx as jvz
from poulpy_tpu.hal.module import get_module as j_get_module
from poulpy_tpu.hal.source import Source as JSource
from poulpy_tpu_torch.backends import LAUNCHES
from poulpy_tpu_torch.binfhe import bdd as tbdd
from poulpy_tpu_torch.binfhe.circuit_bootstrapping import circuit_bootstrapping_keygen
from poulpy_tpu_torch.core import encryption as tenc
from poulpy_tpu_torch.core import layouts as tlay
from poulpy_tpu_torch.core import prepared as tprep
from poulpy_tpu_torch.core.conversion import glwe_to_lwe_key_encrypt_sk
from poulpy_tpu_torch.core.decryption import glwe_decrypt
from poulpy_tpu_torch.hal import vec_znx as tvz
from poulpy_tpu_torch.hal.module import get_module as t_get_module
from poulpy_tpu_torch.hal.source import Source as TSource
from poulpy_tpu_torch.utils import interop

N, N_LWE, BLOCK, BASE2K = 64, 14, 7, 15
K_CT, K_GGSW, DNUM_GGSW, K_CBT, DNUM_CBT, DNUM_KS = 30, 45, 3, 60, 4, 2
WIDTH, VA, VB = 4, 11, 6
OPS = ["add", "sub", "and", "or", "xor", "slt", "sltu", "sll", "srl", "sra", "identity"]

JAX_CLASSES = {cls.__name__: cls for cls in (
    jbdd.BDDKey, jbdd.FheUint, jbdd.FheUintPrepared, jcbt.CircuitBootstrappingKey,
    jbr.BlindRotationKeyPrepared, jprep.GGLWEPrepared, jprep.GGSWPrepared,
    jprep.GLWEAutomorphismKeyPrepared, jprep.GLWESecretPrepared, jlay.GLWECiphertext,
    jlay.GGSWCiphertext)}


def plain_semantics(op: str, a: int, b: int, w: int) -> int:
    """Python's int semantics of each op at width w (shift amounts: the low
    log2(w) bits of b; slt signed; sra sign-filling)."""
    mask = (1 << w) - 1
    amt = b & ((1 << (w - 1).bit_length()) - 1)

    def signed(x):
        return x - (1 << w) if x & (1 << (w - 1)) else x

    return {
        "add": lambda: (a + b) & mask, "sub": lambda: (a - b) & mask,
        "and": lambda: a & b, "or": lambda: a | b, "xor": lambda: a ^ b,
        "slt": lambda: int(signed(a) < signed(b)), "sltu": lambda: int(a < b),
        "sll": lambda: (a << amt) & mask, "srl": lambda: a >> amt,
        "sra": lambda: (signed(a) >> amt) & mask, "identity": lambda: a,
    }[op]()


def _eq(have, want):
    have = have.cpu().numpy() if isinstance(have, torch.Tensor) else np.asarray(have)
    want = np.asarray(want)
    return have.shape == want.shape and np.array_equal(have, want)


def _jax(name: str, fields: dict):
    """The JAX package's object from `interop.to_fields` of the port's."""
    def conv(v):
        if isinstance(v, np.ndarray):
            return jnp.asarray(v)
        if interop._is_fields(v):
            return _jax(*v)
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, list):
            return [conv(x) for x in v]
        return v

    return JAX_CLASSES[name](**{k: conv(v) for k, v in fields.items()})


def to_jax(obj):
    return _jax(*interop.to_fields(obj))


def port_keys(m, n_lwe: int = N_LWE, block: int = BLOCK, rank: int = 1) -> dict:
    """bench_schemes.py bench_u32_add's set-up through the port:
    Source(bytes(32)) draws the block-binary LWE secret then the GLWE
    secret; Source 0x03 / 0x04 the CBT key, then the GLWE → LWE key."""
    src, xe, xa = TSource(bytes(32)), TSource(b"\x03" * 32), TSource(b"\x04" * 32)
    sk_lwe = src.binary_block(n_lwe, block)
    sk = tenc.secret_new(m, rank, src)
    skp = tprep.glwe_secret_prepare(m, sk)
    cbt = circuit_bootstrapping_keygen(m, sk_lwe, sk, skp, BASE2K, K_CBT, DNUM_CBT, K_CBT,
                                       DNUM_CBT, K_CBT, DNUM_CBT, xe, xa, block_size=block)
    ks_lwe = glwe_to_lwe_key_encrypt_sk(m, torch.from_numpy(sk_lwe), sk, BASE2K, K_CT,
                                        dnum=DNUM_KS, source_xe=xe, source_xa=xa)
    key = tbdd.BDDKey(cbt=cbt, ks_lwe=ks_lwe, n_lwe=n_lwe, base2k=BASE2K, k_ct=K_CT,
                      dnum_ggsw=DNUM_GGSW, k_ggsw=K_GGSW)
    return dict(m=m, sk=sk, skp=skp, key=key)


def jax_prepare(m, key, ct):
    """The JAX package's fheuint_prepare of `ct`, under jax.jit (the key a
    constant of the trace)."""
    @jax.jit
    def run(data):
        return jbdd.fheuint_prepare(m, ct.replace(glwe=ct.glwe.replace(data=data)), key)

    return run(ct.glwe.data)


@pytest.fixture(scope="module")
def runs():
    """Both packages on the port's keys: the two operands encrypted from
    Source 0x05 / 0x06 in each package, `a` prepared by each, `b` by the
    port and carried over."""
    t = port_keys(t_get_module(N, 2, 28, "cpu"))
    j = dict(m=j_get_module(N, 2, 28), key=to_jax(t["key"]), skp=to_jax(t["skp"]))
    for pkg, bdd, S in (("jax", jbdd, JSource), ("torch", tbdd, TSource)):
        run = j if pkg == "jax" else t
        xe, xa = S(b"\x05" * 32), S(b"\x06" * 32)
        run["ca"] = bdd.fheuint_encrypt(run["m"], VA, WIDTH, run["skp"], BASE2K, K_CT, xe, xa)
        run["cb"] = bdd.fheuint_encrypt(run["m"], VB, WIDTH, run["skp"], BASE2K, K_CT, xe, xa)
    before = dict(LAUNCHES)
    t["pa"] = tbdd.fheuint_prepare(t["m"], t["ca"], t["key"])
    t["pb"] = tbdd.fheuint_prepare(t["m"], t["cb"], t["key"])
    assert LAUNCHES == before          # the plain versions on the CPU
    j["pa"] = jax_prepare(j["m"], j["key"], j["ca"])
    j["pb"] = to_jax(t["pb"])
    return j, t


# ---- circuits ----------------------------------------------------------------------------

@pytest.mark.parametrize("width", [4, 8, 16, 32])
@pytest.mark.parametrize("op", OPS)
def test_bdd_circuit_nodes(op, width):
    """Every output bit's nodes and root equal the JAX package's, and the
    plain evaluation agrees with it and with Python's ints."""
    have, want = tbdd.bdd_circuit(op, width), jbdd.bdd_circuit(op, width)
    assert [(c.nodes, c.root) for c in have] == [(c.nodes, c.root) for c in want]
    rng = np.random.default_rng(width)
    hi = (1 << width) - 1
    pairs = [(0, 0), (hi, 1), (1 << (width - 1), hi)] + [
        (int(a), int(b)) for a, b in zip(rng.integers(0, hi + 1, 16), rng.integers(0, hi + 1, 16))]
    for a, b in pairs:
        bits = [tbdd.eval_bdd_plain(c, a, b) for c in have]
        assert bits == [jbdd.eval_bdd_plain(c, a, b) for c in want]
        assert sum(v << i for i, v in enumerate(bits)) == plain_semantics(op, a, b, width)


@pytest.mark.parametrize("kind", ["sll", "srl", "sra"])
def test_bdd_shift_circuit(kind):
    have, want = tbdd.bdd_shift_circuit(kind, 8), jbdd.bdd_shift_circuit(kind, 8)
    assert [(c.nodes, c.root) for c in have] == [(c.nodes, c.root) for c in want]
    with pytest.raises(ValueError):
        tbdd.bdd_circuit("mul", 4)


# ---- FheUint ---------------------------------------------------------------------------

def test_fheuint_encrypt_and_decrypt(runs):
    j, t = runs
    for c in ("ca", "cb"):
        assert _eq(t[c].glwe.data, j[c].glwe.data) and t[c].width == j[c].width == WIDTH
        assert (t[c].glwe.base2k, t[c].glwe.k) == (BASE2K, K_CT)
    assert tbdd.fheuint_decrypt(t["m"], t["ca"], t["skp"]) == VA
    assert jbdd.fheuint_decrypt(j["m"], j["ca"], j["skp"]) == VA


def test_fheuint_prepare(runs):
    """All WIDTH selectors of the port's prepare equal the JAX package's
    (jitted) prepare of the same FheUint on the same key."""
    j, t = runs
    assert t["pa"].width == j["pa"].width == WIDTH
    for have, want in zip(t["pa"].bits, j["pa"].bits, strict=True):
        assert _eq(have.pmat, want.pmat)
        assert (have.base2k, have.k, have.dsize) == (want.base2k, want.k, want.dsize)
    assert tuple(t["pa"].bits[0].pmat.shape) == (DNUM_GGSW, 2, 2, K_GGSW // BASE2K, 2, N)


@pytest.mark.parametrize("op", OPS)
def test_fheuint_op(runs, op):
    """op(a, b) at width 4 on the prepared operands: equal to the JAX
    package's, and decrypting to Python's int semantics."""
    j, t = runs
    want = jbdd.fheuint_op(j["m"], op, j["pa"], j["pb"], BASE2K, K_CT)
    have = tbdd.fheuint_op(t["m"], op, t["pa"], t["pb"], BASE2K, K_CT)
    assert _eq(have.data, want.data) and (have.base2k, have.k) == (want.base2k, want.k)
    nbits = len(tbdd.bdd_circuit(op, WIDTH))
    got = tbdd.fheuint_decrypt(t["m"], tbdd.FheUint(glwe=have, width=nbits), t["skp"])
    assert got == plain_semantics(op, VA, VB, WIDTH), (op, got)


def test_fheuint_op_1w(runs):
    j, t = runs
    have = tbdd.fheuint_op_1w(t["m"], "identity", t["pb"], BASE2K, K_CT)
    assert _eq(have.data, jbdd.fheuint_op_1w(j["m"], "identity", j["pb"], BASE2K, K_CT).data)
    assert tbdd.fheuint_decrypt(t["m"], tbdd.FheUint(glwe=have, width=WIDTH), t["skp"]) == VB


def test_fheuint_prepared_encrypt_sk(runs):
    """The debug factory (constant-GGSW bits, one batched encryption) equals
    the JAX package's, and its add decrypts as the JAX package's test checks."""
    j, t = runs
    va, vb = 13, 7

    @jax.jit
    def j_factory(skp_data):
        skp = j["skp"].replace(data=skp_data)
        return [jbdd.fheuint_prepared_encrypt_sk(j["m"], v, WIDTH, skp, BASE2K, K_GGSW,
                                                 DNUM_GGSW, xe, xa) for v in (va, vb)]

    xe, xa = JSource(b"\x0d" * 32), JSource(b"\x0e" * 32)
    want = j_factory(j["skp"].data)
    xe, xa = TSource(b"\x0d" * 32), TSource(b"\x0e" * 32)
    have = [tbdd.fheuint_prepared_encrypt_sk(t["m"], v, WIDTH, t["skp"], BASE2K, K_GGSW,
                                             DNUM_GGSW, xe, xa) for v in (va, vb)]
    for h, w in zip(have, want):
        assert h.width == w.width == WIDTH
        assert all(_eq(x.pmat, y.pmat) for x, y in zip(h.bits, w.bits, strict=True))
    out = tbdd.fheuint_op(t["m"], "add", *have, BASE2K, K_CT)
    assert tbdd.fheuint_decrypt(t["m"], tbdd.FheUint(glwe=out, width=WIDTH), t["skp"]) == \
        (va + vb) % 16


# ---- selection and rotation --------------------------------------------------------------

def _glwes(run, pkg, count, seed=0x07):
    """`count` GLWEs of random 8-bit data at 2^-8 (k 8, one limb), the same
    in both packages."""
    rng = np.random.default_rng(seed)
    datas = [rng.integers(-128, 128, size=N) for _ in range(count)]
    enc, S, vz, lay, arr = ((jenc, JSource, jvz, jlay, jnp.asarray) if pkg == "jax"
                            else (tenc, TSource, tvz, tlay, torch.from_numpy))
    xe, xa = S(bytes([seed] * 32)), S(bytes([seed + 1] * 32))
    pts = [lay.GLWEPlaintext(data=vz.encode_vec_i64(BASE2K, 8, 1, arr(d)), base2k=BASE2K, k=8)
           for d in datas]
    return datas, [enc.glwe_encrypt_sk(run["m"], pt, run["skp"], BASE2K, K_CT, xe, xa)
                   for pt in pts]


def _decode(t, ct):
    return tvz.decode_vec_i64(BASE2K, 8, glwe_decrypt(t["m"], ct, t["skp"]).data).numpy()


def test_blind_select(runs):
    """options[a] for the encrypted a = 11 of 16 options, and of the first
    five (an odd level carried up): equal to the JAX package's; the first
    decrypts to entry 11."""
    j, t = runs
    _, jc = _glwes(j, "jax", 16)
    datas, tc = _glwes(t, "torch", 16)
    have = tbdd.blind_select(t["m"], t["pa"], tc)
    assert _eq(have.data, jbdd.blind_select(j["m"], j["pa"], jc).data)
    assert _eq(tbdd.blind_select(t["m"], t["pa"], tc[:5]).data,
               jbdd.blind_select(j["m"], j["pa"], jc[:5]).data)
    assert np.array_equal(_decode(t, have), datas[VA])


@pytest.mark.parametrize("sign,bit_rsh,bit_mask,bit_lsh", [(False, 0, None, 0),
                                                          (True, 1, 2, 3)])
def test_glwe_blind_rotation(runs, sign, bit_rsh, bit_mask, bit_lsh):
    """a · X^{±((11 >> rsh) mod 2^mask) << lsh}: equal to the JAX package's
    and decrypting to the rotated message."""
    j, t = runs
    _, (jc,) = _glwes(j, "jax", 1)
    (data,), (tc,) = _glwes(t, "torch", 1)
    kw = dict(sign=sign, bit_rsh=bit_rsh, bit_mask=bit_mask, bit_lsh=bit_lsh)
    have = tbdd.glwe_blind_rotation(t["m"], tc, t["pa"], **kw)
    assert _eq(have.data, jbdd.glwe_blind_rotation(j["m"], jc, j["pa"], **kw).data)
    nbits = WIDTH - bit_rsh if bit_mask is None else bit_mask
    amt = ((VA >> bit_rsh) % (1 << nbits)) << bit_lsh
    want = tvz.vec_znx_rotate(-amt if sign else amt, torch.from_numpy(data)[None]).numpy()[0]
    assert np.array_equal(_decode(t, have), want)


def test_ggsw_blind_rotation(runs):
    """Every row of a GGSW rotated by the encrypted exponent in one batched
    CMux chain: equal to the JAX package's."""
    j, t = runs
    ggsw = tenc.ggsw_encrypt_sk(t["m"], np.eye(1, N, 3, dtype=np.int64)[0], t["skp"], BASE2K,
                                K_GGSW, DNUM_GGSW, TSource(b"\x09" * 32), TSource(b"\x0a" * 32))
    want = jbdd.ggsw_blind_rotation(j["m"], to_jax(ggsw), j["pa"], bit_mask=3)
    have = tbdd.ggsw_blind_rotation(t["m"], ggsw, t["pa"], bit_mask=3)
    assert _eq(have.data, want.data) and (have.base2k, have.k) == (want.base2k, want.k)


# ---- interop ---------------------------------------------------------------------------

def test_bdd_interop(runs):
    """BDDKey (ks_glwe None), FheUint and FheUintPrepared cross both ways,
    arrays equal, and the port's op on the layouts carried back from the JAX
    package equals its op on its own."""
    j, t = runs
    key = interop.from_fields(*interop.to_fields(j["key"]), device="cpu")
    assert isinstance(key, tbdd.BDDKey) and key.ks_glwe is None
    assert (key.n_lwe, key.base2k, key.k_ct, key.dnum_ggsw, key.k_ggsw, key.extension_factor) \
        == (N_LWE, BASE2K, K_CT, DNUM_GGSW, K_GGSW, 1)
    assert _eq(key.ks_lwe.pmat, t["key"].ks_lwe.pmat)
    assert _eq(key.cbt.brk.pmats, t["key"].cbt.brk.pmats) and key.cbt.block_size == BLOCK
    ca = interop.from_fields(*interop.to_fields(j["ca"]), device="cpu")
    assert isinstance(ca, tbdd.FheUint) and ca.width == WIDTH and _eq(ca.glwe.data, j["ca"].glwe.data)
    pa = interop.from_fields(*interop.to_fields(j["pa"]), device="cpu")
    assert isinstance(pa, tbdd.FheUintPrepared) and pa.width == WIDTH
    assert all(isinstance(b, tprep.GGSWPrepared) for b in pa.bits)
    out = tbdd.fheuint_op(t["m"], "xor", pa, t["pb"], BASE2K, K_CT)
    assert _eq(out.data, tbdd.fheuint_op(t["m"], "xor", t["pa"], t["pb"], BASE2K, K_CT).data)


# ---- chip_smoke.py's fingerprint -------------------------------------------------------

@pytest.mark.slow
def test_fheuint_add_fingerprint_full_config():
    """chip_smoke.py's FHEUINT_ADD_FINGERPRINT at bench_schemes.py's u32 add
    configuration and seeds (N 1024, n_lwe 679 in blocks of 7, base2k 15),
    recomputed by the JAX package on the CPU: sum(|data| mod 65536) of the
    warm-up add 255 + 30 at width 32, which decrypts to 285 (tens of
    minutes, a few GB)."""
    import chip_smoke
    from poulpy_tpu.core.conversion import glwe_to_lwe_key_encrypt_sk as j_ks_key

    m = j_get_module(1024, 2, 28)
    src, xe, xa = JSource(bytes(32)), JSource(b"\x03" * 32), JSource(b"\x04" * 32)
    sk_lwe = src.binary_block(679, 7)
    sk = jenc.secret_new(m, 1, src)
    skp = jprep.glwe_secret_prepare(m, sk)
    cbt = jcbt.circuit_bootstrapping_keygen(m, sk_lwe, sk, skp, BASE2K, K_CBT, DNUM_CBT, K_CBT,
                                            DNUM_CBT, K_CBT, DNUM_CBT, xe, xa, block_size=7)
    ks_lwe = j_ks_key(m, jnp.asarray(sk_lwe), sk, BASE2K, K_CT, dnum=DNUM_KS, source_xe=xe,
                      source_xa=xa)
    key = jbdd.BDDKey(cbt=cbt, ks_lwe=ks_lwe, n_lwe=679, base2k=BASE2K, k_ct=K_CT,
                      dnum_ggsw=DNUM_GGSW, k_ggsw=K_GGSW)
    ca, cb = (jbdd.fheuint_encrypt(m, v, 32, skp, BASE2K, K_CT, xe, xa) for v in (255, 30))
    pa, pb = (jbdd.fheuint_prepare(m, c, key) for c in (ca, cb))
    out = jbdd.fheuint_op(m, "add", pa, pb, BASE2K, K_CT)
    assert jbdd.fheuint_decrypt(m, jbdd.FheUint(glwe=out, width=32), skp) == 285
    assert int((np.abs(np.asarray(out.data)) % 65536).sum()) == chip_smoke.FHEUINT_ADD_FINGERPRINT
