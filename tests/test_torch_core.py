"""poulpy_tpu_torch.core against poulpy_tpu.core, bit for bit, and the slice
as a whole: the same seeds through keygen → encrypt → GGSW prepare → three
chained external products → checksum → decrypt in both packages, every
intermediate compared with `np.array_equal` (tolerance 0), on both prime
bases of the slice.  Shapes follow bench.py cut to N = 128, batch 3:
base2k 17, ciphertext k 51, GGSW k 68, dnum 3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poulpy_tpu.core import conversion as jconv
from poulpy_tpu.core import decryption as jdec
from poulpy_tpu.core import encryption as jenc
from poulpy_tpu.core import external_product as jext
from poulpy_tpu.core import keyswitching as jks
from poulpy_tpu.core import layouts as jlay
from poulpy_tpu.core import prepared as jprep
from poulpy_tpu.hal import dft as jdft
from poulpy_tpu.hal import vec_znx as jvz
from poulpy_tpu.hal.module import get_module as j_get_module
from poulpy_tpu.hal.source import Source as JSource
from poulpy_tpu_torch.core import conversion as tconv
from poulpy_tpu_torch.core import decryption as tdec
from poulpy_tpu_torch.core import encryption as tenc
from poulpy_tpu_torch.core import external_product as text
from poulpy_tpu_torch.core import keyswitching as tks
from poulpy_tpu_torch.core import layouts as tlay
from poulpy_tpu_torch.core import prepared as tprep
from poulpy_tpu_torch.hal import dft as tdft
from poulpy_tpu_torch.hal import vec_znx as tvz
from poulpy_tpu_torch.hal.module import get_module as t_get_module
from poulpy_tpu_torch.hal.source import Source as TSource
from poulpy_tpu_torch.utils import interop

N, B = 128, 3
BASE2K, K_CT, K_PT, K_KEY, DNUM = 17, 51, 34, 68, 3
BITS = [28, 30]

# the JAX package's prepare steps run eagerly op by op; under jit they compile once
j_secret_prepare = jax.jit(jprep.glwe_secret_prepare, static_argnums=0)
j_ggsw_prepare = jax.jit(jprep.ggsw_prepare, static_argnums=0)
j_gglwe_prepare = jax.jit(jprep.gglwe_prepare, static_argnums=0)
# the JAX package's eager dft compiles for seconds per shape and its GLWE → LWE key
# prepares eagerly; under jit each compiles once (the key's Sources static: their
# draws happen while tracing, as in the eager call)
j_dft_apply = jax.jit(jdft.dft_apply, static_argnums=0)
j_to_lwe_key = jax.jit(jconv.glwe_to_lwe_key_encrypt_sk, static_argnums=(0, 3, 4, 5, 6, 7))


def _eq(have, want):
    have = have.cpu().numpy() if isinstance(have, torch.Tensor) else np.asarray(have)
    want = np.asarray(want)
    return have.shape == want.shape and np.array_equal(have, want)


def _pipeline(pkg: str, bits: int) -> dict:
    """bench.py's main path at test size, through one package."""
    if pkg == "jax":
        m, S, enc, ext, dec = j_get_module(N, 2, bits), JSource, jenc, jext, jdec
        lay, vz, sprep, gprep, arr = jlay, jvz, j_secret_prepare, j_ggsw_prepare, jnp.asarray
    else:
        m, S, enc, ext, dec = t_get_module(N, 2, bits, "cpu"), TSource, tenc, text, tdec
        lay, vz, arr = tlay, tvz, torch.as_tensor
        sprep, gprep = tprep.glwe_secret_prepare, tprep.ggsw_prepare
    src, xe, xa = S(bytes(32)), S(b"\x01" * 32), S(b"\x02" * 32)
    out = {"sk": enc.secret_new(m, 1, src)}
    out["skp"] = sprep(m, out["sk"])
    data = np.random.default_rng(0).integers(-(2**15), 2**15, size=(B, N), dtype=np.int64)
    pt = lay.GLWEPlaintext(data=vz.encode_vec_i64(BASE2K, K_PT, 3, arr(data)), base2k=BASE2K,
                           k=K_PT)
    out["pt"] = pt
    out["ct"] = enc.glwe_encrypt_sk(m, pt, out["skp"], BASE2K, K_CT, xe, xa, batch_shape=(B,))
    ptg = np.zeros(N, dtype=np.int64)
    ptg[1] = 1
    out["ggsw"] = enc.ggsw_encrypt_sk(m, arr(ptg), out["skp"], BASE2K, K_KEY, dnum=DNUM,
                                      source_xe=xe, source_xa=xa)
    out["ggswp"] = gprep(m, out["ggsw"])
    prods = [out["ct"]]
    for _ in range(3):
        prods.append(ext.glwe_external_product(m, prods[-1], out["ggswp"]))
    out["prods"] = prods[1:]
    last = prods[-1].data
    out["checksum"] = int((last.abs() % 65536).sum()) if pkg == "torch" else \
        int(jnp.sum(jnp.abs(last) % 65536))
    out["dec"] = dec.glwe_decrypt(m, prods[-1], out["skp"])
    out["decoded"] = vz.decode_vec_i64(BASE2K, K_PT, out["dec"].data)
    out["data"] = data
    return out


@pytest.fixture(scope="module", params=BITS)
def slice_runs(request):
    return _pipeline("jax", request.param), _pipeline("torch", request.param)


def test_secret_new_and_prepare(slice_runs):
    j, t = slice_runs
    assert _eq(t["sk"].data, j["sk"].data) and t["sk"].dist == j["sk"].dist
    assert _eq(t["skp"].data, j["skp"].data)


def test_glwe_encrypt_sk(slice_runs):
    j, t = slice_runs
    assert _eq(t["pt"].data, j["pt"].data)
    assert _eq(t["ct"].data, j["ct"].data)
    assert (t["ct"].base2k, t["ct"].k) == (j["ct"].base2k, j["ct"].k)


def test_ggsw_encrypt_sk_and_prepare(slice_runs):
    j, t = slice_runs
    assert _eq(t["ggsw"].data, j["ggsw"].data)
    assert _eq(t["ggswp"].pmat, j["ggswp"].pmat)
    assert t["ggswp"].pmat.dtype == torch.int32


def test_glwe_external_product_chain(slice_runs):
    j, t = slice_runs
    for have, want in zip(t["prods"], j["prods"]):
        assert _eq(have.data, want.data)


def test_slice_checksum_and_decrypt(slice_runs):
    """The whole slice: equal checksums and plaintexts, and the plaintext is
    the data times X^3 (three products by the GGSW of X)."""
    j, t = slice_runs
    assert t["checksum"] == j["checksum"]
    assert _eq(t["dec"].data, j["dec"].data)
    assert _eq(t["decoded"], j["decoded"])
    rot = np.roll(t["data"], 3, axis=-1)
    rot[:, :3] *= -1
    assert np.array_equal(t["decoded"].numpy(), rot)


def _keys(pkg, bits, dsize, bit):
    """A secret, a GGSW of `bit` with the given dsize, and two ciphertexts."""
    if pkg == "jax":
        m, S, enc, sprep, gprep, arr = (j_get_module(N, 2, bits), JSource, jenc,
                                        j_secret_prepare, j_ggsw_prepare, jnp.asarray)
    else:
        m, S, enc, arr = t_get_module(N, 2, bits, "cpu"), TSource, tenc, torch.as_tensor
        sprep, gprep = tprep.glwe_secret_prepare, tprep.ggsw_prepare
    src, xe, xa = S(b"\x05" * 32), S(b"\x06" * 32), S(b"\x07" * 32)
    skp = sprep(m, enc.secret_new(m, 1, src))
    ptg = np.zeros(N, dtype=np.int64)
    ptg[0] = bit
    dnum = 2 if dsize == 2 else DNUM
    g = gprep(m, enc.ggsw_encrypt_sk(m, arr(ptg), skp, BASE2K, K_KEY, dnum=dnum,
                                     source_xe=xe, source_xa=xa, dsize=dsize))
    cts = [enc.glwe_encrypt_sk(m, None, skp, BASE2K, K_CT, xe, xa, batch_shape=(2,))
           for _ in range(2)]
    return m, skp, g, cts


@pytest.mark.parametrize("bits", BITS)
def test_glwe_external_product_dsize2(bits):
    jm, _, jg, jcts = _keys("jax", bits, 2, 1)
    tm, _, tg, tcts = _keys("torch", bits, 2, 1)
    assert _eq(tg.pmat, jg.pmat) and tg.dsize == jg.dsize == 2
    want = jext.glwe_external_product(jm, jcts[0], jg)
    have = text.glwe_external_product(tm, tcts[0], tg)
    assert _eq(have.data, want.data)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("bit", [0, 1])
def test_glwe_cmux(bits, bit):
    jm, jskp, jg, jcts = _keys("jax", bits, 1, bit)
    tm, tskp, tg, tcts = _keys("torch", bits, 1, bit)
    want = jext.glwe_cmux(jm, jg, jcts[0], jcts[1])
    have = text.glwe_cmux(tm, tg, tcts[0], tcts[1])
    assert _eq(have.data, want.data)
    assert _eq(tdec.glwe_decrypt(tm, have, tskp).data, jdec.glwe_decrypt(jm, want, jskp).data)


@pytest.mark.parametrize("bits", BITS)
def test_interop_jax_keys_drive_the_port(bits):
    """Keys and ciphertexts made by the JAX package, carried into the port by
    `interop`, give the JAX package's product; the port's result carried
    back decrypts under JAX to the same plaintext."""
    jm, jskp, jg, jcts = _keys("jax", bits, 1, 1)
    tm = t_get_module(N, 2, bits, "cpu")
    tg = interop.from_fields(*interop.to_fields(jg), device="cpu")
    tct = interop.from_fields(*interop.to_fields(jcts[0]), device="cpu")
    tskp = interop.from_fields(*interop.to_fields(jskp), device="cpu")
    assert isinstance(tg, tprep.GGSWPrepared) and tg.dsize == jg.dsize
    have = text.glwe_external_product(tm, tct, tg)
    want = jext.glwe_external_product(jm, jcts[0], jg)
    assert _eq(have.data, want.data)
    assert _eq(tdec.glwe_decrypt(tm, have, tskp).data, jdec.glwe_decrypt(jm, want, jskp).data)
    name, fields = interop.to_fields(have)
    back = getattr(jlay, name)(**{k: jnp.asarray(v) if k == "data" else v
                                  for k, v in fields.items()})
    assert _eq(jdec.glwe_decrypt(jm, back, jskp).data, jdec.glwe_decrypt(jm, want, jskp).data)
    for obj in (jskp, jg, jcts[0]):
        name, fields = interop.to_fields(interop.from_fields(*interop.to_fields(obj), device="cpu"))
        assert name == type(obj).__name__


# ---- key switching, LWE and the GLWE → LWE bridge (the gate path's core) -----------

N_LWE = 40


def _ks_run(pkg: str, bits: int, dsize: int) -> dict:
    """Two secrets, a switching key sk1 → sk2, a batch of GLWEs under sk1 and
    their keyswitch; an LWE secret, its GLWE → LWE key, LWE encryptions."""
    if pkg == "jax":
        m, S, enc, ks, conv, dec = j_get_module(N, 2, bits), JSource, jenc, jks, jconv, jdec
        lay, vz, dft_apply, to_lwe_key = jlay, jvz, j_dft_apply, j_to_lwe_key
        sprep, gprep, arr = j_secret_prepare, j_gglwe_prepare, jnp.asarray
    else:
        m, S, enc, ks, conv, dec = t_get_module(N, 2, bits, "cpu"), TSource, tenc, tks, tconv, tdec
        lay, vz, dft_apply, to_lwe_key = tlay, tvz, tdft.dft_apply, tconv.glwe_to_lwe_key_encrypt_sk
        sprep, gprep, arr = tprep.glwe_secret_prepare, tprep.gglwe_prepare, torch.as_tensor
    src = S(b"\x09" * 32)
    xe, xa = src.branch()[1], src.branch()[1]
    out = {"sk1": enc.secret_new(m, 1, src), "sk2": enc.secret_new(m, 1, src)}
    sk2p = sprep(m, out["sk2"])
    dnum = 3 if dsize == 1 else 2
    out["ksk"] = enc.glwe_switching_key_encrypt_sk(m, out["sk1"], sk2p, BASE2K, K_KEY, dnum,
                                                   xe, xa, dsize=dsize)
    out["kskp"] = gprep(m, out["ksk"])
    pt2 = np.random.default_rng(3).integers(-1, 2, (2, N))
    out["gglwe"] = enc.gglwe_encrypt_sk(m, arr(pt2), sk2p, BASE2K, K_CT, 2, xe, xa)
    data = np.random.default_rng(4).integers(-(2**15), 2**15, size=(2, N), dtype=np.int64)
    pt = lay.GLWEPlaintext(data=vz.encode_vec_i64(BASE2K, K_PT, 3, arr(data)), base2k=BASE2K,
                           k=K_PT)
    out["ct"] = enc.glwe_encrypt_sk(m, pt, sprep(m, out["sk1"]), BASE2K, K_CT, xe, xa,
                                    batch_shape=(2,))
    a_dft = dft_apply(m, out["ct"].data[..., 1:, :, :])
    out["prod_dft"] = ks.gglwe_product_dft(m, a_dft, out["kskp"])
    out["ks"] = ks.glwe_keyswitch(m, out["ct"], out["kskp"])
    out["ks_13"] = ks.glwe_keyswitch(m, ks.glwe_normalize(m, out["ct"], 13, K_CT),
                                     out["kskp"], 13, 39)
    out["dec"] = vz.decode_vec_i64(BASE2K, K_PT, dec.glwe_decrypt(m, out["ks"], sk2p).data)
    out["data"] = data
    # LWE: encryption, decryption, the GLWE → LWE key and sample extraction
    sk_lwe = src.binary_prob((N_LWE,))
    out["sk_lwe"] = sk_lwe
    out["sk_emb"] = conv.lwe_secret_as_glwe(m, arr(sk_lwe))
    out["to_lwe"] = to_lwe_key(m, arr(sk_lwe), out["sk2"], BASE2K, K_KEY, dnum, xe, xa)
    lwe_pt = np.zeros((3, 2, 1), dtype=np.int64)
    lwe_pt[:, 0, 0] = [-3 << 12, 5 << 12, 0]
    out["lwe"] = enc.lwe_encrypt_sk(None, arr(lwe_pt), arr(sk_lwe), BASE2K, 34, xe, xa)
    out["lwe_dec"] = dec.lwe_decrypt(out["lwe"], arr(sk_lwe))
    to_emb = ks.glwe_keyswitch(m, out["ks"], out["to_lwe"], BASE2K, 34)
    out["extract"] = conv.lwe_sample_extract(to_emb, N_LWE, 34)
    out["extract_dec"] = dec.lwe_decrypt(out["extract"], arr(sk_lwe))
    return out


@pytest.fixture(scope="module", params=[(b, d) for b in BITS for d in (1, 2)],
                ids=lambda p: f"{p[0]}bit-dsize{p[1]}")
def ks_runs(request):
    bits, dsize = request.param
    return _ks_run("jax", bits, dsize), _ks_run("torch", bits, dsize)


def test_gglwe_and_switching_key_encrypt_sk(ks_runs):
    j, t = ks_runs
    for name in ("sk1", "sk2", "ksk", "gglwe"):
        assert _eq(t[name].data, j[name].data), name
    assert (t["ksk"].dnum, t["ksk"].dsize, t["ksk"].rank_in, t["ksk"].rank_out) == \
        (j["ksk"].dnum, j["ksk"].dsize, j["ksk"].rank_in, j["ksk"].rank_out)
    assert _eq(t["kskp"].pmat, j["kskp"].pmat) and t["kskp"].dsize == j["kskp"].dsize


def test_glwe_keyswitch(ks_runs):
    """gglwe_product_dft, the keyswitch (with a base change too) and its
    decryption under the new secret."""
    j, t = ks_runs
    assert _eq(t["ct"].data, j["ct"].data)
    assert _eq(t["prod_dft"], j["prod_dft"])
    assert _eq(t["ks"].data, j["ks"].data) and (t["ks"].base2k, t["ks"].k) == (17, K_CT)
    assert _eq(t["ks_13"].data, j["ks_13"].data)
    assert _eq(t["dec"], j["dec"])
    assert np.abs(t["dec"].numpy() - t["data"]).max() <= 2 ** 7   # dsize 2 noise: tens


def test_lwe_encrypt_and_decrypt(ks_runs):
    j, t = ks_runs
    assert _eq(t["lwe"].data, j["lwe"].data)
    assert _eq(t["lwe_dec"], j["lwe_dec"])


def test_glwe_to_lwe_key_and_sample_extract(ks_runs):
    j, t = ks_runs
    assert _eq(t["sk_emb"].data, j["sk_emb"].data)
    assert _eq(t["to_lwe"].pmat, j["to_lwe"].pmat)
    assert _eq(t["extract"].data, j["extract"].data) and t["extract"].n_lwe == N_LWE
    assert _eq(t["extract_dec"], j["extract_dec"])


# ---- secret distributions and public-key encryption --------------------------------------

@pytest.mark.parametrize("dist,kw", [("binary_prob", {}), ("binary_prob", {"prob": 0.2}),
                                     ("binary_block", {"block_size": 8}),
                                     ("binary_block", {"block_size": 16})])
def test_secret_new_binary(dist, kw):
    """The binary distributions draw what the JAX package draws, rank 2 (the
    block one a block at a time per column); an unknown name raises
    ValueError in both."""
    have = tenc.secret_new(t_get_module(N, 2, 28, "cpu"), 2, TSource(b"\x08" * 32), dist, **kw)
    want = jenc.secret_new(j_get_module(N, 2, 28), 2, JSource(b"\x08" * 32), dist, **kw)
    assert _eq(have.data, want.data) and have.dist == want.dist == dist
    assert set(np.unique(have.data.numpy())) <= {0, 1}
    if dist == "binary_block":
        assert (have.data.numpy().reshape(2, -1, kw["block_size"]).sum(-1) <= 1).all()
    with pytest.raises(ValueError):
        tenc.secret_new(t_get_module(N, 2, 28, "cpu"), 1, TSource(b"\x08" * 32), "gaussian")


j_pk_prepare = jax.jit(jenc.glwe_public_key_prepare, static_argnums=0)
j_encrypt_pk = jax.jit(jenc.glwe_encrypt_pk, static_argnames=(
    "module", "pk_base2k", "pk_k", "source_xu", "source_xe", "u_dist"))


def _pk_run(pkg: str, bits: int, u_dist: str) -> dict:
    """A public key of k K_KEY, its DFT and encryptions of a message and of
    zero through it (u from Source 0x0b, as tests/test_core.py draws it)."""
    if pkg == "jax":
        m, S, enc, lay, vz, sprep, arr = (j_get_module(N, 2, bits), JSource, jenc, jlay, jvz,
                                          j_secret_prepare, jnp.asarray)
        pk_prepare, encrypt_pk = j_pk_prepare, j_encrypt_pk
    else:
        m, S, enc, lay, vz, arr = t_get_module(N, 2, bits, "cpu"), TSource, tenc, tlay, tvz, \
            torch.as_tensor
        sprep, pk_prepare, encrypt_pk = (tprep.glwe_secret_prepare, tenc.glwe_public_key_prepare,
                                         tenc.glwe_encrypt_pk)
    src, xe, xa, xu = S(b"\x08" * 32), S(b"\x09" * 32), S(b"\x0a" * 32), S(b"\x0b" * 32)
    out = {"skp": sprep(m, enc.secret_new(m, 1, src))}
    out["pk"] = enc.glwe_public_key_generate(m, out["skp"], BASE2K, K_KEY, xe, xa)
    out["pkp"] = pk_prepare(m, out["pk"])
    out["data"] = np.random.default_rng(4).integers(-(2**15), 2**15, size=N, dtype=np.int64)
    pt = lay.GLWEPlaintext(data=vz.encode_vec_i64(BASE2K, K_PT, 2, arr(out["data"])),
                           base2k=BASE2K, k=K_PT)
    out["ct"] = encrypt_pk(m, pt, out["pkp"], BASE2K, K_KEY, xu, xe, u_dist=u_dist)
    out["zero"] = encrypt_pk(m, None, out["pkp"], BASE2K, K_KEY, xu, xe, u_dist=u_dist)
    out["m"] = m
    return out


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("u_dist", ["ternary_prob", "binary_prob"])
def test_public_key_encryption(bits, u_dist):
    """glwe_public_key_generate / _prepare / glwe_encrypt_pk equal the JAX
    package's (the plaintext of 2 limbs padded to the key's 4), and the
    ciphertext decrypts to the message within 2 (tests/test_core.py's
    bound); an unknown u_dist raises ValueError."""
    j, t = _pk_run("jax", bits, u_dist), _pk_run("torch", bits, u_dist)
    for name in ("pk", "ct", "zero"):
        assert _eq(t[name].data, j[name].data), name
        assert (t[name].base2k, t[name].k) == (j[name].base2k, j[name].k) == (BASE2K, K_KEY)
    assert _eq(t["pkp"], j["pkp"])
    got = tvz.decode_vec_i64(BASE2K, K_PT, tdec.glwe_decrypt(t["m"], t["ct"], t["skp"]).data)
    assert np.abs(got.numpy() - t["data"]).max() <= 2
    with pytest.raises(ValueError):
        tenc.glwe_encrypt_pk(t["m"], None, t["pkp"], BASE2K, K_KEY, TSource(b"\x0b" * 32),
                             TSource(b"\x09" * 32), u_dist="gaussian")
