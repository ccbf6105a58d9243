"""poulpy_tpu_torch.core.compressed and the compressed blind-rotation key
against poulpy_tpu's, bit for bit (tolerance 0).

The cases of tests/test_compressed.py at its configuration (N 64 on
get_module(64, 2), base2k 17, ciphertexts k 51, keys k 68 dnum 3): the same
seeds go through both packages, and every compressed object (body and
seed), every decompressed and prepared key, and every blob equals the JAX
package's; in the port each decompressed key also equals the direct
encryption with the branched child stream.  The JAX package's encryptions
and preparations run under `jax.jit`, their `Source` arguments static (the
draws happen once, while tracing, as in the eager call).  The `slow` test
recomputes chip_smoke.py's COMPRESSED_BRK_BLOB_DIGEST and
COMPRESSED_GATE_FINGERPRINT with the JAX package at full size.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poulpy_tpu.binfhe import blind_rotation as jbr
from poulpy_tpu.core import compressed as jcomp
from poulpy_tpu.core import encryption as jenc
from poulpy_tpu.core import prepared as jprep
from poulpy_tpu.core.layouts import GLWEPlaintext as JPlaintext
from poulpy_tpu.hal import vec_znx as jvz
from poulpy_tpu.hal.module import get_module as j_get_module
from poulpy_tpu.hal.source import Source as JSource
from poulpy_tpu.utils import serialization as jser
from poulpy_tpu_torch.binfhe import blind_rotation as tbr
from poulpy_tpu_torch.core import compressed as tcomp
from poulpy_tpu_torch.core import decryption as tdec
from poulpy_tpu_torch.core import encryption as tenc
from poulpy_tpu_torch.core import prepared as tprep
from poulpy_tpu_torch.core.keyswitching import lwe_keyswitch, lwe_switching_key_encrypt_sk
from poulpy_tpu_torch.core.layouts import GLWEPlaintext as TPlaintext
from poulpy_tpu_torch.hal import dft as tdft
from poulpy_tpu_torch.hal import vec_znx as tvz
from poulpy_tpu_torch.hal.module import get_module as t_get_module
from poulpy_tpu_torch.hal.source import Source as TSource
from poulpy_tpu_torch.utils import interop
from poulpy_tpu_torch.utils import serialization as tser

N, BASE2K, K_CT, K_KEY, DNUM = 64, 17, 51, 68, 3
XE, XA = b"\x01" * 32, b"\x02" * 32

j_prepare = jax.jit(jprep.glwe_secret_prepare, static_argnums=0)
# (module, pt / secrets..., base2k, k, [dnum,] xe, xa): the module, the
# parameters and the sources static
j_glwe_c = jax.jit(jcomp.glwe_encrypt_sk_compressed, static_argnums=(0, 3, 4, 5, 6))
j_gglwe_c = jax.jit(jcomp.gglwe_encrypt_sk_compressed, static_argnums=(0, 3, 4, 5, 6, 7))
j_ggsw_c = jax.jit(jcomp.ggsw_encrypt_sk_compressed, static_argnums=(0, 3, 4, 5, 6, 7))
j_lwe_c = jax.jit(jcomp.lwe_encrypt_sk_compressed, static_argnums=(0, 3, 4, 5, 6))
j_brk_c = jax.jit(jbr.blind_rotation_key_encrypt_sk_compressed,
                  static_argnums=(0, 3, 4, 5, 6, 7))
j_brk_decompress = jax.jit(jbr.blind_rotation_key_decompress, static_argnums=0)
j_auto_c = jax.jit(lambda m, p, sk, *a: jcomp.glwe_automorphism_key_encrypt_sk_compressed(
    m, p, sk, *a)[0], static_argnums=(0, 1, 3, 4, 5, 6, 7))
j_tensor_c = jax.jit(jcomp.glwe_tensor_key_encrypt_sk_compressed,
                     static_argnums=(0, 3, 4, 5, 6, 7))
j_to_ggsw_c = jax.jit(jcomp.gglwe_to_ggsw_key_encrypt_sk_compressed,
                      static_argnums=(0, 3, 4, 5, 6, 7))
j_to_ggsw_decompress = jax.jit(jcomp.gglwe_to_ggsw_key_decompress, static_argnums=0)
j_lwe_ksk_c = jax.jit(jcomp.lwe_switching_key_encrypt_sk_compressed,
                      static_argnums=(0, 3, 4, 5, 6, 7))
j_lwe_ksk_decompress = jax.jit(jcomp.lwe_switching_key_decompress, static_argnums=0)


def _eq(have, want):
    have = have.cpu().numpy() if isinstance(have, torch.Tensor) else np.asarray(have)
    want = np.asarray(want)
    return have.shape == want.shape and np.array_equal(have, want)


def _same_compressed(t, j):
    """Equal body, seed and parameters (the dataclass fields in order)."""
    assert type(t).__name__ == type(j).__name__
    fields = [f for f in type(t).__dataclass_fields__ if f != "body"]
    assert [getattr(t, f) for f in fields] == [getattr(j, f) for f in fields]
    assert isinstance(t.seed, bytes) and _eq(t.body, j.body)


@pytest.fixture(scope="module")
def mods():
    """(JAX module, port module), each with the rank-1 secret of Source 0 and
    its preparation."""
    jm, tm = j_get_module(N, 2), t_get_module(N, 2, device="cpu")
    jsk = jenc.secret_new(jm, 1, JSource(bytes(32)))
    tsk = tenc.secret_new(tm, 1, TSource(bytes(32)))
    return dict(jm=jm, tm=tm, jsk=jsk, tsk=tsk, jskp=j_prepare(jm, jsk),
                tskp=tprep.glwe_secret_prepare(tm, tsk))


@pytest.fixture(scope="module")
def rank2(mods):
    """The rank-2 secret of Source 0x07, and two ternary LWE secrets of
    Source 0x0c (24 and 32 coefficients), in both packages."""
    jm, tm = mods["jm"], mods["tm"]
    jsk = jenc.secret_new(jm, 2, JSource(b"\x07" * 32))
    tsk = tenc.secret_new(tm, 2, TSource(b"\x07" * 32))
    src = TSource(b"\x0c" * 32)
    sk1, sk2 = src.ternary_prob((24,)), src.ternary_prob((32,))
    jskp = j_prepare(jm, jsk)
    jm4 = j_get_module(N, 4)
    return dict(jsk=jsk, tsk=tsk, jskp=jskp, tskp=tprep.glwe_secret_prepare(tm, tsk),
                sk1=sk1, sk2=sk2, jm4=jm4, tm4=t_get_module(N, 4, device="cpu"),
                # the JAX package's compressed GGLWE → GGSW and LWE switching keys,
                # each made once for the tests that hold the port against them
                j_to_ggsw=j_to_ggsw_c(jm, jsk, jskp, BASE2K, K_KEY, DNUM, JSource(XE),
                                      JSource(XA)),
                j_lwe_ksk=j_lwe_ksk_c(jm4, jnp.asarray(sk1), jnp.asarray(sk2), BASE2K, K_KEY,
                                      DNUM, JSource(XE), JSource(XA)))


def _child():
    return TSource(XA).branch()[1]


def test_glwe_compressed_bit_exact(mods):
    data = np.random.default_rng(11).integers(-(2**15), 2**15, size=N, dtype=np.int64)
    jpt = JPlaintext(data=jvz.encode_vec_i64(BASE2K, 34, 3, jnp.asarray(data)), base2k=BASE2K,
                     k=34)
    tpt = TPlaintext(data=tvz.encode_vec_i64(BASE2K, 34, 3, torch.from_numpy(data)),
                     base2k=BASE2K, k=34)
    j = j_glwe_c(mods["jm"], jpt, mods["jskp"], BASE2K, K_CT, JSource(XE), JSource(XA))
    t = tcomp.glwe_encrypt_sk_compressed(mods["tm"], tpt, mods["tskp"], BASE2K, K_CT,
                                         TSource(XE), TSource(XA))
    _same_compressed(t, j)
    have = tcomp.glwe_decompress(mods["tm"], t)
    assert _eq(have.data, jcomp.glwe_decompress(mods["jm"], j).data)
    direct = tenc.glwe_encrypt_sk(mods["tm"], tpt, mods["tskp"], BASE2K, K_CT, TSource(XE),
                                  _child())
    assert _eq(have.data, direct.data) and (have.base2k, have.k) == (BASE2K, K_CT)


def test_gglwe_compressed_bit_exact(mods):
    scalar = np.random.default_rng(12).integers(-2, 3, size=(1, N), dtype=np.int64)
    j = j_gglwe_c(mods["jm"], jnp.asarray(scalar), mods["jskp"], BASE2K, K_KEY, DNUM,
                  JSource(XE), JSource(XA))
    t = tcomp.gglwe_encrypt_sk_compressed(mods["tm"], torch.from_numpy(scalar), mods["tskp"],
                                          BASE2K, K_KEY, DNUM, TSource(XE), TSource(XA))
    _same_compressed(t, j)
    have = tcomp.gglwe_decompress(mods["tm"], t)
    assert _eq(have.data, jcomp.gglwe_decompress(mods["jm"], j).data)
    direct = tenc.gglwe_encrypt_sk(mods["tm"], torch.from_numpy(scalar), mods["tskp"], BASE2K,
                                   K_KEY, DNUM, TSource(XE), _child())
    assert _eq(have.data, direct.data)


@pytest.mark.parametrize("batch", [(), (3,)], ids=["single", "batch3"])
def test_ggsw_compressed_bit_exact(mods, batch):
    """One GGSW, and a batch of three (the mask blocks batch-major within
    each plaintext column)."""
    scalar = np.random.default_rng(13).integers(-2, 3, size=batch + (N,), dtype=np.int64)
    j = j_ggsw_c(mods["jm"], jnp.asarray(scalar), mods["jskp"], BASE2K, K_KEY, DNUM,
                 JSource(XE), JSource(XA))
    t = tcomp.ggsw_encrypt_sk_compressed(mods["tm"], torch.from_numpy(scalar), mods["tskp"],
                                         BASE2K, K_KEY, DNUM, TSource(XE), TSource(XA))
    _same_compressed(t, j)
    have = tcomp.ggsw_decompress(mods["tm"], t)
    assert _eq(have.data, jcomp.ggsw_decompress(mods["jm"], j).data)
    direct = tenc.ggsw_encrypt_sk(mods["tm"], torch.from_numpy(scalar), mods["tskp"], BASE2K,
                                  K_KEY, DNUM, TSource(XE), _child())
    assert _eq(have.data, direct.data) and have.dsize == direct.dsize


@pytest.fixture(scope="module")
def brk(mods):
    """An 8-coefficient binary LWE secret and the JAX package's compressed
    BRK of it."""
    sk_lwe = np.random.default_rng(14).integers(0, 2, size=8, dtype=np.int64)
    return sk_lwe, j_brk_c(mods["jm"], jnp.asarray(sk_lwe), mods["jskp"], BASE2K, K_KEY, DNUM,
                           JSource(XE), JSource(XA))


def test_brk_compressed_bit_exact(mods, brk):
    sk_lwe, j = brk
    t = tbr.blind_rotation_key_encrypt_sk_compressed(mods["tm"], torch.from_numpy(sk_lwe),
                                                     mods["tskp"], BASE2K, K_KEY, DNUM,
                                                     TSource(XE), TSource(XA))
    assert t.dist == j.dist
    _same_compressed(t.ggsw, j.ggsw)
    have = tbr.blind_rotation_key_decompress(mods["tm"], t)
    want = j_brk_decompress(mods["jm"], j)
    assert _eq(have.pmats, want.pmats)
    assert (have.base2k, have.k, have.dsize, have.dist) == (want.base2k, want.k, want.dsize,
                                                            want.dist)
    direct = tbr.blind_rotation_key_encrypt_sk(mods["tm"], torch.from_numpy(sk_lwe), mods["tskp"],
                                               BASE2K, K_KEY, DNUM, TSource(XE), _child())
    assert _eq(have.pmats, direct.pmats)


def test_lwe_compressed_bit_exact():
    sk_lwe = np.random.default_rng(15).integers(0, 2, 16, dtype=np.int64)
    pt = np.zeros((3, 1), dtype=np.int64)
    pt[0, 0] = 1234
    j = j_lwe_c(None, jnp.asarray(pt), jnp.asarray(sk_lwe), BASE2K, K_CT, JSource(XE),
                JSource(XA))
    t = tcomp.lwe_encrypt_sk_compressed(None, torch.from_numpy(pt), torch.from_numpy(sk_lwe),
                                        BASE2K, K_CT, TSource(XE), TSource(XA))
    _same_compressed(t, j)
    have = tcomp.lwe_decompress(t)
    assert _eq(have.data, jcomp.lwe_decompress(j).data)
    direct = tenc.lwe_encrypt_sk(None, torch.from_numpy(pt), torch.from_numpy(sk_lwe), BASE2K,
                                 K_CT, TSource(XE), _child())
    assert _eq(have.data, direct.data)


def test_automorphism_key_compressed_bit_exact(mods):
    j = j_auto_c(mods["jm"], 5, mods["jsk"], BASE2K, K_KEY, DNUM, JSource(XE), JSource(XA))
    t, p = tcomp.glwe_automorphism_key_encrypt_sk_compressed(
        mods["tm"], 5, mods["tsk"], BASE2K, K_KEY, DNUM, TSource(XE), TSource(XA))
    assert p == 5
    _same_compressed(t, j)
    have = tcomp.gglwe_decompress(mods["tm"], t)
    assert _eq(have.data, jcomp.gglwe_decompress(mods["jm"], j).data)
    direct, p2 = tenc.glwe_automorphism_key_encrypt_sk(mods["tm"], 5, mods["tsk"], BASE2K, K_KEY,
                                                       DNUM, TSource(XE), _child())
    assert p2 == 5 and _eq(have.data, direct.data)


def test_tensor_key_compressed_roundtrip(mods, rank2):
    """One seeded GGLWE per pair i ≤ j, each on its own branch: equal to the
    JAX package's, decompressed too, and three distinct digests."""
    j = j_tensor_c(mods["jm"], rank2["jsk"], rank2["jskp"], BASE2K, K_KEY, DNUM, JSource(XE),
                   JSource(XA))
    t = tcomp.glwe_tensor_key_encrypt_sk_compressed(mods["tm"], rank2["tsk"], rank2["tskp"],
                                                    BASE2K, K_KEY, DNUM, TSource(XE),
                                                    TSource(XA))
    assert set(t) == set(j) == {(0, 0), (0, 1), (1, 1)}
    have = tcomp.glwe_tensor_key_decompress(mods["tm"], t)
    want = jcomp.glwe_tensor_key_decompress(mods["jm"], j)
    for ij in t:
        _same_compressed(t[ij], j[ij])
        assert _eq(have[ij].data, want[ij].data)
    digests = {ij: tser.digest_u64(k.data) for ij, k in have.items()}
    assert digests == {ij: jser.digest_u64(k.data) for ij, k in want.items()}
    assert len(set(digests.values())) == 3


def test_gglwe_to_ggsw_key_compressed_bit_exact(mods, rank2):
    """One seeded GGLWE per rank element; each decompresses to the direct
    keygen replaying the same branch sequence; the prepared list equals the
    JAX package's."""
    tm, j = mods["tm"], rank2["j_to_ggsw"]
    t = tcomp.gglwe_to_ggsw_key_encrypt_sk_compressed(tm, rank2["tsk"], rank2["tskp"], BASE2K,
                                                      K_KEY, DNUM, TSource(XE), TSource(XA))
    assert len(t) == len(j) == 2
    xa, xe = TSource(XA), TSource(XE)
    for jj, (tc, jc) in enumerate(zip(t, j)):
        _same_compressed(tc, jc)
        got = tcomp.gglwe_decompress(tm, tc)
        assert _eq(got.data, jcomp.gglwe_decompress(mods["jm"], jc).data)
        sj_p = tdft.svp_prepare(tm, rank2["tsk"].data[jj])
        pt = torch.stack([tcomp._secret_product(tm, rank2["tsk"], i, sj_p) for i in range(2)])
        direct = tenc.gglwe_encrypt_sk(tm, pt, rank2["tskp"], BASE2K, K_KEY, DNUM, xe,
                                       xa.branch()[1])
        assert _eq(got.data, direct.data), jj
    have = tcomp.gglwe_to_ggsw_key_decompress(tm, t)
    want = j_to_ggsw_decompress(mods["jm"], j)
    assert all(_eq(h.pmat, w.pmat) for h, w in zip(have, want))


def test_lwe_switching_key_compressed_bit_exact(rank2):
    """The seeded LWE switching key on get_module(64, 4): equal to the JAX
    package's, its prepared decompression to the direct keygen on the
    replayed branch, and it drives an LWE → LWE keyswitch."""
    jm, tm, j = rank2["jm4"], rank2["tm4"], rank2["j_lwe_ksk"]
    sk1, sk2 = rank2["sk1"], rank2["sk2"]
    t = tcomp.lwe_switching_key_encrypt_sk_compressed(tm, torch.from_numpy(sk1),
                                                      torch.from_numpy(sk2), BASE2K, K_KEY,
                                                      DNUM, TSource(XE), TSource(XA))
    _same_compressed(t, j)
    ksk = tcomp.lwe_switching_key_decompress(tm, t)
    assert _eq(ksk.pmat, j_lwe_ksk_decompress(jm, j).pmat)
    direct = lwe_switching_key_encrypt_sk(tm, torch.from_numpy(sk1), torch.from_numpy(sk2),
                                          BASE2K, K_KEY, DNUM, TSource(XE), _child())
    assert _eq(ksk.pmat, direct.pmat)
    pt = tvz.encode_vec_i64(BASE2K, 17, 3, torch.tensor([137]))
    ct = tenc.lwe_encrypt_sk(None, pt, torch.from_numpy(sk1), BASE2K, K_CT, TSource(b"\x03" * 32),
                             TSource(b"\x04" * 32))
    out = tdec.lwe_decrypt(lwe_keyswitch(tm, ct, ksk, 32), torch.from_numpy(sk2))
    assert abs(int(tvz.decode_vec_i64(BASE2K, 17, out[..., None])[0]) - 137) <= 1


def test_compressed_key_bundle_serialization(mods, rank2):
    """Every compressed key of a CBT / BDD bundle survives the wire: the
    port's blobs equal the JAX package's byte for byte, and each reads back
    to the same decompressed key."""
    tm, tm4 = mods["tm"], rank2["tm4"]
    args = (BASE2K, K_KEY, DNUM)
    tkeys = [*tcomp.gglwe_to_ggsw_key_encrypt_sk_compressed(tm, rank2["tsk"], rank2["tskp"],
                                                            *args, TSource(XE), TSource(XA)),
             tcomp.lwe_switching_key_encrypt_sk_compressed(
                 tm4, torch.from_numpy(rank2["sk1"]), torch.from_numpy(rank2["sk2"]), *args,
                 TSource(XE), TSource(XA))]
    jkeys = [*rank2["j_to_ggsw"], rank2["j_lwe_ksk"]]
    for t, j, m in zip(tkeys, jkeys, (tm, tm, tm4)):
        blob = tser.serialize_layout(t)
        assert blob == jser.serialize_layout(j)
        back = tser.deserialize_layout(blob, tcomp.GGLWECompressed, device="cpu")
        assert back.seed == t.seed
        assert _eq(tcomp.gglwe_decompress(m, back).data, tcomp.gglwe_decompress(m, t).data)


def test_compressed_layouts_through_interop(mods, brk):
    """JAX compressed layouts carried into the port (seeds as bytes, bodies
    as tensors) decompress to the JAX package's keys, and back."""
    sk_lwe, j = brk
    name, fields = interop.to_fields(j)
    t = interop.from_fields(name, fields, device="cpu")
    assert isinstance(t, tbr.BlindRotationKeyCompressed)
    assert isinstance(t.ggsw, tcomp.GGSWCompressed) and t.ggsw.seed == j.ggsw.seed
    assert _eq(tbr.blind_rotation_key_decompress(mods["tm"], t).pmats,
               j_brk_decompress(mods["jm"], j).pmats)
    name, fields = interop.to_fields(t)
    assert name == "BlindRotationKeyCompressed" and fields["ggsw"][0] == "GGSWCompressed"
    assert fields["ggsw"][1]["seed"] == j.ggsw.seed and _eq(fields["ggsw"][1]["body"], j.ggsw.body)
    lwe = j_lwe_c(None, jnp.zeros((3, 1), jnp.int64), jnp.asarray(sk_lwe), BASE2K, K_CT,
                  JSource(XE), JSource(XA))
    back = interop.from_fields(*interop.to_fields(lwe), device="cpu")
    assert _eq(tcomp.lwe_decompress(back).data, jcomp.lwe_decompress(lwe).data)


# ---- chip_smoke.py's compressed_gate constants --------------------------------------------------

def _jax_compressed_gate(params):
    """chip_smoke.py's compressed_gate keys through the JAX package: the
    client's keygen and blobs, the server's keys.  Returns (keys, LWE
    secret, BRK blob)."""
    from poulpy_tpu.binfhe import gates as jgates
    from poulpy_tpu.binfhe.lut import LookupTable
    from poulpy_tpu.core.layouts import glwe_size
    from poulpy_tpu.hal.normalization import vec_znx_normalize

    m = jgates.Module(params.n_glwe, params.nprimes, params.prime_bits)
    src = JSource(bytes(32))
    xe, xa = src.branch()[1], src.branch()[1]
    sk_lwe = src.binary_block(params.n_lwe, params.block_size)
    sk_glwe = jenc.secret_new(m, 1, src)
    brk_c = jbr.blind_rotation_key_encrypt_sk_compressed(
        m, jnp.asarray(sk_lwe), jprep.glwe_secret_prepare(m, sk_glwe), params.base2k,
        params.k_brk, params.dnum_brk, xe, xa)
    ksk_c = jcomp.glwe_to_lwe_key_encrypt_sk_compressed(m, jnp.asarray(sk_lwe), sk_glwe,
                                                        params.base2k, params.k_ksk,
                                                        params.dnum_ksk, xe, xa)
    brk_blob, ksk_blob = jser.serialize_layout(brk_c), jser.serialize_layout(ksk_c)
    brk = jbr.blind_rotation_key_decompress(
        m, jser.deserialize_layout(brk_blob, jbr.BlindRotationKeyCompressed))
    to_lwe = jprep.gglwe_prepare(m, jcomp.gglwe_decompress(
        m, jser.deserialize_layout(ksk_blob, jcomp.GGLWECompressed)))
    data = jnp.zeros((1, glwe_size(params.base2k, params.k_ct), params.n_glwe), jnp.int64)
    lut = LookupTable(data=vec_znx_normalize(params.base2k,
                                             data.at[0, 0, :].set(1 << (params.base2k - 3))),
                      base2k=params.base2k, k=params.k_ct)
    keys = jgates.BootstrapKeys(module=m, params=params, brk=brk, to_lwe=to_lwe, lut=lut)
    return keys, sk_lwe, brk_blob


@pytest.mark.slow
def test_compressed_gate_constants_full_config():
    """COMPRESSED_BRK_BLOB_DIGEST and COMPRESSED_GATE_FINGERPRINT: the JAX
    package's compressed keygen at bench_full.py's gate configuration (the
    stream of gates.keygen, compressed keys in place of the direct ones),
    its BRK blob's blake2b-8, then one NAND at batch 1024 on the keys read
    back and decompressed, sum(|data| mod 65536), on the CPU (minutes, a few
    GB); the port (chip_smoke.py's client and server on the CPU) gives the
    same blob and the same data on the first 16 rows (chip_smoke.py checks
    the port's whole batch on the card)."""
    import chip_smoke
    from poulpy_tpu.binfhe import gates as jgates
    from poulpy_tpu_torch.binfhe import gates as tgates

    b1 = np.random.default_rng(0).integers(0, 2, chip_smoke.GATE_BATCH)
    b2 = np.random.default_rng(1).integers(0, 2, chip_smoke.GATE_BATCH)
    outs, blobs = {}, {}
    for gates, S, rows in ((jgates, JSource, chip_smoke.GATE_BATCH), (tgates, TSource, 16)):
        params = gates.GateParams(n_lwe=chip_smoke.GATE_N_LWE, block_size=chip_smoke.GATE_BLOCK)
        if gates is jgates:
            keys, sk, blobs[gates] = _jax_compressed_gate(params)
        else:
            client = chip_smoke.compressed_gate_client(params, "cpu")
            keys = chip_smoke.compressed_gate_server(params, client["brk_blob"],
                                                     client["ksk_blob"], "cpu")[0]
            sk, blobs[gates] = client["sk_lwe"], client["brk_blob"]
        xe, xa = S(b"\x05" * 32), S(b"\x06" * 32)
        c1 = gates.encrypt_bit(params, b1, sk, xe, xa)
        c2 = gates.encrypt_bit(params, b2, sk, xe, xa)
        out = gates.gate_nand(keys, c1.replace(data=c1.data[:rows]),
                              c2.replace(data=c2.data[:rows]))
        assert np.array_equal(gates.decrypt_bit(out, sk), 1 - (b1[:rows] & b2[:rows]))
        outs[gates] = np.asarray(out.data)
    assert blobs[tgates] == blobs[jgates]
    assert chip_smoke.blob_digest(blobs[jgates]) == chip_smoke.COMPRESSED_BRK_BLOB_DIGEST
    assert int((np.abs(outs[jgates]) % 65536).sum()) == chip_smoke.COMPRESSED_GATE_FINGERPRINT
    assert np.array_equal(outs[tgates], outs[jgates][:16])
