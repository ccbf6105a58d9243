"""poulpy_tpu_torch.utils.serialization against poulpy_tpu.utils.serialization:
the same wire format byte for byte.

The round trips of tests/test_serialization.py in the port, then the two
packages against each other: the port's blob of a layout equals the JAX
package's blob of the same layout (a GLWE, a GGSW, a GGLWE, a prepared GGSW,
the compressed GLWE and GGSW, the compressed blind-rotation key with its
nested GGSW, a CKKS ciphertext with its nested GLWE and meta, a constant
plaintext with None fields); each package reads the other's blobs to equal
arrays and parameters; both refuse a wrong type, a bad magic and an unknown
nested class with `ValueError`.  Port layouts are made on the CPU and carried
to the JAX package by their fields.
"""

import json
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from poulpy_tpu.binfhe import blind_rotation as jbr
from poulpy_tpu.ckks import layouts as jckks
from poulpy_tpu.ckks import plaintext as jckks_pt
from poulpy_tpu.core import compressed as jcomp
from poulpy_tpu.core import layouts as jlay
from poulpy_tpu.core import prepared as jprep
from poulpy_tpu.utils import serialization as jser
from poulpy_tpu_torch.binfhe import blind_rotation as tbr
from poulpy_tpu_torch.ckks.layouts import CKKSCiphertext, CKKSMeta
from poulpy_tpu_torch.ckks.plaintext import CKKSPlaintextCstZnx
from poulpy_tpu_torch.core import compressed as comp
from poulpy_tpu_torch.core import encryption as enc
from poulpy_tpu_torch.core.layouts import (
    GGLWECiphertext,
    GGSWCiphertext,
    GLWECiphertext,
    GLWEPlaintext,
)
from poulpy_tpu_torch.core.prepared import GGSWPrepared, ggsw_prepare, glwe_secret_prepare
from poulpy_tpu_torch.hal import vec_znx
from poulpy_tpu_torch.hal.module import get_module
from poulpy_tpu_torch.hal.source import Source
from poulpy_tpu_torch.utils import interop
from poulpy_tpu_torch.utils.serialization import (
    deserialize_layout,
    digest_u64,
    serialize_layout,
)

N = 64
BASE2K = 17

JAX_CLASSES = {cls.__name__: cls for cls in (
    jlay.GLWECiphertext, jlay.GGSWCiphertext, jlay.GGLWECiphertext, jprep.GGSWPrepared,
    jcomp.GLWECompressed, jcomp.GGSWCompressed, jcomp.GGLWECompressed,
    jbr.BlindRotationKeyCompressed, jckks.CKKSCiphertext, jckks.CKKSMeta,
    jckks_pt.CKKSPlaintextCstZnx)}


def _eq(have, want):
    have = have.cpu().numpy() if isinstance(have, torch.Tensor) else np.asarray(have)
    want = np.asarray(want)
    return have.shape == want.shape and have.dtype == want.dtype and np.array_equal(have, want)


def _jax(obj):
    """The JAX package's layout with the port object's fields."""
    def conv(v):
        if isinstance(v, np.ndarray):
            return jnp.asarray(v)
        if interop._is_fields(v):
            return JAX_CLASSES[v[0]](**{k: conv(x) for k, x in v[1].items()})
        return v

    return conv(interop.to_fields(obj))


def _same(a, b) -> bool:
    """Equal layouts of either package: arrays, parameters, nested layouts."""
    if type(a).__name__ != type(b).__name__:
        return False
    for f in type(a).__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        if hasattr(x, "__dataclass_fields__"):
            if not _same(x, y):
                return False
        elif hasattr(x, "shape"):
            if not _eq(x, y):
                return False
        elif x != y:
            return False
    return True


@pytest.fixture(scope="module")
def keys():
    """The port's GLWE of tests/test_serialization.py's set-up, and a GGSW, a
    switching key, a prepared GGSW and the compressed keys from Source 0x03
    / 0x04, on the CPU."""
    m = get_module(N, 2, device="cpu")
    sk = enc.secret_new(m, 1, Source(bytes(32)))
    skp = glwe_secret_prepare(m, sk)
    data = np.random.default_rng(13).integers(-(2**15), 2**15, size=N, dtype=np.int64)
    pt = GLWEPlaintext(data=vec_znx.encode_vec_i64(BASE2K, 34, 3, torch.from_numpy(data)),
                       base2k=BASE2K, k=34)
    ct = enc.glwe_encrypt_sk(m, pt, skp, BASE2K, 51, Source(b"\x01" * 32), Source(b"\x02" * 32))
    ct_c = comp.glwe_encrypt_sk_compressed(m, pt, skp, BASE2K, 51, Source(b"\x01" * 32),
                                           Source(b"\x02" * 32))
    xe, xa = Source(b"\x03" * 32), Source(b"\x04" * 32)
    ptg = torch.zeros(N, dtype=torch.int64)
    ptg[2] = 1
    ggsw = enc.ggsw_encrypt_sk(m, ptg, skp, BASE2K, 68, 3, xe, xa)
    ksk = enc.glwe_switching_key_encrypt_sk(m, sk, skp, BASE2K, 68, 3, xe, xa)
    brk_c = tbr.blind_rotation_key_encrypt_sk_compressed(
        m, torch.from_numpy(Source(b"\x09" * 32).binary_prob((8,))), skp, BASE2K, 68, 3, xe, xa)
    ckks = CKKSCiphertext(glwe=GLWECiphertext(data=torch.arange(48).reshape(2, 3, 8), base2k=17,
                                              k=51),
                          meta=CKKSMeta(log_delta=22, log_budget=30))
    cst = CKKSPlaintextCstZnx(re=314159, im=None, meta=CKKSMeta(log_delta=20, log_budget=0))
    return dict(m=m, ct=ct, ct_c=ct_c, ggsw=ggsw, ksk=ksk, prep=ggsw_prepare(m, ggsw),
                brk_c=brk_c, ggsw_c=brk_c.ggsw, ckks=ckks, cst=cst)


# ---- the round trips of tests/test_serialization.py ----------------------------------------

def test_glwe_roundtrip(keys):
    ct = keys["ct"]
    back = deserialize_layout(serialize_layout(ct), GLWECiphertext, device="cpu")
    assert back.base2k == ct.base2k and back.k == ct.k
    assert torch.equal(back.data, ct.data)


def test_compressed_roundtrip_with_seed(keys):
    m, ct_c = keys["m"], keys["ct_c"]
    back = deserialize_layout(serialize_layout(ct_c), comp.GLWECompressed, device="cpu")
    assert back.seed == ct_c.seed and isinstance(back.seed, bytes)
    assert torch.equal(back.body, ct_c.body)
    assert torch.equal(comp.glwe_decompress(m, back).data, comp.glwe_decompress(m, ct_c).data)


def test_type_mismatch_rejected(keys):
    blob = serialize_layout(keys["ct"])
    for read, cls in ((deserialize_layout, comp.GLWECompressed),
                      (jser.deserialize_layout, jcomp.GLWECompressed)):
        with pytest.raises(ValueError, match="type mismatch"):
            read(blob, cls)


def test_digest_stable(keys):
    data = keys["ct"].data
    d1 = digest_u64(data)
    assert d1 == digest_u64(data.numpy().copy()) == jser.digest_u64(data.numpy())
    assert d1 != digest_u64(data + 1)


@pytest.mark.parametrize("name,cls", [("ggsw", GGSWCiphertext), ("ksk", GGLWECiphertext),
                                      ("prep", GGSWPrepared)])
def test_ggsw_and_key_roundtrips(keys, name, cls):
    obj = keys[name]
    back = deserialize_layout(serialize_layout(obj), cls, device="cpu")
    assert _same(back, obj)


def test_compressed_brk_roundtrip(keys):
    """The compressed blind-rotation key, whole (its GGSW nested) and by its
    GGSW alone, reads back to the same prepared key."""
    m, brk_c = keys["m"], keys["brk_c"]
    want = tbr.blind_rotation_key_decompress(m, brk_c)
    back = deserialize_layout(serialize_layout(brk_c), tbr.BlindRotationKeyCompressed,
                              device="cpu")
    assert _same(back, brk_c)
    back_ggsw = deserialize_layout(serialize_layout(brk_c.ggsw), comp.GGSWCompressed,
                                   device="cpu")
    for key in (back, tbr.BlindRotationKeyCompressed(ggsw=back_ggsw, dist=brk_c.dist)):
        assert torch.equal(tbr.blind_rotation_key_decompress(m, key).pmats, want.pmats)


def test_nested_layout_roundtrip(keys):
    c, z = keys["ckks"], keys["cst"]
    back = deserialize_layout(serialize_layout(c), CKKSCiphertext, device="cpu")
    assert back.meta == c.meta and (back.glwe.base2k, back.glwe.k) == (17, 51)
    assert torch.equal(back.glwe.data, c.glwe.data)
    b2 = deserialize_layout(serialize_layout(z), CKKSPlaintextCstZnx, device="cpu")
    assert b2.re == 314159 and b2.im is None and b2.meta == z.meta


# ---- the port against the JAX package ------------------------------------------------------

LAYOUTS = ["ct", "ct_c", "ggsw", "ksk", "prep", "ggsw_c", "brk_c", "ckks", "cst"]


@pytest.mark.parametrize("name", LAYOUTS)
def test_port_bytes_equal_jax_bytes(keys, name):
    blob = serialize_layout(keys[name])
    assert blob == jser.serialize_layout(_jax(keys[name]))


@pytest.mark.parametrize("name", LAYOUTS)
def test_blobs_cross_packages(keys, name):
    """A JAX blob read by the port and a port blob read by the JAX package
    give equal arrays and parameters."""
    obj = keys[name]
    jobj = _jax(obj)
    from_jax = deserialize_layout(jser.serialize_layout(jobj), type(obj), device="cpu")
    assert _same(from_jax, obj)
    from_port = jser.deserialize_layout(serialize_layout(obj), type(jobj))
    assert _same(from_port, jobj)


def test_nested_names_are_the_jax_package_s(keys):
    """The port writes a nested layout's class under the JAX package's
    qualified name, and reads it and a bare version-1 name back."""
    blob = serialize_layout(keys["brk_c"])
    mlen = struct.unpack_from("<Q", blob)[0]
    header = json.loads(blob[8:8 + mlen])
    assert header == {"type": "BlindRotationKeyCompressed",
                      "meta": {"ggsw": {"__nested__": "poulpy_tpu.core.compressed.GGSWCompressed"},
                               "dist": "binary_prob"}}
    header["meta"]["ggsw"]["__nested__"] = "GGSWCompressed"
    hb = json.dumps(header).encode()
    v1 = struct.pack("<Q", len(hb)) + hb + blob[8 + mlen:]
    assert _same(deserialize_layout(v1, tbr.BlindRotationKeyCompressed, device="cpu"),
                 keys["brk_c"])
    assert _same(jser.deserialize_layout(v1, jbr.BlindRotationKeyCompressed),
                 _jax(keys["brk_c"]))


@pytest.mark.parametrize("nested", ["poulpy_tpu.core.layouts.GGSWCompressed", "NoSuchLayout"])
def test_unknown_nested_class_rejected(keys, nested):
    blob = serialize_layout(keys["brk_c"])
    mlen = struct.unpack_from("<Q", blob)[0]
    header = json.loads(blob[8:8 + mlen])
    header["meta"]["ggsw"]["__nested__"] = nested
    hb = json.dumps(header).encode()
    with pytest.raises(ValueError, match="unknown nested layout class"):
        deserialize_layout(struct.pack("<Q", len(hb)) + hb + blob[8 + mlen:],
                           tbr.BlindRotationKeyCompressed, device="cpu")


def test_bad_magic_rejected(keys):
    blob = bytearray(serialize_layout(keys["ct"]))
    mlen = struct.unpack_from("<Q", blob)[0]
    off = 8 + mlen + 8 + len(b"data")
    blob[off:off + 8] = (0).to_bytes(8, "little")
    with pytest.raises(ValueError, match="bad magic"):
        deserialize_layout(bytes(blob), GLWECiphertext, device="cpu")
    with pytest.raises(ValueError, match="bad magic"):
        jser.deserialize_layout(bytes(blob), jlay.GLWECiphertext)


def test_deserialize_defaults_to_the_card(keys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        deserialize_layout(serialize_layout(keys["ct"]), GLWECiphertext)
