"""poulpy_tpu_torch's circuit bootstrapping (LWE → GGSW) against poulpy_tpu's,
bit for bit (tolerance 0).

At N 64 on get_module(64, 2, 28), bench_schemes.py's configuration cut in
width: base2k 13, n_lwe 16 (a block-binary secret in blocks of 4, also a
binary one), blind-rotation, automorphism and tensor keys at k 52 with dnum
3, an output GGSW of k 26 with dnum 2, log_domain 1, the LWE at k 13.  The
same `Source` seeds go through both packages; one keygen each, shared by
the module.  Covered: `switch_ring` both ways, the LUT over two polynomials
and its rotation, the extended blind rotation (standard and block key),
the keys, their interop, and the CBT to-constant and to-exponent on the
standard, block and block + extended paths, with an external product by
the port's GGSWs decrypting to bit·m.  The `slow` test recomputes
chip_smoke.py's two CBT fingerprints with the JAX package at full size.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poulpy_tpu.binfhe import blind_rotation as jbr
from poulpy_tpu.binfhe import circuit_bootstrapping as jcbt
from poulpy_tpu.binfhe import lut as jlut
from poulpy_tpu.core import encryption as jenc
from poulpy_tpu.core import layouts as jlay
from poulpy_tpu.core import prepared as jprep
from poulpy_tpu.hal import vec_znx as jvz
from poulpy_tpu.hal.module import get_module as j_get_module
from poulpy_tpu.hal.source import Source as JSource
from poulpy_tpu_torch.backends import LAUNCHES
from poulpy_tpu_torch.binfhe import blind_rotation as tbr
from poulpy_tpu_torch.binfhe import circuit_bootstrapping as tcbt
from poulpy_tpu_torch.binfhe import lut as tlut
from poulpy_tpu_torch.core import decryption as tdec
from poulpy_tpu_torch.core import encryption as tenc
from poulpy_tpu_torch.core import external_product as text
from poulpy_tpu_torch.core import layouts as tlay
from poulpy_tpu_torch.core import prepared as tprep
from poulpy_tpu_torch.hal import vec_znx as tvz
from poulpy_tpu_torch.hal.module import get_module as t_get_module
from poulpy_tpu_torch.hal.source import Source as TSource
from poulpy_tpu_torch.utils import interop

N, N_LWE, BLOCK = 64, 16, 4
BASE2K, K_KEY, DNUM_KEY, K_RES, DNUM_RES, K_LWE, LOG_DOMAIN = 13, 52, 3, 26, 2, 13, 1
BITS = np.array([0, 1, 1, 0])
# |decrypt(GLWE(m) ⊡ GGSW(bit)) − bit·m| (mod 2^8, centred) of an 8-bit
# message in a k 26 GLWE: the JAX package reads 10–15 at this configuration
# (a torus error near 2^-4.2: the GGSW rows of k 26 carry noise near 2^-20)
K_MSG, DECRYPT_BOUND = 8, 32

j_secret_prepare = jax.jit(jprep.glwe_secret_prepare, static_argnums=0)


def _eq(have, want):
    have = have.cpu().numpy() if isinstance(have, torch.Tensor) else np.asarray(have)
    want = np.asarray(want)
    return have.shape == want.shape and np.array_equal(have, want)


def _keygen(pkg: str, n: int = N, n_lwe: int = N_LWE, block: int = BLOCK, bits=BITS,
            batches: int = 1) -> dict:
    """bench_schemes.py's set-up through one package: Source(bytes(32))
    draws the LWE secret (`binary_block` for block > 1, else
    `binary_prob`) then the GLWE secret; the keys, then `batches`
    encryptions of `bits` at LWE k 13, come from Source 0x01 / 0x02."""
    if pkg == "jax":
        m, S, enc, cbt, arr = j_get_module(n, 2, 28), JSource, jenc, jcbt, jnp.asarray
        prep = j_secret_prepare
    else:
        m, S, enc, cbt = t_get_module(n, 2, 28, "cpu"), TSource, tenc, tcbt
        arr, prep = torch.from_numpy, tprep.glwe_secret_prepare
    src, xe, xa = S(bytes(32)), S(b"\x01" * 32), S(b"\x02" * 32)
    sk_lwe = src.binary_block(n_lwe, block) if block > 1 else src.binary_prob((n_lwe,))
    sk = enc.secret_new(m, 1, src)
    skp = prep(m, sk)
    key = cbt.circuit_bootstrapping_keygen(m, sk_lwe, sk, skp, BASE2K, K_KEY, DNUM_KEY, K_KEY,
                                           DNUM_KEY, K_KEY, DNUM_KEY, xe, xa, block_size=block)
    pt = np.zeros((len(bits), 1, 1), dtype=np.int64)
    pt[:, 0, 0] = np.asarray(bits) << (BASE2K - 2)
    lwes = [enc.lwe_encrypt_sk(None, arr(pt), arr(sk_lwe), BASE2K, K_LWE, xe, xa)
            for _ in range(batches)]
    return dict(m=m, sk_lwe=sk_lwe, sk=sk, skp=skp, key=key, lwe=lwes[-1])


JAX_CLASSES = {cls.__name__: cls for cls in (jcbt.CircuitBootstrappingKey,
                                             jbr.BlindRotationKeyPrepared, jprep.GGLWEPrepared,
                                             jprep.GLWEAutomorphismKeyPrepared, jlay.LWECiphertext)}


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


@pytest.fixture(scope="module")
def runs():
    """The port's keys and LWEs (the JAX package's keygen compiles for
    minutes on the CPU; the slow test and chip_smoke.py hold the port's
    keygen against it at full size), carried into the JAX package's
    layouts by interop, and carried back."""
    t = _keygen("torch")
    j = dict(m=j_get_module(N, 2, 28), key=_jax(*interop.to_fields(t["key"])),
             lwe=_jax(*interop.to_fields(t["lwe"])))
    t["jkey"] = interop.from_fields(*interop.to_fields(j["key"]), device="cpu")
    return j, t


# ---- switch_ring, LUT, extended blind rotation ---------------------------------------

@pytest.mark.parametrize("n_out", [16, 64, 256], ids=["down", "same", "up"])
def test_switch_ring(n_out):
    a = np.random.default_rng(3).integers(-(2**40), 2**40, size=(2, 3, N))
    assert _eq(tvz.vec_znx_switch_ring(n_out, torch.from_numpy(a)),
               jvz.vec_znx_switch_ring(n_out, jnp.asarray(a)))


@pytest.mark.parametrize("f_len,f_k,rot_dir", [(4, 26, "left"), (6, 26, "right"), (64, 17, "left")])
def test_lookup_table_extended(f_len, f_k, rot_dir):
    """The LUT over two polynomials (domain 2N) and its rotation, by amounts
    of either parity and past the domain."""
    f = np.arange(f_len, dtype=np.int64) * 5 - 7
    want = jlut.lookup_table_new(N, BASE2K, 26, f, f_k, extension_factor=2, rot_dir=rot_dir)
    have = tlut.lookup_table_new(N, BASE2K, 26, f, f_k, extension_factor=2, rot_dir=rot_dir,
                                 device="cpu")
    assert _eq(have.data, want.data)
    assert (have.drift, have.extension_factor, have.domain_size) == (
        want.drift, want.extension_factor, want.domain_size)
    for k in (-7, 8, 3 * N + 1):
        assert _eq(tlut.lookup_table_rotate(have, k).data, jlut.lookup_table_rotate(want, k).data)


@pytest.mark.parametrize("block", [1, BLOCK])
def test_blind_rotation_extended(runs, block):
    """The extended path (ext 2) on the JAX key carried by interop, through
    the port's dispatch, against the JAX package's extended path."""
    j, t = runs
    f = np.arange(8, dtype=np.int64)
    jl = jlut.lookup_table_new(N, BASE2K, 26, f, 26, extension_factor=2)
    tl = tlut.lookup_table_new(N, BASE2K, 26, f, 26, extension_factor=2, device="cpu")
    want = jbr.blind_rotation_execute_extended(j["m"], j["lwe"], jl, j["key"].brk, block)
    have = tbr.blind_rotation_dispatch(t["m"], t["lwe"], tl, t["jkey"].brk, block)
    assert _eq(have, want)


# ---- the key's interop -------------------------------------------------------------------

def test_cbt_key_interop(runs):
    """block_size, the BRK as (name, fields), the atk dict keyed by int (−1
    literally) and the tsk list cross both ways, arrays equal."""
    j, t = runs
    jk, tk, back = j["key"], t["key"], t["jkey"]
    assert type(jk).__module__ == jcbt.__name__ and jk.block_size == tk.block_size == BLOCK
    assert isinstance(back, tcbt.CircuitBootstrappingKey) and back.block_size == BLOCK
    assert isinstance(back.brk, tbr.BlindRotationKeyPrepared)
    assert (back.brk.base2k, back.brk.k, back.brk.dsize) == (tk.brk.base2k, tk.brk.k, tk.brk.dsize)
    assert _eq(back.brk.pmats, jk.brk.pmats) and _eq(tk.brk.pmats, jk.brk.pmats)
    assert list(back.atk) == list(jk.atk) == list(tk.atk) == [-1] + [
        5 ** (1 << i) % (2 * N) for i in range(5)]
    for p, key in back.atk.items():
        assert key.p == jk.atk[p].p == p and _eq(key.key.pmat, jk.atk[p].key.pmat)
        assert _eq(tk.atk[p].key.pmat, jk.atk[p].key.pmat)
    assert len(back.tsk) == len(jk.tsk) == 1 and _eq(back.tsk[0].pmat, jk.tsk[0].pmat)
    name, fields = interop.to_fields(back.replace(block_size=1))
    assert name == "CircuitBootstrappingKey" and fields["block_size"] == 1
    assert fields["brk"][0] == "BlindRotationKeyPrepared"
    assert [n for n, _ in fields["tsk"]] == ["GGLWEPrepared"]
    assert all(n == "GLWEAutomorphismKeyPrepared" for n, _ in fields["atk"].values())


# ---- circuit bootstrapping ---------------------------------------------------------------

PATHS = [(1, 1), (BLOCK, 1), (BLOCK, 2)]


@pytest.mark.parametrize("to_exponent", [False, True], ids=["to_constant", "to_exponent"])
@pytest.mark.parametrize("block,ext", PATHS, ids=["standard", "block", "block_extended"])
def test_circuit_bootstrap(runs, block, ext, to_exponent):
    """The CBT of the four LWEs on the port's own key against the JAX
    package's, and no kernel launched on the CPU; to-constant on the
    standard path also decrypts: GLWE(m) ⊡ GGSW(bit) → bit·m."""
    j, t = runs
    jkey = dataclasses.replace(j["key"], block_size=block)
    tkey = t["key"].replace(block_size=block)
    want = jcbt.circuit_bootstrap(j["m"], j["lwe"], LOG_DOMAIN, jkey, DNUM_RES, K_RES,
                                  to_exponent=to_exponent, extension_factor=ext)
    before = dict(LAUNCHES)
    have = tcbt.circuit_bootstrap(t["m"], t["lwe"], LOG_DOMAIN, tkey, DNUM_RES, K_RES,
                                  to_exponent=to_exponent, extension_factor=ext)
    assert LAUNCHES == before
    assert _eq(have.data, want.data)
    assert (have.base2k, have.k, have.dsize) == (want.base2k, want.k, want.dsize)
    assert tuple(have.data.shape) == (len(BITS), DNUM_RES, 2, 2, K_RES // BASE2K, N)
    if (block, ext, to_exponent) == (1, 1, False):
        m, skp = t["m"], t["skp"]
        msg = np.random.default_rng(9).integers(-(2**(K_MSG - 1)), 2**(K_MSG - 1), size=N)
        pt = tlay.GLWEPlaintext(data=tvz.encode_vec_i64(BASE2K, K_MSG, 2, torch.from_numpy(msg)),
                                base2k=BASE2K, k=K_MSG)
        ct = tenc.glwe_encrypt_sk(m, pt, skp, BASE2K, K_RES, TSource(b"\x03" * 32),
                                  TSource(b"\x04" * 32))
        for row, bit in enumerate(BITS):
            ggsw = tprep.ggsw_prepare(m, have.replace(data=have.data[row]))
            out = tdec.glwe_decrypt(m, text.glwe_external_product(m, ct, ggsw), skp)
            err = (tvz.decode_vec_i64(BASE2K, K_MSG, out.data).numpy() - bit * msg) % (1 << K_MSG)
            assert np.abs((err + (1 << (K_MSG - 1))) % (1 << K_MSG) - (1 << (K_MSG - 1))).max() \
                <= DECRYPT_BOUND


def test_circuit_bootstrap_on_jax_key(runs):
    """The port's CBT on the key carried through the JAX package and back
    equals its CBT on its own key (block path, to-constant)."""
    _, t = runs
    args = (t["m"], t["lwe"], LOG_DOMAIN)
    want = tcbt.circuit_bootstrap(*args, t["key"].replace(block_size=BLOCK), DNUM_RES, K_RES)
    have = tcbt.circuit_bootstrap(*args, t["jkey"].replace(block_size=BLOCK), DNUM_RES, K_RES)
    assert _eq(have.data, want.data)


# ---- the chip_smoke.py CBT fingerprints ----------------------------------------------------

@pytest.mark.slow
def test_cbt_fingerprints_full_config():
    """chip_smoke.py's CBT constants at bench_schemes.py's configuration and
    seeds, recomputed by the JAX package on the CPU (minutes, a few GB):
    the fingerprints sum(|ggsw.data| mod 65536) of the warm-up batch (the
    last of CBT_ITERS + 1 encrypted batches of arange(32) % 2) on the
    standard path (n_lwe 574) and the block path (n_lwe 576 in blocks of
    8), and the decrypt bound: twice the largest |decrypt(ct ⊡ GGSW) −
    bit·decrypt(ct)| (2^-26 scale, centred) over the 32 GGSWs of either
    path, ct the noiseless GLWE of ternary limbs of chip_smoke.py's check.
    The port's CPU run, far slower, gives the same GGSWs on the first 2
    rows (chip_smoke.py checks every row on the card)."""
    import chip_smoke
    from poulpy_tpu.core import decryption as jdec
    from poulpy_tpu.core.external_product import glwe_external_product

    bits = np.arange(chip_smoke.CBT_BATCH) % 2
    ct = np.zeros((2, 2, 1024), dtype=np.int64)
    ct[:, 0] = np.random.default_rng(chip_smoke.CBT_MSG_SEED).integers(-1, 2, (2, 1024))
    worst = 0
    for (n_lwe, block), fingerprint in (((574, 1), chip_smoke.CBT_FINGERPRINT),
                                        ((576, 8), chip_smoke.CBT_BLOCK8_FINGERPRINT)):
        outs = {}
        for pkg, cbt, rows in (("jax", jcbt, len(bits)), ("torch", tcbt, 2)):
            run = _keygen(pkg, 1024, n_lwe, block, bits, chip_smoke.CBT_ITERS + 1)
            lwe = run["lwe"].replace(data=run["lwe"].data[:rows])
            out = cbt.circuit_bootstrap(run["m"], lwe, LOG_DOMAIN, run["key"], DNUM_RES, K_RES)
            outs[pkg] = (run, np.asarray(out.data))
        (j, want), (_, have) = outs["jax"], outs["torch"]
        assert int((np.abs(want) % 65536).sum()) == fingerprint
        assert np.array_equal(have, want[:2])
        m, skp = j["m"], j["skp"]
        glwe = jlay.GLWECiphertext(data=jnp.asarray(ct), base2k=BASE2K, k=K_RES)

        @jax.jit
        def phase(ggsw_data):
            c = glwe if ggsw_data is None else glwe_external_product(
                m, glwe, jprep.ggsw_prepare(m, jlay.GGSWCiphertext(data=ggsw_data, base2k=BASE2K,
                                                                   k=K_RES)))
            return jvz.decode_vec_i64(BASE2K, K_RES, jdec.glwe_decrypt(m, c, skp).data)

        msg = np.asarray(phase(None))
        for row, bit in enumerate(bits):
            err = (np.asarray(phase(jnp.asarray(want[row]))) - bit * msg) % (1 << K_RES)
            worst = max(worst, int(np.abs((err + (1 << 25)) % (1 << K_RES) - (1 << 25)).max()))
    assert 2 * worst == chip_smoke.CBT_DECRYPT_BOUND
