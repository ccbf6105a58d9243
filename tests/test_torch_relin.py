"""poulpy_tpu_torch's ct × ct relinearization against poulpy_tpu's, bit for
bit (tolerance 0).

`glwe_tensor_relinearize` at N 64 in every branch: rank 1 non-wide on both
prime bases (the port's fused pair, its plain versions on the CPU, and the
unfused data flow; the JAX package on the CPU takes its jnp data flow), a
result base other than the ciphertexts', rank 2, and the wide exit.  The two
plain versions of the pair (`fused_tensor_product_ref`,
`fused_glwe_product_ref(small64=…)`) against the JAX package's jnp flow and
its Pallas kernels in interpret mode.  The `slow` test recomputes
chip_smoke.py's relinearize and rotation fingerprints at the full CKKS
configuration with both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poulpy_tpu.core import encryption as jenc
from poulpy_tpu.core import layouts as jlay
from poulpy_tpu.core import operations as jops
from poulpy_tpu.core import prepared as jprep
from poulpy_tpu.hal import dft as jdft
from poulpy_tpu.hal.module import get_module as j_get_module
from poulpy_tpu.hal.source import Source as JSource
from poulpy_tpu_torch.backends import LAUNCHES
from poulpy_tpu_torch.backends import fused as tfused
from poulpy_tpu_torch.core import decryption as tdec
from poulpy_tpu_torch.core import encryption as tenc
from poulpy_tpu_torch.core import layouts as tlay
from poulpy_tpu_torch.core import operations as tops
from poulpy_tpu_torch.core import prepared as tprep
from poulpy_tpu_torch.hal import dft as tdft
from poulpy_tpu_torch.hal import vec_znx as tvz
from poulpy_tpu_torch.hal.module import get_module as t_get_module
from poulpy_tpu_torch.hal.normalization import vec_znx_normalize
from poulpy_tpu_torch.hal.source import Source as TSource

N = 64
# name → (rank, base2k, k_ct, k_key, dnum, nprimes, prime_bits, ternary_hw weight)
CONFIGS = {
    "rank1_28": (1, 17, 51, 68, 4, 2, 28, None),
    "rank1_30": (1, 17, 51, 68, 4, 2, 30, None),
    "rank2": (2, 17, 51, 68, 4, 3, 30, None),
    "wide": (1, 52, 95, 156, 2, 5, 28, 16),
}

# the JAX package's relinearization, compiled once per module and result base
j_relinearize = jax.jit(jops.glwe_tensor_relinearize, static_argnums=(0, 4, 5))


def _eq(have, want):
    have = have.cpu().numpy() if isinstance(have, torch.Tensor) else np.asarray(have)
    want = np.asarray(want)
    return have.shape == want.shape and np.array_equal(have, want)


def _setup(name: str):
    """The port's module, prepared secret, prepared tensor key and two
    ciphertexts (batch 2) of random data drawn with numpy (the tensor key's
    encryption equals the JAX package's: tests/test_torch_ckks.py)."""
    rank, base2k, k_ct, k_key, dnum, nprimes, bits, hw = CONFIGS[name]
    m = t_get_module(N, nprimes, bits, "cpu")
    dist = {"dist": "ternary_hw", "hw": hw} if hw else {}
    sk = tenc.secret_new(m, rank, TSource(bytes(32)), **dist)
    skp = tprep.glwe_secret_prepare(m, sk)
    xe, xa = TSource(b"\x01" * 32), TSource(b"\x02" * 32)
    tsk = tprep.glwe_tensor_key_prepare(m, tenc.glwe_tensor_key_encrypt_sk(
        m, sk, skp, base2k, k_key, dnum=dnum, source_xe=xe, source_xa=xa))
    size = -(-k_ct // base2k)
    data = np.random.default_rng(60).integers(-(2**(base2k - 1)), 2**(base2k - 1),
                                              size=(2, 2, size, N))
    cts = [tenc.glwe_encrypt_sk(m, tlay.GLWEPlaintext(data=torch.from_numpy(d), base2k=base2k,
                                                      k=k_ct), skp, base2k, k_ct, xe, xa)
           for d in data]
    return m, skp, tsk, cts


def _jax(name: str, tsk, cts):
    """The JAX package's module, and the port's tensor key and ciphertexts as
    its layouts."""
    _, _, _, _, _, nprimes, bits, _ = CONFIGS[name]
    keys = {ij: jprep.GGLWEPrepared(pmat=jnp.asarray(k.pmat.numpy()), base2k=k.base2k, k=k.k,
                                    dsize=k.dsize) for ij, k in tsk.keys.items()}
    return (j_get_module(N, nprimes, bits), jprep.GLWETensorKeyPrepared(keys=keys),
            [jlay.GLWECiphertext(data=jnp.asarray(c.data.numpy()), base2k=c.base2k, k=c.k)
             for c in cts])


@pytest.mark.parametrize("name,res", [("rank1_28", None), ("rank1_30", None),
                                      ("rank1_28", (13, 80)), ("rank2", None), ("wide", None)],
                         ids=["rank1_28", "rank1_30", "rank1_28_base13", "rank2", "wide"])
def test_relinearize(name, res, monkeypatch):
    """Port == JAX package.  The rank-1 non-wide configurations go through
    the port's fused pair (its plain versions here), the others through the
    unfused data flow; the JAX package takes its jnp data flow."""
    tm, _, ttsk, (ta, tb) = _setup(name)
    jm, jtsk, (ja, jb) = _jax(name, ttsk, (ta, tb))
    res_base2k, res_k = res or (None, None)
    calls = []
    fused = tops.fused_tensor_product
    monkeypatch.setattr(tops, "fused_tensor_product",
                        lambda *a, **k: calls.append(1) or fused(*a, **k))
    before = dict(LAUNCHES)
    have = tops.glwe_tensor_relinearize(tm, ta, tb, ttsk, res_base2k, res_k)
    want = j_relinearize(jm, ja, jb, jtsk, res_base2k, res_k)
    assert LAUNCHES == before
    assert len(calls) == name.startswith("rank1")
    assert (have.base2k, have.k) == (want.base2k, want.k)
    assert _eq(have.data, want.data)


@pytest.mark.parametrize("name", ["rank1_28", "rank1_30"])
def test_relinearize_routes_agree(name, monkeypatch):
    """The fused and the unfused routes of the port give one result."""
    tm, _, ttsk, (ta, tb) = _setup(name)
    fused = tops.glwe_tensor_relinearize(tm, ta, tb, ttsk)
    monkeypatch.setattr(tops, "tensor_fits", lambda *a: False)
    unfused = tops.glwe_tensor_relinearize(tm, ta, tb, ttsk)
    assert torch.equal(fused.data, unfused.data)


def test_relinearize_takes_the_tensor_kernel_past_shared_memory(monkeypatch):
    """At N 4096 with 6 + 6 limbs the tensor kernel's parent workspace
    (393,216 B) passes shared memory and its global layout takes the shape,
    so glwe_tensor_relinearize calls fused_tensor_product there, as the JAX
    package calls its kernel (a random prepared key: the route is what is
    checked); the result equals the unfused data flow's."""
    tm = t_get_module(4096, 2, 28, "cpu")
    rng = np.random.default_rng(63)
    a, b = (tlay.GLWECiphertext(data=torch.from_numpy(rng.integers(-(2**16), 2**16,
                                                                   size=(1, 2, 6, 4096))),
                                base2k=17, k=102) for _ in range(2))
    pmat = np.stack([rng.integers(0, p, size=(6, 1, 2, 6, 4096)) for p in tm.basis.primes],
                    axis=-2)
    key = tprep.GGLWEPrepared(pmat=torch.from_numpy(pmat.astype(np.int32)), base2k=17, k=102)
    tsk = tprep.GLWETensorKeyPrepared(keys={(0, 0): key})
    assert tfused.tensor_design_layout(6, 6, 11, 2, 4096).kind == "global"
    assert tfused.tensor_fits(tm, 6, 6, 11, 6)
    calls = []
    fused = tops.fused_tensor_product
    monkeypatch.setattr(tops, "fused_tensor_product",
                        lambda *args, **kw: calls.append(1) or fused(*args, **kw))
    have = tops.glwe_tensor_relinearize(tm, a, b, tsk)
    assert calls == [1]
    monkeypatch.setattr(tops, "tensor_fits", lambda *args: False)
    assert torch.equal(have.data, tops.glwe_tensor_relinearize(tm, a, b, tsk).data)
    assert calls == [1]


def test_relinearize_decrypts_to_the_tensor_product():
    """decrypt(relin(a, b)) == d0 + d1·s + d2·s² on the torus, up to the
    tensor key's keyswitch noise (tests/test_core.py's check, on the port)."""
    tm, skp, tsk, (ta, tb) = _setup("rank1_30")
    base2k = ta.base2k
    prod = tops.glwe_tensor_relinearize(tm, ta, tb, tsk)
    have = tdec.glwe_decrypt(tm, prod, skp)
    lin, quad = tops.glwe_tensor_product_big(tm, ta, tb, ta.size + tb.size - 1)

    def times_s(big):
        x = tdft.dft_apply(tm, vec_znx_normalize(base2k, big))
        return tdft.idft_apply(tm, tdft.svp_apply(tm, x, skp.data[0]))

    total = lin[0] + times_s(lin[1]) + times_s(times_s(quad[(0, 0)]))
    want = tdft.big_normalize(tm, have.data.shape[-2], base2k, total, base2k)
    err = tvz.decode_vec_float(base2k, have.data) - tvz.decode_vec_float(base2k, want)
    err -= np.round(err)
    # the keyswitch noise: a 2^17 digit times the key noise 2^-68·3.2, over N·dnum terms
    assert np.abs(err).max() < 2.0**-40, np.log2(np.abs(err).max())


# ---- the plain versions of the two kernels ------------------------------------------

@pytest.mark.parametrize("bits", [28, 30])
def test_plain_tensor_product_matches_jax(bits):
    """fused_tensor_product_ref == glwe_tensor_product_big + big_normalize
    (tests/test_fused.py's check), and == the Pallas kernel in interpret mode
    on the lazy (28-bit) basis."""
    from jax.experimental.pallas import tpu as pltpu

    from poulpy_tpu.backends import pallas_fused as pf

    name = f"rank1_{bits}"
    tm, _, tsk, (ta, tb) = _setup(name)
    jm, _, (ja, jb) = _jax(name, tsk, (ta, tb))
    conv_size, dnum = ta.size + tb.size - 1, 4

    @jax.jit
    def jnp_flow(a, b):
        lin, quad = jops.glwe_tensor_product_big(jm, a, b, conv_size)
        return jdft.big_normalize(jm, dnum, 17, quad[(0, 0)], 17), jnp.stack(lin, axis=-3)

    d_want, lin_want = jnp_flow(ja, jb)
    d, lin64 = tfused.fused_tensor_product_ref(tm, ta.data, tb.data, conv_size, dnum, 17, 17)
    assert _eq(d, d_want) and _eq(lin64, lin_want)
    if bits == 28:
        with pltpu.force_tpu_interpret_mode():
            d_k, lin_k = pf.fused_tensor_product(jm, ja.data, jb.data, conv_size, dnum, 17, 17,
                                                 t_tile=1)
        assert _eq(d, d_k) and _eq(lin64, lin_k)


@pytest.mark.parametrize("bits", [28, 30])
@pytest.mark.parametrize("s64,psize", [(7, 4), (3, 4)], ids=["s64_gt_psize", "s64_lt_psize"])
def test_plain_small64_matches_pallas(bits, s64, psize):
    """fused_glwe_product_ref(small64=…) == the Pallas kernel's small64
    pattern in interpret mode, the linear terms longer or shorter than the
    product."""
    from jax.experimental.pallas import tpu as pltpu

    from poulpy_tpu.backends.pallas_fused import fused_glwe_product

    jm, tm = j_get_module(N, 2, bits), t_get_module(N, 2, bits, "cpu")
    rng = np.random.default_rng(61)
    a = rng.integers(-(2**16), 2**16, size=(3, 1, 4, N))
    pmat = np.stack([rng.integers(0, p, size=(4, 1, 2, psize, N)) for p in jm.basis.primes],
                    axis=-2).astype(np.int32)
    small64 = rng.integers(-(2**45), 2**45, size=(3, 2, s64, N))
    with pltpu.force_tpu_interpret_mode():
        want = fused_glwe_product(jm, jnp.asarray(a), jnp.asarray(pmat), 8, 17, 17,
                                  small64=jnp.asarray(small64), t_tile=1)
    have = tfused.fused_glwe_product_ref(tm, torch.from_numpy(a), torch.from_numpy(pmat), 8, 17,
                                         17, small64=torch.from_numpy(small64))
    assert _eq(have, want)


def test_cpu_relinearize_wrappers_take_the_plain_version():
    tm = t_get_module(N, 2, 28, "cpu")
    rng = np.random.default_rng(62)
    a, b = (torch.from_numpy(rng.integers(-(2**16), 2**16, size=(2, 2, 3, N))) for _ in range(2))
    pmat = torch.from_numpy(np.stack([rng.integers(0, p, size=(4, 1, 2, 4, N))
                                      for p in tm.basis.primes], axis=-2).astype(np.int32))
    before = dict(LAUNCHES)
    d, lin = tfused.fused_tensor_product(tm, a, b, 5, 4, 17, 17)
    want_d, want_lin = tfused.fused_tensor_product_ref(tm, a, b, 5, 4, 17, 17)
    assert torch.equal(d, want_d) and torch.equal(lin, want_lin)
    have = tfused.fused_glwe_product(tm, d[:, None], pmat, 6, 17, 17, small64=lin)
    assert torch.equal(have, tfused.fused_glwe_product_ref(tm, d[:, None], pmat, 6, 17, 17,
                                                           small64=lin))
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="not both"):
        tfused.fused_glwe_product(tm, d[:, None], pmat, 6, 17, 17, small=d, small64=lin)


# ---- the chip_smoke.py relinearize and rotation fingerprints -------------------------

def _fingerprints(pkg: str) -> dict:
    """chip_smoke.py's CKKS set-up (bench_full.py's bench_ckks_mul seeds),
    then glwe_tensor_relinearize of its pair and rotate / conjugate of c1
    with the automorphism keys of galois_element(1) and −1 from Source 0x05 /
    0x06: sum(|data| mod 65536) of each."""
    import chip_smoke
    from poulpy_tpu.ckks import ops as jck
    from poulpy_tpu.ckks.encoder import Encoder as JEncoder
    from poulpy_tpu_torch.ckks import ops as tck
    from poulpy_tpu_torch.ckks.encoder import Encoder as TEncoder

    c = chip_smoke.CKKS
    if pkg == "jax":
        m, S, ck, enc, prep, ops, E, kw = (j_get_module(c.n, c.nprimes, 28), JSource, jck, jenc,
                                           jprep, jops, JEncoder, {})
    else:
        m, S, ck, enc, prep, ops, E, kw = (t_get_module(c.n, c.nprimes, 28, "cpu"), TSource, tck,
                                           tenc, tprep, tops, TEncoder, {"device": "cpu"})
    sk = enc.secret_new(m, 1, S(bytes(32)))
    skp = prep.glwe_secret_prepare(m, sk)
    xe, xa = S(b"\x01" * 32), S(b"\x02" * 32)
    tsk = prep.glwe_tensor_key_prepare(m, enc.glwe_tensor_key_encrypt_sk(
        m, sk, skp, c.base2k, c.k_key, dnum=c.dnum, source_xe=xe, source_xa=xa))
    rng = np.random.default_rng(c.seed)
    z = rng.normal(size=c.n // 2) + 1j * rng.normal(size=c.n // 2)
    pt = ck.encode(E(c.n), z, c.base2k, c.k_ct, c.log_delta, c.log_budget, **kw)
    c1, c2 = (ck.encrypt_sk(m, pt, skp, c.k_ct, xe, xa) for _ in range(2))
    out = {"relinearize": ops.glwe_tensor_relinearize(m, c1.glwe, c2.glwe, tsk).data}
    xe, xa = S(b"\x05" * 32), S(b"\x06" * 32)
    for name, p in (("rotate", m.galois_element(1)), ("conjugate", -1)):
        key, _ = enc.glwe_automorphism_key_encrypt_sk(m, p, sk, c.base2k, c.k_key, dnum=c.dnum,
                                                      source_xe=xe, source_xa=xa)
        akp = prep.GLWEAutomorphismKeyPrepared(key=prep.gglwe_prepare(m, key), p=p)
        out[name] = getattr(ck, name)(m, c1, akp).glwe.data
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in out.items()}


@pytest.mark.slow
def test_relinearize_and_rotation_fingerprints_full_config():
    import chip_smoke

    want, have = _fingerprints("jax"), _fingerprints("torch")
    expected = {"relinearize": chip_smoke.RELIN_FINGERPRINT,
                "rotate": chip_smoke.ROTATE_FINGERPRINT,
                "conjugate": chip_smoke.CONJUGATE_FINGERPRINT}
    for name, value in expected.items():
        assert int((np.abs(want[name]) % 65536).sum()) == value, name
        assert np.array_equal(have[name], want[name]), name
