"""poulpy_tpu_torch.binfhe against poulpy_tpu.binfhe, bit for bit, and the gate
bootstrap as a whole.

The same seeds go through both packages: `gates.keygen` → `encrypt_bit` →
`gate_nand` → `decrypt_bit`, on the block-binary and on the standard blind
rotation path, on the prime bases get_module(64, 2, 28) and (64, 4, 30) as
tests/test_binfhe.py uses them.  Every comparison is `np.array_equal`
(tolerance 0).  Port objects are made on the CPU.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poulpy_tpu.binfhe import blind_rotation as jbr
from poulpy_tpu.binfhe import gates as jgates
from poulpy_tpu.binfhe import lut as jlut
from poulpy_tpu.core.layouts import LWECiphertext as JLWE
from poulpy_tpu.hal.module import get_module as j_get_module
from poulpy_tpu.hal.source import Source as JSource
from poulpy_tpu_torch.binfhe import blind_rotation as tbr
from poulpy_tpu_torch.binfhe import gates as tgates
from poulpy_tpu_torch.binfhe import lut as tlut
from poulpy_tpu_torch.core.layouts import LWECiphertext as TLWE
from poulpy_tpu_torch.hal.module import get_module as t_get_module
from poulpy_tpu_torch.hal.source import Source as TSource
from poulpy_tpu_torch.utils import interop

N_GLWE, N_LWE, BLOCK = 64, 16, 4
BASES = [(2, 28), (4, 30)]
BITS1 = np.array([0, 0, 1, 1])
BITS2 = np.array([0, 1, 0, 1])
GATES = [
    ("nand", lambda a, b: 1 - (a & b)),
    ("and", lambda a, b: a & b),
    ("or", lambda a, b: a | b),
    ("nor", lambda a, b: 1 - (a | b)),
    ("xor", lambda a, b: a ^ b),
    ("xnor", lambda a, b: 1 - (a ^ b)),
]


def _eq(have, want):
    have = have.cpu().numpy() if isinstance(have, torch.Tensor) else np.asarray(have)
    want = np.asarray(want)
    return have.shape == want.shape and np.array_equal(have, want)


def _params(pkg, nprimes, bits, block):
    return pkg.GateParams(n_glwe=N_GLWE, n_lwe=N_LWE, nprimes=nprimes, prime_bits=bits,
                          block_size=block)


@functools.partial(jax.jit, static_argnums=0)
def _j_keys(params):
    keys, sk = jgates.keygen(params)
    return keys.brk, keys.to_lwe, keys.lut, sk


def _j_keygen(params):
    """The JAX package's `gates.keygen` under jax.jit (its eager key
    preparation compiles for most of a minute per basis on the CPU; the
    draws happen while tracing, as in the eager call), its BootstrapKeys
    rebuilt around the jitted keys."""
    brk, to_lwe, lut, sk = _j_keys(params)
    module = jgates.Module(params.n_glwe, params.nprimes, params.prime_bits)
    return jgates.BootstrapKeys(module=module, params=params, brk=brk, to_lwe=to_lwe,
                                lut=lut), np.asarray(sk)


@pytest.fixture(scope="module", params=[(b, blk) for b in BASES for blk in (BLOCK, 1)],
                ids=lambda p: f"P{p[0][0]}-{p[0][1]}bit-block{p[1]}")
def gate_runs(request):
    """keygen → encrypt_bit → gate_nand in both packages from the same seeds."""
    (nprimes, bits), block = request.param
    out = {}
    for name, pkg, src, keygen in (("jax", jgates, JSource, _j_keygen),
                                   ("torch", tgates, TSource,
                                    functools.partial(tgates.keygen, device="cpu"))):
        params = _params(pkg, nprimes, bits, block)
        keys, sk = keygen(params)
        c1 = pkg.encrypt_bit(params, BITS1, sk, src(b"\x05" * 32), src(b"\x06" * 32))
        c2 = pkg.encrypt_bit(params, BITS2, sk, src(b"\x07" * 32), src(b"\x08" * 32))
        out[name] = dict(params=params, keys=keys, sk=sk, c1=c1, c2=c2,
                         nand=pkg.gate_nand(keys, c1, c2))
    return out["jax"], out["torch"]


# ---- tables, mod switch, LUT ---------------------------------------------------

@pytest.mark.parametrize("nprimes,bits", BASES)
def test_xpow_tables(nprimes, bits):
    primes = j_get_module(N_GLWE, nprimes, bits).basis.primes
    assert primes == t_get_module(N_GLWE, nprimes, bits, "cpu").basis.primes
    assert _eq(tbr._xpow_table(N_GLWE, primes), jbr._xpow_table(N_GLWE, primes))
    assert _eq(tbr._xpow_minus1_table(N_GLWE, primes), jbr._xpow_minus1_table(N_GLWE, primes))


@pytest.mark.parametrize("base2k,size", [(17, 2), (8, 3), (5, 4)])
def test_mod_switch_2n(base2k, size):
    """Both rotation directions, negative phases, and the multi-limb branch
    (base2k ≤ log2(2N) + 1)."""
    rng = np.random.default_rng(31)
    half = 1 << (base2k - 1)
    data = rng.integers(-half, half, (3, size, N_LWE + 1))
    data[0, 0, :4] = [-half, half - 1, -1, 0]
    for rot_dir in ("left", "right"):
        want = jbr.mod_switch_2n(2 * N_GLWE, JLWE(data=jnp.asarray(data), base2k=base2k, k=34),
                                 rot_dir)
        have = tbr.mod_switch_2n(2 * N_GLWE, TLWE(data=torch.from_numpy(data), base2k=base2k,
                                                  k=34), rot_dir)
        assert _eq(have, want)


@pytest.mark.parametrize("f_len,f_k,rot_dir", [(8, 6, "left"), (32, 10, "right"), (5, 17, "left")])
def test_lookup_table_new(f_len, f_k, rot_dir):
    f = np.arange(f_len, dtype=np.int64) - f_len // 3
    want = jlut.lookup_table_new(N_GLWE, 17, 34, f, f_k, rot_dir=rot_dir)
    have = tlut.lookup_table_new(N_GLWE, 17, 34, f, f_k, rot_dir=rot_dir, device="cpu")
    assert _eq(have.data, want.data)
    assert (have.drift, have.rot_dir, have.size, have.k) == (want.drift, want.rot_dir, want.size,
                                                             want.k)
    assert _eq(tlut.lookup_table_rotate(have, -7).data, jlut.lookup_table_rotate(want, -7).data)
    # the LUT over two polynomials (domain 2N) and its rotation
    want = jlut.lookup_table_new(N_GLWE, 17, 34, f, f_k, extension_factor=2, rot_dir=rot_dir)
    have = tlut.lookup_table_new(N_GLWE, 17, 34, f, f_k, extension_factor=2, rot_dir=rot_dir,
                                 device="cpu")
    assert _eq(have.data, want.data) and have.drift == want.drift
    assert _eq(tlut.lookup_table_rotate(have, -7).data, jlut.lookup_table_rotate(want, -7).data)


# ---- keys, encryption, blind rotation --------------------------------------------

def test_gate_keygen(gate_runs):
    """BRK pmats (= blind_rotation_key_encrypt_sk), KSK pmat, LUT and secret."""
    j, t = gate_runs
    assert _eq(t["sk"], j["sk"])
    assert _eq(t["keys"].brk.pmats, j["keys"].brk.pmats)
    assert (t["keys"].brk.base2k, t["keys"].brk.k) == (j["keys"].brk.base2k, j["keys"].brk.k)
    assert _eq(t["keys"].to_lwe.pmat, j["keys"].to_lwe.pmat)
    assert _eq(t["keys"].lut.data, j["keys"].lut.data)


def test_encrypt_bit(gate_runs):
    j, t = gate_runs
    for c in ("c1", "c2"):
        assert _eq(t[c].data, j[c].data) and (t[c].base2k, t[c].k) == (j[c].base2k, j[c].k)
    assert _eq(tgates.decrypt_bit(t["c1"], t["sk"]), BITS1)


def test_blind_rotation_paths(gate_runs):
    """Both execute functions on the same LWEs (the encrypted bits): the
    key's own path, and the standard path on block-binary keys too (a
    block-binary secret is a binary one)."""
    j, t = gate_runs
    jk, tk = j["keys"], t["keys"]
    jl, tl = j["c1"], t["c1"]
    want = jbr.blind_rotation_execute(jk.module, jl, jk.lut, jk.brk)
    assert _eq(tbr.blind_rotation_execute(tk.module, tl, tk.lut, tk.brk), want)
    block = t["params"].block_size
    if block > 1:
        want = jbr.blind_rotation_execute_block(jk.module, jl, jk.lut, jk.brk, block)
        have = tbr.blind_rotation_execute_block(tk.module, tl, tk.lut, tk.brk, block)
        assert _eq(have, want)
        assert _eq(tbr.blind_rotation_dispatch(tk.module, tl, tk.lut, tk.brk, block), want)


# ---- the slice as a whole ----------------------------------------------------------

def test_gate_nand_slice(gate_runs):
    """keygen → encrypt → NAND → decrypt: equal output LWEs, equal bits, and
    the NAND truth table."""
    j, t = gate_runs
    assert _eq(t["nand"].data, j["nand"].data)
    have = tgates.decrypt_bit(t["nand"], t["sk"])
    assert _eq(have, jgates.decrypt_bit(j["nand"], j["sk"]))
    assert np.array_equal(have, 1 - (BITS1 & BITS2))


@pytest.mark.parametrize("gate,table", GATES, ids=[g for g, _ in GATES])
def test_gate_truth_tables(gate_runs, gate, table):
    _, t = gate_runs
    out = getattr(tgates, f"gate_{gate}")(t["keys"], t["c1"], t["c2"])
    assert np.array_equal(tgates.decrypt_bit(out, t["sk"]), table(BITS1, BITS2))
    assert np.array_equal(tgates.decrypt_bit(tgates.gate_not(t["keys"], out), t["sk"]),
                          1 - table(BITS1, BITS2))


def test_jax_gate_keys_through_interop(gate_runs):
    """JAX-made keys and ciphertexts, carried into the port, give the JAX
    package's NAND."""
    j, _ = gate_runs
    keys = interop.from_fields(*interop.to_fields(j["keys"]), device="cpu")
    assert isinstance(keys, tgates.BootstrapKeys)
    assert dataclasses.asdict(keys.params) == dataclasses.asdict(j["params"])
    c1, c2 = (interop.from_fields(*interop.to_fields(j[c]), device="cpu") for c in ("c1", "c2"))
    out = tgates.gate_nand(keys, c1, c2)
    assert _eq(out.data, j["nand"].data)
    name, fields = interop.to_fields(keys)
    assert name == "BootstrapKeys" and _eq(fields["brk"][1]["pmats"], j["keys"].brk.pmats)


def test_keygen_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tgates.keygen(_params(tgates, 2, 28, BLOCK))


# ---- the chip_smoke.py gate fingerprint ----------------------------------------------

@pytest.mark.slow
def test_gate_fingerprint_full_config():
    """chip_smoke.py's gate fingerprint: sum(|data| mod 65536) of the NAND at
    bench_full.py's gate configuration and seeds, batch 1024, recomputed by
    the JAX package on the CPU (a few minutes, a few GB); the port, whose
    plain path is far slower on the CPU, gives the same data on the first
    16 rows (chip_smoke.py checks the port's whole batch on the card)."""
    import chip_smoke

    b1 = np.random.default_rng(0).integers(0, 2, chip_smoke.GATE_BATCH)
    b2 = np.random.default_rng(1).integers(0, 2, chip_smoke.GATE_BATCH)
    outs = {}
    for pkg, src, rows, kw in ((jgates, JSource, chip_smoke.GATE_BATCH, {}),
                               (tgates, TSource, 16, {"device": "cpu"})):
        params = pkg.GateParams(n_lwe=chip_smoke.GATE_N_LWE, block_size=chip_smoke.GATE_BLOCK)
        keys, sk = pkg.keygen(params, bytes(32), **kw)
        xe, xa = src(b"\x05" * 32), src(b"\x06" * 32)
        c1 = pkg.encrypt_bit(params, b1, sk, xe, xa)
        c2 = pkg.encrypt_bit(params, b2, sk, xe, xa)
        out = pkg.gate_nand(keys, c1.replace(data=c1.data[:rows]), c2.replace(data=c2.data[:rows]))
        assert np.array_equal(pkg.decrypt_bit(out, sk), 1 - (b1[:rows] & b2[:rows]))
        outs[pkg] = np.asarray(out.data)
    assert int((np.abs(outs[jgates]) % 65536).sum()) == chip_smoke.GATE_FINGERPRINT
    assert np.array_equal(outs[tgates], outs[jgates][:16])
