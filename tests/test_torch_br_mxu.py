"""The blind rotation's MXU branches (`route="fused_mxu"`) and the fused
kernels' shared and global layouts.

CPU part: seeded inputs through both packages, tolerance 0, against the
JAX package's jnp path (its default on the CPU, which its own tests hold
bit-exact to its Pallas kernels): the plain MXU block step, both blind
rotation paths and a NAND through the route, at one prime base
(`get_module(256, 2, 28)`: N 256, the smallest N of the MXU route), n_lwe
16, block 4, batch 4.  The keys are made by the port, whose keygen equals
the JAX package's (tests/test_torch_binfhe.py), and carried to the JAX
package through `interop.to_fields`: the JAX package's keygen alone takes
over a minute at N 256 on the CPU.  Then the route guard and each wrapper's
layout choice, as pure Python.

CUDA part (`-m cuda`): in tests/test_torch_kernels.py and
tests/test_torch_mxu.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poulpy_tpu.binfhe import blind_rotation as jbr
from poulpy_tpu.binfhe import gates as jgates
from poulpy_tpu.binfhe import lut as jlut
from poulpy_tpu.core import prepared as jprep
from poulpy_tpu.core.layouts import LWECiphertext as JLWE
from poulpy_tpu.hal import dft as jdft
from poulpy_tpu.hal.module import Module as JModule
from poulpy_tpu.hal.ntt import mont_mul as j_mont_mul
from poulpy_tpu_torch.backends import fused as tfused
from poulpy_tpu_torch.backends import fused_mxu as tfm
from poulpy_tpu_torch.backends import wide as twide
from poulpy_tpu_torch.binfhe import blind_rotation as tbr
from poulpy_tpu_torch.binfhe import gates as tgates
from poulpy_tpu_torch.hal.module import get_module as t_get_module
from poulpy_tpu_torch.hal.source import Source as TSource
from poulpy_tpu_torch.utils import interop

N, NPRIMES, BITS, N_LWE, BLOCK, BASE2K = 256, 2, 28, 16, 4, 17
BITS1 = np.array([0, 0, 1, 1])
BITS2 = np.array([0, 1, 0, 1])


def _residues(rng, primes, shape):
    """Random standard-form residues [..., P, N] (int32)."""
    out = np.zeros(shape, dtype=np.int64)
    for i, p in enumerate(primes):
        out[..., i, :] = rng.integers(0, p, size=shape[:-2] + shape[-1:])
    return out.astype(np.int32)


# ---- the plain MXU block step ------------------------------------------------------

@pytest.mark.parametrize("size,rows,psize,res_size", [
    (2, 4, 4, 2),     # the gate's accumulator and key (k_ct 34, k_brk 68, dnum 4)
    (3, 3, 4, 3),     # tests/test_fused_mxu.py's block-step shape
])
def test_plain_mxu_block_step_matches_jax(size, rows, psize, res_size):
    """`fused_mxu_br_block_step_ref` (and the CPU wrapper) against the JAX
    package's jnp block step (tests/test_fused_mxu.py's reference, with the
    block path's `a & (2N − 1)`), amounts of both signs and past 2N."""
    m = t_get_module(N, NPRIMES, BITS, "cpu")
    jm = JModule(N, NPRIMES, BITS)
    rng = np.random.default_rng(61)
    acc = rng.integers(-(2**16), 2**16, size=(4, 2, size, N))
    pmats = _residues(rng, m.basis.primes, (BLOCK, rows, 2, 2, psize, NPRIMES, N))
    amounts = rng.integers(-2 * N, 4 * N, size=(4, BLOCK))
    amounts[:3, 0] = [-N, 2 * N, 4 * N - 1]

    xpow = jnp.asarray(jbr._xpow_table(N, jm.basis.primes))
    t = jm.tables

    @jax.jit
    def block_step(acc, pmats, amounts):
        acc_dft = jdft.dft_apply(jm, acc)
        add_dft = None
        for i in range(BLOCK):
            vmp = jdft.vmp_apply(jm, acc_dft, pmats[i])
            xp = jnp.take(xpow, amounts[:, i] & (2 * N - 1), axis=0)
            rot = j_mont_mul(vmp, xp[:, None, None], t.p[:, None], t.qinv[:, None])
            term = jdft.dft_sub(jm, rot, vmp)
            add_dft = term if add_dft is None else jdft.dft_add(jm, add_dft, term)
        big = jdft.idft_apply(jm, add_dft)
        big = big + jdft._align_limbs(acc, big, big.shape[-2], limb_axis=-2)[0]
        return jdft.big_normalize(jm, res_size, BASE2K, big, BASE2K)

    want = np.asarray(block_step(jnp.asarray(acc), jnp.asarray(pmats), jnp.asarray(amounts)))

    args = (m, torch.from_numpy(acc), torch.from_numpy(pmats), torch.from_numpy(amounts),
            res_size, BASE2K)
    assert np.array_equal(tfm.fused_mxu_br_block_step_ref(*args).numpy(), want)
    assert np.array_equal(tfm.fused_mxu_br_block_step(*args).numpy(), want)


# ---- the blind rotation and a NAND through the route ---------------------------------

_JAX_CLASSES = {"BlindRotationKeyPrepared": jbr.BlindRotationKeyPrepared,
                "GGLWEPrepared": jprep.GGLWEPrepared, "LookupTable": jlut.LookupTable,
                "LWECiphertext": JLWE}


def _to_jax(name, fields):
    """The JAX package's object of `interop.to_fields`'s (name, fields)."""
    if name == "BootstrapKeys":
        params = jgates.GateParams(**fields["params"])
        keys = {key: _to_jax(*fields[key]) for key in ("brk", "to_lwe", "lut")}
        return jgates.BootstrapKeys(module=JModule(params.n_glwe, params.nprimes,
                                                   params.prime_bits), params=params, **keys)
    return _JAX_CLASSES[name](**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                 for k, v in fields.items()})


@pytest.fixture(scope="module")
def gate():
    """The port's keys and bits at N 256 (block 4), the same objects in the
    JAX package, and the JAX package's blind rotations and NAND on them."""
    params = tgates.GateParams(n_glwe=N, n_lwe=N_LWE, nprimes=NPRIMES, prime_bits=BITS,
                               block_size=BLOCK)
    keys, sk = tgates.keygen(params, device="cpu")
    c1 = tgates.encrypt_bit(params, BITS1, sk, TSource(b"\x05" * 32), TSource(b"\x06" * 32))
    c2 = tgates.encrypt_bit(params, BITS2, sk, TSource(b"\x07" * 32), TSource(b"\x08" * 32))
    jk, jc1, jc2 = (_to_jax(*interop.to_fields(x)) for x in (keys, c1, c2))
    assert dataclasses.asdict(jk.params) == dataclasses.asdict(params)
    want = {
        "block": np.asarray(jbr.blind_rotation_execute_block(jk.module, jc1, jk.lut, jk.brk,
                                                             BLOCK)),
        "standard": np.asarray(jbr.blind_rotation_execute(jk.module, jc1, jk.lut, jk.brk)),
        "nand": np.asarray(jgates.gate_nand(jk, jc1, jc2).data),
    }
    return keys, sk, c1, c2, want


@pytest.fixture
def mxu_calls(monkeypatch):
    """Counts of the MXU wrappers' calls from the blind rotation (on the
    CPU they run their plain versions and count no launch)."""
    calls = {"fused_mxu_br_block_step": 0, "fused_mxu_glwe_product": 0}
    for name in calls:
        fn = getattr(tbr, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(tbr, name, counted)
    return calls


@pytest.mark.parametrize("route", ["fused_mxu", "mxu"])
def test_block_path_matches_jax(gate, mxu_calls, route):
    """The block path through the route equals the JAX package's; "fused_mxu"
    runs one MXU block step per block, "mxu" none (the butterfly kernel)."""
    keys, _, c1, _, want = gate
    have = tbr.blind_rotation_execute_block(keys.module, c1, keys.lut, keys.brk, BLOCK,
                                            route=route)
    assert np.array_equal(have.numpy(), want["block"])
    steps = N_LWE // BLOCK if route == "fused_mxu" else 0
    assert mxu_calls == {"fused_mxu_br_block_step": steps, "fused_mxu_glwe_product": 0}


@pytest.mark.parametrize("route", ["fused_mxu", "mxu"])
def test_standard_path_matches_jax(gate, mxu_calls, route):
    """The standard path through the route on the same (block-binary, so
    binary) key equals the JAX package's: one MXU product per coefficient."""
    keys, _, c1, _, want = gate
    have = tbr.blind_rotation_dispatch(keys.module, c1, keys.lut, keys.brk, 1, route=route)
    assert np.array_equal(have.numpy(), want["standard"])
    products = N_LWE if route == "fused_mxu" else 0
    assert mxu_calls == {"fused_mxu_br_block_step": 0, "fused_mxu_glwe_product": products}


def test_nand_matches_jax(gate, mxu_calls):
    keys, sk, c1, c2, want = gate
    out = tgates.gate_nand(keys, c1, c2, route="fused_mxu")
    assert np.array_equal(out.data.numpy(), want["nand"])
    assert np.array_equal(tgates.decrypt_bit(out, sk), 1 - (BITS1 & BITS2))
    assert mxu_calls["fused_mxu_br_block_step"] == N_LWE // BLOCK


# ---- the route guard ---------------------------------------------------------------------

def test_br_route_guard():
    """The MXU branch exactly where the JAX package's `_use_fused_br` and
    `_use_mxu_br` both hold; the butterfly kernel elsewhere."""
    gate_m = t_get_module(1024, 2, 28, "cpu")
    assert tbr.br_route(gate_m, "fused_mxu", 4, 17, 1, 0) == "fused_mxu"       # the gate, block
    assert tbr.br_route(gate_m, "fused_mxu", 4, 17, 1, 568) == "fused_mxu"     # 17 + 10 ≤ 29
    assert tbr.br_route(gate_m, "fused", 4, 17, 1, 0) == "fused"
    assert tbr.br_route(gate_m, "mxu", 4, 17, 1, 0) == "fused"
    assert tbr.br_route(t_get_module(64, 2, 28, "cpu"), "fused_mxu", 4, 17, 1, 0) == "fused"
    m = t_get_module(N, 2, 28, "cpu")
    assert tbr.br_route(m, "fused_mxu", 4, 17, 2, 0) == "fused"                # dsize 2
    assert tbr.br_route(m, "fused_mxu", 4, 25, 1, N_LWE) == "fused"            # 25 + 5 > 29
    assert tbr.br_route(m, "fused_mxu", 4, 25, 1, 0) == "fused_mxu"            # the block path
    assert tbr.br_route(m, "fused_mxu", 4, 27, 1, 0) == "fused"                # base2k > 26
    with pytest.raises(ValueError):
        tbr.br_route(m, "tpu", 4, 17, 1, 0)


# ---- the layouts -------------------------------------------------------------------------

# (layout, today's shared memory, output columns per block) at every shape
# the paths of chip_smoke.py run
SHARED_SHAPES = {
    "fused_product": (tfused.product_layout(6, 2, 4, 2, 2048), 180224, 2),
    "fused_product_small@gate": (tfused.product_layout(2, 2, 3, 2, 1024), 57344, 2),
    "fused_product_small@keyswitch": (tfused.product_layout(3, 2, 4, 2, 2048), 155648, 2),
    "fused_product_small@ckks_rotate": (tfused.product_layout(6, 2, 6, 2, 2048), 147456, 1),
    "fused_product_small64": (tfused.product_layout(6, 2, 6, 2, 2048), 147456, 1),
    "br_block_step": (tfused.product_layout(4, 2, 4, 2, 1024, split=False), 81920, 2),
    "wide_product": (tfused.product_layout(2, 2, 3, 5, 2048), 139264, 1),
    "wide_tensor": (twide.tensor_wide_layout(2, 2, 3, 5, 2048), 188416, 1),
    "fused_mxu_product": (tfm.mxu_layout(6, 2, 4, 2, 2048), 215040, 2),
    "fused_mxu_product_small": (tfm.mxu_layout(3, 2, 4, 2, 2048), 215040, 2),
    "fused_mxu_product@gate_standard": (tfm.mxu_layout(4, 2, 4, 2, 1024), 115712, 2),
    "fused_mxu_br_block_step": (tfm.mxu_layout(4, 2, 4, 2, 1024, split=False), 115712, 2),
}


@pytest.mark.parametrize("name", SHARED_SHAPES)
def test_layout_shared_at_path_shapes(name):
    """Every shape the existing paths run keeps its shared layout, bytes
    and column split."""
    lay, smem, cpb = SHARED_SHAPES[name]
    assert (lay.kind, lay.smem, lay.cpb) == ("shared", smem, cpb)


# (layout, one column's shared bytes) at the shapes where the shared layout does not fit
GLOBAL_SHAPES = {
    "fused_product@8192": (tfused.product_layout(6, 2, 4, 2, 8192),
                           tfused.fused_smem_bytes(6, 4, 2, 8192), 458752),
    "fused_product_small@4096": (tfused.product_layout(6, 2, 6, 2, 4096),
                                 tfused.fused_smem_bytes(6, 6, 2, 4096), 294912),
    "br_block_step@4096": (tfused.product_layout(4, 2, 4, 2, 4096, split=False),
                           tfused.fused_smem_bytes(4, 8, 2, 4096), 327680),
    "wide_product@4096": (tfused.product_layout(2, 2, 3, 5, 4096),
                          tfused.fused_smem_bytes(2, 3, 5, 4096), 278528),
    "wide_tensor@4096": (twide.tensor_wide_layout(2, 2, 3, 5, 4096),
                         twide.wide_tensor_smem_bytes(2, 2, 3, 5, 4096), 376832),
    "fused_mxu_product@4096": (tfm.mxu_layout(6, 2, 4, 2, 4096),
                               tfm.fused_mxu_smem_bytes(6, 4, 2, 4096), 277504),
    "fused_mxu_br_block_step@4096": (tfm.mxu_layout(4, 2, 4, 2, 4096, split=False),
                                     tfm.fused_mxu_smem_bytes(4, 8, 2, 4096), 413696),
}


@pytest.mark.parametrize("name", GLOBAL_SHAPES)
def test_layout_global_past_shared_memory(name):
    """Where the shared layout does not fit, the global one: all columns in
    one task, a workspace slot of every residue row, a stage that fits."""
    lay, shared, expected = GLOBAL_SHAPES[name]
    assert shared == expected > tfused.SMEM_LIMIT
    assert lay.kind == "global" and lay.chunk >= 1 and lay.smem <= tfused.SMEM_LIMIT
    assert lay.cpb == (1 if name.startswith("wide_tensor") else 2) and lay.ws_rows > 0


def test_global_layout_geometry():
    """The stage of the butterfly kernels holds whole rows (7 at N 8192);
    the MXU kernel's holds the operand planes of its rows (3 at N 8192, 6 at
    N 4096); one row that does not fit raises."""
    lay = tfused.product_layout(6, 2, 4, 2, 8192)
    assert (lay.chunk, lay.smem, lay.ws_rows) == (7, 7 * 4 * 8192, 6 + 2 * 8)
    lay = tfm.mxu_layout(6, 2, 4, 2, 8192)
    assert (lay.chunk, lay.ws_rows) == (3, 22) and lay.smem == 3 * (128 * 272 + 64 * 528)
    assert tfm.mxu_layout(4, 2, 4, 2, 4096, split=False).chunk == 6
    with pytest.raises(ValueError, match="one row"):
        tfused.product_layout(6, 2, 4, 2, 65536)
