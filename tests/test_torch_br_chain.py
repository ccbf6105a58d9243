"""The block blind rotation's chained steps: `fused_br_block_step(steps=…)`
and the grouping of `blind_rotation_execute_block`, against the JAX package.

The JAX package launches its block step over spans of `steps` whole blocks
(`POULPY_TPU_BR_STEPS`, default 2; `pallas_fused.fused_br_block_step(...,
steps)`), the accumulator kept on chip between them, and runs the nblocks %
steps trailing blocks one per launch.  Here, on the CPU, tolerance 0: the
port's plain chain against the JAX kernel's chain in interpret mode (as
tests/test_fused.py runs it); the port's block blind rotation, 3 blocks
making one pair and one remainder, against the JAX package's called at its
defaults (on the CPU its jnp path, which tests/test_binfhe.py's
`test_block_rotation_steps_span_bit_exact` holds equal to its fused branch
at steps 2, pairs and remainder; that branch in interpret mode compiles
for about 25 s, so it is not run again here); spies on the plain versions
show the port's grouping, and one launch per block on the "fused_mxu"
route, as the JAX package's MXU branch keeps.  The keys are made by the
port and carried to the JAX package through `interop.to_fields`.

The chained kernel itself: tests/test_torch_cuda_emu.py (emulated, bit for
bit) and tests/test_torch_kernels.py (`-m cuda`, on the card).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from poulpy_tpu.backends import pallas_fused as jpf
from poulpy_tpu.binfhe import blind_rotation as jbr
from poulpy_tpu.binfhe import lut as jlut
from poulpy_tpu.core.layouts import LWECiphertext as JLWE
from poulpy_tpu.hal.module import get_module as j_get_module
from poulpy_tpu_torch.backends import fused as tfused
from poulpy_tpu_torch.binfhe import blind_rotation as tbr
from poulpy_tpu_torch.binfhe import gates as tgates
from poulpy_tpu_torch.hal.module import get_module as t_get_module
from poulpy_tpu_torch.hal.source import Source as TSource
from poulpy_tpu_torch.utils import interop
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

N_LWE, BLOCK = 12, 4                   # 3 blocks: one pair, one remainder
BITS1 = np.array([0, 1, 1])


def _residues(rng, primes, shape):
    """Random standard-form residues [..., P, N] (int32)."""
    out = np.zeros(shape, dtype=np.int64)
    for i, p in enumerate(primes):
        out[..., i, :] = rng.integers(0, p, size=shape[:-2] + shape[-1:])
    return out.astype(np.int32)


# ---- (a) the plain chain against the JAX kernel's ------------------------------------

@pytest.mark.parametrize("rot_mode", [0, 2])
def test_plain_chain_matches_pallas(rot_mode):
    """`fused_br_block_step_ref(steps=2)` (and the CPU wrapper) equals the
    JAX package's one `steps=2` launch, with the x-power on the VMP's output
    (0) or input rows (2, the default), at tests/test_fused.py's shape."""
    n, nprimes, base2k, cols, size, rows, psize, block, batch = 128, 2, 17, 2, 3, 3, 4, 4, 3
    jm = j_get_module(n, nprimes, 28)
    rng = np.random.default_rng(71)
    acc = rng.integers(-(2**16), 2**16, size=(batch, cols, size, n), dtype=np.int64)
    pmats = _residues(rng, jm.basis.primes, (2 * block, rows, cols, cols, psize, nprimes, n))
    amounts = rng.integers(-n, 3 * n, size=(batch, 2 * block), dtype=np.int64)
    amounts[0, :3] = [-n, 2 * n, 4 * n - 1]
    with pltpu.force_tpu_interpret_mode():
        pm_k = jnp.swapaxes(jpf.pm_kernel_layout(jnp.asarray(pmats), min(rows, size)), 0, 1)
        xp = jnp.take(jbr._xpow_minus1_table(n, jm.basis.primes), amounts & (2 * n - 1), axis=0)
        want = np.asarray(jpf.fused_br_block_step(jm, jnp.asarray(acc), pm_k,
                                                  xp.astype(jnp.int32), size, base2k,
                                                  t_tile=1, rot_mode=rot_mode, steps=2))
    m = t_get_module(n, nprimes, 28, "cpu")
    args = (m, torch.from_numpy(acc), torch.from_numpy(pmats), torch.from_numpy(amounts), size,
            base2k)
    assert np.array_equal(tfused.fused_br_block_step_ref(*args, steps=2).numpy(), want)
    assert np.array_equal(tfused.fused_br_block_step(*args, steps=2).numpy(), want)


def test_chain_checks_its_shapes():
    """A chain needs steps dividing the key elements and size == res_size
    (the JAX kernel's assertions), on the CPU as on the card."""
    m = t_get_module(64, 2, 28, "cpu")
    rng = np.random.default_rng(72)
    acc = torch.from_numpy(rng.integers(-(2**16), 2**16, size=(2, 2, 3, 64)))
    pmats = torch.from_numpy(_residues(rng, m.basis.primes, (6, 3, 2, 2, 4, 2, 64)))
    amounts = torch.from_numpy(rng.integers(0, 128, size=(2, 6)))
    with pytest.raises(ValueError, match="does not divide"):
        tfused.fused_br_block_step(m, acc, pmats, amounts, 3, 17, steps=4)
    with pytest.raises(ValueError, match="size == res_size"):
        tfused.fused_br_block_step(m, acc, pmats, amounts, 2, 17, steps=2)
    assert tfused.chain_steps(m, acc, pmats, 3, 3, 2) == 2      # the plain version chains any shape


# ---- (b)–(d) the block blind rotation --------------------------------------------------

def _to_jax(name, fields):
    """The JAX package's object of `interop.to_fields`'s (name, fields)."""
    cls = {"BlindRotationKeyPrepared": jbr.BlindRotationKeyPrepared,
           "LookupTable": jlut.LookupTable, "LWECiphertext": JLWE}[name]
    return cls(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                  for k, v in fields.items()})


def _gate(n):
    params = tgates.GateParams(n_glwe=n, n_lwe=N_LWE, nprimes=2, prime_bits=28,
                               block_size=BLOCK)
    keys, sk = tgates.keygen(params, device="cpu")
    lwe = tgates.encrypt_bit(params, BITS1, sk, TSource(b"\x15" * 32), TSource(b"\x16" * 32))
    return keys, lwe


@pytest.fixture(scope="module")
def gate64():
    return _gate(64)


@pytest.fixture
def ref_calls(monkeypatch):
    """(steps, key elements) of each call of the plain block step, which
    the CPU wrapper runs for every launch."""
    calls = []
    ref = tfused.fused_br_block_step_ref

    def spy(module, acc, pmats, a_blk, res_size, base2k, steps=1, *rest):
        calls.append((steps, pmats.shape[0]))
        return ref(module, acc, pmats, a_blk, res_size, base2k, steps, *rest)

    monkeypatch.setattr(tfused, "fused_br_block_step_ref", spy)
    return calls


def test_block_rotation_matches_jax_default(gate64, monkeypatch):
    """The port's block blind rotation (one chain for the pair of blocks,
    one single step for the remainder) equals the JAX package's at its
    defaults."""
    keys, lwe = gate64
    for var in ("POULPY_TPU_BR_STEPS", "POULPY_TPU_ROT_MODE", "POULPY_TPU_FUSED_MXU"):
        monkeypatch.delenv(var, raising=False)
    jm = j_get_module(keys.module.n, 2, 28)
    jbrk, jlut_, jlwe = (_to_jax(*interop.to_fields(x)) for x in (keys.brk, keys.lut, lwe))
    want = np.asarray(jbr.blind_rotation_execute_block(jm, jlwe, jlut_, jbrk, BLOCK))
    have = tbr.blind_rotation_execute_block(keys.module, lwe, keys.lut, keys.brk, BLOCK)
    assert np.array_equal(have.numpy(), want)


def test_block_rotation_groups_pairs_then_remainder(gate64, ref_calls):
    """BR_STEPS blocks per call, the trailing nblocks % BR_STEPS one per call;
    a single block runs alone."""
    keys, lwe = gate64
    assert tbr.BR_STEPS == 2
    tbr.blind_rotation_execute_block(keys.module, lwe, keys.lut, keys.brk, BLOCK)
    assert ref_calls == [(2, 2 * BLOCK), (1, BLOCK)]
    ref_calls.clear()
    tbr.blind_rotation_execute_block(keys.module, lwe, keys.lut, keys.brk, N_LWE)
    assert ref_calls == [(1, N_LWE)]


def test_fused_mxu_route_runs_one_block_per_call(ref_calls, monkeypatch):
    """The "fused_mxu" route keeps one block per launch of its kernel, as the
    JAX package's MXU branch forces steps 1, and equals the butterfly
    route's chain."""
    keys, lwe = _gate(256)                   # N 256: the MXU route's smallest N
    calls = []
    mxu_step = tbr.fused_mxu_br_block_step

    def spy(module, acc, pmats, *args):
        calls.append(pmats.shape[0])
        return mxu_step(module, acc, pmats, *args)

    monkeypatch.setattr(tbr, "fused_mxu_br_block_step", spy)
    have = tbr.blind_rotation_execute_block(keys.module, lwe, keys.lut, keys.brk, BLOCK,
                                            route="fused_mxu")
    assert calls == [BLOCK] * (N_LWE // BLOCK) and ref_calls == []
    want = tbr.blind_rotation_execute_block(keys.module, lwe, keys.lut, keys.brk, BLOCK)
    assert ref_calls == [(2, 2 * BLOCK), (1, BLOCK)]
    assert torch.equal(have, want)
