"""The block step's x-power by Shoup (rot_mode 1, the JAX package's
`POULPY_TPU_ROT_MODE=1`) and the "fused_rot_shoup" route, against the JAX
package on the CPU, tolerance 0.

rot_mode 1 multiplies each row of dft(acc) by the plain NTT(X^{a_i} − 1)
from the two-plane table [2N, 2, P, N] (the value and ⌊w·2^30/p⌋) with
Shoup's product, then runs the VMP (`pallas_fused.py:712-724`).  Here: the
port's own table against the JAX package's; the port's plain rot_mode 1
step, single and chained, against the JAX kernel's rot_mode 1 in interpret
mode (as tests/test_fused.py runs it); rot_mode 1 against rot_mode 2 in the
port's plain version; the wrapper's checks; a NAND on the route against
the default one at tests/test_torch_br_chain.py's size (N 64, 12 LWE
coefficients in blocks of 4).  The kernel's Shoup instances:
tests/test_torch_cuda_emu.py (emulated) and tests/test_torch_kernels.py
(`-m cuda`, on the card).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from poulpy_tpu.backends import pallas_fused as jpf
from poulpy_tpu.binfhe import blind_rotation as jbr
from poulpy_tpu.hal.module import get_module as j_get_module
from poulpy_tpu_torch.backends import fused as tfused
from poulpy_tpu_torch.backends.mxu_product import mxu_route
from poulpy_tpu_torch.binfhe import blind_rotation as tbr
from poulpy_tpu_torch.binfhe import gates as tgates
from poulpy_tpu_torch.hal.module import get_module as t_get_module
from poulpy_tpu_torch.hal.source import Source as TSource
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _residues(rng, primes, shape):
    """Random standard-form residues [..., P, N] (int32)."""
    out = np.zeros(shape, dtype=np.int64)
    for i, p in enumerate(primes):
        out[..., i, :] = rng.integers(0, p, size=shape[:-2] + shape[-1:])
    return out.astype(np.int32)


@pytest.mark.parametrize("n,prime_bits", [(64, 28), (128, 28), (128, 30)])
def test_shoup_table_matches_jax(n, prime_bits):
    """`_xpow_minus1_shoup_table` equals the JAX package's, value for value."""
    primes = t_get_module(n, 2, prime_bits, "cpu").basis.primes
    assert np.array_equal(tfused._xpow_minus1_shoup_table(n, primes),
                          jbr._xpow_minus1_shoup_table(n, primes))


@pytest.mark.parametrize("steps", [1, 2])
def test_plain_rot_shoup_matches_pallas(steps):
    """The port's plain rot_mode 1 step (and the CPU wrapper) equals the JAX
    kernel's rot_mode 1 launch in interpret mode, one step and a chain of
    two, at tests/test_fused.py's shape (N 128) with blocks of 2 (each key
    element of a launch unrolls into the interpreted kernel)."""
    n, nprimes, base2k, cols, size, rows, psize, block, batch = 128, 2, 17, 2, 3, 3, 4, 2, 3
    jm = j_get_module(n, nprimes, 28)
    rng = np.random.default_rng(111 + steps)
    acc = rng.integers(-(2**16), 2**16, size=(batch, cols, size, n), dtype=np.int64)
    pmats = _residues(rng, jm.basis.primes, (steps * block, rows, cols, cols, psize, nprimes, n))
    amounts = rng.integers(-n, 3 * n, size=(batch, steps * block), dtype=np.int64)
    amounts[0, :2] = [-n, 4 * n - 1]
    with pltpu.force_tpu_interpret_mode():
        pm_k = jnp.swapaxes(jpf.pm_kernel_layout(jnp.asarray(pmats), min(rows, size)), 0, 1)
        xp = jnp.take(jbr._xpow_minus1_shoup_table(n, jm.basis.primes), amounts & (2 * n - 1),
                      axis=0)
        want = np.asarray(jpf.fused_br_block_step(jm, jnp.asarray(acc), pm_k,
                                                  xp.astype(jnp.int32), size, base2k,
                                                  t_tile=1, rot_mode=1, steps=steps))
    m = t_get_module(n, nprimes, 28, "cpu")
    args = (m, torch.from_numpy(acc), torch.from_numpy(pmats), torch.from_numpy(amounts), size,
            base2k)
    assert np.array_equal(tfused.fused_br_block_step_ref(*args, steps, rot_mode=1).numpy(), want)
    assert np.array_equal(tfused.fused_br_block_step(*args, steps=steps, rot_mode=1).numpy(),
                          want)


@pytest.mark.parametrize("n,batch,size,block", [(64, 3, 2, 8), (256, 2, 3, 7)])
def test_plain_rot_shoup_equals_montgomery(n, batch, size, block):
    """rot_mode 1 (Shoup on the input rows) and rot_mode 2 / the default
    (the x-power on the output rows, Montgomery) give the same bits, amounts
    of either sign and past 2N."""
    m = t_get_module(n, 2, 28, "cpu")
    rng = np.random.default_rng(113)
    acc = torch.from_numpy(rng.integers(-(2**40), 2**40, size=(batch, 2, size, n)))
    pmats = torch.from_numpy(_residues(rng, m.basis.primes, (block, 4, 2, 2, 4, 2, n)))
    amounts = torch.from_numpy(rng.integers(-2 * n, 4 * n, size=(batch, block)))
    args = (m, acc, pmats, amounts, size, 17)
    want = tfused.fused_br_block_step_ref(*args)
    assert torch.equal(tfused.fused_br_block_step_ref(*args, rot_mode=1), want)
    assert torch.equal(tfused.fused_br_block_step(*args, rot_mode=2), want)


def test_rot_mode_checks():
    """rot_mode 1 and 2 need primes below 2^28 (the JAX kernel asserts it);
    the default takes 2 there and 0 elsewhere, as the JAX package's
    `_rot_mode`; other values raise."""
    m28, m30 = t_get_module(64, 2, 28, "cpu"), t_get_module(64, 2, 30, "cpu")
    assert tfused.block_rot_mode(m28, None) == 2 and tfused.block_rot_mode(m30, None) == 0
    assert tfused.block_rot_mode(m30, 0) == 0
    for mode in (1, 2):
        with pytest.raises(ValueError, match="below 2\\^28"):
            tfused.block_rot_mode(m30, mode)
    with pytest.raises(ValueError, match="rot_mode must be"):
        tfused.block_rot_mode(m28, 3)
    rng = np.random.default_rng(114)
    acc = torch.from_numpy(rng.integers(-(2**16), 2**16, size=(1, 2, 2, 64)))
    pmats = torch.from_numpy(_residues(rng, m30.basis.primes, (2, 2, 2, 2, 2, 2, 64)))
    with pytest.raises(ValueError, match="below 2\\^28"):
        tfused.fused_br_block_step(m30, acc, pmats, torch.zeros(1, 2, dtype=torch.int64), 2, 17,
                                   rot_mode=1)


@pytest.fixture(scope="module")
def gate64():
    params = tgates.GateParams(n_glwe=64, n_lwe=12, nprimes=2, prime_bits=28, block_size=4)
    keys, sk = tgates.keygen(params, device="cpu")
    rng = np.random.default_rng(115)
    bits = rng.integers(0, 2, size=(2, 4))
    c1, c2 = (tgates.encrypt_bit(params, b, sk, TSource(bytes([i]) * 32),
                                 TSource(bytes([i + 8]) * 32)) for i, b in enumerate(bits))
    return keys, sk, bits, c1, c2


def test_nand_on_route_equals_default(gate64, monkeypatch):
    """A NAND through "fused_rot_shoup" equals the default route's, bit for
    bit, and decrypts to the truth table; its block steps run rot_mode 1,
    grouped as the default (a pair, then the remainder), and its keyswitch
    the default product."""
    keys, sk, bits, c1, c2 = gate64
    calls = []
    ref = tfused.fused_br_block_step_ref

    def spy(module, acc, pmats, a_blk, res_size, base2k, steps=1, rot_mode=None, **kw):
        calls.append((steps, rot_mode))
        return ref(module, acc, pmats, a_blk, res_size, base2k, steps, rot_mode, **kw)

    monkeypatch.setattr(tfused, "fused_br_block_step_ref", spy)
    have = tgates.gate_nand(keys, c1, c2, route="fused_rot_shoup")
    assert calls == [(2, 1), (1, 1)]
    calls.clear()
    want = tgates.gate_nand(keys, c1, c2)
    assert calls == [(2, 2), (1, 2)]
    assert torch.equal(have.data, want.data)
    assert np.array_equal(tgates.decrypt_bit(have, sk), 1 - (bits[0] & bits[1]))
    m = keys.module
    assert tbr.br_route(m, "fused_rot_shoup", 4, 17, 1, 0) == "fused_rot_shoup"
    assert mxu_route(m, "fused_rot_shoup", 4, 17, 1) == "fused"
    m30 = t_get_module(64, 2, 30, "cpu")
    assert tbr.br_route(m30, "fused_rot_shoup", 4, 17, 1, 0) == "fused"    # _rot_mode gives 0
