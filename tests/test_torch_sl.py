"""The fused pipeline in the sublane/lane-split layout (`backends/fused_sl.py`,
the JAX package's `POULPY_TPU_SL=1`) and the "fused_sl" route, against the
JAX package on the CPU, tolerance 0.

The layout splits each transform into the stages across 128-point rows and
those inside one 128-lane row, with Montgomery butterflies
(`pallas_fused._ntt_rows_sl` / `_intt_rows_sl`); its switch sits in
`_pipe_fn`, so it reaches every caller of the fused kernel.  Here: the
port's split transforms against `hal.ntt` at N 128 … 2048; the plain `sl`
product with `small` and with `small64`, and the block step under rot_mode
1 and 2, against the JAX kernel in interpret mode with the layout switched
on (`_pipe_fn`'s cache key omits the layout, so it is cleared around those
calls); the refusal of a chain; the routes' fallback where the JAX package's
condition fails (N 64); a NAND through the route against the default.  The
kernel: tests/test_torch_cuda_emu.py (emulated) and tests/test_torch_kernels.py
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
from poulpy_tpu_torch.backends import fused_sl as tsl
from poulpy_tpu_torch.backends.mxu_product import mxu_route
from poulpy_tpu_torch.binfhe import blind_rotation as tbr
from poulpy_tpu_torch.binfhe import gates as tgates
from poulpy_tpu_torch.hal import ntt as hntt
from poulpy_tpu_torch.hal.module import get_module as t_get_module
from poulpy_tpu_torch.hal.source import Source as TSource
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

N = 256


def _residues(rng, primes, shape):
    """Random standard-form residues [..., P, N] (int32)."""
    out = np.zeros(shape, dtype=np.int64)
    for i, p in enumerate(primes):
        out[..., i, :] = rng.integers(0, p, size=shape[:-2] + shape[-1:])
    return out.astype(np.int32)


@pytest.mark.parametrize("prime_bits", [28, 30])
@pytest.mark.parametrize("n", [128, 256, 512, 1024, 2048])
def test_split_transforms_match_hal(n, prime_bits):
    """`ntt_rows_sl` / `intt_rows_sl` equal `hal.ntt`'s transforms (lazy
    butterflies below 2^28, canonical ones at 30 bits), residues 0 and p − 1
    among the inputs, and invert each other."""
    t = t_get_module(n, 3, prime_bits, "cpu").tables
    x = torch.from_numpy(_residues(np.random.default_rng(n + prime_bits), t.basis.primes,
                                   (2, 3, n)))
    x[0, :, 0] = 0
    x[0, :, 1] = torch.tensor(t.basis.primes, dtype=torch.int32) - 1
    f = tsl.ntt_rows_sl(t, x)
    assert torch.equal(f, hntt.ntt_forward(t, x))
    assert torch.equal(tsl.intt_rows_sl(t, x), hntt.ntt_inverse(t, x))
    assert torch.equal(tsl.intt_rows_sl(t, f), x)


@pytest.fixture
def jax_sl(monkeypatch):
    """The JAX kernel with its split layout switched on, `_pipe_fn`'s cache
    cleared before and after (its key omits the layout); yields the list of
    the split transforms its kernel traced, so a test can show the layout ran."""
    traced = []
    for name in ("_ntt_rows_sl", "_intt_rows_sl"):
        real = getattr(jpf, name)

        def spy(*args, _real=real, _name=name, **kw):
            traced.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(jpf, name, spy)
    monkeypatch.setenv("POULPY_TPU_SL", "1")
    jpf._pipe_fn.cache_clear()
    yield traced
    monkeypatch.delenv("POULPY_TPU_SL")
    jpf._pipe_fn.cache_clear()


@pytest.mark.parametrize("pattern", ["small", "small64"])
def test_plain_sl_product_matches_pallas(jax_sl, pattern):
    """The plain `sl` product with the keyswitch body (`small`) or the
    relinearization's linear terms (`small64`, more limbs than the product)
    and the CPU wrapper equal the JAX kernel in the layout, N 256."""
    jm = j_get_module(N, 2, 28)
    rng = np.random.default_rng(121)
    ci, rows, size_a, psize, res_size = (1, 3, 3, 4, 3) if pattern == "small" else (1, 3, 3, 4, 6)
    a = rng.integers(-(2**16), 2**16, size=(2, ci, size_a, N), dtype=np.int64)
    pmat = _residues(rng, jm.basis.primes, (rows, ci, 2, psize, 2, N))
    kw = ({"small": rng.integers(-(2**20), 2**20, size=(2, 3, N), dtype=np.int64)}
          if pattern == "small" else
          {"small64": rng.integers(-(2**47), 2**47, size=(2, 2, 6, N), dtype=np.int64)})
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpf.fused_glwe_product(
            jm, jnp.asarray(a), jnp.asarray(pmat), res_size, 17, 17, t_tile=1,
            **{k: jnp.asarray(v) for k, v in kw.items()}))
    assert {"_ntt_rows_sl", "_intt_rows_sl"} <= set(jax_sl)
    m = t_get_module(N, 2, 28, "cpu")
    targs = (m, torch.from_numpy(a), torch.from_numpy(pmat), res_size, 17, 17)
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    assert np.array_equal(tsl.fused_glwe_product_sl_ref(*targs, **tkw).numpy(), want)
    assert np.array_equal(tsl.fused_glwe_product_sl(*targs, **tkw).numpy(), want)


@pytest.mark.parametrize("rot_mode", [1, 2])
def test_plain_sl_block_step_matches_pallas(jax_sl, rot_mode):
    """The plain `sl` block step and the CPU wrapper equal the JAX kernel's
    block step in the layout (steps 1) under rot_mode 1 and 2, N 256."""
    jm = j_get_module(N, 2, 28)
    rng = np.random.default_rng(122 + rot_mode)
    size, rows, block, batch = 2, 4, 2, 2
    acc = rng.integers(-(2**16), 2**16, size=(batch, 2, size, N), dtype=np.int64)
    pmats = _residues(rng, jm.basis.primes, (block, rows, 2, 2, 4, 2, N))
    amounts = rng.integers(-N, 3 * N, size=(batch, block), dtype=np.int64)
    table = jbr._xpow_minus1_shoup_table if rot_mode == 1 else jbr._xpow_minus1_table
    with pltpu.force_tpu_interpret_mode():
        pm_k = jnp.swapaxes(jpf.pm_kernel_layout(jnp.asarray(pmats), min(rows, size)), 0, 1)
        xp = jnp.take(table(N, jm.basis.primes), amounts & (2 * N - 1), axis=0)
        want = np.asarray(jpf.fused_br_block_step(jm, jnp.asarray(acc), pm_k,
                                                  xp.astype(jnp.int32), size, 17, t_tile=1,
                                                  rot_mode=rot_mode))
    assert {"_ntt_rows_sl", "_intt_rows_sl"} <= set(jax_sl)
    m = t_get_module(N, 2, 28, "cpu")
    args = (m, torch.from_numpy(acc), torch.from_numpy(pmats), torch.from_numpy(amounts), size,
            17)
    assert np.array_equal(tsl.fused_br_block_step_sl_ref(*args, 1, rot_mode).numpy(), want)
    assert np.array_equal(tsl.fused_br_block_step_sl(*args, rot_mode=rot_mode).numpy(), want)


def test_sl_chain_raises_and_rot0_matches():
    """`steps` > 1 raises (the JAX kernel asserts `not sl` for a chain), in
    the wrapper and the plain version; rot_mode 0 and the default equal the
    default pipeline's plain step."""
    m = t_get_module(N, 2, 28, "cpu")
    rng = np.random.default_rng(124)
    acc = torch.from_numpy(rng.integers(-(2**16), 2**16, size=(2, 2, 2, N)))
    pmats = torch.from_numpy(_residues(rng, m.basis.primes, (4, 2, 2, 2, 4, 2, N)))
    amounts = torch.from_numpy(rng.integers(-N, N, size=(2, 4)))
    args = (m, acc, pmats, amounts, 2, 17)
    with pytest.raises(ValueError, match="one block step per launch"):
        tsl.fused_br_block_step_sl(*args, steps=2)
    with pytest.raises(ValueError, match="one block step per launch"):
        tsl.fused_br_block_step_sl_ref(*args, 2)
    want = tfused.fused_br_block_step_ref(*args)
    assert torch.equal(tsl.fused_br_block_step_sl(*args, rot_mode=0), want)
    assert torch.equal(tsl.fused_br_block_step_sl(*args), want)


def test_routes_fall_back_where_jax_does():
    """"fused_sl" takes the split layout where N % 128 == 0 and N ≥ 128 (and
    the JAX package's fused kernel runs: `fused_supported`, and for the blind
    rotation `_use_fused_br`), "fused" elsewhere: at N 64, and for a window
    past the fused kernel's."""
    assert [tsl.sl_applies(n) for n in (64, 128, 192, 256, 2048)] == [False, True, False, True,
                                                                     True]
    m64, m256 = t_get_module(64, 2, 28, "cpu"), t_get_module(N, 2, 28, "cpu")
    assert mxu_route(m64, "fused_sl", 4, 17, 1) == "fused"
    assert mxu_route(m256, "fused_sl", 4, 17, 1) == "fused_sl"
    assert mxu_route(m256, "fused_sl", 4, 17, 2) == "fused_sl"      # any dsize, as the JAX product
    assert mxu_route(m256, "fused_sl", 4, 30, 1) == "fused"         # not fused_supported
    assert tbr.br_route(m64, "fused_sl", 4, 17, 1, 0) == "fused"
    assert tbr.br_route(m256, "fused_sl", 4, 17, 1, 0) == "fused_sl"
    assert tbr.br_route(m256, "fused_sl", 4, 17, 2, 0) == "fused"   # dsize 2: no fused BR
    # the split design's N: 128 .. 8192, past 2048 in its global layout;
    # the parent design's 128 .. 2048
    assert tsl.sl_layout(6, 2, 4, 2, 4096).kind == "global"
    assert tsl.sl_layout(6, 2, 4, 2, 8192).kind == "global"
    assert tsl.sl_layout(6, 2, 4, 2, 16384) is None
    assert tsl.sl_layout(6, 2, 4, 2, 4096, design="parent") is None
    assert tsl.sl_layout(6, 2, 6, 2, 2048, design="parent").cpb == 2
    assert tsl.sl_layout(6, 2, 6, 2, 2048).cpb == 1                 # ≤ 8 output rows a block
    # a column of 10 output rows: two VMP passes, the outputs after the 6 input rows
    assert tsl.split_rows(6, 10) == 16 and tsl.sl_layout(6, 1, 10, 2, 1024).cpb == 1


@pytest.fixture(scope="module")
def gate256():
    params = tgates.GateParams(n_glwe=N, n_lwe=12, nprimes=2, prime_bits=28, block_size=4)
    keys, sk = tgates.keygen(params, device="cpu")
    bits = np.random.default_rng(125).integers(0, 2, size=(2, 3))
    c1, c2 = (tgates.encrypt_bit(params, b, sk, TSource(bytes([i + 1]) * 32),
                                 TSource(bytes([i + 9]) * 32)) for i, b in enumerate(bits))
    return keys, sk, bits, c1, c2


def test_nand_on_route_equals_default(gate256, monkeypatch):
    """A NAND through "fused_sl" equals the default route's bit for bit and
    decrypts to the truth table: its block path one `sl` block step per
    block of 4 (three), its keyswitch the `sl` product with the body; the
    standard path at 12 coefficients one `sl` product each."""
    keys, sk, bits, c1, c2 = gate256
    calls = []
    for name in ("fused_br_block_step_sl_ref", "fused_glwe_product_sl_ref"):
        real = getattr(tsl, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(tsl, name, spy)
    have = tgates.gate_nand(keys, c1, c2, route="fused_sl")
    assert calls == ["fused_br_block_step_sl_ref"] * 3 + ["fused_glwe_product_sl_ref"]
    want = tgates.gate_nand(keys, c1, c2)
    assert calls == ["fused_br_block_step_sl_ref"] * 3 + ["fused_glwe_product_sl_ref"]
    assert torch.equal(have.data, want.data)
    assert np.array_equal(tgates.decrypt_bit(have, sk), 1 - (bits[0] & bits[1]))
    lwe = c1
    del calls[:]
    std = tbr.blind_rotation_execute(keys.module, lwe, keys.lut, keys.brk, route="fused_sl")
    assert calls == ["fused_glwe_product_sl_ref"] * 12
    assert torch.equal(std, tbr.blind_rotation_execute(keys.module, lwe, keys.lut, keys.brk))
