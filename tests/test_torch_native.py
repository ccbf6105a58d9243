"""poulpy_tpu_torch.native against its plain versions and poulpy_tpu.native.

Each wrapper of the port's native host tier (`kernels.cpp`) is held, with
tolerance 0, against its plain version in the port (hal/source.py's numpy
keystream; the torch functions of hal/znx.py, hal/normalization.py and
hal/ntt.py; a Python big-int product) and against the JAX package's
`poulpy_tpu.native` on the same seeded inputs, at N 64 and 2048, the int64
extremes and block counters past 2^32 among them.  Then the port's
`Source`: every refill goes through the native keystream, and its stream
equals the JAX package's in both of that package's modes.
"""

import numpy as np
import pytest
import torch

from poulpy_tpu import native as jnative
from poulpy_tpu.hal.source import Source as JSource
from poulpy_tpu_torch import native
from poulpy_tpu_torch.core import compressed
from poulpy_tpu_torch.hal import normalization as tnorm
from poulpy_tpu_torch.hal import ntt as tntt
from poulpy_tpu_torch.hal import source
from poulpy_tpu_torch.hal import znx as tznx
from poulpy_tpu_torch.hal.module import get_module
from test_torch_hal import I64_EXTREMES
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

NS = [64, 2048]


def _ints(seed: int, shape: tuple) -> np.ndarray:
    """Uniform int64 of `shape` with the int64 extremes in its first row."""
    x = np.random.default_rng(seed).integers(-(2**63), 2**63 - 1, shape, dtype=np.int64,
                                             endpoint=True)
    flat = x.reshape(-1, shape[-1])
    flat[0, : I64_EXTREMES.size] = I64_EXTREMES[: shape[-1]]
    return x


def _plain(fn, *args):
    """A torch function of the port on numpy inputs, back to numpy."""
    conv = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]
    return fn(*conv).numpy()


def _bigint_product(a: np.ndarray, b: np.ndarray) -> list[list[int]]:
    """Exact negacyclic products of the rows of a and b, in Python ints."""
    out = []
    for ra, rb in zip(a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])):
        full = np.convolve(ra.astype(object), rb.astype(object))
        n = ra.size
        out.append([int(v) for v in full[:n] - np.append(full[n:], 0)])
    return out


def _as_ints(hi: np.ndarray, lo: np.ndarray) -> list[list[int]]:
    return [[(int(h) << 64) | int(l) for h, l in zip(rh, rl)]
            for rh, rl in zip(hi.reshape(-1, hi.shape[-1]), lo.reshape(-1, lo.shape[-1]))]


# ---- the wrappers -------------------------------------------------------------

@pytest.mark.parametrize("counter0,nblocks", [(0, 1), (0, 7), (12345, 4), (2**32 - 3, 6),
                                              (2**33, 3)])
def test_chacha8_blocks(counter0, nblocks):
    assert native.available()
    key = np.random.default_rng(counter0 % 1000).integers(0, 2**32, 8, dtype=np.uint32)
    want = source._chacha_blocks(key, counter0, nblocks)
    have = native.chacha8_blocks(key, counter0, nblocks)
    assert have.dtype == np.uint32 and np.array_equal(have, want)
    assert np.array_equal(have, jnative.chacha8_blocks(key, counter0, nblocks))
    out = np.zeros(16 * nblocks + 16, dtype=np.uint32)
    native.chacha8_blocks(key, counter0, nblocks, out=out[16:].reshape(nblocks, 16))
    assert np.array_equal(out[16:].reshape(nblocks, 16), want) and not out[:16].any()
    with pytest.raises(ValueError):
        native.chacha8_blocks(key, counter0, nblocks, out=np.empty((nblocks, 16), np.int64))


@pytest.mark.parametrize("n", NS)
def test_znx_rotate(n):
    a = _ints(n, (3, n))
    for p in (0, 1, 5, n - 1, n, 2 * n - 1, -3, -n, 3 * n + 7):
        have = native.znx_rotate(p, a)
        assert np.array_equal(have, _plain(tznx.znx_rotate, p, a)), p
        assert np.array_equal(have, jnative.znx_rotate(p, a)), p


@pytest.mark.parametrize("n", NS)
def test_znx_automorphism(n):
    a = _ints(n + 1, (2, n))
    for p in (1, 3, 5, 2 * n - 1, 2 * n + 3, -1):
        have = native.znx_automorphism(p, a)
        assert np.array_equal(have, _plain(tznx.znx_automorphism, p, a)), p
        assert np.array_equal(have, jnative.znx_automorphism(p, a)), p
    with pytest.raises(ValueError):
        native.znx_automorphism(2, a)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("base2k,lsh,size", [(17, 0, 4), (17, 3, 4), (52, 5, 3), (17, 3, 1)])
def test_vec_znx_normalize(n, base2k, lsh, size):
    a = _ints(n + size, (2, size, n))
    have = native.vec_znx_normalize(base2k, a, lsh)
    assert np.array_equal(have, _plain(tnorm.vec_znx_normalize, base2k, a, lsh))
    assert np.array_equal(have, jnative.vec_znx_normalize(base2k, a, lsh))


@pytest.mark.parametrize("n", NS)
def test_negacyclic_conv_i128(n):
    """Operands at the extremes where N · max|a| · max|b| < 2^127 holds."""
    rows = 2 if n == 64 else 1
    a = _ints(n + 2, (rows, n))
    b_bits = 126 - 63 - n.bit_length()
    b = np.random.default_rng(n + 3).integers(-(2**b_bits), 2**b_bits, (rows, n), dtype=np.int64)
    hi, lo = native.negacyclic_conv_i128(a, b)
    assert _as_ints(hi, lo) == _bigint_product(a, b)
    jhi, jlo = jnative.negacyclic_conv_i128(a, b)
    assert np.array_equal(hi, jhi) and np.array_equal(lo, jlo)


def test_negacyclic_mul_exact():
    rng = np.random.default_rng(5)
    a = [int(v) for v in rng.integers(-(2**30), 2**30, 64)]
    b = [int(v) for v in rng.integers(-(2**30), 2**30, 64)]
    want = _bigint_product(np.array(a), np.array(b))[0]
    assert native.negacyclic_mul_exact(a, b) == want == jnative.negacyclic_mul_exact(a, b)
    with pytest.raises(OverflowError):
        native.negacyclic_mul_exact([1 << 62] * 8, [1 << 62] * 8)
    # −2^63 counts as 2^63 (numpy's abs would leave it negative)
    with pytest.raises(OverflowError):
        native.negacyclic_mul_exact([-(2**63)] + [0] * 7, [-(2**63)] + [0] * 7)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("bits", [28, 30])
def test_ntt(n, bits):
    t = get_module(n, 2, bits, "cpu").tables
    primes = t.basis.primes
    psi_t, psi_inv_t, n_inv = tntt._host_tables(primes, n)
    rng = np.random.default_rng(n + bits)
    x = np.stack([rng.integers(0, p, (3, n)) for p in primes], axis=1)
    x[0, :, :2] = [[0, p - 1] for p in primes]
    fwd = _plain(tntt.ntt_forward, t, x)
    inv = _plain(tntt.ntt_inverse, t, fwd)
    assert np.array_equal(inv, x)
    for i, p in enumerate(primes):
        qinv = int(t.basis.qinv_arr[i])
        have_f = native.ntt_forward(psi_t[i], p, qinv, x[:, i])
        assert np.array_equal(have_f, fwd[:, i])
        assert np.array_equal(have_f, jnative.ntt_forward(psi_t[i], p, qinv, x[:, i]))
        have_b = native.ntt_inverse(psi_inv_t[i], int(n_inv[i]), p, qinv, fwd[:, i])
        assert np.array_equal(have_b, inv[:, i])
        assert np.array_equal(have_b, jnative.ntt_inverse(psi_inv_t[i], int(n_inv[i]), p, qinv,
                                                          fwd[:, i]))


# ---- the build ------------------------------------------------------------------

@pytest.mark.parametrize("compiler", ["missing", "false"])
def test_failed_build_raises(monkeypatch, tmp_path, compiler):
    """A compiler that is not there, or that fails: library() raises, and so
    does a Source's first draw; nothing falls back to numpy."""
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "g++") if compiler == "missing" else "false")
    native.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="needs" if compiler == "missing" else "failed"):
            native.library()
        assert not native.available()
        with pytest.raises(RuntimeError):
            source.Source(bytes(32)).next_u32()
    finally:
        native.library.cache_clear()


def test_host_cpu_of_a_virtual_machine(monkeypatch):
    """A /proc/cpuinfo whose model name is "unknown", as some virtual
    machines report: the model is the vendor, family and model numbers."""
    import io

    text = ("processor\t: 0\nvendor_id\t: GenuineIntel\ncpu family\t: 6\nmodel\t\t: 207\n"
            "model name\t: unknown\nflags\t\t: fpu avx2 avx512f\n\nprocessor\t: 1\n"
            "flags\t\t: fpu\n")
    monkeypatch.setattr(native, "open", lambda path: io.StringIO(text), raising=False)
    cpu = native.host_cpu()
    assert cpu["model"] == "GenuineIntel family 6 model 207 (model name unknown)"
    assert cpu["flags"] == "fpu avx2 avx512f"


def test_build_key_covers_source_flags_and_cpu(monkeypatch):
    key = native.build_key()
    monkeypatch.setattr(native, "FLAGS", native.FLAGS + ("-g",))
    assert native.build_key() != key
    monkeypatch.undo()
    cpu = native.host_cpu()
    monkeypatch.setattr(native, "host_cpu", lambda: {**cpu, "flags": cpu["flags"] + " x"})
    assert native.build_key() != key


# ---- the Source ----------------------------------------------------------------

SEED = bytes(range(32))


def _draws(src) -> list:
    """Draws that leave words over between refills, and one of many blocks."""
    return [src.next_u32(), src.u64_array(37), src.uniform_digits(17, (3, 50)),
            src.fill_bytes(13), src.normal_f64((301,), 3.2, 19.2), src.next_u64(),
            src.uniform_digits(20, (70001,)), src.new_seed(), src.ternary_hw(64, 16)]


def _assert_equal(have: list, want: list) -> None:
    for h, w in zip(have, want, strict=True):
        if isinstance(w, np.ndarray):
            assert h.dtype == w.dtype and np.array_equal(h, w)
        else:
            assert h == w


@pytest.mark.parametrize("jax_native", [True, False])
def test_source_refills_through_native(monkeypatch, jax_native):
    """With the library built, every refill of the port's Source is one call
    of native.chacha8_blocks and none of the plain keystream; the stream
    equals the JAX package's Source with and without its native keystream,
    and the port's with the plain keystream swapped in."""
    if not jax_native:
        monkeypatch.setattr(jnative, "available", lambda: False)
    want = _draws(JSource(SEED))

    blocks, fast = [], native.chacha8_blocks

    def spy(key, counter0, nblocks, out=None):
        blocks.append((counter0, nblocks))
        return fast(key, counter0, nblocks, out=out)

    def never(*args):
        raise AssertionError("the plain keystream ran with the library built")

    monkeypatch.setattr(native, "chacha8_blocks", spy)
    monkeypatch.setattr(source, "_chacha_blocks", never)
    src = source.Source(SEED)
    _assert_equal(_draws(src), want)
    assert len(blocks) >= 3 and blocks[0][0] == 0
    assert all(c1 == c0 + nb for (c0, nb), (c1, _) in zip(blocks, blocks[1:]))
    assert src._counter == sum(nb for _, nb in blocks)

    monkeypatch.undo()
    monkeypatch.setattr(native, "chacha8_blocks", source.plain_keystream)
    _assert_equal(_draws(source.Source(SEED)), want)


@pytest.mark.parametrize("n_lwe", [8, pytest.param(568, marks=pytest.mark.slow)])
def test_brk_mask_draw(n_lwe):
    """compressed._mask_digits at the gate BRK's mask shape (2, n_lwe, dnum
    4, rank 1, size 4, N 1024, base2k 17): equal to the JAX package's draw
    and to the port's through the plain keystream."""
    shape = (2, n_lwe, 4, 1, 4, 1024)
    have = compressed._mask_digits(SEED, 17, shape)
    assert have.shape == shape and np.array_equal(have, JSource(SEED).uniform_digits(17, shape))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "chacha8_blocks", source.plain_keystream)
        assert np.array_equal(have, compressed._mask_digits(SEED, 17, shape))
