"""poulpy_tpu_torch.hal against poulpy_tpu.hal, bit for bit.

The same numpy inputs and Source seeds go through the JAX function and its
port; every comparison is `np.array_equal` (tolerance 0).  Both prime bases
of the slice are covered: get_module(n, 2, 28) and get_module(n, 2, 30).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poulpy_tpu.hal import dft as jdft
from poulpy_tpu.hal import normalization as jnorm
from poulpy_tpu.hal import ntt as jntt
from poulpy_tpu.hal import vec_znx as jvz
from poulpy_tpu.hal import znx as jznx
from poulpy_tpu.hal.module import get_module as j_get_module
from poulpy_tpu.hal.primes import PrimeBasis as JBasis
from poulpy_tpu.hal.primes import ntt_primes as j_ntt_primes
from poulpy_tpu.hal.primes import required_nprimes as j_required_nprimes
from poulpy_tpu.hal.source import Source as JSource
from poulpy_tpu_torch.hal import dft as tdft
from poulpy_tpu_torch.hal import normalization as tnorm
from poulpy_tpu_torch.hal import ntt as tntt
from poulpy_tpu_torch.hal import vec_znx as tvz
from poulpy_tpu_torch.hal import znx as tznx
from poulpy_tpu_torch.hal.module import get_module as t_get_module
from poulpy_tpu_torch.hal.primes import PrimeBasis as TBasis
from poulpy_tpu_torch.hal.primes import ntt_primes as t_ntt_primes
from poulpy_tpu_torch.hal.primes import required_nprimes as t_required_nprimes
from poulpy_tpu_torch.hal.source import Source as TSource
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BASES = [(2, 28), (2, 30)]
N = 64

I64_EXTREMES = np.array(
    [0, 1, -1, 2**62, -(2**62), 2**63 - 1, -(2**63), 2**40 - 1, -(2**40), 2**29, -(2**29)],
    dtype=np.int64,
)


def _jit(fn, *static):
    """The JAX reference under jit: one compile per shape instead of one per
    eager op keeps these tests fast on the CPU."""
    return jax.jit(fn, static_argnums=static)


def _eq(have, want):
    have = have.numpy() if isinstance(have, torch.Tensor) else np.asarray(have)
    want = np.asarray(want)
    return have.shape == want.shape and np.array_equal(have, want)


def _mods(bits):
    return j_get_module(N, 2, bits), t_get_module(N, 2, bits, "cpu")


def _residues(rng, primes, shape):
    out = np.zeros(shape, dtype=np.int64)
    for i, p in enumerate(primes):
        out[..., i, :] = rng.integers(0, p, size=shape[:-2] + shape[-1:])
    return out.astype(np.int32)


# ---- primes and tables -----------------------------------------------------

@pytest.mark.parametrize("nprimes,bits", BASES + [(4, 30)])
def test_prime_basis_constants(nprimes, bits):
    primes = t_ntt_primes(nprimes, 1 << bits)
    assert primes == j_ntt_primes(nprimes, 1 << bits)
    jb, tb = JBasis(primes), TBasis(primes)
    for name in ("p_arr", "qinv_arr", "r2_arr", "two40_mod_p_arr", "garner_inv",
                 "garner_pprod_mod", "garner_pprod_mont", "garner_inv_mont",
                 "garner_weight_u64", "half_digits"):
        have, want = getattr(tb, name), getattr(jb, name)
        assert have.dtype == want.dtype and np.array_equal(have, want), name
    assert tb.modulus_u64 == jb.modulus_u64 and tb.modulus == jb.modulus


@pytest.mark.parametrize("nprimes,bits", BASES)
def test_twiddle_tables(nprimes, bits):
    jm, tm = j_get_module(256, nprimes, bits), t_get_module(256, nprimes, bits, "cpu")
    for name in ("psi_brv", "psi_inv_brv", "n_inv", "p", "qinv", "r2", "two40_mod_p",
                 "garner_inv_mont", "garner_pprod_mont", "garner_weight", "modulus_u64",
                 "half_digits"):
        assert _eq(getattr(tm.tables, name), getattr(jm.tables, name)), name


# ---- Source ------------------------------------------------------------------

def _draws(src):
    out = [src.next_u32(), src.next_u64(), src.u64_array(37), src.fill_bytes(13),
           src.new_seed(), src.uniform_digits(17, (3, 50)),
           src.normal_f64((301,), 3.2, 19.2),
           src.normal_f64((64,), 3.2, 1.0),        # tight bound: the rejection loop runs
           src.ternary_prob((2, 64)), src.uniform_digits(20, (5000,))]
    return out + [src.new_seed(), src.u64_array(5)]


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("seed", [bytes(32), bytes(range(32))])
def test_source_stream(monkeypatch, native, seed):
    from poulpy_tpu import native as jnative

    if not native:
        monkeypatch.setattr(jnative, "available", lambda: False)
    for have, want in zip(_draws(TSource(seed)), _draws(JSource(seed))):
        if isinstance(want, np.ndarray):
            assert have.dtype == want.dtype and np.array_equal(have, want)
        else:
            assert have == want


def test_source_large_draw_crosses_chunks(monkeypatch):
    """The plain keystream's chunk loop (the refills draw through it here in
    place of the native keystream) across chunk boundaries."""
    from poulpy_tpu_torch import native
    from poulpy_tpu_torch.hal import source

    monkeypatch.setattr(native, "chacha8_blocks", source.plain_keystream)
    monkeypatch.setattr(source, "_CHUNK_BLOCKS", 7)
    t, j = TSource(b"\x02" * 32), JSource(b"\x02" * 32)
    for count in (3, 1000, 17):
        assert np.array_equal(t.uniform_digits(17, (count,)), j.uniform_digits(17, (count,)))


# ---- modular arithmetic and the NTT -----------------------------------------

@pytest.mark.parametrize("bits", [28, 30])
def test_mont_mul_and_reduce_i64(bits):
    jm, tm = _mods(bits)
    jt, tt = jm.tables, tm.tables
    rng = np.random.default_rng(1)
    x = np.concatenate([I64_EXTREMES, rng.integers(-(2**63), 2**63 - 1, 200, dtype=np.int64)])
    for i, p in enumerate(jm.basis.primes):
        want = jntt.reduce_i64(jnp.asarray(x), jt.p[i], jt.qinv[i], jt.r2[i], jt.two40_mod_p[i])
        have = tntt.reduce_i64(torch.from_numpy(x), tt.p[i], tt.qinv[i], tt.r2[i],
                               tt.two40_mod_p[i])
        assert _eq(have, want)
        assert np.array_equal(have.numpy(), np.array([int(v) % p for v in x]))
        a = rng.integers(0, p, 300)
        b = rng.integers(0, p, 300)
        for dt in (np.int32, np.int64):
            want = jntt.mont_mul(jnp.asarray(a.astype(dt)), jnp.asarray(b), jt.p[i], jt.qinv[i])
            have = tntt.mont_mul(torch.from_numpy(a.astype(dt)), torch.from_numpy(b), tt.p[i],
                                 tt.qinv[i])
            assert have.dtype == torch.from_numpy(a.astype(dt)).dtype and _eq(have, want)


@pytest.mark.parametrize("bits", [28, 30])
def test_ntt_and_garner(bits):
    jm, tm = _mods(bits)
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.integers(-(2**40), 2**40, (3, 2, N)),
                        np.broadcast_to(I64_EXTREMES[:8, None], (1, 8, N))[:, :2]])
    jt = jm.tables
    r_j = _jit(jntt.to_residues, 0)(jt, jnp.asarray(x))
    r_t = tntt.to_residues(tm.tables, torch.from_numpy(x))
    assert r_t.dtype == torch.int32 and _eq(r_t, r_j)
    f_j = _jit(jntt.ntt_forward, 0)(jt, r_j)
    f_t = tntt.ntt_forward(tm.tables, r_t)
    assert _eq(f_t, f_j)
    assert _eq(tntt.ntt_inverse(tm.tables, f_t), _jit(jntt.ntt_inverse, 0)(jt, f_j))
    assert _eq(tntt.to_mont(tm.tables, r_t), _jit(jntt.to_mont, 0)(jt, r_j))
    # Garner on arbitrary residues (outputs wrap) and on a small exact value
    res = _residues(rng, jm.basis.primes, (4, 2, N))
    assert _eq(tntt.garner_lift(tm.tables, torch.from_numpy(res)),
               _jit(jntt.garner_lift, 0)(jt, jnp.asarray(res)))
    small = rng.integers(-(2**50), 2**50, (3, N))
    lifted = tntt.garner_lift(tm.tables, tntt.to_residues(tm.tables, torch.from_numpy(small)))
    assert np.array_equal(lifted.numpy(), small)


# ---- znx, normalization, encode/decode -------------------------------------

def test_znx_rotate():
    a = np.random.default_rng(3).integers(-(2**20), 2**20, (3, 2, N))
    for p in (0, 1, -5, N + 3, 2 * N - 1):
        assert _eq(tznx.znx_rotate(p, torch.from_numpy(a)), jznx.znx_rotate(p, jnp.asarray(a)))


@pytest.mark.parametrize("res_size,kr,ka,offset", [
    (3, 17, 17, 0), (2, 17, 17, 0), (5, 17, 17, 0), (3, 13, 19, 0), (4, 21, 17, 4),
    (2, 17, 17, -5), (3, 17, 17, 40), (1, 30, 12, -70), (6, 11, 23, 66)])
def test_vec_znx_normalize_full(res_size, kr, ka, offset):
    rng = np.random.default_rng(4)
    a = np.concatenate([rng.integers(-(2**63), 2**63 - 1, (2, 4, N), dtype=np.int64),
                        np.broadcast_to(I64_EXTREMES[:4, None], (1, 4, N))])
    have = tnorm.vec_znx_normalize_full(res_size, kr, offset, torch.from_numpy(a), ka)
    want = jnorm.vec_znx_normalize_full(res_size, kr, offset, jnp.asarray(a), ka)
    assert _eq(have, want)


@pytest.mark.parametrize("size,lsh", [(1, 0), (3, 0), (4, 5)])
def test_vec_znx_normalize(size, lsh):
    a = np.random.default_rng(5).integers(-(2**62), 2**62, (3, size, N))
    assert _eq(tnorm.vec_znx_normalize(17, torch.from_numpy(a), lsh),
               jnorm.vec_znx_normalize(17, jnp.asarray(a), lsh))


@pytest.mark.parametrize("k,size", [(34, 3), (51, 3), (12, 2), (40, 4)])
def test_encode_decode_vec_i64(k, size):
    rng = np.random.default_rng(6)
    data = rng.integers(-(2**15), 2**15, (2, N))
    enc_t = tvz.encode_vec_i64(17, k, size, torch.from_numpy(data))
    enc_j = jvz.encode_vec_i64(17, k, size, jnp.asarray(data))
    assert _eq(enc_t, enc_j)
    noisy = rng.integers(-(2**16), 2**16, (2, size, N))
    assert _eq(tvz.decode_vec_i64(17, k, torch.from_numpy(noisy)),
               jvz.decode_vec_i64(17, k, jnp.asarray(noisy)))
    a, b = rng.integers(-9, 9, (2, size, N)), rng.integers(-9, 9, (2, size + 1, N))
    for rs in (None, size - 1, size + 2):
        assert _eq(tvz.vec_znx_add(torch.from_numpy(a), torch.from_numpy(b), rs),
                   jvz.vec_znx_add(jnp.asarray(a), jnp.asarray(b), rs))
        assert _eq(tvz.vec_znx_sub(torch.from_numpy(a), torch.from_numpy(b), rs),
                   jvz.vec_znx_sub(jnp.asarray(a), jnp.asarray(b), rs))


# ---- dft ---------------------------------------------------------------------

@pytest.mark.parametrize("bits", [28, 30])
def test_dft_functions(bits):
    jm, tm = _mods(bits)
    rng = np.random.default_rng(7)
    a = rng.integers(-(2**16), 2**16, (2, 2, 5, N))
    s = rng.integers(-1, 2, (1, N))
    dft_apply = _jit(jdft.dft_apply, 0, 2, 3, 4)
    for step, offset, res_size in [(1, 0, None), (2, 1, 3), (3, 2, 4)]:
        assert _eq(tdft.dft_apply(tm, torch.from_numpy(a), step, offset, res_size),
                   dft_apply(jm, jnp.asarray(a), step, offset, res_size))
    a_dft_t = tdft.dft_apply(tm, torch.from_numpy(a))
    a_dft_j = dft_apply(jm, jnp.asarray(a), 1, 0, None)
    assert _eq(tdft.idft_apply(tm, a_dft_t), _jit(jdft.idft_apply, 0)(jm, a_dft_j))
    s_t = tdft.svp_prepare(tm, torch.from_numpy(s))
    s_j = _jit(jdft.svp_prepare, 0)(jm, jnp.asarray(s))
    assert _eq(s_t, s_j)
    assert _eq(tdft.svp_apply(tm, a_dft_t, s_t[0]), _jit(jdft.svp_apply, 0)(jm, a_dft_j, s_j[0]))
    mat = rng.integers(-(2**16), 2**16, (3, 2, 2, 4, N))
    pm_t = tdft.vmp_prepare(tm, torch.from_numpy(mat))
    pm_j = _jit(jdft.vmp_prepare, 0)(jm, jnp.asarray(mat))
    assert _eq(pm_t, pm_j)
    vmp_apply = _jit(jdft.vmp_apply, 0, 3, 4)
    for limb_offset, res_size in [(0, None), (1, 4), (4, 3)]:
        assert _eq(tdft.vmp_apply(tm, a_dft_t, pm_t, limb_offset, res_size),
                   vmp_apply(jm, a_dft_j, pm_j, limb_offset, res_size))
    b_t, b_j = a_dft_t[..., :3, :, :], a_dft_j[..., :3, :, :]
    dft_add = _jit(jdft.dft_add, 0, 3)
    for res_size in (None, 4, 6):
        assert _eq(tdft.dft_add(tm, a_dft_t, b_t, res_size), dft_add(jm, a_dft_j, b_j, res_size))
    big = rng.integers(-(2**50), 2**50, (2, 4, N))
    assert _eq(tdft.big_normalize(tm, 3, 17, torch.from_numpy(big), 17),
               _jit(jdft.big_normalize, 0, 1, 2, 4)(jm, 3, 17, jnp.asarray(big), 17))
    for args in [(17, 17, 11, 6), (26, 26, 11, 6), (30, 30, 12, 8), (17, 17, 16, 1)]:
        assert tdft.product_bits(*args) == jdft.product_bits(*args)
        assert tdft.needs_wide(tdft.product_bits(*args)) == jdft.needs_wide(jdft.product_bits(*args))


# ---- the gate path's additions: Source draws, rotations, automorphisms, dft ------

def _gate_draws(src):
    _, child = src.branch()
    out = [child.u64_array(9), src.next_u64n(7, 7), src.next_u64n(1000, 1023),
           src.binary_prob((3, 40)), src.binary_prob((50,), 0.2)]
    for n, block in ((64, 8), (568, 8), (30, 5)):
        out.append(src.binary_block(n, block))
    _, child2 = src.branch()
    return out + [child2.next_u64(), src.u64_array(3)]


@pytest.mark.parametrize("seed", [bytes(32), bytes(range(32))])
def test_source_branch_and_binary_streams(seed):
    for have, want in zip(_gate_draws(TSource(seed)), _gate_draws(JSource(seed))):
        if isinstance(want, np.ndarray):
            assert have.dtype == want.dtype and np.array_equal(have, want)
        else:
            assert have == want


def test_znx_rotate_batched():
    """Per-batch-element amounts, negative and ≥ N, broadcast over limbs."""
    rng = np.random.default_rng(8)
    a = rng.integers(-(2**20), 2**20, (4, 2, 3, N))
    p = np.array([0, -5, N + 3, 3 * N - 1], dtype=np.int64)
    lut = rng.integers(-(2**20), 2**20, (3, N))
    pairs = [(p[:, None, None], a), (p[:, None], lut), (p[:, None, None], a[:, :1]),
             (np.int64(-7), a)]
    for pp, x in pairs:
        want = jvz.vec_znx_rotate(jnp.asarray(pp), jnp.asarray(x))
        assert _eq(tvz.vec_znx_rotate(torch.from_numpy(np.asarray(pp)), torch.from_numpy(x)), want)
        assert _eq(tznx.znx_rotate(torch.from_numpy(np.asarray(pp)), torch.from_numpy(x)), want)


@pytest.mark.parametrize("p", [-1, 3, 5, 2 * N - 1, 2 * N + 3])
def test_znx_automorphism(p):
    a = np.random.default_rng(9).integers(-(2**20), 2**20, (2, 3, N))
    assert _eq(tvz.vec_znx_automorphism(p, torch.from_numpy(a)),
               jvz.vec_znx_automorphism(p, jnp.asarray(a)))
    idx_t, sign_t = tznx._automorphism_tables(N, p & (2 * N - 1))
    idx_j, sign_j = jznx._automorphism_tables(N, p & (2 * N - 1))
    assert np.array_equal(idx_t, idx_j) and np.array_equal(sign_t, sign_j)
    assert _eq(tvz.vec_znx_negate(torch.from_numpy(a)), jvz.vec_znx_negate(jnp.asarray(a)))


@pytest.mark.parametrize("bits", [28, 30])
def test_dft_sub_copy_and_align(bits):
    jm, tm = _mods(bits)
    rng = np.random.default_rng(10)
    a = _residues(rng, jm.basis.primes, (2, 5, 2, N))
    b = _residues(rng, jm.basis.primes, (2, 3, 2, N))
    for res_size in (None, 2, 4, 7):
        assert _eq(tdft.dft_sub(tm, torch.from_numpy(a), torch.from_numpy(b), res_size),
                   jdft.dft_sub(jm, jnp.asarray(a), jnp.asarray(b), res_size))
        assert _eq(tdft.dft_sub(tm, torch.from_numpy(b), torch.from_numpy(a), res_size),
                   jdft.dft_sub(jm, jnp.asarray(b), jnp.asarray(a), res_size))
    for step, offset, res_size in [(1, 0, None), (2, 1, None), (2, 0, 4), (3, 2, 2), (2, 5, 3)]:
        assert _eq(tdft.dft_copy(torch.from_numpy(a), step, offset, res_size),
                   jdft.dft_copy(jnp.asarray(a), step, offset, res_size))
    limbs = rng.integers(-(2**40), 2**40, (2, 3, N))
    big = rng.integers(-(2**40), 2**40, (2, 4, N))
    for res_size in (2, 4, 6):
        have = tdft._align_limbs(torch.from_numpy(limbs), torch.from_numpy(big), res_size, -2)
        want = jdft._align_limbs(jnp.asarray(limbs), jnp.asarray(big), res_size, limb_axis=-2)
        assert all(_eq(h, w) for h, w in zip(have, want))


# ---- the rest of hal: primes, modular, znx, vec_znx, dft ----------------------------

@pytest.mark.parametrize("base2k,log_n,log_rows", [(17, 11, 7), (17, 10, 3), (13, 10, 7),
                                                   (52, 11, 7), (30, 16, 10), (5, 4, 0)])
def test_required_nprimes(base2k, log_n, log_rows):
    assert t_required_nprimes(base2k, log_n, log_rows) == j_required_nprimes(base2k, log_n,
                                                                           log_rows)


@pytest.mark.parametrize("bits", [28, 30])
def test_neg_mod_and_mul_mod(bits):
    rng = np.random.default_rng(11)
    for p in t_ntt_primes(2, 1 << bits):
        a = np.concatenate([[0, 1, p - 1], rng.integers(0, p, 200)])
        b = np.concatenate([[p - 1, 0, p - 1], rng.integers(0, p, 200)])
        for dt in (np.int32, np.int64):
            assert _eq(tntt.neg_mod(torch.from_numpy(a.astype(dt)), p),
                       jntt.neg_mod(jnp.asarray(a.astype(dt)), p))
        assert _eq(tntt.mul_mod(torch.from_numpy(a), torch.from_numpy(b), p),
                   jntt.mul_mod(jnp.asarray(a), jnp.asarray(b), p))
        assert np.array_equal(tntt.mul_mod(torch.from_numpy(a), torch.from_numpy(b), p).numpy(),
                              [int(x) * int(y) % p for x, y in zip(a, b)])


@pytest.mark.parametrize("k", [0, 1, 17, 63, 64, 70, -1, -17, -63, -64, -70])
def test_znx_arithmetic(k):
    """add / sub / negate / zero_like and · 2^k, wrapping int64 at the extremes."""
    rng = np.random.default_rng(12)
    a = np.concatenate([np.broadcast_to(I64_EXTREMES[:, None], (11, N)),
                        rng.integers(-(2**63), 2**63 - 1, (3, N), dtype=np.int64)])
    b = a[::-1].copy()
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    assert _eq(tznx.znx_mul_power_of_two(k, ta), jznx.znx_mul_power_of_two(k, ja))
    assert _eq(tznx.znx_add(ta, tb), jznx.znx_add(ja, jb))
    assert _eq(tznx.znx_sub(ta, tb), jznx.znx_sub(ja, jb))
    assert _eq(tznx.znx_negate(ta), jznx.znx_negate(ja))
    assert _eq(tznx.znx_zero_like(ta), jznx.znx_zero_like(ja))


@pytest.mark.parametrize("base2k,k,res_size", [(17, 5, None), (17, 20, 4), (13, 3, 2),
                                               (17, 0, 5), (30, 41, 3)])
def test_vec_znx_shifts_and_normalize_op(base2k, k, res_size):
    a = np.random.default_rng(13).integers(-(2**40), 2**40, (2, 3, N))
    ta, ja = torch.from_numpy(a), jnp.asarray(a)
    assert _eq(tvz.vec_znx_lsh(base2k, k, ta, res_size), jvz.vec_znx_lsh(base2k, k, ja, res_size))
    assert _eq(tvz.vec_znx_rsh(base2k, k, ta, res_size), jvz.vec_znx_rsh(base2k, k, ja, res_size))
    assert _eq(tvz.vec_znx_normalize_op(base2k, ta, res_size),
               jvz.vec_znx_normalize_op(base2k, ja, res_size))


@pytest.mark.parametrize("n_out", [N // 2, N // 4, 8])
def test_vec_znx_split_and_merge_rings(n_out):
    a = np.random.default_rng(14).integers(-(2**20), 2**20, (2, 3, N))
    parts = tvz.vec_znx_split_ring(n_out, torch.from_numpy(a))
    assert _eq(parts, jvz.vec_znx_split_ring(n_out, jnp.asarray(a)))
    assert _eq(tvz.vec_znx_merge_rings(parts), jvz.vec_znx_merge_rings(jnp.asarray(parts.numpy())))


@pytest.mark.parametrize("base2k,k,size", [(17, 34, 3), (17, 100, 6), (13, 90, 7), (52, 150, 3),
                                           (17, 51, 3), (30, 121, 5)])
def test_encode_decode_vec_i128(base2k, k, size):
    """Python ints past 64 bits, both signs, encoded then decoded exactly;
    the encoding equals the JAX package's limbs and decodes to the same ints,
    values past the torus's range included."""
    rng = np.random.default_rng(k)
    data = [int.from_bytes(rng.bytes(32), "little", signed=True) >> (258 - k) for _ in range(16)]
    data += [0, -1, 1, (1 << (k - 2)) - 1, -(1 << (k - 2))]
    have = tvz.encode_vec_i128(base2k, k, size, data, device="cpu")
    want = jvz.encode_vec_i128(base2k, k, size, data)
    assert _eq(have, want)
    assert tvz.decode_vec_i128(base2k, k, have) == jvz.decode_vec_i128(base2k, k, want) == data
    # the torus wraps mod 2^k: both packages alike
    wrap = [(1 << (k - 1)) - 1, -(1 << (k - 1)), 1 << (k + 3)]
    have = tvz.encode_vec_i128(base2k, k, size, wrap, device="cpu")
    assert _eq(have, jvz.encode_vec_i128(base2k, k, size, wrap))
    assert tvz.decode_vec_i128(base2k, k, have) == jvz.decode_vec_i128(
        base2k, k, jvz.encode_vec_i128(base2k, k, size, wrap))


@pytest.mark.parametrize("p", [-1, 5, 2 * N - 3])
def test_big_automorphism(p):
    a = np.random.default_rng(15).integers(-(2**62), 2**62, (2, 4, N))
    assert _eq(tdft.big_automorphism(p, torch.from_numpy(a)),
               jdft.big_automorphism(p, jnp.asarray(a)))


def test_module_defaults_to_the_card():
    """Without a device argument the port asks for the card, and raises on a
    machine without one instead of handing back a CPU module."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from poulpy_tpu_torch.hal.module import Module
    from poulpy_tpu_torch.hal.ntt import NttTables

    with pytest.raises(RuntimeError, match="CUDA"):
        t_get_module(64, 2, 28)
    with pytest.raises(RuntimeError, match="CUDA"):
        Module(64, 2, 28)
    with pytest.raises(RuntimeError, match="CUDA"):
        NttTables(TBasis(t_ntt_primes(2, 1 << 28)), 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        tvz.encode_vec_i128(17, 34, 3, [1])
    assert t_get_module(64, 2, 28, "cpu").device == torch.device("cpu")
