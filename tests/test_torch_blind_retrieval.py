"""poulpy_tpu_torch's blind retrieval against poulpy_tpu's, bit for bit
(tolerance 0), at test_torch_bdd.py's configuration (bench_schemes.py's u32
add cut to N 64 and n_lwe 14).

The index comes through `fheuint_prepare` with a rank-reduction key: a
FheUint under a rank-2 secret, switched to the bootstrapping key's rank 1
(`ks_glwe`, k 30 dnum 2) before extraction; the JAX package prepares the
same FheUint under `jax.jit` on the keys the port made (one circuit
bootstrap per file).  The other selectors are the port's constant-GGSW
bits (`fheuint_prepared_encrypt_sk`) carried over by `interop`.  Covered:
`glwe_cswap`, `GLWEBlindRetriever` (equal to `blind_select`, partial
blocks, `add` one at a time with an offset, the capacity and empty-flush
errors), `glwe_blind_retrieval` and `_rev` (sub-fields too) and
`glwe_blind_selection` (missing keys as zero), each decrypting where the
JAX package's own tests decrypt.
"""

import numpy as np
import pytest

from test_torch_bdd import (
    BASE2K,
    DNUM_GGSW,
    DNUM_KS,
    K_CT,
    K_GGSW,
    N,
    _decode,
    _eq,
    _glwes,
    jax_prepare,
    port_keys,
    to_jax,
)

from poulpy_tpu.binfhe import blind_retrieval as jret
from poulpy_tpu.hal.module import get_module as j_get_module
from poulpy_tpu_torch.binfhe import bdd as tbdd
from poulpy_tpu_torch.binfhe import blind_retrieval as tret
from poulpy_tpu_torch.core import encryption as tenc
from poulpy_tpu_torch.core import prepared as tprep
from poulpy_tpu_torch.hal.module import get_module as t_get_module
from poulpy_tpu_torch.hal.source import Source as TSource
from poulpy_tpu_torch.utils import interop

IDX, IDX_WIDTH, N_IN = 5, 4, 16


@pytest.fixture(scope="module")
def ctx():
    """The port's keys with a rank-2 → rank-1 `ks_glwe`, the index FheUint
    under the rank-2 secret prepared by both packages, and N_IN GLWEs under
    the rank-1 secret in each."""
    t = port_keys(t_get_module(N, 2, 28, "cpu"))
    m = t["m"]
    sk2 = tenc.secret_new(m, 2, TSource(b"\x10" * 32))
    sk2p = tprep.glwe_secret_prepare(m, sk2)
    xe, xa = TSource(b"\x11" * 32), TSource(b"\x12" * 32)
    ks_glwe = tprep.gglwe_prepare(m, tenc.glwe_switching_key_encrypt_sk(
        m, sk2, t["skp"], BASE2K, K_CT, DNUM_KS, xe, xa))
    t["key"] = t["key"].replace(ks_glwe=ks_glwe)
    t["idx"] = tbdd.fheuint_encrypt(m, IDX, IDX_WIDTH, sk2p, BASE2K, K_CT, xe, xa)
    t["sel"] = tbdd.fheuint_prepare(m, t["idx"], t["key"])
    j = dict(m=j_get_module(N, 2, 28), skp=to_jax(t["skp"]), key=to_jax(t["key"]))
    j["sel"] = jax_prepare(j["m"], j["key"], to_jax(t["idx"]))
    for pkg, run in (("jax", j), ("torch", t)):
        run["datas"], run["cts"] = _glwes(run, pkg, N_IN, 0x40)
    return j, t


def _sel(ctx, value, width, seed):
    """Constant-GGSW selector bits of `value` from the port, and the JAX
    package's copy."""
    _, t = ctx
    sel = tbdd.fheuint_prepared_encrypt_sk(t["m"], value, width, t["skp"], BASE2K, K_GGSW,
                                           DNUM_GGSW, TSource(bytes([seed] * 32)),
                                           TSource(bytes([seed + 1] * 32)))
    return to_jax(sel), sel


def test_fheuint_prepare_rank_reduction(ctx):
    """The prepare through `ks_glwe` equals the JAX package's, the key
    crosses with its `ks_glwe`, and the selectors pick entry IDX."""
    j, t = ctx
    for have, want in zip(t["sel"].bits, j["sel"].bits, strict=True):
        assert _eq(have.pmat, want.pmat)
    key = interop.from_fields(*interop.to_fields(j["key"]), device="cpu")
    assert _eq(key.ks_glwe.pmat, t["key"].ks_glwe.pmat) and key.ks_glwe.rank_in == 2
    out = tbdd.blind_select(t["m"], t["sel"], t["cts"])
    assert np.array_equal(_decode(t, out), t["datas"][IDX])


@pytest.mark.parametrize("idx", [IDX, 0, 15])
def test_streaming_retriever_matches_flat_tree(ctx, idx):
    """The carry-save retriever equals `blind_select` bit for bit and the
    JAX package's retriever, and decrypts to entry idx."""
    j, t = ctx
    js, ts = (j["sel"], t["sel"]) if idx == IDX else _sel(ctx, idx, IDX_WIDTH, 0x50 + 2 * idx)
    have = tret.GLWEBlindRetriever(N_IN).retrieve(t["m"], t["cts"], ts)
    assert _eq(have.data, tbdd.blind_select(t["m"], ts, t["cts"]).data)
    assert _eq(have.data, jret.GLWEBlindRetriever(N_IN).retrieve(j["m"], j["cts"], js).data)
    assert np.array_equal(_decode(t, have), t["datas"][idx])


@pytest.mark.parametrize("idx", [2, 4])
def test_streaming_retriever_non_power_of_two(ctx, idx):
    """Five inputs (partial blocks merge in flush)."""
    j, t = ctx
    js, ts = _sel(ctx, idx, 3, 0x70 + 2 * idx)
    have = tret.GLWEBlindRetriever(5).retrieve(t["m"], t["cts"][:5], ts)
    assert _eq(have.data, tbdd.blind_select(t["m"], ts, t["cts"][:5]).data)
    assert _eq(have.data, jret.GLWEBlindRetriever(5).retrieve(j["m"], j["cts"][:5], js).data)
    assert np.array_equal(_decode(t, have), t["datas"][idx])


def test_streaming_retriever_incremental_and_offset(ctx):
    """`add` one at a time keeps at most two live slots; offset 2 on the
    selector 0b1101 reads index 3; the capacity and empty-flush errors."""
    j, t = ctx
    js, ts = _sel(ctx, 0b1101, 4, 0x90)
    have, want = tret.GLWEBlindRetriever(4), jret.GLWEBlindRetriever(4)
    for tc, jc in zip(t["cts"][:4], j["cts"][:4]):
        have.add(t["m"], tc, ts, offset=2)
        want.add(j["m"], jc, js, offset=2)
        assert sum(s[1] for s in have._slots) <= 2
        assert [s[1] for s in have._slots] == [s[1] for s in want._slots]
    out = have.flush(t["m"], ts, offset=2)
    assert _eq(out.data, want.flush(j["m"], js, offset=2).data)
    assert np.array_equal(_decode(t, out), t["datas"][3])
    full = tret.GLWEBlindRetriever(2)
    full.add(t["m"], t["cts"][0], ts)
    full.add(t["m"], t["cts"][1], ts)
    with pytest.raises(ValueError, match="Accumulating limit of 2 reached"):
        full.add(t["m"], t["cts"][2], ts)
    with pytest.raises(ValueError, match="no accumulated inputs"):
        tret.GLWEBlindRetriever(4).flush(t["m"], ts)
    with pytest.raises(ValueError, match="capacity"):
        tret.GLWEBlindRetriever(0)


@pytest.mark.parametrize("bit", [0, 1])
def test_cswap(ctx, bit):
    """(a, b) under bit 0, (b, a) under bit 1, through one product."""
    j, t = ctx
    js, ts = _sel(ctx, bit, 1, 0xB0 + bit)
    have = tret.glwe_cswap(t["m"], t["cts"][0], t["cts"][1], ts.bits[0])
    want = jret.glwe_cswap(j["m"], j["cts"][0], j["cts"][1], js.bits[0])
    assert all(_eq(h.data, w.data) for h, w in zip(have, want))
    order = (1, 0) if bit else (0, 1)
    assert all(np.array_equal(_decode(t, h), t["datas"][i]) for h, i in zip(have, order))


@pytest.mark.parametrize("idx", [0, 3, 6])
def test_butterfly_retrieval_and_rev(ctx, idx):
    """Element 0 of the butterfly encrypts cts[idx]; the reverse network
    restores every position; both equal the JAX package's."""
    j, t = ctx
    js, ts = _sel(ctx, idx, 3, 0xD0 + 2 * idx)
    have = tret.glwe_blind_retrieval(t["m"], t["cts"][:8], ts)
    want = jret.glwe_blind_retrieval(j["m"], j["cts"][:8], js)
    assert all(_eq(h.data, w.data) for h, w in zip(have, want, strict=True))
    assert np.array_equal(_decode(t, have[0]), t["datas"][idx])
    back = tret.glwe_blind_retrieval_rev(t["m"], have, ts)
    assert all(_eq(h.data, w.data) for h, w in
               zip(back, jret.glwe_blind_retrieval_rev(j["m"], want, js), strict=True))
    for pos in range(8):
        assert np.array_equal(_decode(t, back[pos]), t["datas"][pos]), (idx, pos)


def test_butterfly_sub_field(ctx):
    """Selector 0b110 with bit_rsh 1, bit_mask 2 reads index 3."""
    j, t = ctx
    js, ts = _sel(ctx, 0b110, 3, 0xE8)
    have = tret.glwe_blind_retrieval(t["m"], t["cts"][:4], ts, bit_rsh=1, bit_mask=2)
    want = jret.glwe_blind_retrieval(j["m"], j["cts"][:4], js, bit_rsh=1, bit_mask=2)
    assert all(_eq(h.data, w.data) for h, w in zip(have, want, strict=True))
    assert np.array_equal(_decode(t, have[0]), t["datas"][3])


@pytest.mark.parametrize("idx,bit_rsh,bit_mask,want_key",
                         [(0, 0, 3, 0), (3, 0, 3, 3), (5, 0, 3, 5), (4, 0, 3, None),
                          (0b101, 1, 2, 2)])
def test_blind_selection_sparse_map(ctx, idx, bit_rsh, bit_mask, want_key):
    """The entry at the encrypted key of a map with keys 0, 2, 3, 5; a
    missing key reads as zero; a sub-field with bit_rsh / bit_mask."""
    j, t = ctx
    keys = [0, 2, 3, 5]
    js, ts = _sel(ctx, idx, 3, 0x10 + 2 * idx + bit_rsh)
    have = tret.glwe_blind_selection(t["m"], dict(zip(keys, t["cts"])), ts, bit_rsh, bit_mask)
    want = jret.glwe_blind_selection(j["m"], dict(zip(keys, j["cts"])), js, bit_rsh, bit_mask)
    assert _eq(have.data, want.data)
    expect = np.zeros(N, dtype=np.int64) if want_key is None else t["datas"][keys.index(want_key)]
    assert np.array_equal(_decode(t, have), expect)
    with pytest.raises(ValueError, match="empty map"):
        tret.glwe_blind_selection(t["m"], {}, ts)
