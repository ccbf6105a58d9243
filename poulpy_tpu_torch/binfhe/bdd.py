"""BDD arithmetic on packed encrypted integers: twin of
`poulpy_tpu/binfhe/bdd.py`.

The circuits are built by the same pure-Python constructions as the JAX
package's (a copy: the port imports nothing of it), so both evaluate the
same nodes in the same order.  Every BDD node is one CMux,

    node = sel ? hi : lo  =  lo + GGSW(sel) ⊡ (hi − lo),

the selectors being the circuit-bootstrapped input bits and the leaves
trivial GLWEs of 0 / 1.  A `FheUint` packs its bits in one GLWE (bit j at
coefficient j); `fheuint_prepare` extracts every bit to LWE and
circuit-bootstraps all of them in one batch.  On the card each CMux is one
fused product launch (`fused_product`); the preparation runs the CBT's
kernels (block steps or products, the trace's keyswitches, the expansion's
NTT and VMP) at batch `width`.  The layouts are plain dataclasses.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from poulpy_tpu_torch.binfhe.circuit_bootstrapping import (
    CircuitBootstrappingKey,
    circuit_bootstrap,
)
from poulpy_tpu_torch.core import encryption as enc
from poulpy_tpu_torch.core.conversion import lwe_sample_extract
from poulpy_tpu_torch.core.decryption import glwe_decrypt
from poulpy_tpu_torch.core.external_product import glwe_cmux
from poulpy_tpu_torch.core.keyswitching import glwe_keyswitch
from poulpy_tpu_torch.core.layouts import (
    GGSWCiphertext,
    GLWECiphertext,
    GLWEPlaintext,
    _Replace,
    glwe_size,
)
from poulpy_tpu_torch.core.operations import glwe_rotate
from poulpy_tpu_torch.core.prepared import GGLWEPrepared, GGSWPrepared, ggsw_prepare
from poulpy_tpu_torch.hal import vec_znx
from poulpy_tpu_torch.hal.module import Module
from poulpy_tpu_torch.hal.normalization import vec_znx_normalize

# ---- BDD representation and construction ------------------------------------------------
#
# A circuit is a tuple of nodes (var, lo, hi): var an input bit index, lo / hi
# earlier nodes or the leaves -1 (FALSE) and -2 (TRUE).  For two w-bit
# operands var 2i is a_i and var 2i+1 is b_i (LSB first).

FALSE, TRUE = -1, -2


@dataclass(frozen=True)
class BDD:
    nodes: tuple  # tuple of (var, lo, hi)
    root: int


class _Builder:
    def __init__(self):
        self.nodes = []
        self.cache = {}

    def mk(self, var, lo, hi):
        if lo == hi:
            return lo
        key = (var, lo, hi)
        if key not in self.cache:
            self.nodes.append(key)
            self.cache[key] = len(self.nodes) - 1
        return self.cache[key]

    def freeze(self, root) -> BDD:
        return BDD(nodes=tuple(self.nodes), root=root)


def _add_bit_bdd(width: int, out_bit: int, sub: bool = False) -> BDD:
    """Bit `out_bit` of a + b (or a − b): nodes track the carry (borrow),
    variables LSB first up to out_bit."""
    del width
    b = _Builder()
    memo = {}

    def build(i, carry):
        key = (i, carry)
        if key in memo:
            return memo[key]
        if i == out_bit:
            def leaf(ai, bi):
                return TRUE if (ai ^ bi ^ carry) else FALSE

            n_b0 = b.mk(2 * i + 1, leaf(0, 0), leaf(0, 1))
            n_b1 = b.mk(2 * i + 1, leaf(1, 0), leaf(1, 1))
            node = b.mk(2 * i, n_b0, n_b1)
        else:
            def next_carry(ai, bi):
                if sub:
                    return 1 if (ai - bi - carry) < 0 else 0
                return 1 if (ai + bi + carry) >= 2 else 0

            subs = {}
            for ai in (0, 1):
                lo = build(i + 1, next_carry(ai, 0))
                hi = build(i + 1, next_carry(ai, 1))
                subs[ai] = b.mk(2 * i + 1, lo, hi)
            node = b.mk(2 * i, subs[0], subs[1])
        memo[key] = node
        return node

    return b.freeze(build(0, 0))


def _cmp_bdd(width: int, signed: bool) -> BDD:
    """a < b (signed or unsigned), MSB first: the state is "still equal"."""
    b = _Builder()
    memo = {}

    def build(i):
        if i < 0:
            return FALSE  # equal: not less-than
        if i in memo:
            return memo[i]
        lower = build(i - 1)
        lt, gt = TRUE, FALSE
        if signed and i == width - 1:
            lt, gt = gt, lt  # the sign bit inverts the order
        n_a0 = b.mk(2 * i + 1, lower, lt)
        n_a1 = b.mk(2 * i + 1, gt, lower)
        node = b.mk(2 * i, n_a0, n_a1)
        memo[i] = node
        return node

    return b.freeze(build(width - 1))


def _shift_bdd(width: int, out_bit: int, kind: str) -> BDD:
    """Bit `out_bit` of a shifted by the low log2(width) bits of b (sll, srl,
    sra): a Shannon expansion over the amount's bits selects the data bit (or
    0, or the sign bit) that reaches it."""
    logw = (width - 1).bit_length()
    b = _Builder()

    def src_bit(shift: int) -> int | None:
        if kind == "sll":
            j = out_bit - shift
            return j if j >= 0 else None
        if kind == "srl":
            j = out_bit + shift
            return j if j < width else None
        if kind == "sra":
            return min(out_bit + shift, width - 1)
        raise ValueError(kind)

    def build(bit_idx: int, shift: int) -> int:
        if bit_idx < 0:
            j = src_bit(shift)
            return FALSE if j is None else b.mk(2 * j, FALSE, TRUE)
        lo = build(bit_idx - 1, shift)
        hi = build(bit_idx - 1, shift | (1 << bit_idx))
        return b.mk(2 * bit_idx + 1, lo, hi)

    return b.freeze(build(logw - 1, 0))


def _bitwise_bdd(i: int, fn) -> BDD:
    bld = _Builder()

    def leaf(ai, bi):
        return TRUE if fn(ai, bi) & 1 else FALSE

    n_b0 = bld.mk(2 * i + 1, leaf(0, 0), leaf(0, 1))
    n_b1 = bld.mk(2 * i + 1, leaf(1, 0), leaf(1, 1))
    return bld.freeze(bld.mk(2 * i, n_b0, n_b1))


_BITWISE = {"and": lambda a, b: a & b, "or": lambda a, b: a | b, "xor": lambda a, b: a ^ b}
_CIRCUIT_CACHE: dict = {}


def bdd_circuit(op: str, width: int) -> list[BDD]:
    """The BDDs of every output bit of a two-operand op (add, sub, and, or,
    xor, slt, sltu, sll, srl, sra, identity), built on demand and cached."""
    key = (op, width)
    if key in _CIRCUIT_CACHE:
        return _CIRCUIT_CACHE[key]
    if op in ("add", "sub"):
        out = [_add_bit_bdd(width, i, sub=op == "sub") for i in range(width)]
    elif op in _BITWISE:
        out = [_bitwise_bdd(i, _BITWISE[op]) for i in range(width)]
    elif op in ("slt", "sltu"):
        out = [_cmp_bdd(width, op == "slt")]
    elif op in ("sll", "srl", "sra"):
        out = [_shift_bdd(width, i, op) for i in range(width)]
    elif op == "identity":
        out = []
        for i in range(width):
            bld = _Builder()
            out.append(bld.freeze(bld.mk(2 * i, FALSE, TRUE)))
    else:
        raise ValueError(op)
    _CIRCUIT_CACHE[key] = out
    return out


def bdd_shift_circuit(kind: str, width: int) -> list[BDD]:
    """The shift circuits alone (shares `bdd_circuit`'s cache)."""
    key = (kind, width)
    if key not in _CIRCUIT_CACHE:
        _CIRCUIT_CACHE[key] = [_shift_bdd(width, i, kind) for i in range(width)]
    return _CIRCUIT_CACHE[key]


def eval_bdd_plain(bdd: BDD, a: int, b: int) -> int:
    """The BDD on plaintext ints (the circuits' oracle)."""
    ref = bdd.root
    while ref not in (TRUE, FALSE):
        var, lo, hi = bdd.nodes[ref]
        ref = hi if ((b if var % 2 else a) >> (var // 2)) & 1 else lo
    return 1 if ref == TRUE else 0


# ---- layouts -----------------------------------------------------------------------------

@dataclass(frozen=True)
class FheUint(_Replace):
    """All bits of an unsigned integer in one GLWE, bit j at coefficient j."""

    glwe: GLWECiphertext
    width: int


@dataclass(frozen=True)
class FheUintPrepared(_Replace):
    """One prepared GGSW selector per bit."""

    bits: list[GGSWPrepared]
    width: int


@dataclass(frozen=True)
class BDDKey(_Replace):
    """The circuit-bootstrapping key, the GLWE → LWE switching key and the
    parameters of `fheuint_prepare`; `ks_glwe`, where given, first switches
    the input GLWE to the bootstrapping key's rank."""

    cbt: CircuitBootstrappingKey
    ks_lwe: GGLWEPrepared
    n_lwe: int
    base2k: int
    k_ct: int
    dnum_ggsw: int
    k_ggsw: int
    extension_factor: int = 1
    ks_glwe: GGLWEPrepared | None = None


def fheuint_encrypt(module: Module, value: int, width: int, skp, base2k: int, k_ct: int,
                    source_xe, source_xa) -> FheUint:
    """The bits of `value` at torus 1/4 (k 2): circuit bootstrapping with
    log_domain 1 needs the phase of a 1 in the positive half-circle."""
    bits = torch.zeros(module.n, dtype=torch.int64)
    bits[:width] = torch.tensor([(value >> j) & 1 for j in range(width)], dtype=torch.int64)
    pt = GLWEPlaintext(data=vec_znx.encode_vec_i64(base2k, 2, glwe_size(base2k, k_ct),
                                                   bits.to(module.device)),
                       base2k=base2k, k=2)
    glwe = enc.glwe_encrypt_sk(module, pt, skp, base2k, k_ct, source_xe, source_xa)
    return FheUint(glwe=glwe, width=width)


def fheuint_decrypt(module: Module, ct: FheUint, skp) -> int:
    pt = glwe_decrypt(module, ct.glwe, skp)
    bits = vec_znx.decode_vec_i64(ct.glwe.base2k, 2, pt.data).cpu()
    return sum((int(bits[j]) & 1) << j for j in range(ct.width))


def _selectors(module: Module, ggsw: GGSWCiphertext, width: int) -> FheUintPrepared:
    prepared = ggsw_prepare(module, ggsw)       # pmat [width, dnum, ., ., ., P, N]
    return FheUintPrepared(bits=[prepared.replace(pmat=prepared.pmat[j]) for j in range(width)],
                           width=width)


def fheuint_prepare(module: Module, ct: FheUint, key: BDDKey) -> FheUintPrepared:
    """Every bit to a GGSW selector in one batch: the rank reduction where
    the key has one, the GLWE rotated by −j for each bit j (a leading axis of
    `width`), the GLWE → LWE keyswitch, the sample extraction, the circuit
    bootstrap (log_domain 1, to-constant) and the GGSW preparation; bit j's
    selector is a view of the batched prepared matrix."""
    w = ct.width
    glwe = ct.glwe
    if key.ks_glwe is not None:
        glwe = glwe_keyswitch(module, glwe, key.ks_glwe, key.base2k, key.k_ct)
    shifts = -torch.arange(w, dtype=torch.int64, device=module.device)[:, None, None]
    rot = glwe_rotate(shifts, glwe)                                  # [w, rank+1, size, N]
    ks = glwe_keyswitch(module, rot, key.ks_lwe, key.base2k, key.k_ct)
    lwe = lwe_sample_extract(ks, key.n_lwe, key.k_ct)
    ggsw = circuit_bootstrap(module, lwe, 1, key.cbt, dnum_res=key.dnum_ggsw, k_res=key.k_ggsw,
                             to_exponent=False, extension_factor=key.extension_factor)
    return _selectors(module, ggsw, w)


def fheuint_prepared_encrypt_sk(module: Module, value: int, width: int, skp, base2k: int, k: int,
                                dnum: int, source_xe, source_xa) -> FheUintPrepared:
    """`value` straight into selectors, each bit a constant-GGSW encryption
    (the debug factory: no packed GLWE, no circuit bootstrap), all bits in
    one batched `ggsw_encrypt_sk`."""
    pt = torch.zeros((width, module.n), dtype=torch.int64)
    pt[:, 0] = torch.tensor([(value >> i) & 1 for i in range(width)], dtype=torch.int64)
    ggsw = enc.ggsw_encrypt_sk(module, pt.to(module.device), skp, base2k, k, dnum, source_xe,
                               source_xa)
    return _selectors(module, ggsw, width)


# ---- evaluation --------------------------------------------------------------------------

def _trivial_bit(module: Module, bit: int, coeff: int, base2k: int, k: int,
                 rank: int) -> GLWECiphertext:
    """The noiseless GLWE of bit·2^-2 at coefficient `coeff`, on the module's device."""
    data = torch.zeros((rank + 1, glwe_size(base2k, k), module.n), dtype=torch.int64,
                       device=module.device)
    if bit:
        data[0, 0, coeff] = 1 << (base2k - 2)
    return GLWECiphertext(data=data, base2k=base2k, k=k)


def eval_bdd_bit(module: Module, bdd: BDD, sel_a: FheUintPrepared, sel_b: FheUintPrepared,
                 out_coeff: int, base2k: int, k: int) -> GLWECiphertext:
    """One output bit's BDD, bottom up: one `glwe_cmux` per node reached
    from the root, each node evaluated once."""
    rank = sel_a.bits[0].rank
    cache: dict[int, GLWECiphertext] = {}

    def value(ref):
        if ref in (TRUE, FALSE):
            return _trivial_bit(module, 1 if ref == TRUE else 0, out_coeff, base2k, k, rank)
        if ref not in cache:
            var, lo, hi = bdd.nodes[ref]
            sel = (sel_b if var % 2 else sel_a).bits[var // 2]
            cache[ref] = glwe_cmux(module, sel, value(hi), value(lo))
        return cache[ref]

    return value(bdd.root)


def fheuint_op(module: Module, op: str, a: FheUintPrepared, b: FheUintPrepared, base2k: int,
               k: int) -> GLWECiphertext:
    """op(a, b): every output bit's GLWE (bit j at coefficient j) summed
    into one packed GLWE, then normalized."""
    acc = None
    for j, bdd in enumerate(bdd_circuit(op, a.width)):
        bit = eval_bdd_bit(module, bdd, a, b, j, base2k, k)
        acc = bit if acc is None else acc.replace(data=acc.data + bit.data)
    return acc.replace(data=vec_znx_normalize(base2k, acc.data))


def fheuint_op_1w(module: Module, op: str, a: FheUintPrepared, base2k: int,
                  k: int) -> GLWECiphertext:
    """A one-operand circuit (`identity` re-packs the selectors into a fresh
    packed GLWE)."""
    return fheuint_op(module, op, a, a, base2k, k)


# ---- selection and rotation by an encrypted index ----------------------------------------

def blind_select(module: Module, selector_bits: FheUintPrepared,
                 options: list[GLWECiphertext]) -> GLWECiphertext:
    """options[j] for the encrypted index j: a CMux tree over the selector's
    bits, LSB first."""
    level = list(options)
    for sel in selector_bits.bits:
        if len(level) == 1:
            break
        level = [glwe_cmux(module, sel, level[i + 1], level[i]) if i + 1 < len(level)
                 else level[i] for i in range(0, len(level), 2)]
    return level[0]


def glwe_blind_rotation(module: Module, a: GLWECiphertext, k: FheUintPrepared,
                        sign: bool = False, bit_rsh: int = 0, bit_mask: int | None = None,
                        bit_lsh: int = 0) -> GLWECiphertext:
    """a · X^{±((k >> bit_rsh) mod 2^bit_mask) << bit_lsh} for the encrypted
    exponent k: one CMux per exponent bit between the rotated and the
    unrotated accumulator."""
    nbits = (k.width - bit_rsh) if bit_mask is None else bit_mask
    res = a
    for i in range(nbits):
        amt = 1 << (i + bit_lsh)
        res = glwe_cmux(module, k.bits[bit_rsh + i], glwe_rotate(-amt if sign else amt, res),
                        res)
    return res


def ggsw_blind_rotation(module: Module, a: GGSWCiphertext, k: FheUintPrepared,
                        sign: bool = False, bit_rsh: int = 0, bit_mask: int | None = None,
                        bit_lsh: int = 0) -> GGSWCiphertext:
    """The GGSW counterpart: its (dnum, rank+1) rows are leading batch axes
    of one chain of batched CMuxes."""
    rows = GLWECiphertext(data=a.data, base2k=a.base2k, k=a.k)
    out = glwe_blind_rotation(module, rows, k, sign=sign, bit_rsh=bit_rsh, bit_mask=bit_mask,
                              bit_lsh=bit_lsh)
    return a.replace(data=out.data)
