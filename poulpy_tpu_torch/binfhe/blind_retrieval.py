"""Streaming oblivious retrieval and conditional-swap networks: twin of
`poulpy_tpu/binfhe/blind_retrieval.py`.

`GLWEBlindRetriever` takes a stream of GLWEs one at a time and keeps
O(log n) of them: slot i holds the CMux combination of an aligned block of
2^i inputs, and two full blocks of one level merge upward, as a binary
carry-save counter.  Its combine schedule is `bdd.blind_select`'s tree, so
the two give equal results.  The butterfly networks stack the pairs of a
stage on a new leading axis: one external product per stage.  Each GLWE
may carry leading batch axes.
"""

from __future__ import annotations

import torch

from poulpy_tpu_torch.core.external_product import glwe_cmux, glwe_external_product
from poulpy_tpu_torch.core.layouts import GLWECiphertext
from poulpy_tpu_torch.core.operations import glwe_add, glwe_sub
from poulpy_tpu_torch.hal.module import Module

__all__ = [
    "GLWEBlindRetriever",
    "glwe_cswap",
    "glwe_blind_retrieval",
    "glwe_blind_retrieval_rev",
    "glwe_blind_selection",
]


def _get_bit(selector, i):
    """Selector bit i of a `FheUintPrepared` or of a sequence of prepared GGSWs."""
    return getattr(selector, "bits", selector)[i]


def glwe_cswap(module: Module, a: GLWECiphertext, b: GLWECiphertext,
               sel) -> tuple[GLWECiphertext, GLWECiphertext]:
    """(a, b) if sel = 0, (b, a) if sel = 1, through one external product
    shared by both outputs: d = sel ⊡ (b − a); a' = a + d; b' = b − d."""
    d = glwe_external_product(module, glwe_sub(b, a), sel, a.base2k, a.k)
    return glwe_add(a, d), glwe_sub(b, d)


class GLWEBlindRetriever:
    """Retrieves one GLWE from a stream by an encrypted binary index.

    `capacity` bounds the `add` calls between resets; the state is
    ⌈log2 capacity⌉ slots, each empty or holding one combined GLWE.  `flush`
    returns the encryption of data[idx], idx the value of the selector bits
    offset .. offset + nbits (bit i picks the higher-index half of each
    2^(i+1)-aligned block)."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        nbits = max(1, (capacity - 1).bit_length())
        # slot = [data | None, num in {0, 1}]; the top slot's data outlives
        # num = 0, as flush reads it unconditionally
        self._slots: list[list] = [[None, 0] for _ in range(nbits)]
        self.capacity = capacity
        self.counter = 0

    def reset(self) -> None:
        for s in self._slots:
            s[1] = 0
        self.counter = 0

    def _add_core(self, module, a, i, selector, offset):
        """Carry a combined block of 2^i inputs into slot i."""
        slots = self._slots
        while i < len(slots):
            if slots[i][1] == 0:
                slots[i][0], slots[i][1] = a, 1
                return
            # the later-streamed (higher-index) operand when the bit is 1
            a = glwe_cmux(module, _get_bit(selector, i + offset), a, slots[i][0])
            slots[i][0], slots[i][1] = a, 0
            i += 1

    def add(self, module: Module, ct: GLWECiphertext, selector, offset: int = 0) -> None:
        """Stream in the next input."""
        if self.counter >= self.capacity:
            raise ValueError(f"Accumulating limit of {self.capacity} reached")
        self._add_core(module, ct, 0, selector, offset)
        self.counter += 1

    def flush(self, module: Module, selector, offset: int = 0) -> GLWECiphertext:
        """Merge the partial blocks upward and return the retrieved GLWE.  An
        empty accumulator raises: it holds no GLWE to shape a zero from."""
        if self.counter == 0:
            raise ValueError("flush with no accumulated inputs (there is no GLWE to shape "
                             "a zero ciphertext from)")
        slots = self._slots
        for i in range(len(slots) - 1):
            if slots[i][1] != 0:
                self._add_core(module, slots[i][0], i + 1, selector, offset)
                slots[i][1] = 0
        res = slots[-1][0]
        self.reset()
        return res

    def retrieve(self, module: Module, data, selector, offset: int = 0) -> GLWECiphertext:
        """reset, `add` of each input, `flush`."""
        self.reset()
        for ct in data:
            self.add(module, ct, selector, offset)
        return self.flush(module, selector, offset)


def _batched_cswap_stage(module, res, pairs, bit):
    """One butterfly stage: its (lo, hi) pairs share the selector bit, so
    they stack on a new leading axis through one external product."""
    if len(pairs) == 1:
        j, jt = pairs[0]
        res[j], res[jt] = glwe_cswap(module, res[j], res[jt], bit)
        return
    lo = res[pairs[0][0]]
    lo_stack = lo.replace(data=torch.stack([res[j].data for j, _ in pairs]))
    hi_stack = lo.replace(data=torch.stack([res[jt].data for _, jt in pairs]))
    lo2, hi2 = glwe_cswap(module, lo_stack, hi_stack, bit)
    for p, (j, jt) in enumerate(pairs):
        res[j] = lo.replace(data=lo2.data[p])
        res[jt] = lo.replace(data=hi2.data[p])


def glwe_blind_selection(module: Module, a: dict, selector, bit_rsh: int = 0,
                         bit_mask: int | None = None) -> GLWECiphertext:
    """The GLWE at key (idx >> bit_rsh) mod 2^bit_mask of the map `a`, idx
    the encrypted selector; a missing key acts as an encryption of zero
    (a CMux tree, MSB to LSB)."""
    if not a:
        raise ValueError("blind_selection: empty map")
    if bit_mask is None:
        bit_mask = len(getattr(selector, "bits", selector)) - bit_rsh
    entries = dict(a)
    proto = next(iter(entries.values()))
    zero = proto.replace(data=torch.zeros_like(proto.data))   # on the entries' device
    for i in range(bit_mask):
        t = 1 << (bit_mask - i - 1)
        bit = _get_bit(selector, bit_rsh + bit_mask - i - 1)
        for j in range(t):
            low = entries.pop(j, None)
            high = entries.pop(j + t, None)
            if low is None and high is None:
                continue
            entries[j] = glwe_cmux(module, bit, zero if high is None else high,
                                   zero if low is None else low)
    return entries.get(0, zero)


def _butterfly(module, cts, selector, bit_rsh, bit_mask, reverse):
    if bit_mask is None:
        bit_mask = len(getattr(selector, "bits", selector)) - bit_rsh
    res = list(cts)
    stages = range(bit_mask)
    for i in (reversed(stages) if reverse else stages):
        t = 1 << (bit_mask - i - 1)
        bit = _get_bit(selector, bit_rsh + bit_mask - i - 1)
        pairs = [(j, j + t) for j in range(t) if j + t < len(res)]
        if pairs:
            _batched_cswap_stage(module, res, pairs, bit)
    return res


def glwe_blind_retrieval(module: Module, cts: list[GLWECiphertext], selector, bit_rsh: int = 0,
                         bit_mask: int | None = None) -> list[GLWECiphertext]:
    """A butterfly of conditional swaps, MSB to LSB: element 0 of the result
    encrypts cts[(idx >> bit_rsh) mod 2^bit_mask]."""
    return _butterfly(module, cts, selector, bit_rsh, bit_mask, reverse=False)


def glwe_blind_retrieval_rev(module: Module, cts: list[GLWECiphertext], selector,
                             bit_rsh: int = 0,
                             bit_mask: int | None = None) -> list[GLWECiphertext]:
    """The stages in reverse order: undoes `glwe_blind_retrieval`'s
    permutation (up to noise)."""
    return _butterfly(module, cts, selector, bit_rsh, bit_mask, reverse=True)
