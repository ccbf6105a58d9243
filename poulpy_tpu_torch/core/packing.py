"""GLWE trace and slot packing: twin of `poulpy_tpu/core/packing.py`.

Trace: res = Σ of the Galois conjugates, which projects onto the
coefficient-0 subspace.  Packing merges the coefficient-0 slots of up to N
ciphertexts into one through the recursion a ← a + b·X^t + φ(a − b·X^t),
halving (rsh by 1) at each level in place of a modulus switch.  Every
keyswitch is `glwe_keyswitch`: one fused product with the body added
(`fused_product_small`) on the card.
"""

from __future__ import annotations

from poulpy_tpu_torch.core.automorphism import glwe_automorphism, glwe_automorphism_add
from poulpy_tpu_torch.core.layouts import GLWECiphertext
from poulpy_tpu_torch.core.operations import (
    glwe_add,
    glwe_normalize_inplace,
    glwe_rotate,
    glwe_rsh,
    glwe_sub,
)
from poulpy_tpu_torch.core.prepared import GLWEAutomorphismKeyPrepared
from poulpy_tpu_torch.hal.module import Module


def _level_element(module: Module, i: int) -> int:
    """The Galois element of trace / packing level i: −1, then 5^{2^{i−1}}."""
    return -1 if i == 0 else module.galois_element(1 << (i - 1))


def trace_galois_elements(module: Module) -> list[int]:
    """The elements of the log N trace levels (−1 literally at level 0)."""
    return [_level_element(module, i) for i in range(module.log_n)]


def glwe_trace(module: Module, a: GLWECiphertext, keys: dict[int, GLWEAutomorphismKeyPrepared],
               skip: int = 0) -> GLWECiphertext:
    """Per level from `skip`: halve, then add the conjugate.  `keys` maps
    the elements of `trace_galois_elements` to prepared keys."""
    res = a
    for i in range(skip, module.log_n):
        res = glwe_automorphism_add(module, glwe_rsh(1, res), keys[_level_element(module, i)])
    return res


def glwe_pack(module: Module, cts: dict[int, GLWECiphertext],
              keys: dict[int, GLWEAutomorphismKeyPrepared], log_gap_out: int = 0) -> GLWECiphertext:
    """Pack the coefficient-0 slot of `cts[j]` into coefficient
    j·2^{log_gap_out} of one ciphertext: a tree merge of partner slots j and
    j + t (t = N/2^{i+1}) at level i, then a trace over the remaining
    levels."""
    log_n = module.log_n
    a = dict(cts)
    if max(a) >= module.n:
        raise ValueError(f"slot {max(a)} does not fit N = {module.n}")
    for i in range(log_n - log_gap_out):
        t = min(module.n, 1 << (log_n - 1 - i))
        key = keys[_level_element(module, i)]
        for j in range(t):
            merged = _pack_internal(module, a.pop(j, None), a.pop(j + t, None), i, key)
            if merged is not None:
                a[j] = merged
    return glwe_trace(module, a[0], keys, skip=log_n - log_gap_out)


def _pack_internal(module: Module, a: GLWECiphertext | None, b: GLWECiphertext | None, i: int,
                   key: GLWEAutomorphismKeyPrepared) -> GLWECiphertext | None:
    """One merge of level i: (a·X^{-t} + b)/2 − φ((a·X^{-t} − b)/2), times
    X^t; a missing `a` or `b` takes its branch, both missing give None."""
    if a is None and b is None:
        return None
    t = 1 << (module.log_n - i - 1)
    if a is None:
        tmp = glwe_rsh(1, glwe_rotate(t, b))
        return glwe_sub(tmp, glwe_automorphism(module, tmp, key, b.base2k, b.k))
    if b is None:
        return glwe_automorphism_add(module, glwe_rsh(1, a), key)
    a = glwe_rotate(-t, a)
    tmp = glwe_normalize_inplace(glwe_rsh(1, glwe_sub(a, b)))
    a = glwe_rsh(1, glwe_add(a, b))
    tmp = glwe_automorphism(module, tmp, key, a.base2k, a.k)
    return glwe_rotate(t, glwe_normalize_inplace(glwe_sub(a, tmp)))


class GLWEPacker:
    """Streaming packer with log N accumulators: ciphertexts come one at a
    time and a binary-counter tree folds pairs with the recursion of
    `glwe_pack`.  The output's coefficients come in bit-reversed order."""

    def __init__(self, module: Module, log_batch: int = 0):
        self.module = module
        self.log_batch = log_batch
        self.accs: list = [(None, False)] * (module.log_n - log_batch)   # (value, control)
        self.counter = 0

    def add(self, ct: GLWECiphertext | None, keys) -> None:
        """Feed the next ciphertext (None for an empty slot)."""
        if self.counter >= self.module.n >> self.log_batch:
            raise ValueError("packer full")
        self._pack_core(ct, 0, keys)
        self.counter += 1

    def _pack_core(self, a, j: int, keys) -> None:
        """The binary-counter fold from accumulator j up."""
        if j == len(self.accs):
            return
        level = self.log_batch + j
        val, ctrl = self.accs[j]
        if not ctrl:
            self.accs[j] = (a, True)
            return
        merged = _pack_internal(self.module, val, a, level,
                                keys[_level_element(self.module, level)])
        # the merged value stays in place: the last accumulator holds the
        # result for flush()
        self.accs[j] = (merged, False)
        self._pack_core(merged, j + 1, keys)

    def flush(self) -> GLWECiphertext:
        """The packed result; the packer starts over."""
        if self.counter != self.module.n >> self.log_batch:
            raise ValueError("packer not full")
        out = self.accs[-1][0]
        self.accs = [(None, False)] * len(self.accs)
        self.counter = 0
        return out
