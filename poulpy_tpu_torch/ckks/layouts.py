"""CKKS ciphertext / plaintext layouts: twins of `poulpy_tpu/ckks/layouts.py`
as frozen dataclasses with `replace`, like `core/layouts.py`."""

from __future__ import annotations

from dataclasses import dataclass

from poulpy_tpu_torch.core.layouts import GLWECiphertext, GLWEPlaintext, _Replace


@dataclass(frozen=True)
class CKKSMeta(_Replace):
    """log_delta: scale bits; log_budget: remaining headroom bits."""

    log_delta: int
    log_budget: int

    @property
    def effective_k(self) -> int:
        return self.log_delta + self.log_budget


@dataclass(frozen=True)
class CKKSCiphertext(_Replace):
    glwe: GLWECiphertext
    meta: CKKSMeta

    @property
    def log_delta(self) -> int:
        return self.meta.log_delta

    @property
    def log_budget(self) -> int:
        return self.meta.log_budget

    @property
    def effective_k(self) -> int:
        return self.meta.effective_k


@dataclass(frozen=True)
class CKKSPlaintext(_Replace):
    pt: GLWEPlaintext
    meta: CKKSMeta
