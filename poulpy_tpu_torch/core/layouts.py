"""Ciphertext / key layouts.

Twins of `poulpy_tpu/core/layouts.py` (the port's part) as frozen
dataclasses: tensor fields carry the limb data (batch over leading axes),
the other fields the parameters.  Same field names and shapes:

  GLWE           data [..., rank+1, size, N]      (col 0 = body)
  GLWEPlaintext  data [..., size, N]
  GGLWE          data [..., dnum, rank_in, rank_out+1, size, N]
  GGSW           data [..., dnum, rank+1, rank+1, size, N]
  LWE            data [..., size, n_lwe+1]        (coefficient 0 = body)
  GLWESecret     data [rank, N]
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


class _Replace:
    def replace(self, **changes):
        """A copy with `changes` applied (flax.struct's `replace`)."""
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class GLWECiphertext(_Replace):
    data: torch.Tensor
    base2k: int
    k: int

    @property
    def rank(self) -> int:
        return self.data.shape[-3] - 1

    @property
    def size(self) -> int:
        return self.data.shape[-2]

    @property
    def n(self) -> int:
        return self.data.shape[-1]

    @property
    def batch_shape(self):
        return tuple(self.data.shape[:-3])


@dataclass(frozen=True)
class GLWEPlaintext(_Replace):
    data: torch.Tensor
    base2k: int
    k: int

    @property
    def size(self) -> int:
        return self.data.shape[-2]

    @property
    def n(self) -> int:
        return self.data.shape[-1]


@dataclass(frozen=True)
class GGLWECiphertext(_Replace):
    """Gadget GLWE: row r, input col i encrypts pt_i·2^{-(r·dsize+dsize)·base2k}."""

    data: torch.Tensor
    base2k: int
    k: int
    dsize: int = 1

    @property
    def dnum(self) -> int:
        return self.data.shape[-5]

    @property
    def rank_in(self) -> int:
        return self.data.shape[-4]

    @property
    def rank_out(self) -> int:
        return self.data.shape[-3] - 1

    @property
    def size(self) -> int:
        return self.data.shape[-2]

    @property
    def n(self) -> int:
        return self.data.shape[-1]


@dataclass(frozen=True)
class GGSWCiphertext(_Replace):
    """Gadget GSW: row r, col j encrypts m·s_j·2^{-(r·dsize+dsize)·base2k}."""

    data: torch.Tensor
    base2k: int
    k: int
    dsize: int = 1

    @property
    def dnum(self) -> int:
        return self.data.shape[-5]

    @property
    def rank(self) -> int:
        return self.data.shape[-3] - 1

    @property
    def size(self) -> int:
        return self.data.shape[-2]

    @property
    def n(self) -> int:
        return self.data.shape[-1]


@dataclass(frozen=True)
class LWECiphertext(_Replace):
    """Scalar LWE, body and mask packed in one row per limb."""

    data: torch.Tensor  # [..., size, n_lwe+1]
    base2k: int
    k: int

    @property
    def n_lwe(self) -> int:
        return self.data.shape[-1] - 1

    @property
    def size(self) -> int:
        return self.data.shape[-2]


@dataclass(frozen=True)
class GLWESecret(_Replace):
    data: torch.Tensor  # [rank, N]
    dist: str = "ternary_prob"

    @property
    def rank(self) -> int:
        return self.data.shape[-2]

    @property
    def n(self) -> int:
        return self.data.shape[-1]


def glwe_size(base2k: int, k: int) -> int:
    """#limbs = ceil(k / base2k)."""
    return -(-k // base2k)
