"""Prepared (DFT-domain) layouts: twins of `poulpy_tpu/core/prepared.py`
(the port's part).

  GLWESecretPrepared     data [rank, P, N]                          (Montgomery)
  GGLWEPrepared          pmat [dnum, rank_in, rank_out+1, size, P, N] (Montgomery)
  GGSWPrepared           pmat [dnum, rank+1, rank+1, size, P, N]     (Montgomery)
  GLWEAutomorphismKeyPrepared  a GGLWEPrepared and its Galois element p
  GLWETensorKeyPrepared  rank(rank+1)/2 GGLWEPrepared for the s_i·s_j terms
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from poulpy_tpu_torch.core.layouts import GGLWECiphertext, GGSWCiphertext, GLWESecret, _Replace
from poulpy_tpu_torch.hal import dft
from poulpy_tpu_torch.hal.module import Module


@dataclass(frozen=True)
class GLWESecretPrepared(_Replace):
    data: torch.Tensor  # [rank, P, N] Montgomery NTT
    dist: str = "ternary_prob"

    @property
    def rank(self) -> int:
        return self.data.shape[-3]


@dataclass(frozen=True)
class GGLWEPrepared(_Replace):
    pmat: torch.Tensor  # [dnum, rank_in, rank_out+1, size, P, N]
    base2k: int
    k: int
    dsize: int = 1

    @property
    def dnum(self) -> int:
        return self.pmat.shape[-6]

    @property
    def rank_in(self) -> int:
        return self.pmat.shape[-5]

    @property
    def rank_out(self) -> int:
        return self.pmat.shape[-4] - 1

    @property
    def size(self) -> int:
        return self.pmat.shape[-3]


@dataclass(frozen=True)
class GGSWPrepared(_Replace):
    pmat: torch.Tensor  # [dnum, rank+1, rank+1, size, P, N]
    base2k: int
    k: int
    dsize: int = 1

    @property
    def dnum(self) -> int:
        return self.pmat.shape[-6]

    @property
    def rank(self) -> int:
        return self.pmat.shape[-4] - 1

    @property
    def size(self) -> int:
        return self.pmat.shape[-3]


@dataclass(frozen=True)
class GLWEAutomorphismKeyPrepared(_Replace):
    """Switches φ_{p^{-1}}(s) → s; applied with the permutation X → X^p."""

    key: GGLWEPrepared
    p: int


@dataclass(frozen=True)
class GLWETensorKeyPrepared(_Replace):
    """Relinearization keys: keys[(i, j)] switches s_i·s_j → s."""

    keys: dict[tuple[int, int], GGLWEPrepared]


def glwe_secret_prepare(module: Module, sk: GLWESecret) -> GLWESecretPrepared:
    return GLWESecretPrepared(data=dft.svp_prepare(module, sk.data), dist=sk.dist)


def ggsw_prepare(module: Module, ct: GGSWCiphertext) -> GGSWPrepared:
    return GGSWPrepared(pmat=dft.vmp_prepare(module, ct.data), base2k=ct.base2k, k=ct.k,
                        dsize=ct.dsize)


def gglwe_prepare(module: Module, ct: GGLWECiphertext) -> GGLWEPrepared:
    return GGLWEPrepared(pmat=dft.vmp_prepare(module, ct.data), base2k=ct.base2k, k=ct.k,
                         dsize=ct.dsize)


def glwe_tensor_key_prepare(module: Module, keys: dict) -> GLWETensorKeyPrepared:
    return GLWETensorKeyPrepared(keys={k: gglwe_prepare(module, v) for k, v in keys.items()})
