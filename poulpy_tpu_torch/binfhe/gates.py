"""Boolean gate bootstrapping (NAND/AND/OR/NOR/XOR/XNOR/NOT on LWE bits):
twin of `poulpy_tpu/binfhe/gates.py`.

A gate is a linear combination of LWE ciphertexts, then the sign-LUT blind
rotation, the GLWE → LWE keyswitch and the coefficient-0 extraction.
Bit encoding: b ↦ (2b−1)/8 on the torus.  Every gate takes `route`
("fused", "mxu" or "fused_mxu"), passed to the blind rotation
(`blind_rotation_dispatch`) and to the keyswitch (`glwe_keyswitch`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from poulpy_tpu_torch.binfhe.blind_rotation import (
    BlindRotationKeyPrepared,
    blind_rotation_dispatch,
    blind_rotation_key_encrypt_sk,
)
from poulpy_tpu_torch.binfhe.lut import LookupTable
from poulpy_tpu_torch.core import encryption as enc
from poulpy_tpu_torch.core.conversion import glwe_to_lwe_key_encrypt_sk, lwe_sample_extract
from poulpy_tpu_torch.core.decryption import lwe_decrypt
from poulpy_tpu_torch.core.keyswitching import glwe_keyswitch
from poulpy_tpu_torch.core.layouts import GLWECiphertext, LWECiphertext, glwe_size
from poulpy_tpu_torch.core.prepared import GGLWEPrepared, glwe_secret_prepare
from poulpy_tpu_torch.hal.module import Module, get_module
from poulpy_tpu_torch.hal.normalization import vec_znx_normalize
from poulpy_tpu_torch.hal.source import Source


@dataclass(frozen=True)
class GateParams:
    """TFHE-style parameter set (the JAX package's defaults)."""

    n_glwe: int = 1024
    n_lwe: int = 571
    base2k: int = 17
    k_ct: int = 34        # LWE / accumulator torus precision (2 limbs)
    k_brk: int = 68       # blind rotation key precision
    dnum_brk: int = 4
    k_ksk: int = 51       # GLWE → LWE switching key precision
    dnum_ksk: int = 2
    nprimes: int = 2
    prime_bits: int = 28
    block_size: int = 1   # > 1 selects the block-binary CGGI path


@dataclass
class BootstrapKeys:
    module: Module
    params: GateParams
    brk: BlindRotationKeyPrepared
    to_lwe: GGLWEPrepared
    lut: LookupTable


def keygen(params: GateParams, seed: bytes = bytes(32),
           device="cuda") -> tuple[BootstrapKeys, torch.Tensor]:
    """(public bootstrap keys, LWE secret), all on `device`.  The stream of
    draws is the JAX package's: two child sources, the LWE secret, the GLWE
    secret, then the BRK and the switching key."""
    module = get_module(params.n_glwe, params.nprimes, params.prime_bits, device)
    src = Source(seed)
    xe, xa = src.branch()[1], src.branch()[1]
    if params.block_size > 1:
        sk_lwe = src.binary_block(params.n_lwe, params.block_size)
    else:
        sk_lwe = src.binary_prob((params.n_lwe,))
    sk_lwe = torch.from_numpy(sk_lwe).to(module.device)
    sk_glwe = enc.secret_new(module, 1, src)
    brk = blind_rotation_key_encrypt_sk(module, sk_lwe, glwe_secret_prepare(module, sk_glwe),
                                        params.base2k, params.k_brk, params.dnum_brk, xe, xa)
    to_lwe = glwe_to_lwe_key_encrypt_sk(module, sk_lwe, sk_glwe, params.base2k, params.k_ksk,
                                        params.dnum_ksk, xe, xa)
    return BootstrapKeys(module=module, params=params, brk=brk, to_lwe=to_lwe,
                         lut=_sign_lut(params, module.device)), sk_lwe


def _sign_lut(params: GateParams, device) -> LookupTable:
    """The gates' LUT: 1/8 on every coefficient; the negacyclic wrap makes
    coefficient 0 of X^{-phase}·LUT equal ±1/8."""
    data = torch.zeros((1, glwe_size(params.base2k, params.k_ct), params.n_glwe),
                       dtype=torch.int64, device=device)
    data[0, 0, :] = 1 << (params.base2k - 3)
    return LookupTable(data=vec_znx_normalize(params.base2k, data), base2k=params.base2k,
                       k=params.k_ct)


def encrypt_bit(params: GateParams, bits, sk_lwe, source_xe: Source,
                source_xa: Source) -> LWECiphertext:
    """b ↦ (2b−1)/8; `bits` is a scalar or an array.  The ciphertext lies on
    `sk_lwe`'s device."""
    bits = np.asarray(bits, dtype=np.int64)
    pt = np.zeros(bits.shape + (glwe_size(params.base2k, params.k_ct), 1), dtype=np.int64)
    pt[..., 0, 0] = (2 * bits - 1) << (params.base2k - 3)
    return enc.lwe_encrypt_sk(None, torch.from_numpy(pt), sk_lwe, params.base2k, params.k_ct,
                              source_xe, source_xa)


def decrypt_bit(ct: LWECiphertext, sk_lwe) -> np.ndarray:
    """The bits, as a numpy int64 array (0-d for one ciphertext)."""
    return (lwe_decrypt(ct, sk_lwe)[..., 0] > 0).to(torch.int64).cpu().numpy()


def _const_lwe(params: GateParams, num: int, den_log2: int, like: LWECiphertext):
    """Trivial LWE data of num·2^{-den_log2} (body only)."""
    data = torch.zeros_like(like.data)
    data[..., 0, 0] = num << (params.base2k - den_log2)
    return data


def _bootstrap(keys: BootstrapKeys, lin_data, route: str = "fused") -> LWECiphertext:
    """Sign-LUT blind rotation, keyswitch to the LWE secret, extraction."""
    params = keys.params
    lin = LWECiphertext(data=vec_znx_normalize(params.base2k, lin_data), base2k=params.base2k,
                        k=params.k_ct)
    acc = blind_rotation_dispatch(keys.module, lin, keys.lut, keys.brk, params.block_size, route)
    glwe = GLWECiphertext(data=acc, base2k=params.base2k, k=keys.lut.size * params.base2k)
    ks = glwe_keyswitch(keys.module, glwe, keys.to_lwe, params.base2k, params.k_ct, route=route)
    return lwe_sample_extract(ks, params.n_lwe, params.k_ct)


def gate_nand(keys: BootstrapKeys, c1: LWECiphertext, c2: LWECiphertext,
              route: str = "fused") -> LWECiphertext:
    return _bootstrap(keys, _const_lwe(keys.params, 1, 3, c1) - c1.data - c2.data, route)


def gate_and(keys: BootstrapKeys, c1: LWECiphertext, c2: LWECiphertext,
             route: str = "fused") -> LWECiphertext:
    return _bootstrap(keys, -_const_lwe(keys.params, 1, 3, c1) + c1.data + c2.data, route)


def gate_or(keys: BootstrapKeys, c1: LWECiphertext, c2: LWECiphertext,
            route: str = "fused") -> LWECiphertext:
    return _bootstrap(keys, _const_lwe(keys.params, 1, 3, c1) + c1.data + c2.data, route)


def gate_nor(keys: BootstrapKeys, c1: LWECiphertext, c2: LWECiphertext,
             route: str = "fused") -> LWECiphertext:
    return _bootstrap(keys, -_const_lwe(keys.params, 1, 3, c1) - c1.data - c2.data, route)


def gate_xor(keys: BootstrapKeys, c1: LWECiphertext, c2: LWECiphertext,
             route: str = "fused") -> LWECiphertext:
    return _bootstrap(keys, _const_lwe(keys.params, 1, 2, c1) + 2 * (c1.data + c2.data), route)


def gate_xnor(keys: BootstrapKeys, c1: LWECiphertext, c2: LWECiphertext,
              route: str = "fused") -> LWECiphertext:
    return _bootstrap(keys, -_const_lwe(keys.params, 1, 2, c1) - 2 * (c1.data + c2.data), route)


def gate_not(keys: BootstrapKeys, c1: LWECiphertext, route: str = "fused") -> LWECiphertext:
    del keys, route          # no bootstrap: the negation of the phase
    return c1.replace(data=-c1.data)
