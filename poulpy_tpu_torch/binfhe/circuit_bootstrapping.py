"""Circuit bootstrapping, LWE → GGSW: twin of
`poulpy_tpu/binfhe/circuit_bootstrapping.py`.

One blind rotation with a multi-digit LUT leaves all gadget digits of the
message `gap` coefficients apart; per digit a trace isolates coefficient 0
into a GGLWE row; the GGLWE is expanded to a GGSW through the GGLWE → GGSW
(tensor) keys.  On the card the blind rotation runs the fused product
kernel per LWE coefficient (the block-step kernel per block for a
block-binary key, the NTT and VMP kernels on the extended path), the trace
one keyswitch kernel (`fused_product_small`) per level and digit, and the
expansion the NTT and VMP kernels.  Every ciphertext of a batch of LWEs
bootstraps in the same calls.
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
from poulpy_tpu_torch.binfhe.lut import LookupTable, lookup_table_new
from poulpy_tpu_torch.core import encryption as enc
from poulpy_tpu_torch.core.conversion import gglwe_to_ggsw_key_encrypt_sk, ggsw_from_gglwe
from poulpy_tpu_torch.core.layouts import (
    GGLWECiphertext,
    GGSWCiphertext,
    GLWECiphertext,
    LWECiphertext,
    _Replace,
)
from poulpy_tpu_torch.core.operations import glwe_rotate
from poulpy_tpu_torch.core.packing import glwe_pack, glwe_trace, trace_galois_elements
from poulpy_tpu_torch.core.prepared import GLWEAutomorphismKeyPrepared, gglwe_prepare
from poulpy_tpu_torch.hal.module import Module
from poulpy_tpu_torch.hal.source import Source
from poulpy_tpu_torch.parallel.auto import dp_shard


@dataclass(frozen=True)
class CircuitBootstrappingKey(_Replace):
    """The blind-rotation key, the trace's automorphism keys (keyed by
    Galois element, −1 literally) and the GGLWE → GGSW keys (one per rank
    column).  block_size > 1 declares the LWE secret block-binary and routes
    the blind rotation through the block path."""

    brk: BlindRotationKeyPrepared
    atk: dict[int, GLWEAutomorphismKeyPrepared]
    tsk: list
    block_size: int = 1


def circuit_bootstrapping_keygen(module: Module, sk_lwe, sk_glwe, sk_glwe_prepared, base2k: int,
                                 k_brk: int, dnum_brk: int, k_atk: int, dnum_atk: int,
                                 k_tsk: int, dnum_tsk: int, source_xe: Source, source_xa: Source,
                                 block_size: int = 1) -> CircuitBootstrappingKey:
    """The three keys, drawn in the JAX package's order: BRK, the
    automorphism keys level by level, the tensor keys."""
    brk = blind_rotation_key_encrypt_sk(module, sk_lwe, sk_glwe_prepared, base2k, k_brk, dnum_brk,
                                        source_xe, source_xa)
    atk = {}
    for p in trace_galois_elements(module):
        key, _ = enc.glwe_automorphism_key_encrypt_sk(module, p, sk_glwe, base2k, k_atk,
                                                      dnum_atk, source_xe, source_xa)
        atk[p] = GLWEAutomorphismKeyPrepared(key=gglwe_prepare(module, key), p=p)
    tsk = gglwe_to_ggsw_key_encrypt_sk(module, sk_glwe, sk_glwe_prepared, base2k, k_tsk, dnum_tsk,
                                       source_xe, source_xa)
    return CircuitBootstrappingKey(brk=brk, atk=atk, tsk=tsk, block_size=block_size)


def _alpha(dnum_res: int) -> int:
    """The LUT's samples per message value: dnum_res rounded up to a power of two."""
    return 1 << (dnum_res - 1).bit_length() if dnum_res > 1 else 1


def _lookup_table(module: Module, base2k: int, log_domain: int, dnum_res: int, to_exponent: bool,
                  extension_factor: int) -> LookupTable:
    """The multi-digit LUT: for message j, its dnum_res digits
    j·2^{base2k·(dnum_res−1−i)} (to-constant) or the gadget alone
    (to-exponent) on alpha consecutive samples."""
    alpha = _alpha(dnum_res)
    f = np.zeros(((1 << log_domain) * alpha,), dtype=np.int64)
    if to_exponent:
        for i in range(dnum_res):
            f[i] = 1 << (base2k * (dnum_res - 1 - i))
    else:
        for j in range(1 << log_domain):
            for i in range(dnum_res):
                f[j * alpha + i] = j * (1 << (base2k * (dnum_res - 1 - i)))
    lut_k = base2k * dnum_res
    return lookup_table_new(module.n, base2k, lut_k, f, lut_k, extension_factor=extension_factor,
                            rot_dir="right" if to_exponent else "left", device=module.device)


def _gglwe_rows(module: Module, acc: GLWECiphertext, lut: LookupTable, log_domain: int, atk,
                dnum_res: int, to_exponent: bool) -> GGLWECiphertext:
    """The blind-rotated accumulator's digits, one trace (or partial trace
    and repack) each, as a GGLWE `[..., dnum_res, 1, rank+1, size, N]`
    (batch axes leading)."""
    ext = lut.extension_factor
    gap = 2 * lut.drift // ext       # the digits' spacing in the N-ring
    if gap <= 0:
        raise ValueError(f"drift {lut.drift} leaves no digit gap at extension factor {ext}")
    log_gap_in = (gap * _alpha(dnum_res) - 1).bit_length()
    rows = []
    for i in range(dnum_res):
        if to_exponent:
            row = _post_process(module, acc, log_gap_in, 0, log_domain, atk)
        else:
            row = glwe_trace(module, acc, atk, skip=0)
        rows.append(row.data)
        if i + 1 < dnum_res:
            acc = glwe_rotate(-gap, acc)
    return GGLWECiphertext(data=torch.stack(rows, dim=-4).unsqueeze(-4), base2k=acc.base2k,
                           k=acc.k, dsize=1)


def circuit_bootstrap(module: Module, lwe: LWECiphertext, log_domain: int,
                      key: CircuitBootstrappingKey, dnum_res: int, k_res: int,
                      to_exponent: bool = False, extension_factor: int = 1) -> GGSWCiphertext:
    """LWE → GGSW of the constant j = dec(lwe) (to-constant) or of X^j
    (to-exponent), with dnum_res gadget rows.  `extension_factor` spreads
    the LUT over that many polynomials (domain N·ext); `key.block_size`
    routes the blind rotation through the block path.  `k_res` is the
    JAX package's parameter: the output's k is the LUT's, dnum_res·base2k.
    On a mesh-attached module the batch runs dp-sharded (parallel/auto.py)."""
    if module.mesh is not None:
        return dp_shard(module, lambda l: circuit_bootstrap(
            module.local, l, log_domain, key, dnum_res, k_res, to_exponent,
            extension_factor), lwe)
    del k_res
    base2k = key.brk.base2k
    lut = _lookup_table(module, base2k, log_domain, dnum_res, to_exponent, extension_factor)
    acc = GLWECiphertext(data=blind_rotation_dispatch(module, lwe, lut, key.brk, key.block_size),
                         base2k=base2k, k=lut.size * base2k)
    gglwe = _gglwe_rows(module, acc, lut, log_domain, key.atk, dnum_res, to_exponent)
    return ggsw_from_gglwe(module, gglwe, key.tsk)


def _post_process(module: Module, a: GLWECiphertext, log_gap_in: int, log_gap_out: int,
                  log_domain: int, atk) -> GLWECiphertext:
    """A partial trace, then, where the gaps differ, a repack of the
    2^log_domain slots with the coefficient gap 2^log_gap_out."""
    a_trace = glwe_trace(module, a, atk, skip=module.log_n - log_gap_in + 1)
    if log_gap_in == log_gap_out:
        return a_trace
    cts = {}
    cur = a_trace
    for i in range(1 << log_domain):
        if i != 0:
            cur = glwe_rotate(-(1 << log_gap_in), cur)
        cts[i * (1 << log_gap_out)] = cur
    return glwe_pack(module, cts, atk, log_gap_out)
