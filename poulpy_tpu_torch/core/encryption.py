"""Secret-key encryption for GLWE / GGLWE / GGSW / LWE, the secret key, the
tensor (relinearization) key and GLWE public-key encryption.

Twin of `poulpy_tpu/core/encryption.py` (the port's part).  Randomness is
drawn on the host from the ChaCha8 `Source`, whole tensors at once and in
the same order as the JAX package (mask from `source_xa`, then noise from
`source_xe`, per encryption call), then moved to the module's device where
the arithmetic runs.  Inputs are never modified in place.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from poulpy_tpu_torch.core.layouts import (
    GGLWECiphertext,
    GGSWCiphertext,
    GLWECiphertext,
    GLWEPlaintext,
    GLWESecret,
    LWECiphertext,
    glwe_size,
)
from poulpy_tpu_torch.core.prepared import GLWESecretPrepared, glwe_secret_prepare
from poulpy_tpu_torch.hal import dft
from poulpy_tpu_torch.hal.module import Module
from poulpy_tpu_torch.hal.normalization import vec_znx_normalize
from poulpy_tpu_torch.hal.source import Source
from poulpy_tpu_torch.hal.vec_znx import vec_znx_automorphism, vec_znx_sub

DEFAULT_SIGMA_XE = 3.2
DEFAULT_BOUND_XE = 6.0 * DEFAULT_SIGMA_XE


@dataclass(frozen=True)
class NoiseInfos:
    k: int
    sigma: float = DEFAULT_SIGMA_XE
    bound: float = DEFAULT_BOUND_XE

    def target_limb_and_scale(self, base2k: int) -> tuple[int, float]:
        limb = -(-self.k // base2k) - 1
        scale = 2.0 ** ((limb + 1) * base2k - self.k)
        return limb, scale


def secret_new(module: Module, rank: int, source: Source, dist: str = "ternary_prob",
               **kw) -> GLWESecret:
    """Sample a GLWE secret: `ternary_prob` / `binary_prob` (keyword `prob`,
    default 0.5), `ternary_hw` (keyword `hw`, the Hamming weight of each
    column) or `binary_block` (keyword `block_size`: in each block at most
    one 1); `ValueError` for any other name."""
    n = module.n
    if dist == "ternary_prob":
        data = source.ternary_prob((rank, n), kw.get("prob", 0.5))
    elif dist == "ternary_hw":
        data = np.stack([source.ternary_hw(n, kw["hw"]) for _ in range(rank)])
    elif dist == "binary_prob":
        data = source.binary_prob((rank, n), kw.get("prob", 0.5))
    elif dist == "binary_block":
        data = np.stack([source.binary_block(n, kw["block_size"]) for _ in range(rank)])
    else:
        raise ValueError(dist)
    return GLWESecret(data=torch.from_numpy(data).to(module.device), dist=dist)


def _encrypt_core(module, base2k, size, pt_col, noise_limb, mask, e, pt, sk_data):
    """Deterministic encryption arithmetic (randomness passed in)."""
    rank = mask.shape[-3]
    c0 = torch.zeros(mask.shape[:-3] + mask.shape[-2:], dtype=torch.int64, device=mask.device)
    for i in range(1, rank + 1):
        ci = mask[..., i - 1, :, :]
        if pt is not None and pt_col == i:
            ci = vec_znx_normalize(base2k, vec_znx_sub(ci, pt, res_size=size))
        ci_dft = dft.dft_apply(module, ci)
        ci_dft = dft.svp_apply(module, ci_dft, sk_data[i - 1])
        ci_big = dft.idft_apply(module, ci_dft)
        ci_n = dft.big_normalize(module, size, base2k, ci_big, base2k)
        c0 = c0 - ci_n
    c0[..., noise_limb, :] += e  # c0 is a fresh tensor: no input changes
    if pt is not None and pt_col == 0:
        c0 = vec_znx_sub(c0, -pt, res_size=size)
    c0 = vec_znx_normalize(base2k, c0)
    return torch.cat([c0[..., None, :, :], mask], dim=-3)


def encrypt_sk_internal(module: Module, base2k: int, size: int, pt, pt_col: int,
                        sk: GLWESecretPrepared, noise: NoiseInfos, source_xe: Source,
                        source_xa: Source, batch_shape: tuple = ()):
    """The shared encryption core: returns `[..., rank+1, size, N]` with
    ct[i≥1] uniform and ct[0] = -Σ norm(ct[i]·s_i) + e (+ pt if pt_col = 0);
    pt in column j > 0 is realised by treating ct[j] as (uniform − pt)."""
    n = module.n
    rank = sk.rank
    if pt is not None:
        batch_shape = tuple(torch.broadcast_shapes(tuple(batch_shape), tuple(pt.shape[:-2])))
    mask = torch.from_numpy(
        source_xa.uniform_digits(base2k, tuple(batch_shape) + (rank, size, n))
    ).to(module.device)
    limb, scale = noise.target_limb_and_scale(base2k)
    e = torch.from_numpy(
        source_xe.normal_f64(tuple(batch_shape) + (n,), noise.sigma * scale,
                             noise.bound * scale).astype(np.int64)
    ).to(module.device)
    return _encrypt_core(module, base2k, size, pt_col, limb, mask, e, pt, sk.data)


def glwe_encrypt_sk(module: Module, pt: GLWEPlaintext | None, sk: GLWESecretPrepared,
                    base2k: int, k: int, source_xe: Source, source_xa: Source,
                    sigma: float = DEFAULT_SIGMA_XE, bound: float = DEFAULT_BOUND_XE,
                    batch_shape: tuple = ()) -> GLWECiphertext:
    """GLWE secret-key encryption."""
    size = glwe_size(base2k, k)
    noise = NoiseInfos(k=k, sigma=sigma, bound=bound)
    data = encrypt_sk_internal(module, base2k, size, None if pt is None else pt.data, 0, sk,
                               noise, source_xe, source_xa, batch_shape)
    return GLWECiphertext(data=data, base2k=base2k, k=k)


def gglwe_encrypt_sk(module: Module, pt, sk: GLWESecretPrepared, base2k: int, k: int,
                     dnum: int, source_xe: Source, source_xa: Source, dsize: int = 1,
                     sigma: float = DEFAULT_SIGMA_XE,
                     bound: float = DEFAULT_BOUND_XE) -> GGLWECiphertext:
    """GGLWE secret-key encryption: row r, input column i encrypts pt_i
    (`pt` [rank_in, N]) at limb (dsize−1) + r·dsize, all rows of a column
    in one encryption call."""
    size = glwe_size(base2k, k)
    if dnum * dsize > size:
        raise ValueError(f"dnum·dsize = {dnum * dsize} exceeds the {size} limbs of k={k}")
    noise = NoiseInfos(k=k, sigma=sigma, bound=bound)
    pt = torch.as_tensor(pt, dtype=torch.int64).to(module.device)
    cols = []
    for i in range(pt.shape[0]):
        pt_rows = torch.zeros((dnum, size, module.n), dtype=torch.int64, device=module.device)
        for r in range(dnum):
            pt_rows[r, (dsize - 1) + r * dsize, :] = pt[i]
        pt_rows = vec_znx_normalize(base2k, pt_rows)
        cols.append(encrypt_sk_internal(module, base2k, size, pt_rows, 0, sk, noise,
                                        source_xe, source_xa))
    data = torch.stack(cols, dim=1)  # [dnum, rank_in, rank_out+1, size, N]
    return GGLWECiphertext(data=data, base2k=base2k, k=k, dsize=dsize)


def glwe_switching_key_encrypt_sk(module: Module, sk_in: GLWESecret, sk_out: GLWESecretPrepared,
                                  base2k: int, k: int, dnum: int, source_xe: Source,
                                  source_xa: Source, dsize: int = 1, **kw) -> GGLWECiphertext:
    """Key-switching key sk_in → sk_out."""
    return gglwe_encrypt_sk(module, sk_in.data, sk_out, base2k, k, dnum, source_xe, source_xa,
                            dsize=dsize, **kw)


def glwe_automorphism_key_encrypt_sk(module: Module, p: int, sk: GLWESecret, base2k: int, k: int,
                                     dnum: int, source_xe: Source, source_xa: Source,
                                     dsize: int = 1, **kw) -> tuple[GGLWECiphertext, int]:
    """Automorphism key of Galois element p: a GGLWE of s under the permuted
    secret φ_{p^{-1}}(s), so that a keyswitch then φ_p maps an encryption of
    m under s to one of φ_p(m) under s.  Returns (key, p)."""
    p_inv = pow(int(p) % (2 * module.n), -1, 2 * module.n)
    sk_out = GLWESecret(data=vec_znx_automorphism(p_inv, sk.data), dist=sk.dist)
    key = gglwe_encrypt_sk(module, sk.data, glwe_secret_prepare(module, sk_out), base2k, k, dnum,
                           source_xe, source_xa, dsize=dsize, **kw)
    return key, p


def glwe_tensor_key_encrypt_sk(module: Module, sk: GLWESecret, sk_prepared: GLWESecretPrepared,
                               base2k: int, k: int, dnum: int, source_xe: Source,
                               source_xa: Source, dsize: int = 1,
                               **kw) -> dict[tuple[int, int], GGLWECiphertext]:
    """Tensor (relinearization) key: for i ≤ j, a GGLWE of s_i·s_j under s,
    the exact product taken through the NTT (the coefficients are tiny)."""
    keys = {}
    for i in range(sk.rank):
        for j in range(i, sk.rank):
            si_dft = dft.dft_apply(module, sk.data[i][None, :])
            sj_p = dft.svp_prepare(module, sk.data[j])
            sisj = dft.idft_apply(module, dft.svp_apply(module, si_dft, sj_p))[0]
            keys[(i, j)] = gglwe_encrypt_sk(module, sisj[None, :], sk_prepared, base2k, k, dnum,
                                            source_xe, source_xa, dsize=dsize, **kw)
    return keys


def lwe_encrypt_sk(module_unused, pt, sk_lwe, base2k: int, k: int, source_xe: Source,
                   source_xa: Source, sigma: float = DEFAULT_SIGMA_XE,
                   bound: float = DEFAULT_BOUND_XE) -> LWECiphertext:
    """Scalar LWE encryption, b = −<a, s> + m + e, body and mask packed in
    one row per limb.  `pt` is `[..., size, 1]` or `[..., size]` limb
    scalars; the ciphertext lies on `sk_lwe`'s device."""
    sk_lwe = torch.as_tensor(sk_lwe, dtype=torch.int64)
    device = sk_lwe.device
    n_lwe = sk_lwe.shape[-1]
    size = glwe_size(base2k, k)
    pt = torch.as_tensor(pt, dtype=torch.int64).to(device)
    if pt.shape[-1] != 1:
        pt = pt[..., None]
    batch = tuple(pt.shape[:-2])
    a = torch.from_numpy(source_xa.uniform_digits(base2k, batch + (size, n_lwe))).to(device)
    body = -(a * sk_lwe).sum(dim=-1)[..., None]
    body = vec_znx_sub(body, -pt, res_size=size)
    limb, scale = NoiseInfos(k=k, sigma=sigma, bound=bound).target_limb_and_scale(base2k)
    e = source_xe.normal_f64(batch + (1,), sigma * scale, bound * scale).astype(np.int64)
    body[..., limb, :] += torch.from_numpy(e).to(device)  # body is a fresh tensor
    data = vec_znx_normalize(base2k, torch.cat([body, a], dim=-1))
    return LWECiphertext(data=data, base2k=base2k, k=k)


def ggsw_encrypt_sk(module: Module, pt, sk: GLWESecretPrepared, base2k: int, k: int, dnum: int,
                    source_xe: Source, source_xa: Source, dsize: int = 1,
                    sigma: float = DEFAULT_SIGMA_XE,
                    bound: float = DEFAULT_BOUND_XE) -> GGSWCiphertext:
    """GGSW secret-key encryption: row r, column j encrypts m·s_j·gadget via
    plaintext placement at limb (dsize−1) + r·dsize of ciphertext column j."""
    size = glwe_size(base2k, k)
    rank = sk.rank
    noise = NoiseInfos(k=k, sigma=sigma, bound=bound)
    n = module.n
    pt = torch.as_tensor(pt, dtype=torch.int64).to(module.device)
    batch = tuple(pt.shape[:-1])
    pt_rows = torch.zeros(batch + (dnum, size, n), dtype=torch.int64, device=module.device)
    for r in range(dnum):
        pt_rows[..., r, (dsize - 1) + r * dsize, :] = pt
    pt_rows = vec_znx_normalize(base2k, pt_rows)
    cols = [
        encrypt_sk_internal(module, base2k, size, pt_rows, j, sk, noise, source_xe, source_xa)
        for j in range(rank + 1)
    ]
    data = torch.stack(cols, dim=-4)  # [..., dnum, rank+1, rank+1, size, N]
    return GGSWCiphertext(data=data, base2k=base2k, k=k, dsize=dsize)


# ---- public-key encryption --------------------------------------------------------------

def glwe_public_key_generate(module: Module, sk: GLWESecretPrepared, base2k: int, k: int,
                             source_xe: Source, source_xa: Source, **kw) -> GLWECiphertext:
    """The public key: an encryption of zero under `sk`."""
    return glwe_encrypt_sk(module, None, sk, base2k, k, source_xe, source_xa, **kw)


def glwe_public_key_prepare(module: Module, pk: GLWECiphertext):
    """The DFT of every column of the public key, `[cols, size, P, N]`."""
    return dft.dft_apply(module, pk.data)


def glwe_encrypt_pk(module: Module, pt: GLWEPlaintext | None, pk_prepared, pk_base2k: int,
                    pk_k: int, source_xu: Source, source_xe: Source,
                    sigma: float = DEFAULT_SIGMA_XE, bound: float = DEFAULT_BOUND_XE,
                    u_dist: str = "ternary_prob") -> GLWECiphertext:
    """Public-key encryption: an ephemeral u from `source_xu` (`u_dist`
    ternary_prob or binary_prob), then per column i ct_i = norm(iDFT(u ⊙
    pk_i) + e_i), the noise drawn per column and added on the big
    accumulator's noise limb, and pt (zero-padded or cut to its limbs)
    added to column 0 before the normalization."""
    size = glwe_size(pk_base2k, pk_k)
    n = module.n
    if u_dist == "ternary_prob":
        u = source_xu.ternary_prob((n,))
    elif u_dist == "binary_prob":
        u = source_xu.binary_prob((n,))
    else:
        raise ValueError(u_dist)
    u_dft = dft.svp_prepare(module, torch.from_numpy(u).to(module.device))
    limb, scale = NoiseInfos(k=pk_k, sigma=sigma, bound=bound).target_limb_and_scale(pk_base2k)
    cols = []
    for i in range(pk_prepared.shape[-4]):
        big = dft.idft_apply(module, dft.svp_apply(module, pk_prepared[..., i, :, :, :], u_dft))
        e = source_xe.normal_f64((n,), sigma * scale, bound * scale).astype(np.int64)
        big[..., limb, :] += torch.from_numpy(e).to(module.device)  # big is a fresh tensor
        if pt is not None and i == 0:
            big = big + dft._align_limbs(pt.data, big, big.shape[-2], limb_axis=-2)[0]
        cols.append(dft.big_normalize(module, size, pk_base2k, big, pk_base2k))
    return GLWECiphertext(data=torch.stack(cols, dim=-3), base2k=pk_base2k, k=pk_k)
