"""Ring-degree-sharded negacyclic NTT with all-to-all stage exchange: twin
of `poulpy_tpu/parallel/sharded_ntt.py`.

The N axis splits over a mesh axis ("sp"), rank dd holding lanes
[dd·M, (dd+1)·M), M = N/D.  A Cooley–Tukey stage of half-length h pairs
lanes (j, j+h): in the *cyclic* distribution (rank dd holds j ≡ dd mod D)
every stage with D | h is local, in the *block* distribution every stage
with 2h | M.  For D² ≤ N/2 the forward transform converts block → cyclic
(one all_to_all), runs the stages h = N/2 … D, converts back (one more)
and finishes h = D/2 … 1 locally; the inverse (Gentleman–Sande) mirrors
it, so a forward and inverse round trip issues four all_to_alls, each
moving N/D elements per rank.  The butterflies are plain PyTorch int64
ops on the residues' device, as the JAX package's are jnp; the exchanges
go through `collectives.all_to_all` (NCCL on the card, gloo on the CPU).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from poulpy_tpu_torch.hal.ntt import _host_tables, add_mod, mont_mul, sub_mod
from poulpy_tpu_torch.hal.primes import R
from poulpy_tpu_torch.parallel.collectives import all_to_all
from poulpy_tpu_torch.parallel.mesh import axis_size


@functools.lru_cache(maxsize=None)
def _stage_vectors(primes: tuple, n: int, inverse: bool):
    """Full-length per-stage twiddle vectors [S, P, N] (natural j order)
    and N^{-1}·R per prime (numpy int64)."""
    psi_t, psi_inv_t, n_inv = _host_tables(primes, n)
    logn = n.bit_length() - 1
    out = np.zeros((logn, len(primes), n), dtype=np.int64)
    src = psi_inv_t if inverse else psi_t
    for s in range(logn):
        idx = (1 << s) + np.arange(n) // (n >> s)
        out[s if not inverse else logn - 1 - s] = src[:, idx]
    return out, n_inv


@functools.lru_cache(maxsize=None)
def _device_constants(primes: tuple, n: int, inverse: bool, device: torch.device):
    """(stage vectors [S, P, N], p [P, 1], qinv [P, 1], N^{-1}·R [P, 1]) as
    int64 tensors on `device`, uploaded once."""
    tables, n_inv = _stage_vectors(primes, n, inverse)
    p = np.array(primes, dtype=np.int64)[:, None]
    qinv = np.array([(-pow(q, -1, R)) % R for q in primes], dtype=np.int64)[:, None]
    return tuple(torch.from_numpy(a).to(device) for a in (tables, p, qinv, n_inv[:, None]))


def _check(n: int, d: int) -> None:
    if n % d or d * d > n // 2:
        raise ValueError(f"the ring-sharded NTT needs D | N and D² ≤ N/2, got N={n}, D={d}")


def _butterfly_fwd(x, w, p, qinv, h_local: int):
    """CT butterflies at local half-length h_local on [..., L] lanes."""
    lead, L = x.shape[:-1], x.shape[-1]
    xr = x.reshape(lead + (L // (2 * h_local), 2, h_local))
    lo, hi = xr[..., 0, :], xr[..., 1, :]
    wr = w.reshape(w.shape[:-1] + (L // (2 * h_local), 2, h_local))[..., 1, :]
    v = mont_mul(hi, wr, p[..., None], qinv[..., None])
    return torch.stack([add_mod(lo, v, p[..., None]), sub_mod(lo, v, p[..., None])],
                       dim=-2).reshape(x.shape)


def _butterfly_inv(x, w, p, qinv, h_local: int):
    lead, L = x.shape[:-1], x.shape[-1]
    xr = x.reshape(lead + (L // (2 * h_local), 2, h_local))
    lo, hi = xr[..., 0, :], xr[..., 1, :]
    wr = w.reshape(w.shape[:-1] + (L // (2 * h_local), 2, h_local))[..., 1, :]
    u = add_mod(lo, hi, p[..., None])
    v = mont_mul(sub_mod(lo, hi, p[..., None]), wr, p[..., None], qinv[..., None])
    return torch.stack([u, v], dim=-2).reshape(x.shape)


def _block_to_cyclic(x_local, group, d: int):
    """Natural block shards → cyclic shards: chunk the local block [..., M]
    by destination (j mod D, = m mod D for D | M), one all_to_all, then
    interleave the received chunks."""
    lead, M = x_local.shape[:-1], x_local.shape[-1]
    xr = x_local.reshape(lead + (M // d, d)).movedim(-1, 0)      # [D_dest, ..., M/D]
    recv = all_to_all(xr, group)
    return recv.movedim(0, -2).reshape(lead + (M,))


def _cyclic_to_block(x_local, group, d: int):
    """Inverse of _block_to_cyclic."""
    lead, M = x_local.shape[:-1], x_local.shape[-1]
    xr = x_local.reshape(lead + (d, M // d)).movedim(-2, 0)      # [D_dest, ..., M/D]
    recv = all_to_all(xr, group)
    return recv.movedim(0, -1).reshape(lead + (M,))


def _shards(primes, n, mesh, axis, inverse, x_local):
    d = axis_size(mesh, axis)
    _check(n, d)
    tables, p, qinv, n_inv = _device_constants(tuple(primes), n, inverse, x_local.device)
    M = n // d
    dd = mesh.get_local_rank(axis)

    def w_cyclic(s):          # cyclic shard of a twiddle vector: lanes j = m·D + dd
        return tables[s].reshape(tables.shape[1], M, d)[..., dd]

    def w_block(s):
        return tables[s][:, dd * M : (dd + 1) * M]

    return d, mesh.get_group(axis), p, qinv, n_inv, w_cyclic, w_block


def sharded_ntt_forward(primes: tuple, n: int, mesh, axis: str, x_local):
    """Inside a sharded region: x_local [..., P, M] int64, this rank's
    natural block of [..., P, N] residues over `mesh`'s `axis`; returns the
    same layout in the NTT domain (bit-reversed order, as `hal.ntt`)."""
    d, group, p, qinv, _, w_cyclic, w_block = _shards(primes, n, mesh, axis, False, x_local)
    logn, logd = n.bit_length() - 1, d.bit_length() - 1
    x = _block_to_cyclic(x_local, group, d)
    for s in range(logn - logd):              # h = N/2 … D, local stride h/D
        x = _butterfly_fwd(x, w_cyclic(s), p, qinv, (n >> (s + 1)) // d)
    x = _cyclic_to_block(x, group, d)
    for s in range(logn - logd, logn):        # h = D/2 … 1, local
        x = _butterfly_fwd(x, w_block(s), p, qinv, n >> (s + 1))
    return x


def sharded_ntt_inverse(primes: tuple, n: int, mesh, axis: str, x_local):
    """Inverse of `sharded_ntt_forward` (GS stages, mirrored exchanges,
    then the N^{-1} scale)."""
    d, group, p, qinv, n_inv, w_cyclic, w_block = _shards(primes, n, mesh, axis, True, x_local)
    logn, logd = n.bit_length() - 1, d.bit_length() - 1
    x = x_local
    for si in range(logd):                    # h = 1 … D/2, block-local
        x = _butterfly_inv(x, w_block(si), p, qinv, n >> (logn - si))
    x = _block_to_cyclic(x, group, d)
    for si in range(logd, logn):              # h = D … N/2, cyclic-local
        x = _butterfly_inv(x, w_cyclic(si), p, qinv, (n >> (logn - si)) // d)
    x = _cyclic_to_block(x, group, d)
    return mont_mul(x, n_inv, p, qinv)
