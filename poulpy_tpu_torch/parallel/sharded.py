"""Sharded execution of the hot primitives: twin of `poulpy_tpu/parallel/sharded.py`.

dp: ciphertext-batch data parallelism (no collective).
tp: CRT-prime tensor parallelism: every rank owns P/tp primes and runs
    dft → VMP → inverse NTT for them (the NTT and VMP kernels at P/tp on the
    card); one all_gather over tp per inverse transform assembles the
    residues for the centred Garner lift.
sp: the ring degree N split over `sp`: one transform across ranks
    (`sharded_ntt.py`), everything else lane-local.
kp: the blind-rotation key split over `kp`: each rank holds its slice of
    every block's members; one all_reduce of the NTT-domain update per
    block step.

Each builder returns a function of full tensors (every rank holds them
whole, as keys are replicated) or DTensors placed as the JAX package's
in_specs say; it runs this rank's shard and returns a DTensor placed as
its out_specs say.  The collectives go through `collectives.py`: NCCL on
the card, gloo on the CPU, counted in `COLLECTIVES`.
"""

from __future__ import annotations

import copy

import torch

from poulpy_tpu_torch.backends.fused import xpow_tables
from poulpy_tpu_torch.backends.ntt import ntt_inverse
from poulpy_tpu_torch.hal import dft
from poulpy_tpu_torch.hal.module import Module
from poulpy_tpu_torch.hal.normalization import vec_znx_normalize_full
from poulpy_tpu_torch.hal.ntt import garner_lift, mont_mul, to_residues
from poulpy_tpu_torch.parallel.collectives import all_gather, all_reduce_sum
from poulpy_tpu_torch.parallel.mesh import axis_size, from_local, local_shard


def shard_batch(mesh, x, axis: int = 0):
    """`x` as a DTensor with `axis` split over dp: each rank keeps its slice
    of the full tensor it holds (no data moves)."""
    return from_local(mesh, local_shard(mesh, x, {"dp": axis}), {"dp": axis})


def prime_slice(nprimes: int, tp: int, rank: int) -> tuple[int, int]:
    """The primes [lo, hi) of tp rank `rank`."""
    if nprimes % tp:
        raise ValueError(f"tp={tp} must divide the prime count {nprimes}")
    size = nprimes // tp
    return rank * size, (rank + 1) * size


def local_module(module: Module, lo: int, hi: int) -> Module:
    """The mesh-less module of primes lo … hi − 1 on the module's device,
    its tables `NttTables.sliced` (views of the module's rows): what a tp
    rank's transforms and VMP run on."""
    m = copy.copy(module.local)
    m.tables = module.tables.sliced(lo, hi)
    m.basis = m.tables.basis
    m._local = m
    return m


def tp_local_residues(lm: Module, ct, pmat_local):
    """A tp rank's step before the all_gather: dft → VMP → inverse NTT on
    its primes (`lm`, `local_module`), `pmat_local` the key's rows of those
    primes; residues [..., co, size, P/tp, N]."""
    res_dft = dft.vmp_apply(lm, dft.dft_apply(lm, ct), pmat_local)
    return ntt_inverse(lm.tables, res_dft.contiguous())


def sharded_external_product_fn(module: Module, mesh, res_base2k: int, res_size: int,
                                ggsw_base2k: int):
    """(dp, tp)-sharded batched external product.

    Returns fn(ct_data [B, rank+1, size, N], pmat [rows, ci, co, psize, P, N])
    → DTensor [B, rank+1, res_size, N] placed Shard(0) on dp, replicated
    over tp.  pmat's prime axis splits over tp (this rank's primes are
    sliced from a full pmat), ct's batch over dp."""
    t = module.tables
    tp = axis_size(mesh, "tp")
    lo, hi = prime_slice(module.nprimes, tp, mesh.get_local_rank("tp"))
    lm = local_module(module, lo, hi)
    group = mesh.get_group("tp")

    def fn(ct_data, pmat):
        ct = local_shard(mesh, ct_data, {"dp": 0})
        res = tp_local_residues(lm, ct, local_shard(mesh, pmat, {"tp": 4}))
        big = garner_lift(t, all_gather(res, group, dim=-2))    # replicated constants
        out = vec_znx_normalize_full(res_size, res_base2k, 0, big, ggsw_base2k)
        return from_local(mesh, out, {"dp": 0})

    return fn


GATES = ("nand", "and", "or", "nor", "xor", "xnor")


def sharded_gate_bootstrap_fn(keys, mesh, gate: str = "nand"):
    """dp-sharded batched gate bootstrapping: the batch axis of both LWE
    inputs splits over dp, every key tensor is replicated, no collective.

    `keys`: binfhe.gates.BootstrapKeys (on a mesh-less module).  Returns
    fn(c1_data [B, size, n_lwe+1], c2_data like) → DTensor [B, size,
    n_lwe+1] placed Shard(0) on dp, B divisible by the dp extent; bit-exact
    with the single-device gate."""
    from poulpy_tpu_torch.binfhe import gates
    from poulpy_tpu_torch.core.layouts import LWECiphertext

    if gate not in GATES:
        raise ValueError(f"gate must be one of {GATES}, got {gate!r}")
    gate_fn = getattr(gates, f"gate_{gate}")
    params = keys.params
    dims = {"dp": 0}

    def fn(c1_data, c2_data):
        c1 = LWECiphertext(data=local_shard(mesh, c1_data, dims), base2k=params.base2k,
                           k=params.k_ct)
        c2 = c1.replace(data=local_shard(mesh, c2_data, dims))
        return from_local(mesh, gate_fn(keys, c1, c2).data, dims)

    return fn


def sharded_external_product_ring_fn(module: Module, mesh, res_base2k: int, res_size: int,
                                     ggsw_base2k: int, axis: str = "sp"):
    """(dp, sp)-sharded external product with the ring degree N split over
    `axis`: one transform across ranks (`sharded_ntt.py`), the residue
    entry, the VMP (the kernel on the card, pointwise over N/sp lanes), the
    Garner lift and the normalization lane-local.

    Returns fn(ct [B, rank+1, size, N], pmat [rows, ci, co, psize, P, N]) →
    DTensor [B, rank+1, res_size, N] placed Shard(0) on dp and Shard(3) on
    `axis`; bit-exact with the single-device product."""
    from poulpy_tpu_torch.parallel.sharded_ntt import (
        _check,
        sharded_ntt_forward,
        sharded_ntt_inverse,
    )

    m = module.local
    t, primes, n = m.tables, m.basis.primes, m.n
    d = axis_size(mesh, axis)
    _check(n, d)
    # the VMP's module: the same primes and tables over the rank's N/sp lanes
    lanes = copy.copy(m)
    lanes.n, lanes.log_n = n // d, (n // d).bit_length() - 1
    lanes._local = lanes
    dims = {"dp": 0, axis: 3}

    def fn(ct, pmat):
        r = to_residues(t, local_shard(mesh, ct, dims)).to(torch.int64)
        a_dft = sharded_ntt_forward(primes, n, mesh, axis, r)
        res_dft = dft.vmp_apply(lanes, a_dft.to(torch.int32), local_shard(mesh, pmat, {axis: 5}))
        res = sharded_ntt_inverse(primes, n, mesh, axis, res_dft.to(torch.int64))
        out = vec_znx_normalize_full(res_size, res_base2k, 0, garner_lift(t, res), ggsw_base2k)
        return from_local(mesh, out, dims)

    return fn


def kp_block_update(module: Module, acc_dft, a_members, pm_members):
    """A kp rank's part of one block step before the all_reduce: Σ over its
    block members i of (X^{a_i} − 1)·(acc_dft ⊡ BRK_i) in the NTT domain
    (the VMP kernel per member on the card, X^{a_i} a gather from the
    x-power table), int32 residues [..., cols, size, P, N].  a_members
    [bs, ...] are the members' Z_{2N} amounts, pm_members their BRK rows."""
    t, n = module.tables, module.n
    xpow = xpow_tables(module)[0]
    p, qinv = t.p[:, None], t.qinv[:, None]
    add = None
    for i in range(pm_members.shape[0]):
        vmp_res = dft.vmp_apply(module, acc_dft, pm_members[i])
        xp = xpow[a_members[i] & (2 * n - 1)]                     # [..., P, N]
        rot = mont_mul(vmp_res, xp[..., None, None, :, :], p, qinv)
        term = dft.dft_sub(module, rot, vmp_res)
        add = term if add is None else dft.dft_add(module, add, term)
    return add


def kp_members(module: Module, lwe, lut, brk, block_size: int, kp: int, rank: int):
    """The accumulator's start (X^b·LUT, 0) and, per block, kp rank
    `rank`'s members [rank·bs/kp, (rank+1)·bs/kp): their amounts [nblocks,
    bs/kp, ...] and BRK rows [nblocks, bs/kp, rows, ci, co, psize, P, N]."""
    from poulpy_tpu_torch.binfhe.blind_rotation import _acc_init, mod_switch_2n

    if lut.extension_factor != 1:
        raise ValueError("the key-sharded blind rotation takes a LUT over one polynomial")
    n_lwe = brk.n_lwe
    if n_lwe % block_size or block_size % kp:
        raise ValueError(f"n_lwe={n_lwe}, block_size={block_size}, kp={kp}: "
                         "block_size must divide n_lwe and kp block_size")
    nblocks, bs = n_lwe // block_size, block_size // kp
    lwe_2n = mod_switch_2n(2 * module.n, lwe, lut.rot_dir)
    b = lwe_2n[..., 0]
    a_blk = lwe_2n[..., 1:].movedim(-1, 0).reshape((nblocks, block_size) + tuple(b.shape))
    pm_blk = brk.pmats.reshape((nblocks, block_size) + tuple(brk.pmats.shape[1:]))
    members = slice(rank * bs, (rank + 1) * bs)
    return _acc_init(b, lut, brk.rank), a_blk[:, members], pm_blk[:, members]


def sharded_blind_rotation_block_fn(module: Module, mesh, lut, brk, block_size: int,
                                    axis: str = "kp"):
    """Block-binary CGGI blind rotation with the blind-rotation key split
    over `axis`: per block, rank r holds members [r·bs/kp, (r+1)·bs/kp).
    A block step is the rank's `kp_block_update`, one all_reduce (SUM) of
    it widened to int64 over `axis`, then % p (exact: kp·p < 2^63, and mod p
    is a ring homomorphism, so the residues equal the sequential dft_add
    chain's), then the replicated accumulator update.  The ciphertext batch
    splits over dp.

    Returns fn(lwe: LWECiphertext [B, ...]) → DTensor acc data [B, rank+1,
    size, N] placed Shard(0) on dp; bit-exact with
    blind_rotation_execute_block."""
    m = module.local
    t, size, base2k = m.tables, lut.size, brk.base2k
    kp, rank = axis_size(mesh, axis), mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    p = t.p[:, None]

    def block_step(acc, a_i, pm_i):
        add = kp_block_update(m, dft.dft_apply(m, acc), a_i, pm_i)
        add = (all_reduce_sum(add.to(torch.int64), group) % p).to(torch.int32)
        big = dft.idft_apply(m, add)
        big = big + dft._align_limbs(acc, big, big.shape[-2], limb_axis=-2)[0]
        return dft.big_normalize(m, size, base2k, big, base2k)

    def fn(lwe):
        lwe = lwe.replace(data=local_shard(mesh, lwe.data, {"dp": 0}))
        acc, a_loc, pm_loc = kp_members(m, lwe, lut, brk, block_size, kp, rank)
        for j in range(a_loc.shape[0]):
            acc = block_step(acc, a_loc[j], pm_loc[j])
        return from_local(mesh, acc, {"dp": 0})

    return fn
