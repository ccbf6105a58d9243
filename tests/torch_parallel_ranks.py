"""The ranks of tests/test_torch_parallel.py: one process per rank of a gloo
process group on the CPU, importing torch and the port only (no JAX).

    python tests/torch_parallel_ranks.py RANK WORLD STORE OUT

Every rank builds the inputs from the same seeds (`inputs()`, which the test
also calls to feed the JAX package: keys are replicated, as the JAX package
captures them), runs the scenarios of `__graft_entry__.py`'s
dryrun_multichip cut to four ranks and the seven entry points on a
mesh-attached module, and rank 0 writes each output gathered whole, with
its placements and the collectives it issued, and what every rank had
imported, to OUT/results.pt.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

BASE2K, K_CT, K_KEY, DNUM = 17, 51, 68, 3
CPU = "cpu"


def ep_problem(m, batch: int):
    """dryrun_multichip's _make_problem: a batch of encryptions of random
    10-bit data and the prepared GGSW of X^1, from Source bytes(32) / 0x01 /
    0x02 and default_rng(0)."""
    from poulpy_tpu_torch.core import encryption as enc
    from poulpy_tpu_torch.core.layouts import GLWEPlaintext
    from poulpy_tpu_torch.core.prepared import ggsw_prepare, glwe_secret_prepare
    from poulpy_tpu_torch.hal import vec_znx
    from poulpy_tpu_torch.hal.source import Source

    src, xe, xa = Source(bytes(32)), Source(b"\x01" * 32), Source(b"\x02" * 32)
    sk = enc.secret_new(m, 1, src)
    skp = glwe_secret_prepare(m, sk)
    data = torch.from_numpy(np.random.default_rng(0).integers(-(2**10), 2**10, (batch, m.n)))
    pt = GLWEPlaintext(data=vec_znx.encode_vec_i64(BASE2K, 34, 3, data), base2k=BASE2K, k=34)
    ct = enc.glwe_encrypt_sk(m, pt, skp, BASE2K, K_CT, xe, xa, batch_shape=(batch,))
    ptg = np.zeros(m.n, dtype=np.int64)
    ptg[1] = 1
    ggswp = ggsw_prepare(m, enc.ggsw_encrypt_sk(m, ptg, skp, BASE2K, K_KEY, dnum=DNUM,
                                                source_xe=xe, source_xa=xa))
    return dict(sk=sk, skp=skp, ct=ct, ggswp=ggswp)


def inputs() -> dict:
    """Every scenario's keys and ciphertexts, on the CPU, from seeds."""
    from poulpy_tpu_torch.binfhe import gates
    from poulpy_tpu_torch.binfhe.blind_rotation import blind_rotation_key_encrypt_sk
    from poulpy_tpu_torch.binfhe.circuit_bootstrapping import circuit_bootstrapping_keygen
    from poulpy_tpu_torch.binfhe.lut import lookup_table_new
    from poulpy_tpu_torch.ckks import ops as ck
    from poulpy_tpu_torch.ckks.encoder import Encoder
    from poulpy_tpu_torch.core import encryption as enc
    from poulpy_tpu_torch.core.prepared import (
        gglwe_prepare,
        glwe_secret_prepare,
        glwe_tensor_key_prepare,
    )
    from poulpy_tpu_torch.hal.module import get_module
    from poulpy_tpu_torch.hal.ntt import to_residues
    from poulpy_tpu_torch.hal.source import Source

    out = {}
    # 1. (dp 2, tp 2) external product; its ciphertexts and key also feed
    # the dp entry points, with a switching key under the same secret
    m = get_module(64, 2, device=CPU)
    ep = ep_problem(m, 4)
    sk_out = enc.secret_new(m, 1, Source(b"\x0d" * 32))
    ksk = gglwe_prepare(m, enc.glwe_switching_key_encrypt_sk(
        m, ep["sk"], glwe_secret_prepare(m, sk_out), BASE2K, K_KEY, DNUM, Source(b"\x0e" * 32),
        Source(b"\x0f" * 32)))
    out["ep"] = dict(m=m, ct=ep["ct"], ggswp=ep["ggswp"], ksk=ksk)
    # 2. the ring-sharded NTT (sp 4, N 256)
    m2 = get_module(256, 2, device=CPU)
    out["ntt"] = dict(m=m2, r=to_residues(m2.tables, torch.arange(2 * 256).reshape(2, 256))
                      .to(torch.int64))
    # 3. the (dp 2, sp 2) ring external product at N 64
    out["ring"] = dict(m=m, ct=ep["ct"], ggswp=ep["ggswp"])
    # 4. NAND on the hybrid mesh (dp 4)
    params = gates.GateParams(n_glwe=64, n_lwe=8, base2k=17, k_ct=34, k_brk=68, dnum_brk=4,
                              k_ksk=51, dnum_ksk=2, nprimes=4)
    keys, sk_lwe = gates.keygen(params, device=CPU)
    xe, xa = Source(b"\x05" * 32), Source(b"\x06" * 32)
    bits = np.arange(8) % 2
    out["nand"] = dict(keys=keys, sk_lwe=sk_lwe, bits=bits,
                       c1=gates.encrypt_bit(params, bits, sk_lwe, xe, xa),
                       c2=gates.encrypt_bit(params, 1 - bits, sk_lwe, xe, xa))
    # 5. the key-sharded block blind rotation (dp 2, kp 2): n_lwe 8 in blocks
    # of 4, so that each kp rank sums two members per block
    src = Source(bytes(32))
    xe, xa = Source(b"\x01" * 32), Source(b"\x02" * 32)
    n_lwe, block = 8, 4
    sk_lwe = src.binary_block(n_lwe, block)
    skp = glwe_secret_prepare(m, enc.secret_new(m, 1, src))
    brk = blind_rotation_key_encrypt_sk(m, torch.from_numpy(sk_lwe), skp, BASE2K, K_KEY, 4,
                                        xe, xa)
    f = np.arange(16, dtype=np.int64)
    pt = np.zeros((4, 2, 1), dtype=np.int64)
    pt[:, 0, 0] = np.array([0, 5, 9, 14]) << (BASE2K - 5)
    lwe = enc.lwe_encrypt_sk(None, pt, torch.from_numpy(sk_lwe), BASE2K, 34, xe, xa)
    out["br"] = dict(m=m, brk=brk, block=block, lwe=lwe,
                     lut=lookup_table_new(64, BASE2K, 34, f, 8, device=CPU),
                     lut_ext=lookup_table_new(64, BASE2K, 34, f, 8, extension_factor=2,
                                              device=CPU))
    # 6. CKKS mul + rescale (dp 4): dryrun_multichip's _ck_* helpers' seeds
    m6 = get_module(64, 2, 28, device=CPU)
    sk6 = enc.secret_new(m6, 1, Source(b"\x08" * 32))
    skp6 = glwe_secret_prepare(m6, sk6)
    tsk = glwe_tensor_key_prepare(m6, enc.glwe_tensor_key_encrypt_sk(
        m6, sk6, skp6, BASE2K, 95, dnum=6, source_xe=Source(b"\x09" * 32),
        source_xa=Source(b"\x0a" * 32)))
    z = (np.random.default_rng(9).normal(size=(8, 32))
         + 1j * np.random.default_rng(10).normal(size=(8, 32)))
    encd = Encoder(64)

    def ck_encrypt(zz):
        pt = ck.encode(encd, zz, BASE2K, 95, 22, 30, device=CPU)
        return ck.encrypt_sk(m6, pt, skp6, 95, Source(b"\x0b" * 32), Source(b"\x0c" * 32),
                             batch_shape=zz.shape[:-1])

    out["ckks"] = dict(m=m6, tsk=tsk, c1=ck_encrypt(z), c2=ck_encrypt(-z))
    # 7. circuit bootstrap (dp 4)
    src7, xe, xa = Source(b"\x07" * 32), Source(b"\x05" * 32), Source(b"\x06" * 32)
    sk_lwe7 = src7.binary_prob((8,))
    sk7 = enc.secret_new(m, 1, src7)
    key = circuit_bootstrapping_keygen(m, sk_lwe7, sk7, glwe_secret_prepare(m, sk7), BASE2K,
                                       68, 4, 68, 4, 68, 4, xe, xa)
    pt7 = np.zeros((4, 2, 1), dtype=np.int64)
    pt7[:, 0, 0] = 1 << (BASE2K - 3)
    s7 = torch.from_numpy(sk_lwe7)
    lwe7 = enc.lwe_encrypt_sk(None, pt7, s7, BASE2K, 34, xe, xa)
    # the entry-point case: the four messages of log_domain 2
    pt7[:, 0, 0] = np.arange(4) << (BASE2K - 3)
    out["cbt"] = dict(m=m, key=key, lwe=lwe7,
                      lwe_entry=enc.lwe_encrypt_sk(None, pt7, s7, BASE2K, 34, xe, xa))
    return out


# the scenarios of dryrun_multichip at four ranks, then the seven entry points
SCENARIOS = ("ep_dp2_tp2", "ntt_sp4", "ring_ep_dp2_sp2", "nand_hybrid_dp4", "br_block_dp2_kp2",
             "ckks_mul_rescale_dp4", "cbt_dp4")
ENTRY_POINTS = ("glwe_external_product", "glwe_keyswitch", "blind_rotation_execute",
                "blind_rotation_execute_block", "blind_rotation_execute_extended",
                "circuit_bootstrap", "ckks_mul")


def run(world: int) -> dict:
    """Every scenario on this rank; {name: (output gathered whole,
    placements, collectives issued)} and the error checks."""
    import torch.distributed as dist

    from poulpy_tpu_torch.binfhe import blind_rotation as br
    from poulpy_tpu_torch.binfhe.circuit_bootstrapping import circuit_bootstrap
    from poulpy_tpu_torch.ckks import ops as ck
    from poulpy_tpu_torch.core.external_product import glwe_external_product
    from poulpy_tpu_torch.core.keyswitching import glwe_keyswitch
    from poulpy_tpu_torch.core.layouts import glwe_size
    from poulpy_tpu_torch.hal.module import module_with_mesh
    from poulpy_tpu_torch.parallel import (
        COLLECTIVES,
        make_hybrid_mesh,
        make_mesh,
        reset_collectives,
        shard_batch,
        sharded_external_product_fn,
        sharded_gate_bootstrap_fn,
    )
    from poulpy_tpu_torch.parallel.auto import shard_batch as auto_shard
    from poulpy_tpu_torch.parallel.collectives import check_backend
    from poulpy_tpu_torch.parallel.mesh import from_local, local_shard, mesh_from_ranks
    from poulpy_tpu_torch.parallel.sharded import (
        sharded_blind_rotation_block_fn,
        sharded_external_product_ring_fn,
    )
    from poulpy_tpu_torch.parallel.sharded_ntt import sharded_ntt_forward, sharded_ntt_inverse

    x = inputs()
    results, checks = {}, {}

    def record(name, fn):
        reset_collectives()
        out = fn()
        counts = dict(COLLECTIVES)
        results[name] = (out.full_tensor(), [str(p) for p in out.placements], counts)

    ep, ring, nand, b, c6, c7 = (x[k] for k in ("ep", "ring", "nand", "br", "ckks", "cbt"))
    m = ep["m"]
    mesh_dp = make_mesh(device=CPU)                                   # (dp 4, tp 1)
    res_size = glwe_size(BASE2K, K_CT)

    # the scenarios
    mesh = make_mesh(world, tp=2, device=CPU)
    fn = sharded_external_product_fn(m, mesh, BASE2K, res_size, ep["ggswp"].base2k)
    record("ep_dp2_tp2", lambda: fn(shard_batch(mesh, ep["ct"].data), ep["ggswp"].pmat))

    nt = x["ntt"]
    mesh_sp = mesh_from_ranks(CPU, (world,), ("sp",))
    primes, n = nt["m"].basis.primes, nt["m"].n
    dims = {"sp": 2}

    def ntt():
        fwd = sharded_ntt_forward(primes, n, mesh_sp, "sp", local_shard(mesh_sp, nt["r"], dims))
        back = sharded_ntt_inverse(primes, n, mesh_sp, "sp", fwd)
        checks["ntt_round_trip"] = bool(torch.equal(
            from_local(mesh_sp, back, dims).full_tensor(), nt["r"]))
        return from_local(mesh_sp, fwd, dims)

    record("ntt_sp4", ntt)

    mesh_ring = mesh_from_ranks(CPU, (2, 2), ("dp", "sp"))
    rfn = sharded_external_product_ring_fn(m, mesh_ring, BASE2K, res_size, ring["ggswp"].base2k)
    record("ring_ep_dp2_sp2", lambda: rfn(ring["ct"].data, ring["ggswp"].pmat))

    hmesh = make_hybrid_mesh(1, 1, device=CPU)
    checks["hybrid_shape"] = [tuple(hmesh.shape), hmesh.mesh_dim_names]
    gfn = sharded_gate_bootstrap_fn(nand["keys"], hmesh, "nand")
    record("nand_hybrid_dp4", lambda: gfn(shard_batch(hmesh, nand["c1"].data),
                                          shard_batch(hmesh, nand["c2"].data)))

    mesh_kp = mesh_from_ranks(CPU, (2, 2), ("dp", "kp"))
    bfn = sharded_blind_rotation_block_fn(b["m"], mesh_kp, b["lut"], b["brk"], b["block"])
    record("br_block_dp2_kp2", lambda: bfn(b["lwe"]))

    m6 = module_with_mesh(c6["m"], mesh_dp)
    c6a = c6["c1"].replace(glwe=c6["c1"].glwe.replace(data=auto_shard(m6, c6["c1"].glwe.data)))

    def ckks():
        prod = ck.mul(m6, c6a, c6["c2"], c6["tsk"])
        out = ck.rescale(prod, 5)
        checks["ckks_meta"] = [prod.meta.log_delta, prod.meta.log_budget, out.meta.log_delta,
                               out.meta.log_budget]
        results["ckks_mul"] = (prod.glwe.data.full_tensor(),
                               [str(p) for p in prod.glwe.data.placements], dict(COLLECTIVES))
        return out.glwe.data

    record("ckks_mul_rescale_dp4", ckks)

    m7 = module_with_mesh(c7["m"], mesh_dp)
    lwe7 = c7["lwe"].replace(data=auto_shard(m7, c7["lwe"].data))
    record("cbt_dp4", lambda: circuit_bootstrap(m7, lwe7, 2, c7["key"], dnum_res=2,
                                                k_res=34).data)

    # the entry points on the dp-4 mesh (ckks_mul came with its scenario)
    mm = module_with_mesh(m, mesh_dp)
    ct = ep["ct"]
    record("glwe_external_product", lambda: glwe_external_product(mm, ct, ep["ggswp"]).data)
    record("glwe_keyswitch", lambda: glwe_keyswitch(mm, ct, ep["ksk"]).data)
    lwe = b["lwe"].replace(data=auto_shard(mm, b["lwe"].data))
    record("blind_rotation_execute",
           lambda: br.blind_rotation_execute(mm, lwe, b["lut"], b["brk"]))
    record("blind_rotation_execute_block",
           lambda: br.blind_rotation_execute_block(mm, lwe, b["lut"], b["brk"], b["block"]))
    record("blind_rotation_execute_extended",
           lambda: br.blind_rotation_execute_extended(mm, lwe, b["lut_ext"], b["brk"],
                                                      b["block"]))
    record("circuit_bootstrap", lambda: circuit_bootstrap(m7, c7["lwe_entry"], 2, c7["key"],
                                                          dnum_res=2, k_res=34).data)

    # the errors: a batch the axis does not divide, a DTensor placed otherwise
    for name, bad in (("indivisible_batch", lambda: glwe_external_product(
            mm, ct.replace(data=ct.data[:3]), ep["ggswp"])),
                      ("misplaced_dtensor", lambda: glwe_external_product(
            mm, ct.replace(data=from_local(mesh_dp, ct.data, {"tp": 1})), ep["ggswp"]))):
        try:
            bad()
            checks[name] = "no error"
        except ValueError as e:
            checks[name] = f"ValueError: {e}"
    try:
        check_backend(None, torch.device("cuda"))
        checks["backend_mismatch"] = "no error"
    except RuntimeError as e:
        checks["backend_mismatch"] = f"RuntimeError: {e}"
    checks["local_is_mesh_less"] = mm.local is m and mm.local.mesh is None
    checks["tables_shared"] = mm.tables is m.tables
    imported = [None] * world
    dist.all_gather_object(imported, sorted(k for k in sys.modules
                                            if k.split(".")[0] in ("jax", "poulpy_tpu")))
    checks["imported"] = imported
    return dict(results=results, checks=checks)


def main() -> int:
    import torch.distributed as dist

    rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])
    torch.set_num_threads(1)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    dist.init_process_group("gloo", store=dist.FileStore(store, world), world_size=world,
                            rank=rank)
    try:
        res = run(world)
        if rank == 0:
            torch.save(res, out / "results.pt")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
