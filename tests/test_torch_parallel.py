"""poulpy_tpu_torch.parallel against the JAX package's sharded builders, bit
for bit (tolerance 0), on the CPU.

One gloo process group of four ranks (`tests/torch_parallel_ranks.py`: one
process per rank, importing torch and the port, not JAX) runs, once per
file, the seven scenarios of `__graft_entry__.py`'s dryrun_multichip cut
from eight devices to four, and the seven entry points that branch on
`module.mesh` on a dp-4 mesh-attached module:

    ep_dp2_tp2              sharded_external_product_fn, (dp 2, tp 2)
    ntt_sp4                 sharded_ntt_forward / _inverse, sp 4, N 256
    ring_ep_dp2_sp2         sharded_external_product_ring_fn, (dp 2, sp 2)
    nand_hybrid_dp4         sharded_gate_bootstrap_fn on make_hybrid_mesh()
    br_block_dp2_kp2        sharded_blind_rotation_block_fn, (dp 2, kp 2)
    ckks_mul_rescale_dp4    ckks mul + rescale(5) on module_with_mesh
    cbt_dp4                 circuit_bootstrap on module_with_mesh

The JAX package runs the same scenarios and entry points, under jax.jit, on
4 of the conftest's 8 host CPU devices at the same mesh shapes, on the
ranks' inputs (`torch_parallel_ranks.inputs()`, made by the port from seeds:
the JAX package's keygen compiles for minutes on the CPU) carried over by
`interop`.  Each case also holds the output's placements and the
collectives the port issued (one all_gather per prime-sharded inverse
transform, four all_to_alls per ring-sharded round trip, one all_reduce per
key-sharded block step, none for dp); the ranks imported no JAX.
"""

import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_parallel_ranks as ranks
from poulpy_tpu.binfhe import blind_rotation as jbr
from poulpy_tpu.binfhe import circuit_bootstrapping as jcbt
from poulpy_tpu.binfhe import gates as jgates
from poulpy_tpu.binfhe import lut as jlut
from poulpy_tpu.ckks import layouts as jck_layouts
from poulpy_tpu.ckks import ops as jck
from poulpy_tpu.core import layouts as jlay
from poulpy_tpu.core import prepared as jprep
from poulpy_tpu.core.external_product import glwe_external_product
from poulpy_tpu.core.keyswitching import glwe_keyswitch
from poulpy_tpu.hal.module import get_module as j_get_module
from poulpy_tpu.hal.module import module_with_mesh
from poulpy_tpu.parallel import auto as jauto
from poulpy_tpu.parallel import sharded as jsh
from poulpy_tpu.parallel.sharded_ntt import sharded_ntt_forward, sharded_ntt_inverse
from poulpy_tpu_torch.utils import interop

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
RANKS_TIMEOUT_S = 300
JAX_THREADS = 4

JAX_CLASSES = {cls.__name__: cls for cls in (
    jlay.GLWECiphertext, jlay.LWECiphertext, jprep.GGSWPrepared, jprep.GGLWEPrepared,
    jprep.GLWETensorKeyPrepared, jprep.GLWEAutomorphismKeyPrepared, jlut.LookupTable,
    jbr.BlindRotationKeyPrepared, jcbt.CircuitBootstrappingKey, jck_layouts.CKKSCiphertext,
    jck_layouts.CKKSMeta)}

# placements of each output, and the collectives the port issues for it
EXPECT = {
    "ep_dp2_tp2": (["S(0)", "R"], {"all_gather": 1}),
    "ntt_sp4": (["S(2)"], {"all_to_all": 4}),
    "ring_ep_dp2_sp2": (["S(0)", "S(3)"], {"all_to_all": 4}),
    "nand_hybrid_dp4": (["S(0)", "R", "R"], {}),
    "br_block_dp2_kp2": (["S(0)", "R"], {"all_reduce": 2}),      # n_lwe 8, blocks of 4
    "ckks_mul_rescale_dp4": (["S(0)", "R"], {}),
}


def to_jax(obj):
    """The JAX package's object from `interop.to_fields` of the port's."""
    def conv(v):
        if isinstance(v, np.ndarray):
            return jnp.asarray(v)
        if interop._is_fields(v):
            return build(*v)
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, list):
            return [conv(x) for x in v]
        return v

    def build(name, fields):
        return JAX_CLASSES[name](**{k: conv(v) for k, v in fields.items()})

    return build(*interop.to_fields(obj))


def jax_keys(keys):
    """The JAX package's BootstrapKeys from the port's."""
    p = keys.params
    params = jgates.GateParams(**{f: getattr(p, f) for f in p.__dataclass_fields__})
    return jgates.BootstrapKeys(module=j_get_module(p.n_glwe, p.nprimes, p.prime_bits),
                                params=params, brk=to_jax(keys.brk),
                                to_lwe=to_jax(keys.to_lwe), lut=to_jax(keys.lut))


def jax_mesh(shape, names):
    return Mesh(np.array(jax.devices()[:WORLD]).reshape(shape), names)


def jax_outputs(x) -> dict:
    """Every scenario and entry point through the JAX package: independent
    jobs, run in threads (XLA compiles without holding the interpreter
    lock), the longest first."""
    ep, nt, nand, b, c6, c7 = (x[k] for k in ("ep", "ntt", "nand", "br", "ckks", "cbt"))
    jm = j_get_module(64, 2)
    ct, ggswp, ksk = to_jax(ep["ct"]), to_jax(ep["ggswp"]), to_jax(ep["ksk"])
    lwe, lut, lut_ext, brk = (to_jax(b[k]) for k in ("lwe", "lut", "lut_ext", "brk"))
    res_size = ct.data.shape[-2]
    mesh_dp = jax_mesh((WORLD,), ("dp",))
    mm = module_with_mesh(jm, mesh_dp)

    def cbt():
        m7 = module_with_mesh(j_get_module(64, 2), mesh_dp)
        key = to_jax(c7["key"])
        run = jax.jit(lambda lw: jcbt.circuit_bootstrap(m7, lw, 2, key, 2, 34).data)
        out = {}
        for name, lwe7 in (("cbt_dp4", c7["lwe"]), ("circuit_bootstrap", c7["lwe_entry"])):
            lwe7 = to_jax(lwe7)
            out[name] = run(lwe7.replace(data=jauto.shard_batch(m7, lwe7.data)))
        return out

    def ckks():
        m6 = module_with_mesh(j_get_module(64, 2, 28), mesh_dp)
        tsk, c1, c2 = to_jax(c6["tsk"]), to_jax(c6["c1"]), to_jax(c6["c2"])
        c1 = c1.replace(glwe=c1.glwe.replace(data=jauto.shard_batch(m6, c1.glwe.data)))

        @jax.jit
        def run(a, b_):
            prod = jck.mul(m6, a, b_, tsk)
            return prod.glwe.data, jck.rescale(prod, 5).glwe.data

        return dict(zip(("ckks_mul", "ckks_mul_rescale_dp4"), run(c1, c2)))

    def rotations():
        lw = lwe.replace(data=jauto.shard_batch(mm, lwe.data))
        return {"blind_rotation_execute": jbr.blind_rotation_execute(mm, lw, lut, brk),
                "blind_rotation_execute_block": jbr.blind_rotation_execute_block(
                    mm, lw, lut, brk, b["block"]),
                "blind_rotation_execute_extended": jbr.blind_rotation_execute_extended(
                    mm, lw, lut_ext, brk, b["block"])}

    def gate():
        hmesh = jax_mesh((WORLD, 1, 1), ("dp", "tp", "sp"))
        run = jsh.sharded_gate_bootstrap_fn(jax_keys(nand["keys"]), hmesh, "nand")
        return {"nand_hybrid_dp4": run(*(jsh.shard_batch(hmesh, jnp.asarray(c.data.numpy()))
                                         for c in (nand["c1"], nand["c2"])))}

    def products():
        return {"glwe_external_product": glwe_external_product(mm, ct, ggswp).data,
                "glwe_keyswitch": glwe_keyswitch(mm, ct, ksk).data}

    def br_kp():
        run = jsh.sharded_blind_rotation_block_fn(jm, jax_mesh((2, 2), ("dp", "kp")), lut, brk,
                                                  b["block"])
        return {"br_block_dp2_kp2": run(lwe)}

    def ep_tp():
        mesh = jax_mesh((2, 2), ("dp", "tp"))
        run = jsh.sharded_external_product_fn(jm, mesh, ranks.BASE2K, res_size, ggswp.base2k)
        return {"ep_dp2_tp2": run(jsh.shard_batch(mesh, ct.data), ggswp.pmat)}

    def ring():
        mesh = jax_mesh((2, 2), ("dp", "sp"))
        run = jsh.sharded_external_product_ring_fn(jm, mesh, ranks.BASE2K, res_size,
                                                   ggswp.base2k)
        return {"ring_ep_dp2_sp2": run(
            jax.device_put(ct.data, NamedSharding(mesh, P("dp", None, None, "sp"))),
            jax.device_put(ggswp.pmat, NamedSharding(mesh, P(None, None, None, None, None,
                                                             "sp"))))}

    def ntt():
        m2 = j_get_module(256, 2)
        mesh = jax_mesh((WORLD,), ("sp",))
        spec = P(None, None, "sp")

        def region(f):
            return jax.jit(jax.shard_map(lambda xl: f(m2.basis.primes, 256, WORLD, "sp", xl),
                                         mesh=mesh, in_specs=spec, out_specs=spec,
                                         check_vma=False))

        fwd = region(sharded_ntt_forward)(jnp.asarray(nt["r"].numpy()))
        return {"ntt_sp4": fwd, "ntt_round_trip": region(sharded_ntt_inverse)(fwd),
                "ntt_r": nt["r"].numpy()}

    jobs = (cbt, ckks, rotations, gate, products, br_kp, ep_tp, ring, ntt)
    with ThreadPoolExecutor(JAX_THREADS) as pool:
        parts = list(pool.map(lambda job: job(), jobs))
    return {k: np.asarray(v) for part in parts for k, v in part.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks started first, the JAX package's outputs computed
    while they run; then the ranks' results (the others stopped as soon as
    one rank fails)."""
    tmp = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    logs = [tmp / f"rank{r}.log" for r in range(WORLD)]
    procs = []
    try:
        for r, log in enumerate(logs):
            with open(log, "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "tests" / "torch_parallel_ranks.py"), str(r),
                     str(WORLD), str(tmp / "store"), str(tmp)],
                    stdout=out, stderr=subprocess.STDOUT, env=env, cwd=ROOT))
        want = jax_outputs(ranks.inputs())
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        while (any(p.poll() is None for p in procs) and time.monotonic() < deadline
               and not any(p.returncode for p in procs)):
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} rc={p.returncode}\n{log.read_text()[-4000:]}"
    have = torch.load(tmp / "results.pt", weights_only=False)
    return have, want


def _check(runs, name):
    have, want = runs
    out, placements, counts = have["results"][name]
    assert out.shape == want[name].shape and np.array_equal(out.numpy(), want[name])
    return placements, counts


@pytest.mark.parametrize("name", ranks.SCENARIOS)
def test_scenario_matches_jax(runs, name):
    placements, counts = _check(runs, name)
    want_placements, want_counts = EXPECT.get(name, (["S(0)", "R"], {}))
    assert placements == want_placements
    assert {k: v for k, v in counts.items() if v} == want_counts
    if name == "ntt_sp4":
        assert runs[0]["checks"]["ntt_round_trip"]
        assert np.array_equal(runs[1]["ntt_round_trip"], runs[1]["ntt_r"])
    if name == "nand_hybrid_dp4":
        assert runs[0]["checks"]["hybrid_shape"] == [(WORLD, 1, 1), ("dp", "tp", "sp")]


@pytest.mark.parametrize("name", ranks.ENTRY_POINTS)
def test_entry_point_on_mesh_matches_jax(runs, name):
    placements, counts = _check(runs, name)
    assert placements == ["S(0)", "R"]
    assert not any(counts.values())


def test_ckks_meta_through_mesh(runs):
    """mul then rescale(5) on the mesh keep the JAX package's metadata."""
    assert runs[0]["checks"]["ckks_meta"] == [22, 8, 22, 3]


def test_ranks_imported_no_jax(runs):
    assert runs[0]["checks"]["imported"] == [[]] * WORLD


def test_mesh_module_shares_tables_and_rejects_bad_batches(runs):
    checks = runs[0]["checks"]
    assert checks["local_is_mesh_less"] and checks["tables_shared"]
    assert checks["indivisible_batch"].startswith("ValueError: dimension 0")
    assert checks["misplaced_dtensor"].startswith("ValueError: a DTensor placed")
    assert checks["backend_mismatch"].startswith("RuntimeError: a gloo process group")
