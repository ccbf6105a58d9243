"""poulpy_tpu_torch.parallel's process groups, meshes and guards, without JAX.

CPU part: `initialize_multihost` as tests/test_multihost.py holds the JAX
package's: two OS processes join one gloo group at 127.0.0.1 and build the
host-aware (dp, tp, sp) mesh with `make_hybrid_mesh` (the ranks of one host
on its inner axes), then run a collective over each axis through the port's
wrappers and gather a dp-sharded DTensor; an explicit coordinator that
nobody serves raises within its timeout; no coordinator and no torchrun
environment warns and stays single-process.  Also the pieces a sharded
region stands on: `NttTables.sliced` (a tp rank's tables), `tree_map` over
the layouts, the guards of the prime and ring splits.

CUDA part (`-m cuda`, skipped without a card): a gloo group refuses a CUDA
tensor and an NCCL group a CPU one in the port's collectives (gloo would
stage a CUDA tensor through the host), and two NCCL ranks on one card are
refused by NCCL (`tools/nccl_one_rank_per_card.py`).  On the machine with
the card run them with

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_multihost.py -q
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from poulpy_tpu_torch.ckks.layouts import CKKSCiphertext, CKKSMeta
from poulpy_tpu_torch.core.layouts import GLWECiphertext
from poulpy_tpu_torch.hal.module import get_module
from poulpy_tpu_torch.hal.ntt import NttTables, ntt_forward
from poulpy_tpu_torch.hal.primes import PrimeBasis
from poulpy_tpu_torch.parallel import initialize_multihost
from poulpy_tpu_torch.parallel.auto import tree_map
from poulpy_tpu_torch.parallel.collectives import all_gather
from poulpy_tpu_torch.parallel.mesh import mesh_from_ranks
from poulpy_tpu_torch.parallel.sharded import prime_slice
from poulpy_tpu_torch.parallel.sharded_ntt import _check

ROOT = Path(__file__).resolve().parent.parent

_WORKER = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    from poulpy_tpu_torch.parallel import initialize_multihost, make_hybrid_mesh
    from poulpy_tpu_torch.parallel.collectives import all_gather, all_reduce_sum
    from poulpy_tpu_torch.parallel.mesh import from_local

    port, pid = sys.argv[1], int(sys.argv[2])
    initialize_multihost(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
                         process_id=pid, initialization_timeout=60, device="cpu")
    initialize_multihost(coordinator_address="127.0.0.1:1", num_processes=2,
                         process_id=pid, device="cpu")        # idempotent: a no-op
    assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"

    mesh = make_hybrid_mesh(tp=1, device="cpu")
    assert mesh.mesh_dim_names == ("dp", "tp", "sp") and tuple(mesh.shape) == (2, 1, 1)
    assert mesh.mesh[:, 0, 0].tolist() == [0, 1]                  # dp spans both ranks
    x = torch.tensor([pid + 1], dtype=torch.int64)
    assert all_reduce_sum(x, mesh.get_group("dp")).tolist() == [3]
    rows = torch.arange(8, dtype=torch.int64).reshape(4, 2)
    dt = from_local(mesh, rows[2 * pid : 2 * pid + 2], {"dp": 0})
    assert torch.equal(dt.full_tensor(), rows)

    inner = make_hybrid_mesh(tp=2, device="cpu")                  # one host: tp inside it
    assert tuple(inner.shape) == (1, 2, 1)
    assert all_gather(x, inner.get_group("tp"), 0).tolist() == [1, 2]
    try:
        make_hybrid_mesh(tp=3, device="cpu")
        raise AssertionError("tp=3 over 2 ranks per host was accepted")
    except ValueError:
        pass
    dist.destroy_process_group()
    print(f"WORKER{pid}-OK")
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(k, None)
    return env


def test_two_process_hybrid_mesh():
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(port), str(pid)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=_env(),
                              cwd=ROOT)
             for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=150)
            outs.append((p.returncode, out.decode(), err.decode()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {pid} rc={rc}\nstdout:{out}\nstderr:{err[-3000:]}"
        assert f"WORKER{pid}-OK" in out


def test_initialize_multihost_fails_loud_on_bad_coordinator():
    """An explicit coordinator that nobody serves raises within its timeout;
    it never degrades to a single process."""
    code = textwrap.dedent("""
        import torch.distributed as dist
        from poulpy_tpu_torch.parallel import initialize_multihost
        try:
            initialize_multihost(coordinator_address="127.0.0.1:1", num_processes=2,
                                 process_id=1, initialization_timeout=2, device="cpu")
        except Exception as e:
            print("RAISED-OK", type(e).__name__, dist.is_initialized())
        else:
            print("SWALLOWED")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=_env(), cwd=ROOT)
    assert "SWALLOWED" not in out.stdout, out.stdout
    assert "RAISED-OK" in out.stdout and out.stdout.split()[-1] == "False", (
        out.returncode, out.stdout, out.stderr[-2000:])


def test_initialize_multihost_without_coordinator_stays_single(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.warns(RuntimeWarning, match="single-process"):
        initialize_multihost(device="cpu")
    assert not dist.is_initialized()


def test_explicit_coordinator_needs_its_rank_and_size():
    with pytest.raises(ValueError, match="num_processes and process_id"):
        initialize_multihost(coordinator_address="127.0.0.1:1", device="cpu")


@pytest.mark.parametrize("lo, hi", [(0, 1), (1, 2), (1, 3), (0, 4)])
def test_sliced_tables_are_the_sub_basis_tables(lo, hi):
    """A tp rank's tables: its rows of the full tables, the CRT constants of
    its primes, and the same transform as the full basis on those primes."""
    t = get_module(64, 4, device="cpu").tables
    s = t.sliced(lo, hi)
    sub = NttTables(PrimeBasis(t.basis.primes[lo:hi]), 64, "cpu")
    for name in ("psi_brv", "psi_inv_brv", "n_inv", "p", "qinv", "r2", "two40_mod_p",
                 "garner_inv_mont", "garner_pprod_mont", "garner_weight", "modulus_u64",
                 "half_digits"):
        assert torch.equal(getattr(s, name), getattr(sub, name)), name
    assert s.psi_brv.data_ptr() == t.psi_brv[lo].data_ptr()          # a view, no copy
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 2**20, (3, 4, 64)))
    x = x % t.p[:, None]
    assert torch.equal(ntt_forward(s, x[:, lo:hi]), ntt_forward(t, x)[:, lo:hi])


def test_tree_map_maps_the_tensors_of_nested_layouts():
    data = torch.arange(24).reshape(1, 2, 3, 4)
    ct = CKKSCiphertext(glwe=GLWECiphertext(data=data, base2k=17, k=51),
                        meta=CKKSMeta(log_delta=22, log_budget=30))
    out = tree_map(lambda x: x + 1, ct)
    assert torch.equal(out.glwe.data, data + 1)
    assert (out.glwe.base2k, out.glwe.k, out.meta) == (17, 51, ct.meta)


def test_split_guards():
    assert prime_slice(4, 2, 1) == (2, 4)
    with pytest.raises(ValueError, match="must divide the prime count"):
        prime_slice(3, 2, 0)
    _check(256, 8)                       # D² = 64 ≤ N/2 = 128
    with pytest.raises(ValueError, match="D² ≤ N/2"):
        _check(64, 8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture
def group(tmp_path):
    """A one-rank process group of the backend the test asks for."""
    def start(backend):
        dist.init_process_group(backend, store=dist.FileStore(str(tmp_path / "store"), 1),
                                world_size=1, rank=0)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_gloo_group_refuses_cuda_tensors(cuda, group):
    group("gloo")
    with pytest.raises(RuntimeError, match="a gloo process group for cuda tensors"):
        all_gather(torch.ones(4, dtype=torch.int64, device=cuda), None, 0)
    with pytest.raises(RuntimeError, match="a gloo process group for cuda tensors"):
        mesh_from_ranks(cuda, (1,), ("dp",))


@pytest.mark.cuda
def test_cuda_nccl_group_refuses_cpu_tensors(cuda, group):
    torch.cuda.set_device(cuda)
    group("nccl")
    with pytest.raises(RuntimeError, match="a nccl process group for cpu tensors"):
        all_gather(torch.ones(4, dtype=torch.int64), None, 0)
    x = torch.arange(4, dtype=torch.int64, device=cuda)
    assert torch.equal(all_gather(x, None, 0), x)


@pytest.mark.cuda
def test_cuda_two_nccl_ranks_on_one_card_are_refused(cuda):
    out = subprocess.run([sys.executable, str(ROOT / "tools" / "nccl_one_rank_per_card.py")],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]
    assert '"two_ranks_one_card_refused": true' in out.stdout
