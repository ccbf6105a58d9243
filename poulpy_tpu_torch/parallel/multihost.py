"""Multi-process initialization and the host-aware (dp, tp, sp) mesh: twin
of `poulpy_tpu/parallel/multihost.py`.

Every rank runs the same program, one process per card (NCCL) or per CPU
process (gloo): `initialize_multihost` joins them into the default process
group.  Axes that cross hosts ride the network, axes within a host NVLink,
so the mesh is built host-outer / card-inner (`torchrun`'s rank order:
rank = host · ranks_per_host + local rank):

* `dp` (ciphertext batch): no collective, the only axis that should span
  hosts;
* `tp` (CRT primes): one all_gather per inverse transform, within a host;
* `sp` (ring degree N): all_to_alls per transform, within a host.
"""

from __future__ import annotations

import datetime
import os
import socket
import warnings

import torch
import torch.distributed as dist

from poulpy_tpu_torch.hal.ntt import canonical_device
from poulpy_tpu_torch.parallel.collectives import BACKENDS
from poulpy_tpu_torch.parallel.mesh import mesh_from_ranks


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None, process_id: int | None = None,
                         initialization_timeout: int | None = None, device="cuda") -> None:
    """Join this process to the default process group (idempotent).

    With `coordinator_address` ("host:port", rank 0 listens there) the
    group is `init_process_group(init_method="tcp://…", world_size=
    num_processes, rank=process_id)`; a failure raises (a run asked to span
    ranks must not silently shrink to one).  Without it the group comes from
    torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK);
    where that is missing or fails, a warning, and the process stays
    single.  NCCL with one card per rank (LOCAL_RANK, else rank mod the card
    count) on the card, gloo for `device="cpu"`."""
    if dist.is_initialized():
        return
    device = canonical_device(device)
    backend = BACKENDS[device.type]
    timeout = (datetime.timedelta(seconds=initialization_timeout)
               if initialization_timeout is not None else None)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator needs num_processes and process_id")
        _set_card(device, process_id)
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id, timeout=timeout)
        return
    try:
        rank = int(os.environ["RANK"])
        _set_card(device, rank)
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    except (KeyError, ValueError, RuntimeError) as e:
        warnings.warn(f"no process group from the environment ({e!r}); continuing "
                      "single-process", RuntimeWarning, stacklevel=2)


def _set_card(device: torch.device, rank: int) -> None:
    """One card per rank: LOCAL_RANK's, else rank mod the card count."""
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)


def make_hybrid_mesh(tp: int = 1, sp: int = 1, device="cuda"):
    """(dp, tp, sp) mesh over every rank of the default process group,
    host-aware: tp·sp must divide the ranks per host, so that those axes
    stay within a host; dp takes the rest (hosts × leftover ranks).  The
    ranks must come host by host, as torchrun numbers them."""
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    order = list(dict.fromkeys(hosts))
    per_host = hosts.count(order[0])
    if any(hosts.count(h) != per_host for h in order) or hosts != sorted(
            hosts, key=order.index):
        raise ValueError(f"ranks are not numbered host by host: {hosts}")
    inner = tp * sp
    if per_host % inner:
        raise ValueError(f"tp*sp={inner} must divide the ranks per host {per_host} "
                         "(tp/sp collectives must stay within a host)")
    return mesh_from_ranks(device, (len(hosts) // inner, tp, sp), ("dp", "tp", "sp"))
