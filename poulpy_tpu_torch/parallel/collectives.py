"""The collectives of the sharded builders, on the device that holds the data.

Each wrapper checks that its process group's backend matches the tensor's
device (NCCL for a CUDA tensor, gloo for a CPU one) and raises otherwise:
nothing moves a CUDA tensor through gloo (which would stage it through the
host) or degrades to another backend.  `COLLECTIVES` counts the calls per
kind, so that a run can show how many collectives an op issued (the JAX
package's design: one all_gather per prime-sharded inverse transform, one
psum per key-sharded block step, four all_to_alls per ring-sharded forward
and inverse transform).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
COLLECTIVES = {"all_gather": 0, "all_reduce": 0, "all_to_all": 0}


def reset_collectives() -> None:
    for name in COLLECTIVES:
        COLLECTIVES[name] = 0


def check_backend(group, device) -> None:
    """Raise unless `group`'s backend (the default group's for None) is the
    one for `device`'s type."""
    device = torch.device(device)
    want = BACKENDS.get(device.type)
    have = dist.get_backend(group)
    if have != want:
        raise RuntimeError(f"a {have} process group for {device.type} tensors: "
                           f"collectives on {device.type} run over {want}")


def all_gather(x, group, dim: int):
    """The group's shards of `x` concatenated along `dim`, in rank order
    (jax.lax.all_gather(..., tiled=True))."""
    check_backend(group, x.device)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    COLLECTIVES["all_gather"] += 1
    return torch.cat(parts, dim=dim)


def all_reduce_sum(x, group):
    """The elementwise sum of `x` over the group (jax.lax.psum)."""
    check_backend(group, x.device)
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    COLLECTIVES["all_reduce"] += 1
    return out


def all_to_all(x, group):
    """x [D, ...]: chunk k goes to rank k; returns [D, ...] with chunk k
    from rank k (jax.lax.all_to_all(x, axis, 0, 0, tiled=False))."""
    check_backend(group, x.device)
    world = dist.get_world_size(group)
    if x.shape[0] != world:
        raise ValueError(f"all_to_all of {x.shape[0]} chunks over {world} ranks")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    COLLECTIVES["all_to_all"] += 1
    return out
