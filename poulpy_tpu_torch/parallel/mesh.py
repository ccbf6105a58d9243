"""Meshes and placements: twin of `poulpy_tpu/parallel/mesh.py`.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of
the default process group, one rank per card (NCCL) or per CPU process
(gloo).  A sharded array is a `DTensor` whose placements name, per mesh
axis, the tensor dimension it splits (`Shard(dim)`) or `Replicate()`: the
`PartitionSpec` of the JAX package read axis by axis.  A sharded region
(the twin of `shard_map`) takes each rank's shard with `local_shard`, runs
plain tensors through the port's kernels and wraps the result with
`from_local`; neither moves data between ranks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from poulpy_tpu_torch.hal.ntt import canonical_device
from poulpy_tpu_torch.parallel.collectives import check_backend


def mesh_from_ranks(device, shape: tuple[int, ...], names: tuple[str, ...]) -> DeviceMesh:
    """A mesh of `shape` over the ranks 0 … world − 1 of the default process
    group, in rank order (the last axis varies fastest), on `device`'s type;
    the group's backend must match the device (NCCL for "cuda", gloo for
    "cpu")."""
    device = canonical_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.initialize_multihost (or "
                           "torch.distributed.init_process_group) first")
    check_backend(None, device)
    world = dist.get_world_size()
    size = 1
    for d in shape:
        size *= d
    if size != world:
        raise ValueError(f"a mesh of {shape} ({size} ranks) over a process group of {world}")
    return DeviceMesh(device.type, torch.arange(world).reshape(shape), mesh_dim_names=names)


def make_mesh(n_devices: int | None = None, tp: int = 1, device="cuda") -> DeviceMesh:
    """(dp, tp) mesh over the default process group's ranks: dp shards
    ciphertext batches, tp shards the CRT prime basis.  tp must divide the
    rank count (and, for the prime-sharded product, the module's prime
    count).  The card unless `device="cpu"` (then a gloo group)."""
    world = dist.get_world_size() if dist.is_initialized() else None
    n_devices = world if n_devices is None else n_devices
    if n_devices is None or n_devices % tp:
        raise ValueError(f"tp={tp} must divide the rank count {n_devices}")
    return mesh_from_ranks(device, (n_devices // tp, tp), ("dp", "tp"))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[_axis_index(mesh, axis)]


def _axis_index(mesh: DeviceMesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"the mesh has no axis {axis!r}: {names}")
    return names.index(axis)


def placements(mesh: DeviceMesh, dims: dict[str, int]) -> list:
    """Per mesh axis, `Shard(dims[axis])` where `dims` names the axis, else
    `Replicate()`."""
    return [Shard(dims[a]) if a in dims else Replicate() for a in mesh.mesh_dim_names]


def local_shard(mesh: DeviceMesh, x, dims: dict[str, int]):
    """This rank's shard of `x` with tensor dimension `dims[axis]` split
    over each named mesh axis (the rest replicated): `x.to_local()` of a
    DTensor placed so, else the rank's slice of a full tensor (a replicated
    DTensor or a plain tensor every rank holds whole).  Every split
    dimension must be a multiple of its axis size."""
    want = placements(mesh, dims)
    if isinstance(x, DTensor):
        if x.device_mesh != mesh:
            raise ValueError("a DTensor on another mesh")
        shard = list(x.placements) == want
        if not shard and not all(p.is_replicate() for p in x.placements):
            raise ValueError(f"a DTensor placed {x.placements}, expected {want} or replicated")
        _check_divides(mesh, x.shape, dims)
        x = x.to_local()
        if shard:
            return x
    _check_divides(mesh, x.shape, dims)
    for axis, dim in dims.items():
        size = x.shape[dim] // axis_size(mesh, axis)
        x = x.narrow(dim, mesh.get_local_rank(axis) * size, size)
    return x


def _check_divides(mesh: DeviceMesh, shape, dims: dict[str, int]) -> None:
    for axis, dim in dims.items():
        d = axis_size(mesh, axis)
        if shape[dim] % d:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not divide over "
                             f"{axis}={d}")


def from_local(mesh: DeviceMesh, x, dims: dict[str, int]) -> DTensor:
    """The DTensor whose shard on this rank is `x`, placed as `placements`
    says (no data moves)."""
    return DTensor.from_local(x, mesh, placements(mesh, dims), run_check=False)
