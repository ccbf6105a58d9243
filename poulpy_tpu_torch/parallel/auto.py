"""Transparent dp-sharding of the public entry points over a Module-attached
mesh: twin of `poulpy_tpu/parallel/auto.py`.

Attach a mesh to a Module (`hal.module.module_with_mesh`) and the wired
entry points (external product, keyswitch, the three blind rotations,
circuit bootstrap, CKKS mul) run their batch sharded over the mesh's
`batch_axis` with no call-site changes.  Each checks `module.mesh`; if set,
it runs itself through `dp_shard` with `module.local`, the mesh-less twin,
on this rank's shard of every batch operand's leading axis, key material
replicated (every rank holds it whole), and wraps the outputs as DTensors
placed `Shard(0)` on the batch axis.  Pure dp issues no collective.
"""

from __future__ import annotations

import dataclasses

import torch

from poulpy_tpu_torch.parallel.mesh import from_local, local_shard


def tree_map(fn, tree):
    """`fn` on every tensor in `tree`, through the port's layout
    dataclasses (nested ones too), tuples, lists and dicts; every other
    field (`base2k`, `k`, `meta`'s ints, …) passes through unchanged."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def dp_shard(module, local_fn, *batch_trees):
    """`local_fn(*batch_trees)` on this rank's shard: the leading axis of
    every tensor in the trees split over `module.batch_axis` (DTensors so
    placed, or full tensors every rank holds), the outputs' tensors wrapped
    as DTensors placed likewise.  Leading dims must divide the axis size."""
    dims = {module.batch_axis: 0}
    local = [tree_map(lambda x: local_shard(module.mesh, x, dims), t) for t in batch_trees]
    return tree_map(lambda x: from_local(module.mesh, x, dims), local_fn(*local))


def shard_batch(module, tree, axis: int = 0):
    """The tensors of `tree` as DTensors split on `axis` over the module's
    batch axis: each rank keeps its slice of the full tensor it holds (no
    data moves), to feed the dp-sharded entry points."""
    if module.mesh is None:
        raise ValueError("module has no mesh (use module_with_mesh)")
    dims = {module.batch_axis: axis}
    return tree_map(lambda x: from_local(module.mesh, local_shard(module.mesh, x, dims), dims),
                    tree)
