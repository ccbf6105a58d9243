"""Multi-card scale-out: meshes, batch sharding, CRT-prime, ring and key
sharding over `torch.distributed`.  Twin of `poulpy_tpu/parallel/`.

One process per rank, one rank per card: NCCL carries the collectives of
CUDA tensors, gloo those of CPU tensors, and a group whose backend does not
match the tensors' device raises (`collectives.py`).  A mesh is a
`DeviceMesh` (`mesh.py`), a sharded array a `DTensor`; a sharded region
takes each rank's shard, runs the port's kernels on plain tensors and
wraps the result.  Ciphertext batches shard over "dp" (no collective), the
CRT prime basis over "tp" (one all_gather per inverse transform), the ring
degree over "sp" (all_to_alls per transform) and the blind-rotation key
over "kp" (one all_reduce per block step).
"""

from poulpy_tpu_torch.parallel.collectives import COLLECTIVES, reset_collectives  # noqa: F401
from poulpy_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from poulpy_tpu_torch.parallel.multihost import (  # noqa: F401
    initialize_multihost,
    make_hybrid_mesh,
)
from poulpy_tpu_torch.parallel.sharded import (  # noqa: F401
    shard_batch,
    sharded_external_product_fn,
    sharded_gate_bootstrap_fn,
)
