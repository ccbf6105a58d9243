"""poulpy_tpu_torch: the PyTorch / CUDA port of poulpy_tpu for one NVIDIA H100.

Mirrors the JAX package's tree (`hal/`, `backends/`, `core/`) and function
names.  Plain PyTorch int64 code runs on any device; the hand-written CUDA
kernels of `csrc/` (built for sm_90a at first use) carry the NTT, the VMP and
the fused external product on CUDA tensors.
"""

from poulpy_tpu_torch.hal.module import Module, get_module
from poulpy_tpu_torch.hal.source import Source

__all__ = ["Module", "Source", "get_module"]
