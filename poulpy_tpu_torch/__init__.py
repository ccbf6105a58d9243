"""poulpy_tpu_torch: the PyTorch / CUDA port of poulpy_tpu for one NVIDIA H100.

Mirrors the JAX package's tree (`hal/`, `backends/`, `core/`, `binfhe/`,
`ckks/`) and function names.  Plain PyTorch int64 code runs on any device;
the hand-written CUDA kernels of `csrc/` (built for sm_90a at first use)
carry the NTT, the VMP, the fused external product and keyswitch, the
block-binary blind-rotation step, and the wide (128-bit) product and CKKS
tensor product on CUDA tensors.  Entry points work on the
card unless the caller passes `device="cpu"`.
"""

from poulpy_tpu_torch.hal.module import Module, get_module
from poulpy_tpu_torch.hal.source import Source

__all__ = ["Module", "Source", "get_module"]
