"""Hand-written CUDA kernels for Hopper (sm_90a) and their PyTorch wrappers.

Each wrapper takes its kernel's plain PyTorch version for a tensor that lies
on the CPU, and launches its kernel for a CUDA tensor (or raises): there is
no fallback and no switch.  `LAUNCHES` counts kernel launches per wrapper,
so that a run can show which kernels its path went through; `NTT_ROWS`
counts the NTT kernel's launches per (direction, primes, N, rows per prime,
prime bits of the basis), so that a run can show at which shapes, and on
which basis, its path transforms.
"""

from collections import Counter

LAUNCHES = {"ntt_forward": 0, "ntt_inverse": 0, "vmp": 0, "fused_product": 0,
            "fused_product_small": 0, "fused_product_small64": 0, "fused_br_step": 0,
            "br_block_step": 0, "br_block_chain": 0, "br_block_step_shoup": 0,
            "br_block_chain_shoup": 0, "fused_sl_product": 0, "fused_sl_block_step": 0,
            "tensor_product": 0, "wide_product": 0,
            "wide_tensor": 0, "mxu_forward": 0, "mxu_inverse": 0, "garner_exit": 0,
            "fused_mxu_product": 0, "fused_mxu_product_small": 0, "fused_mxu_br_block_step": 0}
NTT_ROWS: Counter = Counter()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    NTT_ROWS.clear()
