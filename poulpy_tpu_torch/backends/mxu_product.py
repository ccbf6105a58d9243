"""The "mxu" route of the GLWE gadget product, twin of
`poulpy_tpu/backends/mxu_product.py`, and the choice of route for the
non-wide products of `core/external_product.py`, `core/keyswitching.py` and
`core/operations.py`'s relinearization.

The routes are the JAX package's knobs: "fused" its default, "mxu"
`POULPY_TPU_MXU=1`, "fused_mxu" `POULPY_TPU_FUSED_MXU=1`, "fused_sl"
`POULPY_TPU_SL=1` (the fused pipeline in the sublane/lane-split layout,
`backends/fused_sl.py`), "fused_rot_shoup" `POULPY_TPU_ROT_MODE=1` (the
block blind rotation's x-power by Shoup; the products take "fused").

    limbs ──four-step forward (mxu4_forward_limbs, σ order)──►
    VMP with the σ-permuted matrix (vmp_apply) ──►
    four-step inverse (mxu4_inverse) ──► garner_exit (+ small at column 0)

The VMP is pointwise in N, so permuting both operands by σ is exact, and
the result equals `fused.fused_glwe_product`'s bit for bit.  Four launches
on CUDA (counters `mxu_forward`, `vmp`, `mxu_inverse`, `garner_exit`), the
plain versions on the CPU.  The TPU's tile padding has no counterpart here.

Preconditions, as in the JAX package: |input limbs| < 2^in_bits (the digit
plane count comes from it: 3 planes at in_bits 23), dsize 1, and the
callers' `fused_supported`.
"""

from __future__ import annotations

from poulpy_tpu_torch.backends.fused import fused_glwe_product, fused_supported, garner_exit
from poulpy_tpu_torch.backends.fused_mxu import fused_mxu_glwe_product, fused_mxu_supported
from poulpy_tpu_torch.backends.fused_sl import fused_glwe_product_sl, sl_applies
from poulpy_tpu_torch.backends.mxu import mxu4_forward_limbs, mxu4_inverse, sigma_index
from poulpy_tpu_torch.backends.mxu_ntt import MXU_MIN_N, NDIG
from poulpy_tpu_torch.backends.vmp import vmp_apply
from poulpy_tpu_torch.hal.module import Module


def _nd_for_bits(bits: int) -> int:
    """Digit planes needed so balanced base-256 digits cover |x| < 2^bits."""
    nd = 1
    while 128 * ((1 << (8 * nd)) - 1) // 255 < (1 << bits) - 1:
        nd += 1
    return min(nd, NDIG)


def mxu_glwe_product(module: Module, a_data, pmat, res_size: int, res_base2k: int,
                     pm_base2k: int, small=None, in_bits: int = 29):
    """`a_data` [..., ci, size_a, N] int64 limbs × `pmat` [rows, ci, co, psize,
    P, N] (Montgomery, butterfly order) → [..., co, res_size, N] normalized
    limbs; `small` [..., s_size, N] added at column 0."""
    t = module.tables
    rows, psize = pmat.shape[0], pmat.shape[3]
    rmax = min(rows, a_data.shape[-2])
    res = mxu4_forward_limbs(t, a_data[..., :rmax, :], _nd_for_bits(in_bits))
    prod = vmp_apply(module, res, pmat[..., sigma_index(t)])
    return garner_exit(module, mxu4_inverse(t, prod), psize, res_size, res_base2k, pm_base2k,
                       small)


ROUTES = ("fused", "mxu", "fused_mxu", "fused_sl", "fused_rot_shoup")


def mxu_route(module: Module, route: str, psize: int, res_base2k: int, dsize: int) -> str:
    """The route a non-wide product takes when `route` is asked for, by the
    JAX package's conditions: "fused_sl" (its POULPY_TPU_SL=1) where its
    fused kernel runs (`fused_supported`, any dsize) and `sl_applies(N)`;
    "fused_mxu" (POULPY_TPU_FUSED_MXU=1) where `fused_mxu_supported`, "mxu"
    (POULPY_TPU_MXU=1) where N ≥ MXU_MIN_N, both only for dsize 1 and
    `fused_supported`; "fused" otherwise, "fused_rot_shoup" included (its
    knob reaches only the block blind rotation)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route in ("fused", "fused_rot_shoup") or not fused_supported(psize, res_base2k):
        return "fused"
    if route == "fused_sl":
        return route if sl_applies(module.n) else "fused"
    if dsize != 1:
        return "fused"
    if route == "fused_mxu":
        return route if fused_mxu_supported(module, psize, res_base2k) else "fused"
    return route if module.n >= MXU_MIN_N else "fused"


def glwe_product(module: Module, route: str, a_data, pmat, res_size: int, res_base2k: int,
                 pm_base2k: int, dsize: int, small=None):
    """The non-wide product `a_data` × `pmat` (+ `small` at column 0) through
    the route `mxu_route` picks."""
    route = mxu_route(module, route, pmat.shape[3], res_base2k, dsize)
    if route == "fused_sl":
        return fused_glwe_product_sl(module, a_data, pmat, res_size, res_base2k, pm_base2k,
                                     dsize=dsize, small=small)
    if route == "fused_mxu":
        return fused_mxu_glwe_product(module, a_data, pmat, res_size, res_base2k, pm_base2k,
                                      small=small)
    if route == "mxu":
        return mxu_glwe_product(module, a_data, pmat, res_size, res_base2k, pm_base2k,
                                small=small, in_bits=min(29, pm_base2k + 6))
    return fused_glwe_product(module, a_data, pmat, res_size, res_base2k, pm_base2k,
                              dsize=dsize, small=small)
