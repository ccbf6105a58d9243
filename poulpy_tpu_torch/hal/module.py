"""Module: the per-ring-degree backend handle.

Twin of `poulpy_tpu/hal/module.py`: ring degree N, the CRT prime basis and
its NTT tables, resident on an explicit `device`, and the mesh handle that
`module_with_mesh` attaches (a `DeviceMesh` of `parallel/mesh.py`: the
public entry points then run their batch sharded over its `batch_axis`,
`parallel/auto.py`).
"""

from __future__ import annotations

import copy
import functools

import torch

from poulpy_tpu_torch.hal.ntt import NttTables, canonical_device
from poulpy_tpu_torch.hal.primes import LOG_N_MAX, PrimeBasis, ntt_primes

GALOIS_GENERATOR = 5  # the generator of the slot rotations (module.rs GALOISGENERATOR)


class Module:
    """Backend handle: ring degree + CRT-NTT tables on `device` (the card
    unless the caller asks for the CPU).

    `prime_bits` bounds the basis primes below 2^prime_bits (30 maximises
    bits per prime; 28 is the basis the headline configuration uses).
    """

    def __init__(self, n: int, nprimes: int = 4, prime_bits: int = 30, device="cuda"):
        assert n & (n - 1) == 0 and 4 <= n <= (1 << LOG_N_MAX)
        assert 18 <= prime_bits <= 30
        self.n = n
        self.log_n = n.bit_length() - 1
        self.device = canonical_device(device)
        self.basis = PrimeBasis(ntt_primes(nprimes, below=1 << prime_bits))
        self.tables = NttTables(self.basis, n, self.device)
        # the mesh handle: set by module_with_mesh, read by the entry points
        # that shard their batch (parallel/auto.py)
        self.mesh = None
        self.batch_axis = "dp"
        self._local = self

    @property
    def local(self):
        """The mesh-less twin (self when no mesh is attached): what an entry
        point re-enters with on its rank's shard of the batch."""
        return self._local

    @property
    def nprimes(self) -> int:
        return self.basis.nprimes

    def galois_element(self, generator_exp: int) -> int:
        """5^|exp| (its inverse for a negative exp) mod 2N."""
        two_n = 2 * self.n
        g = pow(GALOIS_GENERATOR, abs(generator_exp), two_n)
        return pow(g, -1, two_n) if generator_exp < 0 else g

    def galois_element_inv(self, gal_el: int) -> int:
        return pow(gal_el, -1, 2 * self.n)

    def __repr__(self):
        return f"Module(n={self.n}, primes={self.basis.primes}, device={self.device})"


@functools.lru_cache(maxsize=None)
def _get_module(n: int, nprimes: int, prime_bits: int, device: torch.device) -> Module:
    return Module(n, nprimes, prime_bits, device)


def get_module(n: int, nprimes: int = 4, prime_bits: int = 30, device="cuda") -> Module:
    """Cached Module per (n, nprimes, prime_bits, device).  The card by
    default; without one this raises unless `device="cpu"` is passed."""
    return _get_module(n, nprimes, prime_bits, canonical_device(device))


def module_with_mesh(module: Module, mesh, batch_axis: str = "dp") -> Module:
    """A shallow copy of `module` with `mesh` (a `DeviceMesh` whose device
    type is the module's) attached: the public entry points then run their
    batch sharded over `mesh`'s `batch_axis` (parallel/auto.py).  The copy
    shares the original's device tables (nothing is uploaded again) and its
    `local` is the mesh-less original; `get_module`'s cache stays mesh-less."""
    if mesh.device_type != module.device.type:
        raise ValueError(f"a {mesh.device_type} mesh for a module on {module.device}")
    if batch_axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no axis {batch_axis!r}: {mesh.mesh_dim_names}")
    m = copy.copy(module)
    m.mesh = mesh
    m.batch_axis = batch_axis
    m._local = module.local
    return m
