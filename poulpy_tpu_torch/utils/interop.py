"""Carry keys and ciphertexts between the JAX package and this one.

An object crosses as its class name plus a dict of fields: arrays as numpy,
parameters (`base2k`, `k`, `dsize`, `dist`, …) as Python values, a nested
layout (a CKKS ciphertext's `glwe` and `meta`, an automorphism key's `key`,
a circuit-bootstrapping key's `brk`, a FheUint's `glwe`, a BDD key's `cbt`,
`ks_lwe` and `ks_glwe`, a compressed blind-rotation key's `ggsw`) as its own
(name, fields), a dict of layouts (a
tensor key's `keys`, keyed by (i, j); a circuit-bootstrapping key's `atk`,
keyed by Galois element) as a dict of (name, fields), a list of layouts (a
circuit-bootstrapping key's `tsk`, a prepared FheUint's `bits`) as a list of
them, a missing optional layout (`ks_glwe`) as None, and the seed of a
compressed layout (`core/compressed.py`) as its bytes.
The field names are the JAX package's, so any object with one of the class
names below and those dataclass fields converts, without this module
importing JAX:

    port_obj = from_fields(*to_fields(jax_obj), device="cuda")
    name, fields = to_fields(port_obj)      # numpy arrays, ready for jnp.asarray

`BootstrapKeys` crosses as its parameters and its three keys, each as
(name, fields); the module is rebuilt from the parameters on arrival.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from poulpy_tpu_torch.binfhe.bdd import BDDKey, FheUint, FheUintPrepared
from poulpy_tpu_torch.binfhe.blind_rotation import (
    BlindRotationKeyCompressed,
    BlindRotationKeyPrepared,
)
from poulpy_tpu_torch.binfhe.circuit_bootstrapping import CircuitBootstrappingKey
from poulpy_tpu_torch.binfhe.gates import BootstrapKeys, GateParams
from poulpy_tpu_torch.binfhe.lut import LookupTable
from poulpy_tpu_torch.ckks.layouts import CKKSCiphertext, CKKSMeta, CKKSPlaintext
from poulpy_tpu_torch.ckks.plaintext import (
    CKKSPlaintextCstRnx,
    CKKSPlaintextCstZnx,
    CKKSPlaintextVecRnx,
)
from poulpy_tpu_torch.core.compressed import (
    GGLWECompressed,
    GGSWCompressed,
    GLWECompressed,
    LWECompressed,
)
from poulpy_tpu_torch.core.layouts import (
    GGLWECiphertext,
    GGSWCiphertext,
    GLWECiphertext,
    GLWEPlaintext,
    GLWESecret,
    LWECiphertext,
)
from poulpy_tpu_torch.core.prepared import (
    GGLWEPrepared,
    GGSWPrepared,
    GLWEAutomorphismKeyPrepared,
    GLWESecretPrepared,
    GLWETensorKeyPrepared,
)
from poulpy_tpu_torch.hal.module import get_module

CLASSES = {
    cls.__name__: cls
    for cls in (GLWESecret, GLWESecretPrepared, GLWECiphertext, GLWEPlaintext,
                GGSWCiphertext, GGSWPrepared, GGLWECiphertext, GGLWEPrepared, LWECiphertext,
                LookupTable, BlindRotationKeyPrepared, GLWETensorKeyPrepared,
                GLWEAutomorphismKeyPrepared, CKKSMeta, CKKSCiphertext, CKKSPlaintext,
                CKKSPlaintextVecRnx, CKKSPlaintextCstRnx, CKKSPlaintextCstZnx,
                CircuitBootstrappingKey, BDDKey, FheUint, FheUintPrepared, GLWECompressed,
                GGLWECompressed, GGSWCompressed, LWECompressed, BlindRotationKeyCompressed)
}

_ARRAY_FIELDS = ("data", "pmat", "pmats", "coeffs", "body")
_KEYS = ("brk", "to_lwe", "lut")          # the keys of a BootstrapKeys


def to_fields(obj) -> tuple[str, dict]:
    """(class name, fields) of a layout of either package, arrays as numpy."""
    name = type(obj).__name__
    if name == "BootstrapKeys":
        fields = {key: to_fields(getattr(obj, key)) for key in _KEYS}
        fields["params"] = dataclasses.asdict(obj.params)
        return name, fields
    if name not in CLASSES:
        raise TypeError(f"no port of {name}")
    fields = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name in _ARRAY_FIELDS:
            v = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        elif type(v).__name__ in CLASSES:
            v = to_fields(v)
        elif isinstance(v, dict):
            v = {key: to_fields(x) for key, x in v.items()}
        elif isinstance(v, list):
            v = [to_fields(x) for x in v]
        fields[f.name] = v
    return name, fields


def _is_fields(v) -> bool:
    return isinstance(v, tuple) and len(v) == 2 and v[0] in CLASSES and isinstance(v[1], dict)


def from_fields(name: str, fields: dict, device="cuda"):
    """The port's object of class `name`, its arrays on `device`."""
    if name == "BootstrapKeys":
        params = GateParams(**fields["params"])
        module = get_module(params.n_glwe, params.nprimes, params.prime_bits, device)
        keys = {key: from_fields(*fields[key], device=module.device) for key in _KEYS}
        return BootstrapKeys(module=module, params=params, **keys)
    cls = CLASSES[name]
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in fields:
            continue
        v = fields[f.name]
        if f.name in _ARRAY_FIELDS:
            v = torch.from_numpy(np.array(v)).to(device)  # a writable copy
        elif _is_fields(v):
            v = from_fields(*v, device=device)
        elif isinstance(v, dict):
            v = {key: from_fields(*x, device=device) for key, x in v.items()}
        elif isinstance(v, list):
            v = [from_fields(*x, device=device) for x in v]
        kw[f.name] = v
    return cls(**kw)
