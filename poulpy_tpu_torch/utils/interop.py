"""Carry keys and ciphertexts between the JAX package and this one.

An object crosses as its class name plus a dict of fields: arrays as numpy,
parameters (`base2k`, `k`, `dsize`, `dist`) as Python values.  The field
names are the JAX package's, so any object with one of the class names below
and those dataclass fields converts, without this module importing JAX:

    port_obj = from_fields(*to_fields(jax_obj), device="cuda")
    name, fields = to_fields(port_obj)      # numpy arrays, ready for jnp.asarray
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from poulpy_tpu_torch.core.layouts import (
    GGSWCiphertext,
    GLWECiphertext,
    GLWEPlaintext,
    GLWESecret,
)
from poulpy_tpu_torch.core.prepared import GGSWPrepared, GLWESecretPrepared

CLASSES = {
    cls.__name__: cls
    for cls in (GLWESecret, GLWESecretPrepared, GLWECiphertext, GLWEPlaintext,
                GGSWCiphertext, GGSWPrepared)
}

_ARRAY_FIELDS = ("data", "pmat")


def to_fields(obj) -> tuple[str, dict]:
    """(class name, fields) of a layout of either package, arrays as numpy."""
    name = type(obj).__name__
    if name not in CLASSES:
        raise TypeError(f"no port of {name}")
    fields = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name in _ARRAY_FIELDS:
            v = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        fields[f.name] = v
    return name, fields


def from_fields(name: str, fields: dict, device="cpu"):
    """The port's object of class `name`, its arrays on `device`."""
    cls = CLASSES[name]
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in fields:
            continue
        v = fields[f.name]
        if f.name in _ARRAY_FIELDS:
            v = torch.from_numpy(np.array(v)).to(device)  # a writable copy
        kw[f.name] = v
    return cls(**kw)
