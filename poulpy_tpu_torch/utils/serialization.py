"""Layout serialization: twin of `poulpy_tpu/utils/serialization.py`, the same
wire format byte for byte, so that either package reads the other's blobs.

A blob is a u64 length and a JSON header {"type": class name, "meta": the
non-array fields in dataclass order}, then each array field as (u64 name
length, name, array record), then each nested layout as (u64 name length,
name, NESTED tag, u64 length, its own blob).  An array record is the MAGIC /
VERSION pair, the rank, the dims, a dtype code (int64 0, int32 1, float64
2) and the little-endian payload.  `bytes` fields (the seeds of
`core/compressed.py`) are written as {"__bytes__": hex}, None as
{"__none__": true}, and a nested layout's class under the JAX package's
qualified name (`poulpy_tpu.core.compressed.GGSWCompressed`), which is
read back through `utils/interop.py`'s table of classes: nothing imports
the JAX package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import struct as _struct

import numpy as np
import torch

from poulpy_tpu_torch.hal.ntt import canonical_device

MAGIC = 0x504C5059_54505500  # "PLPYTPU\0"
VERSION = 1
_NESTED_TAG = 0x4E45535445440000  # "NESTED\0\0": tells a nested section from an array's MAGIC
_DTYPES = {"int64": 0, "int32": 1, "float64": 2}
_CODES = {0: np.int64, 1: np.int32, 2: np.float64}
_PORT, _JAX = "poulpy_tpu_torch", "poulpy_tpu"


def _host(arr) -> np.ndarray:
    return arr.cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)


def write_array(buf: bytearray, arr) -> None:
    """Append one array record (a tensor is copied to the host first)."""
    a = _host(arr)
    buf += _struct.pack("<QQ", MAGIC, VERSION)
    buf += _struct.pack("<Q", a.ndim)
    for d in a.shape:
        buf += _struct.pack("<Q", d)
    buf += _struct.pack("<Q", _DTYPES[a.dtype.name])
    buf += a.astype(a.dtype.newbyteorder("<")).tobytes()


def read_array(view: memoryview, device="cuda") -> tuple[torch.Tensor, int]:
    """(the array record at the start of `view` as a tensor on `device`,
    bytes consumed).  The payload is copied out of `view`."""
    magic, version = _struct.unpack_from("<QQ", view, 0)
    if magic != MAGIC:
        raise ValueError("bad magic")
    if version != VERSION:
        raise ValueError(f"unsupported version {version}")
    ndim = _struct.unpack_from("<Q", view, 16)[0]
    shape = _struct.unpack_from(f"<{ndim}Q", view, 24)
    off = 24 + 8 * ndim
    dtype = np.dtype(_CODES[_struct.unpack_from("<Q", view, off)[0]])
    off += 8
    count = int(np.prod(shape)) if shape else 1
    arr = np.frombuffer(view, dtype=dtype.newbyteorder("<"), count=count, offset=off)
    arr = arr.astype(dtype).reshape(shape)          # a native-order copy
    return torch.from_numpy(arr).to(canonical_device(device)), off + arr.nbytes


def _wire_module(module: str) -> str:
    """The JAX package's module for one of the port's."""
    if module == _PORT or module.startswith(_PORT + "."):
        return _JAX + module[len(_PORT):]
    return module


def serialize_layout(obj) -> bytes:
    """The blob of a layout dataclass (tensors, parameters, nested layouts)."""
    buf = bytearray()
    meta, arrays, nested = {}, [], []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, bytes):
            meta[f.name] = {"__bytes__": v.hex()}
        elif v is None:
            meta[f.name] = {"__none__": True}
        elif isinstance(v, (bool, int, float, str)):
            meta[f.name] = v
        elif dataclasses.is_dataclass(v):
            meta[f.name] = {"__nested__": f"{_wire_module(type(v).__module__)}.{type(v).__name__}"}
            nested.append((f.name, v))
        else:
            arrays.append((f.name, v))
    header = json.dumps({"type": type(obj).__name__, "meta": meta}).encode()
    buf += _struct.pack("<Q", len(header))
    buf += header
    for name, v in arrays:
        buf += _struct.pack("<Q", len(name.encode()))
        buf += name.encode()
        write_array(buf, v)
    for name, v in nested:
        blob = serialize_layout(v)
        buf += _struct.pack("<Q", len(name.encode()))
        buf += name.encode()
        buf += _struct.pack("<QQ", _NESTED_TAG, len(blob))
        buf += blob
    return bytes(buf)


def _resolve_layout_class(name: str):
    """The port's class for a nested layout name: the JAX package's qualified
    `poulpy_tpu.<module>.<Class>`, or a bare class name (version-1 blobs)."""
    from poulpy_tpu_torch.utils.interop import CLASSES

    module, _, cls_name = name.rpartition(".")
    cls = CLASSES.get(cls_name)
    if cls is None or (module and _wire_module(cls.__module__) != module):
        raise ValueError(f"unknown nested layout class {name!r}")
    return cls


def deserialize_layout(data: bytes | memoryview, cls, device="cuda"):
    """The `cls` object of a blob, its tensors on `device`."""
    view = memoryview(data)
    mlen = _struct.unpack_from("<Q", view, 0)[0]
    hdr = json.loads(bytes(view[8:8 + mlen]))
    if hdr["type"] != cls.__name__:
        raise ValueError(f"type mismatch: {hdr['type']} != {cls.__name__}")
    off = 8 + mlen
    kwargs, nested_cls = {}, {}
    for k, v in hdr["meta"].items():
        if isinstance(v, dict) and "__bytes__" in v:
            kwargs[k] = bytes.fromhex(v["__bytes__"])
        elif isinstance(v, dict) and "__none__" in v:
            kwargs[k] = None
        elif isinstance(v, dict) and "__nested__" in v:
            nested_cls[k] = _resolve_layout_class(v["__nested__"])
        else:
            kwargs[k] = v
    while off < len(data):
        nlen = _struct.unpack_from("<Q", view, off)[0]
        off += 8
        name = bytes(view[off:off + nlen]).decode()
        off += nlen
        if name in nested_cls:
            tag, blen = _struct.unpack_from("<QQ", view, off)
            if tag != _NESTED_TAG:
                raise ValueError("corrupt nested section")
            off += 16
            kwargs[name] = deserialize_layout(view[off:off + blen], nested_cls[name], device)
            off += blen
        else:
            kwargs[name], consumed = read_array(view[off:], device)
            off += consumed
    return cls(**kwargs)


def digest_u64(arr) -> int:
    """Content fingerprint: blake2b-8 over the little-endian int64 bytes (a
    tensor is copied to the host first)."""
    data = _host(arr).astype("<i8").tobytes()
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "little")
