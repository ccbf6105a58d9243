"""Reader / writer of the Rust reference's `VecZnx` wire format: twin of
`poulpy_tpu/utils/reference_io.py` (numpy only).

A record is five little-endian u64 header fields (n, cols, size, max_size,
byte_len), then the i64 coefficients in limb-major, column-minor order:
limb j of column i starts at scalar offset N·(j·cols + i).  Arrays here are
`[cols, size, N]` int64.  docs/parity.md gives the dump directory contract
that `tests/test_torch_parity_vectors.py` reads.
"""

from __future__ import annotations

import struct as _struct

import numpy as np

__all__ = ["read_vec_znx", "write_vec_znx", "load_vec_znx"]


def read_vec_znx(buf: bytes, offset: int = 0):
    """(array `[cols, size, n]` int64, end offset) of the record at `offset`;
    `ValueError` unless n·cols·size·8 equals the header's byte length."""
    n, cols, size, _max_size, blen = _struct.unpack_from("<QQQQQ", buf, offset)
    if n * cols * size * 8 != blen:
        raise ValueError(f"VecZnx metadata inconsistent: n={n} cols={cols} size={size} "
                         f"-> {n * cols * size * 8} != len={blen}")
    off = offset + 40
    flat = np.frombuffer(buf, dtype="<i8", count=n * cols * size, offset=off)
    arr = flat.reshape(size, cols, n).transpose(1, 0, 2)
    return np.ascontiguousarray(arr.astype(np.int64)), off + blen


def write_vec_znx(arr) -> bytes:
    """The record of a `[cols, size, n]` int64 array (max_size = size)."""
    arr = np.asarray(arr, dtype=np.int64)
    assert arr.ndim == 3, arr.shape
    cols, size, n = arr.shape
    head = _struct.pack("<QQQQQ", n, cols, size, size, n * cols * size * 8)
    return head + arr.transpose(1, 0, 2).astype("<i8").tobytes()


def load_vec_znx(path):
    """The array of a file that holds exactly one record."""
    with open(path, "rb") as f:
        buf = f.read()
    arr, end = read_vec_znx(buf)
    if end != len(buf):
        raise ValueError(f"{path}: trailing bytes ({len(buf) - end})")
    return arr
