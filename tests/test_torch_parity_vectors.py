"""poulpy_tpu_torch.utils.reference_io: the Rust reference's VecZnx wire format
(docs/parity.md), against poulpy_tpu.utils.reference_io.

The three wire tests of tests/test_parity_vectors.py on the port's reader
and writer, the two packages' records byte for byte, and, with a dump
directory in `POULPY_PARITY_VECTORS`, every case run through the port's
public API on the CPU and compared bit for bit (skipped without one, as the
JAX package's test is).
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from poulpy_tpu.utils import reference_io as jio
from poulpy_tpu_torch.utils.reference_io import load_vec_znx, read_vec_znx, write_vec_znx

VEC_DIR = os.environ.get("POULPY_PARITY_VECTORS")


def test_vecznx_wire_roundtrip():
    rng = np.random.default_rng(3)
    arr = rng.integers(-(2**40), 2**40, size=(2, 3, 16), dtype=np.int64)
    blob = write_vec_znx(arr)
    back, end = read_vec_znx(blob)
    assert end == len(blob)
    assert np.array_equal(back, arr)


def test_vecznx_wire_layout_is_limb_major_column_minor():
    """Limb j of column i starts at scalar offset N·(j·cols + i)."""
    n, cols, size = 4, 2, 3
    arr = np.arange(cols * size * n, dtype=np.int64).reshape(cols, size, n)
    blob = write_vec_znx(arr)
    hdr = np.frombuffer(blob[:40], dtype="<u8")
    assert list(hdr) == [n, cols, size, size, n * cols * size * 8]
    flat = np.frombuffer(blob[40:], dtype="<i8")
    for j in range(size):
        for i in range(cols):
            assert np.array_equal(flat[n * (j * cols + i): n * (j * cols + i + 1)], arr[i, j])


def test_vecznx_wire_rejects_inconsistent_header():
    blob = bytearray(write_vec_znx(np.zeros((1, 1, 4), dtype=np.int64)))
    blob[32:40] = (999).to_bytes(8, "little")   # corrupt len field
    with pytest.raises(ValueError, match="inconsistent"):
        read_vec_znx(bytes(blob))


@pytest.mark.parametrize("shape", [(1, 1, 4), (2, 3, 16), (3, 5, 64)])
def test_vecznx_records_equal_the_jax_package_s(shape, tmp_path):
    """Equal bytes, each package reads the other's record (two in one buffer,
    at an offset), and a file with trailing bytes is refused by both."""
    arr = np.random.default_rng(sum(shape)).integers(-(2**62), 2**62, size=shape,
                                                     dtype=np.int64)
    blob = write_vec_znx(arr)
    assert blob == jio.write_vec_znx(arr)
    two = blob + jio.write_vec_znx(arr[::-1].copy())
    back, end = read_vec_znx(two, len(blob))
    want, want_end = jio.read_vec_znx(two, len(blob))
    assert end == want_end == len(two) and np.array_equal(back, want)
    path = tmp_path / "rec.vecznx"
    path.write_bytes(blob)
    assert np.array_equal(load_vec_znx(path), jio.load_vec_znx(path))
    path.write_bytes(blob + b"\0")
    for load in (load_vec_znx, jio.load_vec_znx):
        with pytest.raises(ValueError, match="trailing bytes"):
            load(path)


def _cases():
    if not VEC_DIR:
        return []
    return sorted(p for p in Path(VEC_DIR).iterdir() if p.is_dir())


@pytest.mark.skipif(not VEC_DIR, reason="POULPY_PARITY_VECTORS not set")
@pytest.mark.parametrize("case", _cases(), ids=lambda p: p.name)
def test_reference_vector_case(case):
    """One dump case (docs/parity.md) through the port on the CPU."""
    from poulpy_tpu_torch.core.automorphism import glwe_automorphism
    from poulpy_tpu_torch.core.external_product import glwe_external_product
    from poulpy_tpu_torch.core.keyswitching import glwe_keyswitch
    from poulpy_tpu_torch.core.layouts import GLWECiphertext
    from poulpy_tpu_torch.core.prepared import (
        GGLWEPrepared,
        GGSWPrepared,
        GLWEAutomorphismKeyPrepared,
    )
    from poulpy_tpu_torch.hal import dft
    from poulpy_tpu_torch.hal.module import get_module

    params = json.loads((case / "params.json").read_text())
    op = params["op"]
    m = get_module(params["n"], params.get("nprimes", 4), device="cpu")
    base2k = params["base2k"]

    if op == "big_normalize":
        big = torch.from_numpy(load_vec_znx(case / "in.vecznx"))
        want = load_vec_znx(case / "out.vecznx")
        have = dft.big_normalize(m, params["res_size"], params["res_base2k"], big,
                                 params["a_base2k"], res_offset=params.get("offset", 0))
        assert np.array_equal(have.numpy(), want)
        return

    ct_arr = load_vec_znx(case / "in.vecznx")
    want = load_vec_znx(case / "out.vecznx")
    kfiles = sorted(case.glob("key_r*_c*.vecznx"))
    rows = 1 + max(int(f.name.split("_r")[1].split("_")[0]) for f in kfiles)
    cis = 1 + max(int(f.stem.split("_c")[1]) for f in kfiles)
    mat = torch.from_numpy(np.stack([
        np.stack([load_vec_znx(case / f"key_r{i}_c{j}.vecznx") for j in range(cis)], axis=0)
        for i in range(rows)], axis=0))                      # [rows, ci, co, size, N]
    pmat = dft.vmp_prepare(m, mat)
    ct = GLWECiphertext(data=torch.from_numpy(ct_arr), base2k=base2k,
                        k=ct_arr.shape[-2] * base2k)
    k_key = mat.shape[-2] * base2k
    dsize = params.get("dsize", 1)

    if op == "keyswitch":
        have = glwe_keyswitch(m, ct, GGLWEPrepared(pmat=pmat, base2k=base2k, k=k_key,
                                                   dsize=dsize)).data
    elif op == "external_product":
        have = glwe_external_product(m, ct, GGSWPrepared(pmat=pmat, base2k=base2k, k=k_key,
                                                         dsize=dsize)).data
    elif op == "automorphism":
        key = GLWEAutomorphismKeyPrepared(
            key=GGLWEPrepared(pmat=pmat, base2k=base2k, k=k_key, dsize=dsize), p=params["p"])
        have = glwe_automorphism(m, ct, key).data
    else:
        pytest.fail(f"unknown case op {op!r}")
    assert np.array_equal(have.numpy(), want)
