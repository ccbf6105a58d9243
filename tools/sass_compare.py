"""Compare the SASS of every kernel of `poulpy_tpu_torch/csrc/` in two checkouts.

    python tools/sass_compare.py OTHER_ROOT [--work DIR]

Compiles each `.cu` of this checkout and of OTHER_ROOT to a cubin with the
flags of `poulpy_tpu_torch/backends/_lib.py` (nvcc, sm_90a, -O3; all
compiles at once), disassembles each with `cuobjdump -sass`, and prints one
JSON line per source: the entry functions whose SASS is the same in both
trees, those whose SASS differs, and those found in one tree only; then a
summary line.  Needs the CUDA toolkit (nvcc, cuobjdump); the cubins go to
--work (default `build/sass`, listed in .gitignore).
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH = "arch=compute_90a,code=sm_90a"


def _tool(name: str) -> str:
    found = shutil.which(name) or str(Path("/usr/local/cuda/bin") / name)
    if not Path(found).exists():
        raise SystemExit(f"sass_compare: {name} not found")
    return found


def _functions(sass: str) -> dict:
    """Entry function name → its SASS, addresses and comments stripped, the
    anonymous namespace's per-file hash (it differs between checkouts)
    folded out of names and bodies."""
    sass = re.sub(r"\d+_GLOBAL__N__[0-9a-f]{8}_\d+_\w*?_cu_[0-9a-f]{8}", "_GLOBAL__N_", sass)
    out = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name, _, body = block.partition("\n")
        lines = [re.sub(r"/\*[0-9a-f]{4,}\*/", "", ln).strip() for ln in body.splitlines()]
        out[name.strip()] = "\n".join(ln for ln in lines if ln)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--work", type=Path, default=ROOT / "build" / "sass")
    args = ap.parse_args()
    nvcc, cuobjdump = _tool("nvcc"), _tool("cuobjdump")
    trees = {"this": ROOT, "other": args.other.resolve()}
    sources = sorted({f.name for t in trees.values()
                      for f in (t / "poulpy_tpu_torch" / "csrc").glob("*.cu")})
    procs = {}
    for tag, tree in trees.items():
        (args.work / tag).mkdir(parents=True, exist_ok=True)
        for name in sources:
            src = tree / "poulpy_tpu_torch" / "csrc" / name
            if src.exists():
                procs[tag, name] = subprocess.Popen(
                    [nvcc, "-gencode", ARCH, "-std=c++17", "-O3", "-cubin", "-o",
                     str(args.work / tag / (name + ".cubin")), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for key, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"sass_compare: nvcc failed on {key}:\n{log[-2000:]}")
    totals = {"same": 0, "differ": 0, "one_tree": 0}
    for name in sources:
        funcs = {}
        for tag in trees:
            cubin = args.work / tag / (name + ".cubin")
            funcs[tag] = _functions(subprocess.run(
                [cuobjdump, "-sass", str(cubin)], capture_output=True, text=True,
                check=True).stdout) if cubin.exists() else {}
        a, b = funcs["this"], funcs["other"]
        same = sorted(k for k in a.keys() & b.keys() if a[k] == b[k])
        differ = sorted(k for k in a.keys() & b.keys() if a[k] != b[k])
        one = sorted(a.keys() ^ b.keys())
        totals["same"] += len(same)
        totals["differ"] += len(differ)
        totals["one_tree"] += len(one)
        print(json.dumps({"source": name, "same": len(same), "differ": differ,
                          "one_tree": one}), flush=True)
    print(json.dumps({"summary": totals}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
