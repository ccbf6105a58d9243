#!/usr/bin/env python3
"""Two NCCL ranks on one card: NCCL refuses them.

    python3 tools/nccl_one_rank_per_card.py

Starts two processes that both take card 0 and join one NCCL process group
(world size 2, a FileStore in a temporary directory), then all_reduce one
int64 tensor on the card.  Prints the torch, CUDA and NCCL versions, each
rank's exit code and the last lines of its errors, and exits 0 when both
ranks failed with NCCL's duplicate-GPU check (ncclInvalidUsage, "Duplicate
GPU detected"), 1 otherwise.  This is why `poulpy_tpu_torch.parallel` runs
one rank per card: on one card the mesh's real rank count is 1.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

_RANK = """
import sys, torch, torch.distributed as dist
rank, store = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
dist.init_process_group("nccl", store=dist.FileStore(store, 2), world_size=2, rank=rank)
x = torch.ones(4, dtype=torch.int64, device="cuda")
dist.all_reduce(x)
torch.cuda.synchronize()
print("REDUCED", x.tolist(), flush=True)
dist.destroy_process_group()
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("nccl_one_rank_per_card: no CUDA device", file=sys.stderr)
        return 1
    versions = dict(torch=torch.__version__, cuda=torch.version.cuda,
                    nccl=".".join(map(str, torch.cuda.nccl.version())),
                    card=torch.cuda.get_device_name(0), cards=torch.cuda.device_count())
    print(json.dumps(versions), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        store = str(Path(tmp) / "store")
        procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(rank), store],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for rank in range(2)]
        results = []
        try:
            for rank, p in enumerate(procs):
                try:
                    out, err = p.communicate(timeout=120)
                    results.append(dict(rank=rank, rc=p.returncode, stdout=out[-400:],
                                        duplicate_gpu="Duplicate GPU detected" in err,
                                        invalid_usage="ncclInvalidUsage" in err
                                        or "invalid usage" in err.lower(),
                                        stderr_tail=err[-1200:]))
                except subprocess.TimeoutExpired:
                    results.append(dict(rank=rank, rc=None, timed_out=True))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for r in results:
        print(json.dumps(r), flush=True)
    refused = all(r.get("rc") not in (0, None) and r.get("duplicate_gpu") for r in results)
    print(json.dumps({"two_ranks_one_card_refused": refused}), flush=True)
    return 0 if refused else 1


if __name__ == "__main__":
    sys.exit(main())
