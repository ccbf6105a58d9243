"""Time the butterfly kernels of this checkout and of another one, in turns.

    python tools/butterfly_ab.py OTHER_ROOT [--rounds 2]

On the card: bench.py's product (B 16384, N 2048), the gate's keyswitch with
the body (B 1024, N 1024), the CKKS rotation's keyswitch (B 256, N 2048) and
the gate's block step (B 1024, block 8), each through its wrapper, CUDA
events over 20 launches after a warm-up, on inputs made from a seed; then
the circuit bootstrap of each checkout's `chip_smoke.py` on its standard
(n_lwe 574) and block-8 (576) paths, timed as its `phase_cbt_bench` times
them: cbt/s over CBT_ITERS batches of CBT_BATCH and CBT_WIDE_ITERS of
CBT_WIDE_BATCH, with the outputs' checksum; its gate bootstrap
(`phase_gate_bench`'s GATE_ITERS chained NANDs at GATE_BATCH after a
warm-up NAND, gates/s, with the last output's checksum); and its FheUint u32 add
(`phase_bdd_bench`'s timed adds of BDD_PAIRS after a warm-up add, ms per
add, with their checksum).  Each checkout runs in a process
of its own (its own kernel build), in the order other, this, this, other
per round; one JSON line per run.  For comparing a change with its parent
on one card in one call.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r'''
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from poulpy_tpu_torch.backends import fused
from poulpy_tpu_torch.hal.module import get_module

def ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps

gen = torch.Generator(device="cuda").manual_seed(3)

def ints(lim, shape):
    return torch.randint(-lim, lim, shape, generator=gen, device="cuda", dtype=torch.int64)

def residues(m, shape):
    primes = torch.tensor(m.basis.primes, device="cuda")[:, None]
    return (ints(1 << 62, shape).abs() % primes).to(torch.int32)

m, gm = get_module(2048, 2, 28, "cuda"), get_module(1024, 2, 28, "cuda")
a, pmat = ints(2**16, (16384, 2, 3, 2048)), residues(m, (3, 2, 2, 4, 2, 2048))
ka, kpm, kb = ints(2**16, (1024, 1, 2, 1024)), residues(gm, (2, 1, 2, 3, 2, 1024)), ints(2**16, (1024, 2, 1024))
ra, rpm, rb = ints(2**16, (256, 1, 6, 2048)), residues(m, (6, 1, 2, 6, 2, 2048)), ints(2**16, (256, 6, 2048))
acc, brk = ints(2**16, (1024, 2, 2, 1024)), residues(gm, (8, 4, 2, 2, 4, 2, 1024))
amounts, pm_k = ints(3 * 1024, (1024, 8)), fused.pm_kernel_layout(brk, 2)

def cbt_rates(n_lwe, block):
    setup = cs.cbt_setup(n_lwe, block, torch.device("cuda"))
    m, key = setup["m"], setup["key"]

    def checksum(outs):
        return sum(int((o.data.abs() % 65536).sum()) for o in outs)

    checksum([cs.cbt(m, key, setup["lwes"][-1])])
    rates = {}
    for batch, lwes in ((cs.CBT_BATCH, setup["lwes"][:cs.CBT_ITERS]),
                        (cs.CBT_WIDE_BATCH, setup["wide"])):
        if batch == cs.CBT_WIDE_BATCH:
            checksum([cs.cbt(m, key, lwes[0])])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = checksum([cs.cbt(m, key, lwe) for lwe in lwes])
        dt = time.perf_counter() - t0
        rates[f"b{batch}"] = dict(cbt_per_s=batch * len(lwes) / dt, checksum=value)
    return rates

def gate_rate():
    from poulpy_tpu_torch.binfhe import gates

    params = gates.GateParams(n_lwe=cs.GATE_N_LWE, block_size=cs.GATE_BLOCK)
    keys, _, _, _, c1, c2 = cs.gate_setup(params, cs.GATE_BATCH, torch.device("cuda"))
    out = gates.gate_nand(keys, c1, c2)
    out.data.sum().item()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(cs.GATE_ITERS):
        out = gates.gate_nand(keys, out, c2)
    value = int((out.data.abs() % 65536).sum())
    return dict(gates_per_s=cs.GATE_BATCH * cs.GATE_ITERS / (time.perf_counter() - t0),
                checksum=value)

def u32_add():
    from poulpy_tpu_torch.binfhe.bdd import fheuint_op, fheuint_prepare

    setup = cs.bdd_setup(torch.device("cuda"))
    m = setup["m"]
    prepared = [fheuint_prepare(m, ct, setup["key"]) for ct in setup["cts"]]

    def add(a, b):
        return fheuint_op(m, "add", prepared[a], prepared[b], cs.BDD_BASE2K, cs.BDD_K_CT)

    add(0, 1).data.sum().item()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [add(a, b) for a, b in cs.BDD_PAIRS]
    value = sum(int((o.data.abs() % 65536).sum()) for o in outs)
    return dict(ms_per_add=(time.perf_counter() - t0) / len(cs.BDD_PAIRS) * 1e3, checksum=value)

print(json.dumps({
    "checkout": sys.argv[2],
    "product@bench": ms(lambda: fused.fused_glwe_product(m, a, pmat, 3, 17, 17)),
    "small@gate_keyswitch": ms(lambda: fused.fused_glwe_product(gm, ka, kpm, 2, 17, 17, small=kb)),
    "small@ckks_rotate": ms(lambda: fused.fused_glwe_product(m, ra, rpm, 6, 17, 17, small=rb)),
    "block_step@gate": ms(lambda: fused.fused_br_block_step(gm, acc, brk, amounts, 2, 17, pm_k)),
    "gate": gate_rate(),
    "cbt": cbt_rates(cs.CBT_N_LWE, 1),
    "cbt_block8": cbt_rates(cs.CBT_BLOCK8_N_LWE, cs.CBT_BLOCK),
    "u32_add": u32_add(),
}), flush=True)
'''


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    trees = {"this": ROOT, "other": args.other.resolve()}
    for _ in range(args.rounds):
        for tag in ("other", "this", "this", "other"):
            run = subprocess.run([sys.executable, "-c", CHILD, str(trees[tag]), tag],
                                 capture_output=True, text=True)
            if run.returncode:
                raise SystemExit(f"butterfly_ab: the {tag} checkout failed:\n{run.stderr[-2000:]}")
            print(run.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
