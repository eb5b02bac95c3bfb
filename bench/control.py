"""The control of a cell's comparison: the reference computed in TF32 put in
the program's place, judged against the reference in fp32 exactly as a run
judges the program.  It must come out as not correct.

    python3 bench/control.py --workload <cell> --seeds 11,12,13 --cycles 60

runs it on the card at the cell's own size (its streams, its sampled
streams and tenants, its enrollments, ``--cycles`` cycles of its traffic,
recorded as a run records them) and prints one JSON line a seed with every
number the comparison gives, beside the cell's limits.  It runs no code of
the program.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_readings(cell, seed: int, cycles: int, device) -> dict:
    """Every comparison number of the TF32 reference against the fp32 one
    over ``cycles`` cycles of the cell's traffic from ``seed``."""
    from bench.harness import check
    from bench.harness.loader import make_generator
    from bench.harness.model import make_weights
    from bench.reference import tcn as ref

    sizes, wl = cell.config, cell.workload
    gen = make_generator(cell, seed)
    rec = check.Recording(gen, wl, seed, sizes["embed_dim"])
    gen.setup(rec)
    for p in range(cycles):
        gen.cycle(p, rec)
    raw, bn = make_weights(sizes, seed, device)
    served = ref.prepare(raw, bn, len(sizes["tcn_channels"]),
                         quantize=sizes["quantize"])
    kw = dict(quantize=sizes["quantize"], device=device,
              block=int(wl["reference_block"]))
    want = check.reference_outputs(rec.inp, served, sizes, precision="fp32",
                                   **kw)
    ctrl = check.reference_outputs(rec.inp, served, sizes, precision="tf32",
                                   **kw)
    return check.compare(ctrl, want, rec.inp.max_ways,
                         sizes["act_scale"] if sizes["quantize"] else None)


def main(argv) -> int:
    import torch

    from bench.harness.check import judge
    from bench.harness.loader import load_cell

    ap = argparse.ArgumentParser(prog="bench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--cycles", type=int, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench/control.py: needs a CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        nums = control_readings(cell, seed, args.cycles,
                                torch.device("cuda", 0))
        ok, _ = judge(nums, cell.workload["checks"])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "cycles": args.cycles, "correct": ok,
                          "seconds": time.perf_counter() - t0,
                          "numbers": nums,
                          "limits": cell.workload["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT)]
    sys.exit(main(sys.argv[1:]))
