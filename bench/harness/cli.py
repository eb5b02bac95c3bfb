"""``bench/run.py``'s command line: one run of one cell on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit.
The same numbers are the last lines of standard error.  Exits with 2 and
prints no result where there is no card, too few cards, or where the
process has loaded JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

# whole top-level module names the run may not load (the JAX package is
# ``repro``; the program, ``repro_torch``, only begins with that name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names) -> list[str]:
    """The names among ``names`` whose top-level name is forbidden."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def process_start() -> float:
    """The time.perf_counter() reading at which this process started."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - ticks
                                      / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv: list[str], root: Path, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench.harness.driver import run_cell
    from bench.harness.loader import load_cell

    cell = load_cell(root, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"bench: needs {cell.chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; no result", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t_start)
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"bench: the run loaded {bad}; no result", file=sys.stderr)
        return 2
    return emit(res, card_line())


def _finite(v: float) -> float:
    """A number strict JSON can carry: inf and nan (outputs missing or not
    numbers) read as the largest float."""
    return v if v == v and abs(v) != float("inf") else sys.float_info.max


def emit(res, card: str) -> int:
    """Standard error's notes and checks, then the result line."""
    err = sys.stderr
    print(f"card: {card}", file=err)
    for line in res.notes:
        print(line, file=err)
    for name, value, limit in res.checks:
        print(f"check {name} {value!r} limit {limit!r}", file=err)
    line = {"correct": res.correct, "attempted": res.attempted,
            "failed": res.failed, "metrics": res.metrics,
            "device": res.device}
    if res.breakdown is not None:
        line["breakdown"] = res.breakdown
    line["checks"] = {n: {"value": _finite(v), "limit": lim}
                      for n, v, lim in res.checks}
    err.flush()
    print(json.dumps(line), flush=True)
    return 0
