"""Run one cell of the benchmark of ``repro_torch`` on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (see bench/harness/cli.py for what it prints).
Every build and kernel cache of the run goes to fixed directories under
``build/bench/`` in the checkout, so only a checkout's first run builds.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "bench"


def _environment() -> None:
    # the program's own switches come from the cell, not from the caller
    for key in [k for k in os.environ if k.startswith("REPRO_TORCH_")]:
        del os.environ[key]
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(CACHE / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]


if __name__ == "__main__":
    _environment()
    from bench.harness.cli import main, process_start

    sys.exit(main(sys.argv[1:], ROOT, process_start()))
