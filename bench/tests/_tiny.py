"""Cells cut to a size the CPU runs in seconds, for the benchmark's tests."""

from __future__ import annotations

from pathlib import Path

import torch

from bench.harness.loader import load_cell

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("audio-kws-100ms", "omniglot-cl-250way", "omniglot-fsl-8way",
         "omniglot-cl-onboard")


def tiny(cell):
    """``cell`` at 3 to 6 streams of short pushes, a few 2-shot enrollments
    and 2-way bank blocks, every stream and tenant checked."""
    tr, wl = cell.traffic, cell.workload
    if "tenants" not in tr:
        tr.update(sessions=4, steps_per_push=32, clips_per_class=1)
        wl["service"].update(n_slots=4, t_chunk=32)
        n = 4
    else:
        per = min(int(tr["sessions_per_tenant"]), 2)
        tr.update(tenants=3, sessions_per_tenant=per, classes=4, shots=2,
                  glyphs_per_class=3,
                  enrolls_per_cycle=min(int(tr["enrolls_per_cycle"]), 4))
        wl["service"].update(n_slots=3 * per, max_tenants=3)
        if wl["service"].get("paged_bank"):
            wl["service"]["bank_block_ways"] = 2
        n = 3 * per
    if "check_tenants" in wl:
        wl["check_tenants"] = 3
    wl.update(check_sessions=n if wl["check_sessions"] else 0,
              warmup_cycles=1, trace_cycles=1, reference_block=max(n, 1))
    return cell


def tiny_cell(name: str, root: Path = ROOT):
    return tiny(load_cell(root, name))


def pushes(cell) -> bool:
    """Whether the cell's traffic pushes streams at all."""
    return cell.traffic.get("pushes_per_cycle", 1) > 0


def run_tiny(cell, seed: int = 2 ** 31 + 17, trace: bool = False):
    from bench.harness.driver import run_cell

    # a warm-up cycle, then a window that ends at one cycle, however slow
    # the machine
    return run_cell(cell, seed, 1e9, trace, torch.device("cpu"), 0.0,
                    max_cycles=1)
