"""BENCHMARK.json against the benchmark's contract, and cells found by
name: a cell added as files only runs through the loader with no edit."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from bench.harness.loader import load_cell
from bench.tests._tiny import CELLS, ROOT, run_tiny, tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_names_and_units_use_the_allowed_characters():
    b = bench()
    names = [c["name"] for c in b["configs"]] \
        + [w["name"] for w in b["workloads"]] \
        + [m["name"] for m in b["end_to_end"] + b["per_layer"]] \
        + [w["config"] for w in b["workloads"]] \
        + [w["traffic"] for w in b["workloads"]] \
        + [k for c in b["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in [w["why"] for w in b["workloads"]] \
            + [m["layer"] for m in b["per_layer"]] \
            + [c["source"] for c in b["configs"]] + b["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in b[kind]}) == len(b[kind])


def test_metrics_bounds_and_run_length_keep_to_the_contract():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= {w["name"] for w in b["workloads"]}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert 1 <= b["run_seconds"] <= 51
    # a check of the full 24 cells, each run allowed run_seconds + 60 s and
    # each cell 180 s to compile, fits in 43,200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files_by_name(name):
    cell = load_cell(ROOT, name)
    assert cell.config["reduced"] == []
    assert cell.workload["checks"]
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert (cell.metrics_dir / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e
    assert (cell.generators_dir
            / f"{cell.traffic['generator']}.py").is_file()


def _copy(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path / "bench"


def _add_cell(tmp_path, name, config, traffic, workload_like):
    data = tmp_path / "bench"
    (data / "workloads" / f"{name}.json").write_text(
        (data / "workloads" / f"{workload_like}.json").read_text())
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": name, "config": config,
                           "traffic": traffic, "chips": 1,
                           "why": "a cell made of files alone"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))


def test_a_cell_added_as_files_runs_with_no_edit(tmp_path):
    data = _copy(tmp_path)
    spec = json.loads((data / "traffic" / "glyph-fsl-8way.json").read_text())
    spec.update(enrolls_per_cycle=1, new_label_share=1.0)
    (data / "traffic" / "glyph-dummy.json").write_text(json.dumps(spec))
    _add_cell(tmp_path, "dummy-cell", "chameleon-tcn", "glyph-dummy",
              "omniglot-fsl-8way")
    cell = tiny(load_cell(tmp_path, "dummy-cell"))
    assert cell.traffic["enrolls_per_cycle"] == 1
    res = run_tiny(cell)
    assert res.correct, res.checks
    assert res.attempted == 2  # the window's push and its one enrollment


CHURN = """
from bench.generators.keyword_audio import AudioStreams


class Churn(AudioStreams):
    # more streams than slots: each cycle parks a stream and pushes the
    # others, which the service resumes
    def cycle(self, p, run):
        idle = p % self.sessions
        run.call("park", run.svc.park, run.sids[idle])
        x = self.push(p)
        live = [s for s in range(self.sessions) if s != idle]
        run.push(x[live], live)


def make(spec, seed, service):
    return Churn(spec, seed)
"""


def test_a_generator_added_as_a_file_runs_with_no_edit(tmp_path):
    data = _copy(tmp_path)
    (data / "generators" / "dummy_churn.py").write_text(CHURN)
    spec = json.loads((data / "traffic" / "kws-100ms-frames.json")
                      .read_text())
    spec["generator"] = "dummy_churn"
    (data / "traffic" / "kws-churn.json").write_text(json.dumps(spec))
    _add_cell(tmp_path, "churn-cell", "chameleon-tcn-audio", "kws-churn",
              "audio-kws-100ms")
    cell = tiny(load_cell(tmp_path, "churn-cell"))
    cell.traffic["sessions"] = 5          # 5 streams on 4 slots
    res = run_tiny(cell)
    assert res.correct, res.checks
    assert res.attempted == 2  # the window's park and its push
