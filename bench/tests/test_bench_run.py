"""A run without a card, the check on imports, the control and the faults:
the comparison has to come out as not correct for each."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from bench.control import control_readings
from bench.harness.check import judge
from bench.harness.cli import forbidden_modules
from bench.tests._tiny import CELLS, ROOT, pushes, run_tiny, tiny_cell


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "repro",
             "repro.core.streaming", "repro_torch", "repro_torch.sessions",
             "jaxtyping", "reproducible", "numpy"]
    assert forbidden_modules(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "repro",
        "repro.core.streaming"]


def test_run_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "audio-kws-100ms", "--seed", str(2 ** 31 + 5),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert not any(line.startswith("{") for line in r.stdout.splitlines())


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_tiny_run_is_correct(name):
    res = run_tiny(tiny_cell(name))
    assert res.correct, res.checks


@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_is_not_correct(name):
    cell = tiny_cell(name)
    nums = control_readings(cell, 2 ** 31 + 3, 2, torch.device("cpu"))
    ok, rows = judge(nums, cell.workload["checks"])
    assert not ok, rows


def _state_unchanged(orig):
    def chunk(blocks, states, x, lengths, **kw):
        kw["inplace"] = False
        return states, orig(blocks, states, x, lengths, **kw)[1]
    return chunk


def _half_batch(orig):
    def chunk(blocks, states, x, lengths, **kw):
        new, h = orig(blocks, states, x, lengths, **kw)
        h = h.clone()
        h[h.shape[0] // 2:] = h[:h.shape[0] // 2].mean(0, keepdim=True)
        return new, h
    return chunk


def _altered_logit(orig):
    def rows(x, w, b):
        out = orig(x, w, b).clone()
        out[..., -1, 0] += 1.0
        return out
    return rows


def _altered_embedding(orig):
    def head(*a):
        emb, logits = orig(*a)
        emb = emb.clone()
        emb[:, -1, 0] += 0.5
        return emb, logits
    return head


def _shots_embedded(alter):
    """A fault in the enrollment's embedder: ``alter`` the (k, V) shot
    embeddings it returns."""
    def wrap(orig):
        def make(*a, **kw):
            fwd = orig(*a, **kw)

            def forward(params, x):
                out = fwd(params, x)
                return (alter(out[0].clone()),) + tuple(out[1:])
            return forward
        return make
    return wrap


def _half_shots(e):
    e[e.shape[0] // 2:] = e[:e.shape[0] // 2].mean(0, keepdim=True)
    return e


def _altered_shot(e):
    e[-1] += 0.5
    return e


def _bank_unchanged(orig):
    def add_class(self, tenant, shot_embeddings):
        s, c = self.s_sums.clone(), self.counts.clone()
        way = orig(self, tenant, shot_embeddings)
        self.s_sums.copy_(s)
        self.counts.copy_(c)
        return way
    return add_class


PUSH_FAULTS = {
    "state_unchanged": ("repro_torch.kernels.tcn_block", "tcn_chunk_plain",
                        _state_unchanged),
    "half_batch": ("repro_torch.kernels.tcn_block", "tcn_chunk_plain",
                   _half_batch),
    "answer_altered": None,
}
# a cell that only enrolls: its step is an enrollment, its batch the shots
ENROLL_FAULTS = {
    "state_unchanged": ("repro_torch.sessions.bankpool.PagedBankPool",
                        "add_class", _bank_unchanged),
    "half_batch": ("repro_torch.sessions.service", "make_fused_forward",
                   _shots_embedded(_half_shots)),
    "answer_altered": ("repro_torch.sessions.service", "make_fused_forward",
                       _shots_embedded(_altered_shot)),
}


@pytest.mark.parametrize("fault", PUSH_FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    import importlib

    cell = tiny_cell(name)
    spec = (PUSH_FAULTS if pushes(cell) else ENROLL_FAULTS)[fault]
    if spec is None:  # the banked logits where tenants are, else the head
        spec = ("repro_torch.sessions.service", "pn_logits_rows",
                _altered_logit) if cell.traffic.get("tenants") else \
            ("repro_torch.core.streaming", "_head_steps", _altered_embedding)
    path, _, cls = spec[0].rpartition(".")
    owner = getattr(importlib.import_module(path), cls) \
        if cls[:1].isupper() else importlib.import_module(spec[0])
    monkeypatch.setattr(owner, spec[1], spec[2](getattr(owner, spec[1])))
    res = run_tiny(cell)
    assert res.failed == 0 and not res.correct, res.checks


def test_result_line_is_strict_json(capsys):
    from bench.harness.cli import emit
    from bench.harness.driver import Result

    res = Result(correct=False, attempted=1, failed=1, metrics={},
                 device={"platform": "gpu"},
                 checks=[("emb_gap", float("inf"), 1e-5)])
    assert emit(res, "card") == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1],
                      parse_constant=lambda c: pytest.fail(c))
    assert list(line)[-1] == "checks"
    assert out.err.strip().splitlines()[-1].startswith("check emb_gap inf")
