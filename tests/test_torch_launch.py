"""The port's launch layer and cost model against the reference, on the
CPU: ``launch/analytic.py``'s parameter and FLOP counts equal to
``repro.launch.analytic``'s for every config of the registry and every
shape of ``SHAPES``, ``core/costmodel.py``'s ASIC model and roofline
equal to ``repro.core.costmodel``'s; then the one-card launcher
(``python -m repro_torch.launch.train``) and
``examples/train_lm_torch.py``, run in process on the CPU."""

import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import costmodel as jcm  # noqa: E402
from repro.launch import analytic as ja  # noqa: E402
from repro.models import build_bundle as j_build_bundle  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.registry import REGISTRY  # noqa: E402
from repro_torch.configs.shapes import SHAPES, ShapeSpec  # noqa: E402
from repro_torch.core import costmodel as cm  # noqa: E402
from repro_torch.launch import analytic as ta  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build_bundle  # noqa: E402
from repro_torch.utils.trees import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_counts_equal_the_reference(name):
    cfg, jcfg = get_config(name), j_get_config(name)
    defs = build_bundle(cfg, "cpu").param_defs
    jdefs = j_build_bundle(jcfg).param_defs
    assert ta.param_count(defs) == ja.param_count(jdefs)
    assert ta.active_param_count(cfg, defs) == \
        ja.active_param_count(jcfg, jdefs)
    assert ta._train_mult(cfg) == ja._train_mult(jcfg)
    for shape, spec in SHAPES.items():
        got = ta.count_cell(cfg, defs, shape)
        assert got == ta.Counts(**vars(ja.count_cell(jcfg, jdefs, shape))), \
            shape
        assert ta.count_cell(cfg, defs, spec) == got


def test_count_cell_takes_a_run_shape():
    """A ShapeSpec counts a run's own (B, S): olmo-1b's train step at
    8 x 512 is 6 N tokens of model FLOPs."""
    cfg = get_config("olmo-1b")
    defs = build_bundle(cfg, "cpu").param_defs
    c = ta.count_cell(cfg, defs, ShapeSpec("run", "train", 512, 8))
    assert c.model_flops == 6.0 * c.n_params_active * 8 * 512
    assert c.model_flops == cm.model_flops(c.n_params_active, 8 * 512)
    assert 1.1e9 < c.n_params < 1.3e9 and c.n_params == c.n_params_active
    assert c.flops_global > c.model_flops


def test_costmodel_asic_and_roofline_equal_the_reference():
    for n in (4, 16):
        a, b = cm.PEArrayMode(n), jcm.PEArrayMode(n)
        assert a.macs == b.macs and a.peak_gops() == b.peak_gops()
        assert a.peak_gops(100e6) == b.peak_gops(100e6)
        for ops in (0.0, 1e6, 3.7e7):
            assert a.realtime_power_w(ops) == b.realtime_power_w(ops)
            assert a.clock_for(ops) == b.clock_for(ops)
    for macs in (1e3, 2.5e5):
        assert cm.kws_ops_per_s(macs) == jcm.kws_ops_per_s(macs)
        assert cm.kws_ops_per_s(macs, 10.0) == jcm.kws_ops_per_s(macs, 10.0)
    for args in ((1e15, 2e12, 3e9, 1), (4e18, 7e14, 0.0, 256)):
        got, want = cm.roofline(*args), jcm.roofline(*args)
        assert (got.compute_s, got.memory_s, got.collective_s,
                got.dominant, got.bound_s) == \
            (want.compute_s, want.memory_s, want.collective_s,
             want.dominant, want.bound_s)
    assert cm.model_flops(1.2e9, 4096) == jcm.model_flops(1.2e9, 4096)
    assert (cm.PEAK_FLOPS_BF16, cm.HBM_BW, cm.ICI_BW) == \
        (jcm.PEAK_FLOPS_BF16, jcm.HBM_BW, jcm.ICI_BW)
    h = cm.roofline(989e12, 3.35e12, 0.0, 1, chip="h100")
    assert h.compute_s == h.memory_s == 1.0 and h.dominant == "compute"
    with pytest.raises(KeyError):
        cm.roofline(1.0, 1.0, 0.0, 1, chip="unknown")


def test_launch_train_runs_on_the_cpu_when_asked(capsys):
    state, hist = launch_train.main(["--arch", "olmo-1b", "--smoke",
                                     "--steps", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] olmo-1b: 0.15M params on cpu" in out
    assert int(state.step) == 3 and [h["step"] for h in hist] == [0, 2]
    assert all(h["loss"] > 0 and 0 <= h["acc"] <= 1 for h in hist)
    assert "gnorm" in out


def test_launch_train_resumes_and_accumulates(tmp_path):
    argv = ["--arch", "rwkv6-1.6b", "--smoke", "--steps", "4", "--batch",
            "4", "--seq", "16", "--grad-accum", "2", "--compress-grads",
            "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    first, _ = launch_train.main(argv)
    again, hist = launch_train.main(argv)  # resumes at its last step
    assert int(again.step) == 4 and hist == []
    assert all(torch.equal(x, y) for x, y in zip(
        tree_leaves(first.params), tree_leaves(again.params)))


def test_launch_train_refuses_without_a_card(monkeypatch):
    """No fallback: the default device is the card, and without one the
    launcher raises before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--smoke", "--steps", "1"])
    with pytest.raises(ValueError, match="grad-accum"):
        launch_train.main(["--smoke", "--steps", "1", "--batch", "3",
                           "--grad-accum", "2", "--device", "cpu"])


def test_train_lm_example_resumes_exactly(capsys):
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", ROOT / "examples" / "train_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    state, hist = mod.main(["--device", "cpu", "--steps", "10", "--batch",
                            "4", "--seq", "32"])
    out = capsys.readouterr().out
    assert "[run 2] resumed at step 6" in out
    assert "equal to the uninterrupted one bit for bit: True" in out
    assert int(state.step) == 10
