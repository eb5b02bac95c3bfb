"""The port stands alone: no file under src/repro_torch/ nor chip_smoke.py
imports jax, ml_dtypes or the JAX package (checked on the source, so a
lazy import inside a function counts too), and an entry point left on its
default device raises when there is no card instead of falling back to
the CPU."""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                "__import__", "import_module") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"chip_smoke.py", "tcn_block.py", "proto_extract.py",
            "service.py", "convert.py", "log2_matmul.py", "dilated_conv.py",
            "ops.py", "paging.py", "bankpool.py", "rehearsal.py",
            "plane.py", "faults.py", "engine.py", "store.py", "metrics.py",
            "trace.py", "device.py", "runtime.py", "synthetic.py",
            "episodic.py", "compress.py", "optim.py", "trainer.py",
            "trees.py", "layers.py", "transformer.py", "params.py",
            "lm.py", "host.py", "shapes.py", "olmo_1b.py",
            "qwen25_32b.py", "moe.py", "spec.py", "rwkv.py",
            "ssm.py", "analytic.py", "costmodel.py", "train.py"} <= names


@pytest.mark.parametrize("module", ["repro_torch.kernels.dispatch",
                                    "repro_torch.kernels",
                                    "repro_torch.configs",
                                    "repro_torch.sessions.paging",
                                    "repro_torch.sessions.bankpool",
                                    "repro_torch.sessions.rehearsal",
                                    "repro_torch.obs",
                                    "repro_torch.checkpoint.store",
                                    "repro_torch.serving",
                                    "repro_torch.data",
                                    "repro_torch.training",
                                    "repro_torch.training.episodic",
                                    "repro_torch.quant.compress",
                                    "repro_torch.models.layers",
                                    "repro_torch.models.transformer",
                                    "repro_torch.models.params",
                                    "repro_torch.models.rwkv",
                                    "repro_torch.models.ssm",
                                    "repro_torch.models",
                                    "repro_torch.sessions.lm",
                                    "repro_torch.sessions.spec",
                                    "repro_torch.sessions",
                                    "repro_torch.serving.engine",
                                    "repro_torch.utils.host",
                                    "repro_torch.convert",
                                    "repro_torch.configs.shapes",
                                    "repro_torch.launch.analytic",
                                    "repro_torch.launch.train",
                                    "repro_torch.core.costmodel"])
def test_module_imports_first(module):
    """Each of these imports in a fresh interpreter before anything else of
    the port (the configs import the models, which import dispatch; the
    session modules import the scheduler, protonet and dispatch)."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", f"import {module}"], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_default_device_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.kernels import (
        make_dilated_conv_op,
        make_log2_matmul_op,
        make_proto_extract_op,
    )
    from repro_torch.models import build_bundle, build_tcn_bundle
    from repro_torch.models.params import init_params
    from repro_torch.models.tcn import make_fused_forward
    from repro_torch.data import EpisodicSampler, GlyphClasses
    from repro_torch.sessions import PagedBankPool, grid_init
    from repro_torch.training.episodic import fsl_episode

    cfg = get_config("chameleon-tcn")
    lm = build_bundle(get_config("olmo-1b").smoke(), "cpu")
    for entry in (lambda: build_tcn_bundle(cfg),
                  lambda: build_bundle(get_config("olmo-1b")),
                  lambda: init_params(lm.param_defs, torch.Generator()),
                  lambda: make_fused_forward(cfg),
                  lambda: grid_init(cfg, 2),
                  lambda: PagedBankPool(4, 2, 8, 2),
                  lambda: fsl_episode(None, EpisodicSampler(
                      GlyphClasses(5, size=8), range(5)), 0, 5, 1),
                  make_log2_matmul_op, make_dilated_conv_op,
                  make_proto_extract_op,
                  lambda: launch_train.main(["--smoke", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
    assert build_tcn_bundle(cfg, "cpu").device.type == "cpu"
    assert lm.device.type == "cpu"
