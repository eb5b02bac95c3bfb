"""The port stands alone: no file under src/repro_torch/ nor chip_smoke.py
imports jax or the JAX package (checked on the source, so a lazy import
inside a function counts too), and an entry point left on its default
device raises when there is no card instead of falling back to the CPU."""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


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
            "service.py", "convert.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_default_device_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.configs import get_config
    from repro_torch.models import build_tcn_bundle
    from repro_torch.models.tcn import make_fused_forward
    from repro_torch.sessions import grid_init

    cfg = get_config("chameleon-tcn")
    for entry in (lambda: build_tcn_bundle(cfg),
                  lambda: make_fused_forward(cfg),
                  lambda: grid_init(cfg, 2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
    assert build_tcn_bundle(cfg, "cpu").device.type == "cpu"
