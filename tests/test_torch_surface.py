"""The port's public surface against the reference's, read from the source
through ``ast`` (no module of either package is imported for it):

  * every top-level public name a reference module binds (``def``,
    ``class``, assignment, or a name in its ``__all__``) is bound in the
    module's twin under src/repro_torch/ (by any binding, an import
    included), or stands in ``EXCEPTIONS`` with its reason;
  * every exception is still needed (the twin lacks the name);
  * no reference file is without a twin (the last two, the mesh dry-run
    ``launch/dryrun.py`` and the collective accounting ``utils/hlo.py``,
    came with the slice that shards the LM).

Then the names this surface brought in, against the reference's on the
CPU: the tree helpers, ``bank_store``/``bank_set_store``, and
``input_specs``/``make_cache_specs`` (shapes and dtype names on the meta
device) for every config of ``ASSIGNED`` and the three chameleon presets
at every shape of ``SHAPES``."""

import ast
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

PALLAS = "a Pallas body; the port's counterpart has another name"
REGISTRY = ("the reference's backend registry; the port resolves backends "
            "with dispatch.resolve / require_device")

# (reference module, name): reason.  Two groups only.
EXCEPTIONS = {
    # Pallas bodies with a counterpart under another name
    ("kernels/tcn_block.py", "tcn_block_pallas"):
        PALLAS + ": kernels/tcn_block.tcn_block (csrc/tcn_block.cu)",
    ("kernels/dilated_conv.py", "dilated_causal_conv"):
        PALLAS + ": kernels/ops.make_dilated_conv_op",
    # the reference's backend registry
    ("kernels/dispatch.py", "Resolved"): REGISTRY,
    ("kernels/dispatch.py", "register"): REGISTRY,
    ("kernels/dispatch.py", "build"): REGISTRY,
    ("kernels/dispatch.py", "registered_ops"): REGISTRY,
}
LEFT_OUT: set = set()


def _bound(path: Path, *, imports: bool) -> set:
    """Top-level names ``path`` binds (through if/try/with blocks too):
    defs, classes, assignments and ``__all__``; with ``imports``, the
    names its imports bind as well."""
    names = set()

    def visit(body):
        for n in body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                names.add(n.name)
            elif isinstance(n, (ast.Assign, ast.AnnAssign)):
                for t in (n.targets if isinstance(n, ast.Assign)
                          else [n.target]):
                    names.update(e.id for e in ast.walk(t)
                                 if isinstance(e, ast.Name))
                    if isinstance(t, ast.Name) and t.id == "__all__":
                        names.update(ast.literal_eval(n.value))
            elif imports and isinstance(n, (ast.Import, ast.ImportFrom)):
                names.update((a.asname or a.name).split(".")[0]
                             for a in n.names)
            elif isinstance(n, (ast.If, ast.Try, ast.With)):
                for part in ("body", "orelse", "finalbody"):
                    visit(getattr(n, part, []))
                for h in getattr(n, "handlers", []):
                    visit(h.body)

    visit(ast.parse(path.read_text(), filename=str(path)).body)
    return names


REF_FILES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))
TWINNED = [f for f in REF_FILES if (PORT / f).exists()]


def _missing(rel: str) -> set:
    want = {n for n in _bound(REF / rel, imports=False)
            if not n.startswith("_")}
    return want - _bound(PORT / rel, imports=True)


@pytest.mark.parametrize("rel", TWINNED)
def test_reference_names_are_bound_in_the_twin(rel):
    missing = {n for n in _missing(rel) if (rel, n) not in EXCEPTIONS}
    assert not missing, f"src/repro_torch/{rel} lacks {sorted(missing)}"


def test_every_exception_is_needed():
    for (rel, name), reason in EXCEPTIONS.items():
        assert reason.startswith((PALLAS, REGISTRY)), reason
        assert name in _missing(rel), f"{rel}: {name} is bound in the twin"


def test_left_out_files_are_the_mesh_and_hlo_ones():
    """No reference file is left out: every one has its twin."""
    assert set(REF_FILES) - set(TWINNED) == LEFT_OUT == set()


# (reference module, record class, field): reason.  A record is a
# dataclass or a NamedTuple; its twin keeps its fields but these.
FIELD_DEPARTURES = {
    ("models/build.py", "Bundle", "device"):
        "the port's only: the torch device the bundle's tensors live on",
    ("training/trainer.py", "TrainConfig", "dp_axis"):
        "the reference's only: declared and never read by its trainer; "
        "the port keeps no option that nothing reads",
}


def _records(path: Path) -> dict:
    """{class: [field, ...]} of the dataclasses and NamedTuples that
    ``path`` defines at top level."""
    out = {}
    for n in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(n, ast.ClassDef) and (
                any("dataclass" in ast.unparse(d) for d in n.decorator_list)
                or any(ast.unparse(b) == "NamedTuple" for b in n.bases)):
            out[n.name] = [a.target.id for a in n.body
                           if isinstance(a, ast.AnnAssign)
                           and isinstance(a.target, ast.Name)]
    return out


def _field_gaps() -> set:
    """(module, class, field) of every field in only one of a record and
    its twin (both defined in the twinned modules)."""
    gaps = set()
    for rel in TWINNED:
        ref, port = _records(REF / rel), _records(PORT / rel)
        for cls in set(ref) & set(port):
            gaps |= {(rel, cls, f) for f in set(ref[cls]) ^ set(port[cls])}
    return gaps


def test_records_keep_the_reference_fields():
    """Every dataclass and NamedTuple of a reference module has the same
    fields in its twin but the named departures, and each departure is
    still one (the order may differ: both packages build records by
    keyword)."""
    gaps = _field_gaps()
    assert gaps == set(FIELD_DEPARTURES), gaps ^ set(FIELD_DEPARTURES)


# ---------------------------------------------------------------------------
# the new names against the reference's
# ---------------------------------------------------------------------------

class _Pair(NamedTuple):
    a: object
    b: object


def _nested(leaf):
    """One nested tree: dicts (unsorted keys), a list, a tuple, a
    NamedTuple and a None subtree."""
    rng = np.random.default_rng(0)
    arr = lambda *s, dt=np.float32: leaf(rng.normal(size=s).astype(dt))
    return {"z": {"y": arr(2, 3), "x": [arr(4), (arr(1, dt=np.int32),)]},
            "a": _Pair(arr(3, dt=np.float16), None),
            "m": {"w": arr(2, 2, 2)}}


def test_tree_helpers_match_reference():
    import jax.numpy as jnp
    from repro.utils import trees as jt
    from repro_torch import utils as tu

    ref = _nested(jnp.asarray)
    for leaf in (torch.from_numpy, np.asarray):
        tree = _nested(leaf)
        assert tu.tree_size(tree) == jt.tree_size(ref) == 6 + 4 + 1 + 3 + 8
        assert tu.tree_bytes(tree) == jt.tree_bytes(ref) == \
            4 * (6 + 4 + 8) + 4 + 2 * 3
        assert tu.map_with_path(lambda p, x: p, tree) == \
            jt.map_with_path(lambda p, x: p, ref)
        zeros = tu.tree_zeros_like(tree)
        assert tu.map_with_path(lambda p, x: (tuple(x.shape), str(
            x.dtype).replace("torch.", ""), float(x.sum())), zeros) == \
            jt.map_with_path(lambda p, x: (tuple(x.shape), str(x.dtype),
                                           float(x.sum())),
                             jt.tree_zeros_like(ref))
    d = {"b": {"c": 1, "a": {"x": 2}}, "a": 3, 7: {"k": 4}}
    assert list(tu.flatten_dict(d).items()) == \
        list(jt.flatten_dict(d).items())
    flat = tu.flatten_dict(d)
    assert tu.unflatten_dict(flat) == jt.unflatten_dict(flat) == \
        {"b": {"c": 1, "a": {"x": 2}}, "a": 3, "7": {"k": 4}}


def test_bank_store_round_trips_and_matches_reference():
    import jax.numpy as jnp
    from repro.sessions import tenancy as jten
    from repro_torch.sessions import (
        TenantBank,
        bank_set_store,
        bank_store,
    )

    rng = np.random.default_rng(1)
    arrs = (rng.normal(size=(3, 4, 5)).astype(np.float32),
            rng.integers(1, 4, size=(3, 4)).astype(np.float32),
            np.array([2, 4, 1], np.int32))
    bank = TenantBank(*(torch.from_numpy(a.copy()) for a in arrs))
    jbank = jten.TenantBank(*(jnp.asarray(a) for a in arrs))

    store = bank_store(bank, 1)
    for got, want in zip(store, jten.bank_store(jbank, 1)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(store.n_ways) == 4 and store.s_sums.shape == (4, 5)

    new = bank_set_store(bank, 2, store)
    for got, want in zip(new, jten.bank_set_store(jbank, 2,
                                                  jten.bank_store(jbank, 1))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for leaf, a in zip(bank, arrs):  # the input bank is unchanged
        np.testing.assert_array_equal(leaf.numpy(), a)
    for got, want in zip(bank_store(new, 2), store):  # the row round-trips
        assert torch.equal(got, want)
    for got, want in zip(bank_store(new, 0), bank_store(bank, 0)):
        assert torch.equal(got, want)


def _spec_cases():
    from repro_torch.configs import ASSIGNED
    from repro_torch.configs.shapes import SHAPES

    return [(c.name, s) for c in ASSIGNED for s in SHAPES] + [
        (n, s) for n in ("chameleon-tcn", "chameleon-tcn-audio",
                         "chameleon-tcn-kws") for s in SHAPES]


def test_spec_cases_cover_the_reference_configs():
    from repro.configs import ASSIGNED
    from repro.configs.shapes import SHAPES

    assert [c.name for c in ASSIGNED] == list(dict.fromkeys(
        n for n, _ in _spec_cases()))[:len(ASSIGNED)]
    assert len(_spec_cases()) == (len(ASSIGNED) + 3) * len(SHAPES) == 52


@pytest.mark.parametrize("name,shape", _spec_cases())
def test_input_and_cache_specs_match_reference(name, shape):
    import jax
    from repro.configs import get_config as j_get_config
    from repro.configs.shapes import SHAPES
    from repro.models import input_specs as j_input_specs
    from repro.models.build import make_cache_specs as j_cache_specs
    from repro_torch.configs import get_config
    from repro_torch.models import build_bundle, input_specs
    from repro_torch.models.build import make_cache_specs
    from repro_torch.utils.trees import tree_leaves

    dtype = lambda t: str(t.dtype).replace("torch.", "")
    cfg, jcfg = get_config(name), j_get_config(name)
    got, want = input_specs(cfg, shape), j_input_specs(jcfg, shape)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].device.type == "meta"
        assert (tuple(got[k].shape), dtype(got[k])) == \
            (tuple(want[k].shape), str(want[k].dtype)), k
    s = SHAPES[shape]
    got = tree_leaves(make_cache_specs(cfg, s.global_batch, s.seq_len))
    want = jax.tree.leaves(j_cache_specs(jcfg, s.global_batch, s.seq_len))
    assert [(tuple(x.shape), dtype(x)) for x in got] == \
        [(tuple(x.shape), str(x.dtype)) for x in want]
    assert all(x.device.type == "meta" for x in got)
    assert {k: (v.shape, v.dtype) for k, v in build_bundle(
        cfg, "cpu").input_specs(shape).items()} == \
        {k: (v.shape, v.dtype) for k, v in input_specs(cfg, shape).items()}
