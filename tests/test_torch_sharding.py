"""The port's sharding specs against the reference's, on fake meshes (no
process group, no spawn):

  * ``pspec``/``pspec_sized``/``param_pspecs`` and ``DEFAULT_RULES``, and
    ``param_pspecs`` over every ``ASSIGNED`` config's ``param_defs`` plus
    ``chameleon-tcn``'s, on the reference's test meshes
    ``{"data": 16, "model": 16}``, ``{"pod": 2, "data": 16, "model": 16}``
    and ``{"data": 2, "model": 2}`` (the ``FakeMesh`` idiom of
    tests/test_sharding.py) and without a mesh;
  * ``cache_pspecs`` and ``batch_pspecs`` over every LM family's cache and
    input specs at every shape of ``SHAPES``;
  * ``grid_pspecs``, ``bank_pspecs`` and ``column_pspecs``;
  * the spec-to-placements function, the SPMD block arithmetic
    (``sharding/spmd.py``) on a fake device mesh, ``named``,
    ``train_state_pspecs`` and the ambient ``constrain``.

Specs compare entry for entry: the port's ``P`` is a tuple, and the
reference's ``PartitionSpec`` equals a tuple of the same entries."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "2x2": {"data": 2, "model": 2},
}


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


class FakeDeviceMesh:
    """The DeviceMesh surface sharding/spmd.py reads, for one rank."""

    def __init__(self, shape: dict, rank: int):
        self.mesh_dim_names = tuple(shape)
        self.mesh = torch.arange(int(np.prod(list(shape.values())))).reshape(
            tuple(shape.values()))
        self._coords = [int(c[0]) for c in torch.nonzero(self.mesh == rank)
                        .T]

    def get_local_rank(self, name):
        return self._coords[self.mesh_dim_names.index(name)]

    def size(self, mesh_dim=None):
        return self.mesh.numel() if mesh_dim is None \
            else self.mesh.shape[mesh_dim]


def _spec_leaves(tree, path=""):
    """{path: spec} of a spec tree of either package (a spec is a leaf)."""
    from jax.sharding import PartitionSpec

    from repro_torch.sharding.rules import P

    if isinstance(tree, (P, PartitionSpec)):
        return {path: tuple(tree)}
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_spec_leaves(tree[k], f"{path}/{k}"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k, v in zip(tree._fields, tree):
            out.update(_spec_leaves(v, f"{path}.{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_spec_leaves(v, f"{path}[{i}]"))
        return out
    raise TypeError(f"{path}: {type(tree)}")


def _configs():
    from repro_torch.configs import ASSIGNED

    return [c.name for c in ASSIGNED]


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

def test_rules_table_is_the_reference_table():
    from repro.sharding.rules import DEFAULT_RULES as J_RULES

    from repro_torch.sharding import DEFAULT_RULES

    assert list(DEFAULT_RULES.items()) == list(J_RULES.items())
    assert DEFAULT_RULES["embed"] == "data"
    assert DEFAULT_RULES["heads"] == "model"


def test_pspec_mapping_and_spec_type():
    from jax.sharding import PartitionSpec as JP

    from repro_torch.sharding.rules import P, pspec

    rules = {"vocab": "model", "embed": "data", "heads": "model"}
    assert pspec(("vocab", "embed"), rules) == P("model", "data")
    assert pspec(("vocab", "embed"), rules) == JP("model", "data")
    assert pspec(("embed", None), rules) == P("data") == JP("data")
    assert pspec((None, None), rules) == P() == JP()
    assert P("model", ("pod", "data")) == JP("model", ("pod", "data"))
    assert P("a") != P("a", "b")


def test_pspec_sized_drops_indivisible():
    from repro_torch.sharding.rules import P, pspec_sized

    mesh = FakeMesh({"data": 16, "model": 16})
    rules = {"vocab": "model", "embed": "data"}
    assert pspec_sized(("vocab", "embed"), rules, (256206, 1024), mesh) == \
        P(None, "data")
    assert pspec_sized(("vocab", "embed"), rules, (256000, 1024), mesh) == \
        P("model", "data")


def test_param_pspecs_tree():
    from repro_torch.sharding import ParamDef, param_pspecs
    from repro_torch.sharding.rules import P

    defs = {"e": ParamDef((100, 32), ("vocab", "embed")),
            "n": {"w": ParamDef((32,), ("embed",))}}
    specs = param_pspecs(defs, {"vocab": "model", "embed": None})
    assert specs["e"] == P("model") and specs["n"]["w"] == P()


@pytest.mark.parametrize("mesh", [None, *MESHES])
def test_resolve_rules_matches_reference(mesh):
    from repro.sharding.rules import DEFAULT_RULES as J_RULES
    from repro.sharding.rules import resolve_rules as j_resolve

    from repro_torch.sharding import DEFAULT_RULES, resolve_rules

    m = FakeMesh(MESHES[mesh] if mesh else {"data": 1, "model": 1})
    assert resolve_rules(DEFAULT_RULES, m) == j_resolve(J_RULES, m)


def _param_defs(name):
    """(port defs, reference defs) of a config: the LM bundle's, or the
    TCN's for a chameleon preset."""
    from repro.configs import get_config as j_get_config
    from repro.models import build_bundle as j_build_bundle
    from repro.models.tcn import tcn_param_defs as j_tcn_defs

    from repro_torch.configs import get_config
    from repro_torch.models import build_bundle
    from repro_torch.models.tcn import tcn_param_defs

    if name.startswith("chameleon"):
        return tcn_param_defs(get_config(name)), j_tcn_defs(j_get_config(name))
    return (build_bundle(get_config(name), "cpu").param_defs,
            j_build_bundle(j_get_config(name)).param_defs)


@pytest.mark.parametrize("mesh", [None, *MESHES])
@pytest.mark.parametrize("name", _configs() + ["chameleon-tcn"])
def test_param_pspecs_match_reference(name, mesh):
    from repro.sharding.rules import DEFAULT_RULES as J_RULES
    from repro.sharding.rules import param_pspecs as j_param_pspecs
    from repro.sharding.rules import resolve_rules as j_resolve

    from repro_torch.sharding import DEFAULT_RULES, param_pspecs, resolve_rules

    defs, jdefs = _param_defs(name)
    m = FakeMesh(MESHES[mesh]) if mesh else None
    rules = resolve_rules(DEFAULT_RULES, m) if m else DEFAULT_RULES
    jrules = j_resolve(J_RULES, m) if m else J_RULES
    got = _spec_leaves(param_pspecs(defs, rules, m))
    want = _spec_leaves(j_param_pspecs(jdefs, jrules, m))
    assert got == want
    assert len(got) > 0


def test_tcn_param_defs_match_reference():
    from repro.configs import get_config as j_get_config
    from repro.models.tcn import tcn_param_defs as j_tcn_defs

    from repro_torch.configs import get_config
    from repro_torch.models.tcn import tcn_param_defs
    from repro_torch.utils.trees import tree_leaves

    import jax

    for name in ("chameleon-tcn", "chameleon-tcn-audio", "chameleon-tcn-kws"):
        got = [(d.shape, d.axes, d.init) for d in tree_leaves(
            tcn_param_defs(get_config(name)))]
        want = [(d.shape, d.axes, d.init) for d in jax.tree.leaves(
            j_tcn_defs(j_get_config(name)),
            is_leaf=lambda x: hasattr(x, "axes"))]
        assert got == want, name


def test_abstract_params_are_meta_shapes():
    from repro_torch.configs import get_config
    from repro_torch.models import build_bundle
    from repro_torch.sharding import abstract_params
    from repro_torch.utils.trees import tree_leaves

    defs = build_bundle(get_config("olmo-1b"), "cpu").param_defs
    got = tree_leaves(abstract_params(defs))
    assert all(t.device.type == "meta" for t in got)
    assert [tuple(t.shape) for t in got] == [d.shape
                                             for d in tree_leaves(defs)]


# ---------------------------------------------------------------------------
# launch/specs: caches and batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", _configs())
def test_cache_and_batch_pspecs_match_reference(name, mesh):
    from repro.configs import get_config as j_get_config
    from repro.configs.shapes import SHAPES
    from repro.launch import specs as jspecs
    from repro.models import input_specs as j_input_specs
    from repro.models.build import make_cache_specs as j_cache_specs

    from repro_torch.configs import get_config
    from repro_torch.launch import specs
    from repro_torch.models import input_specs
    from repro_torch.models.build import make_cache_specs

    cfg, jcfg = get_config(name), j_get_config(name)
    m = FakeMesh(MESHES[mesh])
    for shape, s in SHAPES.items():
        got = _spec_leaves(specs.cache_pspecs(
            cfg, make_cache_specs(cfg, s.global_batch, s.seq_len), m))
        want = _spec_leaves(jspecs.cache_pspecs(
            jcfg, j_cache_specs(jcfg, s.global_batch, s.seq_len), m))
        assert got == want, shape
        got = specs.batch_pspecs(cfg, input_specs(cfg, shape), m)
        want = jspecs.batch_pspecs(jcfg, j_input_specs(jcfg, shape), m)
        assert _spec_leaves(got) == _spec_leaves(want), shape


def test_cache_pspecs_shard_sequence_when_heads_do_not_divide():
    """8 KV heads on a 16-way model axis: the sequence goes over model
    (context-parallel decode), as the reference's rule says."""
    from repro_torch.launch.specs import cache_pspecs
    from repro_torch.sharding.rules import P

    m = FakeMesh({"data": 16, "model": 16})
    tree = {"k": torch.empty((2, 32, 4096, 8, 64), device="meta")}
    assert cache_pspecs(None, tree, m)["k"] == P(None, "data", "model",
                                                 None, None)
    tree = {"k": torch.empty((2, 3, 4096, 16, 64), device="meta")}
    assert cache_pspecs(None, tree, m)["k"] == P(None, None, "data",
                                                 "model", None)
    assert P(("data",), ()) == P("data", None)


def test_train_state_pspecs_match_reference():
    from repro.launch.specs import train_state_pspecs as j_tsp
    from repro.sharding.rules import param_pspecs as j_param_pspecs
    from repro.training import optim as joptim

    from repro_torch.launch.specs import train_state_pspecs
    from repro_torch.sharding import DEFAULT_RULES, param_pspecs
    from repro_torch.training import optim

    defs, jdefs = _param_defs("olmo-1b")
    ps = param_pspecs(defs, DEFAULT_RULES)
    jps = j_param_pspecs(jdefs, DEFAULT_RULES)
    got = train_state_pspecs(ps, optim.AdamState(None, None, None))
    want = j_tsp(jps, joptim.AdamState(None, None, None))
    assert _spec_leaves(got) == _spec_leaves(want)
    assert type(got.opt_state).__name__ == "AdamState"
    assert got.step == ()


def test_named_places_each_spec():
    from repro_torch.launch.specs import NamedSharding, named
    from repro_torch.sharding.rules import P

    m = FakeMesh({"data": 2, "model": 2})
    tree = {"a": P("data"), "b": {"c": P(None, "model"), "d": P()}}
    out = named(m, tree)
    assert out["a"] == NamedSharding(m, P("data"))
    assert out["b"]["c"].spec == P(None, "model")
    assert out["b"]["d"].spec == P()


# ---------------------------------------------------------------------------
# sessions: grid, bank and column specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES) + ["4x1", "1x4"])
@pytest.mark.parametrize("n_slots", [8, 64, 6])
def test_grid_pspecs_match_reference(mesh, n_slots):
    from repro.configs import get_config as j_get_config
    from repro.sessions import grid_pspecs as j_grid_pspecs

    from repro_torch.configs import get_config
    from repro_torch.sessions import grid_pspecs

    shape = MESHES.get(mesh) or dict(zip(("data", "model"), map(
        int, mesh.split("x"))))
    m = FakeMesh(shape)
    got = _spec_leaves(grid_pspecs(get_config("chameleon-tcn"), m, n_slots))
    want = _spec_leaves(j_grid_pspecs(j_get_config("chameleon-tcn"), m,
                                      n_slots))
    assert got == want
    sharded = n_slots % shape["data"] == 0
    assert all(v == (("data",) if sharded else ()) for v in got.values())


@pytest.mark.parametrize("mesh", list(MESHES) + ["4x1", "1x4"])
@pytest.mark.parametrize("max_tenants", [8, 16, 3])
def test_bank_pspecs_match_reference(mesh, max_tenants):
    from repro.sessions import bank_init as j_bank_init
    from repro.sessions import bank_pspecs as j_bank_pspecs

    from repro_torch.sessions import bank_init, bank_pspecs

    shape = MESHES.get(mesh) or dict(zip(("data", "model"), map(
        int, mesh.split("x"))))
    m = FakeMesh(shape)
    got = bank_pspecs(bank_init(max_tenants, 5, 12, "meta"), m)
    want = j_bank_pspecs(j_bank_init(max_tenants, 5, 12), m)
    assert _spec_leaves(got) == _spec_leaves(want)
    assert type(got).__name__ == "TenantBank"


@pytest.mark.parametrize("mesh", list(MESHES) + ["4x1"])
@pytest.mark.parametrize("name", ["olmo-1b", "deepseek-v2-lite-16b",
                                  "rwkv6-1.6b", "zamba2-1.2b",
                                  "seamless-m4t-large-v2"])
def test_column_pspecs_match_reference(name, mesh):
    from repro.configs import get_config as j_get_config
    from repro.models.build import make_cache_specs as j_cache_specs
    from repro.sessions import column_pspecs as j_column_pspecs

    from repro_torch.configs import get_config
    from repro_torch.models.build import make_cache_specs
    from repro_torch.sessions import column_pspecs, leaf_axes

    shape = MESHES.get(mesh) or {"data": 4, "model": 1}
    m = FakeMesh(shape)
    cfg, jcfg = get_config(name), j_get_config(name)
    specs = make_cache_specs(cfg, 32, 64)
    bax = leaf_axes(lambda: specs, lambda: make_cache_specs(cfg, 33, 64))
    got = _spec_leaves(column_pspecs(specs, bax, m))
    want = _spec_leaves(j_column_pspecs(j_cache_specs(jcfg, 32, 64), bax, m))
    assert got == want
    assert any(v for v in got.values())


# ---------------------------------------------------------------------------
# placements, SPMD blocks, the ambient context
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,want", [
    ((), ("R", "R", "R")),
    (("data",), ("R", "S0", "R")),
    ((None, "model"), ("R", "R", "S1")),
    (("model", ("pod", "data")), ("S1", "S1", "S0")),
    ((("pod", "data"), None, "model"), ("S0", "S0", "S2")),
])
def test_placements_of_a_spec(spec, want):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding.rules import P, placements

    m = FakeMesh({"pod": 2, "data": 4, "model": 2})
    mk = {"R": Replicate()} | {f"S{d}": Shard(d) for d in range(3)}
    assert placements(P(*spec), m) == tuple(mk[w] for w in want)


@pytest.mark.parametrize("spec,match", [
    (("pod",), "pod"),                    # an axis the mesh lacks
    (("data", "data"), "twice"),
    # DTensor nests a dim's blocks in mesh order and spmd.local_range in
    # the entry's: an entry against the mesh's order would place blocks
    # where the services do not look for them
    ((None, ("model", "data")), "mesh's axis order"),
    ((("data", "pod"),), "mesh's axis order"),
    ((None, ("model", "pod", "data")), "mesh's axis order"),
])
def test_placements_refuse_a_bad_spec(spec, match):
    from repro_torch.sharding.rules import P, placements

    shape = {"data": 2, "model": 2}
    if "pod" in str(spec) and match != "pod":
        shape = {"pod": 2, **shape}
    with pytest.raises(ValueError, match=match):
        placements(P(*spec), FakeMesh(shape))


@pytest.mark.parametrize("entry", ["data", "model", ("pod", "data"), None])
def test_spmd_blocks_tile_the_dim(entry):
    """Every rank's [lo, hi) of a 16-long dim: the blocks of one replica
    tile it in order, and ``owner`` of an index holds it."""
    from repro_torch.sharding import spmd

    shape = {"pod": 2, "data": 2, "model": 2}
    meshes = [FakeDeviceMesh(shape, r) for r in range(8)]
    n = 16
    held = {}
    for r, m in enumerate(meshes):
        lo, hi = spmd.local_range(m, entry, n)
        held[r] = set(range(lo, hi))
        assert hi - lo == n // spmd.n_blocks(m, entry)
    for i in range(n):
        o = spmd.owner(meshes[0], entry, i, n)
        assert i in held[o]
        holders = [r for r in held if i in held[r]]
        assert o == min(holders)
    blocks = {spmd.block_index(m, entry) for m in meshes}
    assert blocks == set(range(spmd.n_blocks(meshes[0], entry)))


@pytest.mark.parametrize("spec", [(None, "data"), (("pod", "data"), "model"),
                                  ("model", None), (("data", "model"),),
                                  (None, None)])
def test_block_range_of_placements_is_local_range_of_the_spec(spec):
    """``spmd.block_range`` (keyed by DTensor placements: how the trainer's
    resume and a placed cache's row write see a live leaf) gives every
    rank the block that ``spmd.local_range`` gives for the spec entry."""
    from repro_torch.sharding import spmd
    from repro_torch.sharding.rules import P, placements

    shape = {"pod": 2, "data": 2, "model": 2}
    for r in range(8):
        m = FakeDeviceMesh(shape, r)
        pls = placements(P(*spec), m)
        for d, entry in enumerate(spec):
            assert spmd.block_range(m, pls, d, 16) == \
                spmd.local_range(m, entry, 16), (r, d)


def test_constrain_without_and_with_a_context():
    from repro_torch.sharding.ctx import constrain, current_rules, shard_ctx

    x = torch.ones(4, 4)
    assert constrain(x, ("batch", None)) is x
    assert current_rules() is None
    m = FakeMesh({"pod": 2, "data": 2, "model": 1})
    with shard_ctx(m, {"batch": "dp", "embed": "data"}) as rules:
        assert rules == {"batch": ("pod", "data"), "embed": "data"}
        assert current_rules() == rules
        assert constrain(x, ("batch", None)) is x  # a plain tensor stays
    assert current_rules() is None
