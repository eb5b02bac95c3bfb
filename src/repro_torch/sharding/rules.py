"""Logical-axis sharding rules over a ``torch.distributed`` device mesh.

The port of ``repro/sharding/rules.py``.  Every parameter is declared once
as a ``ParamDef`` (models/params.py) carrying its shape and a tuple of
logical axis names; ``param_pspecs`` maps logical names to mesh axes
through a rules table, so switching DP/TP/SP/EP layouts is switching the
rules dict.  A spec is a ``P``: one entry per tensor dim, each a mesh axis
name, a tuple of them, or None (replicated), with trailing Nones trimmed.
It is a tuple, so it compares equal entry for entry with the reference's
``jax.sharding.PartitionSpec``.

``placements(spec, mesh)`` turns a spec into the DTensor placements of a
``DeviceMesh`` (launch/mesh.py): one ``Shard(dim)`` or ``Replicate()`` per
mesh dim.  A tensor dim given a tuple of mesh axes is sharded over each of
them, the first outermost, as the reference lays out ``P(("pod",
"data"))``.

Mesh axes: ``("pod", "data", "model")`` multi-pod or ``("data",
"model")``.  The rules reference ``"data"``/``"model"``/``"dp"`` (= pod +
data); ``resolve_rules`` expands ``"dp"`` on the mesh at hand.  A mesh
here is anything with ``axis_names`` and a ``shape`` mapping axis ->
extent (``mesh_shape`` reads both off a ``DeviceMesh``).
"""

from __future__ import annotations

from repro_torch.models.params import ParamDef, abstract_params, init_params
from repro_torch.utils.trees import tree_leaves, tree_unflatten

# Default logical-axis -> mesh-axis rules (Megatron-style TP + vocab/expert
# sharding over "model"; batch over pod+data; sequence-parallel activations)
DEFAULT_RULES: dict = {
    # --- parameters ---
    "vocab": "model",          # embedding & LM-head vocab dim
    # FSDP/ZeRO-3: the d_model row dim of every weight matrix is sharded
    # over the data axis
    "embed": "data",
    "heads": "model",          # attention head dim (column-parallel qkv)
    "kv_heads": "model",       # GQA kv heads
    "attn_out": "model",       # row-parallel attention output (contracting dim)
    "ffn": "model",            # column-parallel FFN hidden
    "ffn_in": "model",         # row-parallel FFN output (contracting dim)
    "experts": "model",        # expert parallelism
    "layers": None,            # stacked-layer leading dim (scanned)
    "conv_k": None,            # conv kernel taps
    "channels": "model",       # TCN channels
    "channels_in": None,
    "state": None,             # SSM/RWKV state dims
    "kv_lora": None,           # MLA compressed-kv rank
    "proto": None,             # prototype store (ways)
    # --- streaming sessions (sessions/state.py, sessions/tenancy.py) ---
    "slots": "data",           # session slot-grid leading axis
    "tenants": "model",        # stacked per-tenant prototype banks
    # --- activations ---
    "batch": "dp",             # expands to ("pod","data") on multi-pod meshes
    "seq": None,               # sequence dim of *inputs* (tokens)
    "seq_act": "model",        # sequence-parallel saved activations
    "heads_act": "model",      # attention-head dim of activations
    "act_embed": None,
}


def _entry(e):
    """An entry in its canonical form, as ``PartitionSpec`` keeps it: a
    one-axis tuple is that axis, an empty one None."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


class P(tuple):
    """A partition spec: ``P("model", ("pod", "data"), None)``.  A tuple, so
    it equals the reference's ``PartitionSpec`` of the same entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_entry(e) for e in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def mesh_shape(mesh) -> dict:
    """{axis name: extent} of a ``DeviceMesh`` or of anything that already
    has a ``shape`` mapping (the tests' fake meshes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return dict(mesh.shape)
    # not ``mesh.mesh.shape``: that builds the rank tensor on every read
    return {n: mesh.size(i) for i, n in enumerate(names)}


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def resolve_rules(rules: dict, mesh) -> dict:
    """Expand the virtual 'dp' axis to the mesh's actual DP axes."""
    has_pod = "pod" in axis_names(mesh)
    out = {}
    for k, v in rules.items():
        if v == "dp":
            out[k] = ("pod", "data") if has_pod else "data"
        else:
            out[k] = v
    return out


def pspec(axes: tuple, rules: dict) -> P:
    parts = [None if a is None else rules.get(a) for a in axes]
    while parts and parts[-1] is None:  # trim trailing Nones
        parts.pop()
    return P(*parts)


def axis_size(mesh, axes) -> int:
    """Devices along ``axes`` (None, one name or a tuple of names)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def pspec_sized(axes: tuple, rules: dict, shape: tuple, mesh) -> P:
    """``pspec`` that drops any axis whose dim is not divisible by the mesh
    extent (a 256206-row vocab cannot shard 16 ways and stays replicated)."""
    parts = []
    for dim, a in zip(shape, axes):
        m = None if a is None else rules.get(a)
        if m is not None and dim % axis_size(mesh, m) != 0:
            m = None
        parts.append(m)
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def param_pspecs(defs, rules: dict, mesh=None):
    """Map a tree of ParamDef -> tree of P (divisibility-gated on a mesh)."""
    if mesh is None:
        specs = [pspec(d.axes, rules) for d in tree_leaves(defs)]
    else:
        specs = [pspec_sized(d.axes, rules, d.shape, mesh)
                 for d in tree_leaves(defs)]
    return tree_unflatten(defs, specs)


def map_specs(fn, tree, *rest):
    """``fn`` over the leaves of a spec tree (nested dicts, lists and
    NamedTuples whose leaves are ``P``), the other trees walked alongside;
    a ``P`` is a tuple but a leaf here."""
    if isinstance(tree, P):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` whose entry names it, else
    ``Replicate()``.  An axis the mesh does not have, one named twice, or
    a tuple entry whose axes are not in the mesh's order raises: DTensor
    nests the blocks of a dim sharded over several mesh dims in mesh
    order, and ``spmd.local_range`` in the entry's order, so the two agree
    only when the orders do."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out: list = [Replicate()] * len(names)
    seen = set()
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}; the mesh "
                                 f"has {names}")
            if a in seen:
                raise ValueError(f"spec {spec} names axis {a!r} twice")
            seen.add(a)
            out[names.index(a)] = Shard(d)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: entry {entry} is not in the "
                             f"mesh's axis order {names}")
    return tuple(out)


__all__ = [
    "ParamDef",
    "DEFAULT_RULES",
    "P",
    "resolve_rules",
    "pspec",
    "pspec_sized",
    "param_pspecs",
    "placements",
    "map_specs",
    "init_params",
    "abstract_params",
]
