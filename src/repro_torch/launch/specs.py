"""Sharding specs for batches, caches and optimizer state per (arch, mesh).

The port of ``repro/launch/specs.py``.  Parameters get their specs from
the ParamDef logical axes (sharding/rules.py); this module covers the
runtime trees: input batches, KV/state caches and optimizer state (which
mirrors the param specs leaf for leaf).  Dims are only sharded when
divisible by the mesh axis size (8 KV heads on a 16-way model axis stay
replicated: Megatron's GQA duplication rule).

``named(mesh, specs)`` is the twin of the reference's tree of
``NamedSharding``: a tree of ``NamedSharding(mesh, spec)``, each of which
gives its DTensor ``placements`` and ``place``s a full tensor
(``checkpoint/store.restore_into(shardings=)`` takes such a tree).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.launch.mesh import dp_axes
from repro_torch.models.config import ArchConfig
from repro_torch.sharding.rules import P, axis_size, map_specs, placements
from repro_torch.training.trainer import TrainState
from repro_torch.utils.trees import map_with_path


def _maybe(mesh, dim: int, axes):
    """Shard dim over axes only if divisible."""
    return axes if dim % max(axis_size(mesh, axes), 1) == 0 and dim > 1 \
        else None


def batch_pspecs(cfg: ArchConfig, specs: dict, mesh) -> dict:
    dp = dp_axes(mesh)
    out = {}
    for name, s in specs.items():
        if name == "pos" or s.ndim == 0:
            out[name] = P()
            continue
        b = _maybe(mesh, s.shape[0], dp)
        if s.ndim == 3:  # (B, S/T, D/C) real-valued frontend stubs
            out[name] = P(b, None, None)
        else:            # (B, S) tokens / labels; (B,) labels
            out[name] = P(b, *([None] * (s.ndim - 1)))
    return out


def cache_pspecs(cfg: ArchConfig, cache_tree, mesh) -> dict:
    """KV caches (L,B,S,H,D), MLA latents (L,B,S,r), SSM states, rings."""
    dp = dp_axes(mesh)

    def leaf_spec(path, leaf):
        # dict keys and NamedTuple fields (".field") along the path
        names = [n.lstrip(".") for n in path.split("/")]
        shape = tuple(leaf.shape)
        b = _maybe(mesh, shape[1], dp) if len(shape) >= 2 else None
        if any(n in ("k", "v") for n in names) and len(shape) == 5:
            L, B, S, H, Dh = shape
            h = _maybe(mesh, H, "model")
            # kv_heads below the TP degree (8 on 16): shard the SEQUENCE
            # over the model axis instead (context-parallel decode)
            seq_axes = [a for a in ("data", "model")
                        if (a == "data" and b is None)
                        or (a == "model" and h is None)]
            seq = tuple(seq_axes) if seq_axes else None
            if seq is not None and S % axis_size(mesh, seq) != 0:
                seq = None
            return P(None, b, seq, h, None)
        if any(n == "c_kv" for n in names):  # (L,B,S,r) MLA latent
            return P(None, b, _maybe(mesh, shape[2], "model"), None)
        if any(n == "k_rope" for n in names):  # (L,B,S,1,dr)
            return P(None, b, _maybe(mesh, shape[2], "model"), None, None)
        if any(n == "ssm" for n in names):  # (L,B,H,N,P)
            return P(None, b, _maybe(mesh, shape[2], "model"), None, None)
        if any(n == "state" for n in names):  # rwkv (L,B,H,Dh,Dh)
            return P(None, b, _maybe(mesh, shape[2], "model"), None, None)
        if any(n == "conv" for n in names):  # (L,B,K-1,C)
            return P(None, b, None, _maybe(mesh, shape[3], "model"))
        if len(shape) == 3:  # rwkv x_prev (L,B,D)
            return P(None, b, None)
        return P(*([None] * len(shape)))

    return map_with_path(leaf_spec, cache_tree)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: where each rank's block of a tensor lies."""
    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def place(self, full):
        """``full`` (the same on every rank) as a DTensor of this spec;
        each rank keeps its own block and nothing is sent."""
        from repro_torch.sharding.spmd import place

        return place(full, self.mesh, self.spec)


def named(mesh, pspec_tree):
    return map_specs(lambda s: NamedSharding(mesh, s), pspec_tree)


def place_tree(shardings, tree):
    """Each leaf of ``tree`` (the same on every rank) placed by its
    ``NamedSharding`` in ``shardings`` (a tree of the same structure)."""
    return map_specs(lambda s, x: s.place(x), shardings, tree)


def train_state_pspecs(param_pspecs_tree, opt_state_abstract) -> TrainState:
    """Optimizer state mirrors the param specs (mu/nu per leaf)."""
    return TrainState(
        params=param_pspecs_tree,
        opt_state=type(opt_state_abstract)(
            step=P(),
            mu=param_pspecs_tree,
            nu=param_pspecs_tree,
        ),
        model_state={},
        err_state={},
        step=P(),
    )
