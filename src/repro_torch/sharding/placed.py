"""What the LM code does with parameters placed on a mesh.

With ``launch/specs.place_tree`` a parameter tree becomes DTensors laid
out by ``param_pspecs`` (FSDP: the ``embed`` dim over ``data``; TP: heads,
FFN hidden, vocab and experts over ``model``), and the batch DTensors by
``batch_pspecs``.  The model functions then run on DTensors: elementwise
ops and reductions go through DTensor's sharding propagation, and the
``constrain`` sites (sharding/ctx.py) pin the activations' layouts.  The
rest is done here, by hand:

  * ``use(w, dtype)``: a weight at its use, cast, then gathered over the
    data axes (``pod``, ``data``) and left sharded over ``model``: the
    FSDP all-gather; its backward is the gradient's reduce-scatter;
  * ``linear(x, w)``: a product in Megatron's layout, chosen per mesh
    dim from the layouts at hand (DTensor's own strategy search takes
    minutes a product on a three-axis mesh);
  * ``like(t, ref)``: a tensor that a step builds itself (a rope table, a
    mask, zeros), the same on every rank by construction, as a replicated
    DTensor on ``ref``'s mesh; a plain tensor that came from elsewhere is
    never lifted this way;
  * ``local_apply``: a function that is independent per lane (and per
    head) run on each rank's block: the attention core, the recurrences,
    the MoE dispatch, the embedding lookup, the loss's sums.  Its inputs
    are redistributed to the given placements and its outputs wrapped in
    them; an input replicated along a mesh dim on which an output is
    sharded gets a ``Partial`` gradient there (each rank's block of the
    output used it);
  * ``split_heads`` / ``merge_heads``: the (H, Dh) views, where DTensor's
    view rules refuse a dim sharded unevenly (2 KV heads over 4 ranks).

On plain tensors each helper does what the code did before it (a cast,
a product, a view), so one card runs the same ops, bit for bit.
"""

from __future__ import annotations

import torch

DATA_AXES = ("pod", "data")


def is_dt(x) -> bool:
    # a plain tensor or a non-tensor answers without the import: the
    # unsharded path asks this tens of times a layer
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def mesh_of(*xs):
    """The mesh of the first DTensor among ``xs``, else None."""
    for x in xs:
        if is_dt(x):
            return x.device_mesh
    return None


def replicated(mesh) -> list:
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim


def like(t, ref):
    """``t``, built the same on every rank from shapes and constants, as a
    replicated DTensor on ``ref``'s mesh (``t`` itself when ``ref`` is a
    plain tensor or ``t`` is already a DTensor)."""
    if not is_dt(ref) or is_dt(t) or not isinstance(t, torch.Tensor):
        return t
    from torch.distributed.tensor import DTensor

    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, replicated(mesh), run_check=False)


def use(w, dtype=None):
    """A weight at its use: cast to ``dtype``, then gathered over the data
    axes and left sharded over the others (a plain tensor is only
    cast)."""
    if dtype is not None:
        w = w.to(dtype)
    if not is_dt(w):
        return w
    from torch.distributed.tensor import Replicate

    mesh = w.device_mesh
    pl = [Replicate() if n in DATA_AXES else p
          for n, p in zip(mesh.mesh_dim_names, w.placements)]
    return w if list(pl) == list(w.placements) else w.redistribute(mesh, pl)


def linear(x, w):
    """``x @ w`` for x (..., K) and a weight w (K, N), Megatron's way on a
    mesh, chosen per mesh dim from the layouts at hand (no search over
    DTensor's strategies, which on a three-axis mesh takes minutes):

      w replicated      x's lanes or rows stay sharded (a sharded K is
                        gathered); the output follows x
      w over N          x gathered (the sequence-parallel all-gather);
                        the output sharded over N (column-parallel)
      w over K          x cut along K; the output a ``Partial`` sum
                        (row-parallel)

    Each rank multiplies its own blocks (``local_apply``)."""
    if not (is_dt(x) or is_dt(w)):
        return x @ w
    from torch.distributed.tensor import Partial, Replicate, Shard

    x, w = like(x, w), like(w, x)
    mesh, last = x.device_mesh, x.ndim - 1
    xp, op = [], []
    for a, b in zip(x.placements, w.placements):
        if isinstance(b, Shard) and b.dim == 0:      # row-parallel
            xp.append(Shard(last))
            op.append(Partial())
        elif isinstance(b, Shard):                    # column-parallel
            xp.append(Replicate())
            op.append(Shard(last))
        elif isinstance(a, Shard) and a.dim != last:  # rows of x
            xp.append(a)
            op.append(a)
        else:
            xp.append(Replicate())
            op.append(Replicate())
    return local_apply(torch.matmul, mesh, (x, w), (xp, list(w.placements)),
                       op)


def full(x):
    """``x`` replicated on every rank (a plain tensor as it is)."""
    if not is_dt(x):
        return x
    return x.redistribute(x.device_mesh, replicated(x.device_mesh))


def lane_layout(mesh, x, *, head_dim: int | None = None,
                heads: tuple = ()) -> list:
    """Placements for a per-lane (and per-head) computation: along each
    mesh dim on which ``x`` is sharded on dim 0 (the lanes), Shard(0);
    along ``model``, with ``head_dim`` given, Shard(head_dim) when every
    count in ``heads`` divides by its size (the reference's
    ``heads_act``); else Replicate."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    xp = x.placements if is_dt(x) else replicated(mesh)
    for i, (name, p) in enumerate(zip(mesh.mesh_dim_names, xp)):
        n = mesh.size(i)
        if isinstance(p, Shard) and p.dim == 0:
            out.append(Shard(0))
        elif head_dim is not None and name == "model" and n > 1 \
                and all(h % n == 0 for h in heads):
            out.append(Shard(head_dim))
        else:
            out.append(Replicate())
    return out


def lane_local(v, mesh, lay):
    """A position or length for a ``local_apply`` over ``lay``: an int or
    a 0-d tensor whole, a per-lane (B,) DTensor cut to this rank's
    lanes."""
    from torch.distributed.tensor import Replicate, Shard

    if not isinstance(v, torch.Tensor):
        return v
    if not is_dt(v):
        if v.dim():
            raise ValueError("per-lane positions on a mesh must be placed "
                             "(a DTensor), not a plain tensor")
        return v
    if v.dim() == 0:
        return full(v).to_local()
    pl = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in lay]
    return v.redistribute(mesh, pl).to_local()


def split_heads(t, *shape):
    """``t.view(*shape)`` for a view that splits the last dim into (H,
    Dh): a mesh dim that shards the last dim but does not divide H (2 KV
    heads over a 4-way ``model`` axis, which ``param_pspecs`` shards by
    their H * Dh columns) is gathered first."""
    if is_dt(t):
        from torch.distributed.tensor import Replicate, Shard

        mesh, last, h = t.device_mesh, t.ndim - 1, shape[-2]
        pl = [Replicate() if isinstance(p, Shard) and p.dim == last
              and h % mesh.size(i) else p
              for i, p in enumerate(t.placements)]
        if pl != list(t.placements):
            t = t.redistribute(mesh, pl)
    return t.view(*shape)


def merge_heads(t, *shape):
    """``t.reshape(*shape)`` for a reshape that merges the trailing (H,
    Dh) dims, run on each rank's block with ``t``'s placements: a merge
    whose backward splits a dim that a later product sharded unevenly
    (2 heads over a 4-way axis) would fail in DTensor's view rule."""
    if not is_dt(t):
        return t.reshape(*shape)
    from torch.distributed.tensor import Shard

    mesh, pl = t.device_mesh, list(t.placements)
    local = list(shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and local[p.dim] != -1:
            local[p.dim] //= mesh.size(i)
    return local_apply(lambda a: a.reshape(*local), mesh, (t,), (pl,), pl)


def local_apply(fn, mesh, args, in_pl, out_pl):
    """``fn`` on each rank's blocks.  ``args`` (DTensors, or tensors a
    step built the same on every rank) and ``in_pl`` match one for one.
    ``fn`` returns a tensor or a tuple of tensors, matched by ``out_pl``;
    each is wrapped as a DTensor of those placements."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    single = not isinstance(out_pl, tuple)
    outs_pl = (out_pl,) if single else out_pl
    out_sharded = [any(not isinstance(pl[i], Replicate) for pl in outs_pl)
                   for i in range(mesh.ndim)]
    loc = []
    for a, pl in zip(args, in_pl):
        if not is_dt(a):  # built the same on every rank
            a = DTensor.from_local(a, mesh, replicated(mesh),
                                   run_check=False)
        if list(a.placements) != list(pl):
            a = a.redistribute(mesh, pl)
        grad_pl = [Partial() if isinstance(p, Replicate) and out_sharded[i]
                   else p for i, p in enumerate(pl)]
        loc.append(a.to_local(grad_placements=grad_pl))
    res = fn(*loc)
    res = (res,) if single else res
    wrapped = tuple(_Wrap.apply(r, mesh, tuple(pl))
                    if isinstance(r, torch.Tensor) else r
                    for r, pl in zip(res, outs_pl))
    return wrapped[0] if single else wrapped


class _Wrap(torch.autograd.Function):
    """``DTensor.from_local`` whose backward hands each rank its block of
    the gradient in the output's layout, and, along a mesh dim where the
    output is a ``Partial`` sum, the whole upstream gradient (each rank's
    partial sum contributes to the total with weight one).  Spelled out:
    the DTensor releases this code runs on differ in what
    ``from_local``'s own backward does there."""

    @staticmethod
    def forward(ctx, local, mesh, pl):
        from torch.distributed.tensor import DTensor, Partial, Replicate

        ctx.mesh = mesh
        ctx.want = [Replicate() if isinstance(p, Partial) else p for p in pl]
        return DTensor.from_local(local, mesh, pl, run_check=False)

    @staticmethod
    def backward(ctx, g):
        if list(g.placements) != ctx.want:
            g = g.redistribute(ctx.mesh, ctx.want)
        return g.to_local(), None, None
