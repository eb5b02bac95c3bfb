"""Collective accounting of a step, the port of ``repro/utils/hlo.py``.

PyTorch has no HLO to parse.  The reference reads a step's collectives
from the post-SPMD HLO text; here they are recorded as the step runs:
``CollectiveRecorder`` is a ``TorchDispatchMode`` that sees every
collective the step issues, the functional ones DTensor's redistributions
call (``torch.ops._c10d_functional``) and the process-group ones
(``torch.ops.c10d``), and keeps one record per collective:
``{"opcode", "results": [(dtype name, shape), ...], "group_size"}``.

``collective_bytes(records)`` sums them with the reference's keys
(``total``, ``by_type``, ``count``), opcode names (``all-gather``,
``all-reduce``, ``reduce-scatter``, ``all-to-all``,
``collective-permute``) and accounting: the bytes of each result (the
operand's for all-reduce, all-to-all and permute, the per-device wire
traffic of a ring all-gather), a reduce-scatter's result times its group
size (its operand), a result of a dtype the table does not name counted
as 0, and a record with several results (the reference's tuple form)
summed over them.  An eager step runs every layer as its own ops, so each
collective is recorded as often as it runs: there is no while-loop body
to multiply by a trip count, as the reference must.

``parse_cost_analysis`` normalizes a cost: ``None``, a list (its first
entry) or a mapping, the values as floats; an int (a ``FlopCounterMode``
total) becomes ``{"flops": float(n)}``.
"""

from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_DTYPE_BYTES = {
    "pred": 1,
    "s4": 1, "u4": 1,
    "s8": 1, "u8": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
    "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# torch dtypes under their HLO names
_HLO_NAME = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
}

# op name stems (both namespaces) -> the reference's opcode
_OPCODE = (
    ("reduce_scatter", "reduce-scatter"),
    ("all_gather", "all-gather"), ("allgather", "all-gather"),
    ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
    ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
    ("send", "collective-permute"), ("recv", "collective-permute"),
)


def _opcode(func) -> str | None:
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d", "c10d_functional"):
        return None
    name = func.__name__.split(".")[0]
    for stem, code in _OPCODE:
        if stem in name:
            return code
    return None


def _group_size(func, args) -> int:
    """The group a collective runs over: the ProcessGroup argument of a
    ``c10d`` op, the group name of a functional one."""
    import torch.distributed as dist

    for a in args:
        if isinstance(a, dist.ProcessGroup):
            return a.size()
    for a in args:
        if isinstance(a, str):
            try:
                from torch.distributed.distributed_c10d import (
                    _resolve_process_group,
                )

                return _resolve_process_group(a).size()
            except (KeyError, ValueError, RuntimeError):
                continue
    return 1


def _results(out) -> list:
    """(HLO dtype name, shape) of every tensor a collective returned."""
    if isinstance(out, torch.Tensor):
        return [(_HLO_NAME.get(out.dtype, str(out.dtype)), tuple(out.shape))]
    if isinstance(out, (list, tuple)):
        return [r for o in out for r in _results(o)]
    return []


class CollectiveRecorder(TorchDispatchMode):
    """Record every collective dispatched inside the ``with`` block (of
    this process: rank 0 of a fake world sees what every rank issues)."""

    def __init__(self):
        super().__init__()
        self.records: list[dict] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        code = _opcode(func)
        if code is not None:
            # an in-place c10d op returns (tensors, work): its tensors are
            # its first argument
            res = out if func.namespace != "c10d" else args[0]
            self.records.append({"opcode": code, "results": _results(res),
                                 "group_size": _group_size(func, args)})
        return out


def _shape_bytes(dtype: str, dims) -> int:
    if dtype not in _DTYPE_BYTES:
        return 0
    n = 1
    for d in dims:
        n *= int(d)
    return n * _DTYPE_BYTES[dtype]


def collective_bytes(records) -> dict:
    """Sum a step's collective records (``CollectiveRecorder.records``):
    {"total": bytes, "by_type": {opcode: bytes}, "count": records with
    bytes}."""
    by_type: dict = defaultdict(int)
    count = 0
    for r in records:
        opcode = r["opcode"]
        if opcode not in _COLLECTIVES:
            continue
        nbytes = sum(_shape_bytes(d, s) for d, s in r["results"])
        if opcode == "reduce-scatter":
            nbytes *= int(r.get("group_size", 1))  # operand = result x group
        if nbytes == 0:
            continue
        by_type[opcode] += nbytes
        count += 1
    return {"total": sum(by_type.values()), "by_type": dict(by_type),
            "count": count}


def parse_cost_analysis(cost) -> dict:
    """Normalize a cost record: None -> {}, a list -> its first entry, a
    mapping's values as floats (the non-numeric dropped), a number (a
    ``FlopCounterMode`` total) -> {"flops": n}."""
    if cost is None:
        return {}
    if isinstance(cost, (int, float)):
        return {"flops": float(cost)}
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    out = {}
    for k, v in dict(cost).items():
        try:
            out[k] = float(v)
        except (TypeError, ValueError):
            pass
    return out
