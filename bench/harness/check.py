"""How ``correct`` is decided: what the timed path produced, against the
plain reference (bench/reference) worked out again from the same inputs.

A run records, for a seeded sample of its streams, every push's inputs and
outputs (the embedding, the FC logits and the banked tenant logits of
every step), the way every enrollment returned and, after the window, the
bank of every checked tenant that enrolled (every tenant, or where the
cell sets ``check_tenants``, that many drawn from the seed and the sampled
streams' tenants).  The reference then runs every sampled stream from its
first sample, replays the checked tenants' enrollments in order (embedding
every shot again) and every enrollment's label, and gives the same
outputs.  The numbers compared:

* ``<out>_gap``: the largest |program - reference| over every entry of the
  output, over the largest |reference| entry (an entry of -inf, a way not
  yet enrolled, must be -inf on both sides, or the gap is inf);
* ``<out>_mismatch``: the share of entries farther apart than 1e-3 of
  that scale (a u4 activation one level off is 1/15 of the scale);
* ``bank_w_gap`` / ``bank_b_gap``: the same gap for W = s / k and
  b = -||W||^2 / 2 of the banks left behind;
* ``ways_wrong``: enrollments whose returned way is not the way of their
  label;
* ``emb_levels`` (a quantized configuration): the largest |program -
  reference| of the embedding in u4 levels.  The body sums in the
  reference's order, so only the head's rounding can differ, and it moves
  an embedding at a rounding tie by one level at the most.

The control puts the reference, computed in TF32, in the program's place.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from bench.harness.traffic import mix
from bench.reference import tcn as ref

MISMATCH = 1e-3


@dataclass
class Inputs:
    """What the reference needs: the sampled streams' inputs per push, with
    the number of enrollments made before each, and the enrollments in
    order (tenant, label, shots; shots None where the tenant is not
    checked)."""
    sample: list                      # stream indices
    tenant: dict                      # stream index -> tenant or None
    checked: set | None = None        # tenants whose banks are replayed
    x: dict = field(default_factory=dict)       # stream -> [(steps, C_in)]
    at: dict = field(default_factory=dict)      # stream -> [enrollments]
    enrolls: list = field(default_factory=list)
    banks: dict = field(default_factory=dict)   # tenant -> initial blob
    max_ways: int = 0


class Recording:
    """The calls a traffic generator makes (bench/harness/traffic.py), kept
    as the reference needs them.  The run's recorder makes the same calls on
    the program as well; the control only records them."""

    def __init__(self, gen, workload: dict, seed: int, dim: int):
        self.gen, self.dim = gen, dim
        S = gen.sessions
        k = min(int(workload["check_sessions"]), S)
        sample = sorted(int(s) for s in
                        np.argsort(mix(seed % (1 << 64), 20, np.arange(S)))[:k])
        tenant = {s: gen.tenant_of(s) for s in sample}
        checked = None
        if "check_tenants" in workload:
            n = min(int(workload["check_tenants"]), gen.tenants)
            drawn = np.argsort(mix(seed % (1 << 64), 21,
                                   np.arange(gen.tenants)))[:n]
            checked = {int(t) for t in drawn} \
                | {t for t in tenant.values() if t is not None}
        self.inp = Inputs(sample=sample, tenant=tenant, checked=checked,
                          max_ways=workload["service"].get("max_ways", 0))
        self._sampled = set(sample)

    def is_checked(self, tenant) -> bool:
        return self.inp.checked is None or tenant in self.inp.checked

    def adopt(self, tenant: int, blob: dict) -> None:
        self.inp.banks[tenant] = blob

    def open(self, stream: int, tenant) -> None:
        pass

    def sampled(self, streams) -> list[tuple[int, int]]:
        """(row, stream) of the sampled streams among ``streams``."""
        return [(i, s) for i, s in enumerate(streams) if s in self._sampled]

    def push(self, x: np.ndarray, streams=None):
        """Push ``x[i]`` (steps, C_in) to stream ``streams[i]`` (default:
        stream i)."""
        streams = range(len(x)) if streams is None else streams
        for i, s in self.sampled(streams):
            self.inp.x.setdefault(s, []).append(x[i].copy())
            self.inp.at.setdefault(s, []).append(len(self.inp.enrolls))
        return None

    def enroll(self, stream: int, label, shots: np.ndarray):
        """Enroll ``shots`` (k, steps, C_in) under ``label`` into the bank
        of stream ``stream``'s tenant."""
        t = self.gen.tenant_of(stream)
        self.inp.enrolls.append((t, label,
                                 shots if self.is_checked(t) else None))
        return None


@dataclass
class Outputs:
    """One side's outputs, in the shape the program returns them."""
    emb: dict = field(default_factory=dict)      # stream -> [(steps, V)]
    logits: dict = field(default_factory=dict)
    tenant_logits: dict = field(default_factory=dict)  # stream -> [(steps, N)]
    ways: list = field(default_factory=list)     # per enrollment
    banks: dict = field(default_factory=dict)    # tenant -> {s_sums, counts}


def reference_outputs(inp: Inputs, served: dict, sizes: dict, *,
                      quantize: bool, precision: str, device,
                      block: int = 8, shot_block: int = 256) -> Outputs:
    """The reference's outputs for ``inp`` (see the module docstring)."""
    act = sizes["act_scale"]
    out = Outputs()
    # every checked enrollment's shots, embedded again
    shots = [torch.from_numpy(np.asarray(e[2], np.float32))
             for e in inp.enrolls if e[2] is not None]
    flat = torch.cat(shots) if shots else None
    shot_emb = []
    for i in range(0, 0 if flat is None else len(flat), shot_block):
        # a shot's embedding is its last step's
        shot_emb.append(ref.forward(
            served, flat[i:i + shot_block].to(device), act_scale=act,
            quantize=quantize, precision=precision)[0][:, -1])
    shot_emb = torch.cat(shot_emb) if shot_emb else None
    # every sampled stream that was pushed, from its first sample
    pushed = [s for s in inp.sample if inp.x.get(s)]
    by_len: dict = {}                       # streams of equal length batch
    for s in pushed:
        by_len.setdefault(sum(x.shape[0] for x in inp.x[s]), []).append(s)
    blocks = [g[i:i + block] for _, g in sorted(by_len.items())
              for i in range(0, len(g), block)]
    embs = {}
    for ss in blocks:
        x = torch.from_numpy(np.stack([np.concatenate(inp.x[s]) for s in ss]))
        e, lg = ref.forward(served, x.to(device), act_scale=act,
                            quantize=quantize, precision=precision)
        for j, s in enumerate(ss):
            embs[s] = e[j]
            out.emb[s] = _split(e[j], inp.x[s])
            out.logits[s] = _split(lg[j], inp.x[s])
    # the banks and labels, replayed in order; a push's tenant logits use
    # its tenant's bank as it stood after the enrollments made before it
    banks, labels, n_ways = {}, {}, {}
    for t, b in inp.banks.items():
        banks[t] = ref.Bank(torch.from_numpy(np.asarray(
            b["s_sums"], np.float32)).to(device), b["counts"])
        labels[t], n_ways[t] = dict(b["labels"]), int(b["n_ways"])

    def bank(t):    # a tenant with no initial bank starts empty
        if t not in banks:
            banks[t] = ref.Bank(torch.zeros((0, sizes["embed_dim"]),
                                            device=device), [])
        return banks[t]
    todo = sorted((q, s, j) for s in pushed if inp.tenant[s] is not None
                  for j, q in enumerate(inp.at[s]))
    fcs: dict = {}
    k = 0                                   # next entry of todo
    off = 0                                 # next checked shot
    for q in range(len(inp.enrolls) + 1):
        group = []
        while k < len(todo) and todo[k][0] == q:
            group.append(todo[k][1:])
            k += 1
        for steps in sorted({inp.x[s][j].shape[0] for s, j in group}):
            part = [(s, j) for s, j in group if inp.x[s][j].shape[0] == steps]
            w, b = zip(*(fcs.get(inp.tenant[s]) or fcs.setdefault(
                inp.tenant[s], bank(inp.tenant[s]).fc(inp.max_ways))
                for s, _ in part))
            a = [sum(x.shape[0] for x in inp.x[s][:j]) for s, j in part]
            rows = torch.stack([embs[s][o:o + steps]
                                for (s, _), o in zip(part, a)])
            tl = ref.banked_logits_rows(rows, torch.stack(w), torch.stack(b),
                                        precision)
            for i, (s, j) in enumerate(part):
                out.tenant_logits.setdefault(s, {})[j] = tl[i].cpu().numpy()
        if q == len(inp.enrolls):
            break
        t, label, sh = inp.enrolls[q]
        n = n_ways.get(t, 0)
        way = labels.setdefault(t, {}).setdefault(label, n)
        n_ways[t] = max(n, way + 1)
        out.ways.append(way)
        if sh is not None:
            bank(t).enroll(way, shot_emb[off:off + len(sh)])
            off += len(sh)
            fcs.pop(t, None)
    out.tenant_logits = {s: [d[j] for j in sorted(d)]
                         for s, d in out.tenant_logits.items()}
    for t in sorted({e[0] for e in inp.enrolls if e[2] is not None}):
        out.banks[t] = {"s_sums": torch.stack(banks[t].sums).cpu().numpy(),
                        "counts": np.asarray(banks[t].counts, np.float32)}
    return out


def _split(a: torch.Tensor, like: list) -> list:
    a = a.cpu().numpy()
    out, off = [], 0
    for x in like:
        out.append(a[off:off + x.shape[0]])
        off += x.shape[0]
    return out


def _gap(got: list, want: list) -> tuple[float, float]:
    """(largest gap over the largest finite |want|, share of entries off by
    more than MISMATCH of it) of two lists of arrays, pair by pair."""
    if len(got) != len(want) or any(np.shape(a) != np.shape(b)
                                    for a, b in zip(got, want)):
        return float("inf"), 1.0
    scale = _scale(want)
    worst, off, n = 0.0, 0, 0
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        with np.errstate(invalid="ignore"):
            d = np.abs(g - w)
        d[(~np.isfinite(w)) & (g == w)] = 0.0   # -inf on both sides
        d[np.isnan(d)] = np.inf
        if d.size:
            worst = max(worst, float(d.max()))
            off += int((d > MISMATCH * scale).sum())
            n += d.size
    return worst / scale, off / max(n, 1)


def _scale(want: list) -> float:
    """The largest finite |entry| of a list of arrays (1 where none)."""
    scale = 0.0
    for w in want:
        fin = np.isfinite(w)
        if fin.any():
            scale = max(scale, float(np.abs(w[fin]).max()))
    return scale if scale > 0 else 1.0


def compare(prog: Outputs, want: Outputs, max_ways: int,
            level: float | None = None) -> dict:
    """Every number of the module docstring that the outputs allow;
    ``level`` is a u4 level of a quantized configuration."""
    nums: dict = {}
    for name in ("emb", "logits", "tenant_logits"):
        w = getattr(want, name)
        if not w:
            continue
        p = getattr(prog, name)
        got, exp = [], []
        for s, parts in w.items():
            have = p.get(s)
            if have is None or len(have) != len(parts) \
                    or any(x is None for x in have):
                nums[f"{name}_gap"], nums[f"{name}_mismatch"] = \
                    float("inf"), 1.0
                break
            got += have
            exp += parts
        else:
            nums[f"{name}_gap"], nums[f"{name}_mismatch"] = _gap(got, exp)
            if name == "emb" and level:
                nums["emb_levels"] = nums["emb_gap"] * _scale(exp) / level
    if want.ways or prog.ways:
        nums["ways_wrong"] = float(
            sum(a != b for a, b in zip(prog.ways, want.ways))
            + abs(len(prog.ways) - len(want.ways)))
    if want.banks:
        gw, gb = [], []
        for t, wb in want.banks.items():
            pb = prog.banks.get(t)
            if pb is None or np.asarray(pb["counts"]).shape \
                    != wb["counts"].shape:
                nums["bank_w_gap"] = nums["bank_b_gap"] = float("inf")
                return nums
            w_p, b_p = _bank_fc(pb, max_ways)
            w_r, b_r = _bank_fc(wb, max_ways)
            gw.append((w_p, w_r))
            gb.append((b_p, b_r))
        nums["bank_w_gap"] = _gap([a for a, _ in gw], [b for _, b in gw])[0]
        nums["bank_b_gap"] = _gap([a for a, _ in gb], [b for _, b in gb])[0]
    return nums


def _bank_fc(blob: dict, max_ways: int):
    s = torch.from_numpy(np.asarray(blob["s_sums"], np.float32))
    w, b = ref.Bank(s, np.asarray(blob["counts"], np.float32)).fc(max_ways)
    return w.numpy(), b.numpy()


def judge(nums: dict, limits: dict) -> tuple[bool, list]:
    """(every limited number within its limit, [(name, value, limit)])."""
    rows = [(k, nums.get(k, float("inf")), float(v))
            for k, v in limits.items()]
    return all(v <= lim for _, v, lim in rows), rows
