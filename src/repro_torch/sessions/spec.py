"""Speculative decoding on the LM slot grid: draft cheap, verify batched.

The port of ``repro/sessions/spec.py`` for every LM family the port
builds: the pure-KV bundles (GQA and MLA caches, dense and MoE families)
and the recurrent ones (RWKV, the zamba hybrid).  A drafter proposes up
to K tokens per lane; one slot-grid dispatch verifies them all, accepts
the longest prefix the model itself would have generated and rolls the
lane back to the last accepted position.

Two verify modes:

  * ``verify="scan"`` (default, exact): on a pure-KV service the drafts
    ride the forced-token inputs of the service's OWN decode scan
    (``service._decode_scan``, the program plain ``decode`` runs), fed
    ``[tok, draft...]``.  A service with recurrent leaves (not
    ``parallel_safe``) runs ``make_verify_scan``/``_paged`` instead: the
    same steps with an ``alive`` mask per lane, which dies at the lane's
    first mismatch; from then on its recurrent leaves are frozen by value
    (that freeze is the rollback) and its KV rows stay masked by
    position.  Every live step receives exactly the token plain greedy
    decode would have fed, so the accepted prefix is bit-identical to
    ``service.decode`` for any drafter, dense or paged, across
    park/resume and spills.
  * ``verify="parallel"`` (throughput): one multi-token cached step
    (``bundle.step_fn``, the chunked-prefill path) computes all K+1 verify
    positions of every lane in one batched call at (n_slots, K+1) with
    per-lane positions: the weights are read once for K+1 tokens.  Its
    products run at another M than the decode's, so its stream is
    greedy-consistent under the chunk program, not bit-equal to the scan;
    it is deterministic and park/resume-invariant, and paged == dense.
    Every lane's position is clamped to ``seq_cap - K - 1`` so its K+1
    rows fit; a lane not verified this dispatch may then write below its
    true position, over live history, so its rows are saved before the
    step and written back after it (the reference's value mask of an
    inactive lane).  Lanes too close to the cap finish on the plain scan.
    Pure-KV services only: a recurrent leaf would need a snapshot per
    step to roll back, so a service that is not ``parallel_safe`` refuses
    it with ``ValueError``, as the reference does.

Rollback copies nothing: a lane that accepted m of its drafts sets its host
position to ``pos + m + 1``; rows written past it are dead by position
(every later step rewrites its row before attending, parking truncates to
O(pos)).  A paged lane first makes the rows it will write exclusively
owned (``_ensure_blocks``) and afterwards returns the blocks wholly past
its position to the pool (``_trim_blocks``).

On a ``mesh=`` service (sessions/lm.py) every rank verifies its own
lanes against its block of the cache, through the same programs, and
the verify's tokens are gathered to every rank; the drafts come from
the host, whose state every rank keeps the same, so every rank drafts,
accepts and counts the same tokens, and the stream is the unsharded
decoder's.

Drafters are callbacks ``drafter(history, k) -> <= k tokens`` (history =
the session's prompt and generated stream, on the host), so a session can
be parked, spilled and resumed between or inside speculative calls
without the drafter needing any rollback.  ``ngram_drafter`` is the
self-draft: the continuation of the most recent earlier occurrence of the
current suffix in the session's own stream.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.obs.device import acceptance_stats
from repro_torch.sessions.lm import (
    gather_columns,
    mask_recurrent,
    recurrent_flags,
    scatter_columns,
)
from repro_torch.sessions.state import gather_column, map_tree, scatter_rows


# ---------------------------------------------------------------------------
# Drafters
# ---------------------------------------------------------------------------

def ngram_drafter(n: int = 3, window: int = 128):
    """Self-draft from the session's own token stream: up to k tokens by
    suffix matching (the most recent earlier occurrence of the current
    (n-1)-token suffix within the last ``window`` tokens, backing off to
    shorter suffixes down to 1), each proposal joining the context for the
    next.  Returns fewer than k tokens (possibly none) when the suffix has
    never been seen."""
    if n < 2:
        raise ValueError(f"ngram order must be >= 2, got {n}")

    def _next(h: list, order: int):
        for m in range(order - 1, 0, -1):  # longest suffix first
            if len(h) <= m:
                continue
            ctx = h[-m:]
            for j in range(len(h) - m - 1, -1, -1):
                if h[j:j + m] == ctx:
                    return h[j + m]
        return None

    def draft(history, k: int) -> np.ndarray:
        h = [int(t) for t in np.asarray(history).reshape(-1)[-window:]]
        out = []
        for _ in range(int(k)):
            t = _next(h, n)
            if t is None:
                break
            out.append(t)
            h.append(t)
        return np.asarray(out, np.int32)

    return draft


# ---------------------------------------------------------------------------
# Verify scans of the bundles with recurrent leaves
# ---------------------------------------------------------------------------

def make_verify_scan(decode_fn, batch_axes, seq_axes):
    """Masked verify scan for bundles with recurrent cache leaves:
    ``verify(params, cache, tok, pos, draft, n_draft, active)`` with

      tok     (S,)   i32   pending feedback token per lane
      pos     (S,)   i32   per-lane TRUE position (inactive lanes too)
      draft   (S, K) i32   proposed tokens, left-aligned
      n_draft (S,)   i32   valid drafts per lane (<= K)
      active  (S,)   bool  lanes verified this dispatch

    K + 1 batched steps: step 0 feeds ``tok``, step j >= 1
    ``draft[:, j - 1]``.  A lane is alive at step j iff it is active and
    every earlier step's argmax matched its draft; its first mismatch
    kills it for the rest of the scan.  Recurrent leaves are committed on
    alive steps only (``lane_select`` by value), so they end at the state
    of the last accepted position; a dead step writes its KV row at the
    lane's frozen position, dead by position.  Returns ``(cache, ys (S,
    K + 1) i32)``; the caller takes the matching prefix m of ``ys``
    against ``draft`` and emits ``ys[:, :m + 1]``."""
    rec = recurrent_flags(seq_axes)

    def verify(params, cache, tok, pos, draft, n_draft, active):
        alive = active
        ys = []
        for j in range(draft.shape[1] + 1):
            t = tok if j == 0 else draft[:, j - 1]
            logits, new = decode_fn(params, cache,
                                    {"tokens": t[:, None], "pos": pos})
            y = torch.argmax(logits, dim=-1).to(torch.int32)
            cache = mask_recurrent(alive, new, cache, batch_axes, rec)
            pos = torch.where(alive, pos + 1, pos)
            if j < draft.shape[1]:
                alive = alive & (j < n_draft) & (y == draft[:, j])
            ys.append(y)
        return cache, torch.stack(ys, dim=1)

    return verify


def make_verify_scan_paged(decode_fn, batch_axes, seq_axes):
    """Paged twin of ``make_verify_scan`` for the hybrid (pooled KV leaves
    beside dense recurrent ones): ``verify(params, cache, tables, tok,
    pos, draft, n_draft, active)``.  Every lane's table row is gathered
    into its dense column once, the dense verify runs on the columns, and
    each lane's rows [pos, pos + K + 1) go back through its table (the
    decode scan's discipline: its own blocks get their bytes, unowned
    entries the NULL block); recurrent leaves come back value-masked."""
    dense = make_verify_scan(decode_fn, batch_axes, seq_axes)

    def verify(params, cache, tables, tok, pos, draft, n_draft, active):
        cols = gather_columns(cache, tables, batch_axes, seq_axes)
        cols, ys = dense(params, cols, tok, pos, draft, n_draft, active)
        cache = scatter_columns(cache, cols, tables, pos, draft.shape[1] + 1,
                                batch_axes, seq_axes)
        return cache, ys

    return verify


# ---------------------------------------------------------------------------
# Parallel verify programs
# ---------------------------------------------------------------------------

def _lane_rows(a, rows, bax: int):
    """Rows ``rows`` (S, n) of every lane of a cache leaf whose sequence
    axis follows its session axis ``bax``: (..., S, n, ...)."""
    lanes = torch.arange(rows.shape[0], device=a.device)[:, None]
    return a[(slice(None),) * bax + (lanes, rows)]


def _put_lane_rows(a, rows, bax: int, vals) -> None:
    lanes = torch.arange(rows.shape[0], device=a.device)[:, None]
    a[(slice(None),) * bax + (lanes, rows)] = vals


def make_verify_chunk(step_fn, batch_axes, seq_axes):
    """Parallel verify on a dense grid: ``verify(params, cache, toks (S,
    K+1) i32, pos (S,) i32, active (S,) bool) -> (cache, ys (S, K+1)
    i32)``, ``ys[s, j]`` the argmax after feeding ``toks[s, j]`` at
    position ``pos[s] + j``.  One batched ``step_fn`` writes rows [pos,
    pos + K + 1) of every lane in place; the rows of inactive lanes are
    restored to their bytes before the call.  Callers keep ``pos + K + 1
    <= seq_cap`` for every lane."""
    def check(bax, sax):
        if sax != bax + 1:
            raise ValueError(f"parallel verify needs every cache leaf's "
                             f"sequence axis after its session axis (got "
                             f"bax={bax}, sax={sax})")

    map_tree(check, batch_axes, seq_axes)

    def verify(params, cache, toks, pos, active):
        rows = pos[:, None].long() + torch.arange(toks.shape[1],
                                                  device=toks.device)
        saved = map_tree(lambda a, bax: _lane_rows(a, rows, bax),
                         cache, batch_axes)
        logits, cache = step_fn(params, cache, {"tokens": toks, "pos": pos})

        def restore(a, old, bax):
            keep = active.reshape((1,) * bax + (-1,)
                                  + (1,) * (old.dim() - bax - 1))
            _put_lane_rows(a, rows, bax, torch.where(
                keep, _lane_rows(a, rows, bax), old))

        map_tree(restore, cache, saved, batch_axes)
        return cache, torch.argmax(logits, dim=-1).to(torch.int32)

    return verify


def make_verify_chunk_paged(step_fn, batch_axes, seq_axes):
    """Paged twin of ``make_verify_chunk``: ``verify(params, cache, tables
    (S, max_blocks) i32, toks, pos, active)``.  Every lane's table row is
    gathered into its exact dense column, the dense verify runs on the
    columns, and each lane's rows [pos, pos + K + 1) go back through its
    table.  Inactive lanes write back the bytes they gathered; table
    entries a lane does not own map to the NULL block, whose duplicate
    writes all carry its own gathered bytes.  Callers make every block
    covering an active lane's rows exclusively owned before the call."""
    dense = make_verify_chunk(step_fn, batch_axes, seq_axes)

    def verify(params, cache, tables, toks, pos, active):
        cols = map_tree(lambda a, bax: gather_column(a, tables, bax),
                        cache, batch_axes)
        cols, ys = dense(params, cols, toks, pos, active)
        rows = pos[:, None].long() + torch.arange(toks.shape[1],
                                                  device=toks.device)
        map_tree(lambda a, c, bax: scatter_rows(a, c, tables, rows, bax),
                 cache, cols, batch_axes)
        return cache, ys

    return verify


# ---------------------------------------------------------------------------
# The drafter/verifier layer over LMSessionService
# ---------------------------------------------------------------------------

class SpeculativeDecoder:
    """Speculative ``decode`` over an ``LMSessionService``.

    ``decode(want)`` has the plain service's contract (``want[sid]``
    greedy tokens per session, parked sessions resumed, retirement at
    seq_cap), but each dispatch verifies a K-token draft per lane.  With
    ``verify="scan"`` the stream is bit-identical to ``service.decode``
    for any drafter; ``verify="parallel"`` is the throughput mode.  The
    drafter is advisory: it never touches device state.

    Counters go to the service's registry: ``spec_drafted_total`` and
    ``spec_accepted_total`` (labels service="lm", verify=mode), and with
    the service's ``device_counters`` on, ``spec_device_accepted_total``
    (service="lm"): each lane's matching-prefix length computed on the
    device from the verify's outputs (``obs.device.acceptance_stats``),
    equal to the host's rollback count."""

    def __init__(self, service, drafter=None, *, k: int = 4,
                 verify: str = "scan"):
        if k < 1:
            raise ValueError(f"draft length k must be >= 1, got {k}")
        if verify not in ("scan", "parallel"):
            raise ValueError(f"verify must be 'scan' or 'parallel', "
                             f"got {verify!r}")
        self.svc = service
        self.k = int(k)
        self.drafter = drafter if drafter is not None else ngram_drafter()
        self.verify = verify
        if verify == "parallel":
            if not service.parallel_safe:
                raise ValueError(
                    "parallel verify needs every cache leaf position-indexed "
                    "(recurrent RWKV/Mamba leaves roll back by value); use "
                    "verify='scan' for this bundle")
            if getattr(service.bundle, "step_fn", None) is None:
                raise ValueError(
                    "parallel verify needs the bundle's multi-token cached "
                    "step_fn; this bundle has none: use verify='scan'")
            make = make_verify_chunk_paged if service.paged \
                else make_verify_chunk
            self._verify_chunk = make(service.bundle.step_fn,
                                      service._batch_axes,
                                      service._seq_axes)
        elif not service.parallel_safe:
            # recurrent leaves: the alive-masked scan (rollback by value);
            # pure-KV scan mode runs the service's own _decode_scan
            make = make_verify_scan_paged if service.paged \
                else make_verify_scan
            self._verify_scan = make(service.bundle.decode_fn,
                                     service._batch_axes, service._seq_axes)
        self.drafted = 0       # draft tokens submitted for verification
        self.accepted = 0      # draft tokens accepted
        self.accepts: dict[int, int] = {}  # per-session accepted counts
        reg = service.metrics_registry
        self._c_drafted = reg.counter("spec_drafted_total", service="lm",
                                      verify=verify)
        self._c_accepted = reg.counter("spec_accepted_total", service="lm",
                                       verify=verify)
        self.last_device_accepts = None  # (S,) of the latest dispatch

    # -- introspection ------------------------------------------------------
    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    def stats(self) -> dict:
        return {"k": self.k, "verify": self.verify, "drafted": self.drafted,
                "accepted": self.accepted,
                "acceptance_rate": self.acceptance_rate,
                "accepts": dict(self.accepts)}

    # -- dispatch plumbing --------------------------------------------------
    def _dispatch(self, tok, pos, draft, n_draft, n_steps) -> np.ndarray:
        """One batched verify over the grid: ys (S, K+1) on the host."""
        svc = self.svc
        shape = f"V{self.k + 1}"
        inp = np.concatenate([tok[:, None], draft], axis=1)
        t0 = time.perf_counter()
        with svc.tracer.span("verify", cat="spec", shape=shape,
                             mode=self.verify,
                             lanes=int((n_steps > 0).sum())):
            if self.verify == "parallel":
                # inactive lanes are restored by value, but their K+1-row
                # write must still land inside the cache
                pos = np.minimum(pos, svc.seq_cap - self.k - 1)
                host = (inp, pos, n_steps > 0, n_draft)
            elif not svc.parallel_safe:
                # recurrent leaves: the alive-masked verify scan
                host = (tok, pos, draft, n_draft, n_steps > 0)
            else:
                # pure-KV exact mode: the service's own decode scan, drafts
                # as forced tokens; steps past a mismatch write rows past
                # the accepted position, dead by position
                host = (tok, pos, inp, n_steps, n_steps, n_draft)
            lo, hi = svc._slot_lo, svc._slot_hi  # this rank's lanes
            host = tuple(a[lo:hi] for a in host)
            if svc.paged:
                host += (svc._table,)
            args = svc._upload(*host)
            tb = args[-1:] if svc.paged else []
            if self.verify == "parallel":
                inp_d, pos_d, act_d, nd_d = args[:4]
                cache, ys_d = self._verify_chunk(
                    svc._params, svc._cache(), *tb, inp_d, pos_d,
                    act_d.bool())
                draft_d = inp_d[:, 1:]
            elif not svc.parallel_safe:
                tok_d, pos_d, draft_d, nd_d, act_d = args[:5]
                cache, ys_d = self._verify_scan(
                    svc._params, svc._cache(), *tb, tok_d, pos_d, draft_d,
                    nd_d, act_d.bool())
            else:
                draft_d, nd_d = args[2][:, 1:], args[5]
                cache, _, _, ys_d = svc._decode_scan(
                    svc._params, svc._cache(), *tb, *args[:5])
            svc._set_cache(cache)
            acc = acceptance_stats(ys_d, draft_d, nd_d) \
                if svc.device_counters else None
            if svc._slot_entry is not None:  # every rank's lanes
                ys_d = svc._gather_slots(ys_d)
                if acc is not None:
                    acc = svc._gather_slots(acc)
            ys = ys_d.cpu().numpy()
        svc._record_dispatch(time.perf_counter() - t0, shape)
        if acc is not None:
            self.last_device_accepts = acc.cpu().numpy()
            svc.metrics_registry.counter(
                "spec_device_accepted_total", service="lm").inc(
                    int(self.last_device_accepts.sum()))
        return ys

    # -- the speculative hot path -------------------------------------------
    @torch.no_grad()
    def decode(self, want: dict[int, int]) -> dict[int, list[int]]:
        """Generate ``want[sid]`` tokens per session, speculatively.  A
        still-pending prompt is consumed through the service first (its
        tokens are known: prefill, not speculation); then draft-verify
        dispatches of up to K+1 tokens per lane, the last draft of a
        request cut to its remaining budget."""
        svc = self.svc
        svc._validate_want(want)

        out = {sid: [] for sid in want}
        remaining = {sid: n for sid, n in want.items() if n > 0}
        pending = [sid for sid in remaining
                   if svc.sessions[sid].steps < len(svc.sessions[sid].prompt)]
        if pending:
            for sid, toks in svc.decode({sid: 1 for sid in pending}).items():
                out[sid] += toks
                remaining[sid] -= len(toks)

        while True:
            live = {sid: r for sid, r in remaining.items()
                    if r > 0 and not svc.sessions[sid].done}
            if not live:
                break
            if self.verify == "parallel":
                # lanes too close to the cap for a K+1-row block finish on
                # the plain scan (at most K+1 tokens left to the cap)
                tail = {sid: min(r, svc.seq_cap - svc.sessions[sid].steps)
                        for sid, r in live.items()
                        if svc.sessions[sid].steps + self.k + 1 > svc.seq_cap}
                if tail:
                    for sid, toks in svc.decode(tail).items():
                        out[sid] += toks
                        remaining[sid] -= len(toks)
                    continue
            svc._touch_and_bind(live)

            S, K = svc.n_slots, self.k
            draft = np.zeros((S, K), np.int32)
            n_draft = np.zeros(S, np.int32)
            n_steps = np.zeros(S, np.int32)
            tok = np.zeros(S, np.int32)
            pos = np.zeros(S, np.int32)
            # bound lanes not verified carry their true (clamped) position,
            # the decode scan's masked-step rule
            for slot, bsid in svc.sched.sid_of.items():
                pos[slot] = min(svc.sessions[bsid].steps, svc.seq_cap - 1)
            lanes = {}
            for sid, rem in live.items():
                sess = svc.sessions[sid]
                s = svc.sched.slot_of[sid]
                lanes[sid] = s
                ks = max(min(K, rem - 1, svc.seq_cap - sess.steps - 1), 0)
                hist = np.concatenate(
                    [sess.prompt, np.asarray(svc.outputs[sid], np.int32)])
                d = np.asarray(self.drafter(hist, ks),
                               np.int32).reshape(-1)[:ks]
                draft[s, :d.size] = d
                n_draft[s] = d.size
                n_steps[s] = d.size + 1
                tok[s] = sess.tok
                pos[s] = sess.steps

            if not n_draft.any():
                # nothing to verify anywhere: a K+1-wide verify would spend
                # K+1 steps a token, so take one plain scan step instead
                for sid, toks in svc.decode({sid: 1 for sid in live}).items():
                    out[sid] += toks
                    remaining[sid] -= len(toks)
                continue
            if svc.paged:
                # parallel mode writes K+1 whole rows, either scan at most
                # n_steps; rejected rows' blocks are trimmed after
                for sid, s in lanes.items():
                    steps = svc.sessions[sid].steps
                    n = K + 1 if self.verify == "parallel" \
                        else int(n_steps[s])
                    svc._ensure_blocks(sid, steps,
                                       min(steps + n, svc.seq_cap))

            ys = self._dispatch(tok, pos, draft, n_draft, n_steps)

            for sid, s in lanes.items():
                sess = svc.sessions[sid]
                nd = int(n_draft[s])
                m = 0
                while m < nd and ys[s, m] == draft[s, m]:
                    m += 1
                emitted = [int(t) for t in ys[s, :m + 1]]
                self.drafted += nd
                self.accepted += m
                self._c_drafted.inc(nd)
                self._c_accepted.inc(m)
                self.accepts[sid] = self.accepts.get(sid, 0) + m
                svc.outputs[sid].extend(emitted)
                out[sid].extend(emitted)
                sess.steps += m + 1
                sess.tok = int(ys[s, m])
                remaining[sid] -= m + 1
                sess.last = {"tokens": emitted, "step": sess.steps,
                             "accepted": m}
                svc._trim_blocks(sid)
            for sid in lanes:
                if svc.sessions[sid].steps >= svc.seq_cap:
                    svc._retire(sid)
        return out
