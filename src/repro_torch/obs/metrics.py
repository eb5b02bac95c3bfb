"""Zero-dependency metrics plane: Counter / Gauge / Histogram + registry.

The port of ``repro/obs/metrics.py``, pure Python: for the same sequence
of calls, ``snapshot()`` and ``prometheus()`` give the reference's output
byte for byte (tests/test_torch_obs.py).

  * ``Counter``   — monotonically increasing float/int (evictions,
    dispatches, enrolls);
  * ``Gauge``     — last-write-wins scalar (bound slots, parked bytes,
    occupancy of the most recent dispatch);
  * ``Histogram`` — log2-bucketed distribution for latency: bucket ``i``
    covers ``(2^(i-1), 2^i]``; ``percentile()`` interpolates
    geometrically inside the winning bucket and clamps to the observed
    min/max, so means are exact and quantiles within a factor of 2.

Metrics are keyed by (name, labels), labels a small dict (``service=``,
``shape=``, ``worker=`` ...).  ``snapshot()`` returns a pure-JSON tree
(what ``service.metrics()`` and ``plane.metrics()`` return);
``prometheus()`` renders the text exposition format.

The port's process-default registry (``default_registry()``) is its own
object, separate from the reference's.
"""

from __future__ import annotations

import json
import math
import threading
from typing import Iterable

# log2 buckets: index i holds samples in (2^(i-1), 2^i].  64 buckets cover
# [1, 2^63] — from 1 us to ~292k years when recording microseconds.
N_BUCKETS = 64


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter.  ``inc`` only; resets are a registry operation."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        self.value += n

    def to_dict(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1) -> None:
        self.value += n

    def dec(self, n: float = 1) -> None:
        self.value -= n

    def to_dict(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Log2-bucketed histogram (see module docstring for the bucket rule).

    Records non-negative values; values in [0, 1] land in bucket 0.  Keeps
    exact ``count``/``sum``/``min``/``max`` alongside the buckets, so means
    are exact and only quantiles are bucket-approximate."""

    __slots__ = ("buckets", "count", "sum", "min", "max")

    def __init__(self):
        self.buckets = [0] * N_BUCKETS
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, v: float) -> None:
        if v < 0:
            raise ValueError(f"histogram value must be >= 0, got {v}")
        i = 0 if v <= 1 else min(math.ceil(math.log2(v)), N_BUCKETS - 1)
        self.buckets[i] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def reset(self) -> None:
        """Drop all samples (e.g. after a warm-up, so first-call outliers
        never pollute steady-state tails)."""
        self.__init__()

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Approximate quantile ``q`` in [0, 100]: find the bucket holding
        the q-th sample, interpolate geometrically between its bounds
        (log-uniform assumption), clamp to the observed min/max."""
        if not 0 <= q <= 100:
            raise ValueError(f"percentile must be in [0, 100], got {q}")
        if self.count == 0:
            return 0.0
        rank = q / 100 * self.count
        seen = 0
        for i, n in enumerate(self.buckets):
            if n == 0:
                continue
            if seen + n >= rank:
                lo = 1.0 if i == 0 else float(2 ** (i - 1))
                hi = float(2 ** i)
                frac = (rank - seen) / n
                v = lo * (hi / lo) ** frac
                return float(min(max(v, self.min), self.max))
            seen += n
        return float(self.max)

    def to_dict(self) -> dict:
        # sparse bucket encoding: {exponent: count} for non-empty buckets
        return {"type": "histogram", "count": self.count, "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "p50": self.percentile(50), "p99": self.percentile(99),
                "buckets": {str(i): n for i, n in enumerate(self.buckets)
                            if n}}


def merge_histogram_rows(rows: Iterable[dict]) -> Histogram:
    """Merge ``snapshot()``-encoded histogram rows into one ``Histogram``.
    Log2 buckets ADD exactly (same fixed bounds everywhere), and count/
    sum/min/max recombine losslessly — only quantiles stay bucket-
    approximate, exactly as in any single histogram."""
    m = Histogram()
    for r in rows:
        if not r.get("count"):
            continue
        for i, n in r["buckets"].items():
            m.buckets[int(i)] += n
        m.count += r["count"]
        m.sum += r["sum"]
        m.min = min(m.min, r["min"])
        m.max = max(m.max, r["max"])
    return m


def latency_summary(rows: Iterable[dict], *, by: str | None = None) -> dict:
    """The latency schema: count/p50/p99/mean of the merged rows, plus
    (with ``by="shape"`` etc.) a per-label breakdown under ``by_<label>``
    (chip_smoke.py's plane phase reads the op latencies through it)."""
    rows = [r for r in rows if r.get("count")]
    m = merge_histogram_rows(rows)
    out = {
        "count": m.count,
        "p50_us": m.percentile(50),
        "p99_us": m.percentile(99),
        "mean_us": m.mean,
    }
    if by is not None:
        out[f"by_{by}"] = {r["labels"].get(by, "?"):
                           {"count": r["count"], "p50_us": r["p50"],
                            "p99_us": r["p99"]} for r in rows}
    return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Get-or-create store of (name, labels) -> metric.

    Thread-safe on the create path (an asyncio/worker front-end will share
    one registry across slot-grid workers); reads of plain int/float slots
    are atomic under CPython and need no lock."""

    def __init__(self):
        self._metrics: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def _get(self, kind: str, name: str, labels: dict):
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = _KINDS[kind]()
                    self._metrics[key] = m
        if not isinstance(m, _KINDS[kind]):
            raise TypeError(
                f"metric {name!r}{dict(labels)} already registered as "
                f"{type(m).__name__}, requested {kind}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", name, labels)

    def reset(self) -> None:
        """Reset every metric in place (handles stay valid)."""
        with self._lock:
            for m in self._metrics.values():
                m.__init__()

    # -- exposition ----------------------------------------------------------
    def snapshot(self) -> dict:
        """Pure-JSON tree: {name: [{labels: {...}, **metric}]}.  The shape
        ``service.metrics()`` returns."""
        out: dict[str, list] = {}
        for (name, lk), m in sorted(self._metrics.items()):
            out.setdefault(name, []).append(
                {"labels": dict(lk), **m.to_dict()})
        return out

    def to_json(self, **kw) -> str:
        return json.dumps(self.snapshot(), **kw)

    def prometheus(self) -> str:
        """Prometheus text exposition format (v0.0.4).  Histograms render
        cumulative ``le`` buckets at the log2 upper bounds plus the
        conventional ``_sum``/``_count`` series."""
        lines: list[str] = []
        typed: set[str] = set()
        for (name, lk), m in sorted(self._metrics.items()):
            kind = ("counter" if isinstance(m, Counter)
                    else "gauge" if isinstance(m, Gauge) else "histogram")
            if name not in typed:
                lines.append(f"# TYPE {name} {kind}")
                typed.add(name)
            if isinstance(m, Histogram):
                cum = 0
                for i, n in enumerate(m.buckets):
                    if n == 0:
                        continue
                    cum += n
                    lines.append(f"{name}_bucket"
                                 f"{_prom_labels(lk, le=float(2 ** i))} {cum}")
                lines.append(f"{name}_bucket{_prom_labels(lk, le='+Inf')} "
                             f"{m.count}")
                lines.append(f"{name}_sum{_prom_labels(lk)} {m.sum}")
                lines.append(f"{name}_count{_prom_labels(lk)} {m.count}")
            else:
                lines.append(f"{name}{_prom_labels(lk)} {m.value}")
        return "\n".join(lines) + ("\n" if lines else "")


def _prom_labels(lk: Iterable[tuple], **extra) -> str:
    pairs = list(lk) + [(k, v) for k, v in extra.items()]
    if not pairs:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in pairs)
    return "{" + body + "}"


# The process-default registry: what ServingPlane reports to when no
# registry is passed.  Tests and chip_smoke.py pass fresh ones.
DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return DEFAULT
