"""Metrics registry — counters, gauges, fixed-bucket histograms.

One registry absorbs the serving stack's scattered ``stats()`` dicts into
a single flat, JSON-able namespace: recompile counts from the
ModelRunner/PackedVitSegments compile ledgers, planner merge/fuse/deadline
decisions and the modeled-vs-measured cost error (the calibration-drift
signal), quality-controller tighten events per keep level, padding-waste
and device-idle gauges, admission accept/degrade/reject counters, and the
traffic harness's SLO distributions.

Design constraints, in order:

* **Deterministic.** Histograms use fixed bucket edges chosen at creation
  (no adaptive resizing), so two runs over the same sample stream produce
  byte-identical snapshots. ``percentile`` reads return bucket upper
  edges — a quantized but machine-independent answer.
* **Additive.** The registry *absorbs* the existing ``stats()`` dicts
  (:meth:`MetricsRegistry.absorb` hoovers every numeric entry into a
  gauge); it does not replace them — tests and launchers keep reading the
  dicts they always read.
* **Cheap.** A metric is a tiny mutable object; recording is a dict
  lookup + add. Nothing here touches the device or the wall clock.

A process-wide default registry exists (:func:`registry`) for launchers
that want one sink; engines and the traffic harness accept an explicit
``MetricsRegistry`` so tests can isolate streams.
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "log_buckets", "registry", "reset_registry",
           "DEFAULT_MS_BUCKETS"]


def log_buckets(lo: float, hi: float, per_decade: int = 4
                ) -> Tuple[float, ...]:
    """Deterministic geometric bucket edges covering [lo, hi] with
    ``per_decade`` edges per decade. Edges are computed from integer
    exponents (not accumulated multiplication), so the same arguments
    always yield bit-identical edges."""
    if not (lo > 0.0 and hi > lo):
        raise ValueError(f"need 0 < lo < hi, got lo={lo}, hi={hi}")
    if per_decade < 1:
        raise ValueError(f"per_decade must be >= 1, got {per_decade}")
    k0 = math.floor(per_decade * math.log10(lo))
    k1 = math.ceil(per_decade * math.log10(hi))
    return tuple(10.0 ** (k / per_decade) for k in range(k0, k1 + 1))


# 1us .. 100s in ms units — wide enough for both virtual-clock SLO
# latencies (sub-ms at bench scale) and wall-clock step times
DEFAULT_MS_BUCKETS = log_buckets(1e-3, 1e5, per_decade=4)


class Counter:
    """Monotone event count."""

    kind = "counter"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counters are monotone; cannot add {n}")
        self.value += n

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-written value."""

    kind = "gauge"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket distribution; deterministic for a given sample stream.

    ``buckets`` are ascending upper edges; a sample lands in the first
    bucket whose edge is >= the sample, or the overflow bucket past the
    last edge. ``percentile`` is a nearest-rank read over the bucket
    counts: it returns the upper edge of the bucket containing the rank
    (quantized — exact percentiles stay with the raw-sample paths that
    need them, e.g. the traffic report)."""

    kind = "histogram"
    __slots__ = ("buckets", "counts", "count", "sum", "min", "max")

    def __init__(self, buckets: Sequence[float] = DEFAULT_MS_BUCKETS):
        edges = tuple(float(b) for b in buckets)
        if not edges or any(b <= a for a, b in zip(edges, edges[1:])):
            raise ValueError(f"bucket edges must be strictly ascending and "
                             f"non-empty, got {edges}")
        self.buckets = edges
        self.counts = [0] * (len(edges) + 1)  # [+ overflow]
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, v: float) -> None:
        v = float(v)
        lo, hi = 0, len(self.buckets)
        while lo < hi:  # first edge >= v
            mid = (lo + hi) // 2
            if self.buckets[mid] >= v:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile as a bucket upper edge (the overflow
        bucket reads as the observed max). NaN when empty."""
        if self.count == 0:
            return float("nan")
        rank = max(1, math.ceil(q / 100.0 * self.count))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return (self.buckets[i] if i < len(self.buckets)
                        else self.max)
        return self.max

    def snapshot(self) -> Dict[str, Any]:
        return {
            "type": "histogram",
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "p50": self.percentile(50) if self.count else None,
            "p95": self.percentile(95) if self.count else None,
            "p99": self.percentile(99) if self.count else None,
            "buckets": list(self.buckets),
            "counts": list(self.counts),
        }


class MetricsRegistry:
    """Lazily-created named metrics behind one flat namespace.

    ``counter(name)`` / ``gauge(name)`` / ``histogram(name)`` return the
    existing metric or create it; asking for an existing name with a
    different type raises (one name, one meaning)."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(*args)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is a {m.kind}, not a "
                            f"{cls.kind}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_MS_BUCKETS
                  ) -> Histogram:
        return self._get(name, Histogram, buckets)

    def absorb(self, prefix: str, stats: Dict[str, Any]) -> None:
        """Hoover every numeric entry of a ``stats()`` dict into gauges
        named ``<prefix>.<key>`` (non-numeric values — mode strings, level
        tuples — are skipped; record those explicitly if they matter)."""
        for k, v in stats.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            self.gauge(f"{prefix}.{k}").set(v)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able {name: metric snapshot}, name-sorted — the ``metrics``
        block of the schema-v4 bench envelope."""
        return {name: self._metrics[name].snapshot()
                for name in sorted(self._metrics)}

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, default=str)


_GLOBAL: Optional[MetricsRegistry] = None


def registry() -> MetricsRegistry:
    """The process-wide default registry (created on first use)."""
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = MetricsRegistry()
    return _GLOBAL


def reset_registry() -> MetricsRegistry:
    """Replace the process-wide registry with a fresh one (tests)."""
    global _GLOBAL
    _GLOBAL = MetricsRegistry()
    return _GLOBAL
