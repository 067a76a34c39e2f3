"""Span tracer — Chrome ``trace_event`` timelines for the serving stack.

One tracer serves two clocks:

* **Wall clock** (default): ``span(name, **attrs)`` as a context manager,
  or explicit ``begin``/``end`` around async stages. The engines emit
  per-step ``plan``/``stage`` spans and the ``StepPipeline`` emits
  ``dispatch``/``complete`` spans around its phases — where a step's wall
  time actually goes.
* **Virtual clock**: every API takes an explicit ``t_ms`` override. The
  traffic harness stamps spans with its deterministic replay timestamps —
  per-step ``plan``/``stage``/``dispatch``/``complete`` spans keyed by the
  ``StepReport``, and per-request lifecycle spans stitched from the
  Scheduler event stream — so the exported trace is byte-identical at any
  pipeline depth (the harness's timestamp guarantee, visible in Perfetto).

Export targets:

* :meth:`Tracer.chrome_trace` / :meth:`write_chrome_trace` — Chrome
  ``trace_event`` JSON (the ``{"traceEvents": [...]}`` envelope), loadable
  in Perfetto / ``chrome://tracing``. Tracks map to threads via
  ``thread_name`` metadata events.
* :meth:`Tracer.write_jsonl` — one closed span per line (name, track,
  start, duration, attrs) for ad-hoc grep/pandas analysis.

The hot path pays one attribute check when tracing is off: engines guard
emission with ``if tracer.enabled:`` and the default is the shared
:data:`NULL_TRACER` (an :class:`Tracer` subclass whose methods no-op).
Tracing must never perturb serving results — spans observe, they do not
reorder; the CI overhead guard asserts ``outputs_digest`` equality
between traced and untraced runs.

Span discipline is enforced: per track, ``begin``/``end`` must nest
(LIFO); mismatched or unbalanced ends raise. :func:`validate_chrome_trace`
re-checks an exported document (well-formed envelope, balanced B/E pairs,
monotonic per-track timestamps) — shared by the tests and the CI
trace-schema step.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "validate_chrome_trace"]


class _SpanCtx:
    """Context manager yielded by :meth:`Tracer.span` (wall clock)."""

    __slots__ = ("_tracer", "_name", "_track", "_attrs")

    def __init__(self, tracer, name, track, attrs):
        self._tracer = tracer
        self._name = name
        self._track = track
        self._attrs = attrs

    def __enter__(self):
        self._tracer.begin(self._name, track=self._track, **self._attrs)
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tracer.end(self._name, track=self._track)
        return False


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_CTX = _NullCtx()


class Tracer:
    """Collects spans; exports Chrome trace JSON and a JSONL span log.

    ``enabled=False`` builds a tracer whose emit methods return
    immediately (same surface, zero events) — the per-call cost the
    engines pay is one attribute check plus, when they skip the check, a
    cheap early return."""

    enabled: bool

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._t0 = time.perf_counter()
        # chrome events in emission order: (ph, name, tid, ts_us, attrs)
        self._events: List[Tuple[str, str, int, float,
                                 Optional[Dict[str, Any]]]] = []
        self._tracks: Dict[str, int] = {}      # track name -> tid
        self._stacks: Dict[int, List[Tuple[str, float,
                                           Optional[Dict[str, Any]]]]] = {}
        self._spans: List[Dict[str, Any]] = []  # closed spans (JSONL log)

    # -- clock / track plumbing --------------------------------------------
    def _ts_us(self, t_ms: Optional[float]) -> float:
        if t_ms is not None:
            return float(t_ms) * 1e3
        return (time.perf_counter() - self._t0) * 1e6

    def _tid(self, track: str) -> int:
        tid = self._tracks.get(track)
        if tid is None:
            tid = self._tracks[track] = len(self._tracks) + 1
        return tid

    # -- emission -----------------------------------------------------------
    def begin(self, name: str, track: str = "main",
              t_ms: Optional[float] = None, **attrs: Any) -> None:
        """Open a span on ``track`` (wall clock, or at virtual ``t_ms``)."""
        if not self.enabled:
            return
        ts = self._ts_us(t_ms)
        tid = self._tid(track)
        a = attrs or None
        self._events.append(("B", name, tid, ts, a))
        self._stacks.setdefault(tid, []).append((name, ts, a))

    def end(self, name: Optional[str] = None, track: str = "main",
            t_ms: Optional[float] = None) -> None:
        """Close the innermost span on ``track``; ``name``, when given,
        must match it (spans nest — the ordering invariant the tests
        assert)."""
        if not self.enabled:
            return
        tid = self._tid(track)
        stack = self._stacks.get(tid)
        if not stack:
            raise ValueError(f"end({name!r}) on track {track!r} with no "
                             f"open span")
        top, ts0, attrs = stack.pop()
        if name is not None and name != top:
            stack.append((top, ts0, attrs))
            raise ValueError(f"end({name!r}) does not match open span "
                             f"{top!r} on track {track!r} (spans nest)")
        ts = self._ts_us(t_ms)
        if ts < ts0 - 1e-9:
            stack.append((top, ts0, attrs))
            raise ValueError(f"span {top!r} on track {track!r} ends at "
                             f"{ts}us before it began at {ts0}us")
        self._events.append(("E", top, tid, ts, None))
        self._spans.append({"name": top, "track": track,
                            "ts_ms": ts0 / 1e3,
                            "dur_ms": (ts - ts0) / 1e3,
                            "attrs": attrs or {}})

    def instant(self, name: str, track: str = "main",
                t_ms: Optional[float] = None, **attrs: Any) -> None:
        """Zero-duration marker (Chrome ``i`` event)."""
        if not self.enabled:
            return
        self._events.append(("i", name, self._tid(track),
                             self._ts_us(t_ms), attrs or None))

    def span(self, name: str, track: str = "main", **attrs: Any):
        """Wall-clock span context manager (``with tracer.span("plan"):``).
        Disabled tracers return a shared no-op context."""
        if not self.enabled:
            return _NULL_CTX
        return _SpanCtx(self, name, track, attrs)

    # -- introspection ------------------------------------------------------
    @property
    def event_count(self) -> int:
        return len(self._events)

    @property
    def span_log(self) -> List[Dict[str, Any]]:
        """Closed spans in completion order (the JSONL payload)."""
        return list(self._spans)

    def open_spans(self) -> List[str]:
        return [name for stack in self._stacks.values()
                for name, _, _ in stack]

    # -- export -------------------------------------------------------------
    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome ``trace_event`` JSON document (Perfetto-loadable).
        Raises if any span is still open — an unbalanced trace would fail
        its own validator."""
        still_open = self.open_spans()
        if still_open:
            raise ValueError(f"cannot export with open spans: {still_open}")
        events: List[Dict[str, Any]] = []
        for track, tid in sorted(self._tracks.items(), key=lambda kv: kv[1]):
            events.append({"ph": "M", "name": "thread_name", "pid": 1,
                           "tid": tid, "args": {"name": track}})
        for ph, name, tid, ts, attrs in self._events:
            ev: Dict[str, Any] = {"ph": ph, "name": name, "pid": 1,
                                  "tid": tid, "ts": ts}
            if ph == "i":
                ev["s"] = "t"
            if attrs:
                ev["args"] = attrs
            events.append(ev)
        return {"displayTimeUnit": "ms", "traceEvents": events}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, default=str)

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for rec in self._spans:
                f.write(json.dumps(rec, default=str) + "\n")


class NullTracer(Tracer):
    """The disabled default: same surface, no storage, no clock reads.
    Engines keep a ``self.tracer`` unconditionally and guard hot-path
    emission with ``if self.tracer.enabled:`` — one attribute check."""

    def __init__(self):
        # deliberately NOT calling super().__init__: no clock read, no
        # buffers — a NullTracer is free to construct and share
        self.enabled = False

    def begin(self, name, track="main", t_ms=None, **attrs):
        pass

    def end(self, name=None, track="main", t_ms=None):
        pass

    def instant(self, name, track="main", t_ms=None, **attrs):
        pass

    def span(self, name, track="main", **attrs):
        return _NULL_CTX

    @property
    def event_count(self) -> int:
        return 0

    @property
    def span_log(self):
        return []

    def open_spans(self):
        return []

    def chrome_trace(self):
        return {"displayTimeUnit": "ms", "traceEvents": []}


NULL_TRACER = NullTracer()


def validate_chrome_trace(doc: Any) -> Dict[str, int]:
    """Validate a Chrome ``trace_event`` document: well-formed envelope,
    required event fields, balanced B/E pairs per track (stack
    discipline), and monotonic (non-decreasing) per-track timestamps in
    emission order. Returns summary counts; raises ``ValueError`` on the
    first violation. Shared by the tests and the CI trace-schema step."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("not a trace_event document: missing traceEvents")
    events = doc["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    stacks: Dict[Tuple[Any, Any], List[str]] = {}
    last_ts: Dict[Tuple[Any, Any], float] = {}
    n_spans = 0
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not an object")
        for field in ("ph", "name", "pid", "tid"):
            if field not in ev:
                raise ValueError(f"event {i}: missing {field!r}")
        ph = ev["ph"]
        if ph == "M":
            continue
        if "ts" not in ev:
            raise ValueError(f"event {i}: missing 'ts'")
        key = (ev["pid"], ev["tid"])
        ts = float(ev["ts"])
        if ts < last_ts.get(key, -float("inf")) - 1e-9:
            raise ValueError(f"event {i}: track {key} timestamp {ts} "
                             f"decreases (last {last_ts[key]})")
        last_ts[key] = ts
        if ph == "B":
            stacks.setdefault(key, []).append(ev["name"])
        elif ph == "E":
            stack = stacks.get(key)
            if not stack:
                raise ValueError(f"event {i}: E {ev['name']!r} on track "
                                 f"{key} with no open B")
            top = stack.pop()
            if top != ev["name"]:
                raise ValueError(f"event {i}: E {ev['name']!r} does not "
                                 f"match open B {top!r} on track {key}")
            n_spans += 1
        elif ph not in ("i", "I", "X", "C"):
            raise ValueError(f"event {i}: unsupported phase {ph!r}")
    unbalanced = {k: v for k, v in stacks.items() if v}
    if unbalanced:
        raise ValueError(f"unbalanced B events: {unbalanced}")
    return {"events": len(events), "spans": n_spans,
            "tracks": len(last_ts)}
