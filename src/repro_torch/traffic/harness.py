"""Trace-replay harness — SLO accounting on a virtual clock; the port of
the reference package's ``traffic/harness.py``.

Replays a :class:`~repro_torch.traffic.workload.Trace` against either serving
engine and reports the numbers an operator actually cares about: p50/p95/
p99 latency, time-to-first-dispatch, goodput vs offered load, deadline-
miss rate, rejection rate, queue-depth peaks.

**The clock is virtual.** Each engine tick returns a host-deterministic
:class:`~repro_torch.serving.pipeline.StepReport`; the harness advances ``now``
by the *modeled* price of the dispatched step — the vision engine's
committed ``ExecutionPlan`` cycles through the calibrated
``TileCostModel`` (``modeled_ms``), the LM engine's dispatched token
count priced at configured per-token rates (``work_tokens``). When the
engine is idle, time jumps straight to the next trace arrival. Two
consequences, both load-bearing:

* Every timestamp — and therefore every SLO verdict — is a deterministic
  function of (trace, engine config, admission limit). Same seed, same
  numbers, on any machine, at any real-time speed.
* Pipeline depth changes WALL time but not VIRTUAL time: the engines
  make identical plans at any depth, so the same trace yields
  byte-identical lifecycle records at depth 1 and depth 2 (tests assert
  this). Plans are host decisions, so the records do not depend on the
  device either: a replay on the card and on the CPU agree.

Deadlines are accounted HERE, not inside the engines: the engines'
deadline logic (`deadline_ms` on requests) is wall-clock-driven and would
couple the verdicts to real time. The harness keeps each trace request's
``deadline_ms`` as a virtual-clock SLO: a request meets its deadline iff
``retire_ms - arrival_ms <= deadline_ms``.

Drivers adapt the two engines' incremental APIs (``enqueue`` / ``tick`` /
``finish``) behind one interface; :class:`TrafficHarness` owns the replay
loop, the lifecycle records, and the report. The harness is host code:
request content is made with numpy and enters the device through the
engines, which own it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.traffic.admission import AdmissionController
from repro_torch.traffic.workload import Trace, TraceRequest

__all__ = ["RequestRecord", "VisionDriver", "LMDriver", "TrafficHarness",
           "outputs_digest", "percentile"]


def outputs_digest(out: Dict[int, Any]) -> str:
    """Order-independent sha256 over per-uid outputs (float32 logits or
    int64 token lists) — equal digests mean bit-identical serving results
    (the harness-vs-direct-serve equivalence check compares these)."""
    h = hashlib.sha256()
    for uid in sorted(out):
        v = np.asarray(out[uid])
        v = v.astype(np.float32) if np.issubdtype(v.dtype, np.floating) \
            else v.astype(np.int64)
        h.update(v.tobytes())
    return h.hexdigest()


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (deterministic, no interpolation)."""
    if not values:
        return float("nan")
    v = sorted(values)
    idx = max(0, math.ceil(q / 100.0 * len(v)) - 1)
    return float(v[idx])


@dataclasses.dataclass
class RequestRecord:
    """One request's lifecycle on the virtual clock (all ms)."""

    uid: int
    arrival_ms: float
    deadline_ms: Optional[float] = None
    submit_ms: Optional[float] = None          # handed to the engine
    first_dispatch_ms: Optional[float] = None  # entered a slot (step start)
    retire_ms: Optional[float] = None          # final segment/token step end
    rejected: bool = False

    @property
    def latency_ms(self) -> Optional[float]:
        if self.retire_ms is None:
            return None
        return self.retire_ms - self.arrival_ms

    @property
    def ttfd_ms(self) -> Optional[float]:
        if self.first_dispatch_ms is None:
            return None
        return self.first_dispatch_ms - self.arrival_ms

    @property
    def deadline_met(self) -> Optional[bool]:
        """True/False once retired (no deadline = met); None while open
        or rejected."""
        lat = self.latency_ms
        if lat is None:
            return None
        return self.deadline_ms is None or lat <= self.deadline_ms


# ===========================================================================
# Engine drivers
# ===========================================================================
class VisionDriver:
    """Adapts :class:`~repro_torch.serving.vision.VisionEngine`. Patch tensors
    are materialized deterministically from each trace record's
    ``content_seed`` (standard-normal pixels — the same distribution the
    launch generators use), so a replayed trace reproduces byte-identical
    inputs without storing pixels."""

    kind = "vision"

    def __init__(self, engine):
        self.engine = engine
        self._pdim = engine.cfg.patch_size ** 2 * 3

    @property
    def scheduler(self):
        return self.engine.scheduler

    def materialize(self, tr: TraceRequest):
        from repro_torch.serving.vision import VisionRequest
        rng = np.random.default_rng(tr.content_seed)
        patches = rng.standard_normal(
            (tr.n_patches, self._pdim)).astype(np.float32)
        # NOTE: tr.deadline_ms stays harness-side (virtual-clock SLO);
        # the engine's own deadline logic is wall-clock-driven and would
        # make the replay nondeterministic.
        return VisionRequest(uid=tr.uid, patches=patches, r_t=tr.r_t,
                             keep_schedule=tr.keep_schedule,
                             quality=tr.quality, soft_prune=tr.soft_prune)

    def start(self) -> None:
        pass

    def enqueue(self, reqs: Sequence[Any]) -> None:
        self.engine.enqueue(reqs)

    def tick(self, out: Dict[int, Any]):
        return self.engine.tick(out)

    def busy(self) -> bool:
        return bool(self.engine._pending) or self.scheduler.has_work()

    def finish(self) -> None:
        self.engine.finish()

    def price_ms(self, report) -> float:
        return report.modeled_ms

    def make_admission(self, limit_ms: float) -> AdmissionController:
        return AdmissionController.for_vision(self.engine, limit_ms)


class LMDriver:
    """Adapts :class:`~repro_torch.serving.engine.ServeEngine` (continuous
    path). The LM engines carry no accelerator cost model, so steps are
    priced at a configured per-token rate: ``per_token_ms`` per
    prefilled/decoded token — the ``work_tokens`` the StepReport
    counts."""

    kind = "lm"

    def __init__(self, engine, per_token_ms: float = 1.0):
        if per_token_ms <= 0.0:
            raise ValueError(f"per_token_ms must be positive, "
                             f"got {per_token_ms}")
        self.engine = engine
        self.per_token_ms = float(per_token_ms)

    @property
    def scheduler(self):
        return self.engine.scheduler

    def materialize(self, tr: TraceRequest):
        from repro_torch.serving.engine import Request
        rng = np.random.default_rng(tr.content_seed)
        vocab = self.engine.cfg.vocab_size
        prompt = rng.integers(0, vocab, size=max(tr.prompt_tokens, 1),
                              dtype=np.int32)
        return Request(uid=tr.uid, prompt=prompt,
                       max_new_tokens=tr.max_new_tokens)

    def start(self) -> None:
        self.engine.start_continuous()

    def enqueue(self, reqs: Sequence[Any]) -> None:
        self.engine.enqueue(reqs)

    def tick(self, out: Dict[int, Any]):
        return self.engine.tick_continuous(out)

    def busy(self) -> bool:
        return self.scheduler.has_work()

    def finish(self) -> None:
        self.engine.pipeline.flush()

    def price_ms(self, report) -> float:
        return self.per_token_ms * report.work_tokens

    def request_ms(self, req) -> float:
        """Modeled full cost of an LM request under the per-token rate
        (the admission pricer)."""
        return self.per_token_ms * (len(req.prompt) + req.max_new_tokens)

    def make_admission(self, limit_ms: float) -> AdmissionController:
        def backlog_ms(_e=self.engine):
            ms = sum(self.request_ms(r) for r in _e.scheduler.waiting)
            for uid, req in ((r.uid, r)
                             for r in _e.scheduler.running.values()):
                left = req.max_new_tokens - _e._scheduled.get(uid, 0)
                ms += self.per_token_ms * max(left, 0)
            return ms

        return AdmissionController(limit_ms, cost_ms=self.request_ms,
                                   backlog_ms=backlog_ms)


# ===========================================================================
# Harness
# ===========================================================================
class TrafficHarness:
    """Replays a trace through a driver on the virtual clock.

    ``admission_limit_ms`` (optional) builds + installs the driver's
    :class:`AdmissionController` on the engine's Scheduler before the
    replay. Without it, admission is unbounded: the engine serves what a direct
    ``serve()`` call on the same requests serves (LM tokens equal; vision
    logits within the engine's tolerance, as tiles may group otherwise).

    ``tracer`` (optional, ``repro_torch.obs``) makes the replay emit
    virtual-clock spans: per dispatched step, nested
    ``plan``/``stage``/``dispatch``/``complete`` spans keyed by the
    :class:`StepReport` on a shared ``steps`` track (host work is free on
    the virtual clock, so plan/stage are zero-width and dispatch spans
    the step's modeled price), and — after the replay — one lifecycle
    track per request (``enqueue``/``queued``/``serve`` spans, rejects as
    instants) stitched from the same records the report is built from.
    Every timestamp is virtual, so the exported Chrome trace is
    byte-identical at any pipeline depth (tests assert this).

    ``metrics`` (optional) records the SLO distributions into
    fixed-bucket histograms (``traffic.latency_ms`` / ``traffic.ttfd_ms``
    / ``traffic.queue_depth`` — their snapshot p50/p95/p99 are histogram
    reads of the same data the report's exact nearest-rank percentiles
    summarize) plus offered/completed/rejected counters and the
    admission/scheduler stats."""

    def __init__(self, driver, admission_limit_ms: Optional[float] = None,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.driver = driver
        self.controller: Optional[AdmissionController] = None
        if admission_limit_ms is not None:
            self.controller = driver.make_admission(admission_limit_ms)
            self.controller.install(driver.scheduler)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics
        self.records: Dict[int, RequestRecord] = {}
        self.outputs: Dict[int, Any] = {}
        self.queue_depth_samples: List[int] = []
        self.virtual_ms = 0.0

    # -- replay ------------------------------------------------------------
    def run(self, trace: Trace) -> Dict[str, Any]:
        if trace.kind != self.driver.kind:
            raise ValueError(f"trace kind {trace.kind!r} does not match "
                             f"driver kind {self.driver.kind!r}")
        drv, sched = self.driver, self.driver.scheduler
        reqs = trace.requests
        self.records = {tr.uid: RequestRecord(
            uid=tr.uid, arrival_ms=tr.arrival_ms,
            deadline_ms=tr.deadline_ms) for tr in reqs}
        out: Dict[int, Any] = {}
        drv.start()
        now = 0.0
        i = 0            # next not-yet-submitted trace index
        ev_mark = len(sched.events)
        while i < len(reqs) or drv.busy():
            if not drv.busy() and i < len(reqs):
                # idle: jump the clock to the next arrival
                now = max(now, reqs[i].arrival_ms)
            due = []
            while i < len(reqs) and reqs[i].arrival_ms <= now + 1e-9:
                due.append(reqs[i])
                i += 1
            if due:
                batch = [drv.materialize(tr) for tr in due]
                for tr in due:
                    self.records[tr.uid].submit_ms = now
                drv.enqueue(batch)
            report = drv.tick(out)
            # rejects surface as scheduler events (LM: at enqueue; vision:
            # inside the tick's admission pass) — scan incrementally
            for kind, payload in sched.events[ev_mark:]:
                if kind == "reject":
                    rec = self.records[payload]
                    rec.rejected = True
            ev_mark = len(sched.events)
            if report.dispatched:
                for uid in report.admitted:
                    self.records[uid].first_dispatch_ms = now
                price = drv.price_ms(report)
                if self.tracer.enabled:
                    self._trace_step(len(self.queue_depth_samples), now,
                                     price, report)
                now += price
                for uid in report.completed:
                    self.records[uid].retire_ms = now
                self.queue_depth_samples.append(sched.queue_depth)
        drv.finish()
        self.outputs = out
        self.virtual_ms = now
        if self.tracer.enabled:
            self._trace_lifecycles()
        if self.metrics is not None:
            self._record_metrics()
        return self.report(trace)

    # -- observability export ----------------------------------------------
    def _trace_step(self, idx: int, t0: float, price_ms: float,
                    report: Any) -> None:
        """One dispatched step's virtual-clock spans. Host-side phases are
        free on the virtual clock by construction (only modeled device
        cost advances it), so ``plan``/``stage`` are zero-width markers at
        the step start, ``dispatch`` spans the modeled price, and
        ``complete`` closes at the step end — all nested in a ``step``
        span carrying the StepReport facts."""
        tr = self.tracer
        t1 = t0 + price_ms
        tr.begin("step", track="steps", t_ms=t0, step=idx,
                 modeled_ms=price_ms, admitted=list(report.admitted),
                 completed=list(report.completed))
        tr.begin("plan", track="steps", t_ms=t0)
        tr.end("plan", track="steps", t_ms=t0)
        tr.begin("stage", track="steps", t_ms=t0)
        tr.end("stage", track="steps", t_ms=t0)
        tr.begin("dispatch", track="steps", t_ms=t0)
        tr.end("dispatch", track="steps", t_ms=t1)
        tr.begin("complete", track="steps", t_ms=t1)
        tr.end("complete", track="steps", t_ms=t1)
        tr.end("step", track="steps", t_ms=t1)

    def _trace_lifecycles(self) -> None:
        """Per-request lifecycle spans on per-uid tracks, from the same
        records the report reads (themselves stitched from the
        Scheduler's unified event stream via the StepReports):
        ``enqueue`` (arrival -> handed to the engine), ``queued`` (waiting
        for a slot), ``serve`` (first dispatch -> retire); rejected
        requests get a ``reject`` instant. Unfinished phases (still-open
        requests) emit nothing — the trace stays balanced."""
        tr = self.tracer
        for r in sorted(self.records.values(), key=lambda r: r.uid):
            track = f"req {r.uid}"
            if r.rejected:
                tr.instant("reject", track=track, uid=r.uid,
                           t_ms=(r.submit_ms if r.submit_ms is not None
                                 else r.arrival_ms))
                continue
            if r.submit_ms is not None:
                tr.begin("enqueue", track=track, t_ms=r.arrival_ms,
                         uid=r.uid, deadline_ms=r.deadline_ms)
                tr.end("enqueue", track=track, t_ms=r.submit_ms)
                if r.first_dispatch_ms is not None:
                    tr.begin("queued", track=track, t_ms=r.submit_ms)
                    tr.end("queued", track=track, t_ms=r.first_dispatch_ms)
            if r.first_dispatch_ms is not None and r.retire_ms is not None:
                tr.begin("serve", track=track, t_ms=r.first_dispatch_ms,
                         uid=r.uid, latency_ms=r.latency_ms,
                         deadline_met=r.deadline_met)
                tr.end("serve", track=track, t_ms=r.retire_ms)

    def _record_metrics(self) -> None:
        """Fold the replay's SLO data into the metrics registry (called
        once, at the end of :meth:`run`)."""
        mx = self.metrics
        lat = mx.histogram("traffic.latency_ms")
        ttfd = mx.histogram("traffic.ttfd_ms")
        for r in self.records.values():
            if r.rejected:
                mx.counter("traffic.rejected").inc()
                continue
            if r.ttfd_ms is not None:
                ttfd.record(r.ttfd_ms)
            if r.latency_ms is not None:
                lat.record(r.latency_ms)
                mx.counter("traffic.completed").inc()
                if r.deadline_met is False:
                    mx.counter("traffic.deadline_missed").inc()
        qd = mx.histogram("traffic.queue_depth",
                          buckets=tuple(float(d) for d in range(65)))
        for d in self.queue_depth_samples:
            qd.record(d)
        mx.counter("traffic.offered").inc(len(self.records))
        mx.absorb("traffic.sched", self.driver.scheduler.stats())
        if self.controller is not None:
            mx.absorb("traffic.admission", self.controller.stats())

    # -- reporting ---------------------------------------------------------
    def report(self, trace: Trace) -> Dict[str, Any]:
        recs = list(self.records.values())
        done = [r for r in recs if r.retire_ms is not None]
        lat = [r.latency_ms for r in done]
        ttfd = [r.ttfd_ms for r in recs if r.ttfd_ms is not None]
        met = [r for r in done if r.deadline_met]
        with_dl = [r for r in done if r.deadline_ms is not None]
        missed = [r for r in with_dl if not r.deadline_met]
        span_s = max(self.virtual_ms, 1e-9) * 1e-3
        sched_stats = self.driver.scheduler.stats()
        rep: Dict[str, Any] = {
            "offered": len(recs),
            "offered_rps": trace.offered_load_rps,
            "completed": len(done),
            "rejected": sum(1 for r in recs if r.rejected),
            "virtual_ms": self.virtual_ms,
            "throughput_rps": len(done) / span_s,
            # goodput counts only deadline-MET completions: under
            # unbounded queueing past the knee it collapses even though
            # throughput holds, which is the whole point of admission
            "goodput_rps": len(met) / span_s,
            "deadline_total": len(with_dl),
            "deadline_missed": len(missed),
            "deadline_miss_rate": (len(missed) / len(with_dl)
                                   if with_dl else 0.0),
            "latency_p50_ms": percentile(lat, 50),
            "latency_p95_ms": percentile(lat, 95),
            "latency_p99_ms": percentile(lat, 99),
            "ttfd_p50_ms": percentile(ttfd, 50),
            "ttfd_p95_ms": percentile(ttfd, 95),
            "peak_queue_depth": sched_stats["peak_queue_depth"],
            "mean_queue_depth": (float(np.mean(self.queue_depth_samples))
                                 if self.queue_depth_samples else 0.0),
            "outputs_digest": outputs_digest(self.outputs),
        }
        if self.controller is not None:
            rep["admission"] = self.controller.stats()
        return rep

    def lifecycle(self) -> List[Tuple[Any, ...]]:
        """Per-request lifecycle tuples, uid-sorted — the cross-depth
        determinism tests compare these wholesale."""
        return [(r.uid, r.arrival_ms, r.submit_ms, r.first_dispatch_ms,
                 r.retire_ms, r.rejected)
                for r in sorted(self.records.values(), key=lambda r: r.uid)]
