"""StepPipeline — pipelined step execution shared by both serving engines.

The paper's accelerator overlaps on-the-fly token pruning with compute via
multi-level parallelism; the software engines used to run every step
synchronously (plan -> dispatch -> block), leaving the host idle while the
device ran and vice versa. This module is the runtime half of the fix: a
step is split into three phases and only the last one ever waits.

    stage     (engine) build the ExecutionPlan and the padded input
              buffers for step N. Pure host bookkeeping plus data-movement
              ops on device handles — it mutates no shared engine state it
              cannot roll back, so a staged step can still be dropped and
              replanned (e.g. a request was submitted mid-step and belongs
              in this plan).
    dispatch  (pipeline) enqueue step N's segment calls. PyTorch's CUDA
              launches return immediately; nothing here blocks. The
              pipeline then records one CUDA event behind the step's
              work. Host mirrors (seg_idx, cache lengths, token
              chains) advance now, because they are deterministic given
              the plan — the enabler for computing plan N+1 while the
              device still executes plan N.
    complete  (pipeline) synchronize on step N's event and materialize
              host-visible results (logits, whose copies to pinned host
              memory were enqueued at dispatch).

``depth`` bounds how many dispatched-but-incomplete steps may be in
flight. Depth 1 completes each step inside :meth:`submit` — bit-exact,
step-for-step identical to the old synchronous loops. Depth 2
double-buffers: while the device executes step N, the host stages step
N+1, and step N is completed only when N+1's dispatch has been enqueued.
Results are bit-exact at any depth — the pipeline reorders *waiting*, not
math: every step's inputs are fully determined at its stage time.

This module owns the engine's ONLY wait on the device (the event's
``synchronize`` in :meth:`StepPipeline._complete_oldest`); everything
upstream must hand the pipeline handles instead of blocking. On the CPU
there is no event: eager CPU work is done when dispatch returns.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Optional

import torch

from repro_torch.obs.trace import NULL_TRACER, Tracer

__all__ = ["StagedStep", "StepPipeline", "StepReport"]


@dataclasses.dataclass(frozen=True)
class StepReport:
    """What one engine ``tick`` did, in host-deterministic terms.

    Both engines' incremental step APIs (``VisionEngine.tick``,
    ``ServeEngine.tick_continuous``) return one of these so external
    callers — a trace-replay harness foremost — can
    account request lifecycles on a *virtual* clock: every field is known
    at dispatch time from host bookkeeping alone (no device sync), and is
    identical at every pipeline depth for the same request stream.

    ``dispatched``   — whether the tick put a step on the device (False =
                       idle bookkeeping tick: nothing admitted/running).
    ``modeled_ms``   — the cost model's price of the dispatched step
                       (vision: the committed ``ExecutionPlan``'s modeled
                       cycles; LM engines leave it 0 and report
                       ``work_tokens`` for the caller to price).
    ``work_tokens``  — tokens this step dispatched (LM: prefilled +
                       decoded; vision engines leave it 0).
    ``admitted``     — uids that entered slots this tick (their first
                       segment/prefill dispatches in this very step).
    ``completed``    — uids whose final segment/token was dispatched this
                       tick; their host-visible outputs materialize when
                       the pipeline completes the step.
    """

    dispatched: bool
    modeled_ms: float = 0.0
    work_tokens: int = 0
    admitted: tuple = ()
    completed: tuple = ()


@dataclasses.dataclass
class StagedStep:
    """One fully-staged engine step awaiting dispatch.

    ``dispatch`` enqueues the device work and returns the output handles
    to block on; ``complete`` runs after the block and materializes
    host-visible results; ``rollback`` (optional) undoes any host-mirror
    mutations staging made, so the step can be dropped pre-dispatch when a
    replan invalidates it (mid-step submission). Once dispatched, a step
    can no longer be dropped — device work is in flight."""

    dispatch: Callable[[], Any]
    complete: Callable[[Any], None]
    rollback: Optional[Callable[[], None]] = None
    label: str = ""
    handles: Any = None
    dispatched: bool = False
    completed: bool = False
    modeled_ms: float = 0.0   # the cost model's price of this step (vision
    # engines set it from the staged ExecutionPlan; 0 = unmodeled). Paired
    # with the measured dispatch+block wall time at completion, this is
    # the per-step modeled-vs-measured sample behind the calibration-drift
    # metric (pipeline stats: modeled_ms_total / measured_ms_total).
    dispatch_wall_s: float = 0.0  # wall seconds this step's dispatch took
    # (pipeline-recorded; the complete phase adds its block time to form
    # the measured cost)
    event: Optional["torch.cuda.Event"] = None  # recorded on the device's
    # current stream right after dispatch (None on the CPU)


class StepPipeline:
    """Bounded in-flight window of engine steps.

    ``depth`` = max steps dispatched but not yet completed. ``submit``
    dispatches the new step, then completes the oldest in-flight steps
    until at most ``depth - 1`` remain — so depth 1 is the synchronous
    path and depth 2 keeps exactly one step on the device while the host
    stages the next.
    """

    def __init__(self, depth: int = 1, tracer: Optional[Tracer] = None,
                 device: "str | torch.device" = "cpu"):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self.depth = depth
        self.device = torch.device(device)
        # wall-clock span tracer (repro.obs): dispatch/complete spans on
        # the "pipeline" track. Disabled by default — one attribute check
        # per phase; it observes timing only, never reorders work
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._inflight: Deque[StagedStep] = deque()
        # accounting (the bench's wall_vs_device column reads these)
        self.steps = 0           # steps dispatched
        self.drops = 0           # staged steps dropped pre-dispatch
        self.overlap_hits = 0    # completions whose handles were already
        #                          ready — the device finished while the
        #                          host was staging (overlap realized)
        self.block_s = 0.0       # wall seconds waiting on step events
        self.dispatch_s = 0.0    # wall seconds enqueueing device work
        self.modeled_ms_total = 0.0   # sum of completed steps' cost-model
        #                               prices (steps with modeled_ms > 0)
        self.measured_ms_total = 0.0  # their measured dispatch+block wall
        #                               ms — modeled vs measured is the
        #                               calibration-drift signal
        self.starved_s = 0.0     # wall seconds the device spent with NO
        #                          step in flight — the host was planning/
        #                          staging while the device sat idle. This
        #                          is the quantity double-buffering
        #                          removes, and it is meaningful even when
        #                          host and device share cores (CPU): it
        #                          measures queue emptiness, not wall
        #                          speedup.
        self._idle_since = time.perf_counter()

    # -- lifecycle ----------------------------------------------------------
    def submit(self, step: StagedStep) -> None:
        """Dispatch ``step`` and drain completions down to ``depth - 1``
        in-flight steps."""
        tr = self.tracer
        t0 = time.perf_counter()
        if not self._inflight:
            # the device queue was empty for the whole host-side gap since
            # it last drained — that gap is device starvation
            self.starved_s += t0 - self._idle_since
        if tr.enabled:
            tr.begin("dispatch", track="pipeline", label=step.label)
        step.handles = step.dispatch()
        if self.device.type == "cuda":
            step.event = torch.cuda.Event()
            step.event.record(torch.cuda.current_stream(self.device))
        step.dispatched = True
        if tr.enabled:
            tr.end("dispatch", track="pipeline")
        step.dispatch_wall_s = time.perf_counter() - t0
        self.dispatch_s += step.dispatch_wall_s
        self.steps += 1
        self._inflight.append(step)
        while len(self._inflight) > self.depth - 1:
            self._complete_oldest()

    def drop(self, step: StagedStep) -> None:
        """Discard a staged-but-not-dispatched step (a replan invalidated
        it); runs its rollback so staged host-mirror state resets."""
        if step.dispatched:
            raise RuntimeError("cannot drop a dispatched step: its device "
                               "work is already in flight")
        if step.rollback is not None:
            step.rollback()
        self.drops += 1

    def flush(self) -> None:
        """Complete every in-flight step (end of serve, or before an
        operation that must observe fully-materialized state, e.g. an
        elastic rebuild)."""
        while self._inflight:
            self._complete_oldest()

    def _complete_oldest(self) -> None:
        step = self._inflight.popleft()
        tr = self.tracer
        if step.event is None or step.event.query():
            self.overlap_hits += 1
        if tr.enabled:
            tr.begin("complete", track="pipeline", label=step.label)
        t0 = time.perf_counter()
        if step.event is not None:
            step.event.synchronize()
        block = time.perf_counter() - t0
        self.block_s += block
        step.complete(step.handles)
        step.completed = True
        if tr.enabled:
            tr.end("complete", track="pipeline")
        if step.modeled_ms > 0.0:
            # dispatch wall + block wall brackets the device's work for
            # this step (exactly the bench's device-busy proxy), measured
            # per step so drift against the cost model is attributable
            self.modeled_ms_total += step.modeled_ms
            self.measured_ms_total += (step.dispatch_wall_s + block) * 1e3
        if not self._inflight:
            self._idle_since = time.perf_counter()

    # -- observability ------------------------------------------------------
    @property
    def in_flight(self) -> int:
        return len(self._inflight)

    def stats(self) -> Dict[str, Any]:
        return {
            "depth": self.depth,
            "steps": self.steps,
            "drops": self.drops,
            "overlap_hits": self.overlap_hits,
            "block_s": self.block_s,
            "dispatch_s": self.dispatch_s,
            "starved_s": self.starved_s,
            "modeled_ms_total": self.modeled_ms_total,
            "measured_ms_total": self.measured_ms_total,
            # signed relative drift of the cost model against measured
            # wall time ((modeled - measured) / measured): the closed-loop
            # adaptation signal; 0.0 until a modeled step completes
            "cost_error": ((self.modeled_ms_total - self.measured_ms_total)
                           / self.measured_ms_total
                           if self.measured_ms_total > 0.0 else 0.0),
        }
