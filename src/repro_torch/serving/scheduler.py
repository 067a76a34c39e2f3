"""Scheduler — admission/retirement policy over waiting + in-flight requests.

One of the three serving layers (Scheduler / KVCacheManager / ModelRunner —
see ``repro.serving.engine``). The Scheduler owns *which request runs in
which slot and when*; it never touches device state. Both serve paths
(static waves and continuous batching) drive their request lifecycles
through it, so they emit one unified event stream:

    ("admit",   uid)    request entered a slot
    ("retire",  uid)    request finished, slot freed
    ("reject",  uid)    request refused at submit by the admission hook
    ("degrade", desc)   elastic event observed mid-stream (mesh shrank)

Backlog accounting is first-class: :meth:`stats` reports queue depth (and
its peak), slot occupancy, and the submit/reject/admit/retire counters.
These are THE load counters — the ``QualityController`` reads the same
``queue_depth`` the traffic harness reports, so "backlog pressure" means
one thing everywhere.

``admission_control`` is the load-shedding hook: an optional callable
``hook(request) -> bool`` consulted once per submitted request. Returning
``False`` refuses the request — it never enters the waiting queue, a
``("reject", uid)`` event is emitted, and ``submitted_total`` does not
advance (a rejected request must not trigger the engines' mid-step
replans). ``repro.traffic.admission`` installs its cost-model controller
here; the hook may mutate the request (e.g. set its quality preference)
before accepting it.

Admission order is policy-pluggable: pass ``policy="fifo"`` (default), one
of the latency-aware built-ins below, or a callable
``policy(waiting: Sequence[Request]) -> int`` returning the index of the
next request to admit. The built-ins are shared by BOTH serve paths (LM
``ServeEngine`` and vision ``VisionEngine``) — they read request size
duck-typed (``prompt`` tokens or ``patches`` rows):

* ``"fifo"``                  — arrival order.
* ``"shortest_prompt_first"`` — smallest request first (SJF): minimizes
  mean latency under skewed sizes; ties stay FIFO.
* ``"prune_pressure_aware"``  — prefer the request with the lowest
  *predicted post-prune token load* (``req.prune_load``, set at submit:
  the TDM token-count trajectory for vision, the KV-prune-discounted
  footprint for LMs). HeatViT/SPViT motivate scheduling on the pruned
  load, not the raw size — a heavily-pruned large image is cheaper than a
  lightly-pruned medium one. Vision requests carrying a ``deadline_ms``
  get the same annotation additionally discounted by deadline tightness
  relative to their cost-model solo latency (``serving.planner``), so the
  SAME policy admits urgent requests earlier — deadline awareness needs
  no separate policy.
"""
from __future__ import annotations

from collections import deque
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple)

from repro_torch.obs.events import EventLog

# Request lives in engine.py / vision.py (public API compat); import lazily
# to avoid a cycle — the annotation below is intentionally loose.
Request = Any

PolicyFn = Callable[[Sequence[Request]], int]


def request_tokens(req: Request) -> float:
    """Duck-typed request size: LM prompt tokens, or vision patch rows
    (+CLS). The latency-aware policies rank on this."""
    prompt = getattr(req, "prompt", None)
    if prompt is not None:
        return float(len(prompt))
    patches = getattr(req, "patches", None)
    if patches is not None:
        return float(patches.shape[0] + 1)
    return 0.0


def predicted_prune_load(req: Request) -> float:
    """Predicted post-prune token load; falls back to the raw size when the
    submitting engine didn't annotate ``prune_load``."""
    load = getattr(req, "prune_load", None)
    return float(load) if load is not None else request_tokens(req)


def fifo_policy(waiting: Sequence[Request]) -> int:
    return 0


def shortest_prompt_first(waiting: Sequence[Request]) -> int:
    return min(range(len(waiting)), key=lambda i: request_tokens(waiting[i]))


def prune_pressure_aware(waiting: Sequence[Request]) -> int:
    return min(range(len(waiting)),
               key=lambda i: predicted_prune_load(waiting[i]))


_POLICIES: Dict[str, PolicyFn] = {
    "fifo": fifo_policy,
    "shortest_prompt_first": shortest_prompt_first,
    "prune_pressure_aware": prune_pressure_aware,
}


class Scheduler:
    """Tracks waiting requests and slot occupancy; decides admissions."""

    def __init__(self, num_slots: int, policy: "str | PolicyFn" = "fifo",
                 admission_control: Optional[Callable[[Request], bool]]
                 = None, event_capacity: int = 65536):
        if num_slots <= 0:
            raise ValueError(f"num_slots must be positive, got {num_slots}")
        self.num_slots = num_slots
        if isinstance(policy, str):
            if policy not in _POLICIES:
                raise ValueError(f"unknown policy {policy!r}; built-ins: "
                                 f"{sorted(_POLICIES)}")
            policy = _POLICIES[policy]
        self.policy: PolicyFn = policy
        # optional load-shedding gate consulted at submit (see module
        # docstring); engines/harnesses may also install it post-hoc
        self.admission_control = admission_control
        self.waiting: Deque[Request] = deque()
        self.running: Dict[int, Request] = {}   # slot -> request
        # bounded ring: len() is the absolute sequence length and slices
        # take absolute indices, so incremental consumers (the traffic
        # harness's events[mark:] scan) are eviction-safe; drain() hands
        # the buffered window to exporters
        self.events = EventLog(capacity=event_capacity)
        # monotone submission counter: the pipelined engines snapshot it
        # when they stage a step and compare before dispatch — a request
        # submitted while a plan is in flight lands in the NEXT plan
        # (stage is rolled back and rebuilt), never mutates the one being
        # staged, and is never silently deferred past a step boundary
        self.submitted_total = 0
        self.rejected_total = 0
        self.admitted_total = 0
        self.retired_total = 0
        self.peak_queue_depth = 0

    # -- request lifecycle -------------------------------------------------
    def submit(self, requests: Sequence[Request]) -> None:
        """Enqueue ``requests`` for admission, consulting the
        ``admission_control`` hook (if any) one request at a time — so a
        controller watching backlog sees each acceptance before pricing
        the next request of the same batch."""
        for req in requests:
            if (self.admission_control is not None
                    and not self.admission_control(req)):
                self.rejected_total += 1
                self.events.append(("reject", req.uid))
                continue
            self.waiting.append(req)
            self.submitted_total += 1
        self.peak_queue_depth = max(self.peak_queue_depth,
                                    len(self.waiting))

    def free_slots(self) -> List[int]:
        return [i for i in range(self.num_slots) if i not in self.running]

    def schedule(self) -> List[Tuple[int, Request]]:
        """Admit waiting requests into free slots (policy order). Returns
        the [(slot, request), ...] admitted this call and emits ``admit``
        events for each."""
        admitted: List[Tuple[int, Request]] = []
        for slot in self.free_slots():
            if not self.waiting:
                break
            idx = self.policy(self.waiting)
            req = self.waiting[idx]
            del self.waiting[idx]
            self.running[slot] = req
            self.events.append(("admit", req.uid))
            self.admitted_total += 1
            admitted.append((slot, req))
        return admitted

    def retire(self, slot: int) -> Request:
        """Free ``slot``; emits a ``retire`` event for its request."""
        req = self.running.pop(slot)
        self.events.append(("retire", req.uid))
        self.retired_total += 1
        return req

    # -- observability -----------------------------------------------------
    def observe(self, kind: str, payload: Any = None) -> None:
        """Record an externally observed event (e.g. elastic degradation)
        into the same stream as admit/retire."""
        self.events.append((kind, payload))

    def drain_events(self) -> List[Tuple[str, Any]]:
        """Consume the buffered event window (see ``EventLog.drain``:
        counters and absolute marks stay valid)."""
        return self.events.drain()

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    @property
    def num_admissions(self) -> int:
        # counter-backed (NOT an event scan: the ring may have evicted
        # old admit events on a long-lived engine)
        return self.admitted_total

    @property
    def num_retirements(self) -> int:
        return self.retired_total

    @property
    def queue_depth(self) -> int:
        """Requests submitted but not yet in a slot — THE backlog-pressure
        number (the QualityController and the traffic harness both read
        this one, not private mirrors of it)."""
        return len(self.waiting)

    def stats(self) -> Dict[str, Any]:
        """First-class backlog/occupancy block, shared by both engines'
        ``stats()`` (prefixed ``sched_``) and sampled per virtual step by
        the traffic harness."""
        return {
            "queue_depth": self.queue_depth,
            "peak_queue_depth": self.peak_queue_depth,
            "running": len(self.running),
            "free_slots": self.num_slots - len(self.running),
            "num_slots": self.num_slots,
            "submitted_total": self.submitted_total,
            "rejected_total": self.rejected_total,
            "admitted_total": self.admitted_total,
            "retired_total": self.retired_total,
            "events_dropped": self.events.dropped,
        }
