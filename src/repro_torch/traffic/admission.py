"""Cost-model admission control — degrade before you reject; the port of
the reference package's ``traffic/admission.py``.

The third leg of the traffic subsystem: a controller that decides, per
submitted request, whether the engine should take the work at all. The
decision is priced with the same calibrated ``TileCostModel`` the
``TilePlanner`` plans with — offered work and remaining capacity are
measured in the same modeled milliseconds, so admission, planning and the
harness's virtual clock all agree on what a request costs.

The policy is **degrade-then-reject**, composing with the
``QualityController`` rather than duplicating it:

1. *accept* — the request's marginal modeled cost fits the capacity left
   under ``limit_ms`` (modeled backlog drain time, live + waiting).
2. *degrade* — it does not fit at its own keep schedule, but WOULD fit at
   the quality floor: the controller stamps the request's ``quality``
   preference to ``"degrade"`` (the engine's QualityController then runs
   it at the tightest usable grid level) and admits it. Quality degrades
   before goodput does.
3. *reject* — even the floored schedule does not fit; the request is
   refused at submit (``("reject", uid)`` scheduler event) and never
   consumes a slot. Under sustained overload this is what keeps the queue
   — and therefore every accepted request's latency — bounded.

Every verdict is recorded as a typed :class:`AdmissionDecision`;
decisions are a pure function of (trace, seed, limit) because every input
is modeled, not measured — the determinism the traffic tests assert.

The controller is engine-agnostic: it sees three callables (price a
request, price its degraded variant, probe the backlog). ``for_vision``
wires them to a ``VisionEngine``; ``repro_torch.traffic.harness`` does the
per-token equivalent for the LM path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

__all__ = ["ADMISSION_ACTIONS", "AdmissionDecision", "AdmissionController"]

ADMISSION_ACTIONS = ("accept", "degrade", "reject")


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    """One admission verdict, in modeled milliseconds.

    ``cost_ms`` is the marginal modeled cost the verdict was priced at —
    the request's own schedule for accept/reject, the floored schedule
    for degrade. ``backlog_ms`` is the modeled drain time of everything
    already admitted (live + waiting) at decision time; ``limit_ms`` the
    capacity bound they were compared against."""

    uid: int
    action: str
    cost_ms: float
    backlog_ms: float
    limit_ms: float

    def __post_init__(self):
        if self.action not in ADMISSION_ACTIONS:
            raise ValueError(f"admission action must be one of "
                             f"{ADMISSION_ACTIONS}, got {self.action!r}")


class AdmissionController:
    """Marginal-cost admission gate over a modeled-capacity budget.

    ``limit_ms``      — max modeled backlog (committed + marginal work, in
                        cost-model ms) the engine may hold. The knee of
                        the goodput curve: below it requests drain inside
                        their SLOs, above it unbounded queueing turns
                        every completion into a deadline miss.
    ``cost_ms``       — callable pricing a request's full modeled cost.
    ``backlog_ms``    — callable probing the modeled drain time of work
                        already admitted (live slots + waiting queue).
    ``degraded_cost_ms`` / ``degrade`` — optional degrade arm: the price
                        of the request at the quality floor, and the
                        mutation that opts the request into it (stamps
                        its ``quality`` preference). Omit either and the
                        controller is accept-or-reject only.

    Install via :meth:`install` (sets ``scheduler.admission_control``) or
    pass :meth:`gate` yourself. The gate may mutate the request (degrade
    arm) — by design, and only before acceptance."""

    def __init__(self, limit_ms: float,
                 cost_ms: Callable[[Any], float],
                 backlog_ms: Callable[[], float],
                 degraded_cost_ms: Optional[Callable[[Any], float]] = None,
                 degrade: Optional[Callable[[Any], None]] = None):
        if not (math.isfinite(limit_ms) and limit_ms > 0.0):
            raise ValueError(f"limit_ms must be finite and positive, "
                             f"got {limit_ms}")
        self.limit_ms = float(limit_ms)
        self._cost_ms = cost_ms
        self._backlog_ms = backlog_ms
        self._degraded_cost_ms = degraded_cost_ms
        self._degrade = degrade
        self.decisions: List[AdmissionDecision] = []

    @classmethod
    def for_vision(cls, engine, limit_ms: float) -> "AdmissionController":
        """Wire the controller to a ``VisionEngine``: marginal cost from
        ``modeled_request_ms``, backlog from ``modeled_backlog_ms``, and —
        when the engine's QualityController is enabled — a degrade arm
        that prices the request at the controller's quality floor (every
        keep rate tightened the full usable grid, exactly what a
        ``"degrade"`` preference resolves to) before stamping the
        preference on."""
        q = engine.planner.quality
        degraded_cost = degrade = None
        if q.enabled:
            max_steps = len(q.config.usable_levels)

            def degraded_cost(req, _e=engine, _q=q, _n=max_steps):
                floor = tuple(_q.tighten(r, _n)
                              for r in _e._base_schedule(req))
                return _e.modeled_request_ms(req, schedule=floor)

            def degrade(req):
                req.quality = "degrade"

        return cls(limit_ms, cost_ms=engine.modeled_request_ms,
                   backlog_ms=engine.modeled_backlog_ms,
                   degraded_cost_ms=degraded_cost, degrade=degrade)

    # -- the gate ----------------------------------------------------------
    def gate(self, req: Any) -> bool:
        """``Scheduler.admission_control``-shaped verdict for ``req``.
        Probes the backlog fresh per request — within one submit batch,
        each acceptance raises the backlog the next request is priced
        against."""
        backlog = float(self._backlog_ms())
        budget = self.limit_ms - backlog
        cost = float(self._cost_ms(req))
        if cost <= budget:
            self._record(req, "accept", cost, backlog)
            return True
        if self._degraded_cost_ms is not None and self._degrade is not None:
            dcost = float(self._degraded_cost_ms(req))
            if dcost <= budget:
                self._degrade(req)
                self._record(req, "degrade", dcost, backlog)
                return True
        self._record(req, "reject", cost, backlog)
        return False

    def install(self, scheduler) -> "AdmissionController":
        scheduler.admission_control = self.gate
        return self

    def _record(self, req: Any, action: str, cost: float,
                backlog: float) -> None:
        self.decisions.append(AdmissionDecision(
            uid=req.uid, action=action, cost_ms=cost,
            backlog_ms=backlog, limit_ms=self.limit_ms))

    # -- observability -----------------------------------------------------
    def counts(self) -> Dict[str, int]:
        out = {a: 0 for a in ADMISSION_ACTIONS}
        for d in self.decisions:
            out[d.action] += 1
        return out

    def stats(self) -> Dict[str, Any]:
        return {"limit_ms": self.limit_ms, "decisions": len(self.decisions),
                **{f"{a}s": n for a, n in self.counts().items()}}
