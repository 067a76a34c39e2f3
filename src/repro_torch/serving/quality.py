"""QualityController — keep-rates as a load-control knob.

The paper fixes the TDM keep-rate ``r_t`` at design time; the adaptive-
pruning literature (HeatViT, SPViT, PPT) is unanimous that it should be an
inference-time decision. This module is the serving half of that argument:
the controller maps *scheduler pressure* (queue depth against the slot
count, deadline slack priced by the calibrated ``TileCostModel``) plus each
request's accuracy/latency preference to a per-step keep schedule —
graceful **quality** degradation under overload, the serving twin of
``dist/elastic``'s device degradation.

Design constraints, in order:

* **Controller off == today.** Mode ``strict`` (the default) returns every
  schedule untouched, so plans, stage keys, digests and recompiles are
  bit-identical to the pre-controller engine at every pipeline depth.
* **Resolution is pure.** ``resolve`` mutates nothing — the engine calls
  it from the staging phase, which must stay drop/replan-safe
  (``StepPipeline``). Accounting folds in via ``record`` at dispatch, the
  same commit discipline as ``TilePlanner``.
* **Dispatch shapes stay bounded.** Tightened rates only ever come from
  the quantized ``keep_levels`` grid, so the set of distinct TDM ``k``
  values (= segment ledger keys) is bounded by grid × token-count buckets no matter
  how pressure fluctuates. Untightened entries keep the request's own
  base rate — exactly the pre-controller behavior.
* **Never loosen a step below its request's floor, never loosen at all.**
  Tightening moves DOWN the grid only; ``keep_floor`` truncates the grid
  from below.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Set, Tuple

__all__ = ["QUALITY_MODES", "QualityConfig", "QualityController"]

QUALITY_MODES = ("strict", "auto", "degrade")

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class QualityConfig:
    """Controller policy knobs.

    ``mode``        — ``strict``: controller off (schedules untouched);
                      ``auto``: tighten with queue/deadline pressure;
                      ``degrade``: run every consenting request at the
                      tightest usable grid level (shed-load mode).
    ``keep_levels`` — the quantized keep-rate grid, strictly descending in
                      (0, 1]. Resolved rates are drawn from here (bounded
                      recompiles); a base rate below every usable level is
                      left alone.
    ``keep_floor``  — truncates the grid: levels below it are unusable, so
                      no request is ever tightened past it.
    ``backlog_per_level`` — in ``auto`` mode, one grid level of tightening
                      per this many *fully-backlogged slot sets* of queue
                      depth (pressure = queue_depth // num_slots //
                      backlog_per_level).
    """

    mode: str = "strict"
    keep_levels: Tuple[float, ...] = (1.0, 0.85, 0.7, 0.55, 0.4)
    keep_floor: float = 0.4
    backlog_per_level: int = 1

    def __post_init__(self):
        if self.mode not in QUALITY_MODES:
            raise ValueError(f"quality mode must be one of {QUALITY_MODES}, "
                             f"got {self.mode!r}")
        lv = tuple(float(l) for l in self.keep_levels)
        if not lv:
            raise ValueError("keep_levels must be non-empty")
        for l in lv:
            if not (math.isfinite(l) and 0.0 < l <= 1.0):
                raise ValueError(f"keep_levels entries must be finite in "
                                 f"(0, 1], got {l}")
        if any(a <= b for a, b in zip(lv, lv[1:])):
            raise ValueError(f"keep_levels must be strictly descending, "
                             f"got {lv}")
        if not (math.isfinite(self.keep_floor)
                and 0.0 < self.keep_floor <= 1.0):
            raise ValueError(f"keep_floor must be finite in (0, 1], got "
                             f"{self.keep_floor}")
        if not any(l >= self.keep_floor - _EPS for l in lv):
            raise ValueError(f"keep_floor {self.keep_floor} is above every "
                             f"keep level {lv} — no usable grid remains")
        if self.backlog_per_level < 1:
            raise ValueError("backlog_per_level must be >= 1")
        object.__setattr__(self, "keep_levels", lv)

    @property
    def usable_levels(self) -> Tuple[float, ...]:
        """The grid truncated at the floor (descending)."""
        return tuple(l for l in self.keep_levels
                     if l >= self.keep_floor - _EPS)


class QualityController:
    """Resolves per-request keep schedules at plan time.

    Owned by the :class:`~repro.serving.planner.TilePlanner` (quality is a
    planning decision: it rewrites trajectories, and trajectories are what
    plans are built from). The engine calls :meth:`resolve` once per live
    request per staged step and :meth:`record` at dispatch.
    """

    def __init__(self, config: Optional[QualityConfig] = None,
                 num_slots: int = 1):
        self.config = config if config is not None else QualityConfig()
        self.num_slots = max(int(num_slots), 1)
        # cumulative accounting (folded at dispatch via record())
        self.decisions = 0
        self.tightened = 0
        self.deadline_tightened = 0
        self.levels_used: Set[float] = set()
        # tighten events per resolved keep level (the per-level counter
        # the obs metrics registry exports)
        self.level_counts: Dict[float, int] = {}

    @property
    def enabled(self) -> bool:
        return self.config.mode != "strict"

    # -- pure resolution ---------------------------------------------------
    def pressure_steps(self, queue_depth: int) -> int:
        """Queue backlog -> grid-tightening steps: one level per
        ``backlog_per_level`` full slot-widths of waiting requests. Zero
        when the queue fits the slots — the controller is a no-op on an
        unloaded engine."""
        return (max(int(queue_depth), 0) // self.num_slots
                // self.config.backlog_per_level)

    def tighten(self, r: float, steps: int) -> float:
        """``r`` moved ``steps`` levels down the usable grid (monotone:
        never up, never past the floor). A rate already below every usable
        level is left alone — the controller never *loosens*."""
        if steps <= 0:
            return r
        below = [l for l in self.config.usable_levels if l < r - _EPS]
        if not below:
            return r
        return below[min(steps, len(below)) - 1]

    def resolve(self, schedule: Sequence[float], done: int = 0,
                preference: Optional[str] = None, queue_depth: int = 0,
                deadline_left_ms: Optional[float] = None,
                remaining_ms: Optional[Callable[[Tuple[float, ...]], float]]
                = None) -> Tuple[float, ...]:
        """The per-step keep schedule a request should run under NOW.

        Pure — safe to call from the pipeline's staging phase and to call
        again after a drop/replan. Entries before ``done`` (TDM steps
        already executed) pass through untouched; they are history.

        ``preference`` is the request's accuracy/latency stance: ``strict``
        pins the base schedule even under load (accuracy-critical),
        ``degrade`` invites maximum tightening (latency-critical), ``None``
        follows the controller mode. A ``strict`` *controller* ignores
        preferences entirely — controller-off must be bit-exact with the
        pre-controller engine.

        ``deadline_left_ms`` + ``remaining_ms`` (a callable pricing the
        remaining trajectory under a candidate schedule, from the
        calibrated cost model) add deadline pressure in ``auto`` mode: the
        schedule tightens further until the modeled remainder fits the
        slack or the floor is reached.
        """
        base = tuple(float(r) for r in schedule)
        if not self.enabled:
            return base
        mode = self.config.mode
        if preference is not None:
            if preference not in QUALITY_MODES:
                raise ValueError(f"quality preference must be one of "
                                 f"{QUALITY_MODES}, got {preference!r}")
            mode = preference
        if mode == "strict":
            return base

        max_steps = len(self.config.usable_levels)
        if mode == "degrade":
            steps = max_steps
        else:  # auto
            steps = min(self.pressure_steps(queue_depth), max_steps)

        def apply(t: int) -> Tuple[float, ...]:
            return base[:done] + tuple(
                self.tighten(r, t) for r in base[done:])

        out = apply(steps)
        if (mode == "auto" and deadline_left_ms is not None
                and remaining_ms is not None):
            while steps < max_steps and remaining_ms(out) > deadline_left_ms:
                steps += 1
                out = apply(steps)
        return out

    # -- dispatch-time accounting -----------------------------------------
    def record(self, decisions: int, tightened: int,
               levels: Sequence[float] = (),
               deadline_tightened: int = 0) -> None:
        """Fold one dispatched step's resolution accounting into the
        cumulative counters (the engine calls this next to
        ``TilePlanner.commit`` — staged-then-dropped steps leave no
        trace)."""
        self.decisions += decisions
        self.tightened += tightened
        self.deadline_tightened += deadline_tightened
        for l in levels:
            lv = float(l)
            self.levels_used.add(lv)
            self.level_counts[lv] = self.level_counts.get(lv, 0) + 1

    def stats(self) -> Dict[str, Any]:
        return {
            "mode": self.config.mode,
            "keep_floor": self.config.keep_floor,
            "keep_levels": self.config.keep_levels,
            "decisions": self.decisions,
            "tightened": self.tightened,
            "deadline_tightened": self.deadline_tightened,
            "levels_used": tuple(sorted(self.levels_used)),
            "level_counts": tuple(sorted(self.level_counts.items())),
        }
