"""TilePlanner — cost-model-driven execution planning for ragged ViT serving.

The ``RaggedBatcher`` buckets the ragged population by exact token count
and dispatches every bucket as its own tile — it never asks whether a
grouping is *worth it*. SPViT and HeatViT both argue that pruning-era
scheduling must be driven by a latency model, not token counts alone, and
the paper's own hardware contribution is exactly such a load balancer for
the irregular work that simultaneous pruning produces. This module is the
missing layer: a planner that *prices* tiles with the accelerator cycle
model (``core.perf_model``) before dispatching them.

Each engine step, :class:`TilePlanner` takes the live population as
:class:`PlanItem` s and emits an :class:`ExecutionPlan` — hashable,
deterministic, stats-carrying — chosen by a pluggable
:class:`TileCostModel`:

* **bucket merging** (modes ``merge``/``full``) — neighboring under-full
  token buckets of the same stage are bin-packed into one masked tile when
  the modeled padding cost is below the modeled dispatch saving;
* **express lanes** (modes ``fuse``/``full``) — a request that is a
  singleton in *every* bucket of its remaining trajectory pays one dispatch
  per segment for nothing; the planner fuses its consecutive segments into
  one trajectory call (``PackedVitSegments.run_fused``);
* **deadline-aware tiling** (any non-``off`` mode) — requests carrying a
  ``deadline_ms`` whose modeled slack has run out are carved out of shared
  tiles into their own smaller tiles, dispatched first, and excluded from
  merging (merging only adds padded work to their critical path).

Mode ``off`` is the identity: the plan's tiles are exactly
``RaggedBatcher.plan``'s output (property-tested), no lanes, no deadline
handling — the trivial cost model's special case, preserving the
batcher's bit-exact balanced path unchanged.

Exactness: merging pads rows inside *masked* kernels whose padded keys
contribute exactly zero, and fused lanes compose the same pure segment
bodies into one call — both are bit-exact against the unmerged
balanced path at the head logits (asserted for the reference package
on the CPU backend; the port holds its engine to its own offline oracle).

Recompile discipline: every tile maps to a ``bucket_key`` and every lane to
a ``traj_key``; distinct dispatch shapes are bounded by the union of the
two sets (the
``bucket ∪ trajectory`` bound, checked by the vision bench and CI).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, List, Optional, Sequence, Set, Tuple

from repro_torch.core.perf_model import (PAPER_U250, PRECISION_SPEEDUP,
                                   AcceleratorConfig, precision_speedup,
                                   vit_segment_cycles)
from repro_torch.serving.ragged_batcher import RaggedBatcher, Tile

__all__ = ["PLANNER_MODES", "PRECISIONS", "PlanItem", "FusedLane",
           "PlanStats", "ExecutionPlan", "TileCostModel", "TilePlanner"]

PLANNER_MODES = ("off", "merge", "fuse", "full")

# Precision candidates in tie-break order: fp32 first, so a quantized tier
# must be STRICTLY cheaper under the cost model to displace full precision.
PRECISIONS = tuple(PRECISION_SPEEDUP)

# FPGA-era default: roughly the cost of streaming one column-block group
# through the MPCA between kernels (~3 µs at 300 MHz). Deliberately coarse —
# ``TileCostModel.calibrate`` replaces it with a fitted wall-clock constant
# so merge decisions aren't hostage to this number.
DEFAULT_DISPATCH_OVERHEAD_CYCLES = 1000.0


@dataclasses.dataclass(frozen=True)
class PlanItem:
    """One live request as the planner sees it.

    ``trajectory`` is the remaining (stage key, entry token count) sequence
    INCLUDING the current stage at offset 0 — offsets align with engine
    steps, which is what makes the fusion singleton check sound: two live
    requests can only ever share a future bucket at equal trajectory
    offsets. Empty trajectory = opaque item (fusion disabled for it).
    ``deadline_left_ms`` is wall-clock milliseconds until the request's
    deadline (``None`` = no deadline)."""

    stage: Hashable
    n_tokens: int
    cap: Optional[int] = None
    trajectory: Tuple[Tuple[Hashable, int], ...] = ()
    deadline_left_ms: Optional[float] = None

    def __post_init__(self):
        if self.trajectory:
            s0, n0 = self.trajectory[0]
            if s0 != self.stage or n0 != self.n_tokens:
                raise ValueError(
                    f"trajectory[0] {(s0, n0)!r} must restate the item's "
                    f"current (stage, n_tokens) {(self.stage, self.n_tokens)!r}")


@dataclasses.dataclass(frozen=True)
class FusedLane:
    """An express lane: ``member`` (caller-side item index) runs its whole
    remaining trajectory — one call, one dispatch — instead of one
    tile per segment."""

    member: int
    trajectory: Tuple[Tuple[Hashable, int], ...]  # (stage, entry count)

    @property
    def traj_key(self) -> Tuple:
        """Compile identity of the fused program (the ledger key)."""
        return self.trajectory

    @property
    def real_cells(self) -> int:
        return sum(n for _, n in self.trajectory)


@dataclasses.dataclass(frozen=True)
class PlanStats:
    """Per-plan accounting, carried by the :class:`ExecutionPlan`."""

    tiles: int = 0
    lanes: int = 0
    merges: int = 0              # bin-pack operations applied
    fused_segments: int = 0      # segments covered by lanes
    deadline_urgent: int = 0     # members whose modeled slack ran out
    deadline_splits: int = 0     # tiles carved apart for urgent members
    modeled_cycles: float = 0.0  # cost of THIS plan under the cost model
    base_cycles: float = 0.0     # cost of the identity plan for same items

    @property
    def modeled_saving_cycles(self) -> float:
        return self.base_cycles - self.modeled_cycles


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """What one engine step dispatches: dense tiles + fused express lanes.
    Frozen/hashable (tiles and lanes are frozen dataclasses over hashable
    fields) and deterministic given the item sequence and planner state.
    ``urgent`` lists the members whose deadline slack ran out — the engine
    must dispatch their tiles BEFORE everything else in the step (tiles
    are already ordered urgent-first; lanes come after urgent tiles, since
    a fused lane is the most expensive single dispatch of the step)."""

    tiles: Tuple[Tile, ...]
    lanes: Tuple[FusedLane, ...]
    stats: PlanStats
    urgent: Tuple[int, ...] = ()

    def covered_members(self) -> List[int]:
        """Sorted item indices covered — a correct plan covers each item
        exactly once across tiles ∪ lanes (property-tested)."""
        out = [i for t in self.tiles for i in t.members]
        out += [l.member for l in self.lanes]
        return sorted(out)

    def urgent_tile_count(self) -> int:
        """Tiles containing at least one urgent member; by construction
        (``TilePlanner._order``) these are exactly the leading tiles."""
        u = set(self.urgent)
        return sum(1 for t in self.tiles if any(m in u for m in t.members))

    def staging_meta(self) -> Tuple[Tuple, ...]:
        """Per-tile staging recipe, one entry per tile in dispatch order:
        ``(members, n_tokens, n_tile, b_tile, needs_mask, n_valid)`` where
        ``n_valid`` is the full padded-row valid-count vector (real counts
        then ``n_tile`` for batch-pad rows) or ``None`` when no row is
        token-padded. Hashable and device-free — the pipelined engines
        build step N+1's input buffers from this while step N executes."""
        out = []
        for t in self.tiles:
            nv = None
            if t.needs_mask:
                nv = t.n_tokens + (t.n_tile,) * (t.b_tile - len(t.members))
            out.append((t.members, t.n_tokens, t.n_tile, t.b_tile,
                        t.needs_mask, nv))
        return tuple(out)


# ===========================================================================
# Cost model
# ===========================================================================
class TileCostModel:
    """Prices tiles and lanes in modeled accelerator cycles.

    Stage keys produced by the ``VisionEngine`` have the shape
    ``(seg_idx, segment, k)`` with ``segment`` one of the
    ``core.packed_runner`` segments; those are priced through the paper's
    cycle model (``encoder_cycles``/``sbmm_cycles``, Table III). Opaque
    stage keys (planner unit tests, foreign engines) fall back to a
    quadratic-in-tokens proxy of attention cost.

    ``dispatch_overhead_cycles`` is the per-dispatch fixed cost the merge
    rule trades against padding; :meth:`calibrate` fits it (and the
    cycle→seconds scale) from measured wall-clock timings, so decisions on
    a real host aren't hostage to the FPGA-era default.
    """

    def __init__(self, cfg=None, acc: AcceleratorConfig = PAPER_U250,
                 dispatch_overhead_cycles: float =
                 DEFAULT_DISPATCH_OVERHEAD_CYCLES,
                 seconds_per_cycle: Optional[float] = None):
        self.cfg = cfg
        self.acc = acc
        self.dispatch_overhead_cycles = float(dispatch_overhead_cycles)
        self.seconds_per_cycle = (1.0 / acc.freq_hz if seconds_per_cycle
                                  is None else float(seconds_per_cycle))
        self.calibrated = False

    # -- per-stage pricing -------------------------------------------------
    @staticmethod
    def _segment_of(stage) -> Optional[Tuple]:
        """Extract the packed_runner segment from an engine stage key
        ``(seg_idx, segment, k)`` — or its marker-extended variants
        ``(…, "soft")`` / ``(…, precision)`` / ``(…, "soft", precision)``
        (same segment weights, so the same base pricing); None for opaque
        keys."""
        if (isinstance(stage, tuple) and len(stage) >= 3
                and isinstance(stage[1], tuple) and stage[1]
                and isinstance(stage[1][0], str)):
            return stage[1]
        return None

    @staticmethod
    def _precision_of(stage) -> str:
        """Precision marker of a stage key: non-fp32 stages carry the
        precision string as their LAST element (after the optional "soft"
        marker); fp32 keys carry no marker — by construction in the engine,
        so fp32 stage keys (and therefore fp32 plans, digests and compile
        ledgers) are byte-identical to the pre-quantization ones."""
        if (isinstance(stage, tuple) and stage
                and isinstance(stage[-1], str)
                and stage[-1] in PRECISION_SPEEDUP):
            return stage[-1]
        return "fp32"

    def stage_row_cycles(self, stage, n_tokens: int) -> float:
        """Modeled cycles for ONE row (one image) of a tile at ``stage``
        with ``n_tokens`` (padded) tokens. Quantized stages price at the
        cycle model's precision throughput (``PRECISION_SPEEDUP``)."""
        seg = self._segment_of(stage)
        precision = self._precision_of(stage)
        if seg is None or self.cfg is None:
            # opaque stage: attention-shaped proxy (quadratic term + linear),
            # scaled by the same precision speedup so foreign engines and
            # the proxy-priced benches see consistent precision ordering
            return (float(n_tokens * n_tokens + 8 * n_tokens)
                    / precision_speedup(precision))
        return vit_segment_cycles(self.cfg, seg, n_tokens, self.acc,
                                  precision=precision)

    # -- tile / lane / trajectory pricing ----------------------------------
    def tile_work_cycles(self, tile: Tile) -> float:
        """Variable (per-cell) part of a tile's cost: every padded row pays
        the full padded token count — that's the padding cost merging
        trades against the dispatch overhead."""
        return tile.b_tile * self.stage_row_cycles(tile.stage, tile.n_tile)

    def tile_cycles(self, tile: Tile) -> float:
        return self.dispatch_overhead_cycles + self.tile_work_cycles(tile)

    def lane_cycles(self, lane: FusedLane) -> float:
        """A fused lane is ONE dispatch covering its whole trajectory."""
        work = sum(self.stage_row_cycles(s, n) for s, n in lane.trajectory)
        return self.dispatch_overhead_cycles + work

    def trajectory_cycles(self, trajectory: Sequence[Tuple[Hashable, int]]
                          ) -> float:
        """Cost of running a trajectory the DEFAULT way — one dispatch per
        stage (the baseline a lane is compared against, and the remaining
        work term in deadline slack)."""
        return sum(self.dispatch_overhead_cycles
                   + self.stage_row_cycles(s, n) for s, n in trajectory)

    def ms(self, cycles: float) -> float:
        return cycles * self.seconds_per_cycle * 1e3

    # -- calibration -------------------------------------------------------
    def calibrate(self, measured: Sequence[Tuple[float, float]]
                  ) -> Dict[str, float]:
        """Fit the model to wall-clock: ``measured`` is (work_cycles,
        seconds) per observed dispatch, with ``work_cycles`` the *variable*
        cost (:meth:`tile_work_cycles`). Least-squares
        ``seconds ≈ a + b·work`` sets ``seconds_per_cycle = b`` and
        ``dispatch_overhead_cycles = a / b`` — after which modeled cycles
        are directly comparable to the host's wall clock and merge/deadline
        decisions reflect measured dispatch overhead, not the FPGA-era
        default. Returns the fit."""
        pts = [(float(x), float(y)) for x, y in measured]
        if len(pts) < 2:
            raise ValueError(f"calibrate needs >= 2 samples, got {len(pts)}")
        n = len(pts)
        mx = sum(x for x, _ in pts) / n
        my = sum(y for _, y in pts) / n
        var = sum((x - mx) ** 2 for x, _ in pts)
        if var == 0.0:
            raise ValueError("calibrate needs samples at >= 2 distinct "
                             "work sizes to separate overhead from work")
        b = sum((x - mx) * (y - my) for x, y in pts) / var
        a = my - b * mx
        # Guard degenerate fits (noise on near-constant timings): keep the
        # scale positive and the overhead non-negative.
        b = max(b, 1e-15)
        a = max(a, 0.0)
        self.seconds_per_cycle = b
        self.dispatch_overhead_cycles = a / b
        self.calibrated = True
        ss_res = sum((y - (a + b * x)) ** 2 for x, y in pts)
        ss_tot = sum((y - my) ** 2 for _, y in pts) or 1e-30
        return {"seconds_per_cycle": b,
                "dispatch_overhead_cycles": self.dispatch_overhead_cycles,
                "overhead_seconds": a,
                "r2": 1.0 - ss_res / ss_tot,
                "samples": n}


# ===========================================================================
# Planner
# ===========================================================================
class TilePlanner:
    """Plans one engine step's dispatches over the ragged population.

    Owns the :class:`RaggedBatcher` (grouping + padding stats) and a
    :class:`TileCostModel` (pricing); accumulates merge/fusion/deadline
    counters and the trajectory ledger across calls."""

    def __init__(self, batcher: RaggedBatcher,
                 cost_model: Optional[TileCostModel] = None,
                 mode: str = "full", fuse_min_segments: int = 2,
                 quality: Optional[object] = None):
        if mode not in PLANNER_MODES:
            raise ValueError(f"planner mode must be one of {PLANNER_MODES}, "
                             f"got {mode!r}")
        if mode != "off" and batcher.mode != "balanced":
            raise ValueError(
                f"planner mode {mode!r} requires the balanced batcher "
                f"(merge/fuse/deadline rewrite exact-count buckets); "
                f"batcher mode is {batcher.mode!r}")
        if fuse_min_segments < 1:
            raise ValueError("fuse_min_segments must be >= 1")
        self.batcher = batcher
        self.cost_model = cost_model if cost_model is not None \
            else TileCostModel()
        self.mode = mode
        self.fuse_min_segments = fuse_min_segments
        # keep-schedule resolution is a planning decision (it rewrites
        # trajectories, and trajectories are what plans are built from),
        # so the QualityController lives here; a strict (off) controller
        # is the default and resolves every schedule to itself
        if quality is None:
            from repro_torch.serving.quality import QualityController
            quality = QualityController()
        self.quality = quality
        # cumulative accounting
        self.plans = 0
        self.merges = 0
        self.lanes_planned = 0
        self.lane_cells = 0      # real token·segment cells served via lanes
        self.fused_segments = 0
        self.deadline_urgent = 0
        self.deadline_splits = 0
        self.modeled_cycles = 0.0
        self.base_cycles = 0.0
        self.trajectory_keys: Set = set()
        self.precision_decisions: Dict[str, int] = {p: 0 for p in PRECISIONS}

    # -- public API --------------------------------------------------------
    def plan(self, items: Sequence[PlanItem]) -> ExecutionPlan:
        """Emit the :class:`ExecutionPlan` for one step's population and
        fold it into the cumulative ledgers (build + :meth:`commit`).
        Deterministic: identical items + planner config -> identical plan."""
        return self.commit(self._build(list(items)))

    def plan_ahead(self, items: Sequence[PlanItem],
                   horizon: int) -> List[ExecutionPlan]:
        """Speculative plans for this step and up to ``horizon - 1``
        predicted successors. Plans are hashable, deterministic values, so
        they CAN be computed before the device work that realizes them —
        the pipelined engines stage plan N+1 while plan N executes, then
        :meth:`commit` only what actually dispatches (nothing here touches
        the cumulative ledgers or the batcher's padding stats).

        Prediction semantics: every live item advances one trajectory
        offset per step; lane-fused members and items at their last
        segment leave the population (:meth:`advance_items` is the same
        rule, exposed for the engines' cache-validity fingerprints).
        Deadlines are not propagated — urgency is wall-clock-scoped to the
        step that observes it, so speculative successors carry none (the
        engines skip lookahead caching for deadline-bearing populations).

        The trajectory-singleton (express-lane) check is memoized across
        the horizon: the pairwise last-collision offsets are computed once
        (one O(n²·L) trajectory scan) and each successor's fusible set is
        derived from them by integer comparison — item ``i`` is solo at
        horizon step ``h`` iff its last collision with every still-live
        item falls before ``h``.
        """
        if horizon < 1:
            raise ValueError(f"plan_ahead horizon must be >= 1, "
                             f"got {horizon}")
        items = list(items)
        plans = [self._build(items)]
        if horizon == 1:
            return plans
        fuse_on = self.mode in ("fuse", "full")
        maxcol = self._pairwise_last_collision(items) if fuse_on else None
        cur, orig = items, list(range(len(items)))
        for h in range(1, horizon):
            cur, kept = self._advance(cur, plans[-1])
            orig = [orig[ci] for ci in kept]
            if not cur:
                break
            fused_members = None
            if fuse_on:
                fused_members = {
                    ci for ci, oi in enumerate(orig)
                    if len(cur[ci].trajectory) >= self.fuse_min_segments
                    and all(maxcol[oi][oj] < h
                            for cj, oj in enumerate(orig) if cj != ci)}
            plans.append(self._build(cur, fused_members=fused_members))
        return plans

    def commit(self, plan: ExecutionPlan) -> ExecutionPlan:
        """Fold a plan that is actually dispatching into the cumulative
        ledgers (planner counters, trajectory-key set, batcher padding
        stats). The engines call this from the pipeline's dispatch phase —
        a staged-then-dropped plan never touches the ledgers, so replans
        leak no accounting (the staged-state audit's planner half)."""
        st = plan.stats
        self.plans += 1
        self.merges += st.merges
        self.lanes_planned += st.lanes
        self.lane_cells += sum(l.real_cells for l in plan.lanes)
        self.fused_segments += st.fused_segments
        self.deadline_urgent += st.deadline_urgent
        self.deadline_splits += st.deadline_splits
        self.modeled_cycles += st.modeled_cycles
        self.base_cycles += st.base_cycles
        for l in plan.lanes:
            self.trajectory_keys.add(l.traj_key)
        self.batcher.record(plan.tiles)
        return plan

    def choose_precision(self, candidates: Sequence[Tuple[str, Tuple]],
                         record: bool = True) -> str:
        """Pick the execution precision for one request — the third planner
        knob next to merging and quality. ``candidates`` is a sequence of
        ``(precision, trajectory)`` pairs, each trajectory already carrying
        that precision's stage-key markers (so it prices through the same
        :meth:`TileCostModel.trajectory_cycles` every other decision uses).

        Deterministic: the strict argmin of modeled trajectory cycles,
        scanning candidates in the given order — engines list fp32 first,
        so a quantized tier only wins by being STRICTLY cheaper, and ties
        keep full precision. ``record=False`` skips the decision counters
        for pure pricing probes (``modeled_request_ms``/backlog estimates),
        so ``precision_decisions`` counts actual admissions only."""
        cands = list(candidates)
        if not cands:
            raise ValueError("choose_precision needs at least one candidate")
        best_p: Optional[str] = None
        best_c: Optional[float] = None
        for p, traj in cands:
            c = self.cost_model.trajectory_cycles(traj)
            if best_c is None or c < best_c:
                best_p, best_c = p, c
        if record:
            self.precision_decisions[best_p] = (
                self.precision_decisions.get(best_p, 0) + 1)
        return best_p

    def advance_items(self, items: Sequence[PlanItem],
                      plan: ExecutionPlan) -> List[PlanItem]:
        """Predicted next-step population after ``plan`` runs over
        ``items``: lane-fused members run to completion and leave, items
        at their last trajectory segment retire, everything else advances
        one offset (caps and deadlines are not propagated — a cap only
        binds at the embed stage, which no advanced item revisits)."""
        return self._advance(items, plan)[0]

    @staticmethod
    def _advance(items: Sequence[PlanItem], plan: ExecutionPlan
                 ) -> Tuple[List[PlanItem], List[int]]:
        fused = {l.member for l in plan.lanes}
        nxt: List[PlanItem] = []
        kept: List[int] = []
        for i, it in enumerate(items):
            if i in fused or len(it.trajectory) <= 1:
                continue
            traj = it.trajectory[1:]
            nxt.append(PlanItem(stage=traj[0][0], n_tokens=traj[0][1],
                                trajectory=traj))
            kept.append(i)
        return nxt, kept

    def _build(self, items: Sequence[PlanItem],
               fused_members: Optional[Set[int]] = None) -> ExecutionPlan:
        """Pure plan construction — no ledger mutation (see
        :meth:`commit`). ``fused_members`` overrides the express-lane
        singleton scan with a precomputed set (``plan_ahead``'s memoized
        horizon steps); ``None`` runs the exact pairwise scan."""
        raw = [(it.stage, it.n_tokens) if it.cap is None
               else (it.stage, it.n_tokens, it.cap) for it in items]
        base_tiles = self.batcher.partition(raw)

        if self.mode == "off":
            stats = self._plan_stats(base_tiles, [], items, base_tiles,
                                     merges=0, urgent=set(), splits=0)
            return ExecutionPlan(tuple(base_tiles), (), stats, ())

        urgent = self._urgent_members(items)
        if self.mode in ("fuse", "full"):
            if fused_members is None:
                lanes = self._fuse(items)
            else:
                lanes = [FusedLane(member=i, trajectory=items[i].trajectory)
                         for i in sorted(fused_members)]
        else:
            lanes = []
        fused = {l.member for l in lanes}
        # a fusible item is by construction a singleton in its current
        # bucket, so removing it removes exactly its singleton tile
        tiles = [t for t in base_tiles
                 if not (len(t.members) == 1 and t.members[0] in fused)]
        tiles, splits = self._split_urgent(tiles, urgent - fused, items)
        merges = 0
        if self.mode in ("merge", "full"):
            tiles, merges = self._merge(tiles, items, exclude=urgent)
        tiles = self._order(tiles, urgent)
        stats = self._plan_stats(tiles, lanes, items, base_tiles,
                                 merges=merges, urgent=urgent, splits=splits)
        return ExecutionPlan(tuple(tiles),
                             tuple(sorted(lanes, key=lambda l: l.member)),
                             stats, tuple(sorted(urgent)))

    def stats(self) -> Dict[str, object]:
        """Cumulative planner counters (the engine folds these into its
        ``stats()`` under ``plan_*``)."""
        cm = self.cost_model
        saving = self.base_cycles - self.modeled_cycles
        out = {
            "mode": self.mode,
            "plans": self.plans,
            "merges": self.merges,
            "lanes": self.lanes_planned,
            "lane_cells": self.lane_cells,
            "fused_segments": self.fused_segments,
            "deadline_urgent": self.deadline_urgent,
            "deadline_splits": self.deadline_splits,
            "trajectory_count": len(self.trajectory_keys),
            "modeled_cycles": self.modeled_cycles,
            "base_cycles": self.base_cycles,
            "modeled_saving_cycles": saving,
            "modeled_saving_ms": cm.ms(saving),
            "calibrated": cm.calibrated,
        }
        for p in PRECISIONS:
            out[f"precision_{p}"] = self.precision_decisions.get(p, 0)
        return out

    @property
    def trajectory_count(self) -> int:
        """Distinct fused-lane compile identities planned so far — together
        with the batcher's bucket set this bounds distinct dispatch shapes."""
        return len(self.trajectory_keys)

    # -- deadline handling -------------------------------------------------
    def _urgent_members(self, items: Sequence[PlanItem]) -> Set[int]:
        """Members whose modeled slack has run out: time left is below the
        modeled cost of their remaining trajectory."""
        urgent: Set[int] = set()
        for i, it in enumerate(items):
            if it.deadline_left_ms is None:
                continue
            traj = it.trajectory or ((it.stage, it.n_tokens),)
            remaining_ms = self.cost_model.ms(
                self.cost_model.trajectory_cycles(traj))
            if it.deadline_left_ms - remaining_ms <= 0.0:
                urgent.add(i)
        return urgent

    def _split_urgent(self, tiles: List[Tile], urgent: Set[int],
                      items: Sequence[PlanItem]
                      ) -> Tuple[List[Tile], int]:
        """Carve urgent members out of shared tiles into their own
        exact-count singleton tiles (smaller batch tile = less work on the
        urgent request's critical path; dispatch ordering puts them first).
        Splitting preserves exactness: the carved tile is exact-count and
        the remainder keeps its bucket's n_tile."""
        if not urgent:
            return tiles, 0
        out: List[Tile] = []
        splits = 0
        for t in tiles:
            mine = [m for m in t.members if m in urgent]
            if not mine or len(t.members) == 1:
                out.append(t)
                continue
            splits += 1
            rest = [m for m in t.members if m not in urgent]
            for m in mine:
                it = items[m]
                out.append(Tile(
                    stage=t.stage, members=(m,), n_tokens=(it.n_tokens,),
                    n_tile=self.batcher.tile_tokens(it.n_tokens, it.cap),
                    b_tile=1))
            if rest:
                out.append(Tile(
                    stage=t.stage, members=tuple(rest),
                    n_tokens=tuple(items[m].n_tokens for m in rest),
                    n_tile=t.n_tile,
                    b_tile=self.batcher.tile_batch(len(rest))))
        return out, splits

    # -- express lanes -----------------------------------------------------
    def _fuse(self, items: Sequence[PlanItem]) -> List[FusedLane]:
        """Items that are singletons in EVERY bucket of their remaining
        trajectory. Trajectory offsets align with engine steps, so two live
        items can only ever share a future bucket at equal offsets — one
        pairwise scan decides fusibility exactly (arrivals admitted later
        always trail in segment index and can never collide)."""
        lanes: List[FusedLane] = []
        tt = self.batcher.tile_tokens
        for i, it in enumerate(items):
            if len(it.trajectory) < self.fuse_min_segments:
                continue
            solo = True
            for j, jt in enumerate(items):
                if j == i:
                    continue
                other = jt.trajectory or ((jt.stage, jt.n_tokens),)
                for d in range(min(len(it.trajectory), len(other))):
                    si, ni = it.trajectory[d]
                    sj, nj = other[d]
                    if si == sj and tt(ni) == tt(nj):
                        solo = False
                        break
                if not solo:
                    break
            if solo:
                lanes.append(FusedLane(member=i, trajectory=it.trajectory))
        return lanes

    def _pairwise_last_collision(self, items: Sequence[PlanItem]
                                 ) -> List[List[int]]:
        """``maxcol[i][j]`` = largest trajectory offset at which items
        ``i`` and ``j`` would land in the same bucket (-1 = never). One
        O(n²·L) scan; ``plan_ahead`` derives every horizon step's fusible
        set from it by comparison — ``i`` is solo among a live set at
        offset ``h`` iff ``maxcol[i][j] < h`` for every live ``j`` (no
        collision at or past ``h``), which is exactly :meth:`_fuse`'s
        pairwise check on the advanced trajectories."""
        tt = self.batcher.tile_tokens
        trajs = [it.trajectory or ((it.stage, it.n_tokens),) for it in items]
        n = len(items)
        maxcol = [[-1] * n for _ in range(n)]
        for i in range(n):
            for j in range(i + 1, n):
                m = -1
                ti, tj = trajs[i], trajs[j]
                for d in range(min(len(ti), len(tj))):
                    if (ti[d][0] == tj[d][0]
                            and tt(ti[d][1]) == tt(tj[d][1])):
                        m = d
                maxcol[i][j] = maxcol[j][i] = m
        return maxcol

    # -- bucket merging ----------------------------------------------------
    def _merge(self, tiles: List[Tile], items: Sequence[PlanItem],
               exclude: Set[int]) -> Tuple[List[Tile], int]:
        """Greedy bin-packing of neighboring token buckets per stage: walk
        each stage's tiles in ascending n_tile and absorb a tile into its
        neighbor whenever the cost model says the merged masked tile is
        cheaper than two dispatches. Urgent members never merge."""
        cm = self.cost_model
        groups: Dict = {}
        out: List[Tile] = []
        merges = 0
        for t in tiles:
            if any(m in exclude for m in t.members):
                out.append(t)  # deadline-pinned: never pad its rows further
            else:
                groups.setdefault(t.stage, []).append(t)
        for stage in sorted(groups, key=repr):
            group = sorted(groups[stage], key=lambda t: (t.n_tile, t.members))
            cur = group[0]
            for nxt in group[1:]:
                cand = self._merged(cur, nxt, items)
                if cand is not None and (cm.tile_cycles(cur)
                                         + cm.tile_cycles(nxt)
                                         - cm.tile_cycles(cand)) > 0.0:
                    cur = cand
                    merges += 1
                else:
                    out.append(cur)
                    cur = nxt
            out.append(cur)
        return out, merges

    def _merged(self, a: Tile, b: Tile,
                items: Sequence[PlanItem]) -> Optional[Tile]:
        """The masked tile covering a ∪ b, or None when a hard token cap
        (e.g. the embed stage's position-table capacity) forbids padding a
        member to the merged tile width."""
        n_tile = max(a.n_tile, b.n_tile)
        members = a.members + b.members
        for m in members:
            cap = items[m].cap
            if cap is not None and cap < n_tile:
                return None
        if self.batcher.max_batch and len(members) > self.batcher.max_batch:
            return None
        return Tile(stage=a.stage, members=members,
                    n_tokens=a.n_tokens + b.n_tokens, n_tile=n_tile,
                    b_tile=self.batcher.tile_batch(len(members)))

    # -- ordering / accounting ---------------------------------------------
    @staticmethod
    def _order(tiles: List[Tile], urgent: Set[int]) -> List[Tile]:
        """Deterministic dispatch order, urgent tiles first (forced early
        dispatch — the host runs tiles sequentially, so ordering is the
        within-step latency lever)."""
        def key(t: Tile):
            has_urgent = any(m in urgent for m in t.members)
            return (0 if has_urgent else 1, repr((t.stage, t.n_tile,
                                                  t.members)))
        return sorted(tiles, key=key)

    def _plan_stats(self, tiles: List[Tile], lanes: List[FusedLane],
                    items: Sequence[PlanItem], base_tiles: List[Tile],
                    merges: int, urgent: Set[int], splits: int) -> PlanStats:
        """Per-plan accounting only — the cumulative ledgers are folded by
        :meth:`commit` when (and only when) the plan dispatches."""
        cm = self.cost_model
        fused = {l.member for l in lanes}
        modeled = (sum(cm.tile_cycles(t) for t in tiles)
                   + sum(cm.lane_cycles(l) for l in lanes))
        # identity baseline: per-bucket tiles now + one dispatch per future
        # segment for the items a lane absorbs (the lane replaces those
        # future dispatches, so they belong in its baseline)
        base = sum(cm.tile_cycles(t) for t in base_tiles
                   if not (len(t.members) == 1 and t.members[0] in fused))
        base += sum(cm.trajectory_cycles(items[l.member].trajectory)
                    for l in lanes)
        return PlanStats(
            tiles=len(tiles), lanes=len(lanes), merges=merges,
            fused_segments=sum(len(l.trajectory) for l in lanes),
            deadline_urgent=len(urgent), deadline_splits=splits,
            modeled_cycles=modeled, base_cycles=base)
