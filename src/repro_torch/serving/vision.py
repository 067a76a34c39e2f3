"""VisionEngine — continuous-batching inference for the packed, pruned ViT,
on the card; the port of the reference package's ``serving/vision.py``.

* Admission rides the ``Scheduler`` (one admit/retire event stream,
  policy-pluggable — FIFO, shortest-prompt-first, prune-pressure-aware).
* Execution walks the per-stage segmentation of ``forward_vit_packed``
  (``core.packed_runner.vit_segments``): prune boundaries are batching
  boundaries. Each engine step advances every in-flight image one segment.
* Between segments the ``TilePlanner`` prices the ragged population with
  the accelerator cost model and emits an ``ExecutionPlan``: dense
  token-count tiles (grouped by the ``RaggedBatcher``, optionally merged),
  express-lane fused trajectories for bucket-singleton requests, and
  deadline-driven tile splits. ``VisionEngineConfig.planner="off"`` is the
  identity plan.
* Staging pads and stacks the members' activations on the device; the
  ``StepPipeline`` records one CUDA event per step and waits on it only
  when the step completes, so at depth 2 the host stages step N+1 while
  the card runs step N.

Exactness: the kernels compute every row with the same code whatever the
batch (``kernels/csrc``), so a request's logits do not depend on the rows
it shares a tile with, except through the plain PyTorch parts (embed,
LayerNorm, MLP and head matmuls), where cuBLAS — or the CPU's BLAS — may
pick another algorithm for another batch size. The engine is therefore
held to its offline oracle (``forward_vit_packed``) within a stated
tolerance, and bitwise only where those libraries allow it.

Requests may carry per-request keep rates (``r_t``) and arbitrary patch
counts — both sources of raggedness; ``arrival_step`` staggers admission.
A request may ask for soft pruning (``soft_prune``: a package token
carries the dropped tokens' mass across TDM layers). An engine serves at
a precision tier (``VisionEngineConfig.precision``): at ``fp16`` or
``int8`` the planner prices each request's trajectory at fp32 and at the
tier and takes the cheaper, and ``quality="strict"`` requests stay fp32.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import packed_runner as PR
from repro_torch.core import quant as Q
from repro_torch.core.complexity import vit_num_tokens
from repro_torch.kernels.backend import host_to_device, resolve_device
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.serving.planner import (PLANNER_MODES, PlanItem,
                                         TileCostModel, TilePlanner)
from repro_torch.serving.pipeline import StagedStep, StepPipeline, StepReport
from repro_torch.serving.quality import (QUALITY_MODES, QualityConfig,
                                         QualityController)
from repro_torch.serving.ragged_batcher import RaggedBatcher
from repro_torch.serving.scheduler import Scheduler

__all__ = ["VisionRequest", "VisionEngineConfig", "VisionEngine"]


@dataclasses.dataclass
class VisionRequest:
    uid: int
    patches: np.ndarray              # [n_patches, patch²·3] float32
    r_t: Optional[float] = None      # per-request TDM keep rate (None = cfg)
    arrival_step: int = 0            # engine step at which it may be admitted
    deadline_ms: Optional[float] = None  # wall-clock SLO from admission; the
    # planner carves the request into smaller, first-dispatched tiles when
    # its modeled slack runs out, and the admission annotation below shrinks
    # so prune_pressure_aware admits tight-deadline requests earlier
    keep_schedule: Optional[Tuple[float, ...]] = None  # explicit per-TDM
    # keep schedule (one entry per TDM segment, in segment order) —
    # overrides r_t; None broadcasts r_t over every TDM step
    quality: Optional[str] = None    # accuracy/latency preference for the
    # QualityController: "strict" pins the base schedule even under load,
    # "degrade" invites maximum tightening, None follows the engine mode.
    soft_prune: bool = False         # soft-pruning TDM: dropped tokens fold
    # into a persistent package token (TP.tdm_soft) instead of a fresh
    # fused token at every TDM
    logits: Optional[np.ndarray] = None
    done: bool = False
    prune_load: Optional[float] = None   # predicted post-prune token load
    # (sum of the per-segment token counts, deadline-discounted; set at
    # submit and refreshed each admission pass for waiting deadline
    # requests — the prune_pressure_aware admission policy reads it)
    prune_load_base: Optional[float] = None  # undiscounted load (engine-set)
    solo_ms: Optional[float] = None  # modeled solo latency (engine-set)
    submit_t: Optional[float] = None  # monotonic submit time (engine-set)

    @property
    def n_patches(self) -> int:
        return int(self.patches.shape[0])


@dataclasses.dataclass
class VisionEngineConfig:
    max_batch: int = 8        # in-flight image slots
    token_tile: int = 1       # bucket quantization (1 = exact tiles)
    mode: str = "balanced"    # 'balanced' buckets | 'naive' pad-to-max
    planner: str = "off"      # TilePlanner mode: off|merge|fuse|full
    use_tdm: Optional[bool] = None   # None = cfg.pruning.token_pruning_enabled
    pipeline_depth: int = 1   # StepPipeline depth: 1 = synchronous,
    # 2 = double-buffered (host plans/stages step N+1 while the card
    # executes step N)
    quality: str = "strict"   # QualityController mode: strict = off,
    # auto = tighten keep rates with queue/deadline pressure,
    # degrade = shed-load floor
    keep_levels: Tuple[float, ...] = (1.0, 0.85, 0.7, 0.55, 0.4)
    # quantized keep-rate grid the controller resolves onto (bounds the
    # distinct TDM k values, hence dispatch shapes)
    keep_floor: float = 0.4   # no request is ever tightened below this
    precision: str = "fp32"   # serving precision tier: at "fp16"/"int8"
    # the planner prices each request's trajectory at fp32 AND the tier
    # and picks the cheaper (fp32 ties win); quality="strict" requests stay
    # fp32. Encoder segments only: embed and head run fp32 at every tier.
    quant_granularity: str = "channel"  # int8 scales: "block" = one per
    # kept block, "channel" = one per output channel of each kept block

    def __post_init__(self):
        if self.precision not in Q.PRECISIONS:
            raise ValueError(f"VisionEngineConfig.precision must be one of "
                             f"{Q.PRECISIONS}, got {self.precision!r}")
        if self.quant_granularity not in Q.GRANULARITIES:
            raise ValueError(f"VisionEngineConfig.quant_granularity must be "
                             f"one of {Q.GRANULARITIES}, "
                             f"got {self.quant_granularity!r}")
        if self.max_batch <= 0:
            raise ValueError(f"VisionEngineConfig.max_batch must be a "
                             f"positive slot count, got {self.max_batch}")
        if self.pipeline_depth <= 0:
            raise ValueError(f"VisionEngineConfig.pipeline_depth must be "
                             f">= 1, got {self.pipeline_depth}")
        if self.token_tile <= 0:
            raise ValueError(f"VisionEngineConfig.token_tile must be "
                             f"positive, got {self.token_tile}")
        if self.mode not in ("balanced", "naive"):
            raise ValueError(f"VisionEngineConfig.mode must be 'balanced' "
                             f"or 'naive', got {self.mode!r}")
        if self.planner not in PLANNER_MODES:
            raise ValueError(f"VisionEngineConfig.planner must be one of "
                             f"{PLANNER_MODES}, got {self.planner!r}")
        if self.planner != "off" and self.mode != "balanced":
            raise ValueError(f"planner {self.planner!r} requires "
                             f"mode='balanced' (got {self.mode!r})")
        self.quality_config = QualityConfig(mode=self.quality,
                                            keep_levels=self.keep_levels,
                                            keep_floor=self.keep_floor)


@dataclasses.dataclass
class _Live:
    """Per-slot in-flight state: the request, its current activation
    (unpadded, on the device) and where it is in the segment plan."""
    req: VisionRequest
    seg_idx: int
    x: torch.Tensor      # patches (pre-embed) or [n_tokens, D] activations
    n_tokens: int        # real rows of x (grouping key)
    schedule: Tuple[float, ...]  # BASE per-TDM keep schedule
    soft: bool = False   # package-token soft TDM for this request
    pkg_mass: Optional[torch.Tensor] = None  # carried package mass (0-d,
    # on the device) after the first soft TDM; updated at dispatch
    admit_t: float = 0.0  # monotonic admission time (deadline slack base)
    precision: str = "fp32"  # execution precision chosen at admission
    # (planner-priced; "strict" quality pins fp32), fixed per request so
    # its tiles stay precision-uniform


class VisionEngine:
    """Single-host engine for packed-ViT serving. Exposes the layers as
    ``.scheduler`` / ``.planner`` (owning ``.batcher``) / ``.segments``."""

    def __init__(self, cfg: ModelConfig, params: Dict, packed: Dict,
                 vc: Optional[VisionEngineConfig] = None,
                 policy: "str | Callable" = "fifo",
                 cost_model: Optional[TileCostModel] = None,
                 tracer: Optional[Tracer] = None,
                 device: "str | torch.device" = "cuda"):
        if cfg.family != "vit":
            raise ValueError(f"VisionEngine serves the 'vit' family, "
                             f"got {cfg.family!r}")
        self.cfg = cfg
        self.vc = vc if vc is not None else VisionEngineConfig()
        self.device = resolve_device(device)
        self.segments = PR.PackedVitSegments(
            cfg, params, packed, use_tdm=self.vc.use_tdm, device=self.device,
            quant_granularity=self.vc.quant_granularity)
        if self.vc.precision != "fp32":
            # quantize the tier's weights now: done lazily, the int8 pass
            # would read the blocks back to the host inside a serve
            self.segments.packed_for(self.vc.precision)
        self.scheduler = Scheduler(self.vc.max_batch, policy=policy)
        self.batcher = RaggedBatcher(token_tile=self.vc.token_tile,
                                     mode=self.vc.mode,
                                     max_batch=self.vc.max_batch)
        self.planner = TilePlanner(
            self.batcher,
            cost_model if cost_model is not None else TileCostModel(cfg),
            mode=self.vc.planner,
            quality=QualityController(self.vc.quality_config,
                                      num_slots=self.vc.max_batch))
        self._live: Dict[int, _Live] = {}   # slot -> state
        # not-yet-arrived requests as (absolute arrival step, request)
        self._pending: List[Any] = []
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.pipeline = StepPipeline(self.vc.pipeline_depth,
                                     tracer=self.tracer, device=self.device)
        # speculative next-step plan from plan_ahead: (population
        # fingerprint it is valid for, plan)
        self._plan_cache: Optional[Any] = None
        self.plan_ahead_hits = 0
        self.plan_ahead_drops = 0
        self.steps = 0
        self.images_served = 0
        # tiles + lanes dispatched per execution precision, and how many of
        # them ran the int8 dequant-in-kernel SBMM (counted at dispatch)
        self.precision_dispatches: Dict[str, int] = {
            p: 0 for p in Q.PRECISIONS}
        self.dequant_dispatches = 0
        self._n_patches_max = vit_num_tokens(cfg) - 1
        self._use_tdm = (cfg.pruning.token_pruning_enabled
                         if self.vc.use_tdm is None else self.vc.use_tdm)
        # _tdm_before[si] = how many TDM segments precede plan index si —
        # the keep-schedule index of the NEXT TDM at seg_idx=si
        self._tdm_before: List[int] = []
        n_tdm = 0
        for seg in self.segments.plan:
            self._tdm_before.append(n_tdm)
            if seg[0] == "tdm":
                n_tdm += 1
        self._tdm_before.append(n_tdm)  # seg_idx == len(plan) (finished)
        self._n_tdm = n_tdm

    @classmethod
    def from_pruned(cls, cfg: ModelConfig, params: Dict, scores: Dict,
                    vc: Optional[VisionEngineConfig] = None,
                    policy: "str | Callable" = "fifo",
                    tracer: Optional[Tracer] = None,
                    device: "str | torch.device" = "cuda") -> "VisionEngine":
        """Harden the pruning and build the engine: masks the dense params
        (the DBMM path) and SBMM-packs the attention weights."""
        from repro_torch.models import model as M
        from repro_torch.models import pruning_glue as PG
        dev = resolve_device(device)
        params = M.to_device(params, dev)
        scores = {k: v.to(dev) for k, v in scores.items()}
        masked = PG.apply_pruning(cfg, params, scores)
        packed = PR.pack_model(cfg, params, scores)
        return cls(cfg, masked, packed, vc=vc, policy=policy, tracer=tracer,
                   device=dev)

    @property
    def events(self):
        return self.scheduler.events

    # -- public API --------------------------------------------------------
    def serve(self, requests: Sequence[VisionRequest]
              ) -> Dict[int, np.ndarray]:
        """Serve ``requests`` to completion; returns {uid: logits}."""
        out: Dict[int, np.ndarray] = {}
        self.enqueue(requests)
        while self._pending or self.scheduler.has_work():
            self.tick(out)
        self.finish()
        return out

    def enqueue(self, requests: Sequence[VisionRequest]) -> None:
        """Validate + annotate ``requests`` and queue them for admission
        (``arrival_step`` relative to the CURRENT engine step)."""
        base = self.steps
        for r in requests:  # validate ALL before enqueueing ANY
            self._validate(r)
        for r in requests:
            if r.prune_load is None:
                sched = self._base_schedule(r)
                traj = PR.token_trajectory(
                    self.cfg, r.n_patches, use_tdm=self._use_tdm,
                    schedule=sched if self._use_tdm else None,
                    soft=r.soft_prune)
                r.prune_load_base = float(sum(traj))
                r.prune_load = r.prune_load_base
                r.submit_t = time.monotonic()
                if r.deadline_ms is not None:
                    cm = self.planner.cost_model
                    r.solo_ms = cm.ms(cm.trajectory_cycles(
                        self._traj_from(0, r.n_patches, sched, r.soft_prune,
                                        precision=self._precision_for(r))))
                    r.prune_load *= min(1.0, r.deadline_ms
                                        / max(r.solo_ms, 1e-9))
            self._pending.append((base + r.arrival_step, r))
        self._pending.sort(key=lambda ar: ar[0])
        self._plan_cache = None  # stale speculation from a previous batch

    def tick(self, out: Dict[int, np.ndarray]) -> StepReport:
        """One serve-loop iteration: retire finished slots, admit due
        arrivals, stage + dispatch one engine step through the pipeline."""
        self._retire_finished()
        self._admit_arrivals()
        self._refresh_prune_loads(time.monotonic())
        live_before = {st.req.uid for st in self._live.values()}
        cycles_before = self.planner.modeled_cycles
        staged = None
        while True:
            # requests submitted after staging began belong in THIS plan:
            # drop the staged step (leaks nothing) and replan
            sub_mark = self.scheduler.submitted_total
            self.scheduler.schedule()
            self._sync_admissions()
            if not self._live:
                break
            staged = self._stage_step(out)
            if self.scheduler.submitted_total == sub_mark:
                break
            self.pipeline.drop(staged)
            staged = None
        admitted = tuple(sorted(
            {st.req.uid for st in self._live.values()} - live_before))
        if staged is None:
            if self._pending or self.scheduler.has_work():
                self.steps += 1  # nothing admitted yet: advance time
            return StepReport(dispatched=False, admitted=admitted)
        self.pipeline.submit(staged)
        n_segs = len(self.segments.plan)
        completed = tuple(sorted(
            st.req.uid for st in self._live.values()
            if st.seg_idx >= n_segs))
        return StepReport(
            dispatched=True,
            modeled_ms=self.planner.cost_model.ms(
                self.planner.modeled_cycles - cycles_before),
            admitted=admitted, completed=completed)

    def finish(self) -> None:
        """Drain the pipeline and retire the finished slots."""
        self.pipeline.flush()
        self._retire_finished()

    def modeled_request_ms(self, r: VisionRequest,
                           schedule: Optional[Sequence[float]] = None
                           ) -> float:
        """Cost-model price (ms) of serving ``r`` solo from scratch."""
        sched = (tuple(float(v) for v in schedule) if schedule is not None
                 else self._base_schedule(r))
        cm = self.planner.cost_model
        return cm.ms(cm.trajectory_cycles(
            self._traj_from(0, r.n_patches, sched, r.soft_prune,
                            precision=self._precision_for(r))))

    def modeled_backlog_ms(self) -> float:
        """Modeled time to drain the engine's current commitment."""
        cm = self.planner.cost_model
        ms = sum(self.modeled_request_ms(r) for r in self.scheduler.waiting)
        for st in self._live.values():
            ms += cm.ms(cm.trajectory_cycles(self._traj_from(
                st.seg_idx, st.n_tokens, st.schedule, st.soft,
                precision=st.precision)))
        return ms

    def stats(self) -> Dict[str, Any]:
        buckets = self.batcher.bucket_count
        trajectories = self.planner.trajectory_count
        return {
            "images_served": self.images_served,
            "steps": self.steps,
            "admissions": self.scheduler.num_admissions,
            "compile_count": self.segments.compile_count,
            "jit_compile_count": self.segments.jit_compile_count(),
            "bucket_count": buckets,
            "trajectory_count": trajectories,
            "compile_budget": buckets + trajectories,
            "plan_ahead_hits": self.plan_ahead_hits,
            "plan_ahead_drops": self.plan_ahead_drops,
            "precision": self.vc.precision,
            **{f"dispatch_{p}": n
               for p, n in self.precision_dispatches.items()},
            "dequant_dispatches": self.dequant_dispatches,
            **{f"sched_{k}": v for k, v in self.scheduler.stats().items()},
            **{f"pipeline_{k}": v for k, v in self.pipeline.stats().items()},
            **{f"batcher_{k}": v for k, v in self.batcher.stats().items()},
            **{f"plan_{k}": v for k, v in self.planner.stats().items()},
            **{f"quality_{k}": v
               for k, v in self.planner.quality.stats().items()},
        }

    def export_metrics(self, registry: MetricsRegistry,
                       prefix: str = "vision") -> MetricsRegistry:
        """Fold this engine's observable state into ``registry``."""
        registry.absorb(prefix, self.stats())
        p = self.pipeline.stats()
        registry.gauge(f"{prefix}.plan_cost_error").set(p["cost_error"])
        for lvl, n in sorted(self.planner.quality.level_counts.items()):
            registry.gauge(
                f"{prefix}.quality_tightened_level_{lvl:g}").set(n)
        return registry

    def quantization_report(self) -> Dict[str, Any]:
        """Weight-quantization accounting at the engine's tier: the max-abs
        weight delta against the fp32 packed dict and the packed model size
        at both tiers (surviving blocks + headers + scales, at their dtype
        widths). An fp32 engine reports zero error without quantizing."""
        fp32_bytes = Q.packed_dict_nbytes(self.segments.packed)
        rep = {"precision": self.vc.precision,
               "granularity": self.vc.quant_granularity,
               "packed_bytes_fp32": fp32_bytes,
               "packed_bytes": fp32_bytes,
               "quant_max_abs_error": 0.0}
        if self.vc.precision != "fp32":
            qd = self.segments.packed_for(self.vc.precision)
            rep["packed_bytes"] = Q.packed_dict_nbytes(qd)
            rep["quant_max_abs_error"] = Q.max_abs_error(
                self.segments.packed, qd)
        return rep

    # -- engine internals --------------------------------------------------
    def _validate(self, r: VisionRequest) -> None:
        n = r.n_patches
        if not 1 <= n <= self._n_patches_max:
            raise ValueError(
                f"request {r.uid}: {n} patches outside "
                f"[1, {self._n_patches_max}] (pos-table capacity for "
                f"image_size={self.cfg.image_size}, "
                f"patch_size={self.cfg.patch_size})")
        pdim = self.cfg.patch_size ** 2 * 3
        if r.patches.shape[-1] != pdim:
            raise ValueError(f"request {r.uid}: patch dim "
                             f"{r.patches.shape[-1]} != {pdim}")
        r_t = self.cfg.pruning.r_t if r.r_t is None else r.r_t
        if not (math.isfinite(r_t) and 0.0 < r_t <= 1.0):
            raise ValueError(f"request {r.uid}: r_t must be finite in "
                             f"(0, 1], got {r_t}")
        if r.deadline_ms is not None and not (
                math.isfinite(r.deadline_ms) and r.deadline_ms > 0.0):
            raise ValueError(f"request {r.uid}: deadline_ms must be finite "
                             f"and positive, got {r.deadline_ms}")
        if r.keep_schedule is not None:
            ks = tuple(float(v) for v in r.keep_schedule)
            if self._use_tdm and len(ks) != self._n_tdm:
                raise ValueError(
                    f"request {r.uid}: keep_schedule has {len(ks)} entries, "
                    f"model has {self._n_tdm} TDM segments")
            for v in ks:
                if not (math.isfinite(v) and 0.0 < v <= 1.0):
                    raise ValueError(f"request {r.uid}: keep_schedule "
                                     f"entries must be finite in (0, 1], "
                                     f"got {v}")
        if r.quality is not None and r.quality not in QUALITY_MODES:
            raise ValueError(f"request {r.uid}: quality must be one of "
                             f"{QUALITY_MODES}, got {r.quality!r}")

    def _admit_arrivals(self) -> None:
        arrived = [r for at, r in self._pending if at <= self.steps]
        if arrived:
            self._pending = [(at, r) for at, r in self._pending
                             if at > self.steps]
            self.scheduler.submit(arrived)

    def _sync_admissions(self) -> None:
        """Initialize in-flight state for slots the Scheduler filled; the
        request's patches go to the device here, once, without a stream
        sync (the previous step may still be running)."""
        for slot, req in self.scheduler.running.items():
            if slot in self._live:
                continue
            self._live[slot] = _Live(
                req=req, seg_idx=0,
                x=host_to_device(req.patches, self.device),
                n_tokens=req.n_patches,
                schedule=self._base_schedule(req),
                soft=req.soft_prune,
                admit_t=time.monotonic(),
                precision=self._precision_for(req, record=True))

    def _precision_for(self, r: VisionRequest, record: bool = False) -> str:
        """Execution precision for ``r``. fp32 engines and
        ``quality="strict"`` requests take fp32 without asking the planner;
        otherwise the planner prices the request's whole trajectory at fp32
        and at the engine's tier and takes the strictly cheaper (fp32 on a
        tie). ``record=True`` only at admission, so pricing probes do not
        count as decisions."""
        if self.vc.precision == "fp32" or r.quality == "strict":
            return "fp32"
        sched = self._base_schedule(r)
        cands = [(p, self._traj_from(0, r.n_patches, sched, r.soft_prune,
                                     precision=p))
                 for p in ("fp32", self.vc.precision)]
        return self.planner.choose_precision(cands, record=record)

    def _base_schedule(self, r: VisionRequest) -> Tuple[float, ...]:
        """The request's own per-TDM keep schedule BEFORE any controller
        tightening."""
        if r.keep_schedule is not None:
            return tuple(float(v) for v in r.keep_schedule)
        return PR.keep_schedule(self.cfg, r_t=r.r_t, use_tdm=self._use_tdm)

    def _refresh_prune_loads(self, now: float) -> None:
        """Re-discount waiting deadline requests' ``prune_load`` by their
        CURRENT slack each admission pass."""
        for req in self.scheduler.waiting:
            if (req.deadline_ms is None or req.prune_load_base is None
                    or req.solo_ms is None or req.submit_t is None):
                continue
            left = req.deadline_ms - (now - req.submit_t) * 1e3
            req.prune_load = req.prune_load_base * min(
                1.0, max(left, 0.0) / max(req.solo_ms, 1e-9))

    def _traj_from(self, seg_idx: int, n_tokens: int,
                   schedule: Sequence[float], soft: bool = False,
                   precision: str = "fp32"):
        """Remaining (stage key, entry token count) trajectory from segment
        ``seg_idx`` at ``n_tokens`` real tokens under ``schedule``. A
        stage key is ``(si, segment, k[, "soft"][, precision])`` — the
        batcher grouping identity: the static keep count at TDM segments
        (tiles must be k-uniform), a ``"soft"`` marker on soft TDM stages
        (soft and hard requests never share a TDM tile), and the precision
        on the weight-bearing (layers/tdm) stages of a non-fp32 request
        (embed and head run fp32 and batch across tiers). Offsets align
        with engine steps, which the planner's fusion and deadline logic
        rely on."""
        mark = () if precision == "fp32" else (precision,)
        entries = []
        n = n_tokens
        ti = self._tdm_before[seg_idx]
        for si in range(seg_idx, len(self.segments.plan)):
            seg = self.segments.plan[si]
            if seg[0] == "tdm":
                r = schedule[ti]
                if soft:
                    k = PR.tdm_soft_keep_count(n, r, has_pkg=ti > 0)
                    entries.append(((si, seg, k, "soft") + mark, n))
                else:
                    k = PR.tdm_keep_count(n, r)
                    entries.append(((si, seg, k) + mark, n))
                n = k + 2
                ti += 1
            elif seg[0] == "layers":
                entries.append(((si, seg, None) + mark, n))
            else:
                entries.append(((si, seg, None), n))
                if seg[0] == "embed":
                    n += 1  # + CLS
        return tuple(entries)

    def _resolve_schedule(self, st: _Live, now: float) -> Tuple[float, ...]:
        """The EFFECTIVE keep schedule for this staging pass (the
        QualityController's resolution; identity when it is off)."""
        q = self.planner.quality
        if not q.enabled:
            return st.schedule
        done = self._tdm_before[st.seg_idx]
        left = rem = None
        if st.req.deadline_ms is not None:
            left = st.req.deadline_ms - (now - st.admit_t) * 1e3
            cm = self.planner.cost_model

            def rem(sched, _st=st, _cm=cm):
                return _cm.ms(_cm.trajectory_cycles(self._traj_from(
                    _st.seg_idx, _st.n_tokens, sched, _st.soft,
                    precision=_st.precision)))

        return q.resolve(st.schedule, done=done,
                         preference=st.req.quality,
                         queue_depth=self.scheduler.queue_depth,
                         deadline_left_ms=left, remaining_ms=rem)

    def _plan_item(self, st: _Live, now: float,
                   schedule: Sequence[float]) -> PlanItem:
        traj = self._traj_from(st.seg_idx, st.n_tokens, schedule, st.soft,
                               precision=st.precision)
        left = None
        if st.req.deadline_ms is not None:
            left = st.req.deadline_ms - (now - st.admit_t) * 1e3
        return PlanItem(stage=traj[0][0], n_tokens=st.n_tokens,
                        cap=self._token_cap(st), trajectory=traj,
                        deadline_left_ms=left)

    @staticmethod
    def _parse_stage(stage) -> Tuple[Tuple, Optional[int], bool, str]:
        """A stage key ``(si, segment, k[, "soft"][, precision])`` as
        ``(segment, k, soft, precision)``: the inverse of ``_traj_from``'s
        keys ("soft" is not a precision, so the markers cannot collide)."""
        seg, k = stage[1], stage[2]
        rest = stage[3:]
        precision = next((m for m in rest if m in Q.PRECISIONS), "fp32")
        return seg, k, "soft" in rest, precision

    def _token_cap(self, st: _Live) -> Optional[int]:
        """Hard bound on the padded token tile: the embed stage indexes the
        position table, so its tile must never pad past the table's patch
        capacity."""
        if self.segments.plan[st.seg_idx][0] == "embed":
            return self._n_patches_max
        return None

    def step(self, out: Dict[int, np.ndarray]) -> None:
        """Synchronously advance the in-flight population one step."""
        self.pipeline.submit(self._stage_step(out))
        self.pipeline.flush()
        self._retire_finished()

    def _next_plan(self, items: List[PlanItem]):
        """This step's ExecutionPlan, via the plan-ahead cache when the
        population matches the prediction."""
        key = self._items_fingerprint(items)
        cached, self._plan_cache = self._plan_cache, None
        if cached is not None:
            ckey, cplan = cached
            if key is not None and ckey == key:
                self.plan_ahead_hits += 1
                return cplan
            self.plan_ahead_drops += 1
        plans = self.planner.plan_ahead(items, self.pipeline.depth)
        if len(plans) > 1 and key is not None:
            nxt = self.planner.advance_items(items, plans[0])
            if nxt:
                self._plan_cache = (self._items_fingerprint(nxt), plans[1])
        return plans[0]

    @staticmethod
    def _items_fingerprint(items: List[PlanItem]):
        """Population identity the plan cache keys on; ``None`` (never
        cache) when any item carries a deadline."""
        if any(it.deadline_left_ms is not None for it in items):
            return None
        return tuple((it.stage, it.n_tokens, it.cap, it.trajectory)
                     for it in items)

    def _stage_step(self, out: Dict[int, np.ndarray]) -> StagedStep:
        """Stage one engine step: plan the population, build every tile's
        padded input batch on the device (pad + stack of device tensors —
        no host round trip) and every lane's entry activation, and close
        over them in a :class:`StagedStep`. Staging mutates NO engine
        state, so a staged step can be dropped for a replan."""
        slots = sorted(self._live)
        now = time.monotonic()
        tr = self.tracer
        if tr.enabled:
            tr.begin("plan", track="engine", step=self.steps,
                     population=len(slots))
        eff = {s: self._resolve_schedule(self._live[s], now) for s in slots}
        items = [self._plan_item(self._live[s], now, eff[s]) for s in slots]
        plan = self._next_plan(items)
        if tr.enabled:
            tr.end("plan", track="engine")
        n_urgent = plan.urgent_tile_count()
        n_segs = len(self.segments.plan)

        q_dec = q_tight = q_dl = 0
        q_levels: List[float] = []
        q = self.planner.quality
        if q.enabled:
            depth = self.scheduler.queue_depth
            for s in slots:
                st = self._live[s]
                done = self._tdm_before[st.seg_idx]
                pairs = list(zip(st.schedule[done:], eff[s][done:]))
                q_dec += len(pairs)
                hit = [e for b, e in pairs if e < b - 1e-12]
                q_tight += len(hit)
                q_levels.extend(hit)
                if st.req.deadline_ms is not None and hit:
                    e0 = q.resolve(st.schedule, done=done,
                                   preference=st.req.quality,
                                   queue_depth=depth)
                    q_dl += sum(1 for a, b in zip(e0[done:], eff[s][done:])
                                if b < a - 1e-12)

        if tr.enabled:
            tr.begin("stage", track="engine", step=self.steps,
                     tiles=len(plan.tiles), lanes=len(plan.lanes))
        tile_runs = []
        for tile in plan.tiles:
            member_slots = [slots[i] for i in tile.members]
            states = [self._live[s] for s in member_slots]
            # the stage key decides what runs; states only supply data
            seg, k, soft, prec = self._parse_stage(tile.stage)
            feat = states[0].x.shape[-1]
            rows = [F.pad(st.x, (0, 0, 0, tile.n_tile - st.n_tokens))
                    for st in states]
            if tile.b_tile > len(states):
                zero = torch.zeros((tile.n_tile, feat), dtype=torch.float32,
                                   device=self.device)
                rows += [zero] * (tile.b_tile - len(states))
            batch = torch.stack(rows)
            n_valid = None
            if tile.needs_mask and seg[0] in ("layers", "tdm"):
                n_valid = np.fromiter(
                    (st.n_tokens for st in states), np.int32, len(states))
                n_valid = np.concatenate(
                    [n_valid, np.full(tile.b_tile - len(states), tile.n_tile,
                                      np.int32)])
            pkg_mass = None
            if soft and self._tdm_before[tile.stage[0]] > 0:
                # every member past its first soft TDM carries a package
                # mass; batch-pad rows get 0 (their packages are don't-care)
                pkg_mass = torch.stack([st.pkg_mass for st in states])
                if tile.b_tile > len(states):
                    pkg_mass = F.pad(pkg_mass,
                                     (0, tile.b_tile - len(states)))
            tile_runs.append((member_slots, seg, k, soft, prec, batch,
                              n_valid, pkg_mass))

        lane_runs = []
        for lane in plan.lanes:
            slot = slots[lane.member]
            st = self._live[slot]
            steps = []
            for stage, _ in lane.trajectory:
                seg, k, soft, _prec = self._parse_stage(stage)
                steps.append((seg, k, True) if soft else (seg, k))
            seed = None if st.pkg_mass is None else st.pkg_mass.reshape(1)
            lane_runs.append((slot, tuple(steps), st.x[None], seed))
        if tr.enabled:
            tr.end("stage", track="engine")

        produced: List[Any] = []  # (req, logits row on the host)

        def emit(req, y, row):
            # enqueue the copy to pinned host memory now; the pipeline's
            # event covers it, so completion reads it without another wait
            produced.append((req, y[row].to("cpu", non_blocking=True)))

        def count_dispatch(prec):
            self.precision_dispatches[prec] += 1
            if prec == "int8":
                self.dequant_dispatches += 1

        def run_tile(run):
            (member_slots, seg, k, soft, prec, batch, n_valid,
             pkg_mass) = run
            count_dispatch(prec)
            mass = None
            if soft:
                y, mass = self.segments.run(seg, batch, n_valid=n_valid, k=k,
                                            soft=True, pkg_mass=pkg_mass,
                                            precision=prec)
            else:
                y = self.segments.run(seg, batch, n_valid=n_valid, k=k,
                                      precision=prec)
            kind = seg[0]
            for b, slot in enumerate(member_slots):
                st = self._live[slot]
                if kind == "embed":
                    st.n_tokens += 1          # + CLS
                    st.x = y[b, : st.n_tokens]
                elif kind == "layers":
                    st.x = y[b, : st.n_tokens]
                elif kind == "tdm":
                    st.n_tokens = k + 2       # CLS + k kept + fused/package
                    st.x = y[b, : st.n_tokens]
                    if soft:
                        st.pkg_mass = mass[b]
                else:  # head
                    emit(st.req, y, b)
                st.seg_idx += 1
            return y

        def dispatch():
            # urgent tiles (the plan's leading tiles) dispatch BEFORE lanes
            handles = [run_tile(run) for run in tile_runs[:n_urgent]]
            for slot, steps, x1, seed in lane_runs:
                st = self._live[slot]
                count_dispatch(st.precision)
                y = self.segments.run_fused(steps, x1, pkg_mass=seed,
                                            precision=st.precision)
                emit(st.req, y, 0)
                st.seg_idx = n_segs
                handles.append(y)
            handles += [run_tile(run) for run in tile_runs[n_urgent:]]
            self.planner.commit(plan)
            if q.enabled:
                q.record(q_dec, q_tight, q_levels,
                         deadline_tightened=q_dl)
            self.steps += 1
            return handles

        def complete(handles):
            for req, logits in produced:
                req.logits = logits.numpy()
                req.done = True
                out[req.uid] = req.logits

        return StagedStep(dispatch=dispatch, complete=complete,
                          label=f"vit-step-{self.steps}",
                          modeled_ms=self.planner.cost_model.ms(
                              plan.stats.modeled_cycles))

    def _retire_finished(self) -> None:
        """Free slots whose trajectory completed (host-deterministic given
        the dispatched plans; the logits materialize at the step's
        completion)."""
        n_segs = len(self.segments.plan)
        for slot in sorted(self._live):
            st = self._live[slot]
            if st.seg_idx >= n_segs:
                self.scheduler.retire(slot)
                del self._live[slot]
                self.images_served += 1
