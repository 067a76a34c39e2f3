"""ServeEngine — LM serving as a thin composition of three layers; the port
of the reference package's ``serving/engine.py`` apart from elastic
degradation (ROADMAP queue A, item 9).

* ``Scheduler``      (``serving.scheduler``) — admission/retirement policy
  over waiting + in-flight requests; owns the ``("admit", uid)`` /
  ``("retire", uid)`` event stream.
* ``KVCacheManager`` (``serving.cache_manager``) — per-slot cache state:
  the live caches, per-slot ``length`` / ``valid_start`` host mirrors,
  prefix-length bucketing, capacity accounting and the dynamic KV-prune
  cadence.
* ``ModelRunner``    (``serving.runner``) — the prefill / per-slot
  prefill / decode steps and the ledger of step shapes.

Serve paths
-----------
* ``serve(requests)`` — static waves: up to ``max_batch`` requests prefill
  together and decode in lockstep until the longest request finishes.
  Each step's tokens are read before the next step (a step boundary).
* ``serve(requests, continuous=True)`` — continuous batching with
  ``max_batch`` fixed decode slots, driven through the ``StepPipeline``:
  each step is staged (host bookkeeping, snapshot-protected), dispatched
  (device work chained through the pending next-token vector and the
  caches, which the steps update in place) and completed (the tokens,
  copied to pinned host memory at dispatch, read after the step's CUDA
  event) as separate phases. Admission prefills only the admitted prompt
  (per-slot prefill into its row of the live cache); with
  ``per_slot_prefill=False`` every admission re-prefills the whole batch.
  ``pipeline_depth`` 2 stages step N+1 while the card runs step N; depth
  1 reproduces the synchronous loop step for step.

Per-slot cache geometry: every ``KVCache.length`` is ``[B]``, each row
reads and writes at its own position, and RoPE phases count real tokens
(cache slot − ``valid_start``), so per-slot prefill equals whole-batch
left-padded prefill. KV pruning ranks cached tokens by their accumulated
decode attention mass and every ``kv_prune_interval`` steps compacts each
layer's cache to the top ``kv_prune_keep`` fraction.

The engine waits on the card only at step boundaries: the pipeline's step
events on the continuous path, one event per step on the static path.
Everything else it sends to the card goes through pinned asynchronous
copies.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.backend import host_to_device, resolve_device
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.serving.cache_manager import KVCacheManager, prune_kv_caches
from repro_torch.serving.pipeline import StagedStep, StepPipeline, StepReport
from repro_torch.serving.runner import (ModelRunner, build_padded_batch,
                                        require_tokens_only, to_host)
from repro_torch.serving.scheduler import Scheduler

__all__ = ["Request", "EngineConfig", "ServeEngine", "prune_kv_caches"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # [S] int32
    max_new_tokens: int = 16
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    prune_load: Optional[float] = None  # predicted post-prune token load
    # (set at submit when KV pruning is on; the prune_pressure_aware
    # admission policy reads it — see serving.scheduler)


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8          # wave width / continuous decode slots
    max_len: int = 512
    kv_prune_interval: int = 0   # 0 = off
    kv_prune_keep: float = 1.0
    per_slot_prefill: bool = True   # False: whole-batch re-prefill
    prefill_bucket_min: int = 8     # smallest prefix-length bucket
    pipeline_depth: int = 1     # StepPipeline depth: 1 = synchronous,
    # 2 = the host stages step N+1 while the card runs step N (tokens and
    # events identical at any depth)

    def __post_init__(self):
        if self.max_batch <= 0:
            raise ValueError(
                f"EngineConfig.max_batch must be a positive slot count, "
                f"got {self.max_batch}")
        if self.max_len <= 0:
            raise ValueError(
                f"EngineConfig.max_len must be a positive cache capacity "
                f"(tokens), got {self.max_len}")
        if not (0.0 < self.kv_prune_keep <= 1.0):
            raise ValueError(
                f"EngineConfig.kv_prune_keep must be in (0, 1] — the "
                f"fraction of cache entries kept per prune — got "
                f"{self.kv_prune_keep}")
        if self.kv_prune_interval < 0:
            raise ValueError(
                f"EngineConfig.kv_prune_interval must be >= 0 (decode "
                f"steps between prunes; 0 disables pruning), got "
                f"{self.kv_prune_interval}")
        if self.prefill_bucket_min <= 0:
            raise ValueError(
                f"EngineConfig.prefill_bucket_min must be a positive "
                f"bucket width, got {self.prefill_bucket_min}")
        if self.pipeline_depth <= 0:
            raise ValueError(
                f"EngineConfig.pipeline_depth must be >= 1 (1 = "
                f"synchronous stepping), got {self.pipeline_depth}")


class ServeEngine:
    """Single-card LM engine. Construction wires the three layers; they are
    exposed as ``.scheduler`` / ``.cache`` / ``.runner``. ``device`` is the
    card by default; ``"cpu"`` runs the kernels' plain versions."""

    def __init__(self, cfg: ModelConfig, params: Any, ec: EngineConfig,
                 elastic: Any = None,
                 policy: "str | Callable" = "fifo",
                 tracer: Optional[Tracer] = None,
                 device: "str | torch.device" = "cuda"):
        require_tokens_only(cfg)
        if elastic is not None:
            raise NotImplementedError(
                "elastic degradation is not ported yet (ROADMAP queue A, "
                "item 9: distribution and launchers)")
        self.cfg = cfg
        self.ec = ec
        self.device = resolve_device(device)
        self.runner = ModelRunner(cfg, params, device=self.device)
        self.cache = KVCacheManager(cfg, ec, device=self.device)
        self.scheduler = Scheduler(ec.max_batch, policy=policy)
        # wall-clock span tracer: plan/stage spans here, the pipeline adds
        # dispatch/complete; disabled by default
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.pipeline = StepPipeline(ec.pipeline_depth, tracer=self.tracer,
                                     device=self.device)
        # padded tokens run through prefill at admissions
        self.admission_prefill_tokens = 0
        # pipelined continuous-path state: the next-token vector chained
        # step to step (host array at the start, then a device tensor), and
        # the host-side count of tokens DISPATCHED per request uid —
        # retirement is decided from the counts, so slot reuse never waits
        # on in-flight device work
        self._toks: Any = None
        self._scheduled: Dict[int, int] = {}

    @property
    def params(self):
        return self.runner.params

    @property
    def events(self):
        """The Scheduler's event stream."""
        return self.scheduler.events

    @property
    def prune_events(self) -> int:
        return self.cache.prune_events

    # -- public API --------------------------------------------------------
    def serve(self, requests: List[Request],
              continuous: bool = False) -> Dict[int, List[int]]:
        self._annotate_prune_load(requests)
        if continuous:
            return self._serve_continuous(requests)
        out: Dict[int, List[int]] = {}
        for ws in range(0, len(requests), self.ec.max_batch):
            out.update(self._run_wave(requests[ws: ws + self.ec.max_batch]))
        return out

    def stats(self) -> Dict[str, Any]:
        adm = self.scheduler.num_admissions
        return {
            "admissions": adm,
            "admission_prefill_tokens": self.admission_prefill_tokens,
            "prefill_tokens_per_admission":
                self.admission_prefill_tokens / adm if adm else 0.0,
            "compile_count": self.runner.compile_count,
            "jit_compile_count": self.runner.jit_compile_count(),
            "prune_events": self.cache.prune_events,
            **{f"runner_{k}_calls": n
               for k, n in self.runner.calls.items()},
            **{f"sched_{k}": v for k, v in self.scheduler.stats().items()},
            **{f"pipeline_{k}": v for k, v in self.pipeline.stats().items()},
        }

    def export_metrics(self, registry: MetricsRegistry,
                       prefix: str = "lm") -> MetricsRegistry:
        """Fold every numeric ``stats()`` entry into ``registry`` as a
        ``<prefix>.<key>`` gauge."""
        registry.absorb(prefix, self.stats())
        return registry

    def _annotate_prune_load(self, requests: Sequence[Request]) -> None:
        """Predicted post-prune token load for the prune_pressure_aware
        admission policy: prompt + generation, discounted by the KV-prune
        keep rate."""
        keep = self.ec.kv_prune_keep if self.ec.kv_prune_interval else 1.0
        for r in requests:
            if getattr(r, "prune_load", None) is None:
                r.prune_load = (len(r.prompt) + r.max_new_tokens) * keep

    def _host_handle(self, toks: torch.Tensor) -> torch.Tensor:
        """The step's tokens as a host tensor the completion reads: on the
        card an asynchronous copy into pinned memory, valid once the
        step's event has passed."""
        if toks.device.type == "cuda":
            return toks.to("cpu", non_blocking=True)
        return toks

    # -- static-wave path --------------------------------------------------
    def _run_wave(self, wave: List[Request]) -> Dict[int, List[int]]:
        sched, kvm, runner = self.scheduler, self.cache, self.runner
        max_new = max(r.max_new_tokens for r in wave)
        sched.submit(wave)
        admitted = sched.schedule()  # every slot free: the whole wave fits
        toks = np.zeros((self.ec.max_batch,), np.int64)

        if runner.supports_slot_prefill and self.ec.per_slot_prefill:
            kvm.reset()  # the fallback path allocates inside its prefill
            for slot, req in admitted:
                lb, _ = kvm.admit(slot, len(req.prompt), max_new)
                tok, kvm.caches = runner.prefill_slot(
                    np.asarray(req.prompt, np.int32), kvm.caches, slot, lb)
                toks[slot] = tok
                self.admission_prefill_tokens += lb
        else:
            toks = self._prefill_whole_batch(max_new)

        out: Dict[int, List[int]] = {}
        self._append_and_retire(toks, sched.running.keys(), out)
        while sched.running:
            kvm.maybe_prune()
            kvm.on_decode()
            tok_dev, kvm.caches = runner.decode(toks, kvm.caches,
                                                kvm.valid_starts())
            toks = to_host(tok_dev).astype(np.int64)
            self._append_and_retire(toks, sched.running.keys(), out)
        return out

    # -- continuous-batching path ------------------------------------------
    def _serve_continuous(self, requests: List[Request]
                          ) -> Dict[int, List[int]]:
        """``max_batch`` decode slots with per-request admission, driven
        through the ``StepPipeline``. Each step produces at most one token
        per slot: per-slot prefill for slots admitted this step, or one
        batched decode step for the slots already live. Which step
        finishes a request is host-known at dispatch time, so retirement
        and slot reuse never wait on in-flight device work."""
        self.enqueue(requests)
        self.start_continuous()
        out: Dict[int, List[int]] = {}
        while True:
            rep = self.tick_continuous(out)
            if not rep.dispatched:
                break
        self.pipeline.flush()
        return out

    def enqueue(self, requests: Sequence[Request]) -> None:
        """Annotate + submit ``requests`` into the Scheduler (continuous
        path)."""
        self._annotate_prune_load(list(requests))
        self.scheduler.submit(requests)

    def start_continuous(self) -> None:
        """Reset the continuous-serve step state ahead of a
        :meth:`tick_continuous` loop."""
        if (self.runner.supports_slot_prefill
                and self.ec.per_slot_prefill):
            self.cache.reset()  # per-slot admissions write into live
            # caches; the fallback's whole-batch prefill allocates its own
        self._toks = np.zeros((self.ec.max_batch,), np.int64)
        self._scheduled = {}

    def tick_continuous(self, out: Dict[int, List[int]]) -> StepReport:
        """One continuous-batching step: retire dispatched-to-budget
        slots, admit waiting requests, stage + dispatch one step (per-slot
        prefills or a batched decode) through the pipeline. The returned
        :class:`StepReport` carries host-deterministic facts only
        (``work_tokens`` = prompt tokens prefilled + tokens decoded this
        step), identical at every pipeline depth."""
        sched, runner = self.scheduler, self.runner
        use_slot = runner.supports_slot_prefill and self.ec.per_slot_prefill
        self._retire_scheduled()
        if not sched.has_work():
            return StepReport(dispatched=False)
        prefill_mark = self.admission_prefill_tokens
        sched_mark = sum(self._scheduled.values())
        staged: Optional[StagedStep] = None
        admitted: List[Tuple[int, Request]] = []
        tr = self.tracer
        while True:
            sub_mark = sched.submitted_total
            if tr.enabled:
                tr.begin("plan", track="engine")
            admitted.extend(sched.schedule())
            if tr.enabled:
                tr.end("plan", track="engine")
            if admitted and not use_slot:
                break  # sync fallback below; nothing staged to drop
            if tr.enabled:
                tr.begin("stage", track="engine",
                         admissions=len(admitted))
            staged = (self._stage_admissions(admitted, out)
                      if admitted else self._stage_decode(out))
            if tr.enabled:
                tr.end("stage", track="engine")
            if sched.submitted_total == sub_mark:
                break
            # submitted while staging: drop + restage so the request is
            # considered for THIS step's admissions
            self.pipeline.drop(staged)
            staged = None
        if staged is not None:
            self.pipeline.submit(staged)
        else:
            # whole-batch fallback: a re-prefill replaces every cache row
            # at once from prompt + generated-so-far, so drain the
            # pipeline first, then account the step synchronously
            self.pipeline.flush()
            toks = self._reprefill_active()
            produced = [(s, sched.running[s]) for s in sorted(sched.running)]
            for _, req in produced:
                self._scheduled[req.uid] = \
                    self._scheduled.get(req.uid, 0) + 1
            self._toks = toks
            self._complete_tokens(toks, produced, out)
        completed = tuple(sorted(
            req.uid for req in sched.running.values()
            if self._scheduled.get(req.uid, 0) >= req.max_new_tokens))
        return StepReport(
            dispatched=True,
            work_tokens=(self.admission_prefill_tokens - prefill_mark
                         + sum(self._scheduled.values()) - sched_mark),
            admitted=tuple(sorted(r.uid for _, r in admitted)),
            completed=completed)

    def _device_tokens(self) -> torch.Tensor:
        """A fresh device copy of the next-token vector (later steps write
        their own copy, never a tensor a pending completion reads)."""
        if isinstance(self._toks, torch.Tensor):
            return self._toks.clone()
        return host_to_device(self._toks, self.device, np.int64)

    def _stage_admissions(self, admitted: List[Tuple[int, "Request"]],
                          out: Dict[int, List[int]]) -> StagedStep:
        """Stage one admission step: the capacity checks and mirror
        bookkeeping (``kvm.admit``) run now; the per-slot prefills and the
        next-token writes dispatch later."""
        kvm, runner = self.cache, self.runner
        snap = kvm.snapshot()
        plan: List[Tuple[int, Request, np.ndarray, int]] = []
        for slot, req in admitted:
            lb, _ = kvm.admit(slot, len(req.prompt), req.max_new_tokens)
            plan.append((slot, req, np.asarray(req.prompt, np.int32), lb))

        def dispatch():
            toks = self._device_tokens()
            caches = kvm.caches
            for slot, req, prompt, lb in plan:
                tok1, caches = runner.prefill_slot_async(prompt, caches,
                                                         slot, lb)
                toks[slot] = tok1[0]
                self.admission_prefill_tokens += lb
                self._scheduled[req.uid] = \
                    self._scheduled.get(req.uid, 0) + 1
            kvm.caches = caches
            self._toks = toks
            return self._host_handle(toks)

        def complete(host_toks):
            self._complete_tokens(host_toks.numpy(),
                                  [(s, r) for s, r, _, _ in plan], out)

        return StagedStep(dispatch=dispatch, complete=complete,
                          rollback=lambda: kvm.restore(snap),
                          label=f"lm-prefill-x{len(plan)}")

    def _stage_decode(self, out: Dict[int, List[int]]) -> StagedStep:
        """Stage one batched decode step: prune cadence and write-position
        accounting run now against the host mirrors; the decode itself
        dispatches later against the live caches. ``maybe_prune`` rebinds
        ``kvm.caches`` to new compacted tensors — the snapshot keeps the
        pre-prune ones, which nothing has written, so a drop rewinds
        cleanly."""
        sched, kvm, runner = self.scheduler, self.cache, self.runner
        snap = kvm.snapshot()
        kvm.maybe_prune()
        kvm.on_decode()
        starts = kvm.valid_starts()
        produced = [(s, sched.running[s]) for s in sorted(sched.running)]

        def dispatch():
            tok_dev, kvm.caches = runner.decode(self._toks, kvm.caches,
                                                starts)
            self._toks = tok_dev
            for _, req in produced:
                self._scheduled[req.uid] = \
                    self._scheduled.get(req.uid, 0) + 1
            return self._host_handle(tok_dev)

        def complete(host_toks):
            self._complete_tokens(host_toks.numpy(), produced, out)

        return StagedStep(dispatch=dispatch, complete=complete,
                          rollback=lambda: kvm.restore(snap),
                          label="lm-decode")

    def _complete_tokens(self, toks: np.ndarray,
                         produced: List[Tuple[int, "Request"]],
                         out: Dict[int, List[int]]) -> None:
        """Materialize this step's token for every slot that produced one;
        a request that reached its budget is marked done and its output
        recorded. Slot/event bookkeeping is ``_retire_scheduled``'s."""
        for slot, req in produced:
            req.generated.append(int(toks[slot]))
            if len(req.generated) >= req.max_new_tokens:
                req.done = True
                out[req.uid] = list(req.generated)

    def _retire_scheduled(self) -> None:
        """Free every slot whose request has had its full token budget
        DISPATCHED (host-side count — no wait on the card)."""
        sched, kvm = self.scheduler, self.cache
        for slot in sorted(sched.running):
            req = sched.running[slot]
            if self._scheduled.get(req.uid, 0) >= req.max_new_tokens:
                sched.retire(slot)
                kvm.free(slot)
                self._scheduled.pop(req.uid, None)

    # -- shared helpers ----------------------------------------------------
    def _append_and_retire(self, toks: np.ndarray, produced, out) -> None:
        sched, kvm = self.scheduler, self.cache
        for slot in sorted(produced):
            req = sched.running.get(slot)
            if req is None:
                continue
            req.generated.append(int(toks[slot]))
            if len(req.generated) >= req.max_new_tokens:
                req.done = True
                out[req.uid] = list(req.generated)
                sched.retire(slot)
                kvm.free(slot)

    def _prefill_whole_batch(self, max_new: int) -> np.ndarray:
        """Wave-start whole-batch prefill (per-slot prefill disabled):
        every admitted prompt left-padded to a common length."""
        prefixes: List[Optional[np.ndarray]] = [None] * self.ec.max_batch
        for slot, req in self.scheduler.running.items():
            prefixes[slot] = np.asarray(req.prompt, np.int32)
        return self._prefill_prefixes(prefixes, max_new)

    def _reprefill_active(self) -> np.ndarray:
        """Whole-batch re-prefill of every active prefix (prompt +
        generated so far): the continuous path's admission without
        per-slot prefill. Prefill over a prefix is the decode that
        produced it."""
        prefixes: List[Optional[np.ndarray]] = [None] * self.ec.max_batch
        rem = 1
        for slot, req in self.scheduler.running.items():
            p = np.asarray(req.prompt, np.int32)
            if req.generated:
                p = np.concatenate(
                    [p, np.asarray(req.generated, np.int32)])
            prefixes[slot] = p
            rem = max(rem, req.max_new_tokens - len(req.generated))
        return self._prefill_prefixes(prefixes, rem)

    def _prefill_prefixes(self, prefixes, max_new: int) -> np.ndarray:
        kvm, runner = self.cache, self.runner
        L = max(len(p) for p in prefixes if p is not None)
        if L > self.ec.max_len:
            raise RuntimeError(
                f"prompt of {L} tokens exceeds max_len={self.ec.max_len}")
        # worst case before the next re-prefill: the longest (left-padded)
        # prefix decodes until the slowest slot retires
        kvm.check_capacity(L + max_new - 1)
        tokens, starts = build_padded_batch(prefixes)
        kvm.reset()
        tok_dev, kvm.caches = runner.prefill(tokens, starts, kvm.caches)
        kvm.set_batch_state(np.full((self.ec.max_batch,), L),
                            starts if kvm.masked else None)
        kvm.active[:] = [p is not None for p in prefixes]
        n_active = sum(p is not None for p in prefixes)
        self.admission_prefill_tokens += n_active * L
        return to_host(tok_dev).astype(np.int64)
