"""KVCacheManager — owns per-slot serve-cache state and its lifecycle.

One of the three serving layers (Scheduler / KVCacheManager / ModelRunner —
see ``repro_torch.serving.engine``); the port of the reference package's
``serving/cache_manager.py``, host mirrors and budget rules unchanged. The
manager holds the live device caches (one ``KVCache`` per layer) plus host
mirrors of each slot's ``length`` (cache-buffer write position) and
``valid_start`` (first real entry — everything before it is left-padding
or compacted-cache garbage). It decides capacity (admission high-water
checks, decode overflow) and runs the dynamic KV-prune cadence; it never
runs model math — the ModelRunner produces the cache contents the manager
accounts for.

Admission granularity is a *prefix-length bucket*: ``admit(slot,
prompt_len)`` rounds the prompt up to the next power-of-two bucket (capped
at ``max_len``), so per-slot prefill sees one shape per bucket.

The manager never reads the device: after a prune it computes the new
``valid_start`` mirror from its own mirrors with the formula the device
uses (:func:`prune_kv_caches`), so a prune staged ahead of the device
costs no wait.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import token_pruning as TP
from repro_torch.kernels.backend import host_to_device, resolve_device
from repro_torch.models import attention as A
from repro_torch.models import steps as ST


def bucket_length(n: int, cap: int, lo: int = 8) -> int:
    """Round ``n`` up to the next power-of-two bucket in [lo, cap]."""
    b = max(int(lo), 1)
    while b < n:
        b *= 2
    return min(b, cap)


def _keep_count(n: int, keep_frac: float) -> int:
    return max(1, min(int(n * keep_frac), n))


class KVCacheManager:
    """Per-slot cache bookkeeping for one engine's ``max_batch`` slots.

    ``ec`` is an ``EngineConfig`` (duck-typed to avoid an import cycle with
    ``engine.py``): max_batch / max_len / kv_prune_interval / kv_prune_keep
    / prefill_bucket_min are read from it. Caches live on ``device``.
    """

    def __init__(self, cfg, ec, device: "str | torch.device" = "cuda"):
        self.cfg = cfg
        self.ec = ec
        self.device = resolve_device(device)
        self.masked = cfg.family in ST.MASKABLE_FAMILIES
        self.caches: Any = None
        B = ec.max_batch
        self.lengths = np.zeros((B,), np.int64)   # mirrors device length
        self.starts = np.zeros((B,), np.int32)    # mirrors valid_start
        self.active = np.zeros((B,), bool)
        self.steps_since_prune = 0
        self.prune_events = 0

    # -- lifecycle ---------------------------------------------------------
    def reset(self) -> None:
        """Fresh zeroed caches for all slots; prune cadence restarts."""
        self.caches = ST.init_caches(self.cfg, self.ec.max_batch,
                                     self.ec.max_len, device=self.device)
        self.lengths[:] = 0
        self.starts[:] = 0
        self.active[:] = False
        self.steps_since_prune = 0

    def admit(self, slot: int, prompt_len: int,
              max_new_tokens: int = 0) -> Tuple[int, int]:
        """Account slot ``slot`` as holding a prompt of ``prompt_len`` real
        tokens. Returns ``(bucket_len, valid_start)``: the bucketed row
        width the runner must prefill at and the left-pad depth within it.
        Raises up-front when the slot's own high-water mark cannot fit
        (decidable only with KV pruning off)."""
        ec = self.ec
        if prompt_len > ec.max_len:
            raise RuntimeError(
                f"prompt of {prompt_len} tokens exceeds max_len={ec.max_len}")
        lb = bucket_length(prompt_len, ec.max_len, ec.prefill_bucket_min)
        # bucket padding must never turn a feasible request infeasible:
        # when the padded row would consume the decode headroom, fall back
        # to the largest bucket that fits — or the raw prompt length
        if self.pruning_enabled:
            # pruning bounds the cache only once it FIRES: leave room to
            # decode until the first compaction can fire — up to (keep −
            # prompt) steps growing to the keep target plus a full cadence
            # interval before the tick lands
            keep = _keep_count(ec.max_len, ec.kv_prune_keep)
            budget = ec.max_len - (max(0, keep - prompt_len)
                                   + ec.kv_prune_interval)
        else:
            budget = ec.max_len - max(max_new_tokens - 1, 0)
        if lb > budget:
            b = 1
            while b * 2 <= budget:
                b *= 2
            lb = b if b >= prompt_len else prompt_len
        self.check_capacity(lb + max_new_tokens - 1)
        start = lb - prompt_len
        self.lengths[slot] = lb
        self.starts[slot] = start
        self.active[slot] = True
        return lb, start

    def free(self, slot: int) -> None:
        """Slot retired; its device row is garbage until the next admit
        overwrites it (decode keeps advancing it harmlessly — outputs of
        inactive rows are never read)."""
        self.active[slot] = False

    def snapshot(self) -> Tuple:
        """Capture the full manager state for the pipelined engine's stage
        rollback: a step staged then dropped must leave no trace. The
        caches are captured by reference: stage-time ops (``maybe_prune``)
        REBIND ``self.caches`` to new tensors and never write the old ones,
        and only a dispatch writes caches in place — a dropped step never
        dispatches."""
        return (self.caches, self.lengths.copy(), self.starts.copy(),
                self.active.copy(), self.steps_since_prune,
                self.prune_events)

    def restore(self, snap: Tuple) -> None:
        """Inverse of :meth:`snapshot` (mirror arrays keep their identity —
        callers hold views)."""
        caches, lengths, starts, active, since, events = snap
        self.caches = caches
        self.lengths[:] = lengths
        self.starts[:] = starts
        self.active[:] = active
        self.steps_since_prune = since
        self.prune_events = events

    def set_batch_state(self, lengths, starts) -> None:
        """Adopt mirrors after a whole-batch (re-)prefill replaced every
        row at once (the fallback path)."""
        self.lengths[:] = np.asarray(lengths)
        self.starts[:] = np.asarray(starts) if starts is not None else 0
        self.steps_since_prune = 0  # fresh caches, fresh cadence

    # -- capacity ----------------------------------------------------------
    @property
    def pruning_enabled(self) -> bool:
        return self.ec.kv_prune_interval > 0 and self.ec.kv_prune_keep < 1.0

    def check_capacity(self, high_water: int) -> None:
        """Reject up-front a workload whose cache high-water mark cannot
        fit. Only decidable when KV pruning is off."""
        if not self.pruning_enabled and high_water > self.ec.max_len:
            raise RuntimeError(
                f"max_len={self.ec.max_len} cannot hold {high_water} tokens "
                "(prefix + remaining decode); raise EngineConfig.max_len")

    def on_decode(self) -> None:
        """Account one decode step: every row's write position advances by
        one (the batched decode touches all rows). Raises before an active
        slot would write past the cache buffer."""
        over = self.active & (self.lengths >= self.ec.max_len)
        if over.any():
            slot = int(np.argmax(over))
            raise RuntimeError(
                f"KV cache overflow: decode step would write at "
                f"{int(self.lengths[slot])} >= max_len={self.ec.max_len} "
                f"(slot {slot})")
        self.lengths += 1

    def valid_starts(self) -> Optional[torch.Tensor]:
        """Per-slot valid_start for the next device call (None when the
        family cannot mask left-padding), copied without a wait."""
        return (host_to_device(self.starts, self.device, np.int32)
                if self.masked else None)

    # -- dynamic KV pruning ------------------------------------------------
    def maybe_prune(self) -> bool:
        """Compact the caches when the cadence fires and they have outgrown
        the keep target. Returns True when a prune ran."""
        ec = self.ec
        if not self.pruning_enabled:
            return False
        keep = _keep_count(ec.max_len, ec.kv_prune_keep)
        self.steps_since_prune += 1
        # gauge growth by REAL tokens of ACTIVE slots (write position minus
        # left-padding): keying the cadence on buffer positions would make
        # prune timing admission-path- or retirement-history-dependent
        act = self.active
        n_real = (int((self.lengths[act] - self.starts[act]).max())
                  if act.any() else 0)
        if self.steps_since_prune < ec.kv_prune_interval or n_real < keep:
            return False
        self.steps_since_prune = 0
        self.prune_events += 1
        self.caches, _ = prune_kv_caches(self.caches, ec.kv_prune_keep,
                                         starts=self.valid_starts())
        if self.masked:
            # the device's new_starts, from the mirrors it is computed from
            n_valid = np.clip(self.lengths - self.starts, 0, keep)
            self.starts[:] = (keep - n_valid).astype(np.int32)
        self.lengths[:] = keep
        return True


def prune_kv_caches(caches: List[Any], keep_frac: float,
                    starts: Optional[torch.Tensor] = None
                    ) -> Tuple[List[Any], Optional[torch.Tensor]]:
    """Compact every KVCache to its top-``keep_frac`` attention-mass slots.

    ``starts`` ([B] int32) marks per-slot left-padding; pad slots score
    ``-inf`` and are never kept ahead of real tokens. Kept entries are
    packed so each slot's valid window ends at ``keep``: when a slot has
    fewer than ``keep`` valid entries, the (zeroed) garbage sits at the
    *front*, which the returned ``new_starts`` ([B] int32) masks. ``length``
    becomes ``keep`` per slot and attention mass resets. The result is new
    tensors; the input caches are not written.

    Returns ``(pruned_caches, new_starts)``.
    """
    def one(c):
        if not isinstance(c, A.KVCache):
            return c  # recurrent state passes through untouched
        k, v, length, mass = c
        n = k.shape[1]
        keep = _keep_count(n, keep_frac)
        scores = TP.kv_prune_scores(mass, length, start=starts)
        idx = TP.select_kv_keep(scores, keep, invalid_first=True)
        k2, v2 = TP.compact_kv_cache(k, v, idx)
        # zero the invalid (garbage) prefix each slot may carry
        n_valid = torch.clamp(length - (starts if starts is not None else 0),
                              0, keep)
        pos = torch.arange(keep, device=k.device)
        valid = (pos[None, :] >= (keep - n_valid)[:, None])[..., None, None]
        k_new = torch.zeros_like(k)
        v_new = torch.zeros_like(v)
        k_new[:, :keep] = torch.where(valid, k2, torch.zeros_like(k2))
        v_new[:, :keep] = torch.where(valid, v2, torch.zeros_like(v2))
        return A.KVCache(k_new, v_new, torch.full_like(length, keep),
                         torch.zeros_like(mass))

    pruned = [one(c) for c in caches]
    kv = [c for c in caches if isinstance(c, A.KVCache)]
    if not kv:  # pure recurrent state: nothing compacted
        return pruned, starts
    # per-slot garbage prefix — identical for every layer: it depends only
    # on length/starts/keep, not the per-layer attention mass
    first = kv[0]
    keep = _keep_count(first.k.shape[1], keep_frac)
    base = (starts if starts is not None
            else torch.zeros_like(first.length))
    n_valid = torch.clamp(first.length - base, 0, keep)
    return pruned, (keep - n_valid).to(torch.int32)
