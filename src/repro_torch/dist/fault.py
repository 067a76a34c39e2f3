"""Fault-tolerant training: straggler detection + checkpointed restart —
the port of the reference package's ``dist/fault.py`` (framework-free).

``RestartableLoop`` wraps a step function with the checkpoint/restart
contract the system tests demand: state is saved every
``checkpoint_every`` completed steps through ``CheckpointManager``, any
exception raised inside a step (data fetch, injected fault, a CUDA error)
triggers a restore of the latest checkpoint, and — because the data pipeline
is a pure function of the step index (``data/pipeline.py``) — replaying the
steps since that checkpoint reproduces the pre-failure state *bit-exactly*.

``StepWatchdog`` is the straggler half of the fault story: it tracks the
running mean step time and flags any step slower than
``slow_step_factor``x the mean (flagged steps are excluded from the mean so
one straggler doesn't mask the next).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Knobs for the fault-tolerance substrate."""

    checkpoint_every: int = 100   # steps between checkpoints (0 = never)
    slow_step_factor: float = 3.0  # straggler threshold vs mean step time
    warmup_steps: int = 5          # observations before the watchdog arms
    max_restarts: int = 16         # hard stop against crash loops


class StepWatchdog:
    """Flags steps slower than ``slow_step_factor`` x the running mean."""

    def __init__(self, config: FaultConfig):
        self.config = config
        self._count = 0
        self._total = 0.0

    def observe(self, duration: float) -> Optional[str]:
        """Record one step duration; returns "straggler" if it's anomalous
        (after warmup), else None. Stragglers don't pollute the mean."""
        if self._count >= max(self.config.warmup_steps, 1):
            mean = self._total / self._count
            if mean > 0 and duration > self.config.slow_step_factor * mean:
                return "straggler"
        self._count += 1
        self._total += duration
        return None


class RestartableLoop:
    """Checkpointed step loop with exact resume after failures.

    Args:
      manager:   ``CheckpointManager`` for save/restore.
      config:    ``FaultConfig``.
      make_state: () -> fresh state pytree (also the restore template).
      step_fn:   (state, batch) -> (new_state, metrics dict).
      data_fn:   (step index) -> batch; must be deterministic in the step so
                 replay after a restore is bit-exact.
      state_to_tree / tree_to_state: optional projections when only part of
                 the state is checkpointable (e.g. params+opt but not
                 closures). Defaults checkpoint the whole state.
    """

    def __init__(self, manager, config: FaultConfig,
                 make_state: Callable[[], Any],
                 step_fn: Callable[[Any, Any], Tuple[Any, Dict]],
                 data_fn: Callable[[int], Any],
                 state_to_tree: Optional[Callable[[Any], Any]] = None,
                 tree_to_state: Optional[Callable[[Any, Any], Any]] = None):
        self.manager = manager
        self.config = config
        self.make_state = make_state
        self.step_fn = step_fn
        self.data_fn = data_fn
        self.state_to_tree = state_to_tree or (lambda s: s)
        self.tree_to_state = tree_to_state or (lambda tree, state: tree)

    # ------------------------------------------------------------------
    def _restore_or_init(self, events) -> Tuple[int, Any]:
        state = self.make_state()
        step = self.manager.latest_step()
        if step is None:
            return 0, state
        tree = self.manager.restore(self.state_to_tree(state), step=step)
        events.append((step, "restored"))
        return step, self.tree_to_state(tree, state)

    def _save(self, step: int, state: Any, events) -> None:
        self.manager.save(step, self.state_to_tree(state),
                          extra={"step": step})
        events.append((step, "checkpoint"))

    # ------------------------------------------------------------------
    def run(self, num_steps: int,
            fail_injector: Optional[Callable[[int], None]] = None) -> Dict:
        """Run to ``num_steps`` completed steps, restarting on any step
        fault. ``fail_injector(step)`` (tests) may raise to simulate one."""
        events: list = []
        loss_by_step: Dict[int, float] = {}
        restarts = 0
        watchdog = StepWatchdog(self.config)
        every = self.config.checkpoint_every

        step, state = self._restore_or_init(events)
        while step < num_steps:
            try:
                t0 = time.monotonic()
                batch = self.data_fn(step)
                if fail_injector is not None:
                    fail_injector(step)
                state, metrics = self.step_fn(state, batch)
                # float() blocks on async dispatch, so it must precede the
                # watchdog observation or asynchronous steps time as ~0s and
                # stragglers are never flagged; keyed by step so replayed
                # steps after a restore overwrite instead of duplicating
                if metrics and "loss" in metrics:
                    loss_by_step[step] = float(metrics["loss"])
                if watchdog.observe(time.monotonic() - t0) == "straggler":
                    events.append((step, "straggler"))
                step += 1
                if every and step % every == 0:
                    self._save(step, state, events)
            except Exception as e:  # noqa: BLE001 — any step fault restarts
                restarts += 1
                if restarts > self.config.max_restarts:
                    raise
                events.append((step, f"failure:{type(e).__name__}"))
                step, state = self._restore_or_init(events)

        if every and step % every != 0:
            self._save(step, state, events)  # final state always durable
        return {"state": state, "restarts": restarts,
                "losses": [loss_by_step[s] for s in sorted(loss_by_step)],
                "events": events}
