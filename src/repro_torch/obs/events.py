"""Bounded event ring buffer behind the Scheduler's unified event stream.

The Scheduler's ``events`` list used to grow without bound — fine for a
bench run, a leak for a long-lived serving process. :class:`EventLog`
keeps the most recent ``capacity`` entries in a ring while preserving the
two consumption patterns the stack already relies on:

* **Absolute indexing.** ``len(log)`` is the TOTAL number of events ever
  appended (not the buffered count), and slices take *absolute* sequence
  indices — so the traffic harness's incremental scan
  (``mark = len(events); ...; events[mark:]``) keeps working verbatim,
  even after eviction (evicted entries are silently absent from the
  slice; by construction the harness never asks for them, it marks every
  tick).
* **Iteration = buffered entries.** ``list(log)`` and filtered
  comparisons (``[e for e in sched.events if e[0] == "admit"]``) see the
  retained window — the full stream until the ring wraps.

``drain()`` returns-and-clears the buffered entries (the total count
keeps advancing, so outstanding absolute marks stay valid): the
consume-once API for exporters that mirror the stream elsewhere.
"""
from __future__ import annotations

from collections import deque
from itertools import islice
from typing import Any, Deque, Iterator, List

__all__ = ["EventLog"]


class EventLog:
    """Ring buffer with absolute (total-appended) indexing."""

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._buf: Deque[Any] = deque(maxlen=capacity)
        self._total = 0

    def append(self, event: Any) -> None:
        self._buf.append(event)
        self._total += 1

    # -- sizes --------------------------------------------------------------
    def __len__(self) -> int:
        """Total events ever appended (the absolute sequence length) —
        NOT the buffered count; see :attr:`buffered`."""
        return self._total

    @property
    def buffered(self) -> int:
        return len(self._buf)

    @property
    def dropped(self) -> int:
        """Events evicted by the ring so far."""
        return self._total - len(self._buf)

    def __bool__(self) -> bool:
        return self._total > 0

    # -- access -------------------------------------------------------------
    def __iter__(self) -> Iterator[Any]:
        return iter(self._buf)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            start, stop, step = idx.indices(self._total)
            lo = self.dropped
            items = list(islice(self._buf, max(start - lo, 0),
                                max(stop - lo, 0)))
            return items[::step] if step != 1 else items
        i = idx + self._total if idx < 0 else idx
        if not 0 <= i < self._total:
            raise IndexError(f"index {idx} out of range for {self._total} "
                             f"events")
        if i < self.dropped:
            raise IndexError(f"event {idx} was evicted (ring keeps the "
                             f"last {self.capacity})")
        return self._buf[i - self.dropped]

    def drain(self) -> List[Any]:
        """Return and clear the buffered entries. The total count is
        unaffected, so absolute marks taken before the drain stay
        consistent (the drained range simply reads as evicted)."""
        items = list(self._buf)
        self._buf.clear()
        return items
