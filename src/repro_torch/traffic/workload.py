"""Trace workloads — seeded arrival processes + request mixes, replayable;
the port of the reference package's ``traffic/workload.py``. The same
``(TraceSpec, seed)`` makes the same draws in the same order, so a trace
made here is byte-identical to the reference's (same fingerprint) and the
checked-in ``examples/traces/*.jsonl`` load in both packages.

The benches so far replay tiny uniform request mixes; nothing in the stack
referees behavior under the traffic regime the paper's dynamic token
pruning is FOR — bursty, heavy-tailed, diurnal load where the latency
budget binds (SPViT/HeatViT both take that budget as the first-class
input). This module is the workload half of the traffic subsystem: it
synthesizes request streams as *traces* — plain data, serializable to
JSONL — that the harness (``traffic.harness``) replays against either
serving engine on a virtual clock.

Design rules:

* **Everything is seeded and replayable.** A trace is a pure function of
  ``(TraceSpec, seed)``; request *content* (patch pixels, prompt tokens)
  is NOT stored in the trace — each record carries a ``content_seed`` and
  the harness's drivers materialize tensors from it deterministically, so
  a few-KB JSONL file replays byte-for-byte.
* **The schema is versioned.** The JSONL header line carries
  ``trace_schema``; :func:`load_trace` refuses versions it does not know.
  :func:`trace_fingerprint` (sha256 over the canonical serialization) is
  what bench artifacts record for provenance.
* **Arrival processes are explicit.** ``poisson`` (memoryless baseline),
  ``bursty`` (two-state Markov-modulated Poisson — the heavy-tailed
  production shape), ``diurnal`` (sinusoidally ramped rate via Lewis
  thinning). All return absolute arrival times in virtual milliseconds.

Only numpy is imported here — the workload layer knows nothing about
engines or devices, so traces can be generated/inspected anywhere.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["TRACE_SCHEMA_VERSION", "ARRIVAL_PROCESSES", "TraceRequest",
           "Trace", "TraceSpec", "poisson_arrivals", "bursty_arrivals",
           "diurnal_arrivals", "make_trace", "save_trace", "load_trace",
           "trace_fingerprint"]

TRACE_SCHEMA_VERSION = 1

ARRIVAL_PROCESSES = ("poisson", "bursty", "diurnal")

TRACE_KINDS = ("vision", "lm")


# ===========================================================================
# Records
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One trace line: when a request arrives and what it asks for.

    Vision fields (``kind == "vision"``): ``n_patches`` (resolution),
    ``r_t`` / ``keep_schedule`` (TDM keep rates; ``None`` = engine
    default), ``quality`` (per-request accuracy/latency preference),
    ``soft_prune``. LM fields (``kind == "lm"``): ``prompt_tokens``,
    ``max_new_tokens``. ``deadline_ms`` is the request's SLO measured
    from arrival on the harness's virtual clock; ``content_seed`` is the
    RNG seed the drivers materialize tensors from (replayability without
    storing pixels)."""

    uid: int
    arrival_ms: float
    kind: str = "vision"
    n_patches: int = 0
    r_t: Optional[float] = None
    keep_schedule: Optional[Tuple[float, ...]] = None
    quality: Optional[str] = None
    soft_prune: bool = False
    deadline_ms: Optional[float] = None
    prompt_tokens: int = 0
    max_new_tokens: int = 0
    content_seed: int = 0

    def __post_init__(self):
        if self.kind not in TRACE_KINDS:
            raise ValueError(f"trace request kind must be one of "
                             f"{TRACE_KINDS}, got {self.kind!r}")
        if not (math.isfinite(self.arrival_ms) and self.arrival_ms >= 0.0):
            raise ValueError(f"uid {self.uid}: arrival_ms must be finite "
                             f"and >= 0, got {self.arrival_ms}")
        if self.deadline_ms is not None and not (
                math.isfinite(self.deadline_ms) and self.deadline_ms > 0.0):
            raise ValueError(f"uid {self.uid}: deadline_ms must be finite "
                             f"and positive, got {self.deadline_ms}")
        if self.keep_schedule is not None:
            object.__setattr__(self, "keep_schedule",
                               tuple(float(v) for v in self.keep_schedule))

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        if d["keep_schedule"] is not None:
            d["keep_schedule"] = list(d["keep_schedule"])
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "TraceRequest":
        d = dict(d)
        if d.get("keep_schedule") is not None:
            d["keep_schedule"] = tuple(d["keep_schedule"])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class Trace:
    """An ordered request stream plus the metadata that regenerates it."""

    meta: Dict[str, Any]
    requests: Tuple[TraceRequest, ...]

    def __post_init__(self):
        reqs = tuple(self.requests)
        if any(b.arrival_ms < a.arrival_ms
               for a, b in zip(reqs, reqs[1:])):
            raise ValueError("trace requests must be sorted by arrival_ms")
        if len({r.uid for r in reqs}) != len(reqs):
            raise ValueError("trace request uids must be unique")
        object.__setattr__(self, "requests", reqs)

    @property
    def kind(self) -> str:
        return self.meta.get("kind", "vision")

    @property
    def span_ms(self) -> float:
        """First-to-last arrival span (the offered-load denominator)."""
        if not self.requests:
            return 0.0
        return self.requests[-1].arrival_ms - self.requests[0].arrival_ms

    @property
    def offered_load_rps(self) -> float:
        """Offered load in requests per (virtual) second over the span."""
        if len(self.requests) < 2 or self.span_ms <= 0.0:
            return 0.0
        return (len(self.requests) - 1) / (self.span_ms * 1e-3)

    def fingerprint(self) -> str:
        return trace_fingerprint(self)


# ===========================================================================
# Arrival processes (virtual milliseconds)
# ===========================================================================
def poisson_arrivals(n: int, rate_rps: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Homogeneous Poisson process: exponential inter-arrivals at
    ``rate_rps`` requests per virtual second."""
    if rate_rps <= 0.0:
        raise ValueError(f"rate_rps must be positive, got {rate_rps}")
    gaps_ms = rng.exponential(1e3 / rate_rps, size=n)
    return np.cumsum(gaps_ms)


def bursty_arrivals(n: int, rate_rps: float, rng: np.random.Generator,
                    burst_factor: float = 8.0, p_enter: float = 0.08,
                    p_exit: float = 0.25) -> np.ndarray:
    """Two-state Markov-modulated Poisson process (per-arrival chain): a
    calm state and a burst state whose rate is ``burst_factor`` times
    hotter; after each arrival the state flips with probability
    ``p_enter`` (calm -> burst) / ``p_exit`` (burst -> calm). The calm
    rate is chosen so the long-run mean rate is ``rate_rps`` — same
    offered load as the Poisson baseline, very different tail."""
    if rate_rps <= 0.0:
        raise ValueError(f"rate_rps must be positive, got {rate_rps}")
    if burst_factor < 1.0:
        raise ValueError(f"burst_factor must be >= 1, got {burst_factor}")
    # stationary occupancy of the per-arrival chain; the mean inter-
    # arrival weights each state's gap (1/rate) by its ARRIVAL share, so
    # matching the long-run rate solves 1/rate_rps =
    # (pi_calm + pi_burst/burst_factor) / calm_rate
    pi_burst = p_enter / max(p_enter + p_exit, 1e-12)
    calm_rate = rate_rps * ((1.0 - pi_burst) + pi_burst / burst_factor)
    t = 0.0
    out = np.empty(n, np.float64)
    burst = False
    for i in range(n):
        rate = calm_rate * (burst_factor if burst else 1.0)
        t += rng.exponential(1e3 / rate)
        out[i] = t
        if rng.random() < (p_exit if burst else p_enter):
            burst = not burst
    return out


def diurnal_arrivals(n: int, rate_rps: float, rng: np.random.Generator,
                     period_s: float = 60.0,
                     depth: float = 0.8) -> np.ndarray:
    """Nonhomogeneous Poisson with a sinusoidal rate —
    ``rate(t) = rate_rps * (1 + depth * sin(2*pi*t / period))`` — sampled
    by Lewis thinning against the peak rate. ``depth`` in [0, 1): 0 is
    flat, near 1 swings between ~2x and ~0x the mean (the ramp the
    admission controller must ride)."""
    if rate_rps <= 0.0:
        raise ValueError(f"rate_rps must be positive, got {rate_rps}")
    if not 0.0 <= depth < 1.0:
        raise ValueError(f"depth must be in [0, 1), got {depth}")
    peak = rate_rps * (1.0 + depth)
    t = 0.0
    out = np.empty(n, np.float64)
    i = 0
    while i < n:
        t += rng.exponential(1e3 / peak)
        rate_t = rate_rps * (1.0 + depth * math.sin(
            2.0 * math.pi * (t * 1e-3) / period_s))
        if rng.random() * peak <= rate_t:
            out[i] = t
            i += 1
    return out


_ARRIVALS = {"poisson": poisson_arrivals, "bursty": bursty_arrivals,
             "diurnal": diurnal_arrivals}


# ===========================================================================
# Trace synthesis
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Everything that determines a synthetic trace (with the seed).

    The mix samplers draw independently per request: ``sizes`` /
    ``size_weights`` choose the vision patch count (LM: ``prompt_sizes``
    choose the prompt length), ``r_ts`` the keep rate (``None`` entries =
    engine default), ``deadlines_ms`` the SLO (``None`` entries = no
    deadline), ``qualities`` the per-request preference. ``process_args``
    passes through to the arrival process (burst_factor, period_s, ...).
    """

    n: int = 32
    rate_rps: float = 50.0
    process: str = "bursty"
    kind: str = "vision"
    sizes: Tuple[int, ...] = (16, 9, 4)
    size_weights: Optional[Tuple[float, ...]] = None
    r_ts: Tuple[Optional[float], ...] = (None,)
    deadlines_ms: Tuple[Optional[float], ...] = (None,)
    qualities: Tuple[Optional[str], ...] = (None,)
    soft_prob: float = 0.0
    prompt_sizes: Tuple[int, ...] = (8, 16, 32)
    max_new_tokens: int = 8
    process_args: Tuple[Tuple[str, float], ...] = ()

    def __post_init__(self):
        if self.n <= 0:
            raise ValueError(f"n must be positive, got {self.n}")
        if self.process not in ARRIVAL_PROCESSES:
            raise ValueError(f"process must be one of {ARRIVAL_PROCESSES}, "
                             f"got {self.process!r}")
        if self.kind not in TRACE_KINDS:
            raise ValueError(f"kind must be one of {TRACE_KINDS}, "
                             f"got {self.kind!r}")
        if not 0.0 <= self.soft_prob <= 1.0:
            raise ValueError(f"soft_prob must be in [0, 1], "
                             f"got {self.soft_prob}")

    def to_json(self) -> Dict[str, Any]:
        return {k: (list(v) if isinstance(v, tuple) else v)
                for k, v in dataclasses.asdict(self).items()}


def _choice(rng: np.random.Generator, options: Sequence,
            weights: Optional[Sequence[float]] = None):
    """Index-based choice so ``None`` entries survive (np.random.choice
    would coerce a mixed option list to object/str dtype)."""
    if weights is None:
        return options[int(rng.integers(len(options)))]
    p = np.asarray(weights[:len(options)], np.float64)
    return options[int(rng.choice(len(options), p=p / p.sum()))]


def make_trace(spec: TraceSpec, seed: int = 0) -> Trace:
    """Synthesize the trace for ``(spec, seed)`` — pure and replayable:
    the same pair always yields the identical trace (and therefore the
    identical fingerprint)."""
    rng = np.random.default_rng(seed)
    arrivals = _ARRIVALS[spec.process](
        spec.n, spec.rate_rps, rng, **dict(spec.process_args))
    reqs: List[TraceRequest] = []
    for uid in range(spec.n):
        deadline = _choice(rng, spec.deadlines_ms)
        quality = _choice(rng, spec.qualities)
        content_seed = int(rng.integers(2 ** 31 - 1))
        if spec.kind == "vision":
            reqs.append(TraceRequest(
                uid=uid, arrival_ms=float(arrivals[uid]), kind="vision",
                n_patches=int(_choice(rng, spec.sizes, spec.size_weights)),
                r_t=_choice(rng, spec.r_ts),
                quality=quality,
                soft_prune=bool(rng.random() < spec.soft_prob),
                deadline_ms=deadline, content_seed=content_seed))
        else:
            reqs.append(TraceRequest(
                uid=uid, arrival_ms=float(arrivals[uid]), kind="lm",
                prompt_tokens=int(_choice(rng, spec.prompt_sizes)),
                max_new_tokens=spec.max_new_tokens,
                quality=quality, deadline_ms=deadline,
                content_seed=content_seed))
    meta = {"trace_schema": TRACE_SCHEMA_VERSION, "kind": spec.kind,
            "seed": seed, "spec": spec.to_json()}
    return Trace(meta=meta, requests=tuple(reqs))


# ===========================================================================
# Serialization + provenance
# ===========================================================================
def _canonical_lines(trace: Trace) -> List[str]:
    """Header line + one canonical JSON line per request. Canonical =
    sorted keys, no whitespace — the serialization IS the fingerprint
    domain, so save/load round-trips preserve the fingerprint exactly."""
    lines = [json.dumps(trace.meta, sort_keys=True,
                        separators=(",", ":"))]
    lines += [json.dumps(r.to_json(), sort_keys=True,
                         separators=(",", ":"))
              for r in trace.requests]
    return lines


def trace_fingerprint(trace: Trace) -> str:
    """sha256 over the canonical JSONL serialization — the replayability
    token bench artifacts record (same fingerprint == byte-for-byte the
    same workload)."""
    h = hashlib.sha256()
    for line in _canonical_lines(trace):
        h.update(line.encode())
        h.update(b"\n")
    return h.hexdigest()


def save_trace(path: str, trace: Trace) -> str:
    """Write the JSONL trace file; returns its fingerprint."""
    with open(path, "w") as f:
        for line in _canonical_lines(trace):
            f.write(line + "\n")
    return trace_fingerprint(trace)


def load_trace(path: str) -> Trace:
    """Read a JSONL trace, validating the schema version."""
    with open(path) as f:
        lines = [ln for ln in (l.strip() for l in f) if ln]
    if not lines:
        raise ValueError(f"{path}: empty trace file")
    meta = json.loads(lines[0])
    version = meta.get("trace_schema")
    if version != TRACE_SCHEMA_VERSION:
        raise ValueError(f"{path}: trace_schema {version!r} != supported "
                         f"{TRACE_SCHEMA_VERSION}")
    reqs = tuple(TraceRequest.from_json(json.loads(ln))
                 for ln in lines[1:])
    return Trace(meta=meta, requests=reqs)
