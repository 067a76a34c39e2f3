"""Schema-versioned JSON bench artifacts; the port of the reference
package's ``bench/artifacts.py``, with the same envelope and version, so
an artifact written by either package loads in the other.

Every benchmark (``BENCH_serving.json``, ``BENCH_vision.json``,
``BENCH_traffic.json``, ...) writes through :func:`write_bench_artifact`,
so downstream consumers (dashboards, regression diffing) see ONE envelope
instead of per-script ad-hoc dicts:

    {
      "schema_version": 4,
      "kind":    "<benchmark family, e.g. 'serving' | 'vision'>",
      "created_unix": <float epoch seconds>,
      "provenance": {           # what it takes to REPRODUCE the run
        "git_sha": "<HEAD sha or null outside a checkout>",
        "seed": <int | null>,   # the run's root RNG seed
        "trace_fingerprint": "<sha256 | null>"  # replayed workload id
      },
      "config":  {...},         # the knobs the run was configured with
      "results": {...},         # per-mode measurements
      "metrics": {...} | null,  # optional repro_torch.obs
                                # MetricsRegistry snapshot
                                # (name -> typed metric entry)
      ...extra top-level summary keys (speedups etc.)
    }

Bump ``SCHEMA_VERSION`` when the envelope itself changes shape; kind-local
result layouts may evolve freely (consumers dispatch on ``kind``).

Version history:
  1 — initial envelope.
  2 — vision artifacts grew the ``quality_pareto`` results block (keep-
      floor sweep rows: modeled_ms, top1_agreement, tightened_steps) and
      the timed arms record the controller's quality/keep-floor knobs in
      ``config``.
  3 — reserved ``provenance`` block (git_sha, seed, trace_fingerprint):
      a bench row is only evidence if the run is reconstructible — which
      code, which RNG stream, and (for trace-replay benches) which exact
      workload. Fields are null when unknown; the block is always present.
  4 — reserved optional ``metrics`` block: a
      ``repro_torch.obs.MetricsRegistry`` snapshot (``{name: {"type":
      counter|gauge|histogram, ...}}``) taken at the end of the run —
      recompile counts, planner modeled-vs-measured cost error,
      quality-tighten counters, SLO histograms.
      Null when the bench collected no metrics; the key is always
      present. Purely observational: adding it must not change any
      ``results`` value or digest.
"""
from __future__ import annotations

import json
import subprocess
import time
from typing import Any, Dict, Optional

SCHEMA_VERSION = 4

_RESERVED = ("schema_version", "kind", "created_unix", "provenance",
             "config", "results", "metrics")


def git_sha() -> Optional[str]:
    """HEAD commit of the working tree (None outside a git checkout or
    without git on PATH) — recorded, never trusted for logic."""
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"],
                             capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def write_bench_artifact(path: str, kind: str, config: Dict[str, Any],
                         results: Dict[str, Any],
                         extra: Optional[Dict[str, Any]] = None,
                         seed: Optional[int] = None,
                         trace_fingerprint: Optional[str] = None,
                         metrics: Optional[Dict[str, Any]] = None
                         ) -> Dict[str, Any]:
    """Write the envelope to ``path``; returns the dict written. ``extra``
    keys land at the top level (summary scalars) and must not collide with
    the envelope's own fields. ``seed`` / ``trace_fingerprint`` fill the
    provenance block (the git SHA is captured automatically). ``metrics``
    is an optional ``repro_torch.obs.MetricsRegistry.snapshot()`` dict
    (schema v4); pass None when the bench collected none."""
    artifact: Dict[str, Any] = {
        "schema_version": SCHEMA_VERSION,
        "kind": kind,
        "created_unix": time.time(),
        "provenance": {
            "git_sha": git_sha(),
            "seed": seed,
            "trace_fingerprint": trace_fingerprint,
        },
        "config": config,
        "results": results,
        "metrics": metrics,
    }
    for key, value in (extra or {}).items():
        if key in _RESERVED:
            raise ValueError(f"extra key {key!r} collides with the "
                             f"artifact envelope")
        artifact[key] = value
    with open(path, "w") as f:
        json.dump(artifact, f, indent=2, default=str)
    return artifact


def load_bench_artifact(path: str,
                        expect_kind: Optional[str] = None) -> Dict[str, Any]:
    """Read + validate an artifact envelope (schema version, provenance
    block shape and, if given, kind). The smoke lanes use this to fail
    loudly on malformed output."""
    with open(path) as f:
        artifact = json.load(f)
    missing = [k for k in _RESERVED if k not in artifact]
    if missing:
        raise ValueError(f"{path}: not a bench artifact — missing {missing}")
    if artifact["schema_version"] != SCHEMA_VERSION:
        raise ValueError(
            f"{path}: schema_version {artifact['schema_version']} != "
            f"supported {SCHEMA_VERSION}")
    prov = artifact["provenance"]
    missing_prov = [k for k in ("git_sha", "seed", "trace_fingerprint")
                    if k not in prov]
    if missing_prov:
        raise ValueError(f"{path}: provenance block missing {missing_prov}")
    if expect_kind is not None and artifact["kind"] != expect_kind:
        raise ValueError(f"{path}: kind {artifact['kind']!r} != "
                         f"{expect_kind!r}")
    return artifact
