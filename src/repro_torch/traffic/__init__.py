"""repro_torch.traffic — trace-driven load, SLO accounting, admission
control; the port of the reference package's ``traffic`` (numpy and the
port's serving engines; no device code of its own).

Three modules, one pipeline: :mod:`~repro_torch.traffic.workload`
synthesizes seeded, replayable request traces (Poisson / bursty / diurnal
arrivals × request mixes, versioned JSONL);
:mod:`~repro_torch.traffic.harness` replays a trace against either serving
engine on a deterministic virtual clock and reports latency percentiles,
time-to-first-dispatch, goodput and deadline-miss rate;
:mod:`~repro_torch.traffic.admission` gates submission with the calibrated
tile cost model — degrading quality (via the ``QualityController``) before
rejecting, so the queue stays bounded and goodput survives past the
saturation knee.
"""
from repro_torch.traffic.admission import (ADMISSION_ACTIONS,
                                           AdmissionController,
                                           AdmissionDecision)
from repro_torch.traffic.harness import (LMDriver, RequestRecord,
                                         TrafficHarness, VisionDriver,
                                         outputs_digest, percentile)
from repro_torch.traffic.workload import (ARRIVAL_PROCESSES,
                                          TRACE_SCHEMA_VERSION, Trace,
                                          TraceRequest, TraceSpec,
                                          bursty_arrivals, diurnal_arrivals,
                                          load_trace, make_trace,
                                          poisson_arrivals, save_trace,
                                          trace_fingerprint)

__all__ = [
    "ADMISSION_ACTIONS", "AdmissionController", "AdmissionDecision",
    "LMDriver", "RequestRecord", "TrafficHarness", "VisionDriver",
    "outputs_digest", "percentile",
    "ARRIVAL_PROCESSES", "TRACE_SCHEMA_VERSION", "Trace", "TraceRequest",
    "TraceSpec", "bursty_arrivals", "diurnal_arrivals", "load_trace",
    "make_trace", "poisson_arrivals", "save_trace", "trace_fingerprint",
]
