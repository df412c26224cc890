"""Observability for the port's rounds (``repro.obs``): ``MetricStream``
(per-round rows to sinks while the rounds run, without a host wait on the
dispatch thread), ``trace`` (phase labels on profiles, host spans,
``torch.profiler`` runs written as Chrome traces) and ``sinks`` (JSONL,
CSV, stdout and memory sinks, the run manifest)."""
from repro_torch.obs.metrics import MetricStream
from repro_torch.obs.sinks import (CsvSink, JsonlSink, MemorySink, StdoutSink,
                                   bench_json, run_manifest, write_manifest)
from repro_torch.obs.trace import HostSpans, phase, profile

__all__ = [
    "MetricStream", "JsonlSink", "CsvSink", "StdoutSink", "MemorySink",
    "bench_json", "run_manifest", "write_manifest", "HostSpans", "phase",
    "profile",
]
