"""Observability (``repro/obs``): the metrics registry, the JSONL event
stream and heartbeat line, the per-step comm byte counters that the
train and serve loops record into, and the measured path:

  provenance  — the metadata header every profile and trace embeds
  measure     — per-op measured replay emitting sim-compatible Timelines
  calibrate   — alpha-beta NetworkModel and staging fits, per-mesh
                fitted profiles (``python -m repro_torch.obs --fit``)

``measure`` and ``calibrate`` are imported lazily.
"""
from repro_torch.obs.events import EventLog, heartbeat_line, utc_now
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.provenance import SCHEMA_VERSION, bench_metadata

__all__ = [
    "Counter",
    "EventLog",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "SCHEMA_VERSION",
    "bench_metadata",
    "comm_byte_counters",
    "fit_network",
    "fit_staging",
    "fitted_network",
    "heartbeat_line",
    "load_profile",
    "measured_gradsync",
    "measured_timeline",
    "measurement_rows",
    "save_profile",
    "utc_now",
]

_LAZY = {
    "measured_gradsync": "repro_torch.obs.measure",
    "measured_timeline": "repro_torch.obs.measure",
    "measurement_rows": "repro_torch.obs.measure",
    "fit_network": "repro_torch.obs.calibrate",
    "fit_staging": "repro_torch.obs.calibrate",
    "fitted_network": "repro_torch.obs.calibrate",
    "load_profile": "repro_torch.obs.calibrate",
    "save_profile": "repro_torch.obs.calibrate",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.obs' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


def comm_byte_counters(schedule, registry: MetricsRegistry,
                       itemsize: int = 4) -> None:
    """Account one execution of ``schedule`` into byte counters keyed
    ``comm_bytes.<kind>.<reducer>.<phase>`` (RS/AG pairs each count their
    own wire pass; UPDATE/NORM move no payload).  ``itemsize`` is the
    plan's comm dtype's; a bucket that pins its own dtype counts that."""
    from repro_torch.core.schedule import (
        ALL_GATHER,
        ALLREDUCE,
        REDUCE_SCATTER,
        itemsize_of,
    )

    for op in schedule.ops:
        if op.kind not in (ALLREDUCE, REDUCE_SCATTER, ALL_GATHER):
            continue
        nb = op.bucket.size * itemsize_of(op.bucket.comm_dtype, itemsize)
        tag = op.reducer or "default"
        registry.counter(
            f"comm_bytes.{op.kind}.{tag}.{op.phase}").inc(nb)
