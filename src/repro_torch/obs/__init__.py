"""Observability (``repro/obs``): the metrics registry, the JSONL event
stream and heartbeat line, and the per-step comm byte counters that the
train and serve loops record into.  The reference's provenance, measured
replay and calibration come with ROADMAP queue 1 item 15b.
"""
from repro_torch.obs.events import EventLog, heartbeat_line, utc_now
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = [
    "Counter",
    "EventLog",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "comm_byte_counters",
    "heartbeat_line",
    "utc_now",
]


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
