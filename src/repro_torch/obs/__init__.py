"""Observability (``repro/obs``): the metrics registry the serving
runtime records into."""
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]
