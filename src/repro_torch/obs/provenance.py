"""Shared provenance metadata for every artifact the port writes (fitted
network profiles, traces) — the port of ``repro/obs/provenance.py``.

Calibration fits a cost model FROM these artifacts, so it must be able
to trust where a row came from: which mesh, which torch and CUDA, which
backend and card, when.  One helper, one schema version, every writer.
"""
from __future__ import annotations

import platform
from typing import Any, Mapping

from repro_torch.obs.events import utc_now

SCHEMA_VERSION = 1


def bench_metadata(
    mesh_shape: Mapping[str, int] | None = None,
    **extra: Any,
) -> dict[str, Any]:
    """The metadata header embedded in every profile or trace.

    torch's version, its CUDA, the process group's backend, the device
    count and the first card's name are best-effort: a header must never
    be the reason an artifact fails to write."""
    meta: dict[str, Any] = {
        "schema_version": SCHEMA_VERSION,
        "utc": utc_now(),
        "platform": platform.platform(),
        "python": platform.python_version(),
    }
    try:
        import torch
        import torch.distributed as dist

        cuda = torch.cuda.is_available()
        meta["torch_version"] = torch.__version__
        meta["torch_cuda"] = torch.version.cuda
        meta["backend"] = (dist.get_backend() if dist.is_initialized()
                           else ("cuda" if cuda else "cpu"))
        meta["device_count"] = torch.cuda.device_count() if cuda else 0
        meta["device_name"] = torch.cuda.get_device_name(0) if cuda else "cpu"
    except Exception:
        meta["torch_version"] = None
    if mesh_shape is not None:
        meta["mesh_shape"] = dict(mesh_shape)
    meta.update(extra)
    return meta
