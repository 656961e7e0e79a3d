"""Meshes and process-group setup (``repro/launch/mesh.py``).

The meshes are ``parallel/sharding.py::Mesh``es: axis names and sizes,
ranks row-major over the axes (``Mesh.coords``/``Mesh.rank_of``).  The
ranks of one model group (the same data coordinates) hold the shards of
one replica and read the same rows of the batch
(``parallel/sharding.py::dp_index``).

``make_mesh`` lays the initialized process group out as the production
mesh: a "model" axis of the given extent (tensor parallelism, the
reference's ``make_config(tp=mesh.shape["model"])``) and the rest of
the world on "data", or on two pods with ``multi_pod`` (the counterpart
of ``make_production_mesh(multi_pod=True)``).  A pod's ranks are meant
to share one host: the hierarchical reducers' intra-pod rings write into
each other's memory (``core/dependency.py::pod_comms``).
"""
from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

from repro_torch.core.dependency import backend_for, resolve_device
from repro_torch.parallel.sharding import STAGE_AXIS, Mesh


def make_smoke_mesh(data: int = 1, model: int = 1, stage: int = 0) -> Mesh:
    """The reference's two-axis ("data", "model") mesh; both axes always
    present so every collective path runs.  ``stage >= 1`` inserts a
    "stage" axis between them (pipeline stages, DESIGN.md §15): rank
    (d·stage + s)·model + m at (d, s, m); extent 1 keeps the staged code
    path with a trivial pipeline, the reference a staged run is held
    to."""
    if data < 1 or model < 1 or stage < 0:
        raise ValueError(f"a mesh needs data, model >= 1 and stage >= 0; got "
                         f"{data} x {model}, stage {stage}")
    if stage >= 1:
        return Mesh(("data", STAGE_AXIS, "model"),
                    {"data": data, STAGE_AXIS: stage, "model": model})
    return Mesh(("data", "model"), {"data": data, "model": model})


def make_pod_mesh(pods: int, data: int, model: int = 1) -> Mesh:
    """The reference's ("pod", "data", "model") mesh: ``pods`` pods of
    ``data`` × ``model`` ranks each, rank (p·data + d)·model + m at
    (p, d, m)."""
    if pods < 1 or data < 1 or model < 1:
        raise ValueError(f"a pod mesh needs pods, data, model >= 1; got "
                         f"{pods} x {data} x {model}")
    return Mesh(("pod", "data", "model"), {"pod": pods, "data": data, "model": model})


def make_mesh(model: int = 1, multi_pod: bool = False, stage: int = 0) -> Mesh:
    """The initialized process group as the production mesh: a "model"
    axis of extent ``model``, with ``stage >= 1`` a "stage" axis of that
    extent before it, and the rest of the world on "data" (with
    ``multi_pod`` on two pods of equal "data" extent).  A world that
    does not split so raises.  (A mesh over fewer ranks than the world,
    an elastic rung, is a ``Mesh`` with ``ranks``.)"""
    world = dist.get_world_size() if dist.is_initialized() else 1
    per = model * max(stage, 1)
    if model < 1 or stage < 0 or world % per:
        raise ValueError(f"a model axis of {model} and {stage} stages do not divide "
                         f"a world of {world}")
    dp = world // per
    if stage and multi_pod:
        raise ValueError("pipeline stages on a multi-pod mesh: the reference's "
                         "stage axis is on the smoke mesh only")
    if not multi_pod:
        return make_smoke_mesh(dp, model, stage)
    if dp < 2 or dp % 2:
        raise ValueError(f"--multi-pod needs two equal pods; {dp} data-parallel "
                         f"rank(s) do not split into two")
    return make_pod_mesh(2, dp // 2, model)


def make_dp_mesh(multi_pod: bool = False) -> Mesh:
    """Data parallelism over every rank of the process group (model
    extent 1): ``make_mesh(1, multi_pod)``."""
    return make_mesh(1, multi_pod)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_dist(device: str | torch.device = "cuda", *,
              backend: str | None = None,
              init_method: str | None = None, rank: int | None = None,
              world_size: int | None = None,
              timeout: datetime.timedelta | None = None) -> tuple[int, int]:
    """Initialize the default process group once; returns (rank, world).

    ``backend`` None is NCCL for ``cuda`` and gloo for ``cpu``.  Naming
    gloo for ``cuda`` runs every rank's compute on its card and the
    collectives through pinned host memory (``core/dependency.py``):
    several ranks can then share one card, which NCCL refuses.  The
    communicators the port creates later take the default group's
    backend, except that CPU tensors always get gloo ones: a CPU run can
    share a process with an NCCL default group.  Rank ``r`` uses card
    ``r % device_count``.  Rank and world come from the arguments, else
    from the environment (``RANK``/``WORLD_SIZE``/``MASTER_ADDR``, as
    ``torchrun`` sets them), else a one-rank group on a free localhost
    port.  A second call returns the existing group's rank and world.
    ``timeout`` bounds every collective's wait (torch's default if None).
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    device = resolve_device(device)
    if init_method is None:
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            init_method = "env://"
            rank = int(os.environ["RANK"])
            world_size = int(os.environ["WORLD_SIZE"])
        else:
            init_method = f"tcp://127.0.0.1:{_free_port()}"
            rank, world_size = 0, 1
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank or 0)) % torch.cuda.device_count()
        torch.cuda.set_device(local)
    dist.init_process_group(backend or backend_for(device),
                            init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)
    return dist.get_rank(), dist.get_world_size()
