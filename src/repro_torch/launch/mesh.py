"""Meshes and process-group setup (``repro/launch/mesh.py``).

The port's ``Mesh`` is the reference mesh's shape alone: axis names and
sizes.  Data parallelism spans every rank of the process group; the
"model" axis has extent 1 until tensor parallelism is ported.

A multi-pod mesh (``make_pod_mesh``; ``make_dp_mesh(multi_pod=True)``,
the counterpart of ``make_production_mesh(multi_pod=True)``) is
("pod", "data", "model") over a world of pods × data ranks, rank
p·data + d at (p, d): the device order of the reference's mesh.  A pod's
ranks are meant to share one host: the hierarchical reducers' intra-pod
rings write into each other's memory (``core/dependency.py::pod_comms``).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import socket

import torch
import torch.distributed as dist

from repro_torch.core.dependency import backend_for, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    shape: dict[str, int]


def make_smoke_mesh(data: int = 1, model: int = 1) -> Mesh:
    """The reference's two-axis ("data", "model") mesh; both axes always
    present so every collective path runs."""
    if model != 1:
        raise NotImplementedError(
            "a model axis > 1 is tensor parallelism: ROADMAP queue 1 item 9")
    return Mesh(("data", "model"), {"data": data, "model": model})


def make_pod_mesh(pods: int, data: int) -> Mesh:
    """The reference's ("pod", "data", "model") mesh: ``pods`` pods of
    ``data`` ranks each, rank p·data + d at (p, d), model extent 1."""
    if pods < 1 or data < 1:
        raise ValueError(f"a pod mesh needs pods, data >= 1; got {pods} x {data}")
    return Mesh(("pod", "data", "model"), {"pod": pods, "data": data, "model": 1})


def make_dp_mesh(multi_pod: bool = False) -> Mesh:
    """Data parallelism over every rank of the initialized process group;
    with ``multi_pod`` as two pods of half the world each (the reference's
    multi-pod production mesh has two pods).  A world that does not split
    into two pods raises."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not multi_pod:
        return make_smoke_mesh(world)
    if world < 2 or world % 2:
        raise ValueError(f"--multi-pod needs a world of two equal pods; "
                         f"{world} rank(s) do not split into two")
    return make_pod_mesh(2, world // 2)


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
