"""Training runtime: the data-parallel step factory and the loop
(``repro/runtime/train_loop.py``, the ``microbatch == 1`` path).

One step: forward and backward on the local batch, ``GradSync`` over the
gradients (the strategy's schedule of bucketed all-reduces, staged
through the fused pack/unpack kernels), ``clip_by_global_norm``, the
optimizer update, and an all-reduce of the loss for logging.  The loss
divides by the GLOBAL batch, so the summed gradients are the mean.

Under a strategy that ``uses_in_scan`` (depcha) with a config that asks
for it (``depcha_in_scan``), the family's stacked layer leaves are
summed inside the backward, one collective a layer (``core/overlap.py::
LayerSync``, set up once here), and the post-backward schedule skips
them; the step waits on those collectives, after the post-backward
schedule is issued and before the clip.

Each stage runs under a profiler label (``step.forward``,
``step.backward``, ``step.gradsync``, ``step.depcha_wait``,
``step.optimizer``, ``step.loss_allreduce``; GradSync's ops nest as
``comm.<kind>...``), so a ``torch.profiler`` trace splits the step by
layer.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.core import GradSync, GradSyncConfig, get_strategy
from repro_torch.core import dependency as dep
from repro_torch.core.dependency import chain_groups, resolve_device
from repro_torch.models.registry import family_of
from repro_torch.optim.optimizers import (
    Optimizer,
    apply_updates,
    clip_by_global_norm,
)
from repro_torch.utils.trees import flatten_with_names, tree_unflatten


@dataclasses.dataclass
class TrainStep:
    fn: Callable[..., Any]   # (model, opt_state, batch, step) -> (model, opt_state, metrics)
    gradsync: GradSync
    device: torch.device
    layer_sync: Any = None   # core.overlap.LayerSync under depcha in-scan, else None


def make_train_step(
    cfg: Any,
    mesh,
    sync: GradSyncConfig,
    optimizer: Optimizer,
    *,
    model: torch.nn.Module,
    clip_norm: float = 1.0,
    zero1_mode: bool = False,
    microbatch: int = 1,
    pp_stages: int = 1,
    device: str | torch.device = "cuda",
) -> TrainStep:
    """Build the data-parallel train step for one (arch, mesh, sync).

    ``model`` gives the parameter shapes (its ``params_tree()`` is the
    reference's tree).  The step updates the model's parameters and
    ``opt_state`` in place and returns them with the metrics
    (``loss`` summed over ranks, ``grad_norm``).  Runs on ``device``:
    CUDA unless the caller passes ``"cpu"``; raises if CUDA is asked for
    and absent.
    """
    if zero1_mode:
        raise NotImplementedError("ZeRO-1: ROADMAP queue 1 item 8")
    if microbatch != 1:
        raise NotImplementedError(
            "gradient accumulation (microbatch > 1): ROADMAP queue 1 item 8")
    if pp_stages != 1:
        raise NotImplementedError("pipeline stages: ROADMAP queue 1 item 13")
    device = resolve_device(device)
    api = family_of(cfg)
    if api.train_forward is None:
        raise NotImplementedError(
            f"{api.family} training: ROADMAP queue 1 item 12")
    params_like = model.params_tree()
    # sum leaves inside the backward, and skip them from the post-backward
    # schedule, ONLY when the strategy and the config both ask for it
    in_scan = (api.in_scan_names(params_like)
               if get_strategy(sync.strategy).uses_in_scan
               and getattr(cfg, "depcha_in_scan", False) else frozenset())
    layer_sync = None
    if in_scan:
        if api.layer_sync is None:
            raise NotImplementedError(
                f"{api.family}: in-backward sync, ROADMAP queue 1 item 12")
        layer_sync = api.layer_sync(cfg, params_like, mesh, device)
        if layer_sync is None or set(layer_sync.names) != set(in_scan):
            raise ValueError(f"{api.family}: the in-backward sync does not cover "
                             f"the in-scan leaves")
    gs = GradSync(sync, mesh, api.param_specs(params_like, cfg), params_like,
                  in_scan_names=in_scan, device=device)
    loss_group = chain_groups([0], device)[0]
    fwd_kw = {"layer_sync": layer_sync} if layer_sync is not None else {}

    def step(model, opt_state, batch, step_idx: int):
        model.zero_grad(set_to_none=True)
        tree = model.params_tree()
        if layer_sync is not None:
            layer_sync.begin()
        with record_function("step.forward"):
            loss = api.train_forward(tree, batch, cfg, **fwd_kw)
        with record_function("step.backward"):
            loss.backward()
        named, treedef = flatten_with_names(tree)
        # the in-scan leaves' gradients come from the in-backward sync
        missing = [n for n, p in named if p.grad is None and n not in in_scan]
        if missing:
            raise RuntimeError(f"no gradient for {missing}")
        with record_function("step.gradsync"):
            grads_tree = gs(tree_unflatten(treedef, [p.grad for _, p in named]))
        grads = dict(flatten_with_names(grads_tree)[0])
        if layer_sync is not None:
            stacked = dict(named)
            with record_function("step.depcha_wait"):
                layer_sync.finish([stacked[n] for n in layer_sync.names])
            grads.update({n: stacked[n].grad for n in layer_sync.names})
        with record_function("step.optimizer"):
            if clip_norm:
                grads, gnorm = clip_by_global_norm(grads, clip_norm)
            else:
                gnorm = torch.zeros((), device=device)
            params = {n: p.data for n, p in named}
            updates, opt_state = optimizer.update(grads, opt_state, params,
                                                  step_idx)
            apply_updates(params, updates)
        with record_function("step.loss_allreduce"):
            loss = loss.detach()
            dep.collective(dist.all_reduce, loss_group, loss).wait()
        return model, opt_state, {"loss": loss, "grad_norm": gnorm}

    return TrainStep(step, gs, device, layer_sync)


class Trainer:
    """Training driver: runs the step over the pipeline's batches, times
    each step (the first reported apart: it carries one-time set-up such
    as kernel loading and communicator creation) and keeps the losses.
    Checkpointing, fault injection and ``repro.obs`` metrics come in
    later slices."""

    def __init__(self, step_fn: TrainStep, pipeline, *, log_every: int = 10,
                 printer: Callable[[str], None] = print):
        self.step_fn = step_fn
        self.pipeline = pipeline
        self.log_every = log_every
        self.printer = printer
        self.step_times: list[float] = []
        self.first_step_time: float | None = None

    def run(self, model, opt_state, num_steps: int, start_step: int = 0
            ) -> tuple[Any, Any, dict]:
        device = self.step_fn.device
        losses: list[float] = []
        for step in range(start_step, num_steps):
            batch = self.pipeline.batch_at(step)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            model, opt_state, metrics = self.step_fn.fn(
                model, opt_state, batch, step)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            if self.first_step_time is None:
                self.first_step_time = dt
            else:
                self.step_times.append(dt)
            losses.append(float(metrics["loss"]))
            if step % self.log_every == 0:
                self.printer(f"[trainer] step {step} loss {losses[-1]:.4f} "
                             f"({dt * 1e3:.1f} ms)")
        return model, opt_state, {
            "losses": losses,
            "step_times": list(self.step_times),
            "first_step_time": self.first_step_time,
        }
