"""Pipeline parallelism over a "stage" mesh axis (DESIGN.md §15) — the
port of ``repro/parallel/pipeline.py``.

Two layers, as the reference's:

- ``pipeline_forward``: the GPipe-style inference skeleton.  Each rank
  holds one stage's params and, wave by wave, applies its stage to the
  microbatch it holds and passes the activation to the next stage; the
  outputs, on the last stage, reach the caller by a sum over the stage
  axis ("psum") or one hop to stage 0 ("hop").  Bubble fraction
  (S − 1)/(M + S − 1) for S stages and M microbatches.
- ``pipeline_wave_loss``: the differentiable training counterpart used
  by ``runtime/train_loop.py`` with pipeline stages: the same waves,
  carrying a tuple of tensors (the activation and the MoE aux) and
  giving the last stage's per-microbatch losses.

The reference's ``ppermute`` is ``_Hop``, a ``torch.autograd.Function``
on the stage communicator (a ``StageAxis``): group rank i sends to
i + shift and receives from i − shift, mod S; its backward is the
reverse hop, ppermute's VJP.  Every rank must meet every hop in the
same order, forward and backward.  Forward, the wave loop issues them
in one order on every rank.  Backward, autograd runs a node once the
gradient of each of its outputs has arrived, so the graph is built for
that order to be the reverse of the forward's on every rank: hop t's
output feeds wave t + 1's input on every stage (stage 0 through
``_Select``, which hands the discarded carry an exact-zero cotangent,
as the reference's ``jnp.where`` does), and the last wave's carry is
tied to the loss by ``_Sink`` (another exact zero).  Hop t's backward
then needs wave t + 1's, which needs hop t + 1's.

Off-wave slots (a stage with no microbatch in that wave) run no
compute: their carry passes through to the hop unchanged.  The
reference computes and masks them; their contributions are exact
zeros, so skipping them gives the same gradients, and a staged run
stays bit-identical to its own stage = 1 run: each layer sees its
microbatches' cotangents in one order (the last microbatch first) on
every layout, and a stage-replicated leaf's gradient is nonzero on one
stage only.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch.core import dependency as dep
from repro_torch.parallel.sharding import STAGE_AXIS


@dataclasses.dataclass(frozen=True)
class StageAxis:
    """The "stage" mesh axis as one rank sees it: ``group`` the
    communicator of its stage group (the ranks that share its other
    coordinates; None at extent 1), ``index`` its stage, ``size`` the
    extent (S)."""

    group: dist.ProcessGroup | None
    index: int
    size: int


NO_STAGE_AXIS = StageAxis(None, 0, 1)


def stage_axis(mesh, device: str | torch.device = "cuda") -> StageAxis:
    """This rank's ``StageAxis`` on ``mesh``.  Collective: every world
    rank creates every stage group (none at extent 1); a rank outside the
    mesh gets no group."""
    size = mesh.shape.get(STAGE_AXIS, 1)
    if size == 1:
        return NO_STAGE_AXIS
    group = dep.coset_groups([(STAGE_AXIS,)], mesh,
                             dep.resolve_device(device))[(STAGE_AXIS,)]
    me = dep.mesh_rank(mesh)
    return StageAxis(group, 0 if me is None else mesh.coords(me)[STAGE_AXIS], size)


def ring_hop(axis: StageAxis, shift: int,
             xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """One hop of every tensor of ``xs`` along the stage ring, no
    autograd (``dependency.ring_exchange``, which counts it)."""
    return dep.ring_exchange(axis.group, axis.index, axis.size, shift, xs)


class _Hop(torch.autograd.Function):
    """ppermute over the stage axis; its backward is the reverse hop."""

    @staticmethod
    def forward(ctx, axis: StageAxis, shift: int, *xs: torch.Tensor):
        ctx.axis, ctx.shift = axis, shift
        return tuple(ring_hop(axis, shift, xs))

    @staticmethod
    def backward(ctx, *gs: torch.Tensor):
        return (None, None, *ring_hop(ctx.axis, -ctx.shift, gs))


class _Select(torch.autograd.Function):
    """The first ``n`` inputs (stage 0's injected microbatch); the rest
    (the ring's carry) get an exact-zero cotangent, as the reference's
    ``jnp.where`` gives its discarded branch, so the hop that made them
    stays in the backward."""

    @staticmethod
    def forward(ctx, n: int, *xs: torch.Tensor):
        ctx.n = n
        ctx.rest = [(x.shape, x.dtype, x.device) for x in xs[n:]]
        return tuple(x.view_as(x) for x in xs[:n])

    @staticmethod
    def backward(ctx, *gs: torch.Tensor):
        return (None, *gs, *(torch.zeros(s, dtype=d, device=dv) for s, d, dv in ctx.rest))


class _Sink(torch.autograd.Function):
    """``losses`` unchanged; the final carry, which no stage reads, gets
    an exact-zero cotangent, so the last hop's backward runs too."""

    @staticmethod
    def forward(ctx, losses: torch.Tensor, *carry: torch.Tensor):
        ctx.carry = [(x.shape, x.dtype, x.device) for x in carry]
        return losses.view_as(losses)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return (g, *(torch.zeros(s, dtype=d, device=dv) for s, d, dv in ctx.carry))


def pipeline_forward(stage_fn: Callable, stage_params, microbatches: torch.Tensor, *,
                     axis: StageAxis, broadcast: str = "psum") -> torch.Tensor:
    """Run M microbatches (``microbatches``: (M, mb, ...)) through the S
    stages of ``axis``; returns the outputs in microbatch order, shape
    and dtype of ``microbatches``.  Each rank applies
    ``stage_fn(stage_params, x)`` to the microbatch it holds in each wave
    and hops the activation one stage on.

    ``broadcast`` picks how the outputs, on the last stage, reach the
    caller: "psum" sums them over the stage axis with every other stage's
    zeros (the result on every stage; integer outputs stay integer);
    "hop" moves them last → first in one transfer, so only stage 0 holds
    them (the other stages get zeros)."""
    if broadcast not in ("psum", "hop"):
        raise ValueError(f"broadcast must be 'psum' or 'hop', got {broadcast!r}")
    M, S, sid = microbatches.shape[0], axis.size, axis.index
    outputs = torch.zeros_like(microbatches)
    carry = torch.zeros_like(microbatches[0])
    with torch.no_grad():
        for t in range(M + S - 1):
            m = t - sid
            if 0 <= m < M:
                y = stage_fn(stage_params, microbatches[t] if sid == 0 else carry)
                if sid == S - 1:
                    outputs[m] = y
            else:
                y = carry
            if t < M + S - 2:
                carry = ring_hop(axis, 1, [y])[0]
        if S == 1:
            return outputs
        if broadcast == "psum":
            dep.collective(dist.all_reduce, axis.group, outputs).wait()
            return outputs
        if sid == S - 1:
            dep.exchange(axis.group, [(outputs, 0, 0)], [])
            return torch.zeros_like(outputs)
        if sid == 0:
            got = torch.empty_like(outputs)
            dep.exchange(axis.group, [], [(got, S - 1, 0)])
            return got
        return torch.zeros_like(outputs)


def pipeline_wave_loss(inject_fn: Callable[[int], tuple], stage_fn: Callable[[tuple], tuple],
                       loss_fn: Callable[[tuple, int], torch.Tensor], n_microbatches: int, *,
                       axis: StageAxis, carry_like: Sequence[torch.Tensor]) -> torch.Tensor:
    """The differentiable wave pipeline for training: returns the (M,) f32
    per-microbatch losses, nonzero only on the last stage (the caller
    sums them over the stage axis outside the backward: the other
    stages add zeros).

    - ``inject_fn(m)`` → the carry (a tuple of tensors) of microbatch
      ``m`` entering stage 0 (the embedded tokens and a zero aux);
    - ``stage_fn(carry)`` → the carry after this rank's layer slice;
    - ``loss_fn(carry, m)`` → the scalar loss of microbatch ``m`` (the
      head and the cross-entropy), on the last stage;
    - ``carry_like``: tensors of the carry's shapes and dtypes (the
      ring's first carry is zeros like them).

    Backward from the returned vector's sum runs every hop's reverse in
    reverse order on every rank (module docstring)."""
    M, S, sid = n_microbatches, axis.size, axis.index
    last = S - 1
    carry = tuple(torch.zeros_like(c).requires_grad_() for c in carry_like)
    n = len(carry)
    losses: list[torch.Tensor | None] = [None] * M
    for t in range(M + S - 1):
        m = t - sid
        x = carry
        if sid == 0 and t < M:
            x = _Select.apply(n, *inject_fn(t), *carry)
        if 0 <= m < M:
            y = tuple(stage_fn(x))
            if sid == last:
                losses[m] = loss_fn(y, m)
        else:
            y = x
        carry = _Hop.apply(axis, 1, *y) if t < M + S - 2 else y
    if sid == last:
        out = torch.stack([l.to(torch.float32) for l in losses])
    else:
        out = torch.zeros((M,), dtype=torch.float32, device=carry[0].device)
    return _Sink.apply(out, *carry)


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
