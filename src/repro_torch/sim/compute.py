"""Per-bucket compute timing: when does each gradient bucket become
ready during the backward pass?  The port of ``repro/sim/compute.py``.

The simulator needs two things from the compute side:
  - ``t_fwd`` / ``t_bwd`` — step-level forward/backward durations, derived
    from model FLOPs (``repro_torch.configs``/``repro_torch.models``) and
    a hardware model;
  - per-bucket *release times* — buckets are created in gradient-ready
    order (``make_bucket_plan(reverse=True)``), so bucket ``i`` is
    released once its cumulative share of the backward has run.  For
    in-scan strategies (depcha) releases snap to scan-step boundaries:
    the sum is issued at the END of its layer's backward step.

FLOP models (forward, whole step):
  LM families      2 · params · tokens           (dense matmul bound)
  conv families    params · img² / 256 · images  (the reference's
                   calibration on the paper's models: ResNet-50/CIFAR →
                   ~1.0e8 flops/image, ResNet-50/ImageNet → ~5e9)
Backward ≈ 2 × forward throughout (the standard 1:2 fwd:bwd split).

The defaults are an NVIDIA H100 SXM's (NVIDIA data sheet; the card the
port is measured on reports itself as "NVIDIA H100 80GB HBM3, 700.00 W"
to ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``),
figures fitted on that card (the staging model), or assumptions that
are no measurement, each marked as such.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

# H100 SXM data sheet: dense bf16 tensor-core peak and HBM3 bandwidth
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Per-card compute throughput."""

    peak_flops: float = H100_BF16_FLOPS   # data sheet, bf16 dense
    mfu: float = 0.4             # assumption (the reference's ratio), not measured

    @property
    def flops(self) -> float:
        return self.peak_flops * self.mfu


@dataclasses.dataclass(frozen=True)
class StagingModel:
    """HBM cost of CopyFromTo staging (pack/unpack around a collective).

    Staging is compute-side work — a local HBM pass per direction — not
    network time, so it lives here next to the FLOP model.  Two modes:

      fused     — ONE kernel per direction reads the leaves and writes
                  the cast (+loss-scaled) comm buffer: ~2·nbytes of HBM
                  traffic and a single launch (rows 1–2).
      leafwise  — per-leaf ravel+cast then concatenate (and per-leaf
                  slice+cast back): two passes over the payload
                  (~4·nbytes) plus one copy op PER LEAF.
    """

    # fitted on the card: ``obs.calibrate.fit_staging`` over rows 1-2's
    # device time a call, the L2 flushed before each (``chip_smoke.py``'s
    # ``sim`` phase: 80 rows, buckets of 16 KiB to 4 MiB, rel residual
    # 0.028-0.030, "ok"), NVIDIA H100 80GB HBM3 at 700.00 W, two runs:
    # 2.7298 and 2.7405 TB/s (0.82 of the data sheet's 3.35) and 5.394
    # and 5.721 us a launch; their means
    hbm_bw: float = 2.735e12       # bytes/s
    leaf_overhead: float = 5.56e-6  # per-launch cost
    fused_passes: float = 2.0      # read + write, once
    leafwise_passes: float = 4.0   # cast pass + concatenate pass

    def stage_time(self, nbytes: float, num_leaves: int, *,
                   fused: bool) -> float:
        """One direction (pack OR unpack) of one bucket's staging."""
        passes = self.fused_passes if fused else self.leafwise_passes
        ops = 1 if fused else max(int(num_leaves), 1)
        return passes * nbytes / self.hbm_bw + ops * self.leaf_overhead


@dataclasses.dataclass(frozen=True)
class UpdateModel:
    """HBM cost of one scheduled optimizer UPDATE op.

    The sharded update is elementwise math: read the gradient shard, the
    param shard and the optimizer moments, write the update and the new
    moments — ~7 passes over the shard for AdamW-class optimizers — plus
    a dispatch overhead.  ZeRO-1 shrinks the shard by the dp group size,
    which is what this model prices against the monolithic update.
    """

    hbm_bw: float = H100_HBM_BYTES_PER_S   # data sheet; bytes/s
    passes: float = 7.0          # g, p, m, v reads + u, m, v writes
    overhead: float = 2e-6       # assumption (the reference's): per-op dispatch cost

    def update_time(self, shard_bytes: float) -> float:
        return self.passes * shard_bytes / self.hbm_bw + self.overhead


@dataclasses.dataclass(frozen=True)
class ComputeModel:
    """Step-level compute durations + bucket release-time policy."""

    t_fwd: float
    t_bwd: float
    n_stages: int = 1        # backward scan steps (layers); release grain
    update: UpdateModel = UpdateModel()   # UPDATE-op (shard math) cost

    def bucket_release_times(
        self,
        bucket_sizes: Sequence[tuple[int, int]],
        *,
        per_stage: bool = False,
    ) -> dict[int, float]:
        """bucket_id → time its gradients exist.

        ``bucket_sizes`` is (bucket_id, elems); bucket_ids ascend in
        gradient-ready order (the bucketer's creation order).  With
        ``per_stage`` the release snaps up to the owning scan step's end
        (in-scan sums are issued per layer, not per element).
        """
        total = sum(s for _, s in bucket_sizes)
        if total <= 0:
            return {bid: self.t_fwd for bid, _ in bucket_sizes}
        out: dict[int, float] = {}
        cum = 0
        for bid, size in sorted(bucket_sizes):
            cum += size
            frac = cum / total
            if per_stage and self.n_stages > 1:
                frac = math.ceil(frac * self.n_stages) / self.n_stages
            out[bid] = self.t_fwd + self.t_bwd * frac
        return out

    @property
    def end(self) -> float:
        return self.t_fwd + self.t_bwd

    def with_accum(self, accum: int, *,
                   overlap_tail: bool = True) -> "ComputeModel":
        """Fold an M-microbatch gradient-accumulation loop into the step.

        ``self`` is the PER-MICROBATCH model.  The returned model spans
        the whole M-microbatch step: with ``overlap_tail`` (the peeled
        final microbatch) the first M-1 microbatches become pure head
        compute and releases happen during the FINAL microbatch's
        backward.  Without it (the port's one order: the sync starts
        after the last backward) every release waits for the whole loop.
        """
        if accum <= 1:
            return self
        micro = self.t_fwd + self.t_bwd
        if overlap_tail:
            return dataclasses.replace(
                self, t_fwd=(accum - 1) * micro + self.t_fwd)
        return dataclasses.replace(self, t_fwd=accum * micro, t_bwd=0.0)


@dataclasses.dataclass(frozen=True)
class PipelineTimeline:
    """One pipeline step's analytic timeline.

    ``op_release`` maps every SEND/RECV op of the plan to the time its
    payload exists (the producing slot's compute end) — feed it to
    ``sim.engine.simulate(release_times=...)`` so the rendezvous pairs
    start no earlier than the stage compute that produces them.
    ``stage_grad_release`` is per GLOBAL stage: the end of that stage's
    final backward slot, i.e. when its gradients exist and the bucket
    reduce-scatters wired by ``compose_step`` may begin.
    """

    wall: float              # last slot (or lockstep wave) retires
    fwd_wall: float          # forward phase wall (gpipe: flush point)
    pure_compute: float      # per-device compute alone (no bubble/wire)
    op_release: dict         # op_id -> payload-ready time
    stage_grad_release: tuple[float, ...]   # per global stage

    @property
    def bubble_fraction(self) -> float:
        """Idle share of the wall: 1 − pure_compute / wall.  For the
        lockstep GPipe model at wire_time=0 this is exactly
        (S−1)/(M+S−1)."""
        if self.wall <= 0.0:
            return 0.0
        return max(0.0, 1.0 - self.pure_compute / self.wall)


def pipeline_timeline(plan, compute: ComputeModel, *,
                      wire_time: float = 0.0) -> PipelineTimeline:
    """Cost a ``core.pipeline_program.PipelinePlan`` against ``compute``.

    ``compute.t_fwd``/``t_bwd`` are WHOLE-step durations; each of the
    ``M × S_tot`` forward (backward) slots takes an even share.
    ``wire_time`` is one boundary crossing (the SEND/RECV hop, priced by
    ``NetworkModel.p2p_time``).

    gpipe        lockstep wave model: every wave is ``t_slot + wire``
                 across all stages (each wave ends in a hop every stage
                 joins), so the wire rides the critical path of every
                 wave.
    1f1b /       deterministic replay of ``plan.commits`` with real
    interleaved  durations: a slot starts at max(device clock, input
                 arrival), where arrivals pay ``wire_time`` once per
                 boundary crossing.  In steady state the transfer
                 overlaps the neighbor's compute.
    """
    S, M, v = plan.n_stages, plan.n_microbatches, plan.virtual
    S_tot = S * v
    slots = max(1, M * S_tot)
    tf = compute.t_fwd / slots
    tb = compute.t_bwd / slots
    w = max(0.0, float(wire_time))
    pure = M * v * (tf + tb)      # one device's share: v stages × M slots

    slot_end: dict[tuple[str, int, int], float] = {}
    if plan.kind == "gpipe":
        wave_f, wave_b = tf + w, tb + w
        t_flush = (M + S - 1) * wave_f
        for m in range(M):
            for g in range(S):
                slot_end[("F", g, m)] = (g + m) * wave_f + tf
                slot_end[("B", g, m)] = (
                    t_flush + ((S - 1 - g) + m) * wave_b + tb)
        fwd_wall = t_flush
        wall = t_flush + (M + S - 1) * wave_b
    else:
        dev_clock = [0.0] * S
        fwd_wall = wall = 0.0
        for dev, slot in plan.commits:
            g, m = slot.stage, slot.mb
            if slot.phase == "F":
                ready = (0.0 if g == 0
                         else slot_end[("F", g - 1, m)] + w)
                end = max(dev_clock[dev], ready) + tf
                fwd_wall = max(fwd_wall, end)
            else:
                ready = (slot_end[("F", g, m)] if g == S_tot - 1
                         else slot_end[("B", g + 1, m)] + w)
                end = max(dev_clock[dev], ready) + tb
            slot_end[(slot.phase, g, m)] = end
            dev_clock[dev] = end
            wall = max(wall, end)

    # SEND and its RECV both release when the producing slot's compute
    # ends: for a forward boundary that is F(g, m) itself; for a
    # backward boundary the producing slot is the consumer-side mapping
    # recorded in op_slot (the recv cannot fire before the payload
    # exists, which the paired-send release plus the SEND→RECV data edge
    # enforces).
    op_release: dict[int, float] = {}
    for op_id, (role, slot) in plan.op_slot.items():
        g, m = slot.stage, slot.mb
        if role == "send":
            op_release[op_id] = slot_end[(slot.phase, g, m)]
        else:
            src = (("F", g - 1, m) if slot.phase == "F"
                   else ("B", g + 1, m))
            op_release[op_id] = slot_end[src]

    grad_release = tuple(slot_end[("B", g, M - 1)] for g in range(S_tot))
    return PipelineTimeline(
        wall=wall, fwd_wall=fwd_wall, pure_compute=pure,
        op_release=op_release, stage_grad_release=grad_release)


def count_params(cfg) -> int:
    """Total parameter elements of the config's global tree, drawn on the
    ``meta`` device (no memory)."""
    from repro_torch.configs.base import param_structs
    from repro_torch.utils.trees import tree_leaves

    return sum(math.prod(l.shape) if l.shape else 1
               for l in tree_leaves(param_structs(cfg)))


def fwd_flops(cfg, *, global_batch: int, seq_len: int,
              params: int | None = None) -> float:
    """Whole-step forward FLOPs for any registered model family."""
    from repro_torch.models.registry import family_of

    p = params if params is not None else count_params(cfg)
    family = family_of(cfg).family
    if family in ("resnet", "inception"):
        return p * (cfg.img_size ** 2) / 256.0 * global_batch
    return 2.0 * p * global_batch * max(seq_len, 1)


def n_stages_of(cfg) -> int:
    """Backward scan steps: layers for scanned families, stages for convnets."""
    n = getattr(cfg, "n_layers", None)
    if n:
        return int(n)
    stages = getattr(cfg, "stages", None)
    if stages:
        return int(sum(stages))
    return 1


def compute_model_for(cfg, *, global_batch: int, seq_len: int,
                      n_devices: int,
                      hw: HardwareModel | None = None) -> ComputeModel:
    """Derive the step's compute timeline from model FLOPs and the mesh
    size (compute is data-parallel: per-device share of the step)."""
    hw = hw or HardwareModel()
    f = fwd_flops(cfg, global_batch=global_batch, seq_len=seq_len)
    t_fwd = f / (max(n_devices, 1) * hw.flops)
    return ComputeModel(t_fwd=t_fwd, t_bwd=2.0 * t_fwd,
                        n_stages=n_stages_of(cfg))
