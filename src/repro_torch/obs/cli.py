"""``python -m repro_torch.obs`` — measure, diff, trace, and fit; the port
of ``repro/obs/cli.py``.

Builds a small sharded param stack on the world's mesh (``launch/mesh.py::
make_mesh``: a "model" axis of ``--model``, the rest of the world on
"data"), plans the configured strategy's schedule, then:

  --diff         per-op sim-vs-measured table, largest divergence first
  --trace PATH   one merged Chrome/Perfetto trace: a simulated and a
                 measured track for the SAME schedule
  --fit          measure across bucket sizes, fit the alpha-beta
                 NetworkModel, write the per-mesh profile ``auto`` prefers

The world is torchrun-style: rank and world from ``RANK``/``WORLD_SIZE``
(``init_dist``), else one rank.  Rank 0 prints and writes.

    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc_per_node 4 \
        -m repro_torch.obs --diff --device cpu --model 2
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc_per_node 4 \
        -m repro_torch.obs --fit --device cpu
"""
from __future__ import annotations

import argparse
import json
import math
import os
from typing import Any

D_MODEL, D_FF, LAYERS = 128, 512, 4


def build_setup(strategy: str, reducer: str, bucket_kib: int, mesh, device, **sync):
    """A GradSync + this rank's shards of seeded global grads over a
    synthetic 4-layer param stack (matmuls sharded over "model" and
    replicated norms: both grad reduce-axis groups appear).  ``sync``
    adds ``GradSyncConfig`` fields (a ZeRO-1 StepProgram's, say)."""
    import torch

    from repro_torch.core import GradSync, GradSyncConfig
    from repro_torch.core.dependency import mesh_rank
    from repro_torch.parallel.sharding import localize_structs, shard_tree

    params: dict[str, Any] = {}
    specs: dict[str, Any] = {}
    for i in range(LAYERS):
        params[f"layer{i}.wi"] = torch.empty((D_MODEL, D_FF), device="meta")
        specs[f"layer{i}.wi"] = (None, "model")
        params[f"layer{i}.wo"] = torch.empty((D_FF, D_MODEL), device="meta")
        specs[f"layer{i}.wo"] = ("model", None)
        params[f"layer{i}.scale"] = torch.empty((D_MODEL,), device="meta")
        specs[f"layer{i}.scale"] = ()
    cfg = GradSyncConfig(strategy=strategy, reducer=reducer, mean_axes=("data",),
                         bucket_bytes=bucket_kib << 10, **sync)
    gs = GradSync(cfg, mesh, specs, localize_structs(params, specs, mesh), device=device)
    full = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(i))
            for i, (k, v) in enumerate(sorted(params.items()))}
    grads = {k: v.contiguous().to(device)
             for k, v in shard_tree(full, specs, mesh, mesh_rank(mesh)).items()}
    return gs, grads


def _sim_timeline(gs):
    from repro_torch.sim.engine import SimConfig, simulate

    return simulate(
        gs.schedule, gs.mesh_shape,
        sim=SimConfig(itemsize=gs.cfg.comm_dtype.itemsize,
                      reducer=gs.cfg.reducer,
                      fused_staging=gs.cfg.use_fused_staging))


def _measure(gs, grads, reps: int):
    from repro_torch.obs.measure import measured_gradsync

    _, timeline, info = measured_gradsync(gs, grads, reps=reps)
    return timeline, info


def cmd_diff(gs, sim_tl, meas_tl, say=print) -> list:
    """Op-by-op divergence table, largest |log ratio| first; the rows."""
    sim_by = {e.op_id: e for e in sim_tl.events}
    rows = []
    for ev in meas_tl.events:
        se = sim_by[ev.op_id]
        sim_us = se.duration * 1e6
        meas_us = ev.duration * 1e6
        ratio = meas_us / sim_us if sim_us > 0 else float("inf")
        rows.append((ev.op_id, ev.kind, ev.bucket_id, sim_us, meas_us, ratio))
    rows.sort(key=lambda r: abs(math.log(max(r[5], 1e-12))), reverse=True)
    say(f"{'op':>4} {'kind':<16} {'bucket':>6} {'sim_us':>10} "
        f"{'meas_us':>10} {'meas/sim':>9}")
    for op_id, kind, bid, s, m, r in rows:
        say(f"{op_id:>4} {kind:<16} {bid:>6} {s:>10.1f} {m:>10.1f} {r:>9.2f}")
    say(f"total sim {sim_tl.step_time * 1e6:.1f}us  "
        f"measured(serial) {meas_tl.step_time * 1e6:.1f}us  "
        f"largest divergence: op {rows[0][0]} ({rows[0][1]}) "
        f"x{rows[0][5]:.2f}" if rows else "no events")
    return rows


def cmd_trace(gs, sim_tl, meas_tl, path: str, strategy: str, say=print) -> None:
    from repro_torch.sim.trace import write_chrome_trace

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_chrome_trace(path, {
        f"measured:{strategy}": meas_tl,
        f"simulated:{strategy}": sim_tl,
    })
    ok = len(sim_tl.events) == len(meas_tl.events) == len(gs.schedule.ops)
    say(f"wrote {path}: simulated track {len(sim_tl.events)} ops, "
        f"measured track {len(meas_tl.events)} ops, IR "
        f"{len(gs.schedule.ops)} ops — "
        f"{'match' if ok else 'MISMATCH'}")


def fit_rows(mesh, device, reducer: str = "flat", reps: int = 3,
             sizes_kib=(16, 64, 256)) -> tuple[list, dict]:
    """Measured calibration rows across bucket sizes and both transport
    families (concom's allreduces, rsag's reduce-scatters and
    all-gathers): ``(rows, mesh_shape)``.  Collective: every rank."""
    from repro_torch.obs.measure import measurement_rows

    rows: list[dict] = []
    mesh_shape = None
    for strategy in ("concom", "rsag"):
        for kib in sizes_kib:
            gs, grads = build_setup(strategy, reducer, kib, mesh, device)
            mesh_shape = gs.mesh_shape
            meas_tl, _ = _measure(gs, grads, reps)
            rows.extend(measurement_rows(gs.schedule, meas_tl, mesh_shape))
            gs.close()
    return rows, mesh_shape


def cmd_fit(args, mesh, device, say=print) -> str | None:
    """Measure across bucket sizes and both transport families, fit the
    NetworkModel, persist the per-mesh profile (rank 0)."""
    import torch.distributed as dist

    from repro_torch.obs.calibrate import REL_RESIDUAL_MAX, fit_network, save_profile

    rows, mesh_shape = fit_rows(mesh, device, args.reducer, args.reps)
    if dist.get_rank() != 0:
        return None
    model, info = fit_network(rows)
    path = save_profile(model, mesh_shape, dir=args.profile_dir, info=info)
    say(f"fitted {len(rows)} rows -> {path}")
    say(json.dumps(info["axes"], indent=1, sort_keys=True))
    say(f"rms residual {info['rms_residual_s'] * 1e6:.2f}us "
        f"({info['rel_residual'] * 100:.0f}% of signal) — "
        f"quality {info['quality']}")
    if info["quality"] != "ok":
        say("WARNING: poor fit (residual exceeds "
            f"{REL_RESIDUAL_MAX * 100:.0f}% of the measured signal) — "
            "profile saved for inspection, but `auto` will ignore it")
    return path


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="measured per-op telemetry: diff/trace/fit")
    p.add_argument("--strategy", default="concom")
    p.add_argument("--reducer", default="flat")
    p.add_argument("--bucket-kib", type=int, default=64)
    p.add_argument("--reps", type=int, default=3,
                   help="timed runs per op (min taken)")
    p.add_argument("--diff", action="store_true",
                   help="print the per-op sim-vs-measured table")
    p.add_argument("--trace", metavar="PATH",
                   help="write a merged sim+measured Chrome trace")
    p.add_argument("--fit", action="store_true",
                   help="fit the NetworkModel and write the profile")
    p.add_argument("--profile-dir", default=None,
                   help="profile output dir (default "
                        "$REPRO_TORCH_NETPROFILE_DIR or results/netprofiles_torch)")
    p.add_argument("--model", type=int, default=1,
                   help="the mesh's model extent (the rest of the world is data)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--backend", default=None,
                   help="process-group backend (default nccl on cuda, gloo on cpu)")
    return p


def run(args) -> None:
    """One rank's work, in an initialized (or to-be-initialized) world."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_dist, make_mesh

    init_dist(args.device, backend=args.backend)
    say = print if dist.get_rank() == 0 else (lambda *_a: None)
    mesh = make_mesh(model=args.model)
    try:
        if args.fit:
            cmd_fit(args, mesh, args.device, say)
            return
        gs, grads = build_setup(args.strategy, args.reducer, args.bucket_kib,
                                mesh, args.device)
        sim_tl = _sim_timeline(gs)
        meas_tl, _ = _measure(gs, grads, args.reps)
        if args.trace and dist.get_rank() == 0:
            cmd_trace(gs, sim_tl, meas_tl, args.trace, args.strategy, say)
        if args.diff or not args.trace:
            cmd_diff(gs, sim_tl, meas_tl, say)
        gs.close()
    finally:
        dist.destroy_process_group()


def main(argv: list[str] | None = None) -> None:
    run(_parser().parse_args(argv))
