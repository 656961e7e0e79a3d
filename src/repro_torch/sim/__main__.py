"""``python -m repro_torch.sim`` — simulate every collective-embedding
strategy for one (arch × shape × mesh) cell: predicted timelines, exposed
communication and the auto-tuned winner, on the CPU in seconds (no
process group, no device: the mesh is a stand-in of the asked shape).
The port of ``repro/sim/__main__.py``.

  PYTHONPATH=src python -m repro_torch.sim --arch resnet50-cifar
  PYTHONPATH=src python -m repro_torch.sim --arch qwen3-1.7b --shape train_4k \\
      --mesh multi --autotune --trace results/sim_trace.json
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import param_structs
from repro_torch.core.buckets import make_bucket_plan
from repro_torch.core.registry import fixed_strategy_names
from repro_torch.models.registry import family_of
from repro_torch.parallel.sharding import Mesh, dp_axes_of, localize_structs
from repro_torch.sim import (
    SimConfig,
    ascii_timeline,
    compute_model_for,
    grid_search,
    last_auto_report,
    plan_auto,
    rank_step_plans,
    simulate,
    simulate_strategy,
    write_chrome_trace,
)


def make_mesh(spec: str) -> Mesh:
    """A stand-in mesh: "single" (16 × 16 data × model), "multi" (2 pods of
    16 × 16), or DxM / PxDxM."""
    if spec == "single":
        dims: tuple[int, ...] = (16, 16)
    elif spec == "multi":
        dims = (2, 16, 16)
    else:
        dims = tuple(int(v) for v in spec.split("x"))
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}[len(dims)]
    return Mesh(axes, dict(zip(axes, dims)))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sim", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None,
                    help="shape name (default: the arch's train shape)")
    ap.add_argument("--mesh", default="single",
                    help="single | multi | DxM | PxDxM")
    ap.add_argument("--channels", type=int, default=4)
    ap.add_argument("--bucket-mb", type=float, default=4.0)
    ap.add_argument("--reducer", default="flat")
    ap.add_argument("--comm-dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--staging", default="fused", choices=["fused", "leafwise"],
                    help="CopyFromTo cost model: fused kernels vs per-leaf "
                         "pack/unpack")
    ap.add_argument("--autotune", action="store_true",
                    help="grid-search strategy × channels × bucket size")
    ap.add_argument("--zero1", action="store_true",
                    help="simulate the full-step ZeRO-1 StepProgram (per-bucket "
                         "RS→UPDATE→AG, plus the pipelined deferred-AG variant) "
                         "vs the flat allreduce + monolithic update baseline")
    ap.add_argument("--clip", action="store_true",
                    help="with --zero1: plan the scheduled grad-norm NORM op")
    ap.add_argument("--accum", type=int, default=1,
                    help="grad-accumulation factor M: cost the M-microbatch "
                         "loop (releases from the FINAL microbatch's backward)")
    ap.add_argument("--no-accum-overlap", action="store_true",
                    help="with --accum: releases at the loop's very end (the "
                         "port's one order)")
    ap.add_argument("--trace", default="",
                    help="write a Chrome-trace JSON of all timelines")
    ap.add_argument("--ascii", action="store_true",
                    help="render the best strategy's timeline")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    shape = (next(s for s in arch.shapes if s.name == args.shape) if args.shape
             else next((s for s in arch.shapes if s.kind == "train"), arch.shapes[0]))
    mesh = make_mesh(args.mesh)
    mesh_shape = dict(mesh.shape)
    cfg = arch.make_config(tp=mesh_shape.get("model", 1), dp_axes=dp_axes_of(mesh))
    structs = param_structs(cfg)
    api = family_of(cfg)
    specs = api.param_specs(structs, cfg)
    # the sync's payload is each rank's shard
    local = localize_structs(structs, specs, mesh)
    compute = compute_model_for(cfg, global_batch=shape.global_batch,
                                seq_len=shape.seq_len, n_devices=mesh.size)
    # with --accum the step's FLOPs stay those of the global batch; the
    # per-microbatch model is 1/M of it, folded where releases happen
    micro = compute
    if args.accum > 1:
        micro = dataclasses.replace(compute, t_fwd=compute.t_fwd / args.accum,
                                    t_bwd=compute.t_bwd / args.accum)
        compute = micro.with_accum(args.accum, overlap_tail=not args.no_accum_overlap)
    comm_dtype = torch.bfloat16 if args.comm_dtype == "bf16" else torch.float32
    itemsize = comm_dtype.itemsize
    sim = SimConfig(window=args.window, itemsize=itemsize, reducer=args.reducer,
                    fused_staging=args.staging == "fused")
    plan = make_bucket_plan(local, specs, mesh,
                            bucket_bytes=int(args.bucket_mb * 1024 * 1024),
                            num_channels=args.channels, comm_dtype=comm_dtype)

    print(f"[sim] {args.arch} × {shape.name} × {args.mesh} "
          f"({'x'.join(f'{k}={v}' for k, v in mesh_shape.items())}), "
          f"{plan.total_bytes / 1e6:.1f} MB grads in {len(plan.buckets)} buckets, "
          f"t_fwd={compute.t_fwd * 1e3:.2f} ms t_bwd={compute.t_bwd * 1e3:.2f} ms"
          + (f" (accum M={args.accum}, releases in the final microbatch's backward)"
             if args.accum > 1 and not args.no_accum_overlap else
             f" (accum M={args.accum}, releases after the loop)" if args.accum > 1
             else ""))

    print("strategy,ops,chains,step_ms,comm_ms,exposed_ms,overlap_pct")
    timelines = {}
    for name in fixed_strategy_names():
        schedule, tl = simulate_strategy(name, plan, mesh_shape, compute=compute, sim=sim)
        timelines[name] = tl
        print(f"{name},{len(schedule.ops)},{schedule.num_chains},"
              f"{tl.step_time * 1e3:.3f},{tl.total_comm * 1e3:.3f},"
              f"{tl.exposed_comm * 1e3:.3f},{tl.overlap_fraction * 100:.1f}")

    auto_schedule = plan_auto(plan, context={
        "mesh_shape": mesh_shape, "reducer": args.reducer, "itemsize": itemsize,
        "compute": compute, "fused_staging": args.staging == "fused"})
    report = last_auto_report()
    timelines["auto"] = simulate(auto_schedule, mesh_shape, compute=compute, sim=sim)
    print(f"[sim] auto → {report['winner']} "
          f"(predicted {report['ranking'][0][1] * 1e3:.3f} ms/step; network model "
          f"{report['net']})")

    # fused vs leafwise CopyFromTo on the winner's schedule: the staging
    # cost the fused kernels (rows 1–2) remove
    both = {mode: simulate(auto_schedule, mesh_shape, compute=compute,
                           sim=dataclasses.replace(sim, fused_staging=mode == "fused"))
            for mode in ("fused", "leafwise")}
    print(f"[sim] staging ({report['winner']}): "
          f"fused {both['fused'].step_time * 1e3:.3f} ms/step vs "
          f"leafwise {both['leafwise'].step_time * 1e3:.3f} ms/step "
          f"(Δ {(both['leafwise'].step_time - both['fused'].step_time) * 1e6:.1f} us)")

    if args.zero1:
        from repro_torch.core.stepprogram import zero1_bucket_plan

        dp = dp_axes_of(mesh)
        if not dp:
            raise SystemExit("[sim] --zero1 needs a data-parallel axis")
        dp_plan = zero1_bucket_plan(local, specs, mesh, dp_axes=dp,
                                    bucket_bytes=int(args.bucket_mb * 1024 * 1024),
                                    num_channels=args.channels)
        ranked = rank_step_plans(dp_plan, mesh_shape, dp_axes=dp, clip=args.clip,
                                 compute=micro, sim=sim, accum=args.accum,
                                 accum_overlap=not args.no_accum_overlap)
        print("step_plan,ops,update_ops,step_ms,exposed_ms,overlap_pct")
        for name, tl in ranked:
            ups = sum(1 for e in tl.events if e.kind == "update")
            print(f"{name},{len(tl.events)},{ups},{tl.step_time * 1e3:.3f},"
                  f"{tl.exposed_comm * 1e3:.3f},{tl.overlap_fraction * 100:.1f}")
            timelines[name] = tl
        best = {fam: next(t for n, t in ranked if n.startswith(fam + ":"))
                for fam in ("deferred", "zero1", "flat")}
        print(f"[sim] deferred-pipelined {best['deferred'].step_time * 1e3:.3f} "
              f"(exposed {best['deferred'].exposed_comm * 1e3:.3f}) vs "
              f"zero1-scheduled {best['zero1'].step_time * 1e3:.3f} "
              f"(exposed {best['zero1'].exposed_comm * 1e3:.3f}) vs "
              f"flat+monolithic {best['flat'].step_time * 1e3:.3f} ms/step")

    if args.ascii:
        print(f"[sim] timeline: {report['winner']}")
        print(ascii_timeline(timelines[report["winner"]]))

    if args.autotune:
        preds = grid_search(local, specs, mesh, mesh_shape=mesh_shape,
                            compute=compute, sim=sim, comm_dtype=comm_dtype)
        print("tuned: strategy,channels,bucket_mb,step_ms,overlap_pct")
        for p in preds[:10]:
            print(f"tuned: {p.strategy},{p.num_channels},"
                  f"{p.bucket_bytes / (1 << 20):.0f},{p.step_time * 1e3:.3f},"
                  f"{p.overlap_fraction * 100:.1f}")
        best_p = preds[0]
        print(f"[sim] best config: --strategy {best_p.strategy} "
              f"--channels {best_p.num_channels} "
              f"--bucket-mb {best_p.bucket_bytes / (1 << 20):.0f}")

    if args.trace:
        os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
        write_chrome_trace(args.trace, timelines)
        n_events = sum(len(t.events) for t in timelines.values())
        print(f"[sim] wrote {args.trace} ({n_events} op events, "
              f"open in chrome://tracing or Perfetto)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
