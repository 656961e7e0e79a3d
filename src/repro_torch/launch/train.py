"""Training launcher (``repro/launch/train.py``, data-parallel path).

    PYTHONPATH=src python -m repro_torch.launch.train --arch resnet50-cifar \\
        --strategy depcha --steps 5 [--device cpu] [--smoke]
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --seq 1024 --batch 4 --steps 3 --strategy depcha
    PYTHONPATH=src python -m repro_torch.launch.train --arch inception-bn-imagenet \\
        --steps 3 --strategy depcha

Runs on CUDA unless ``--device cpu``; one rank by default, or as many
as ``torchrun --nproc-per-node N`` starts (rank and world come from its
environment).  ``--smoke`` runs the arch's reduced config.  An image
arch (the ``resnet`` and ``inception`` families) trains with SGD over
``ImagePipeline``; a language model with AdamW
over ``TokenPipeline`` (with the arch's extra inputs), ``--seq`` tokens
a sequence.  ``--seq`` and ``--batch`` default to the reference's smoke
sizes with ``--smoke`` and to the arch's training shape without.  The
config gets the mesh's DP axes and ``depcha_in_scan`` exactly when the
strategy sums inside the backward (depcha), with ``--smoke`` too.
``--multi-pod`` lays the world out as two pods (``launch/mesh.py``),
which the hierarchical reducers reduce in three stages.  ``--model N``
gives the mesh a "model" axis of extent N (tensor parallelism; the rest
of the world is data-parallel) and the config ``tp=N``, as the reference
sets ``make_config(tp=mesh.shape["model"])``; each rank draws the
global weights from the seed and keeps its shards:

    RANK=r WORLD_SIZE=4 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \
        PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --smoke --device cpu --model 2 --strategy depcha --steps 2 --seq 32 --batch 4

``--strategy auto`` simulates every fixed strategy on the step's bucket
plan and runs the predicted winner (``repro_torch.sim``; rank 0 prints
the ranking).

``--zero1`` shards the optimizer state over the dp ranks (the optimizer
wrapped in ``optim.zero1``, the dp axes excluded from the sync):
``--zero1-plan scheduled`` (per-bucket RS→UPDATE→AG in GradSync's
StepProgram, clipped by its NORM op), ``deferred`` (the all-gathers at
the next step's top) or ``monolithic`` (one bucket after the sync).
``--microbatch M`` accumulates M microbatches a step into f32
accumulators, the adds running inside each backward.

``--pp-stages S`` trains over S pipeline stages (DESIGN.md §15): the
mesh gets a "stage" axis of extent S between "data" and "model" (the
world splits data × S × model), ``--microbatch`` is the pipeline's
microbatch count M, and ``--pp-schedule`` picks gpipe or 1f1b ("auto",
the default as in the reference, picks the one of least simulated
pipeline wall: ``repro_torch.sim.choose_pp_schedule``).  As the
reference's, it needs ``--smoke``:

    RANK=r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \
        PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --smoke --device cpu --pp-stages 2 --pp-schedule gpipe --microbatch 4 \
        --strategy concom --steps 2 --seq 32 --batch 4

``--events-jsonl PATH`` appends the ``Trainer``'s JSONL events (one
``step`` a step and the lifecycle events, ``repro_torch.obs``) and
``--metrics-json PATH`` writes the final metrics snapshot, both from
rank 0.

``--ckpt-dir DIR`` checkpoints the params and the optimizer state every
``--ckpt-every`` steps (``repro_torch.checkpoint.CheckpointManager``,
async, the reference's format); a second launch with the same directory
resumes from its latest step.  ZeRO-1 state under ``--model`` > 1 has no
plain checkpoint (the step refuses it at the first save: it moves through
``repro_torch.elastic``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --smoke \\
        --device cpu --strategy concom --zero1 --zero1-plan deferred \\
        --microbatch 4 --steps 3 --seq 32 --batch 8
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch.distributed as dist

import repro_torch.sim  # noqa: F401  (registers "auto" → --strategy auto)
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.core import GradSyncConfig, get_strategy, reducer_names, strategy_names
from repro_torch.data import ImagePipeline, TokenPipeline
from repro_torch.launch.mesh import init_dist, make_mesh
from repro_torch.models.registry import family_of
from repro_torch.optim import adamw, cosine_warmup, sgd, zero1
from repro_torch.parallel.sharding import dp_axes_of
from repro_torch.runtime import Trainer, make_train_step


IMAGE_FAMILIES = ("resnet", "inception")   # SGD over ImagePipeline


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--strategy", default="depcha", choices=strategy_names())
    ap.add_argument("--reducer", default="flat", choices=reducer_names())
    ap.add_argument("--channels", type=int, default=4)
    ap.add_argument("--bucket-mb", type=float, default=4.0)
    ap.add_argument("--clip-norm", type=float, default=1.0)
    ap.add_argument("--zero1", action="store_true",
                    help="shard the optimizer state over the dp ranks")
    ap.add_argument("--zero1-plan", default="scheduled",
                    choices=["scheduled", "deferred", "monolithic"],
                    help="scheduled = StepProgram (per-bucket RS→UPDATE→AG "
                         "planned by the strategy, clipped by the NORM op); "
                         "deferred = its all-gathers at the next step's top, "
                         "the update shards carried in opt_state; monolithic "
                         "= one bucket after the sync, no clipping")
    ap.add_argument("--microbatch", type=int, default=1,
                    help="gradient-accumulation microbatches a step")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default: 8 with --smoke, else the arch's shape)")
    ap.add_argument("--seq", type=int, default=None,
                    help="LM sequence length (default: 64 with --smoke, else the "
                         "arch's shape)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--multi-pod", action="store_true",
                    help="two pods over the world: a (pod, data, model) mesh")
    ap.add_argument("--model", type=int, default=1,
                    help="extent of the mesh's model axis (tensor parallelism)")
    ap.add_argument("--pp-stages", type=int, default=1,
                    help="pipeline stages over a 'stage' mesh axis (smoke config "
                         "only; --microbatch doubles as the pipeline microbatch "
                         "count M)")
    ap.add_argument("--pp-schedule", default="auto", choices=["auto", "gpipe", "1f1b"],
                    help="pipeline schedule; auto = argmin of the analytic "
                         "pipeline wall (repro_torch.sim.choose_pp_schedule)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--events-jsonl", default="",
                    help="append per-step JSONL telemetry (repro_torch.obs EventLog) "
                         "to this path")
    ap.add_argument("--metrics-json", default="",
                    help="write the final metrics snapshot here")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    if args.pp_stages > 1 and not args.smoke:
        raise SystemExit("--pp-stages needs the smoke mesh (--smoke); the production "
                         "mesh has no 'stage' axis")
    rank, _ = init_dist(args.device)
    try:
        mesh = make_mesh(args.model, multi_pod=args.multi_pod,
                         stage=args.pp_stages if args.pp_stages > 1 else 0)
        if args.smoke:
            cfg, batch, seq = arch.make_smoke(), args.batch or 8, args.seq or 64
        else:
            shape = arch.shapes[0]
            cfg = arch.make_config()
            batch, seq = args.batch or shape.global_batch, args.seq or shape.seq_len
        over = dict(dp_axes=dp_axes_of(mesh),
                    depcha_in_scan=get_strategy(args.strategy).uses_in_scan)
        if mesh.shape["model"] > 1:
            if not hasattr(cfg, "tp"):
                raise ValueError(f"{args.arch} has no model axis to shard over "
                                 f"(--model {args.model})")
            over["tp"] = mesh.shape["model"]
        cfg = dataclasses.replace(cfg, **over)
        api = family_of(cfg)
        # each rank keeps its shards: of "model" (tp > 1), of the dp axes
        # (FSDP), its stage's layers (pipeline stages)
        sharded = (mesh.shape["model"] > 1 or getattr(cfg, "fsdp", False)
                   or args.pp_stages > 1)
        init_kw = dict(mesh=mesh, rank=rank) if sharded else {}
        model = api.module(cfg, api.init(cfg, seed=args.seed, device=args.device,
                                         **init_kw))
        if arch.family in IMAGE_FAMILIES:
            pipe = ImagePipeline(cfg.img_size, cfg.num_classes, batch,
                                 seed=args.seed, mesh=mesh, rank=rank,
                                 device=args.device)
            opt = sgd(cosine_warmup(args.lr, 10, args.steps), momentum=0.9)
        else:
            extras = {name: (tuple(shape_fn(cfg, seq)), np.float32)
                      for name, shape_fn, _ in arch.extra_inputs}
            pipe = TokenPipeline(cfg.vocab, seq, batch, seed=args.seed, mesh=mesh,
                                 rank=rank, extra_specs=extras, device=args.device)
            opt = adamw(cosine_warmup(args.lr, 10, args.steps))
        dp = dp_axes_of(mesh)
        if args.zero1:
            opt = zero1(opt, dp, int(np.prod([mesh.shape[a] for a in dp])))
        sync = GradSyncConfig(strategy=args.strategy, reducer=args.reducer,
                              bucket_bytes=int(args.bucket_mb * 1024 * 1024),
                              num_channels=args.channels,
                              exclude_axes=dp if args.zero1 else ())
        pp = dict(pp_stages=args.pp_stages,
                  pp_schedule=args.pp_schedule) if args.pp_stages > 1 else {}
        ts = make_train_step(cfg, mesh, sync, opt, model=model,
                             clip_norm=args.clip_norm, zero1_mode=args.zero1,
                             zero1_plan=args.zero1_plan, microbatch=args.microbatch,
                             batch_like=pipe.batch_at(0), device=args.device, **pp)
        if rank == 0 and get_strategy(args.strategy).meta:
            report = repro_torch.sim.last_auto_report()
            print(f"[train] {args.strategy} -> {report['winner']} "
                  f"(network model: {report['net']}; ranking "
                  + ", ".join(f"{n} {t * 1e3:.6g} ms" for n, t in report["ranking"])
                  + ")")
        ckpt = (CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
                if args.ckpt_dir else None)
        trainer = Trainer(ts, pipe, ckpt, log_every=1,
                          printer=print if rank == 0 else (lambda _s: None),
                          events_path=(args.events_jsonl or None) if rank == 0 else None)
        model, opt_state, hist = trainer.run(model, ts.init_opt(), args.steps)
        if ts.finalize is not None:
            ts.finalize(model, opt_state)     # the last step's deferred updates
        ts.close()
        if rank == 0 and args.metrics_json:
            with open(args.metrics_json, "w") as f:
                json.dump(hist.get("metrics", {}), f, indent=1, sort_keys=True)
            print(f"[train] metrics snapshot -> {args.metrics_json}")
        if rank == 0 and hist["losses"]:
            times = hist["step_times"]
            avg = sum(times) / len(times) * 1e3 if times else float("nan")
            print(f"[train] {args.arch} {args.strategy}: loss "
                  f"{hist['losses'][0]:.4f} -> {hist['losses'][-1]:.4f}; "
                  f"first step {hist['compile_time'] * 1e3:.1f} ms, "
                  f"then {avg:.1f} ms/step")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
