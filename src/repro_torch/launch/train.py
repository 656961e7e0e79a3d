"""Training launcher (``repro/launch/train.py``, data-parallel path).

    PYTHONPATH=src python -m repro_torch.launch.train --arch resnet50-cifar \\
        --strategy depcha --steps 5 [--device cpu] [--smoke]

Runs on CUDA unless ``--device cpu``; one rank by default, or as many
as ``torchrun --nproc-per-node N`` starts (rank and world come from its
environment).  ``--smoke`` runs the arch's reduced config.
"""
from __future__ import annotations

import argparse

import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.core import GradSyncConfig, reducer_names, strategy_names
from repro_torch.data import ImagePipeline
from repro_torch.launch.mesh import init_dist, make_dp_mesh
from repro_torch.models.registry import family_of
from repro_torch.optim import cosine_warmup, sgd
from repro_torch.runtime import Trainer, make_train_step
from repro_torch.utils.trees import flatten_with_names


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--strategy", default="depcha", choices=strategy_names())
    ap.add_argument("--reducer", default="flat", choices=reducer_names())
    ap.add_argument("--channels", type=int, default=4)
    ap.add_argument("--bucket-mb", type=float, default=4.0)
    ap.add_argument("--clip-norm", type=float, default=1.0)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, global batch --batch")
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch with --smoke (else the arch's shape)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    rank, _ = init_dist(args.device)
    try:
        mesh = make_dp_mesh()
        if args.smoke:
            cfg, batch = arch.make_smoke(), args.batch
        else:
            cfg, batch = arch.make_config(), arch.shapes[0].global_batch
        api = family_of(cfg)
        if api.module is None:
            raise NotImplementedError(
                f"{api.family} training: ROADMAP queue 1 item 5")
        model = api.module(cfg, api.init(cfg, seed=args.seed, device=args.device))
        pipe = ImagePipeline(cfg.img_size, cfg.num_classes, batch,
                             seed=args.seed, mesh=mesh, rank=rank,
                             device=args.device)
        opt = sgd(cosine_warmup(args.lr, 10, args.steps), momentum=0.9)
        sync = GradSyncConfig(strategy=args.strategy, reducer=args.reducer,
                              bucket_bytes=int(args.bucket_mb * 1024 * 1024),
                              num_channels=args.channels)
        ts = make_train_step(cfg, mesh, sync, opt, model=model,
                             clip_norm=args.clip_norm, device=args.device)
        params = dict(flatten_with_names(model.params_tree())[0])
        trainer = Trainer(ts, pipe, log_every=1,
                          printer=print if rank == 0 else (lambda _s: None))
        _, _, hist = trainer.run(model, opt.init(params), args.steps)
        if rank == 0:
            times = hist["step_times"]
            avg = sum(times) / len(times) * 1e3 if times else float("nan")
            print(f"[train] {args.arch} {args.strategy}: loss "
                  f"{hist['losses'][0]:.4f} -> {hist['losses'][-1]:.4f}; "
                  f"first step {hist['first_step_time'] * 1e3:.1f} ms, "
                  f"then {avg:.1f} ms/step")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
