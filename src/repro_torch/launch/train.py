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
which the hierarchical reducers reduce in three stages.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.core import GradSyncConfig, get_strategy, reducer_names, strategy_names
from repro_torch.data import ImagePipeline, TokenPipeline
from repro_torch.launch.mesh import init_dist, make_dp_mesh
from repro_torch.models.registry import family_of
from repro_torch.optim import adamw, cosine_warmup, sgd
from repro_torch.parallel.sharding import dp_axes_of
from repro_torch.runtime import Trainer, make_train_step
from repro_torch.utils.trees import flatten_with_names


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
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    rank, _ = init_dist(args.device)
    try:
        mesh = make_dp_mesh(multi_pod=args.multi_pod)
        if args.smoke:
            cfg, batch, seq = arch.make_smoke(), args.batch or 8, args.seq or 64
        else:
            shape = arch.shapes[0]
            cfg = arch.make_config()
            batch, seq = args.batch or shape.global_batch, args.seq or shape.seq_len
        cfg = dataclasses.replace(
            cfg, dp_axes=dp_axes_of(mesh),
            depcha_in_scan=get_strategy(args.strategy).uses_in_scan)
        api = family_of(cfg)
        if api.module is None:
            raise NotImplementedError(
                f"{api.family} training: ROADMAP queue 1 item 12")
        model = api.module(cfg, api.init(cfg, seed=args.seed, device=args.device))
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
        sync = GradSyncConfig(strategy=args.strategy, reducer=args.reducer,
                              bucket_bytes=int(args.bucket_mb * 1024 * 1024),
                              num_channels=args.channels)
        ts = make_train_step(cfg, mesh, sync, opt, model=model,
                             clip_norm=args.clip_norm, device=args.device)
        params = dict(flatten_with_names(model.params_tree())[0])
        trainer = Trainer(ts, pipe, log_every=1,
                          printer=print if rank == 0 else (lambda _s: None))
        _, _, hist = trainer.run(model, opt.init(params), args.steps)
        ts.gradsync.close()
        if rank == 0:
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
