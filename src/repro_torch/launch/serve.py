"""Serving launcher (``repro/launch/serve.py``): continuous batching (the
default) or the static batcher, on one rank or on a ("data", "model")
mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --temperature 0.8 --top-k 16 --seed 7

Runs on CUDA unless ``--device cpu``; one rank by default, or as many as
``torchrun --nproc-per-node N`` starts (rank and world come from its
environment: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``;
``launch/mesh.py::init_dist``).  ``--model N`` gives the mesh a "model"
axis of extent N (heads and vocab sharded over it; the config's tp) and
the rest of the world serves slots and batch rows over "data", or over
two pods with ``--multi-pod``; every rank draws the global weights from
the seed and keeps its shards.  Every rank prints the tokens it holds
(each holds every request's, and they must agree); rank 0 prints the
rest.  On the CPU, two ranks at model 2 (one process per r):

    RANK=r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=p PYTHONPATH=src \\
        python -m repro_torch.launch.serve --arch qwen3-1.7b --smoke --device cpu --model 2

Without ``--smoke`` the arch's full config is served from random weights
made from a seeded generator on the device.  Greedy decoding
(temperature 0) and the continuous engine are the defaults; ``--engine
static`` runs the ``RequestQueue`` batcher, and so does a family without
a paged decode hook (rwkv, ssm):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
        --engine static --max-len 1024
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.core.dependency import resolve_device
from repro_torch.launch.mesh import init_dist, make_mesh
from repro_torch.models.registry import family_of
from repro_torch.parallel.sharding import dp_axes_of
from repro_torch.runtime import ContinuousScheduler, RequestQueue, SamplingParams, Server


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="two pods over the world: a (pod, data, model) mesh")
    ap.add_argument("--model", type=int, default=1,
                    help="extent of the mesh's model axis (tensor parallelism)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4,
                    help="static batcher width / continuous in-flight slots")
    ap.add_argument("--engine", choices=("continuous", "static"),
                    default="continuous",
                    help="continuous falls back to static for families "
                         "without a paged decode hook")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged KV-cache block size (must divide max-len)")
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=8,
                    help="decode steps per host sync")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy (the default)")
    ap.add_argument("--top-k", type=int, default=0, help="0 = no cap")
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="per-request sampling seed base")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    rank, _ = init_dist(device)
    try:
        mesh = make_mesh(args.model, multi_pod=args.multi_pod)
        cfg = arch.make_smoke() if args.smoke else arch.make_config()
        cfg = dataclasses.replace(cfg, tp=mesh.shape["model"], dp_axes=dp_axes_of(mesh))
        api = family_of(cfg)
        if api.prefill is None:
            raise SystemExit(f"{args.arch} has no serve path")
        sharded = cfg.tp > 1 or getattr(cfg, "fsdp", False)
        params = api.init(cfg, seed=0, device=device,
                          **(dict(mesh=mesh, rank=rank) if sharded else {}))
        server = Server(cfg, mesh, params, max_len=args.max_len)
        say = print if rank == 0 else (lambda *_a: None)

        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, min(cfg.vocab, 512),
                                size=rng.integers(4, 12), dtype=np.int32)
                   for _ in range(args.requests)]

        use_continuous = (args.engine == "continuous"
                          and api.decode_paged is not None)
        if args.engine == "continuous" and not use_continuous:
            say(f"[serve] {cfg.name}'s family has no paged decode hook; "
                f"falling back to the static batcher")

        t0 = time.perf_counter()
        if use_continuous:
            eng = ContinuousScheduler(
                server, slots=args.batch, block_size=args.block_size,
                chunk=args.chunk)
            handles = [eng.submit(p, args.max_new, SamplingParams(
                temperature=args.temperature, top_k=args.top_k,
                top_p=args.top_p, seed=args.seed + i))
                for i, p in enumerate(prompts)]
            eng.run_until_idle()
        else:
            queue = RequestQueue(server, batch=args.batch)
            handles = [queue.submit(p, args.max_new) for p in prompts]
            done = 0
            while done < args.requests:
                done += queue.serve_once()
        dt = time.perf_counter() - t0
        for i, h in enumerate(handles):
            out = h.get(timeout=30)
            if isinstance(out, Exception):
                raise out
            print(f"req {i}: {out.tolist()}")
        say(f"[serve] engine={'continuous' if use_continuous else 'static'} "
            f"{args.requests} requests in {dt:.2f}s "
            f"({args.requests * args.max_new / dt:.1f} tok/s)")
        server.close()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
