"""Serving launcher (``repro/launch/serve.py``): continuous batching (the
default) or the static batcher, on one rank.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --temperature 0.8 --top-k 16 --seed 7

Runs on CUDA unless ``--device cpu``.  Without ``--smoke`` the arch's
full config is served from random weights made from a seeded generator
on the device.  Greedy decoding (temperature 0) and the continuous
engine are the defaults; ``--engine static`` runs the ``RequestQueue``
batcher.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.core.dependency import resolve_device
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models.registry import family_of
from repro_torch.runtime import ContinuousScheduler, RequestQueue, SamplingParams, Server


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4,
                    help="static batcher width / continuous in-flight slots")
    ap.add_argument("--engine", choices=("continuous", "static"),
                    default="continuous")
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
    cfg = arch.make_smoke() if args.smoke else arch.make_config()
    api = family_of(cfg)
    if api.prefill is None:
        raise SystemExit(f"{args.arch} has no serve path")
    params = api.init(cfg, seed=0, device=device)
    server = Server(cfg, make_smoke_mesh(1, 1), params, max_len=args.max_len)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, min(cfg.vocab, 512),
                            size=rng.integers(4, 12), dtype=np.int32)
               for _ in range(args.requests)]

    t0 = time.perf_counter()
    if args.engine == "continuous":
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
    print(f"[serve] engine={args.engine} "
          f"{args.requests} requests in {dt:.2f}s "
          f"({args.requests * args.max_new / dt:.1f} tok/s)")


if __name__ == "__main__":
    main()
