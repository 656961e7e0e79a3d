"""The paper reproduction on the PyTorch port (``examples/paper_repro.py``
on ``repro_torch``): (1) the paper's python API (Figs 5, 8, 10) on the
port's KVStore; (2) ResNet-50/CIFAR training with each strategy (paper
§5.1 setting, the smoke config); (3) the paper-era Fig 13–16 tables of
``benchmarks/paper_figures.py`` (a P100 cost model, not a measurement)
with the paper's claims checked.

    python examples/paper_repro_torch.py                 # on the GPU
    python examples/paper_repro_torch.py --device cpu    # on the CPU

Runs over a process group of one; imports neither JAX nor ``repro``.
"""
import argparse
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from benchmarks.paper_figures import fig13, fig14, fig16, validate  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import GradSyncConfig, KVStore  # noqa: E402
from repro_torch.data import ImagePipeline  # noqa: E402
from repro_torch.launch.mesh import init_dist, make_dp_mesh  # noqa: E402
from repro_torch.models.registry import family_of  # noqa: E402
from repro_torch.optim import linear_scaling_rule, sgd  # noqa: E402
from repro_torch.runtime import Trainer, make_train_step  # noqa: E402
from repro_torch.utils.trees import flatten_with_names  # noqa: E402


def paper_api_demo(mesh, device):
    """Paper Fig 10 (DepCha python): push all keys, then pull + update."""
    grads = {k: torch.ones((8, 8), device=device) * (k + 1) for k in range(4)}
    kv = KVStore.create("depCha".lower(), reduce_axes=("data",),
                        num_channels=2, mesh_shape=mesh.shape, device=device)
    for key in range(4):                        # Fig 10 line 6-7
        kv.push(key, grads[key])
    outs = {}
    for key in range(4):                        # Fig 10 line 8-11
        outs[key] = kv.pull(key)
        # SGD.Update(params[key], outs[key], rescale=1/mb) happens in
        # repro_torch.runtime via the optimizer
    ok = all(torch.allclose(outs[k], grads[k]) for k in range(4))
    n_ops = len(kv.schedule().ops)              # the six analysis passes
    print(f"[paper-api] KVStore DepCha push/pull roundtrip: "
          f"{'OK' if ok else 'MISMATCH'} ({n_ops} ops, verified)")
    return ok


def cifar_strategies(mesh, device, steps=8):
    """Paper §5.1: ResNet-50 on CIFAR, one strategy per run (reduced)."""
    arch = get_arch("resnet50-cifar")
    cfg = arch.make_smoke()
    api = family_of(cfg)
    pipe = ImagePipeline(cfg.img_size, cfg.num_classes, 8, mesh=mesh,
                         device=device)
    # paper §5.2: linear LR scaling with worker count
    lr = linear_scaling_rule(0.1, 256, 256)
    opt = sgd(lr, momentum=0.9)
    losses = {}
    for strat in ("funnel", "concom", "depcha"):
        model = api.module(cfg, api.init(cfg, seed=0, device=device))
        ts = make_train_step(cfg, mesh, GradSyncConfig(strategy=strat, num_channels=4),
                             opt, model=model, device=device)
        params = dict(flatten_with_names(model.params_tree())[0])
        tr = Trainer(ts, pipe, log_every=1000, printer=lambda _m: None)
        _, _, hist = tr.run(model, opt.init(params), steps)
        ts.close()
        losses[strat] = hist["losses"]
        print(f"[cifar] {strat:7s} loss {hist['losses'][0]:.3f} -> "
              f"{hist['losses'][-1]:.3f} "
              f"(identical math, schedule differs)")
    return losses


def figures():
    print("\n[fig13] CIFAR ResNet-50 epoch seconds (funnel/concom/depcha)")
    for n, f, c, d in fig13():
        print(f"   {n:3d} GPUs: {f:7.1f} {c:7.1f} {d:7.1f}")
    print("[fig14] ImageNet Inception-BN epoch seconds")
    for n, f, c, d in fig14():
        print(f"   {n:3d} GPUs: {f:7.1f} {c:7.1f} {d:7.1f}")
    print("[fig16] ImageNet ResNet-50 DepCha scaling")
    for n, t in fig16():
        print(f"   {n:3d} GPUs: {t:7.1f}s/epoch")
    v = validate()
    print("[claims]",
          f"DepCha/Funnel(Inception) ≥1.6×: {v['claim_1.6x']} "
          f"(min {v['inception_depcha_speedup_min']:.2f});",
          f"CIFAR gap shrinks by 32 GPUs: {v['claim_gap_shrinks']};",
          f"~50s epoch @256: {v['claim_50s']} "
          f"({v['imagenet_epoch_256']:.0f}s)")
    return v


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    init_dist(args.device)
    try:
        mesh = make_dp_mesh()
        paper_api_demo(mesh, args.device)
        cifar_strategies(mesh, args.device)
        figures()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
