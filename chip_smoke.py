#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

  build       compile the staging kernels from ``csrc/`` for sm_90a.
  kernels     ``fused_pack``/``fused_unpack`` against their plain versions
              on the 24 full-width ResNet-50 buckets (comm dtype f32, bf16,
              f16; scale 1 and 64), one mixed-dtype bucket and one bucket of
              more leaves than one launch takes: bit-exact.  Then each
              kernel is timed over a whole step's buckets with CUDA events,
              beside its plain version and one PyTorch call doing the same.
  train       full-width ResNet-50/CIFAR, global batch 256 at 32x32, SGD
              with momentum 0.9, clip 1.0, on a one-rank NCCL group:
              funnel, concom and depcha from the same seeded weights, 1
              warm-up + 3 timed steps each.  Losses finite and equal across
              strategies (rtol 1e-5, TF32 off, deterministic cuDNN); the
              kernels' launch counters advance by exactly 24 x steps.
  profile     one more step of the last strategy under torch.profiler: device
              time per step stage and the kernels that take the most.
  cpu_vs_gpu  the smoke config for 3 steps on the CPU (plain versions) and
              on the GPU (kernels) from the same weights and batches:
              params agree to rtol 1e-3 / atol 1e-5.

Then it prints the ``{"kernels": [...]}`` line, the card's name and power
limit as nvidia-smi reports them, and last
``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""
from __future__ import annotations

import faulthandler
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
STRATEGIES = ("funnel", "concom", "depcha")
TRAIN_STEPS = 4                # 1 warm-up + 3 timed
HANG_LIMIT_S = 1000             # dump stacks and exit before the 1200 s limit


def log(msg: str) -> None:
    print(msg, flush=True)


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def same_bits(a: torch.Tensor, b: torch.Tensor, what: str) -> float:
    """Raise unless a and b agree bit for bit; return max |a - b|."""
    if a.dtype != b.dtype or a.shape != b.shape:
        raise AssertionError(f"{what}: {a.dtype}{tuple(a.shape)} vs "
                             f"{b.dtype}{tuple(b.shape)}")
    err = (a.double() - b.double()).abs().max().item() if a.numel() else 0.0
    if not torch.equal(bits(a), bits(b)):
        raise AssertionError(f"{what}: not bit-exact (max abs err {err})")
    return err


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time per call of ``fn`` (CUDA events around ``reps`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build() -> None:
    from repro_torch.kernels.collectives import kernel

    t0 = time.perf_counter()
    lib = kernel.build()
    log(f"[build] {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")


def resnet50_plan():
    from repro_torch.configs.resnet50_cifar import make_config
    from repro_torch.core import make_bucket_plan
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.resnet import init_params, param_specs
    from repro_torch.utils.trees import flatten_with_names

    params = init_params(make_config(), device="meta")
    plan = make_bucket_plan(params, param_specs(params), make_smoke_mesh(1),
                            bucket_bytes=4 * 1024 * 1024, num_channels=4)
    return plan, flatten_with_names(params)[0]


def plain_unpack(bucket, buf, flat_out, scale=1.0) -> None:
    """What ``fused_unpack`` does with the plain version (its CPU path)."""
    from repro_torch.kernels.collectives import ref

    pieces = ref.leafwise_unpack(buf, [l.size for l in bucket.leaves],
                                 [l.dtype for l in bucket.leaves], scale=scale)
    for l, piece in zip(bucket.leaves, pieces):
        flat_out[l.index].view(-1).copy_(piece)


def check_bucket(bucket, flat, comm, scale) -> float:
    from repro_torch.kernels.collectives import ops, ref

    leaves = [flat[l.index] for l in bucket.leaves]
    got = ops.fused_pack(bucket, flat, comm, scale=scale)
    want = ref.leafwise_pack(leaves, comm, scale=scale)
    err = same_bits(got, want, f"pack b{bucket.bucket_id} {comm} x{scale}")
    out_k = list(flat)
    out_p = list(flat)
    for l in bucket.leaves:
        out_k[l.index] = torch.empty(l.shape, dtype=l.dtype, device="cuda")
        out_p[l.index] = torch.empty(l.shape, dtype=l.dtype, device="cuda")
    ops.fused_unpack(bucket, want, out_k, scale=1.0 / scale)
    plain_unpack(bucket, want, out_p, scale=1.0 / scale)
    for l in bucket.leaves:
        err = max(err, same_bits(out_k[l.index], out_p[l.index],
                                 f"unpack b{bucket.bucket_id} {l.name} {comm}"))
    return err


def phase_kernels() -> dict:
    from repro_torch.core.buckets import Bucket, LeafInfo
    from repro_torch.kernels.collectives import kernel, ops, ref

    plan, named = resnet50_plan()
    if len(plan.buckets) != 24:
        raise AssertionError(f"expected 24 ResNet-50 buckets, got {len(plan.buckets)}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flat = [torch.randn(p.shape, generator=gen, device="cuda") for _, p in named]

    err = 0.0
    n_checks = 0
    for comm in (torch.float32, torch.bfloat16, torch.float16):
        for scale in (1.0, 64.0):
            for b in plan.buckets:
                err = max(err, check_bucket(b, flat, comm, scale))
                n_checks += 1

    # one mixed-dtype bucket and one of more leaves than a launch takes
    dts = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
    sizes = torch.randint(1, 5000, (220,), generator=torch.Generator().manual_seed(1))
    extra = [torch.randn(int(n), generator=gen, device="cuda").to(dts[i % 4])
             for i, n in enumerate(sizes[:70])]
    extra += [torch.randn(int(n), generator=gen, device="cuda") for n in sizes[70:]]
    infos = [LeafInfo(f"x{i}", len(flat) + i, tuple(t.shape), t.dtype, t.numel())
             for i, t in enumerate(extra)]
    mixed = Bucket(tuple(infos[:70]), ("data", "model"), 0, 100)
    many = Bucket(tuple(infos[70:]), ("data", "model"), 0, 101)
    flat_x = flat + extra
    for comm in (torch.float32, torch.bfloat16, torch.float16, torch.float64):
        for scale in (1.0, 64.0):
            before = kernel.PACK_LAUNCHES
            err = max(err, check_bucket(mixed, flat_x, comm, scale))
            if kernel.PACK_LAUNCHES - before != 4:   # one launch per dtype
                raise AssertionError("mixed bucket: expected 4 pack launches")
            before = kernel.PACK_LAUNCHES
            err = max(err, check_bucket(many, flat_x, comm, scale))
            if kernel.PACK_LAUNCHES - before != 3:   # 150 leaves / 64
                raise AssertionError("150-leaf bucket: expected 3 pack launches")
            n_checks += 2
    torch.cuda.synchronize()
    log(f"[kernels] {n_checks} bucket checks bit-exact "
        f"(max abs err {err}); 24 buckets, "
        f"{sum(len(b.leaves) for b in plan.buckets)} leaves, "
        f"{sum(b.size for b in plan.buckets)} elements")

    # timing over a whole step's buckets: f32 wire, scale 1 (the main path)
    f32 = torch.float32
    bufs = [ops.fused_pack(b, flat, f32) for b in plan.buckets]
    outs = [torch.empty_like(t) for t in flat]
    step_bytes = 2 * sum(b.size for b in plan.buckets) * f32.itemsize
    bound = step_bytes / HBM_BYTES_PER_S * 1e3
    sizes_of = [[l.size for l in b.leaves] for b in plan.buckets]

    def lib_unpack():
        for b, buf, sz in zip(plan.buckets, bufs, sizes_of):
            torch._foreach_copy_([outs[l.index].view(-1) for l in b.leaves],
                                 list(torch.split(buf, sz)))

    rows = {
        "pack": dict(
            ms=cuda_ms(lambda: [ops.fused_pack(b, flat, f32) for b in plan.buckets]),
            plain_ms=cuda_ms(lambda: [ref.leafwise_pack(
                [flat[l.index] for l in b.leaves], f32) for b in plan.buckets]),
            library_ms=cuda_ms(lambda: [torch.cat(
                [flat[l.index].reshape(-1).to(f32) for l in b.leaves])
                for b in plan.buckets])),
        "unpack": dict(
            ms=cuda_ms(lambda: [ops.fused_unpack(b, buf, outs)
                                for b, buf in zip(plan.buckets, bufs)]),
            plain_ms=cuda_ms(lambda: [plain_unpack(b, buf, outs)
                                      for b, buf in zip(plan.buckets, bufs)]),
            library_ms=(cuda_ms(lib_unpack)
                        if hasattr(torch, "_foreach_copy_") else None)),
    }
    for name, r in rows.items():
        r.update(bound_ms=bound, bound_by="bytes", max_abs_err=err,
                 step_bytes=step_bytes)
        log(f"[kernels] {name}: {r['ms']:.4f} ms/step (24 launches), plain "
            f"{r['plain_ms']:.4f}, library {r['library_ms']}, bound {bound:.4f}")
    return rows


def phase_train() -> dict:
    from repro_torch.configs.resnet50_cifar import make_config
    from repro_torch.core import GradSyncConfig
    from repro_torch.data import ImagePipeline
    from repro_torch.kernels.collectives import kernel
    from repro_torch.launch.mesh import make_dp_mesh
    from repro_torch.models.resnet import ResNet, init_params
    from repro_torch.optim import linear_scaling_rule, sgd
    from repro_torch.runtime import Trainer, make_train_step
    from repro_torch.utils.trees import flatten_with_names

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("[train] " + json.dumps({
        "cudnn.deterministic": torch.backends.cudnn.deterministic,
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}))
    cfg = make_config()
    mesh = make_dp_mesh()
    pipe = ImagePipeline(cfg.img_size, cfg.num_classes, 256, seed=0,
                         mesh=mesh, device="cuda")
    lr = linear_scaling_rule(0.1, 256, 256)
    steps: list = []
    kernel.PACK_LAUNCHES = 0
    kernel.UNPACK_LAUNCHES = 0
    hists = {}
    live = None
    for strat in STRATEGIES:
        model = ResNet(cfg, init_params(cfg, seed=0, device="cuda"))
        opt = sgd(lr, momentum=0.9)
        ts = make_train_step(cfg, mesh, GradSyncConfig(strategy=strat),
                             opt, model=model, clip_norm=1.0, device="cuda")
        steps.append(len(ts.gradsync.plan.buckets) * TRAIN_STEPS)
        params = dict(flatten_with_names(model.params_tree())[0])
        model, opt_state, hist = Trainer(ts, pipe, log_every=10 ** 9).run(
            model, opt.init(params), TRAIN_STEPS)
        hists[strat] = hist
        live = (ts, model, opt_state, pipe)
        st = ts.gradsync.schedule.stats()
        log(f"[train] {strat}: {st['num_ops']} ops on {st['num_chains']} "
            f"chains (longest {st['max_chain_len']}); losses {hist['losses']}; "
            f"first step {hist['first_step_time'] * 1e3:.1f} ms, timed steps "
            f"{[round(t * 1e3, 2) for t in hist['step_times']]} ms")
    launches = {"pack": kernel.PACK_LAUNCHES, "unpack": kernel.UNPACK_LAUNCHES}
    if launches != {"pack": sum(steps), "unpack": sum(steps)} or sum(steps) != 24 * 12:
        raise AssertionError(f"launch counters {launches}, expected "
                             f"{sum(steps)} = 24 buckets x {TRAIN_STEPS} steps "
                             f"x {len(STRATEGIES)} strategies")
    ref_losses = hists[STRATEGIES[0]]["losses"]
    for strat, hist in hists.items():
        if not all(math.isfinite(x) for x in hist["losses"]):
            raise AssertionError(f"{strat}: non-finite loss {hist['losses']}")
        for a, b in zip(hist["losses"], ref_losses):
            if abs(a - b) > 1e-5 * abs(b):
                raise AssertionError(
                    f"{strat} losses {hist['losses']} differ from "
                    f"{STRATEGIES[0]} {ref_losses} beyond rtol 1e-5")
    log(f"[train] launch counters {launches} = 24 x {TRAIN_STEPS} steps x "
        f"{len(STRATEGIES)} strategies; losses agree across strategies")
    return {"launches": launches, "hists": hists, "live": live}


def _device_ms(e, self_only: bool = False) -> float:
    name = "self_device_time_total" if self_only else "device_time_total"
    old = "self_cuda_time_total" if self_only else "cuda_time_total"
    return (getattr(e, name, None) or getattr(e, old, 0) or 0) / 1e3


def phase_profile(ts, model, opt_state, pipe) -> None:
    """One more step of the last strategy under ``torch.profiler``: device
    time under each step stage, the summed kernel time against the step's
    wall time, and the kernels that take the most.  Runs after the main
    path's launch counts were read."""
    from torch.profiler import ProfilerActivity, profile

    batch = pipe.batch_at(TRAIN_STEPS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ts.fn(model, opt_state, batch, TRAIN_STEPS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    stages = {e.key: {"device_ms": round(_device_ms(e), 3),
                      "host_ms": round(e.cpu_time_total / 1e3, 3)}
              for e in events if e.key.startswith("step.")}
    kernel_ms = sum(_device_ms(e, self_only=True) for e in events)
    top = sorted(events, key=lambda e: _device_ms(e, self_only=True),
                 reverse=True)[:12]
    log("[profile] " + json.dumps({
        "strategy": STRATEGIES[-1], "wall_ms_under_profiler": round(wall_ms, 3),
        "kernel_ms_summed": round(kernel_ms, 3),
        "by_stage": stages,
        "top_kernels": [{"name": e.key[:90], "calls": e.count,
                         "ms": round(_device_ms(e, self_only=True), 3)}
                        for e in top],
        "staging_kernels": [{"name": e.key[:90], "calls": e.count,
                             "ms": round(_device_ms(e, self_only=True), 3)}
                            for e in events if "_bucket_kernel<" in e.key]}))


def phase_cpu_vs_gpu() -> None:
    from repro_torch.configs.resnet50_cifar import make_smoke
    from repro_torch.core import GradSyncConfig
    from repro_torch.data import ImagePipeline
    from repro_torch.launch.mesh import make_dp_mesh
    from repro_torch.models.resnet import ResNet, init_params
    from repro_torch.optim import linear_scaling_rule, sgd
    from repro_torch.runtime import Trainer, make_train_step
    from repro_torch.utils.trees import flatten_with_names

    cfg = make_smoke()
    mesh = make_dp_mesh()
    final = {}
    for device in ("cpu", "cuda"):
        model = ResNet(cfg, init_params(cfg, seed=0, device=device))
        opt = sgd(linear_scaling_rule(0.1, 256, 256), momentum=0.9)
        ts = make_train_step(cfg, mesh, GradSyncConfig(strategy="depcha"), opt,
                             model=model, clip_norm=1.0, device=device)
        pipe = ImagePipeline(cfg.img_size, cfg.num_classes, 8, seed=0,
                             mesh=mesh, device=device)
        params = dict(flatten_with_names(model.params_tree())[0])
        _, _, hist = Trainer(ts, pipe, log_every=10 ** 9).run(
            model, opt.init(params), 3)
        final[device] = ({n: p.detach().cpu() for n, p in params.items()},
                         hist["losses"])
    worst = 0.0
    for n, p_cpu in final["cpu"][0].items():
        p_gpu = final["cuda"][0][n]
        worst = max(worst, (p_gpu - p_cpu).abs().max().item())
        if not torch.allclose(p_gpu, p_cpu, rtol=1e-3, atol=1e-5):
            raise AssertionError(f"cpu_vs_gpu: {n} differs by "
                                 f"{(p_gpu - p_cpu).abs().max().item()}")
    log(f"[cpu_vs_gpu] {len(final['cpu'][0])} params agree after 3 steps "
        f"(max abs diff {worst}); losses cpu {final['cpu'][1]} "
        f"gpu {final['cuda'][1]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a GPU", file=sys.stderr)
        return 1
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_dist

    faulthandler.dump_traceback_later(HANG_LIMIT_S, exit=True)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    phase_build()
    init_dist("cuda")
    try:
        rows = phase_kernels()
        train = phase_train()
        phase_profile(*train["live"])
        phase_cpu_vs_gpu()
    finally:
        dist.destroy_process_group()

    src = "src/repro_torch/kernels/collectives/csrc/staging.cu"
    replaces = {"pack": "src/repro/kernels/collectives/kernel.py:76",
                "unpack": "src/repro/kernels/collectives/kernel.py:99"}
    kernels = []
    for name, r in rows.items():
        kernels.append({
            "name": f"{name}_bucket_kernel", "route": "cuda", "source": src,
            "replaces": replaces[name], "launches": train["launches"][name],
            "launches_per_step": 24, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "step_bytes": r["step_bytes"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
