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
  flash       the flash-attention kernel against its plain version on the
              five tests/test_kernels.py shapes, Qwen3-1.7B's static
              prefill shape (B 4, S 512, 16/8 heads, D 128, bf16) and a
              ragged S = 200: tolerance 2e-5 in f32, 2e-2 in bf16.  Then
              kernel, plain and F.scaled_dot_product_attention times with
              CUDA events at the static and the continuous prefill shape.
  serve       Qwen3-1.7B at full width, bf16, use_flash, random weights
              from a seeded generator on the card: 8 prompts of 384-512
              tokens, max_len 1024, 32 new tokens each, through the static
              engine (RequestQueue, batch 4: 2 prefills) and the
              continuous engine (8 slots, blocks of 128, chunks of 8: 8
              prefills).  The flash launch count must be 28 x prefills;
              every request gets 32 tokens; the kernel matches its plain
              version on the q/k/v prefill fed to layers 0 and 27; the
              last-position logits of one static prefill agree in f32
              between use_flash and the chunked path.  Then, in f32 at
              full width, two unpadded prompts at batch 1 through both
              engines: equal tokens, and logits that agree step by step
              with each other and with a prefill of the same tokens.  A
              report-only bf16 witness: each prompt served alone by the
              static engine against the continuous engine's tokens.
              Then one prefill and three decode steps timed without and
              then under torch.profiler (device idle share = 1 - kernel
              time / unprofiled wall time).
  serve_cpu_vs_gpu  the qwen3 smoke config, the same weights, greedy,
              through both engines on the CPU (plain versions) and on the
              GPU (kernel): tokens equal, prefill logits close in f32.

The build compiles every kernel source at once (one nvcc each, in
parallel).  Then it prints the ``{"kernels": [...]}`` line, the card's
name and power limit as nvidia-smi reports them, and last
``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
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
PEAK_FLOPS = {torch.bfloat16: 989e12,   # dense tensor cores (data sheet)
              torch.float32: 67e12}     # f32 outside the tensor cores
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
    """Compile every kernel source at once: one nvcc each, in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.collectives import kernel as staging
    from repro_torch.kernels.flash_attention import kernel as flash

    def timed(build):
        t0 = time.perf_counter()
        return build(), time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = [pool.submit(timed, k.build) for k in (staging, flash)]
        built = [f.result() for f in futures]
    for lib, dt in built:
        log(f"[build] {lib.relative_to(ROOT)} in {dt:.1f} s")
    log(f"[build] all kernels in {time.perf_counter() - t0:.1f} s")


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


# ------------------------------------------------------------------ serving
FLASH_SHAPES = (   # (B, S, Hq, Hkv, D, dtype, causal)
    (2, 128, 4, 2, 64, torch.float32, True),       # tests/test_kernels.py
    (1, 256, 2, 2, 128, torch.float32, False),
    (2, 128, 4, 1, 64, torch.bfloat16, True),
    (1, 512, 8, 4, 64, torch.float32, True),
    (2, 128, 2, 2, 256, torch.bfloat16, False),
    (4, 512, 16, 8, 128, torch.bfloat16, True),    # Qwen3-1.7B static prefill
    (1, 200, 16, 8, 128, torch.bfloat16, True),    # ragged last tile
)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # test_kernels.py:34
PREFILL_SHAPES = {"static": (4, 512, 16, 8, 128),        # B, S, Hq, Hkv, D
                  "continuous": (1, 512, 16, 8, 128)}
SERVE_REQUESTS = 8
SERVE_MAX_LEN = 1024
SERVE_MAX_NEW = 32


def flash_bound(B, S, Hq, Hkv, D, dtype, causal=True):
    """Least time for the work on this card: q, k, v read and o written
    once against the memory rate; the score and P.V products of the
    visible (q, k) pairs against the peak rate of the inputs' type."""
    esz = torch.empty((), dtype=dtype).element_size()
    nbytes = 2 * B * S * Hq * D * esz + 2 * B * S * Hkv * D * esz
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * B * Hq * D * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def flash_inputs(B, S, Hq, Hkv, D, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(B, S, h, D, generator=gen, device="cuda").to(dtype)
            for h in (Hq, Hkv, Hkv)]


def check_flash(q, k, v, causal: bool, what: str) -> float:
    """Kernel against its plain version on the same inputs; returns the
    max abs error, raises beyond the dtype's tolerance."""
    from repro_torch.kernels.flash_attention import kernel, ref

    got = kernel.flash_attention_fwd(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    tol = FLASH_TOL[q.dtype]
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        raise AssertionError(f"{what}: kernel vs plain max abs err {err} "
                             f"beyond atol=rtol={tol}")
    return err


def phase_flash() -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref

    errs = {}
    for i, (B, S, Hq, Hkv, D, dt, causal) in enumerate(FLASH_SHAPES):
        q, k, v = flash_inputs(B, S, Hq, Hkv, D, dt, seed=i)
        what = f"B{B} S{S} Hq{Hq} Hkv{Hkv} D{D} {dt} causal={causal}"
        errs[(B, S, Hq, Hkv, D, dt)] = check_flash(q, k, v, causal, what)
        log(f"[flash] {what}: max abs err {errs[(B, S, Hq, Hkv, D, dt)]} "
            f"(tol {FLASH_TOL[dt]})")
    rows = {}
    for name, (B, S, Hq, Hkv, D) in PREFILL_SHAPES.items():
        q, k, v = flash_inputs(B, S, Hq, Hkv, D, torch.bfloat16, seed=100)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        bound, by, nbytes, flops = flash_bound(B, S, Hq, Hkv, D, torch.bfloat16)
        rows[name] = dict(
            shape=f"B{B} S{S} Hq{Hq} Hkv{Hkv} D{D} bf16 causal",
            ms=cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True)),
            plain_ms=cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True)),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, enable_gqa=True)),
            bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
        log(f"[flash] {name} prefill shape: " + json.dumps(rows[name]))
    rows["static"]["max_abs_err"] = errs[(4, 512, 16, 8, 128, torch.bfloat16)]
    return rows


def serve_prompts(vocab: int) -> list:
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, size=int(n)).astype(np.int32)
            for n in rng.integers(384, 513, size=SERVE_REQUESTS)]


def left_pad(prompts) -> torch.Tensor:
    """The batch ``RequestQueue`` builds from ``prompts``."""
    S = max(len(p) for p in prompts)
    toks = torch.zeros(len(prompts), S, dtype=torch.int32)
    for i, p in enumerate(prompts):
        toks[i, S - len(p):] = torch.from_numpy(p)
    return toks


def _results(handles, what: str) -> list:
    out = [h.get(timeout=600) for h in handles]
    for i, r in enumerate(out):
        if isinstance(r, Exception):
            raise AssertionError(f"{what}: request {i} failed") from r
        if r.shape != (SERVE_MAX_NEW,):
            raise AssertionError(f"{what}: request {i} got {r.shape[0]} tokens, "
                                 f"expected {SERVE_MAX_NEW}")
    return out


def phase_serve(smi: str) -> dict:
    import numpy as np

    from repro_torch.configs.qwen3_1_7b import make_config
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.runtime import ContinuousScheduler, RequestQueue, Server
    from repro_torch.utils.trees import flatten_with_names

    cfg = make_config(use_flash=True)
    t0 = time.perf_counter()
    params = tf.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for _, p in flatten_with_names(params)[0])
    log(f"[serve] {cfg.name}: {n_params} params, {cfg.dtype}, use_flash, "
        f"init on the card in {time.perf_counter() - t0:.1f} s")
    server = Server(cfg, make_smoke_mesh(1, 1), params, max_len=SERVE_MAX_LEN)
    prompts = serve_prompts(cfg.vocab)

    # a hook of this script, not of the package: keep the q/k/v the first
    # prefill feeds to layers 0 and 27, and time every generate call
    attention = tf.attn_lib.attention
    captured, calls = {}, [0]

    def capture(q, k, v, **kw):
        li = calls[0] % cfg.n_self
        if calls[0] < cfg.n_self and li in (0, cfg.n_self - 1):
            captured[li] = (q.clone(), k.clone(), v.clone())
        calls[0] += 1
        return attention(q, k, v, **kw)

    generate, gen_ms = server.generate, []
    api, loops = server.api, []        # per generate: [start, end, steps]

    def timed_generate(*a, **kw):
        torch.cuda.synchronize()
        loops.append([torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True), 0])
        t = time.perf_counter()
        out = generate(*a, **kw)                 # ends in a host copy
        gen_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def timed_decode_step(*a):
        # CUDA events from the first decode step's start to the last one's
        # end: the decode loop's time on the device's clock, no extra sync
        loop = loops[-1]
        if loop[2] == 0:
            loop[0].record()
        out = api.decode_step(*a)
        loop[1].record()
        loop[2] += 1
        return out

    server.generate = timed_generate
    server.api = dataclasses.replace(api, decode_step=timed_decode_step)
    runs = {}
    flash.FLASH_LAUNCHES = 0
    tf.attn_lib.attention = capture
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rq = RequestQueue(server, batch=4)
        handles = [rq.submit(p, SERVE_MAX_NEW) for p in prompts]
        done = 0
        while done < len(prompts):
            done += rq.serve_once()
        static_out = _results(handles, "static")
        runs["static"] = dict(wall_s=time.perf_counter() - t0, prefills=2,
                              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                              flash_launches=flash.FLASH_LAUNCHES)
        server.api = api

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = ContinuousScheduler(server, slots=8, block_size=128, chunk=8)
        decode_chunk, chunk_ms = eng._decode_chunk, []

        def timed_chunk():
            t = time.perf_counter()
            out = decode_chunk()                 # ends in a host copy
            chunk_ms.append((time.perf_counter() - t) * 1e3)
            return out

        eng._decode_chunk = timed_chunk
        handles = [eng.submit(p, SERVE_MAX_NEW) for p in prompts]
        eng.run_until_idle()
        cont_out = _results(handles, "continuous")
        runs["continuous"] = dict(
            wall_s=time.perf_counter() - t0, prefills=len(prompts),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            flash_launches=flash.FLASH_LAUNCHES - runs["static"]["flash_launches"])
    finally:
        tf.attn_lib.attention = attention
        server.generate = generate
        server.api = api
    launches = flash.FLASH_LAUNCHES
    for name, r in runs.items():
        if r["flash_launches"] != cfg.n_self * r["prefills"]:
            raise AssertionError(f"{name}: {r['flash_launches']} flash launches, "
                                 f"expected {cfg.n_self} x {r['prefills']} prefills")
    if launches != cfg.n_self * (2 + len(prompts)):
        raise AssertionError(f"{launches} flash launches in the serve run")

    # the kernel on the q/k/v the first static prefill fed to layers 0, 27
    errs = {}
    for li, (q, k, v) in sorted(captured.items()):
        errs[li] = check_flash(q, k, v, True, f"serve layer {li} {tuple(q.shape)}")
    if sorted(errs) != [0, cfg.n_self - 1]:
        raise AssertionError(f"captured layers {sorted(errs)}")

    # one static prefill: use_flash against the chunked path, both in f32
    # (TF32 off).  They differ only in the order of the attention sums and
    # in exp's last bits; through 28 layers of random weights that stays
    # well under 1e-3 relative, so hold them to rtol = atol = 1e-3 on
    # logits of order 1 and report the difference.
    torch.backends.cuda.matmul.allow_tf32 = False
    toks = left_pad(prompts[:4]).cuda()
    p32 = {n: (p.float() if not isinstance(p, dict) else
               {m: w.float() for m, w in p.items()}) for n, p in params.items()}
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    lf, _ = tf.prefill(p32, toks, dataclasses.replace(cfg32, use_flash=True))
    lc, _ = tf.prefill(p32, toks, dataclasses.replace(cfg32, use_flash=False))
    torch.cuda.synchronize()
    logit_diff = (lf - lc).abs().max().item()
    logit_max = lc.abs().max().item()
    if not torch.allclose(lf, lc, rtol=1e-3, atol=1e-3):
        raise AssertionError(f"f32 prefill: use_flash vs chunked logits differ by "
                             f"{logit_diff} (max |logit| {logit_max})")
    del lf, lc
    decode32 = check_decode_f32(p32, cfg32, prompts[:2])
    del p32
    witness = bf16_witness(server, params, cfg, prompts, cont_out)

    # times of the pieces, on the card, after the counted run
    prefill_ms = {}
    for name, batch in (("static", prompts[:4]), ("continuous", prompts[:1])):
        t = left_pad(batch).cuda()
        t = torch.nn.functional.pad(t, (0, 512 - t.shape[1]))   # S = 512
        prefill_ms[name] = cuda_ms(lambda: tf.prefill(params, t, cfg), reps=3,
                                   warmup=1)
    agree = float(np.mean([np.mean(a == b) for a, b in zip(static_out, cont_out)]))
    tokens = SERVE_REQUESTS * SERVE_MAX_NEW
    steps = len(chunk_ms) * 8
    if any(n != SERVE_MAX_NEW - 1 for *_, n in loops):
        raise AssertionError(f"decode steps per generate: {[n for *_, n in loops]}")
    decode_ms = [a.elapsed_time(b) / n for a, b, n in loops]
    report = {
        "card": smi, "model": cfg.name, "params": n_params,
        "requests": SERVE_REQUESTS, "prompt_lens": [len(p) for p in prompts],
        "max_new": SERVE_MAX_NEW, "max_len": SERVE_MAX_LEN,
        "flash_launches": launches, "greedy_agreement_static_vs_continuous": agree,
        "kernel_vs_plain_err_layers_0_27": errs,
        "f32_logits_flash_vs_chunked_max_abs_diff": logit_diff,
        "f32_logits_max_abs": logit_max,
        "f32_engines": decode32, "bf16_witness": witness,
        "static": dict(runs["static"], tokens_per_s=tokens / runs["static"]["wall_s"],
                       generate_ms=gen_ms, prefill_ms_B4_S512=prefill_ms["static"],
                       decode_ms_per_token_step_per_generate=decode_ms,
                       decode_ms_per_token_step=sum(decode_ms) / len(decode_ms)),
        "continuous": dict(runs["continuous"],
                           tokens_per_s=tokens / runs["continuous"]["wall_s"],
                           chunk_ms=chunk_ms, prefill_ms_B1_S512=prefill_ms["continuous"],
                           decode_ms_per_token_step=sum(chunk_ms) / steps,
                           admission_s=(runs["continuous"]["wall_s"]
                                        - sum(chunk_ms) / 1e3)),
    }
    log("[serve] " + json.dumps(report))
    phase_serve_profile(params, cfg)
    return {"launches": launches, "report": report}


class LogitsRecorder:
    """Wraps a server's serve hooks to keep every logits tensor they
    return, in f32 (a tool of this script, not of the package)."""

    def __init__(self, server, hooks):
        self.server, self.api, self.logits = server, server.api, []

        def wrap(fn):
            def rec(*a, **kw):
                out = fn(*a, **kw)
                self.logits.append(out[0].float().clone())
                return out
            return rec

        server.api = dataclasses.replace(
            self.api, **{h: wrap(getattr(self.api, h)) for h in hooks})

    def close(self) -> list:
        self.server.api = self.api
        return self.logits


F32_ENGINE_STEPS = 8             # tokens per request in the f32 engine check


def check_decode_f32(p32, cfg32, prompts) -> dict:
    """Full width in f32 (TF32 off), on unpadded prompts at batch 1: the
    static engine (``Server.generate``: prefill, ring-cache
    ``decode_step``) against the continuous engine (bucketed prefill read
    at ``last_pos``, the pool scatter, ``decode_step_paged`` over blocks of
    128), step by step on their logits and tokens; and the static
    engine's decode logits against a prefill of the same tokens read at
    the same position.  The paths differ only in the order of their sums
    (GEMM shapes, flash or dense attention), so they are held to rtol =
    atol = 1e-3 as flash against chunked is; a wrong position, block or
    row changes logits of order 1."""
    import numpy as np

    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.runtime import ContinuousScheduler, Server

    cfg = dataclasses.replace(cfg32, use_flash=True)
    n = F32_ENGINE_STEPS
    server = Server(cfg, make_smoke_mesh(1, 1), p32, max_len=SERVE_MAX_LEN)
    static_tok, static_lg = [], []
    for p in prompts:
        rec = LogitsRecorder(server, ("prefill", "decode_step"))
        static_tok.append(server.generate(p[None], n)[0])
        static_lg.append(rec.close())           # prefill, then n - 1 decodes
    rec = LogitsRecorder(server, ("prefill", "decode_paged"))
    eng = ContinuousScheduler(server, slots=8, block_size=128, chunk=8)
    cont_tok = eng.generate_batch(prompts, n)
    cont_lg = rec.close()    # one prefill per prompt, then one chunk (W, V) a step

    def diff(a, b, what):
        d = (a - b).abs().max().item()
        if not torch.allclose(a, b, rtol=1e-3, atol=1e-3):
            raise AssertionError(f"f32 {what}: logits differ by {d}")
        return d

    engines = []
    for i, p in enumerate(prompts):
        if not np.array_equal(static_tok[i], cont_tok[i]):
            raise AssertionError(f"f32 prompt {i}: static {static_tok[i]} vs "
                                 f"continuous {cont_tok[i]}")
        engines.append(diff(static_lg[i][0], cont_lg[i], f"prompt {i} prefill"))
        for j in range(n - 1):
            engines.append(diff(static_lg[i][1 + j], cont_lg[len(prompts) + j][i:i + 1],
                                f"prompt {i} decode step {j}"))
    # decode_step at position L + j against a prefill read at L + j
    L = len(prompts[0])
    seq = torch.as_tensor(np.concatenate([prompts[0], static_tok[0][:n - 1]]),
                          dtype=torch.int32, device=server.device)[None]
    forced = [diff(static_lg[0][1 + j], tf.prefill(p32, seq, cfg, last_pos=L + j)[0]
                   .float(), f"decode step {j} vs prefill")
              for j in range(n - 1)]
    out = dict(prompt_lens=[len(p) for p in prompts], tokens_per_request=n,
               tokens_equal=True,
               static_vs_continuous_logits_max_abs_diff=max(engines),
               decode_vs_prefill_logits_max_abs_diff=max(forced),
               logits_max_abs=max(lg.abs().max().item() for lg in static_lg[0]))
    log("[serve_f32] " + json.dumps(out))
    return out


def bf16_witness(server, params, cfg, prompts, cont_out) -> dict:
    """Report only: why the bf16 engines disagree.  Each prompt served
    alone (batch 1, no left pad) by the static engine against the
    continuous engine's tokens; and, per prompt, the bf16 prefill logits
    unpadded against the continuous engine's bucketed prefill read at
    ``last_pos``, beside the gap between the two largest logits."""
    import numpy as np

    from repro_torch.models import transformer as tf

    alone = [server.generate(p[None], SERVE_MAX_NEW)[0] for p in prompts]
    first = [int(np.argmax(a != b)) if (a != b).any() else SERVE_MAX_NEW
             for a, b in zip(alone, cont_out)]
    diffs, gaps = [], []
    for p in prompts:
        t = torch.as_tensor(p, dtype=torch.int32, device=server.device)[None]
        bucket = torch.nn.functional.pad(t, (0, -(-len(p) // 128) * 128 - len(p)))
        a = tf.prefill(params, t, cfg)[0].float()
        b = tf.prefill(params, bucket, cfg, last_pos=len(p) - 1)[0].float()
        diffs.append((a - b).abs().max().item())
        top2 = a.topk(2).values[0]
        gaps.append((top2[0] - top2[1]).item())
    out = dict(
        greedy_agreement_static_B1_vs_continuous=float(
            np.mean([np.mean(a == b) for a, b in zip(alone, cont_out)])),
        first_divergent_token=first,
        prefill_logits_unpadded_vs_bucket_max_abs_diff=diffs,
        prefill_top2_logit_gap=gaps)
    log("[serve_bf16_witness] " + json.dumps(out))
    return out


def phase_serve_profile(params, cfg) -> None:
    """One static prefill (B 4, S 512) and three decode steps of the
    full-width model: their wall time without the profiler (host clock
    around synchronized work, median of 3), then one run of each under
    ``torch.profiler`` for kernel time, launches and the kernels that take
    the most.  The device's idle share is 1 - kernel time / the
    unprofiled wall time (the profiler slows the host, not the kernels).
    Runs after the main path's launch counts were read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as tf
    from repro_torch.runtime import sharded_argmax

    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(1, cfg.vocab, (4, 512), generator=gen,
                         dtype=torch.int32).cuda()
    logits, cache = tf.prefill(params, toks, cfg)     # warm-up
    cache = {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 512))
             for n, c in cache.items()}
    tok = sharded_argmax(logits.float(), 1)
    torch.cuda.synchronize()

    def prefill():
        tf.prefill(params, toks, cfg)

    def decode():
        nonlocal tok
        for pos in range(512, 515):
            lg, _ = tf.decode_step(params, cache, tok, pos, cfg)
            tok = sharded_argmax(lg.float(), 1)

    def wall_ms(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    out = {}
    for name, fn in (("prefill B4 S512", prefill),
                     ("decode B4, 3 steps at 512-514, cache 1024", decode)):
        plain_ms = sorted(wall_ms(fn) for _ in range(3))[1]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prof_ms = wall_ms(fn)
        # the kernels alone: an operator's own device time repeats its
        # kernels'.  One stream, so their sum is the device's busy time.
        kernels = [e for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA]
        busy_ms = sum(_device_ms(e, self_only=True) for e in kernels)
        top = sorted(kernels, key=lambda e: _device_ms(e, self_only=True),
                     reverse=True)[:12]
        out[name] = {
            "wall_ms": plain_ms,
            "wall_ms_under_profiler": prof_ms,
            "kernel_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / plain_ms,
            "device_idle_share_under_profiler": 1 - busy_ms / prof_ms,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "ms": round(_device_ms(e, self_only=True), 3)}
                            for e in top]}
    log("[serve_profile] " + json.dumps(out))


def phase_serve_cpu_vs_gpu() -> None:
    import numpy as np

    from repro_torch.configs.qwen3_1_7b import make_smoke
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.runtime import ContinuousScheduler, Server

    cfg = dataclasses.replace(make_smoke(), use_flash=True)
    params = tf.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(5, 40, size=6)]
    toks = left_pad(prompts)
    got = {}
    for device in ("cpu", "cuda"):
        p = {n: (w.to(device) if not isinstance(w, dict) else
                 {m: x.to(device) for m, x in w.items()}) for n, w in params.items()}
        server = Server(cfg, make_smoke_mesh(1, 1), p, max_len=64)
        eng = ContinuousScheduler(server, slots=4, block_size=16, chunk=4)
        logits, _ = tf.prefill(p, toks.to(device), cfg)
        got[device] = (server.generate(toks.numpy(), 8),
                       eng.generate_batch(prompts, 8), logits.cpu())
    (s_cpu, c_cpu, l_cpu), (s_gpu, c_gpu, l_gpu) = got["cpu"], got["cuda"]
    if not np.array_equal(s_cpu, s_gpu):
        raise AssertionError(f"static tokens differ: cpu {s_cpu} gpu {s_gpu}")
    for i, (a, b) in enumerate(zip(c_cpu, c_gpu)):
        if not np.array_equal(a, b):
            raise AssertionError(f"continuous request {i}: cpu {a} gpu {b}")
    diff = (l_cpu - l_gpu).abs().max().item()
    if not torch.allclose(l_cpu, l_gpu, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"prefill logits cpu vs gpu differ by {diff}")
    log(f"[serve_cpu_vs_gpu] {cfg.name}: static and continuous greedy tokens "
        f"equal on CPU and GPU ({len(prompts)} prompts x 8); prefill logits "
        f"max abs diff {diff} (rtol = atol = 1e-4, f32)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a GPU", file=sys.stderr)
        return 1
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_dist

    faulthandler.dump_traceback_later(HANG_LIMIT_S, exit=True)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)} ({smi})")
    phase_build()
    init_dist("cuda")
    try:
        rows = phase_kernels()
        train = phase_train()
        phase_profile(*train["live"])
        phase_cpu_vs_gpu()
    finally:
        dist.destroy_process_group()
    del train["live"]
    flash_rows = phase_flash()
    serve = phase_serve(smi)
    phase_serve_cpu_vs_gpu()

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
    fr = flash_rows["static"]
    kernels.append({
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:78",
        "launches": serve["launches"], "launches_per_prefill": 28,
        "max_abs_err": fr["max_abs_err"], "ms": fr["ms"],
        "plain_ms": fr["plain_ms"], "bound_ms": fr["bound_ms"],
        "bound_by": fr["bound_by"], "library_ms": fr["library_ms"],
        "shape": fr["shape"], "continuous_shape": flash_rows["continuous"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
