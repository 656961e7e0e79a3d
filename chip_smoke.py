#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

  build       compile every kernel source from ``csrc/`` for sm_90a.
  kernels     the pack kernel (into a buffer started as NaN, through
              ``out=``) and ``fused_unpack`` against their plain versions
              on the 24 full-width ResNet-50 buckets (comm dtype f32, bf16,
              f16; scale 1, 4 and 64, so unpack at 1, 1/4 and 1/64; one
              launch a bucket each way), one mixed-dtype bucket and one
              bucket of more leaves than one launch takes (4 and 3 launches
              each way): bit-exact.  Logs the bucket layouts built (pack and
              unpack share them) and the leaves that take the scalar path.
              Then each kernel is timed over a whole step's buckets with
              CUDA events (in turns with one PyTorch call doing the same),
              torch.profiler's device time and the host's enqueue time,
              beside its plain version; unpack also at scale 1/4.
  ring_quant  the ring-hop combine against torch.add (f32, bf16, f16; the
              tests/test_collectives.py lengths 100 and 4096, an odd
              length and the half-chunks of the 24 ResNet-50 buckets at a
              ring of 4; aligned and misaligned; into a new tensor and in
              place), its pair entry (each bucket's two half-chunk pairs as
              the ring forms them, an empty second half, 8 pairs; one
              launch a call) and the int8 kernels against their plain
              versions, bit for bit: the quantize/dequantize on the 24
              buckets padded to 256·4 and their shards (magnitudes 1e-3, 1
              and 1e3, zero blocks, blocks of exact .5 ties; outputs
              started as NaN); the quantize of an unpadded buffer, as
              phase 1 runs it, on the 24 buckets at their real lengths (4
              ragged), n = 1001, n = 255 + 256·k and a bucket of fewer than
              256 elements, with NaN past n in memory; the fused
              sum-requantize (phases 2-3) and the dequantize's peer-sum
              entry on the 24 buckets' shards at
              g = 4, on the tie blocks, and the fused entry at g = 1, 2, 3,
              8 and 9; outputs started as poison (scales NaN, q 0x7f), one
              launch a call.  Then each timed over one rank's training
              step of launches (72 combines of two pairs, 48 quantizes, 24
              fused sum-requantizes, 48 dequantizes, 24 peer sums) with
              CUDA events, torch.profiler and the host's enqueue time,
              beside its byte bound, its plain version and one PyTorch call
              (``torch._foreach_add_`` a hop, and ``torch.add`` a pair;
              ``torch.mul``).  The main path's quantize work a step (24
              quantizes of the unpadded buckets + 24 fused launches) in
              turns against what it replaces (F.pad of the 4 ragged
              buckets, 48 quantizes at the parent's launch path, 24 peer
              sums), with device time (and the profiler's
              span over CUDA events) beside both bounds; the dequantize
              work of the peer-sum path (24 peer sums + 24 dequantizes)
              against 48 dequantizes + 72 ``torch.add`` and ``torch.mul``
              + ``torch.add``.  (By hand: ``ring_quant_in_turns`` runs
              another tree's ``phase_ring_quant`` in turns with this one.)
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
  lm_kernels  the pack and unpack kernels bit for bit against their plain
              versions at the LM's layouts: the 10 buckets of Qwen3-1.7B's
              post-backward plan (bf16 leaves, f32 comm) and the 28
              in-backward slots of depcha (a layer's 11 bf16 leaves into a
              bf16 slot, scale 1), one launch each way a bucket or slot.
              Then a step's worth of each timed with CUDA events in turns
              with torch.cat / torch._foreach_copy_, beside the plain
              version and the byte bound.
  lm_train    Qwen3-1.7B at full width (28 layers, bf16, random seeded
              weights) on a one-rank NCCL group: seq 1024 x global batch 4,
              AdamW with cosine warm-up, clip 1.0, remat "dots", the
              chunked attention; funnel, concom and depcha (in-scan) from
              the same weights, 1 warm-up + 2 timed steps each, under
              torch.use_deterministic_algorithms (CUBLAS_WORKSPACE_CONFIG
              set before the first CUDA context; the setting restored
              after).  Step times, tokens/s and peak memory (under 80 GB);
              pack and unpack launches exactly the schedule's buckets a
              step plus one slot a layer under depcha; 28 in-backward
              collectives a depcha step and none under the others; losses
              bit-identical across the strategies (an op reported
              nondeterministic would be named and the later steps held to
              rtol 1e-3).  Then one more depcha step under torch.profiler
              (kernel time against the timed steps' wall time: the device
              idle share; the kernels that take the most) and one with a
              CUDA event at each step stage's entry and exit (each stage's
              span on the device).  (By hand, on four cards:
              ``phase_lm_cards()`` trains the same model data-parallel
              over NCCL, one rank a card, the strategies in turns.)
  lm_cpu_vs_gpu  the quickstart LM's widths (4 layers, d 128, 8/4 heads,
              ff 256, vocab 512, f32, attn_chunk 64), 3 steps of depcha
              in-scan on the CPU (plain versions) and on the card
              (kernels) from the same weights and batches, TF32 off:
              losses within rtol 1e-5, 4 in-backward collectives a step
              on each.
  inception_kernels  the pack and unpack kernels bit for bit against
              their plain versions at Inception-BN's layouts: the 2
              buckets of its full-width plan (57 f32 leaves and the head;
              f32 and bf16 comm, scale 1 and 4), one launch each way a
              bucket; then a step's worth timed in turns with torch.cat /
              torch._foreach_copy_, on the device, beside the plain
              version and the byte bound.
  inception   Inception-BN/ImageNet at full width (width 1.0, 224x224,
              1000 classes, random seeded weights), global batch 256, SGD
              with momentum 0.9, clip 1.0, TF32 off, deterministic cuDNN,
              on a one-rank NCCL group: funnel, concom and depcha through
              ``Trainer`` with a ``MetricsRegistry``, 1 warm-up + 2 timed
              steps each.  Losses equal across the strategies (rtol
              1e-5); pack and unpack launches exactly the plan's (2 a
              step); the ``comm_bytes.*`` counters the schedule's bytes.
              Step ms, images/s, peak memory, the host ms of one
              ``batch_at``, a profiled depcha step (idle share, top
              kernels) and its stages by CUDA events.
  inception_cpu_vs_gpu  the Inception smoke config, 3 steps of depcha on
              the CPU (plain versions) and on the card: losses within
              rtol 1e-5.
  verify      host ms of the six analysis passes that GradSync runs
              while planning (ResNet-50, Qwen3-1.7B depcha in-scan,
              Inception-BN; 1 and 8 ranks), and the port analyzer's
              cross-product summary: every planned cell clean.
  reducers    four rank processes spawned on the one card, each with all
              its compute on cuda:0 and gloo communicators staged through
              pinned host memory (NCCL refuses two ranks on one device;
              this measures the kernels and the schedule's order, not a
              wire).  Full-width ResNet-50, global batch 256 (64 a rank),
              the same seeded weights, TF32 off: 1 warm-up + 2 steps of
              funnel x {flat, ring, compressed, compressed_ring}, concom x
              ring and rsag x ring.  Params bit-identical across the ranks
              after every step; the first step's ring gradients within
              rtol 1e-5 of flat's; compressed_ring = compressed bit for bit;
              compressed within the int8 quantization bound of the flat
              sum on every block; one captured bucket's ring allreduce with
              the kernel = with the plain add, bit for bit; the launch
              counts of the five kernel entries exactly as
              ``step_launches`` predicts from the plan (one combine a ring
              hop: 72 a step; one quantize, one fused sum-requantize and
              one dequantize a compressed bucket, no peer sum).  Then the
              quickstart LM (f32) for 3 steps of funnel and of depcha
              in-scan (its in-backward collectives through the same pinned
              host memory): params bit-identical across the ranks after
              every step, depcha's first-step gradients within rtol 1e-5 /
              atol 1e-6 of funnel's, 4 in-backward collectives a depcha
              step.
  hierarchical four rank processes on the one card as ``reducers``, on
              pod 2 x data 2 and pod 1 x data 4.  The peer-memory ring
              reduce-scatter and all-gather (the intra-pod rings, through
              CUDA IPC) against the plain rings, bit for bit: f32 and bf16,
              uni- and bidirectional, the 24 bucket sizes padded to the
              ring, c = 1 and an odd c, back to back with no host sync,
              and on two chains (streams, rings) at once; then 3·K + 2
              calls of each back to back (K message slots a direction, so
              every slot is rewritten), the chunk alternating between the
              largest bucket's and one element, with the stream waits
              counted.  Each timed over a ResNet-50 step (24 calls) with
              CUDA events, torch.profiler and the host's enqueue time
              beside the plain ring and the byte bound, its stream waits
              counted by the library and held to ``hier_memops``.
              Then full-width ResNet-50 at global batch 256, 1 warm-up + 2
              steps of funnel x {flat, hierarchical, hierarchical_ring}
              and concom x hierarchical_ring on pod 2 x data 2 and funnel
              x hierarchical_ring on pod 1 x data 4: params bit-identical
              across the ranks after every step, first-step gradients
              within rtol 1e-5 of flat's, one captured bucket through
              hierarchical_ring on the kernels = through the plain rings,
              peer-ring launches exactly as ``hier_launches`` predicts and
              their stream waits as ``hier_memops`` does, and none of
              rows 3, 6, 7 (nor the peer sum or the fused entry).  (By hand:
              ``peer_rings_in_turns`` times another tree's rings in turns
              with these.)
  flash       cuobjdump must find HGMMA (wgmma) and UTMALDG (TMA) code in
              the bf16 library.  The flash-attention kernels against
              their plain version:
              bf16 on the tensor-core kernel (TMA, wgmma) at 2e-2, f32 on
              the CUDA-core kernel at 2e-5, on the five tests/test_kernels.py
              shapes, Qwen3-1.7B's static prefill shape (B 4, S 512, 16/8
              heads, D 128, bf16), a ragged S = 200 and the smoke config's
              head dim 16; each error logged as a share of the check's
              bound, atol + rtol |plain|.
              Then kernel, plain and F.scaled_dot_product_attention times
              with CUDA events, and the kernel's device time from
              torch.profiler, at the static and the continuous prefill
              shape in bf16 and at the static shape in f32.
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
              time / unprofiled wall time; the flash kernels' share of
              the kernel time).
  serve_cpu_vs_gpu  the qwen3 smoke config, the same weights, greedy,
              through both engines on the CPU (plain versions) and on the
              GPU (kernel): tokens equal, prefill logits close in f32.
  wkv         Qwen3's weights freed first.  The WKV kernel's one-chunk
              entry against its plain version on the three
              tests/test_kernels.py shapes (one with bf16 inputs), RWKV-6
              7B's prefill chunk (B 4, C 32, 64 heads of 64), its decode
              step (C 1), a short prompt (C 7) and the smoke head size
              (N 16): tolerance 5e-4 in f32, 5e-2 with bf16 inputs.  Then
              its sequence entry, one launch a layer, against
              wkv_sequence_ref: RWKV-6 7B's prefill layer (B 4, S 512,
              chunk 32) in bf16 and in f32, a ragged S 481, S 7 below the
              chunk (B 1: 2 column splits), the decode step (S 1) and the
              smoke config (B 2, S 23, H 4, N 16, chunk 16); the state and
              f32 y at atol = rtol = 5e-4, bf16 y within one bf16 rounding
              (rtol 2^-7, atol 5e-4); one launch a call.  The prefill
              layer also at every column split built, at B 4 and at B 1.
              Then, at the prefill layer in bf16 and the decode step: ms a
              layer back to back (CUDA events) for the kernel and for
              rwkv.wkv_chunked, device ms (torch.profiler), the host's
              enqueue time, the plain version's ms, launches a call and
              the split, beside the bound by bytes and by operations; the
              one-chunk entry timed at the prefill chunk and decode shapes
              as before.
  rwkv_serve  RWKV-6 7B at full width, bf16, tp=1, random weights from a
              seeded generator on the card with the reference's constant
              leaves perturbed: the same 8 prompts through the static
              engine (RequestQueue, batch 4: 2 prefills), 32 new tokens
              each.  WKV launches must be exactly 32 a prefill (one a
              layer) plus 32 a decode step; the continuous engine must
              refuse the family.  Then in f32 at full width, one prompt at
              B 1: every layer's block on the kernel path against the
              plain path on the same input (1e-3), the last logits against
              the plain path and prefill(S-2) + 2 decode steps against
              prefill(S) (1e-3 and 2e-3, or the plain path's own B 1 vs
              B 2 difference where that is larger: the random-weight model
              is chaotic in f32).  Then report-only prefill and decode
              times, tokens/s, peak memory and a profile as serve's.
  rwkv_cpu_vs_gpu  the rwkv smoke config, the same weights, greedy
              through Server.generate on the CPU (plain versions) and on
              the GPU (kernel): tokens equal, prefill logits within 1e-4,
              one WKV launch a layer a prefill and a decode step.

The build compiles every kernel source at once (one nvcc each, in
parallel).  Then it prints the ``{"kernels": [...]}`` line, the card's
name and power limit as nvidia-smi reports them, and last
``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import faulthandler
import gc
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
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


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


def cuda_ms_in_turns(fns: dict) -> dict:
    """``cuda_ms`` of each function, twice, in turns (a, b, c, c, b, a):
    the host's launch rate drifts within a run, so versions are compared
    within one pass.  Returns each name's two times."""
    turns = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            turns[k].append(cuda_ms(fns[k]))
    return turns


def phase_build() -> None:
    """Compile every kernel source at once: one nvcc each, in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.collectives import kernel as collectives
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.quantize import kernel as quantize
    from repro_torch.kernels.rwkv6 import kernel as wkv

    def timed(build):
        t0 = time.perf_counter()
        return build(), time.perf_counter() - t0

    t0 = time.perf_counter()
    builds = (collectives.build, collectives.build_ring_accum,
              collectives.build_ring_p2p, flash.build, flash.build_tc, wkv.build,
              quantize.build)
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        futures = [pool.submit(timed, b) for b in builds]
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
    from repro_torch.kernels.collectives import kernel, ops, ref

    leaves = [flat[l.index] for l in bucket.leaves]
    nan = torch.full((bucket.size,), float("nan"), dtype=comm, device="cuda")
    got = kernel.pack_bucket_kernel(leaves, comm, scale=scale, out=nan)   # NaN first
    want = ref.leafwise_pack(leaves, comm, scale=scale)
    err = same_bits(got, want, f"pack b{bucket.bucket_id} {comm} x{scale}")
    out_k = list(flat)
    out_p = list(flat)
    for l in bucket.leaves:      # NaN first: an element the kernel misses shows
        out_k[l.index] = torch.full(l.shape, float("nan"), dtype=l.dtype, device="cuda")
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

    kernel.LAYOUTS_BUILT = 0
    err = 0.0
    n_checks = 0
    for comm in (torch.float32, torch.bfloat16, torch.float16):
        for scale in (1.0, 4.0, 64.0):      # unpack at 1, 1/4 (the 4-rank mean), 1/64
            for b in plan.buckets:
                before = (kernel.PACK_LAUNCHES, kernel.UNPACK_LAUNCHES)
                err = max(err, check_bucket(b, flat, comm, scale))
                if (kernel.PACK_LAUNCHES - before[0], kernel.UNPACK_LAUNCHES - before[1]) != (1, 1):
                    raise AssertionError(f"bucket {b.bucket_id}: expected 1 pack and 1 "
                                         f"unpack launch")
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
            before = (kernel.PACK_LAUNCHES, kernel.UNPACK_LAUNCHES)
            err = max(err, check_bucket(mixed, flat_x, comm, scale))
            if (kernel.PACK_LAUNCHES - before[0], kernel.UNPACK_LAUNCHES - before[1]) != (4, 4):
                raise AssertionError("mixed bucket: expected 4 pack and 4 unpack launches")
            before = (kernel.PACK_LAUNCHES, kernel.UNPACK_LAUNCHES)
            err = max(err, check_bucket(many, flat_x, comm, scale))
            if (kernel.PACK_LAUNCHES - before[0], kernel.UNPACK_LAUNCHES - before[1]) != (3, 3):
                raise AssertionError("150-leaf bucket: expected 3 pack and 3 unpack launches")
            n_checks += 2
    torch.cuda.synchronize()
    scalar = {str(c): scalar_path_leaves(plan, flat, c) for c in (torch.float32, torch.bfloat16)}
    log(f"[kernels] {n_checks} bucket checks bit-exact "
        f"(max abs err {err}; pack into a buffer started as NaN); 24 buckets, "
        f"{sum(len(b.leaves) for b in plan.buckets)} leaves, "
        f"{sum(b.size for b in plan.buckets)} elements; one pack and one unpack launch a "
        f"bucket; {kernel.LAYOUTS_BUILT} bucket layouts built (pack and unpack share "
        f"one a bucket, dtypes and scale); ResNet-50 leaves on the scalar path "
        f"(leaf or buffer slice not 16-byte aligned), by comm dtype: {scalar}")

    # timing over a whole step's buckets: f32 wire, scale 1 (the main path)
    # and, for unpack, 1/4 (the four-rank mean's inverse scale)
    f32 = torch.float32
    bufs = [ops.fused_pack(b, flat, f32) for b in plan.buckets]
    outs = [torch.empty_like(t) for t in flat]
    step_bytes = 2 * sum(b.size for b in plan.buckets) * f32.itemsize
    bound = step_bytes / HBM_BYTES_PER_S * 1e3
    sizes_of = [[l.size for l in b.leaves] for b in plan.buckets]
    n_buckets = len(plan.buckets)

    def pack():
        for b in plan.buckets:
            ops.fused_pack(b, flat, f32)

    def unpack(scale=1.0):
        for b, buf in zip(plan.buckets, bufs):
            ops.fused_unpack(b, buf, outs, scale=scale)

    def lib_pack():
        for b in plan.buckets:
            torch.cat([flat[l.index].reshape(-1).to(f32) for l in b.leaves])

    def lib_unpack():
        for b, buf, sz in zip(plan.buckets, bufs, sizes_of):
            torch._foreach_copy_([outs[l.index].view(-1) for l in b.leaves],
                                 list(torch.split(buf, sz)))

    pack_turns = cuda_ms_in_turns({"ms": pack, "library_ms": lib_pack})
    unpack_turns = cuda_ms_in_turns({"ms": unpack, "library_ms": lib_unpack})
    rows = {
        "pack": dict(
            ms=sum(pack_turns["ms"]) / 2,
            device_ms=device_ms_per_launch(pack, "pack_bucket_kernel", reps=10),
            host_ms_per_bucket=host_ms(pack, reps=20) / n_buckets,
            plain_ms=cuda_ms(lambda: [ref.leafwise_pack(
                [flat[l.index] for l in b.leaves], f32) for b in plan.buckets]),
            library_ms=sum(pack_turns["library_ms"]) / 2, library="torch.cat",
            library_host_ms_per_bucket=host_ms(lib_pack, reps=20) / n_buckets,
            turns=pack_turns),
        "unpack": dict(
            ms=sum(unpack_turns["ms"]) / 2,
            device_ms=device_ms_per_launch(unpack, "unpack_bucket_kernel", reps=10),
            host_ms_per_bucket=host_ms(unpack, reps=20) / n_buckets,
            plain_ms=cuda_ms(lambda: [plain_unpack(b, buf, outs)
                                      for b, buf in zip(plan.buckets, bufs)]),
            library_ms=sum(unpack_turns["library_ms"]) / 2, library="torch._foreach_copy_",
            library_host_ms_per_bucket=host_ms(lib_unpack, reps=20) / n_buckets,
            turns=unpack_turns,
            scale_quarter=dict(
                ms=cuda_ms(lambda: unpack(0.25)),
                device_ms=device_ms_per_launch(lambda: unpack(0.25), "unpack_bucket_kernel",
                                               reps=10),
                plain_ms=cuda_ms(lambda: [plain_unpack(b, buf, outs, 0.25)
                                          for b, buf in zip(plan.buckets, bufs)]))),
    }
    for name, r in rows.items():
        r.update(bound_ms=bound, bound_by="bytes", max_abs_err=err,
                 step_bytes=step_bytes)
        log(f"[kernels] {name} ({n_buckets} launches a step): " + json.dumps(r))
    rows["pack"]["scalar_path_leaves"] = scalar
    return rows


def scalar_path_leaves(plan, flat, comm) -> int:
    """Leaves of the plan whose pack or unpack walks scalars: the leaf's
    pointer or its slice of a ``comm`` buffer (at a 16-byte aligned base)
    not 16-byte aligned."""
    n = 0
    for b in plan.buckets:
        off = 0
        for l in b.leaves:
            n += bool((flat[l.index].data_ptr() | off * comm.itemsize) % 16)
            off += l.size
    return n


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
    kernel.LAYOUTS_BUILT = 0
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
            f"first step {hist['compile_time'] * 1e3:.1f} ms, timed steps "
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
        f"{len(STRATEGIES)} strategies; losses agree across strategies; "
        f"{kernel.LAYOUTS_BUILT} bucket layouts built for {launches['pack']} packs and "
        f"{launches['unpack']} unpacks (at most one a bucket, shared by pack and "
        f"unpack: the .grad tensors are new each step, their layout is not, and the "
        f"kernels phase may have built it already)")
    return {"launches": launches, "hists": hists, "live": live,
            "layouts_built": kernel.LAYOUTS_BUILT}


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


# ------------------------------------------------------- the transformer LM

LM_SEQ, LM_BATCH = 1024, 4     # tokens a sequence, global batch: 4,096 tokens a step
LM_STEPS = 3                   # 1 warm-up + 2 timed
LM_STAGES = ("step.forward", "step.backward", "step.gradsync", "step.depcha_wait",
             "step.optimizer", "step.loss_allreduce")


def lm_config(strategy: str = "funnel"):
    """Qwen3-1.7B at full width (28 layers, bf16), depcha's in-backward
    sync on exactly under the strategies that use it."""
    from repro_torch.configs.qwen3_1_7b import make_config
    from repro_torch.core import get_strategy

    return make_config(depcha_in_scan=get_strategy(strategy).uses_in_scan)


def lm_plan():
    """Qwen3-1.7B's post-backward bucket plan as GradSync builds it (4 MiB
    buckets, 4 channels, f32 comm) and its named leaves, on ``meta``."""
    from repro_torch.core import make_bucket_plan
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.transformer import init_params, param_specs
    from repro_torch.utils.trees import flatten_with_names

    cfg = lm_config()
    params = init_params(cfg, device="meta")
    plan = make_bucket_plan(params, param_specs(params, cfg), make_smoke_mesh(1),
                            bucket_bytes=4 * 1024 * 1024, num_channels=4)
    return plan, flatten_with_names(params)[0]


def time_staging(buckets_and_leaves, comm) -> dict:
    """A step's worth of pack and of unpack launches (each bucket with its
    leaf list) timed with CUDA events in turns with one PyTorch call doing
    the same (``torch.cat``, ``torch._foreach_copy_``), and by
    torch.profiler on the device; beside the plain version and the byte
    bound (each leaf read or written once, each buffer written or read
    once)."""
    from repro_torch.kernels.collectives import ops, ref

    bufs = [ops.fused_pack(b, lv, comm) for b, lv in buckets_and_leaves]
    targets = {}      # one set of outputs for each leaf list
    for _, lv in buckets_and_leaves:
        if id(lv) not in targets:
            targets[id(lv)] = [torch.empty_like(t) for t in lv]
    outs = [targets[id(lv)] for _, lv in buckets_and_leaves]
    elems = sum(b.size for b, _ in buckets_and_leaves)
    leaf_bytes = sum(sum(lv[l.index].numel() * lv[l.index].element_size()
                         for l in b.leaves) for b, lv in buckets_and_leaves)
    bound = (leaf_bytes + elems * comm.itemsize) / HBM_BYTES_PER_S * 1e3

    def pack():
        for b, lv in buckets_and_leaves:
            ops.fused_pack(b, lv, comm)

    def unpack():
        for (b, _), buf, out in zip(buckets_and_leaves, bufs, outs):
            ops.fused_unpack(b, buf, out)

    def lib_pack():
        for b, lv in buckets_and_leaves:
            torch.cat([lv[l.index].reshape(-1).to(comm) for l in b.leaves])

    def lib_unpack():
        for (b, _), buf, out in zip(buckets_and_leaves, bufs, outs):
            torch._foreach_copy_([out[l.index].view(-1) for l in b.leaves],
                                 list(torch.split(buf, [l.size for l in b.leaves])))

    def plain_unpack_all():
        for (b, _), buf, out in zip(buckets_and_leaves, bufs, outs):
            plain_unpack(b, buf, out)

    res = {}
    for name, fn, lib, plain in (
            ("pack", pack, lib_pack, lambda: [ref.leafwise_pack(
                [lv[l.index] for l in b.leaves], comm) for b, lv in buckets_and_leaves]),
            ("unpack", unpack, lib_unpack, plain_unpack_all)):
        turns = cuda_ms_in_turns({"ms": fn, "library_ms": lib})
        res[name] = dict(ms=sum(turns["ms"]) / 2, library_ms=sum(turns["library_ms"]) / 2,
                         device_ms=device_ms_per_launch(fn, f"{name}_bucket_kernel", reps=10),
                         plain_ms=cuda_ms(plain, reps=5), bound_ms=bound, bound_by="bytes",
                         launches=len(buckets_and_leaves), turns=turns)
    return res


def phase_lm_kernels() -> dict:
    """Rows 1-2 at the LM's layouts, bit for bit against their plain
    versions: every bucket of Qwen3-1.7B's post-backward plan (bf16 leaves,
    f32 comm) and every layer's in-backward slot (its 11 bf16 leaves into
    a bf16 slot, scale 1: a bit copy), one launch each way a bucket or a
    slot.  Then one step's worth of each (the plan's buckets; the 28
    slots) timed with CUDA events in turns with one PyTorch call doing the
    same, beside the plain version and the byte bound."""
    from repro_torch.core.overlap import LayerSync
    from repro_torch.kernels.collectives import kernel
    from repro_torch.launch.mesh import make_dp_mesh
    from repro_torch.models.transformer import _depcha_axes, init_params

    plan, named = lm_plan()
    cfg = lm_config("depcha")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flat = [torch.randn(p.shape, generator=gen, device="cuda").to(p.dtype) for _, p in named]
    f32 = torch.float32
    err, n_checks = 0.0, 0
    for b in plan.buckets:
        before = (kernel.PACK_LAUNCHES, kernel.UNPACK_LAUNCHES)
        err = max(err, check_bucket(b, flat, f32, 1.0))
        if (kernel.PACK_LAUNCHES - before[0], kernel.UNPACK_LAUNCHES - before[1]) != (1, 1):
            raise AssertionError(f"LM bucket {b.bucket_id}: expected 1 pack and 1 unpack launch")
        n_checks += 1
    blocks = {n[len("blocks/"):]: t for (n, _), t in zip(named, flat) if n.startswith("blocks/")}
    meta_blocks = init_params(cfg, device="meta")["blocks"]
    sync = LayerSync(meta_blocks, _depcha_axes(cfg, meta_blocks, "blocks/"), make_dp_mesh(),
                     device="cuda")
    if len(sync.buckets) != 1:
        raise AssertionError(f"expected one slot a layer, got {len(sync.buckets)}")
    slot_bucket, _, slot_dtype = sync.buckets[0]
    names = sorted(blocks)
    rows = [[blocks[n][li] for n in names] for li in range(cfg.n_layers)]
    for li in range(cfg.n_layers):
        before = (kernel.PACK_LAUNCHES, kernel.UNPACK_LAUNCHES)
        err = max(err, check_bucket(slot_bucket, rows[li], slot_dtype, 1.0))
        if (kernel.PACK_LAUNCHES - before[0], kernel.UNPACK_LAUNCHES - before[1]) != (1, 1):
            raise AssertionError(f"slot of layer {li}: expected 1 pack and 1 unpack launch")
        n_checks += 1
    torch.cuda.synchronize()
    log(f"[lm_kernels] {n_checks} checks bit-exact (max abs err {err}): "
        f"{len(plan.buckets)} post-backward buckets ({plan.num_leaves} bf16 leaves, "
        f"{sum(b.size for b in plan.buckets)} elements, f32 comm) and {cfg.n_layers} "
        f"in-backward slots ({len(slot_bucket.leaves)} leaves, {slot_bucket.size} elements, "
        f"{slot_dtype}); one pack and one unpack launch each")

    out = {"post_backward": time_staging([(b, flat) for b in plan.buckets], f32),
           "slots": time_staging([(slot_bucket, r) for r in rows], slot_dtype),
           "max_abs_err": err, "checks": n_checks}
    log("[lm_kernels] " + json.dumps(out))
    return out


def lm_profile(ts, model, opt_state, pipe, wall_ms: float, step: int = LM_STEPS) -> dict:
    """One more step (``step``) under torch.profiler: the device time of its kernels
    (device events other than the ``step.*``/``comm.*`` annotations)
    against ``wall_ms`` (the mean wall time of the timed steps without the
    profiler) gives the device idle share; and the kernels that take the
    most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = pipe.batch_at(step)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ts.fn(model, opt_state, batch, step)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if getattr(e, "device_type", None) == DeviceType.CUDA
               and not e.name.startswith(("step.", "comm."))]
    if not kernels:
        raise AssertionError("the profiler saw no device time in the step")
    kernel_ms = sum(k.time_range.elapsed_us() for k in kernels) / 1e3
    by_name: dict = {}
    for k in kernels:
        calls, ms = by_name.get(k.name, (0, 0.0))
        by_name[k.name] = (calls + 1, ms + k.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)[:12]
    return {
        "wall_ms_unprofiled": wall_ms, "wall_ms_under_profiler": profiled_ms,
        "kernel_ms_summed": kernel_ms, "device_kernels": len(kernels),
        "idle_share": 1 - kernel_ms / wall_ms,
        "top_kernels": [{"name": n[:90], "calls": c, "ms": ms} for n, (c, ms) in top],
        "staging_kernels": [{"name": n[:90], "calls": c, "ms": ms}
                            for n, (c, ms) in by_name.items() if "_bucket_kernel<" in n]}


def lm_stage_spans(ts, model, opt_state, pipe, step: int = LM_STEPS + 1) -> dict:
    """One more step (``step``), unprofiled, with a CUDA event recorded on the
    current stream at the entry and the exit of each ``step.*`` label of
    the train loop: each stage's span on the device (ms), which holds its
    kernels and the device's idle gaps between them.  The backward's
    kernels are launched from autograd's engine thread, but on the same
    stream, and ``loss.backward()`` returns only once they are all
    enqueued, so the label's events bracket them; GradSync's chain streams
    are joined to the current stream before its label ends."""
    from repro_torch.runtime import train_loop

    real, marks = train_loop.record_function, []

    @contextlib.contextmanager
    def marked(name):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        with real(name):
            yield
        end.record()
        marks.append((name, start, end))

    batch = pipe.batch_at(step)
    torch.cuda.synchronize()
    train_loop.record_function = marked
    try:
        t0 = time.perf_counter()
        ts.fn(model, opt_state, batch, step)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        train_loop.record_function = real
    spans = {name: start.elapsed_time(end) for name, start, end in marks}
    return {"wall_ms": wall_ms, "stage_ms": spans,
            "first_to_last_event_ms": marks[0][1].elapsed_time(marks[-1][2]),
            "stages_in_order": [name for name, _, _ in marks]}


def lm_run(strat: str, mesh, pipe, after=None) -> dict:
    """One strategy's run of Qwen3-1.7B from the seeded weights: AdamW
    (cosine warm-up), clip 1.0, 1 warm-up + ``LM_STEPS`` - 1 timed steps
    over ``pipe``.  Pack and unpack must launch exactly the schedule's
    buckets (plus one slot a layer under depcha) a step, and depcha must
    issue one in-backward collective a layer a step, the others none.
    ``after(ts, model, opt_state, run)`` runs before the run's state is
    freed; its result is kept under "after"."""
    from repro_torch.core import GradSyncConfig
    from repro_torch.kernels.collectives import kernel
    from repro_torch.models.transformer import Transformer, init_params
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.runtime import Trainer, make_train_step
    from repro_torch.utils.trees import flatten_with_names

    cfg = lm_config(strat)
    model = Transformer(cfg, init_params(cfg, seed=0, device="cuda"))
    opt = adamw(cosine_warmup(3e-4, 10, 100))
    ts = make_train_step(cfg, mesh, GradSyncConfig(strategy=strat), opt, model=model,
                         clip_norm=1.0, device="cuda")
    opt_state = opt.init(dict(flatten_with_names(model.params_tree())[0]))
    trainer = Trainer(ts, pipe, log_every=10 ** 9, printer=lambda _m: None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel.PACK_LAUNCHES = kernel.UNPACK_LAUNCHES = 0
    collectives, losses = [], []
    for step in range(LM_STEPS):
        model, opt_state, hist = trainer.run(model, opt_state, step + 1, start_step=step)
        losses.append(hist["losses"][-1])
        collectives.append(ts.layer_sync.collectives if ts.layer_sync is not None else 0)
    launches = {"pack": kernel.PACK_LAUNCHES, "unpack": kernel.UNPACK_LAUNCHES}
    per_step = len(ts.gradsync.schedule.ops) + (
        cfg.n_layers if ts.layer_sync is not None else 0)
    if launches != {"pack": per_step * LM_STEPS, "unpack": per_step * LM_STEPS}:
        raise AssertionError(f"lm {strat}: launches {launches}, expected "
                             f"{per_step} a step x {LM_STEPS}")
    want = cfg.n_layers if strat == "depcha" else 0
    if collectives != [want] * LM_STEPS:
        raise AssertionError(f"lm {strat}: in-backward collectives {collectives}, "
                             f"expected {want} a step")
    times = trainer.step_times
    run = {"losses": losses, "first_step_ms": trainer.first_step_time * 1e3,
           "step_ms": [t * 1e3 for t in times],
           "tokens_per_s": [pipe.global_batch * LM_SEQ / t for t in times],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "launches_per_step": per_step,
           "buckets": len(ts.gradsync.schedule.ops),
           "in_backward_collectives_per_step": collectives}
    if after is not None:
        run["after"] = after(ts, model, opt_state, run)
    del ts, model, opt_state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return run


def phase_lm_train() -> dict:
    """Qwen3-1.7B at full width on a one-rank NCCL group, seq 1024 x batch
    4, under funnel, concom and depcha (in-scan): ``lm_run`` each, under
    torch.use_deterministic_algorithms (restored after).  The losses must
    be bit-identical across the strategies.  Then one more depcha step
    under the profiler and one with CUDA events around its stages."""
    import warnings

    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import make_dp_mesh

    def profiled(ts, model, opt_state, run):
        out = lm_profile(ts, model, opt_state, pipe, sum(run["step_ms"]) / len(run["step_ms"]))
        out["stages"] = lm_stage_spans(ts, model, opt_state, pipe)
        return out

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_dp_mesh()
    pipe = TokenPipeline(lm_config().vocab, LM_SEQ, LM_BATCH, seed=0, mesh=mesh,
                         device="cuda")
    runs = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for strat in STRATEGIES:
                runs[strat] = lm_run(strat, mesh, pipe,
                                     after=profiled if strat == "depcha" else None)
                log(f"[lm_train] {strat}: " + json.dumps(
                    {k: v for k, v in runs[strat].items() if k != "after"}))
        finally:
            torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    profile_out = runs["depcha"].pop("after")
    nondeterministic = sorted({str(w.message)[:200] for w in caught
                               if "deterministic" in str(w.message)})
    base = runs[STRATEGIES[0]]["losses"]
    for strat, r in runs.items():
        if not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"lm {strat}: non-finite loss {r['losses']}")
        if r["peak_gb"] >= 80:
            raise AssertionError(f"lm {strat}: peak {r['peak_gb']} GB")
        if nondeterministic:         # named below; later steps to rtol 1e-3
            if r["losses"][0] != base[0] or any(
                    abs(a - b) > 1e-3 * abs(b) for a, b in zip(r["losses"], base)):
                raise AssertionError(f"lm {strat} losses {r['losses']} vs {base}")
        elif r["losses"] != base:
            raise AssertionError(f"lm {strat} losses {r['losses']} are not bit-identical "
                                 f"to {STRATEGIES[0]}'s {base}")
    out = {"runs": runs, "profile": profile_out, "nondeterministic_ops": nondeterministic,
           "losses_bit_identical": not nondeterministic,
           "launches": {k: sum(r["launches"][k] for r in runs.values())
                        for k in ("pack", "unpack")},
           "shape": {"seq": LM_SEQ, "global_batch": LM_BATCH, "layers": lm_config().n_layers}}
    log("[lm_train] " + json.dumps({k: v for k, v in out.items() if k != "runs"}))
    return out


LM_CARD_TURNS = ("funnel", "concom", "depcha", "depcha", "concom", "funnel")


def _lm_card_rank(rank: int, workdir: str, backend: str) -> None:
    """One rank of ``phase_lm_cards``: Qwen3-1.7B at full width, seq 1024 x
    batch 4 a rank, each strategy of ``LM_CARD_TURNS`` in turn through
    ``lm_run``, then a step with CUDA events around its stages; params
    bit-identical across the ranks after every run (rank 0's broadcast on
    the default group and compared on the card)."""
    import datetime

    import torch.distributed as dist

    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import init_dist, make_dp_mesh
    from repro_torch.utils.trees import flatten_with_names

    world = torch.cuda.device_count()
    init_dist("cuda", backend=backend, init_method=f"file://{workdir}/store", rank=rank,
              world_size=world, timeout=datetime.timedelta(seconds=300))
    torch.backends.cuda.matmul.allow_tf32 = False
    say = log if rank == 0 else (lambda _m: None)
    mesh = make_dp_mesh()
    pipe = TokenPipeline(lm_config().vocab, LM_SEQ, LM_BATCH * world, seed=0, mesh=mesh,
                         rank=rank, device="cuda")

    def checked(ts, model, opt_state, run):
        mine = torch.cat([p.detach().reshape(-1) for _, p in
                          flatten_with_names(model.params_tree())[0]])
        theirs = mine.clone()
        dist.broadcast(theirs, 0)        # a copy: rank 0's bits, bf16 as they are
        ok = torch.tensor([int(torch.equal(mine.view(torch.int16), theirs.view(torch.int16)))],
                          device="cuda")
        dist.all_reduce(ok, op=dist.ReduceOp.MIN)
        if not ok.item():
            raise AssertionError("lm params are not bit-identical across the ranks")
        del mine, theirs
        return lm_stage_spans(ts, model, opt_state, pipe)

    out = []
    for strat in LM_CARD_TURNS:
        run = lm_run(strat, mesh, pipe, after=checked)
        out.append({"strategy": strat, **run})
        say(f"[lm_cards] {strat}: " + json.dumps(out[-1]))
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def phase_lm_cards(backend: str = "nccl") -> list:
    """By hand, on a host of several cards (four H100s of one host): one rank
    a card, Qwen3-1.7B data-parallel at seq 1024 x batch 4 a rank (global
    batch 4 x cards), funnel / concom / depcha (in-scan) in turns (funnel,
    concom, depcha, depcha, concom, funnel), 1 warm-up + 2 timed steps
    each and a step with its stages timed by CUDA events: whether depcha's
    in-backward collectives hide behind the backward shows in the step
    time and in what is left to ``step.depcha_wait`` against funnel's
    ``step.gradsync``."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="lm-cards-") as wd:
        mp.spawn(_lm_card_rank, args=(wd, backend), nprocs=torch.cuda.device_count(),
                 join=True)
        with open(os.path.join(wd, "rank0.json")) as f:
            res = json.load(f)
    log("[lm_cards] " + json.dumps(res))
    return res


def phase_lm_cpu_vs_gpu() -> None:
    """The quickstart LM's widths (4 layers, d 128, 8/4 heads, ff 256,
    vocab 512, f32, attn_chunk 64), 3 steps of depcha in-scan from the
    same weights and batches on the CPU (plain versions) and on the card
    (kernels), TF32 off: losses within rtol 1e-5."""
    from repro_torch.core import GradSyncConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import make_dp_mesh
    from repro_torch.models.transformer import Transformer, TransformerConfig, init_params
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.runtime import Trainer, make_train_step
    from repro_torch.utils.trees import flatten_with_names

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TransformerConfig(name="quickstart-lm", n_layers=4, d_model=128, n_heads=8,
                            kv_heads=4, d_ff=256, vocab=512, tp=1, attn_chunk=64,
                            dtype=torch.float32, depcha_in_scan=True)
    weights = init_params(cfg, seed=0, device="cpu")
    mesh = make_dp_mesh()
    final = {}
    for device in ("cpu", "cuda"):
        model = Transformer(cfg, tree_to(copy.deepcopy(weights), device))   # trained in place
        opt = adamw(cosine_warmup(1e-3, 20, 200))
        ts = make_train_step(cfg, mesh, GradSyncConfig(strategy="depcha"), opt,
                             model=model, clip_norm=1.0, device=device)
        pipe = TokenPipeline(cfg.vocab, 64, 8, seed=0, mesh=mesh, device=device)
        params = dict(flatten_with_names(model.params_tree())[0])
        _, _, hist = Trainer(ts, pipe, log_every=10 ** 9, printer=lambda _m: None).run(
            model, opt.init(params), 3)
        final[device] = ({n: p.detach().cpu() for n, p in params.items()}, hist["losses"],
                         ts.layer_sync.collectives)
    (p_cpu, l_cpu, c_cpu), (p_gpu, l_gpu, c_gpu) = final["cpu"], final["cuda"]
    for a, b in zip(l_gpu, l_cpu):
        if abs(a - b) > 1e-5 * abs(b):
            raise AssertionError(f"lm_cpu_vs_gpu: losses gpu {l_gpu} cpu {l_cpu} beyond rtol 1e-5")
    if c_cpu != c_gpu or c_gpu != cfg.n_layers:
        raise AssertionError(f"lm_cpu_vs_gpu: in-backward collectives in the last step: "
                             f"cpu {c_cpu}, gpu {c_gpu}")
    worst = max((p_gpu[n] - p).abs().max().item() for n, p in p_cpu.items())
    log(f"[lm_cpu_vs_gpu] losses cpu {l_cpu} gpu {l_gpu} (rtol 1e-5); {c_gpu} in-backward "
        f"collectives in the last step on each; max param diff after 3 steps {worst} "
        f"(reported)")


# ------------------------------------------------------- Inception-BN / ImageNet

INCEPTION_BATCH = 256          # the arch's training shape: global batch 256 at 224x224
INCEPTION_STEPS = 3            # 1 warm-up + 2 timed


def inception_plan():
    """Inception-BN's bucket plan at full width as GradSync builds it (4 MiB
    buckets, 4 channels, f32 comm) and its named leaves, on ``meta``."""
    from repro_torch.configs.inception_bn_imagenet import make_config
    from repro_torch.core import make_bucket_plan
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.resnet import init_inception, param_specs
    from repro_torch.utils.trees import flatten_with_names

    params = init_inception(make_config(), device="meta")
    plan = make_bucket_plan(params, param_specs(params), make_smoke_mesh(1),
                            bucket_bytes=4 * 1024 * 1024, num_channels=4)
    return plan, flatten_with_names(params)[0]


def staging_launches(bucket) -> int:
    """Launches of one pack (or one unpack) of ``bucket``: one a group of
    at most ``MAX_LEAVES`` leaves of one dtype."""
    from repro_torch.kernels.collectives.kernel import MAX_LEAVES

    per_dtype: dict = {}
    for l in bucket.leaves:
        per_dtype[l.dtype] = per_dtype.get(l.dtype, 0) + 1
    return sum(-(-n // MAX_LEAVES) for n in per_dtype.values())


def phase_inception_kernels() -> dict:
    """Rows 1-2 at Inception-BN's layouts, bit for bit against their plain
    versions: every bucket of the full-width plan (f32 leaves; f32 and bf16
    comm; scale 1 and 4, so unpack at 1 and 1/4), the pack into a buffer
    started as NaN, the unpack into outputs started as NaN, with the
    launches each bucket takes.  Then a step's worth of each (f32 comm,
    scale 1: the main path) timed back to back with CUDA events in turns
    with ``torch.cat`` / ``torch._foreach_copy_``, on the device by
    torch.profiler, beside the plain version and the byte bound."""
    from repro_torch.kernels.collectives import kernel

    plan, named = inception_plan()
    gen = torch.Generator(device="cuda").manual_seed(0)
    flat = [torch.randn(p.shape, generator=gen, device="cuda") for _, p in named]
    err, n_checks = 0.0, 0
    for comm in (torch.float32, torch.bfloat16):
        for scale in (1.0, 4.0):
            for b in plan.buckets:
                before = (kernel.PACK_LAUNCHES, kernel.UNPACK_LAUNCHES)
                err = max(err, check_bucket(b, flat, comm, scale))
                want = staging_launches(b)
                if (kernel.PACK_LAUNCHES - before[0],
                        kernel.UNPACK_LAUNCHES - before[1]) != (want, want):
                    raise AssertionError(f"inception bucket {b.bucket_id}: expected {want} "
                                         f"pack and {want} unpack launches")
                n_checks += 1
    torch.cuda.synchronize()
    layout = [{"bucket": b.bucket_id, "leaves": len(b.leaves), "elements": b.size,
               "launches": staging_launches(b)} for b in plan.buckets]
    log(f"[inception_kernels] {n_checks} checks bit-exact (max abs err {err}): "
        f"{len(plan.buckets)} buckets, {plan.num_leaves} f32 leaves, "
        f"{sum(b.size for b in plan.buckets)} elements: {json.dumps(layout)}")
    out = time_staging([(b, flat) for b in plan.buckets], torch.float32)
    out.update(max_abs_err=err, checks=n_checks, buckets=layout)
    log("[inception_kernels] " + json.dumps(out))
    return out


def phase_inception() -> dict:
    """Inception-BN at full width (width 1.0, 224x224, 1000 classes,
    random seeded weights) on a one-rank NCCL group, global batch 256, SGD
    with momentum 0.9, clip 1.0, TF32 off and deterministic cuDNN: funnel,
    concom and depcha through ``Trainer`` with a ``MetricsRegistry``, 1
    warm-up + 2 timed steps each.  Losses finite and equal across the
    strategies (rtol 1e-5); pack and unpack launches exactly the plan's a
    step; the ``comm_bytes.*`` counters the schedule's bytes.  Reports step
    ms, images/s, peak memory and the host ms of one ``batch_at``; then one
    more depcha step under torch.profiler (device idle share, the kernels
    that take the most) and one with CUDA events at each step stage."""
    from repro_torch.configs.inception_bn_imagenet import make_config
    from repro_torch.core import GradSyncConfig
    from repro_torch.data import ImagePipeline
    from repro_torch.kernels.collectives import kernel
    from repro_torch.launch.mesh import make_dp_mesh
    from repro_torch.models.resnet import Inception, init_inception
    from repro_torch.obs import MetricsRegistry
    from repro_torch.optim import linear_scaling_rule, sgd
    from repro_torch.runtime import Trainer, make_train_step
    from repro_torch.utils.trees import flatten_with_names

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = make_config()
    mesh = make_dp_mesh()
    pipe = ImagePipeline(cfg.img_size, cfg.num_classes, INCEPTION_BATCH, seed=0, mesh=mesh,
                         device="cuda")
    batch_ms = []
    for step in range(2):
        t0 = time.perf_counter()
        pipe.batch_at(step)
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    lr = linear_scaling_rule(0.1, 256, 256)
    runs, live, expected = {}, None, 0
    kernel.PACK_LAUNCHES = kernel.UNPACK_LAUNCHES = 0
    for strat in STRATEGIES:
        model = Inception(cfg, init_inception(cfg, seed=0, device="cuda"))
        opt = sgd(lr, momentum=0.9)
        ts = make_train_step(cfg, mesh, GradSyncConfig(strategy=strat), opt, model=model,
                             clip_norm=1.0, device="cuda")
        params = dict(flatten_with_names(model.params_tree())[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(ts, pipe, log_every=10 ** 9, printer=lambda _m: None,
                          metrics=MetricsRegistry())
        model, opt_state, hist = trainer.run(model, opt.init(params), INCEPTION_STEPS)
        ops = ts.gradsync.schedule.ops
        per_step = sum(staging_launches(op.bucket) for op in ops)
        expected += per_step * INCEPTION_STEPS
        snap = hist["metrics"]
        comm_bytes = {k: v for k, v in snap.items() if k.startswith("comm_bytes.")}
        want_bytes = ts.gradsync.schedule.comm_bytes(4)
        if comm_bytes != {"comm_bytes.allreduce.default.post": want_bytes}:
            raise AssertionError(f"inception {strat}: comm byte counters {comm_bytes}, "
                                 f"the schedule moves {want_bytes} bytes a step")
        st = ts.gradsync.schedule.stats()
        runs[strat] = {
            "losses": hist["losses"], "first_step_ms": hist["compile_time"] * 1e3,
            "step_ms": [t * 1e3 for t in hist["step_times"]],
            "images_per_s": [INCEPTION_BATCH / t for t in hist["step_times"]],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "buckets": len(ops), "chains": st["num_chains"],
            "launches_per_step": per_step, "comm_bytes": comm_bytes,
            "metrics": {k: snap[k] for k in ("steps_total", "mem.state_bytes",
                                              "compile_time_s", "loss", "grad_norm",
                                              "step_time_s")}}
        log(f"[inception] {strat}: " + json.dumps(runs[strat]))
        live = (ts, model, opt_state)
    launches = {"pack": kernel.PACK_LAUNCHES, "unpack": kernel.UNPACK_LAUNCHES}
    if launches != {"pack": expected, "unpack": expected}:
        raise AssertionError(f"inception launch counters {launches}, expected {expected} "
                             f"each (the plans' launches x {INCEPTION_STEPS} steps x "
                             f"{len(STRATEGIES)} strategies)")
    base = runs[STRATEGIES[0]]["losses"]
    for strat, r in runs.items():
        if not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"inception {strat}: non-finite loss {r['losses']}")
        if any(abs(a - b) > 1e-5 * abs(b) for a, b in zip(r["losses"], base)):
            raise AssertionError(f"inception {strat} losses {r['losses']} differ from "
                                 f"{STRATEGIES[0]}'s {base} beyond rtol 1e-5")
    ts, model, opt_state = live
    step_ms = runs[STRATEGIES[-1]]["step_ms"]
    prof = lm_profile(ts, model, opt_state, pipe, sum(step_ms) / len(step_ms),
                      step=INCEPTION_STEPS)
    prof["stages"] = lm_stage_spans(ts, model, opt_state, pipe, step=INCEPTION_STEPS + 1)
    out = {"runs": runs, "launches": launches, "batch_at_host_ms": batch_ms,
           "profile": prof, "shape": {"global_batch": INCEPTION_BATCH,
                                      "img_size": cfg.img_size, "classes": cfg.num_classes,
                                      "width_mult": cfg.width_mult}}
    log("[inception] " + json.dumps({k: v for k, v in out.items() if k != "runs"}))
    del live, ts, model, opt_state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_inception_cpu_vs_gpu() -> None:
    """Inception-BN's smoke config (width 0.25, 32x32, 10 classes), 3 steps
    of depcha from the same weights and batches (global batch 8) on the
    CPU (plain versions) and on the card (kernels), TF32 off: losses within
    rtol 1e-5."""
    from repro_torch.configs.inception_bn_imagenet import make_smoke
    from repro_torch.core import GradSyncConfig
    from repro_torch.data import ImagePipeline
    from repro_torch.launch.mesh import make_dp_mesh
    from repro_torch.models.resnet import Inception, init_inception
    from repro_torch.optim import linear_scaling_rule, sgd
    from repro_torch.runtime import Trainer, make_train_step
    from repro_torch.utils.trees import flatten_with_names

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = make_smoke()
    mesh = make_dp_mesh()
    final = {}
    for device in ("cpu", "cuda"):
        model = Inception(cfg, init_inception(cfg, seed=0, device=device))
        opt = sgd(linear_scaling_rule(0.1, 256, 256), momentum=0.9)
        ts = make_train_step(cfg, mesh, GradSyncConfig(strategy="depcha"), opt,
                             model=model, clip_norm=1.0, device=device)
        pipe = ImagePipeline(cfg.img_size, cfg.num_classes, 8, seed=0, mesh=mesh,
                             device=device)
        params = dict(flatten_with_names(model.params_tree())[0])
        _, _, hist = Trainer(ts, pipe, log_every=10 ** 9, printer=lambda _m: None).run(
            model, opt.init(params), 3)
        final[device] = ({n: p.detach().cpu() for n, p in params.items()}, hist["losses"])
    (p_cpu, l_cpu), (p_gpu, l_gpu) = final["cpu"], final["cuda"]
    for a, b in zip(l_gpu, l_cpu):
        if abs(a - b) > 1e-5 * abs(b):
            raise AssertionError(f"inception_cpu_vs_gpu: losses gpu {l_gpu} cpu {l_cpu} "
                                 f"beyond rtol 1e-5")
    worst = max((p_gpu[n] - p).abs().max().item() for n, p in p_cpu.items())
    log(f"[inception_cpu_vs_gpu] losses cpu {l_cpu} gpu {l_gpu} (rtol 1e-5); max param "
        f"diff after 3 steps {worst} (reported)")


def phase_verify() -> dict:
    """The six analysis passes that ``GradSync`` now runs while planning,
    timed on the host (median of 5): ``plan_sync`` without and with them,
    and ``verify_schedule`` alone, for ResNet-50 (concom, 24 buckets),
    Qwen3-1.7B (depcha in-scan) and Inception-BN (concom), on the one-rank
    mesh of the main path and on an 8-rank stand-in (the spmd pass
    simulates every rank).  Then the port analyzer's cross-product: its
    summary, and no planned cell with a finding."""
    from repro_torch.analysis import verify_schedule
    from repro_torch.analysis.cli import iter_cells, lint_cell, static_mesh, summarize
    from repro_torch.configs.inception_bn_imagenet import make_config as inception_config
    from repro_torch.configs.resnet50_cifar import make_config as resnet_config
    from repro_torch.core import GradSyncConfig, plan_sync
    from repro_torch.models import resnet, transformer

    def median_ms(fn, reps=5):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return sorted(ts)[reps // 2]

    r50 = resnet.init_params(resnet_config(), device="meta")
    inc = resnet.init_inception(inception_config(), device="meta")
    lm_cfg = lm_config("depcha")
    lm = transformer.init_params(lm_cfg, device="meta")
    cases = {
        "resnet50-cifar concom": (r50, resnet.param_specs(r50), "concom", frozenset()),
        "qwen3-1.7b depcha in-scan": (lm, transformer.param_specs(lm, lm_cfg), "depcha",
                                      transformer.in_scan_param_names(lm)),
        "inception-bn-imagenet concom": (inc, resnet.param_specs(inc), "concom",
                                         frozenset()),
    }
    out = {}
    for name, (params, specs, strat, names) in cases.items():
        for ranks in (1, 8):
            mesh = static_mesh({"data": ranks, "model": 1})
            row = {}
            for verify in (False, True):
                cfg = GradSyncConfig(strategy=strat, verify=verify)
                row[f"plan_ms_verify_{verify}"] = median_ms(
                    lambda: plan_sync(cfg, mesh, specs, params, in_scan_names=names))
            planned = plan_sync(GradSyncConfig(strategy=strat), mesh, specs, params,
                                in_scan_names=names)
            row["verify_schedule_ms"] = median_ms(lambda: verify_schedule(
                planned.schedule, mesh_shape=planned.mesh_shape, default_reducer="flat",
                plan_comm_dtype=torch.float32, expect_defer=False))
            row["ops"] = len(planned.schedule.ops)
            out[f"{name}, {ranks} rank(s)"] = row
    t0 = time.perf_counter()
    summary = summarize([lint_cell(*c) for c in iter_cells()])
    summary["host_s"] = time.perf_counter() - t0
    if summary["errors"] or summary["planned"] == 0:
        raise AssertionError(f"analyzer: {summary}")
    out["analyzer"] = summary
    log("[verify] " + json.dumps(out))
    return out


# ------------------------------------------------- ring and int8 kernels

ACCUM_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
RING = 4                       # ranks of the reducers phase, on one card
QBLOCK = 256                   # elements a quantization block
REDUCER_RUNS = (("funnel", "flat"), ("funnel", "ring"), ("funnel", "compressed"),
                ("funnel", "compressed_ring"), ("concom", "ring"), ("rsag", "ring"))
REDUCER_STEPS = 3              # 1 warm-up + 2 timed
RING_QUANT_SOURCES = {
    "ring_accum_kernel": "src/repro_torch/kernels/collectives/csrc/ring_accum.cu",
    "quantize_blocks_kernel": "src/repro_torch/kernels/quantize/csrc/quantize.cu",
    "dequantize_blocks_kernel": "src/repro_torch/kernels/quantize/csrc/quantize.cu",
    "dequantize_sum_blocks_kernel": "src/repro_torch/kernels/quantize/csrc/quantize.cu",
    "dequantize_sum_quantize_blocks_kernel":
        "src/repro_torch/kernels/quantize/csrc/quantize.cu"}
RING_QUANT_REPLACES = {
    "ring_accum_kernel": "src/repro/kernels/collectives/kernel.py:117",
    "quantize_blocks_kernel": "src/repro/kernels/quantize/kernel.py:33",
    "dequantize_blocks_kernel": "src/repro/kernels/quantize/kernel.py:54",
    # the dequantize's second entry: phase 2 of src/repro/core/compression.py:79-83
    "dequantize_sum_blocks_kernel": "src/repro/kernels/quantize/kernel.py:54",
    # the quantize's second entry: phases 2 and 3 of src/repro/core/compression.py:79-89
    "dequantize_sum_quantize_blocks_kernel": "src/repro/kernels/quantize/kernel.py:33"}
QUANTIZE_LIBRARY = "none: no single PyTorch call computes an int8 block quantization"
PEER_SUM_LIBRARY = ("none: no single PyTorch call dequantizes and sums the peers' shards; "
                    "composite_ms times torch.mul over the g shards + g - 1 torch.add")
SUM_QUANTIZE_LIBRARY = ("none: no single PyTorch call dequantizes, sums and requantizes "
                        "the peers' shards")


def ring_halves(size: int) -> tuple[int, int]:
    """The two half-chunks a bidirectional ring of ``RING`` combines for a
    bucket of ``size`` elements (padded to a multiple of ``RING``)."""
    c = -(-size // RING)
    return c // 2, c - c // 2


def padded(size: int) -> int:
    """A bucket's buffer as the compressed reducer pads it (256 · RING)."""
    return -(-size // (QBLOCK * RING)) * QBLOCK * RING


def step_launches(sizes, reducer: str) -> dict:
    """Kernel launches of one training step on one rank, from the plan's
    bucket sizes: a ring reduce-scatter (the ring reducer's, or rsag's)
    combines once a hop, both directions in one launch, over RING - 1
    hops; the compressed reducers, for each bucket of at least 256 · RING
    elements, quantize the unpadded bucket once (phase 1), sum the peers'
    shards and requantize the sum in one launch (phases 2-3) and
    dequantize once (after the gather); the peer sum alone never runs."""
    accum = (RING - 1) * len(sizes) if reducer == "ring" else 0
    big = (sum(n >= QBLOCK * RING for n in sizes)
           if reducer.startswith("compressed") else 0)
    return {"accum": accum, "quantize": big, "sum_quantize": big, "dequantize": big,
            "dequantize_sum": 0}


def tie_blocks() -> torch.Tensor:
    """An all-zero block, then blocks of scale 1 and 2 whose x/scale lands
    on exact .5 ties, then blocks at magnitudes 1e-3, 1 and 1e3."""
    ties1 = torch.arange(-127, 129, dtype=torch.float32).clamp(max=126) + 0.5
    ties1[0] = 127.0                                   # amax 127: scale 1
    ties2 = 2 * (torch.arange(256, dtype=torch.float32) % 254 - 127) + 1
    ties2[0] = -254.0                                  # amax 254: scale 2
    gen = torch.Generator().manual_seed(3)
    mags = [torch.randn(256, generator=gen) * m for m in (1e-3, 1.0, 1e3)]
    return torch.stack([torch.zeros(256), ties1, ties2, *mags]).cuda()


def check_quantize(x: torch.Tensor, what: str) -> None:
    """Kernel against plain version, bit for bit: q, scales, dequantized
    (into an output started as NaN)."""
    from repro_torch.kernels.quantize import kernel, ref

    xb = x.reshape(-1, QBLOCK)
    q, s = kernel.quantize_blocks_kernel(x.reshape(-1))
    q = q.view(-1, QBLOCK)
    q_p, s_p = ref.quantize_ref(xb)
    same_bits(q, q_p, f"quantize {what}: q")
    same_bits(s, s_p, f"quantize {what}: scales")
    nan = torch.full(xb.shape, float("nan"), device="cuda")
    same_bits(kernel.dequantize_blocks_kernel(q, s, out=nan), ref.dequantize_ref(q, s),
              f"dequantize {what}")


def peer_shards(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` (g, k·256) f32, one row a peer, quantized as the peers do:
    (q (g, k·256) int8, s (g, k) f32), as phase 2 receives them."""
    from repro_torch.kernels.quantize import kernel

    q, s = kernel.quantize_blocks_kernel(x.reshape(-1))
    return q.view(x.shape[0], -1), s.view(x.shape[0], -1)


def check_peer_sum(x: torch.Tensor, what: str) -> None:
    """The peer-sum entry against its plain version on the peers' shards
    of ``x`` (g, k·256), bit for bit, into an output started as NaN."""
    from repro_torch.kernels.quantize import kernel, ref

    q, s = peer_shards(x)
    nan = torch.full((q.shape[1],), float("nan"), device="cuda")
    before = kernel.DEQUANTIZE_SUM_LAUNCHES
    got = kernel.dequantize_sum_blocks_kernel(q, s, out=nan)
    if kernel.DEQUANTIZE_SUM_LAUNCHES != before + 1:
        raise AssertionError("dequantize_sum_blocks_kernel: expected one launch a call")
    same_bits(got, ref.dequantize_sum_ref(q, s), f"peer sum {what}")


def nan_tail(n: int, gen, scale: float = 1.0) -> torch.Tensor:
    """(n,) f32 random values, a view of a longer tensor whose elements
    past n are NaN: a kernel that uses one of them makes a NaN scale."""
    x = torch.full((n + 64,), float("nan"), device="cuda")
    x[:n] = torch.randn(n, generator=gen, device="cuda") * scale
    if n >= QBLOCK:
        x[:QBLOCK] = 0.0                              # a zero block
    return x[:n]


def check_unpadded_quantize(buf: torch.Tensor, m: int, what: str) -> None:
    """The quantize of ``buf`` (n,) read as zero-padded to m elements, as
    phase 1 runs it, against the plain version of
    the zero-padded buffer, bit for bit, into outputs started as poison
    (q 0x7f, scales NaN); one launch a call."""
    from repro_torch.kernels.quantize import kernel, ref

    q = torch.full((m,), 0x7f, dtype=torch.int8, device="cuda")
    s = torch.full((m // QBLOCK,), float("nan"), device="cuda")
    before = kernel.QUANTIZE_LAUNCHES
    kernel.quantize_blocks_kernel(buf, n_blocks=m // QBLOCK, q_out=q, s_out=s)
    if kernel.QUANTIZE_LAUNCHES != before + 1:
        raise AssertionError("quantize_blocks_kernel: expected one launch a call")
    q_p, s_p = ref.quantize_ref(ref.zero_padded(buf, m).view(-1, QBLOCK))
    same_bits(q, q_p.reshape(-1), f"unpadded quantize {what}: q")
    same_bits(s, s_p, f"unpadded quantize {what}: scales")


def check_sum_quantize(x: torch.Tensor, what: str) -> None:
    """The fused sum-requantize against its plain version (the peer sum,
    then the quantize) on the peers' shards of ``x`` (g, k·256), bit for
    bit, into outputs started as poison (q 0x7f, scales NaN); one launch
    a call."""
    from repro_torch.kernels.quantize import kernel, ref

    q, s = peer_shards(x)
    k = s.shape[1]
    q2 = torch.full((k * QBLOCK,), 0x7f, dtype=torch.int8, device="cuda")
    s2 = torch.full((k,), float("nan"), device="cuda")
    before = kernel.SUM_QUANTIZE_LAUNCHES
    kernel.dequantize_sum_quantize_blocks_kernel(q, s, q_out=q2, s_out=s2)
    if kernel.SUM_QUANTIZE_LAUNCHES != before + 1:
        raise AssertionError("dequantize_sum_quantize_blocks_kernel: expected one launch "
                             "a call")
    q_p, s_p = ref.dequantize_sum_quantize_ref(q, s)
    same_bits(q2, q_p, f"sum-requantize {what}: q")
    same_bits(s2, s_p, f"sum-requantize {what}: scales")


def phase_ring_quant() -> dict:
    """Rows 3, 6 and 7 against their plain versions on the card, bit for
    bit, then each timed over one training step's launches on one rank of
    a ring of 4 (CUDA events back to back, and the device's own time from
    torch.profiler) beside its byte bound and one PyTorch call; the
    main path's quantize work a step and the peer-sum path's dequantize work a step, each in
    turns against the composition it replaced."""
    from repro_torch.kernels.collectives import kernel as ck
    from repro_torch.kernels.collectives import ref as cr
    from repro_torch.kernels.quantize import kernel as qk
    from repro_torch.kernels.quantize import ref as qr

    plan, _ = resnet50_plan()
    sizes = [b.size for b in plan.buckets]
    gen = torch.Generator(device="cuda").manual_seed(7)
    halves = sorted({h for n in sizes for h in ring_halves(n)})
    lengths = [100, 4 * 1024, 131071, *halves]        # test_collectives.py:141, odd, buckets
    n_checks = 0
    for dt in ACCUM_DTYPES:
        for n in lengths:
            for off in (0, 1):                        # aligned, and not 16-byte aligned
                a, b = (torch.randn(n + off, generator=gen, device="cuda").to(dt)[off:]
                        for _ in range(2))
                want = cr.ring_accum_ref(a, b)
                same_bits(ck.ring_accum_kernel(a, b), want, f"accum {dt} n={n} +{off}")
                same_bits(ck.ring_accum_kernel(a.clone(), b, out=a.clone()), want,
                          f"accum {dt} n={n} +{off}")
                inplace = a.clone()
                ck.ring_accum_kernel(inplace, b, out=inplace)
                same_bits(inplace, want, f"accum in place {dt} n={n} +{off}")
                n_checks += 1
    log(f"[ring_quant] ring_accum_kernel bit-exact with torch.add in {n_checks} "
        f"cases: f32/bf16/f16, lengths {lengths[:3]} and the {len(halves)} "
        f"half-chunk lengths of the 24 ResNet-50 buckets at g = {RING}, "
        f"aligned and misaligned, into a new tensor and in place")
    n_checks = check_accum_pairs(sizes, gen)
    log(f"[ring_quant] ring_accum_pairs_kernel bit-exact with torch.add in {n_checks} "
        f"launches (one each): f32/bf16/f16, each bucket's two half-chunk pairs as "
        f"a ring of {RING} forms them (own chunks the rows of x2d[:, :h] and "
        f"x2d[:, h:]), an empty second half (c = 1: one pair), and 8 pairs")
    n_checks = 0
    for i, n in enumerate(sizes):
        m = padded(n)
        mag = (1e-3, 1.0, 1e3)[i % 3]
        for what, k in (("bucket", m), ("shard", m // RING)):
            x = torch.randn(k, generator=gen, device="cuda") * mag
            x[:QBLOCK] = 0.0                          # a zero block in every buffer
            check_quantize(x, f"b{i} {what} {k}")
            n_checks += 1
    check_quantize(tie_blocks(), "ties, zero and magnitude blocks")
    torch.cuda.synchronize()
    log(f"[ring_quant] quantize/dequantize bit-exact with the plain versions on "
        f"{n_checks} buffers (the 24 buckets padded to 256·{RING} and their "
        f"shards, magnitudes 1e-3/1/1e3, a zero block each) and on the tie blocks")
    ragged = [n for n in sizes if n != padded(n)]
    lengths = [(n, padded(n)) for n in sizes] + [
        (1001, 1024), *[(255 + QBLOCK * k, padded(255 + QBLOCK * k)) for k in (1, 2, 5)],
        (100, padded(100))]
    n_checks = 0
    for i, (n, m) in enumerate(lengths):
        check_unpadded_quantize(nan_tail(n, gen, (1e-3, 1.0, 1e3)[i % 3]), m,
                                f"n={n} m={m}")
        n_checks += 1
    torch.cuda.synchronize()
    log(f"[ring_quant] quantize of unpadded buffers bit-exact with the plain version of "
        f"the zero-padded buffer in {n_checks} launches (one a call): the {len(sizes)} "
        f"buckets at their real lengths ({len(ragged)} ragged: {ragged}), n = 1001, "
        f"n = 255 + 256·k and n = 100, NaN past n in memory, outputs started as poison")
    peer_checks = qk.DEQUANTIZE_SUM_LAUNCHES
    for i, n in enumerate(sizes):                     # phase 2's shards of each bucket
        x = torch.randn(RING, padded(n) // RING, generator=gen, device="cuda")
        x *= torch.tensor([1e-3, 1.0, 1e3, 1.0], device="cuda")[:, None]
        x[i % RING, :QBLOCK] = 0.0                    # a zero block on one peer
        check_peer_sum(x, f"b{i} ({RING} x {x.shape[1]})")
        check_sum_quantize(x, f"b{i} ({RING} x {x.shape[1]})")
    ties = tie_blocks().reshape(1, -1)
    ties = torch.cat([ties, -ties, 2 * ties, ties.flip(1)])
    check_peer_sum(ties, "tie blocks")
    check_sum_quantize(ties, "tie blocks")
    peer_checks = qk.DEQUANTIZE_SUM_LAUNCHES - peer_checks
    for g in (1, 2, 3, 8, 9):                         # across kPeerChunk (8)
        x = torch.randn(g, 37 * QBLOCK, generator=gen, device="cuda")
        x *= torch.logspace(-3, 3, g, device="cuda")[:, None]
        x[:, :QBLOCK] = 0.0
        check_sum_quantize(x, f"g={g} (37 blocks)")
    torch.cuda.synchronize()
    log(f"[ring_quant] dequantize_sum_blocks_kernel bit-exact with the plain peer sum "
        f"(dequantize, then the adds in peer order) and dequantize_sum_quantize_blocks_"
        f"kernel with the plain peer sum quantized, on the {len(sizes)} buckets' "
        f"phase-2 shards at g = {RING} (peers at 1e-3/1/1e3/1, a zero block each) "
        f"and on the tie blocks, the fused entry also at g = 1, 2, 3, 8, 9; one launch "
        f"a call, outputs started as NaN (and q as 0x7f)")

    # one rank's step of the main path: 3 combines a bucket (one a hop, both
    # halves), 2 quantizes (m, m/4) and 2 dequantizes (m, m) a bucket
    hops = ring_step_hops(sizes, gen)
    pairs = [(m, c) for msgs, chunks in hops for m, c in zip(msgs, chunks)]
    qin = [torch.randn(k, generator=gen, device="cuda")
           for n in sizes for k in (padded(n), padded(n) // RING)]
    qin2d = [x.view(-1, QBLOCK) for x in qin]        # the parent's and the plain form
    qs = [(q.view(-1, QBLOCK), s) for q, s in (
        qk.quantize_blocks_kernel(torch.randn(padded(n), generator=gen, device="cuda"))
        for n in sizes for _ in range(2))]
    # phase 1's inputs: each bucket at its real length, and its padded length
    p1 = [(torch.randn(n, generator=gen, device="cuda"), padded(n)) for n in sizes]
    # the main path's dequantize work a step: a peer sum of the received
    # shards (phase 2) and a dequantize of the gathered buffer (phase 3)
    recv = [(q.view(RING, -1), s.view(RING, -1)) for q, s in qs[0::2]]
    gathered = qs[1::2]

    def add():                      # torch.add a pair: the floor for row 3
        for a, b in pairs:
            torch.add(a, b, out=a)

    work = {
        "ring_accum_kernel": dict(
            kernel=lambda: [ck.ring_accum_pairs_kernel(m, c) for m, c in hops],
            plain=lambda: [cr.ring_accum_pairs_ref(m, c) for m, c in hops],
            library=lambda: [torch._foreach_add_(m, c) for m, c in hops],
            library_call="torch._foreach_add_ (one call a hop)", launches=len(hops),
            nbytes=sum(3 * a.numel() * 4 for a, _ in pairs), yardsticks={"add_ms": add}),
        "quantize_blocks_kernel": dict(
            kernel=lambda: [qk.quantize_blocks_kernel(x) for x in qin],
            plain=lambda: [qr.quantize_ref(x) for x in qin2d],
            library=None, library_call=QUANTIZE_LIBRARY, launches=len(qin),
            nbytes=sum(x.numel() * (4 + 1) + x.shape[0] * 4 for x in qin2d),
            yardsticks={"parent_path_ms": lambda: [parent_launch_quantize(x) for x in qin2d]}),
        "dequantize_blocks_kernel": dict(
            kernel=lambda: [qk.dequantize_blocks_kernel(q, s) for q, s in qs],
            plain=lambda: [qr.dequantize_ref(q, s) for q, s in qs],
            library=lambda: [torch.mul(q.view(-1, QBLOCK), s[:, None]) for q, s in qs],
            library_call="torch.mul(q.view(-1, 256), s[:, None])", launches=len(qs),
            nbytes=sum(q.numel() * (1 + 4) + s.numel() * 4 for q, s in qs)),
        "dequantize_sum_blocks_kernel": dict(
            kernel=lambda: [qk.dequantize_sum_blocks_kernel(q, s) for q, s in recv],
            plain=lambda: [qr.dequantize_sum_ref(q, s) for q, s in recv],
            library=None, library_call=PEER_SUM_LIBRARY, launches=len(recv),
            nbytes=sum(q.numel() + s.numel() * 4 + q.shape[1] * 4 for q, s in recv),
            yardsticks={"composite_ms": lambda: [composite_peer_sum(q, s) for q, s in recv]}),
        "dequantize_sum_quantize_blocks_kernel": dict(
            kernel=lambda: [qk.dequantize_sum_quantize_blocks_kernel(q, s) for q, s in recv],
            plain=lambda: [qr.dequantize_sum_quantize_ref(q, s) for q, s in recv],
            library=None, library_call=SUM_QUANTIZE_LIBRARY, launches=len(recv),
            nbytes=sum(q.numel() + s.numel() * 4 + q.shape[1] + s.shape[1] * 4
                       for q, s in recv)),
    }

    rows = {}
    for name, w in work.items():
        device_ms = device_ms_per_launch(w["kernel"], name, reps=10)
        # back to back in turns (kernel, yardsticks, yardsticks reversed, kernel):
        # the host's launch rate drifts within a run
        fns = {"ms": w["kernel"], "library_ms": w["library"], **w.get("yardsticks", {})}
        turns = cuda_ms_in_turns({k: f for k, f in fns.items() if f is not None})
        rows[name] = dict(
            ms=sum(turns["ms"]) / 2, device_ms=device_ms,
            plain_ms=cuda_ms(w["plain"]),
            library_ms=sum(turns["library_ms"]) / 2 if w["library"] else None,
            library=w["library_call"], max_abs_err=0.0,
            bound_ms=w["nbytes"] / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            step_bytes=w["nbytes"], launches_per_step=w["launches"], turns=turns,
            **{k: sum(turns[k]) / 2 for k in w.get("yardsticks", {})})
        if name == "ring_accum_kernel":
            rows[name].update(
                entry="ring_accum_pairs_kernel", add_calls=len(pairs), pairs=len(pairs),
                host_ms_per_launch=host_ms(w["kernel"], reps=20) / len(hops),
                library_host_ms_per_call=host_ms(w["library"], reps=20) / len(hops),
                add_host_ms_per_call=host_ms(add, reps=20) / len(pairs))
        else:
            rows[name]["host_ms_per_launch"] = host_ms(w["kernel"], reps=20) / w["launches"]
        if name == "quantize_blocks_kernel":
            rows[name]["parent_path_host_ms_per_launch"] = host_ms(
                w["yardsticks"]["parent_path_ms"], reps=20) / w["launches"]
        log(f"[ring_quant] {name}: " + json.dumps(rows[name]))
    rows["quantize_step"] = quantize_step(p1, recv)
    rows["dequantize_step"] = dequantize_step(recv, gathered)
    rows["peer_sum_check_launches"] = peer_checks
    return rows


def parent_launch_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The quantize of x (n_blocks, 256) f32 as the parent's wrapper
    launched it, the yardstick of ``quantize_step``: the shape and the full
    ``_check`` of x, two ``torch.empty``, the stream read through
    ``torch.cuda.current_stream``, then the same kernel at one block a warp
    (x a whole number of blocks).  Not counted: it is no wrapper of the
    port."""
    from repro_torch.kernels.quantize import kernel as qk

    n = qk._blocks(x, "x")
    qk._check(x, "x", torch.float32, (n, QBLOCK), x.device)
    q = torch.empty((n, QBLOCK), dtype=torch.int8, device=x.device)
    s = torch.empty(n, dtype=torch.float32, device=x.device)
    rc = qk._lib().quantize_blocks(x.data_ptr(), q.data_ptr(), s.data_ptr(), n, n * QBLOCK,
                                   x.device.index,
                                   torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quantize launch failed: CUDA error {rc}")
    return q, s


def quantize_step(p1, recv) -> dict:
    """One rank's quantize work of a compressed step as the main path runs
    it: 24 quantizes of the unpadded buckets (phase 1) and 24 fused
    sum-requantizes (phases 2-3), timed in turns against the composition
    it replaced (F.pad of a ragged bucket, a quantize, the peer sum and a
    quantize of the sum, the quantizes at the parent's launch path), with
    device time (torch.profiler, and its span over CUDA events), host time,
    both byte bounds (each input read once, each output written once) and
    the plain version."""
    import torch.nn.functional as F

    from repro_torch.kernels.quantize import kernel as qk
    from repro_torch.kernels.quantize import ref as qr

    def main_path():
        for buf, m in p1:
            qk.quantize_blocks_kernel(buf, n_blocks=m // QBLOCK)
        for q, s in recv:
            qk.dequantize_sum_quantize_blocks_kernel(q, s)

    def replaced():
        for buf, m in p1:
            x = F.pad(buf, (0, m - buf.numel())) if m != buf.numel() else buf
            parent_launch_quantize(x.view(-1, QBLOCK))
        for q, s in recv:
            parent_launch_quantize(qk.dequantize_sum_blocks_kernel(q, s).view(-1, QBLOCK))

    def plain():
        for buf, m in p1:
            qr.quantize_ref(qr.zero_padded(buf, m).view(-1, QBLOCK))
        for q, s in recv:
            qr.dequantize_sum_quantize_ref(q, s)

    turns = cuda_ms_in_turns({"ms": main_path, "replaced_ms": replaced})
    dev = device_ms_clock_checked(main_path, r"(?:dequantize_sum_)?quantize_blocks_kernel",
                                  reps=10)
    rdev = device_ms_clock_checked(replaced, None, reps=10)
    launches = len(p1) + len(recv)
    ragged = sum(m != b.numel() for b, m in p1)
    nbytes = (sum(b.numel() * 4 + m + m // QBLOCK * 4 for b, m in p1)
              + sum(q.numel() + s.numel() * 4 + q.shape[1] + s.shape[1] * 4
                    for q, s in recv))
    pad_bytes = sum(b.numel() * 4 + m * 4 for b, m in p1 if m != b.numel())
    replaced_bytes = (pad_bytes + sum(m * 4 + m + m // QBLOCK * 4 for _, m in p1)
                      + sum(q.numel() + s.numel() * 4 + q.shape[1] * 4 for q, s in recv)
                      + sum(q.shape[1] * (4 + 1) + s.shape[1] * 4 for q, s in recv))
    row = dict(
        ms=sum(turns["ms"]) / 2, replaced_ms=sum(turns["replaced_ms"]) / 2,
        device_ms=dev["device_ms_per_launch"], events_ms=dev["events_ms_per_launch"],
        profiler_span_over_events=dev["span_over_events"],
        device_launches_per_step=dev["device_events_per_call"],
        replaced_device_ms=rdev["device_ms_per_launch"],
        replaced_profiler_span_over_events=rdev["span_over_events"],
        replaced_device_events_per_step=rdev["device_events_per_call"],
        host_ms_per_launch=host_ms(main_path, reps=20) / launches,
        replaced_host_ms_per_step=host_ms(replaced, reps=20),
        plain_ms=cuda_ms(plain, reps=3, warmup=1),
        library_ms=None, library=SUM_QUANTIZE_LIBRARY,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", step_bytes=nbytes,
        replaced_bound_ms=replaced_bytes / HBM_BYTES_PER_S * 1e3,
        replaced_step_bytes=replaced_bytes, launches_per_step=launches,
        replaced_counted_launches_per_step=len(p1) + 2 * len(recv),
        replaced_pad_copies_per_step=ragged, turns=turns)
    row["ms_over_replaced"] = row["ms"] / row["replaced_ms"]
    row["device_over_replaced"] = row["device_ms"] / row["replaced_device_ms"]
    row["device_over_bound"] = row["device_ms"] / row["bound_ms"]
    log("[ring_quant] quantize work a step (24 unpadded quantizes + 24 fused "
        "sum-requantizes): " + json.dumps(row))
    return row


def composite_peer_sum(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The peer sum by library calls: ``torch.mul`` over the g shards, then
    ``torch.add`` in peer order."""
    d = torch.mul(q.view(q.shape[0], -1, QBLOCK), s[:, :, None]).view(q.shape[0], -1)
    red = d[0]
    for j in range(1, q.shape[0]):
        red = torch.add(red, d[j])
    return red


def dequantize_step(recv, gathered) -> dict:
    """One rank's dequantize work of a compressed step on the peer-sum
    path (a peer sum a bucket for phase 2, a dequantize a bucket after the
    gather; the main path now fuses phase 2 into the requantize and runs
    only the dequantizes), timed in turns against the composition it replaced (phase 2 as a
    dequantize of the g shards and g - 1 ``torch.add``) and against
    library calls (``torch.mul`` + ``torch.add``, ``torch.mul``), with its
    device time and byte bound."""
    from repro_torch.kernels.quantize import kernel as qk
    from repro_torch.kernels.quantize import ref as qr

    def main_path():
        for q, s in recv:
            qk.dequantize_sum_blocks_kernel(q, s)
        for q, s in gathered:
            qk.dequantize_blocks_kernel(q, s)

    def replaced():
        for q, s in recv:
            d = qk.dequantize_blocks_kernel(q.view(-1, QBLOCK), s.view(-1)).view(RING, -1)
            red = d[0]
            for j in range(1, RING):
                red = red + d[j]
        for q, s in gathered:
            qk.dequantize_blocks_kernel(q, s)

    def library():
        for q, s in recv:
            composite_peer_sum(q, s)
        for q, s in gathered:
            torch.mul(q.view(-1, QBLOCK), s[:, None])

    turns = cuda_ms_in_turns({"ms": main_path, "replaced_ms": replaced,
                              "library_ms": library})
    nbytes = (sum(q.numel() + s.numel() * 4 + q.shape[1] * 4 for q, s in recv)
              + sum(q.numel() * (1 + 4) + s.numel() * 4 for q, s in gathered))
    row = dict(
        ms=sum(turns["ms"]) / 2, replaced_ms=sum(turns["replaced_ms"]) / 2,
        library_ms=sum(turns["library_ms"]) / 2,
        library="torch.mul + torch.add (phase 2), torch.mul (phase 3)",
        device_ms=device_ms_per_launch(main_path, r"dequantize(?:_sum)?_blocks_kernel",
                                       reps=10),
        replaced_device_ms=device_ms_per_launch(
            replaced, r"(?:dequantize_blocks_kernel|\w*elementwise_kernel)", reps=10),
        plain_ms=cuda_ms(lambda: ([qr.dequantize_sum_ref(q, s) for q, s in recv],
                                  [qr.dequantize_ref(q, s) for q, s in gathered])),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", step_bytes=nbytes,
        launches_per_step=len(recv) + len(gathered),
        replaced_launches_per_step=len(recv) * RING + len(gathered), turns=turns)
    log("[ring_quant] dequantize work a step (24 peer sums + 24 dequantizes): "
        + json.dumps(row))
    return row


def ring_step_hops(sizes, gen, dtype=torch.float32) -> list:
    """One rank's ring reduce-scatter combines over a step, as the ring
    forms them: per bucket (padded to RING · c) and hop, the received
    messages of the two half-chunks and this rank's own rows of
    ``x2d[:, :h]`` and ``x2d[:, h:]`` (one pair when h = 0)."""
    from repro_torch.kernels.collectives import ref as cr

    hops = []
    for n in sizes:
        c = -(-n // RING)
        x2d = torch.randn(RING * c, generator=gen, device="cuda").to(dtype).view(RING, c)
        rings = cr._rings(x2d, True)
        for s in range(1, RING):
            own = [part[(0 - sgn * (s + 1)) % RING] for part, sgn in rings]
            hops.append(([torch.randn(o.numel(), generator=gen, device="cuda").to(dtype)
                          for o in own], own))
    return hops


def check_accum_pairs(sizes, gen) -> int:
    """The pair kernel against torch.add, bit for bit, one launch a call."""
    from repro_torch.kernels.collectives import kernel as ck

    cases = []
    for dt in ACCUM_DTYPES:
        cases += ring_step_hops(sizes, gen, dt)[::RING - 1]      # a hop a bucket
        cases.append(([torch.randn(1, generator=gen, device="cuda").to(dt)],
                      [torch.randn(RING, generator=gen, device="cuda").to(dt)[1:2]]))
        x = torch.randn(9 * 4099, generator=gen, device="cuda").to(dt)
        cases.append(([torch.randn(4097 - i, generator=gen, device="cuda").to(dt)
                       for i in range(8)],
                      [x[i * 4099 + i % 3:][:4097 - i] for i in range(8)]))
    for msgs, own in cases:
        want = [torch.add(m, o) for m, o in zip(msgs, own)]
        before = ck.ACCUM_LAUNCHES
        got = ck.ring_accum_pairs_kernel(msgs, own)
        if ck.ACCUM_LAUNCHES != before + 1:
            raise AssertionError("ring_accum_pairs_kernel: expected one launch a call")
        for i, (g, w) in enumerate(zip(got, want)):
            same_bits(g, w, f"accum pairs {g.dtype} {len(msgs)} pairs, pair {i} "
                            f"n={g.numel()}")
    return len(cases)


def _same_on_every_rank(tensors, what: str, group) -> None:
    """Raise unless ``tensors`` hold the same bits on every rank: rank 0's
    are broadcast (host copies, on the gloo ``group``) and compared."""
    import torch.distributed as dist

    mine = torch.cat([t.detach().reshape(-1) for t in tensors]).view(torch.int32).cpu()
    theirs = mine.clone()
    dist.broadcast(theirs, 0, group=group)
    ok = torch.tensor([int(torch.equal(mine, theirs))])
    dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=group)
    if not ok.item():
        raise AssertionError(f"{what}: not bit-identical across the {RING} ranks")


def _capturing(reducer, store: dict):
    """``reducer`` that keeps each bucket's first input and output."""
    def wrapped(buf, bucket, group):
        first = bucket.bucket_id not in store
        inp = buf.clone() if first else None
        h = reducer(buf, bucket, group)
        if first:
            store[bucket.bucket_id] = (bucket, inp, h.out)
        return h
    return wrapped


def _reducers_rank(rank: int, workdir: str, backend: str) -> None:
    """One rank of the reducers phase: every run of ``REDUCER_RUNS`` from
    the same seeded weights; checks; results to ``workdir/rank<r>.json``.
    Rank r computes on card r % device_count."""
    import datetime

    import torch.distributed as dist
    import torch.nn.functional as F

    from repro_torch.configs.resnet50_cifar import make_config
    from repro_torch.core import GradSyncConfig
    from repro_torch.data import ImagePipeline
    from repro_torch.kernels.collectives import kernel as ck
    from repro_torch.kernels.collectives import ops as co
    from repro_torch.kernels.collectives import ref as cr
    from repro_torch.kernels.quantize import kernel as qk
    from repro_torch.kernels.quantize import ref as qr
    from repro_torch.launch.mesh import init_dist, make_dp_mesh
    from repro_torch.models.resnet import ResNet, init_params
    from repro_torch.optim import linear_scaling_rule, sgd
    from repro_torch.runtime import Trainer, make_train_step
    from repro_torch.utils.trees import flatten_with_names

    init_dist("cuda", backend=backend, init_method=f"file://{workdir}/store",
              rank=rank, world_size=RING, timeout=datetime.timedelta(seconds=300))
    host = dist.new_group(backend="gloo")     # the checks' own host collectives
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say = log if rank == 0 else (lambda _m: None)
    cfg = make_config()
    mesh = make_dp_mesh()
    pipe = ImagePipeline(cfg.img_size, cfg.num_classes, 256, seed=0, mesh=mesh,
                         rank=rank, device="cuda")
    out = {"runs": {}}
    grads0, params_end, captured = {}, {}, {}
    for strategy, reducer in REDUCER_RUNS:
        run = f"{strategy}x{reducer}"
        model = ResNet(cfg, init_params(cfg, seed=0, device="cuda"))
        opt = sgd(linear_scaling_rule(0.1, 256, 256), momentum=0.9)
        ts = make_train_step(cfg, mesh, GradSyncConfig(strategy=strategy, reducer=reducer),
                             opt, model=model, clip_norm=1.0, device="cuda")
        if strategy == "funnel" and reducer in ("ring", "compressed"):
            captured[reducer] = {}
            ts.gradsync.reducer = _capturing(ts.gradsync.reducer, captured[reducer])
        named = flatten_with_names(model.params_tree())[0]
        opt_state = opt.init(dict(named))
        predicted = {k: v * REDUCER_STEPS for k, v in step_launches(
            [b.size for b in ts.gradsync.plan.buckets], reducer).items()}
        trainer = Trainer(ts, pipe, log_every=10 ** 9, printer=lambda _m: None)
        ck.ACCUM_LAUNCHES = qk.QUANTIZE_LAUNCHES = qk.DEQUANTIZE_LAUNCHES = 0
        qk.DEQUANTIZE_SUM_LAUNCHES = qk.SUM_QUANTIZE_LAUNCHES = 0
        for step in range(REDUCER_STEPS):
            model, opt_state, hist = trainer.run(model, opt_state, step + 1,
                                                 start_step=step)
            if step == 0:
                grads0[run] = [p.grad.detach().clone() for _, p in named]
            _same_on_every_rank([p for _, p in named], f"{run} params after step {step}",
                                host)
        launches = {"accum": ck.ACCUM_LAUNCHES, "quantize": qk.QUANTIZE_LAUNCHES,
                    "sum_quantize": qk.SUM_QUANTIZE_LAUNCHES,
                    "dequantize": qk.DEQUANTIZE_LAUNCHES,
                    "dequantize_sum": qk.DEQUANTIZE_SUM_LAUNCHES}
        if launches != predicted:
            raise AssertionError(f"{run}: launches {launches}, predicted {predicted}")
        params_end[run] = [p.detach().clone() for _, p in named]
        out["runs"][run] = {
            "launches": launches, "buckets": len(ts.gradsync.plan.buckets),
            "first_step_ms": trainer.first_step_time * 1e3,
            "step_ms": [t * 1e3 for t in trainer.step_times],
            "loss": hist["losses"][-1]}
        say(f"[reducers] {run}: launches {launches} (= prediction), params "
            f"bit-identical on the {RING} ranks after each of {REDUCER_STEPS} steps; "
            f"first step {trainer.first_step_time * 1e3:.1f} ms, then "
            f"{[round(t * 1e3, 1) for t in trainer.step_times]} ms")
        del ts, model, opt_state, trainer

    # ring and flat: the same sums in another order
    worst = 0.0
    for a, b in zip(grads0["funnelxring"], grads0["funnelxflat"]):
        tol = 1e-5 * b.abs().max().item()
        if not torch.allclose(a, b, rtol=1e-5, atol=tol):
            raise AssertionError(f"ring vs flat grads differ by {(a - b).abs().max().item()}")
        worst = max(worst, (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30))
    out["ring_vs_flat_max_diff_over_leaf_absmax"] = worst
    # compressed_ring and compressed: the same int8 values, gathered otherwise
    for a, b in zip(grads0["funnelxcompressed_ring"] + params_end["funnelxcompressed_ring"],
                    grads0["funnelxcompressed"] + params_end["funnelxcompressed"]):
        same_bits(a, b, "compressed_ring vs compressed")
    # compressed against the flat sum of the same inputs, per block of each bucket
    ratio = 0.0
    for bid, (bucket, inp, got) in sorted(captured["compressed"].items()):
        pad = padded(inp.numel()) - inp.numel()
        buf = F.pad(inp.cpu(), (0, pad))
        flat_sum = buf.clone()
        dist.all_reduce(flat_sum, group=host)
        scales = qr.quantize_ref(buf.view(-1, QBLOCK))[1]
        dist.all_reduce(scales, group=host)           # sum over the ranks
        out_b = F.pad(got.cpu(), (0, pad))
        s2 = out_b.view(-1, QBLOCK).abs().amax(1) / 127
        # + a millionth of the summed amax for the two sums' own rounding
        bound = (scales / 2 + s2 * (1 + 1e-6) / 2
                 + 1e-6 * scales * 127).repeat_interleave(QBLOCK)
        err = (out_b - flat_sum).abs()
        if not torch.all(err <= bound):
            raise AssertionError(f"bucket {bid}: compressed beyond the quantization bound")
        ratio = max(ratio, (err / bound).max().item())
    out["compressed_err_over_bound_max"] = ratio
    # one captured bucket: the ring with the kernel against the plain add
    bucket, inp, _ = max(captured["ring"].values(), key=lambda c: c[1].numel())
    group = dist.group.WORLD
    with_kernel = co.ring_allreduce(inp.clone(), bucket.reduce_axes, mesh.shape, group)
    buf = F.pad(inp, (0, (-inp.numel()) % RING))
    plain = cr.ring_all_gather_ref(
        cr.ring_reduce_scatter_ref(buf, group, accum=cr.ring_accum_pairs_ref), group)
    same_bits(with_kernel, plain[:inp.numel()], f"ring allreduce of bucket "
              f"{bucket.bucket_id}: kernel vs plain add")
    out["captured_bucket"] = {"bucket": bucket.bucket_id, "elements": inp.numel()}
    out["lm"] = _lm_ranks(rank, host, say)
    say(f"[reducers] ring vs flat first-step grads within rtol 1e-5 (max diff / leaf "
        f"absmax {worst}); compressed_ring = compressed bit for bit (grads and params); "
        f"compressed within the quantization bound of the flat sum (max err/bound "
        f"{ratio}); ring allreduce of bucket {bucket.bucket_id} ({inp.numel()} "
        f"elements) with the kernel = with the plain add, bit for bit")
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _lm_ranks(rank: int, host, say) -> dict:
    """The quickstart LM (4 layers, d 128, f32) on the RING ranks, on the
    default group's transport: 3 steps of funnel and of depcha in-scan from
    the same weights, global batch 8 of 64 tokens.  Params bit-identical
    across the ranks after every step; depcha's first-step reduced
    gradients within rtol 1e-5 / atol 1e-6 of funnel's; 4 in-backward
    collectives a depcha step, none a funnel step."""
    from repro_torch.core import GradSyncConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import make_dp_mesh
    from repro_torch.models.transformer import Transformer, TransformerConfig, init_params
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.runtime import Trainer, make_train_step
    from repro_torch.utils.trees import flatten_with_names

    mesh = make_dp_mesh()
    weights = init_params(TransformerConfig(
        name="quickstart-lm", n_layers=4, d_model=128, n_heads=8, kv_heads=4, d_ff=256,
        vocab=512, tp=1, attn_chunk=64, dtype=torch.float32), seed=0, device="cpu")
    grads0, out = {}, {}
    for strat in ("funnel", "depcha"):
        cfg = TransformerConfig(name="quickstart-lm", n_layers=4, d_model=128, n_heads=8,
                                kv_heads=4, d_ff=256, vocab=512, tp=1, attn_chunk=64,
                                dtype=torch.float32, depcha_in_scan=strat == "depcha")
        model = Transformer(cfg, tree_to(weights, "cuda"))
        opt = adamw(cosine_warmup(1e-3, 20, 200))
        ts = make_train_step(cfg, mesh, GradSyncConfig(strategy=strat), opt, model=model,
                             clip_norm=1.0, device="cuda")
        pipe = TokenPipeline(cfg.vocab, 64, 8, seed=0, mesh=mesh, rank=rank, device="cuda")
        named = flatten_with_names(model.params_tree())[0]
        opt_state = opt.init(dict(named))
        trainer = Trainer(ts, pipe, log_every=10 ** 9, printer=lambda _m: None)
        losses, collectives = [], []
        for step in range(3):
            model, opt_state, hist = trainer.run(model, opt_state, step + 1, start_step=step)
            losses.append(hist["losses"][-1])
            collectives.append(ts.layer_sync.collectives if ts.layer_sync is not None else 0)
            if step == 0:
                grads0[strat] = [p.grad.detach().clone() for _, p in named]
            _same_on_every_rank([p for _, p in named], f"lm {strat} params after step {step}",
                                host)
        want = cfg.n_layers if strat == "depcha" else 0
        if collectives != [want] * 3:
            raise AssertionError(f"lm {strat}: in-backward collectives {collectives}")
        out[strat] = {"losses": losses, "in_backward_collectives_per_step": collectives,
                      "step_ms": [t * 1e3 for t in trainer.step_times]}
    worst = 0.0
    for (n, _), a, b in zip(named, grads0["depcha"], grads0["funnel"]):
        if not torch.allclose(a, b, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"lm depcha vs funnel grads of {n} differ by "
                                 f"{(a - b).abs().max().item()}")
        worst = max(worst, (a - b).abs().max().item())
    out["depcha_vs_funnel_grads_max_abs_diff"] = worst
    say(f"[reducers] lm quickstart on {RING} ranks: params bit-identical after each of 3 "
        f"steps; depcha vs funnel first-step grads within rtol 1e-5 / atol 1e-6 (max abs "
        f"diff {worst}); " + json.dumps(out))
    return out


def phase_reducers(backend: str = "gloo") -> dict:
    """Four rank processes: the ring, compressed and compressed_ring
    reducers under GradSync at full ResNet-50/CIFAR width.  With gloo (as
    ``main`` runs it) all four share the one card and their communicators
    stage through pinned host memory; ``backend="nccl"`` needs four cards,
    one a rank."""
    import tempfile

    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="reducers-") as wd:
        mp.spawn(_reducers_rank, args=(wd, backend), nprocs=RING, join=True)
        ranks = []
        for r in range(RING):
            with open(os.path.join(wd, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    for r, res in enumerate(ranks):
        if {k: v["launches"] for k, v in res["runs"].items()} != \
                {k: v["launches"] for k, v in ranks[0]["runs"].items()}:
            raise AssertionError(f"rank {r} launched other counts than rank 0")
    res = ranks[0]
    res["wall_s"] = time.perf_counter() - t0
    res["transport"] = (
        f"gloo over pinned host memory, {RING} processes on one card: times the "
        f"kernels and the schedule's order, not a wire" if backend == "gloo"
        else f"{backend}, {RING} processes on {torch.cuda.device_count()} cards")
    log("[reducers] " + json.dumps(res))
    return res


# ------------------------------------------------------- hierarchical reducers

HIER_LAYOUTS = ((2, 2), (1, 4))        # (pods, data ranks a pod) over the RING ranks
HIER_RUNS = (("funnel", "flat", (2, 2)), ("funnel", "hierarchical", (2, 2)),
             ("funnel", "hierarchical_ring", (2, 2)),
             ("concom", "hierarchical_ring", (2, 2)),
             ("funnel", "hierarchical_ring", (1, 4)))
HIER_DTYPES = (torch.float32, torch.bfloat16)
NVLINK_BYTES_PER_S = 450e9     # one direction of one H100's NVLink (data sheet)
P2P_SOURCE = "src/repro_torch/kernels/collectives/csrc/ring_p2p.cu"
P2P_REPLACES = {"ring_reduce_scatter_kernel": "src/repro/kernels/collectives/kernel.py:208",
                "ring_all_gather_kernel": "src/repro/kernels/collectives/kernel.py:227"}
P2P_NO_LIBRARY = ("none on one card: NCCL refuses two ranks on one device, and the four "
                  "ranks of this phase share cuda:0")


def hier_launches(sizes, reducer: str, data: int) -> dict:
    """Peer-ring launches of one training step on one rank, from the
    plan's bucket sizes: ``hierarchical_ring`` reduce-scatters and
    all-gathers every bucket over the pod's ``data`` ranks, each call one
    launch a hop plus the hop-0 send, ``data`` in all."""
    calls = len(sizes) if reducer == "hierarchical_ring" and data > 1 else 0
    return {"rs": calls * data, "ag": calls * data}


def hier_memops(sizes, reducer: str, data: int) -> dict:
    """Stream memory operations the peer rings enqueue in one training
    step on one rank: ``peer_memops`` a call, one call of each kernel a
    bucket, bidirectional unless the bucket's chunk is one element."""
    from repro_torch.kernels.collectives.kernel import peer_memops

    if reducer != "hierarchical_ring" or data == 1:
        return {"rs": 0, "ag": 0}
    n = sum(peer_memops(data, -(-size // data) > 1) for size in sizes)
    return {"rs": n, "ag": n}


def _plain_hier(buf, comm):
    """``hierarchical_allreduce(use_ring=True)`` through the plain rings."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from repro_torch.core import dependency as dep
    from repro_torch.kernels.collectives import ref as cr

    n, g = buf.numel(), dist.get_world_size(comm.intra)
    x = F.pad(buf, (0, (-n) % g))
    shard = cr.ring_reduce_scatter_ref(x, comm.intra)
    if dist.get_world_size(comm.inter) > 1:
        dep.collective(dist.all_reduce, comm.inter, shard).wait()
    return cr.ring_all_gather_ref(shard, comm.intra)[:n]


def _peer_kernel_checks(sizes, layout, gen, say) -> dict:
    """Both peer-ring kernels against the plain rings, bit for bit: every
    bucket size (padded to the ring), c = 1 and an odd c, f32 and bf16,
    uni- and bidirectional, back to back with no host sync, then two
    chains at once on two streams, then ``_peer_wrap_checks``."""
    import torch.distributed as dist

    from repro_torch.core import dependency as dep
    from repro_torch.kernels.collectives import kernel as ck
    from repro_torch.kernels.collectives import ref as cr

    pods, data = layout
    comms = dep.pod_comms({0: dist.group.WORLD, 1: dist.group.WORLD}, pods, data,
                          torch.device("cuda"))
    lengths = [-(-n // data) * data for n in sizes] + [data, data * 131071]
    slot = max(lengths) // data * 4
    rings = [ck.PeerRing(comms[c].intra, slot, chain=c) for c in (0, 1)]
    intra = comms[0].intra
    say(f"[hierarchical] peer rings on pod {pods} x data {data}: signals at "
        f"{'system' if rings[0].system_scope else 'GPU'} scope")
    n_checks = 0
    for dt in HIER_DTYPES:
        for bidi in (True, False):
            xs = [torch.randn(n, generator=gen, device="cuda").to(dt) for n in lengths]
            got = []
            for x in xs:                          # back to back: no host sync
                shard = ck.ring_reduce_scatter_kernel(rings[0], x, bidirectional=bidi)
                got.append((shard, ck.ring_all_gather_kernel(rings[0], shard,
                                                             bidirectional=bidi)))
            for x, (shard, full) in zip(xs, got):
                want = cr.ring_reduce_scatter_ref(x, intra, bidirectional=bidi)
                same_bits(shard, want, f"peer RS {layout} {dt} bidi={bidi} n={x.numel()}")
                same_bits(full, cr.ring_all_gather_ref(want, intra, bidirectional=bidi),
                          f"peer AG {layout} {dt} bidi={bidi} n={x.numel()}")
                n_checks += 2
    # two chains at once: buckets alternate between two streams and two rings
    streams = [torch.cuda.Stream() for _ in rings]
    xs = [torch.randn(n, generator=gen, device="cuda") for n in lengths]
    cur = torch.cuda.current_stream()
    outs = []
    for i, x in enumerate(xs):
        c = i % 2
        streams[c].wait_stream(cur)
        with torch.cuda.stream(streams[c]):
            shard = ck.ring_reduce_scatter_kernel(rings[c], x)
            outs.append((shard, ck.ring_all_gather_kernel(rings[c], shard)))
            x.record_stream(streams[c])
    for s in streams:
        cur.wait_stream(s)
    for x, (shard, full) in zip(xs, outs):
        want = cr.ring_reduce_scatter_ref(x, intra)
        same_bits(shard, want, f"peer RS two chains {layout} n={x.numel()}")
        same_bits(full, cr.ring_all_gather_ref(want, intra),
                  f"peer AG two chains {layout} n={x.numel()}")
        n_checks += 2
    n_wrap = _peer_wrap_checks(rings[0], intra, lengths, gen)
    for ring in rings:
        ring.close()
    say(f"[hierarchical] peer rings bit-exact with the plain rings in {n_checks} checks on "
        f"pod {pods} x data {data}: f32/bf16, uni/bidi, the 24 bucket sizes padded to "
        f"{data}, c = 1 and c = 131071, back to back, and on two chains at once; "
        f"{n_wrap} wrap-around checks ({rings[0].slots} slots a direction); "
        f"a ring of {rings[0].bytes} bytes a rank")
    return {"checks": n_checks, "wrap_checks": n_wrap}


def _peer_wrap_checks(ring, intra, lengths, gen) -> int:
    """3·K + 2 calls of each peer-ring kernel back to back with no host
    sync (K slots a direction, so every slot is rewritten at least three
    times), the chunk alternating between the largest bucket's and one
    element, f32, bidirectional: each result bit for bit against the
    plain rings, and the stream waits enqueued exactly as predicted."""
    from repro_torch.kernels.collectives import kernel as ck
    from repro_torch.kernels.collectives import ref as cr

    g = ring.g
    big = max(lengths[:-2])                    # the largest bucket, padded
    ns = [(big, g)[i % 2] for i in range(3 * ring.slots + 2)]
    xs = [torch.randn(n, generator=gen, device="cuda") for n in ns]
    before = ck.stream_memops()
    got = []
    for x in xs:
        shard = ck.ring_reduce_scatter_kernel(ring, x)
        got.append((shard, ck.ring_all_gather_kernel(ring, shard)))
    after = ck.stream_memops()
    want = sum(ck.peer_memops(g, n // g > 1) for n in ns)
    if {k: after[k] - before[k] for k in after} != {"rs": want, "ag": want}:
        raise AssertionError(f"wrap-around: stream waits {before} -> {after}, "
                             f"predicted {want} a kernel")
    for x, (shard, full) in zip(xs, got):
        plain = cr.ring_reduce_scatter_ref(x, intra)
        same_bits(shard, plain, f"peer RS wrap-around g={g} n={x.numel()}")
        same_bits(full, cr.ring_all_gather_ref(plain, intra),
                  f"peer AG wrap-around g={g} n={x.numel()}")
    return 2 * len(xs)


def _peer_host_ms(sizes, layout, gen, host, reps: int = 5) -> dict:
    """The host's time to enqueue one call of each peer-ring kernel: a
    ResNet-50 step's 24 calls, each run started on an idle card with the
    ranks in step, the median of ``reps`` runs.  It uses whichever
    ``repro_torch`` this process imports, so that ``peer_rings_in_turns``
    times every tree's host path alike."""
    import torch.distributed as dist

    from repro_torch.core import dependency as dep
    from repro_torch.kernels.collectives import kernel as ck

    pods, data = layout
    comm = dep.pod_comms({0: dist.group.WORLD}, pods, data, torch.device("cuda"))[0]
    xs = [torch.randn(-(-n // data) * data, generator=gen, device="cuda") for n in sizes]
    shards = [torch.randn(x.numel() // data, generator=gen, device="cuda") for x in xs]
    ring = ck.PeerRing(comm.intra, max(x.numel() for x in xs) // data * 4, chain=0)
    ms = {}
    for name, fn in (("ring_reduce_scatter_kernel",
                      lambda: [ck.ring_reduce_scatter_kernel(ring, x) for x in xs]),
                     ("ring_all_gather_kernel",
                      lambda: [ck.ring_all_gather_kernel(ring, s) for s in shards])):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            dist.barrier(group=host)
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3 / len(xs))
        torch.cuda.synchronize()
        ms[name] = sorted(times)[reps // 2]
    ring.close()
    return ms


def _peer_timing(sizes, layout, gen, host, backend: str) -> dict:
    """One ResNet-50 step of each peer-ring kernel on this rank (24 calls
    each, f32, bidirectional): CUDA events back to back, device time from
    torch.profiler, the plain ring's time, the bound and (over NCCL) one
    library call's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import torch.distributed as dist

    from repro_torch.core import dependency as dep
    from repro_torch.kernels.collectives import kernel as ck
    from repro_torch.kernels.collectives import ref as cr

    pods, data = layout
    comm = dep.pod_comms({0: dist.group.WORLD}, pods, data, torch.device("cuda"))[0]
    xs = [torch.randn(-(-n // data) * data, generator=gen, device="cuda") for n in sizes]
    shards = [torch.randn(x.numel() // data, generator=gen, device="cuda") for x in xs]
    ring = ck.PeerRing(comm.intra, max(x.numel() for x in xs) // data * 4, chain=0)
    c_total = sum(s.numel() for s in shards)
    hops = data - 1
    work = {
        "ring_reduce_scatter_kernel": dict(
            kernel=lambda: [ck.ring_reduce_scatter_kernel(ring, x) for x in xs],
            plain=lambda: [cr.ring_reduce_scatter_ref(x, comm.intra) for x in xs],
            library=lambda: [dist.reduce_scatter_tensor(s, x, group=comm.intra)
                             for s, x in zip(shards, xs)],
            library_call="dist.reduce_scatter_tensor (NCCL)",
            hop_bytes=hops * 3 * c_total * 4),
        "ring_all_gather_kernel": dict(
            kernel=lambda: [ck.ring_all_gather_kernel(ring, s) for s in shards],
            plain=lambda: [cr.ring_all_gather_ref(s, comm.intra) for s in shards],
            library=lambda: [dist.all_gather_into_tensor(x, s, group=comm.intra)
                             for s, x in zip(shards, xs)],
            library_call="dist.all_gather_into_tensor (NCCL)",
            hop_bytes=hops * 2 * c_total * 4),
    }

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        dist.barrier(group=host)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    rows = {}
    for name, w in work.items():
        reps = 5
        dist.barrier(group=host)
        ops0 = ck.stream_memops()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                w["kernel"]()
            torch.cuda.synchronize()
        key = "rs" if name == "ring_reduce_scatter_kernel" else "ag"
        memops = (ck.stream_memops()[key] - ops0[key]) // reps
        predicted = hier_memops([x.numel() for x in xs], "hierarchical_ring", data)[key]
        if memops != predicted:
            raise AssertionError(f"{name}: {memops} stream waits a step, predicted "
                                 f"{predicted}")
        device_ms = sum(_device_ms(e, self_only=True) for e in prof.key_averages()
                        if getattr(e, "device_type", None) == DeviceType.CUDA
                        and "ring_hop_kernel" in e.key) / reps
        # each launch's device time: a context switch inside a launch (four
        # processes time-share the card) lands in its time, not in others'
        each = sorted(_device_ms(e) for e in prof.events()
                      if getattr(e, "device_type", None) == DeviceType.CUDA
                      and "ring_hop_kernel" in e.name)
        launch_ms = {q: each[min(int(q * len(each)), len(each) - 1)]
                     for q in (0.0, 0.5, 0.9, 0.99)} if each else {}
        one_card = backend == "gloo"
        # the function's own bytes on a rank: reduce-scatter reads (g, c)
        # and writes (c,), all-gather reads (c,) and writes (g, c). One
        # card: the RING ranks' bytes share one HBM. Four cards: the
        # larger of a rank's HBM bytes and the (g - 1) c it must send over
        # NVLink, one direction.
        rank_bytes = (data + 1) * c_total * 4
        wire_s = hops * c_total * 4 / NVLINK_BYTES_PER_S
        if one_card:
            bound_s, basis = RING * rank_bytes / HBM_BYTES_PER_S, "HBM, the four ranks' bytes"
        elif wire_s > rank_bytes / HBM_BYTES_PER_S:
            bound_s, basis = wire_s, "NVLink, the bytes one rank sends"
        else:
            bound_s, basis = rank_bytes / HBM_BYTES_PER_S, "HBM, one rank's bytes"
        rows[name] = dict(
            ms=timed(w["kernel"], 10), device_ms=device_ms,
            plain_ms=timed(w["plain"], 2),
            library_ms=None if one_card else timed(w["library"], 10),
            library=P2P_NO_LIBRARY if one_card else w["library_call"],
            max_abs_err=0.0, bound_ms=bound_s * 1e3, bound_by="bytes",
            bound_basis=basis,
            bytes=RING * rank_bytes if one_card else rank_bytes,
            hop_bytes=w["hop_bytes"],
            launch_ms_quantiles=launch_ms,
            launches_per_step=len(xs) * data, memops_per_step=memops,
            memops_per_call=ck.peer_memops(data, True),
            ring_bytes=ring.bytes,
            layout=list(layout))
    ring.close()
    return rows


def _hier_rank(rank: int, workdir: str, backend: str) -> None:
    """One rank of the hierarchical phase: the peer-ring kernels against
    the plain rings and timed, then every run of ``HIER_RUNS`` from the
    same seeded weights, checked; results to ``workdir/rank<r>.json``."""
    import datetime

    import torch.distributed as dist

    from repro_torch.configs.resnet50_cifar import make_config
    from repro_torch.core import GradSyncConfig
    from repro_torch.data import ImagePipeline
    from repro_torch.kernels.collectives import kernel as ck
    from repro_torch.kernels.quantize import kernel as qk
    from repro_torch.launch.mesh import init_dist, make_pod_mesh
    from repro_torch.models.resnet import ResNet, init_params
    from repro_torch.optim import linear_scaling_rule, sgd
    from repro_torch.runtime import Trainer, make_train_step
    from repro_torch.utils.trees import flatten_with_names

    init_dist("cuda", backend=backend, init_method=f"file://{workdir}/store",
              rank=rank, world_size=RING, timeout=datetime.timedelta(seconds=300))
    host = dist.new_group(backend="gloo")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say = log if rank == 0 else (lambda _m: None)
    plan, _ = resnet50_plan()
    sizes = [b.size for b in plan.buckets]
    gen = torch.Generator(device="cuda").manual_seed(100 + rank)
    out = {"kernel_checks": 0, "wrap_checks": 0, "timing": {}, "runs": {}}
    for layout in HIER_LAYOUTS:
        checks = _peer_kernel_checks(sizes, layout, gen, say)
        out["kernel_checks"] += checks["checks"]
        out["wrap_checks"] += checks["wrap_checks"]
    for layout in HIER_LAYOUTS:
        out["timing"][str(layout)] = _peer_timing(sizes, layout, gen, host, backend)
        for name, ms in _peer_host_ms(sizes, layout, gen, host).items():
            out["timing"][str(layout)][name]["host_ms_per_call"] = ms
        say(f"[hierarchical] peer rings on pod {layout[0]} x data {layout[1]}: "
            + json.dumps(out["timing"][str(layout)]))

    cfg = make_config()
    grads0 = {}
    for strategy, reducer, (pods, data) in HIER_RUNS:
        run = f"{strategy}x{reducer}@{pods}x{data}"
        mesh = make_pod_mesh(pods, data)
        pipe = ImagePipeline(cfg.img_size, cfg.num_classes, 256, seed=0, mesh=mesh,
                             rank=rank, device="cuda")
        model = ResNet(cfg, init_params(cfg, seed=0, device="cuda"))
        opt = sgd(linear_scaling_rule(0.1, 256, 256), momentum=0.9)
        ts = make_train_step(cfg, mesh, GradSyncConfig(strategy=strategy, reducer=reducer),
                             opt, model=model, clip_norm=1.0, device="cuda")
        captured = {}
        if run == "funnelxhierarchical_ring@2x2":
            ts.gradsync.reducer = _capturing(ts.gradsync.reducer, captured)
        named = flatten_with_names(model.params_tree())[0]
        opt_state = opt.init(dict(named))
        step_sizes = [b.size for b in ts.gradsync.plan.buckets]
        predicted = {k: v * REDUCER_STEPS for k, v in
                     hier_launches(step_sizes, reducer, data).items()}
        predicted.update(accum=0, quantize=0, sum_quantize=0, dequantize=0, dequantize_sum=0)
        memops_predicted = {k: v * REDUCER_STEPS for k, v in
                            hier_memops(step_sizes, reducer, data).items()}
        trainer = Trainer(ts, pipe, log_every=10 ** 9, printer=lambda _m: None)
        ck.RS_LAUNCHES = ck.AG_LAUNCHES = ck.ACCUM_LAUNCHES = 0
        qk.QUANTIZE_LAUNCHES = qk.DEQUANTIZE_LAUNCHES = qk.DEQUANTIZE_SUM_LAUNCHES = 0
        qk.SUM_QUANTIZE_LAUNCHES = 0
        memops0 = ck.stream_memops()
        for step in range(REDUCER_STEPS):
            model, opt_state, hist = trainer.run(model, opt_state, step + 1,
                                                 start_step=step)
            if step == 0:
                grads0[run] = [p.grad.detach().clone() for _, p in named]
            _same_on_every_rank([p for _, p in named], f"{run} params after step {step}",
                                host)
        launches = {"rs": ck.RS_LAUNCHES, "ag": ck.AG_LAUNCHES,
                    "accum": ck.ACCUM_LAUNCHES, "quantize": qk.QUANTIZE_LAUNCHES,
                    "sum_quantize": qk.SUM_QUANTIZE_LAUNCHES,
                    "dequantize": qk.DEQUANTIZE_LAUNCHES,
                    "dequantize_sum": qk.DEQUANTIZE_SUM_LAUNCHES}
        memops = {k: v - memops0[k] for k, v in ck.stream_memops().items()}
        if launches != predicted:
            raise AssertionError(f"{run}: launches {launches}, predicted {predicted}")
        if memops != memops_predicted:
            raise AssertionError(f"{run}: stream waits {memops}, predicted "
                                 f"{memops_predicted}")
        out["runs"][run] = {
            "launches": launches, "memops": memops, "buckets": len(step_sizes),
            "chains": len(ts.gradsync.groups),
            "first_step_ms": trainer.first_step_time * 1e3,
            "step_ms": [t * 1e3 for t in trainer.step_times],
            "loss": hist["losses"][-1]}
        if captured:
            # one captured bucket: the kernels against the plain rings, bit for bit
            from repro_torch.core.hierarchical import hierarchical_allreduce

            bucket, inp, _ = max(captured.values(), key=lambda c: c[1].numel())
            comm = ts.gradsync.groups[0]
            with_kernels = hierarchical_allreduce(inp.clone(), comm, use_ring=True)
            same_bits(with_kernels, _plain_hier(inp.clone(), comm),
                      f"hierarchical_ring of bucket {bucket.bucket_id}: kernels vs plain")
            comm.ring.check()
            out["captured_bucket"] = {"bucket": bucket.bucket_id, "elements": inp.numel()}
        ts.gradsync.close()
        say(f"[hierarchical] {run}: launches {launches} and stream waits {memops} "
            f"(= predictions), params "
            f"bit-identical on the {RING} ranks after each of {REDUCER_STEPS} steps; "
            f"first step {trainer.first_step_time * 1e3:.1f} ms, then "
            f"{[round(t * 1e3, 1) for t in trainer.step_times]} ms")
        del ts, model, opt_state, trainer

    # the same sums in another order: within rtol 1e-5 of flat's first-step grads
    worst = {}
    flat = grads0["funnelxflat@2x2"]
    for run, grads in grads0.items():
        w = 0.0
        for a, b in zip(grads, flat):
            tol = 1e-5 * b.abs().max().item()
            if not torch.allclose(a, b, rtol=1e-5, atol=tol):
                raise AssertionError(f"{run} vs flat grads differ by "
                                     f"{(a - b).abs().max().item()}")
            w = max(w, (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30))
        worst[run] = w
    out["vs_flat_max_diff_over_leaf_absmax"] = worst
    say(f"[hierarchical] first-step grads within rtol 1e-5 of flat's: {worst}; "
        f"bucket {out['captured_bucket']['bucket']} through hierarchical_ring on the "
        f"kernels = through the plain rings, bit for bit")
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _turn_rank(rank: int, workdir: str, tree: str) -> None:
    """One rank of ``peer_rings_in_turns``: the ``_peer_timing`` of the
    tree at ``tree`` (its own chip_smoke.py and src/) on both layouts;
    rank 0 writes the rows to ``workdir/turn.json``."""
    import datetime
    import importlib.util

    sys.path.insert(0, os.path.join(tree, "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke_of_tree",
                                                  os.path.join(tree, "chip_smoke.py"))
    tcs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tcs)
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_dist

    init_dist("cuda", backend="gloo", init_method=f"file://{workdir}/store",
              rank=rank, world_size=tcs.RING, timeout=datetime.timedelta(seconds=300))
    host = dist.new_group(backend="gloo")
    plan, _ = tcs.resnet50_plan()
    sizes = [b.size for b in plan.buckets]
    gen = torch.Generator(device="cuda").manual_seed(100 + rank)
    rows = {}
    for layout in tcs.HIER_LAYOUTS:
        rows[str(layout)] = tcs._peer_timing(sizes, layout, gen, host, "gloo")
        for name, ms in _peer_host_ms(sizes, layout, gen, host).items():
            rows[str(layout)][name]["host_ms_per_call"] = ms
    if rank == 0:
        with open(os.path.join(workdir, "turn.json"), "w") as f:
            json.dump(rows, f)
    dist.destroy_process_group()


def peer_rings_in_turns(parent: str) -> list:
    """By hand, on one card: the peer rings' step timing (``_peer_timing``,
    both layouts, four rank processes as in ``hierarchical``) of the tree
    at ``parent`` (a checkout of another commit, e.g. ``git archive``
    unpacked under build/) and of this tree, in turns: parent, this,
    this, parent.  Each tree runs its own code and builds its own
    library; the host's enqueue time a call is measured alike for both
    (``_peer_host_ms``).  Logs and returns each turn's rows."""
    import tempfile

    import torch.multiprocessing as mp

    parent = os.path.abspath(parent)
    for tree in (parent, ROOT):
        subprocess.run([sys.executable, "-c",
                        "import sys; sys.path.insert(0, 'src'); from "
                        "repro_torch.kernels.collectives import kernel; kernel.build_ring_p2p()"],
                       cwd=tree, check=True)

    def turn(tree):
        with tempfile.TemporaryDirectory(prefix="turn-") as wd:
            mp.spawn(_turn_rank, args=(wd, tree), nprocs=RING, join=True)
            with open(os.path.join(wd, "turn.json")) as f:
                return json.load(f)

    turns = trees_in_turns(parent, turn, "peer", brief=lambda rows: {
        lay: {k: {f: r[f] for f in ("ms", "device_ms", "host_ms_per_call", "bound_ms")}
              for k, r in rr.items()} for lay, rr in rows.items()})
    log("[peer turns] " + json.dumps(turns))
    return turns


def trees_in_turns(parent: str, turn, what: str, brief=None) -> list:
    """``turn(tree)`` on the tree at ``parent`` (a checkout of another
    commit, e.g. ``git archive`` unpacked under build/) and on this tree,
    in turns: parent, this, this, parent.  Logs each turn's rows (through
    ``brief`` where given) and returns [{"tree": ..., "rows": ...}]."""
    parent = os.path.abspath(parent)
    turns = []
    for name, tree in (("parent", parent), ("change", ROOT), ("change", ROOT),
                       ("parent", parent)):
        rows = turn(tree)
        turns.append({"tree": name, "rows": rows})
        log(f"[{what} turns] {name}: " + json.dumps(brief(rows) if brief else rows))
    return turns


def ring_quant_in_turns(parent: str) -> list:
    """By hand, on one card: ``phase_build`` and ``phase_ring_quant`` of
    the tree at ``parent`` and of this tree, each turn a fresh process
    that runs its tree's own script (so its own kernels and launch paths),
    through ``trees_in_turns``; logs each turn's row 6 and 7 times."""
    code = ("import json, chip_smoke as cs; cs.phase_build(); "
            "print('RING_QUANT ' + json.dumps(cs.phase_ring_quant()), flush=True)")

    def turn(tree):
        res = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True,
                             text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"ring_quant turn in {tree} failed:\n"
                               f"{res.stdout[-3000:]}{res.stderr[-3000:]}")
        return json.loads(res.stdout.split("RING_QUANT ", 1)[1].splitlines()[0])

    keys = ("ms", "device_ms", "host_ms_per_launch", "replaced_ms", "replaced_device_ms",
            "parent_path_ms", "parent_path_host_ms_per_launch")

    def brief(rows):
        return {name: {k: r[k] for k in keys if k in r} for name, r in rows.items()
                if name in ("quantize_blocks_kernel", "dequantize_sum_blocks_kernel",
                            "dequantize_sum_quantize_blocks_kernel", "quantize_step",
                            "dequantize_step")}

    return trees_in_turns(parent, turn, "ring_quant", brief=brief)


def phase_hierarchical(backend: str = "gloo") -> dict:
    """Four rank processes: the peer-ring kernels and the hierarchical
    reducers under GradSync at full ResNet-50/CIFAR width, on pod 2 x
    data 2 and pod 1 x data 4.  With gloo (as ``main`` runs it) all four
    share the one card; ``backend="nccl"`` needs four cards, one a rank,
    and the intra-pod rings then cross NVLink."""
    import tempfile

    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="hierarchical-") as wd:
        mp.spawn(_hier_rank, args=(wd, backend), nprocs=RING, join=True)
        ranks = []
        for r in range(RING):
            with open(os.path.join(wd, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    for r, res in enumerate(ranks):
        if {k: v["launches"] for k, v in res["runs"].items()} != \
                {k: v["launches"] for k, v in ranks[0]["runs"].items()}:
            raise AssertionError(f"rank {r} launched other counts than rank 0")
    res = ranks[0]
    res["wall_s"] = time.perf_counter() - t0
    res["transport"] = (
        f"gloo over pinned host memory for the stock collectives, {RING} processes on "
        f"one card; the intra-pod rings through CUDA IPC on that card"
        if backend == "gloo" else
        f"{backend}, {RING} processes on {torch.cuda.device_count()} cards; the "
        f"intra-pod rings over NVLink")
    log("[hierarchical] " + json.dumps(res))
    return res


# ------------------------------------------------------------------ serving
FLASH_SHAPES = (   # (B, S, Hq, Hkv, D, dtype, causal)
    (2, 128, 4, 2, 64, torch.float32, True),       # tests/test_kernels.py
    (1, 256, 2, 2, 128, torch.float32, False),
    (2, 128, 4, 1, 64, torch.bfloat16, True),
    (1, 512, 8, 4, 64, torch.float32, True),
    (2, 128, 2, 2, 256, torch.bfloat16, False),
    (4, 512, 16, 8, 128, torch.bfloat16, True),    # Qwen3-1.7B static prefill
    (1, 200, 16, 8, 128, torch.bfloat16, True),    # ragged last tile
    (2, 77, 4, 2, 16, torch.bfloat16, True),       # the smoke config's head dim
)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # test_kernels.py:34
# bf16 runs on the tensor-core kernel, f32 on the CUDA-core one (kernel.py)
FLASH_SOURCES = {torch.bfloat16: "src/repro_torch/kernels/flash_attention/csrc/flash_attention_tc.cu",
                 torch.float32: "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"}
FLASH_KERNEL_NAMES = {torch.bfloat16: "flash_fwd_tc_kernel", torch.float32: "flash_fwd_kernel"}
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
    max abs error, raises beyond the dtype's tolerance, logs the error as
    a share of it."""
    from repro_torch.kernels.flash_attention import kernel, ref

    got = kernel.flash_attention_fwd(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    tol = FLASH_TOL[q.dtype]
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        raise AssertionError(f"{what}: kernel vs plain max abs err {err} "
                             f"beyond atol=rtol={tol}")
    # the check's bound is tol + tol * |want|: the share of it, and of tol alone
    share = (diff / (tol + tol * want.float().abs())).max().item()
    ulps = ""
    if q.dtype == torch.bfloat16:
        # both sides against the f32 result of the same bf16 inputs, in
        # bf16 ulps of that result (8 significant bits)
        exact = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=causal)
        ulp = torch.exp2(torch.floor(torch.log2(exact.abs().clamp_min(2.0 ** -40))) - 7)
        ulps = (f"; mean bf16 ulps from the f32 result: kernel "
                f"{((got.float() - exact).abs() / ulp).mean().item()}, plain "
                f"{((want.float() - exact).abs() / ulp).mean().item()}")
    log(f"[flash] {what} ({FLASH_KERNEL_NAMES[q.dtype]}): max abs err {err} = "
        f"{share} of the bound atol + rtol |plain| ({err / tol} of atol = {tol}){ulps}")
    return err


def device_ms_per_launch(fn, kernel_name: str, reps: int = 50) -> float:
    """The device time per call of ``fn`` of the kernels named
    ``kernel_name`` (a whole word of the profiler's name, so that
    ``pack_bucket_kernel`` does not count ``unpack_bucket_kernel``), from
    torch.profiler."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    word = re.compile(rf"(?<![A-Za-z0-9_]){kernel_name}(?![A-Za-z0-9_])")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(_device_ms(e, self_only=True) for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and word.search(e.key)) / reps


def device_ms_clock_checked(fn, kernel_name: str | None, reps: int = 50) -> dict:
    """``device_ms_per_launch`` of one profiled loop, with a check of the
    profiler's clock: CUDA events around the same loop, and the span from
    the first of its kernels to the last on the profiler's clock.  Where
    the device runs the loop back to back, ``span_over_events`` is near 1;
    a smaller one says that the profiler's timestamps, and so its device
    times, read low by about that factor.  ``kernel_name`` None takes
    every device event; ``device_events_per_call`` counts those taken."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    word = (re.compile(rf"(?<![A-Za-z0-9_]){kernel_name}(?![A-Za-z0-9_])")
            if kernel_name is not None else re.compile(""))
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) == DeviceType.CUDA and word.search(e.key)]
    events_ms = start.elapsed_time(end)
    span_ms = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels)) / 1e3
    return dict(device_ms_per_launch=sum(e.time_range.elapsed_us() for e in kernels)
                / 1e3 / reps, events_ms_per_launch=events_ms / reps,
                span_over_events=span_ms / events_ms,
                device_events_per_call=len(kernels) / reps)


def flash_sass_counts() -> dict:
    """HGMMA (wgmma) and UTMALDG (TMA load) instructions in the built
    bf16 flash library, by cuobjdump; raises unless both are there."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(kernel.build_tc())],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
    if not all(counts.values()):
        raise AssertionError(f"bf16 flash library lacks tensor-core or TMA code: {counts}")
    log(f"[flash] {FLASH_KERNEL_NAMES[torch.bfloat16]} SASS: {counts}")
    return counts


def host_ms(fn, reps: int = 200) -> float:
    """Host time to enqueue one call of ``fn`` (host clock around ``reps``
    calls with no sync between them; the device drains after)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def phase_flash() -> dict:
    """Both flash kernels against the plain version on FLASH_SHAPES, then
    kernel, plain and SDPA times at both prefill shapes in bf16 (the
    tensor-core kernel) and at the static shape in f32 (the CUDA-core
    kernel), with each kernel's device time from torch.profiler."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref

    sass = flash_sass_counts()
    for i, (B, S, Hq, Hkv, D, dt, causal) in enumerate(FLASH_SHAPES):
        q, k, v = flash_inputs(B, S, Hq, Hkv, D, dt, seed=i)
        check_flash(q, k, v, causal, f"B{B} S{S} Hq{Hq} Hkv{Hkv} D{D} {dt} causal={causal}")
    rows = {}
    timed = [(name, shape, torch.bfloat16) for name, shape in PREFILL_SHAPES.items()]
    timed.append(("static_f32", PREFILL_SHAPES["static"], torch.float32))
    for name, (B, S, Hq, Hkv, D), dt in timed:
        q, k, v = flash_inputs(B, S, Hq, Hkv, D, dt, seed=100)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        bound, by, nbytes, flops = flash_bound(B, S, Hq, Hkv, D, dt)

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, enable_gqa=True)

        shape = f"B{B} S{S} Hq{Hq} Hkv{Hkv} D{D} {str(dt)[6:]} causal"
        rows[name] = dict(
            shape=shape, kernel=FLASH_KERNEL_NAMES[dt],
            max_abs_err=check_flash(q, k, v, True, f"{name} {shape}"),
            ms=cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True)),
            device_ms_per_launch=device_ms_per_launch(
                lambda: ops.flash_attention(q, k, v, causal=True), FLASH_KERNEL_NAMES[dt]),
            host_ms_per_launch=host_ms(lambda: ops.flash_attention(q, k, v, causal=True)),
            plain_ms=cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True)),
            library_ms=cuda_ms(sdpa),
            library_host_ms_per_launch=host_ms(sdpa),
            bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
        log(f"[flash] {name} prefill shape: " + json.dumps(rows[name]))
    rows["static"]["sass"] = sass
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


class DecodeLoopTimer:
    """Wraps a server's serve hooks (a tool of this script): CUDA events
    from each generate's first decode step's start to its last one's end,
    the decode loop's time on the device's clock with no extra sync."""

    def __init__(self, server):
        self.server, self.api, self.loops = server, server.api, []

        def prefill(*a, **kw):
            self.loops.append([torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True), 0])
            return self.api.prefill(*a, **kw)

        def decode_step(*a):
            loop = self.loops[-1]
            if loop[2] == 0:
                loop[0].record()
            out = self.api.decode_step(*a)
            loop[1].record()
            loop[2] += 1
            return out

        server.api = dataclasses.replace(self.api, prefill=prefill,
                                         decode_step=decode_step)

    def close(self, steps: int) -> list:
        """Restore the hooks; ms per decode step of each generate, each of
        which must have run ``steps`` decode steps."""
        self.server.api = self.api
        torch.cuda.synchronize()
        if any(n != steps for *_, n in self.loops):
            raise AssertionError(f"decode steps per generate: "
                                 f"{[n for *_, n in self.loops]}, expected {steps}")
        return [a.elapsed_time(b) / n for a, b, n in self.loops]


def tree_to(tree, device=None, dtype=None):
    if isinstance(tree, dict):
        return {n: tree_to(t, device, dtype) for n, t in tree.items()}
    return tree.to(device=device, dtype=dtype)


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
    api = server.api

    def timed_generate(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = generate(*a, **kw)                 # ends in a host copy
        gen_ms.append((time.perf_counter() - t) * 1e3)
        return out

    server.generate = timed_generate
    timer = DecodeLoopTimer(server)
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
        decode_ms = timer.close(SERVE_MAX_NEW - 1)

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
    f32_before = flash.FLASH_LAUNCHES        # the f32 checks run the CUDA-core kernel
    toks = left_pad(prompts[:4]).cuda()
    p32 = tree_to(params, dtype=torch.float32)
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
    f32_launches = flash.FLASH_LAUNCHES - f32_before
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
    report = {
        "card": smi, "model": cfg.name, "params": n_params,
        "requests": SERVE_REQUESTS, "prompt_lens": [len(p) for p in prompts],
        "max_new": SERVE_MAX_NEW, "max_len": SERVE_MAX_LEN,
        "flash_launches": launches, "flash_launches_f32_checks": f32_launches,
        "greedy_agreement_static_vs_continuous": agree,
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
    return {"launches": launches, "f32_launches": f32_launches, "report": report}


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


def phase_serve_profile(params, cfg, tag: str = "serve_profile") -> dict:
    """One static prefill (B 4, S 512) and three decode steps of the
    full-width model, through its family's serve hooks: their wall time
    without the profiler (host clock around synchronized work, median of
    3), then one run of each under ``torch.profiler`` for kernel time,
    launches and the kernels that take the most.  The device's idle share
    is 1 - kernel time / the unprofiled wall time (the profiler slows the
    host, not the kernels).  Runs after the main path's launch counts were
    read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.runtime import Server, sharded_argmax

    server = Server(cfg, make_smoke_mesh(1, 1), params, max_len=SERVE_MAX_LEN)
    api = server.api
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(1, cfg.vocab, (4, 512), generator=gen,
                         dtype=torch.int32).cuda()
    logits, cache = api.prefill(params, toks, cfg)     # warm-up
    cache = server._pad_cache(cache, 512)              # a KV cache grows to 1024
    tok = sharded_argmax(logits.float(), 1)
    torch.cuda.synchronize()

    def prefill():
        api.prefill(params, toks, cfg)

    def decode():
        nonlocal tok
        for pos in range(512, 515):
            lg, _ = api.decode_step(params, cache, tok, pos, cfg)
            tok = sharded_argmax(lg.float(), 1)

    def wall_ms(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    out = {}
    for name, fn in (("prefill B4 S512", prefill),
                     (f"decode B4, 3 steps at 512-514, max_len {SERVE_MAX_LEN}",
                      decode)):
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
        flash_ms = sum(_device_ms(e, self_only=True) for e in kernels
                       if "flash_fwd" in e.key)
        wkv = [e for e in kernels if "wkv_" in e.key]
        out[name] = {
            "flash_kernel_ms": flash_ms,
            "flash_share_of_kernel_ms": flash_ms / busy_ms,
            "wkv_kernel_ms": sum(_device_ms(e, self_only=True) for e in wkv),
            "wkv_kernel_launches": sum(e.count for e in wkv),
            "wall_ms": plain_ms,
            "wall_ms_under_profiler": prof_ms,
            "kernel_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / plain_ms,
            "device_idle_share_under_profiler": 1 - busy_ms / prof_ms,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "ms": round(_device_ms(e, self_only=True), 3)}
                            for e in top]}
    log(f"[{tag}] " + json.dumps(out))
    return out


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
        p = tree_to(params, device)
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


# ------------------------------------------------------------- rwkv serving
WKV_SHAPES = (   # (B, C, H, N, dtype of r, k, v): the one-chunk entry
    (2, 32, 4, 64, torch.float32),      # tests/test_kernels.py
    (1, 64, 2, 64, torch.float32),
    (2, 16, 8, 64, torch.bfloat16),
    (4, 32, 64, 64, torch.float32),     # RWKV-6 7B prefill chunk (static, B 4)
    (4, 1, 64, 64, torch.float32),      # its decode step
    (1, 7, 64, 64, torch.float32),      # a prompt shorter than the chunk
    (2, 16, 4, 16, torch.float32),      # the smoke config's head size
)
WKV_TOL = {torch.float32: 5e-4, torch.bfloat16: 5e-2}   # test_kernels.py:80
WKV_TIMED = {"prefill": (4, 32, 64, 64), "decode": (4, 1, 64, 64)}
WKV_SEQ_SHAPES = (   # (B, S, H, N, chunk, dtype of r, k, v): one launch a layer
    (4, 512, 64, 64, 32, torch.bfloat16),   # RWKV-6 7B prefill layer (static, B 4)
    (4, 512, 64, 64, 32, torch.float32),
    (4, 481, 64, 64, 32, torch.bfloat16),   # a ragged last chunk
    (1, 7, 64, 64, 32, torch.float32),      # below the chunk; B 1: 2 column splits
    (4, 1, 64, 64, 32, torch.bfloat16),     # a decode step
    (2, 23, 4, 16, 16, torch.float32),      # the smoke config
)
WKV_SEQ_TIMED = {"prefill": WKV_SEQ_SHAPES[0], "decode": WKV_SEQ_SHAPES[4]}
# (atol, rtol) of y; the state and f32 y as the chunk checks, bf16 y within
# one bf16 rounding of the plain version's f32 value
WKV_Y_TOL = {torch.float32: (5e-4, 5e-4), torch.bfloat16: (5e-4, 2 ** -7)}
WKV_LIBRARY = "none: no single PyTorch call computes a WKV chunk or sequence"


def _wkv_draw(rows: tuple, state: tuple, H, N, dtype, seed):
    """r, k, v (in ``dtype``) and logw of shape ``rows``, u (H, N) and a
    state of shape ``state``, drawn as tests/test_kernels.py draws them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    r, k, v = (normal(*rows).to(dtype) for _ in range(3))
    logw = -torch.exp(normal(*rows) * 0.5 - 2.0)
    return r, k, v, logw, normal(H, N) * 0.1, normal(*state) * 0.1


def wkv_inputs(B, C, H, N, dtype, seed):
    """The one-chunk entry's rows (BH, C, N), u and the state (BH, N, N)."""
    return _wkv_draw((B * H, C, N), (B * H, N, N), H, N, dtype, seed)


def wkv_seq_inputs(B, S, H, N, dtype, seed):
    """A layer's r, k, v, logw (B, S, H, N), u and the state (B, H, N, N)."""
    return _wkv_draw((B, S, H, N), (B, H, N, N), H, N, dtype, seed)


def wkv_chunk_flops(c: int, n: int) -> int:
    """The products one (b, h) row of a chunk of ``c`` rows needs at head
    size ``n``: the inter-chunk read and the state update in full (2·c·n²
    each), the scores and their product with v on the strictly lower
    triangle only (c·(c − 1)·n each), since the rest is masked to zero."""
    return 4 * c * n * n + 2 * c * (c - 1) * n


def wkv_bound(r, k, v, logw, u, state):
    """Least time for one chunk on this card: every input read once and y,
    s1 written once (f32) against the memory rate; the chunk's products
    (``wkv_chunk_flops``) against the f32 peak."""
    BH, C, N = r.shape
    nbytes = (sum(t.numel() * t.element_size() for t in (r, k, v, logw, u, state))
              + (BH * C * N + BH * N * N) * 4)
    flops = BH * wkv_chunk_flops(C, N)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[torch.float32]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def wkv_seq_bound(r, k, v, logw, u, state, chunk) -> dict:
    """Least time for one layer on this card: r, k, v, logw, u and the
    state read once, y (r's dtype) and the state written once, against the
    memory rate; every chunk's products (``wkv_chunk_flops`` a row, the
    ragged last chunk at its own length), against the f32 peak."""
    B, S, H, N = r.shape
    C = min(chunk, S)
    nbytes = (sum(t.numel() * t.element_size() for t in (r, k, v, logw, u, state))
              + r.numel() * r.element_size() + state.numel() * 4)
    flops = B * H * ((S // C) * wkv_chunk_flops(C, N) + wkv_chunk_flops(S % C, N))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[torch.float32] * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=nbytes, flops=flops, bytes_ms=bytes_ms, operations_ms=ops_ms)


@contextlib.contextmanager
def wkv_splits(splits: int):
    """Make the WKV kernel's wrapper take ``splits`` column splits for every
    shape (a tool of this script, to time the splits it does not pick)."""
    from repro_torch.kernels.rwkv6 import kernel

    choose = kernel.choose_splits
    kernel.choose_splits = lambda rows, n, c, sms: splits
    try:
        yield
    finally:
        kernel.choose_splits = choose


def check_wkv_seq(ins, chunk: int, what: str) -> tuple:
    """The sequence entry (one launch) against ``wkv_sequence_ref`` at the
    tolerances of WKV_Y_TOL; returns the max abs errors of y and the state."""
    from repro_torch.kernels.rwkv6 import kernel, ref

    before = kernel.WKV_LAUNCHES
    y, s1 = kernel.wkv_sequence_kernel(*ins, chunk)
    launched = kernel.WKV_LAUNCHES - before
    y_want, s_want = ref.wkv_sequence_ref(*ins, chunk)
    torch.cuda.synchronize()
    if launched != 1 or y.dtype != ins[0].dtype or s1.dtype != torch.float32:
        raise AssertionError(f"wkv {what}: {launched} launches, y {y.dtype}, state {s1.dtype}")
    atol, rtol = WKV_Y_TOL[ins[0].dtype]
    err_y = (y.float() - y_want.float()).abs().max().item()
    err_s = (s1 - s_want).abs().max().item()
    if not (torch.allclose(y.float(), y_want.float(), atol=atol, rtol=rtol)
            and torch.allclose(s1, s_want, atol=5e-4, rtol=5e-4)):
        raise AssertionError(f"wkv {what}: kernel vs plain max abs err y {err_y}, "
                             f"state {err_s}, beyond y atol {atol} rtol {rtol}, "
                             f"state 5e-4")
    log(f"[wkv] {what}: max abs err y {err_y} (atol {atol}, rtol {rtol}), state "
        f"{err_s} (5e-4); one launch")
    return err_y, err_s


def phase_wkv() -> dict:
    """The WKV kernel against its plain version on the card, its one-chunk
    entry and its sequence entry (one launch a layer), then their times
    (CUDA events, back to back, the device's own time per launch from
    torch.profiler, the host's enqueue time) beside the plain version's
    and the bounds."""
    from repro_torch.kernels.rwkv6 import kernel, ref
    from repro_torch.models import rwkv

    errs = {}
    for i, (B, C, H, N, dt) in enumerate(WKV_SHAPES):
        ins = wkv_inputs(B, C, H, N, dt, seed=i)
        y, s1 = kernel.wkv_chunk_kernel(*ins)
        y_want, s_want = ref.wkv_chunk_rows_ref(*ins)
        torch.cuda.synchronize()
        what = f"chunk B{B} C{C} H{H} N{N} {dt}"
        tol = WKV_TOL[dt]
        err = max((y - y_want).abs().max().item(), (s1 - s_want).abs().max().item())
        if not (torch.allclose(y, y_want, atol=tol, rtol=tol)
                and torch.allclose(s1, s_want, atol=tol, rtol=tol)):
            raise AssertionError(f"wkv {what}: kernel vs plain max abs err {err} "
                                 f"beyond atol=rtol={tol}")
        errs[(B, C, H, N, dt)] = err
        log(f"[wkv] {what}: max abs err {err} (tol {tol})")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    seq_errs = {}
    for i, (B, S, H, N, chunk, dt) in enumerate(WKV_SEQ_SHAPES):
        ins = wkv_seq_inputs(B, S, H, N, dt, seed=50 + i)
        splits = kernel.choose_splits(B * H, N, min(chunk, S), sms)
        seq_errs[(B, S, H, N, chunk, dt)] = check_wkv_seq(
            ins, chunk, f"sequence B{B} S{S} H{H} N{N} chunk {chunk} {dt}, "
                        f"{splits} split(s)")
    rows = {}
    by_split = {}       # the prefill layer at B 4 and at B 1, each split built
    for B, S, H, N, chunk, dt in (WKV_SEQ_TIMED["prefill"], (1, 512, 64, 64, 32,
                                                            torch.bfloat16)):
        ins = wkv_seq_inputs(B, S, H, N, dt, seed=100)
        picked = kernel.choose_splits(B * H, N, min(chunk, S), sms)
        for splits in kernel.SPLITS[N]:
            with wkv_splits(splits):
                check_wkv_seq(ins, chunk, f"B{B} S{S} layer at {splits} split(s)")

                def fn():
                    kernel.wkv_sequence_kernel(*ins, chunk)

                by_split[f"B{B} S{S} splits {splits}"] = dict(
                    ms=cuda_ms(fn), picked=splits == picked,
                    **device_ms_clock_checked(fn, "wkv_kernel"))
    log("[wkv] prefill layer by column split: " + json.dumps(by_split))
    for name, (B, S, H, N, chunk, dt) in WKV_SEQ_TIMED.items():
        ins = wkv_seq_inputs(B, S, H, N, dt, seed=100)
        C = min(chunk, S)

        def kern():
            kernel.wkv_sequence_kernel(*ins, chunk)

        def layer():
            rwkv.wkv_chunked(*ins, chunk)

        before = kernel.WKV_LAUNCHES
        layer()
        launches = kernel.WKV_LAUNCHES - before
        err_y, err_s = seq_errs[(B, S, H, N, chunk, dt)]
        rows[name] = dict(
            shape=f"B{B} S{S} H{H} N{N} chunk {chunk} {dt}",
            splits=kernel.choose_splits(B * H, N, C, sms),
            launches_per_call=launches, max_abs_err=max(err_y, err_s),
            ms=cuda_ms(kern), layer_ms=cuda_ms(layer),
            **device_ms_clock_checked(kern, "wkv_kernel"),
            host_ms=host_ms(kern),
            plain_ms=cuda_ms(lambda: ref.wkv_sequence_ref(*ins, chunk), reps=3, warmup=1),
            library_ms=None, library=WKV_LIBRARY, **wkv_seq_bound(*ins, chunk))
        if name == "prefill":
            rows[name]["by_split"] = by_split
        log(f"[wkv] {name} layer: " + json.dumps(rows[name]))
    for name, (B, C, H, N) in WKV_TIMED.items():
        ins = wkv_inputs(B, C, H, N, torch.float32, seed=100)
        bound, by, nbytes, flops = wkv_bound(*ins)
        device_ms = device_ms_per_launch(lambda: kernel.wkv_chunk_kernel(*ins),
                                         "wkv_kernel")
        rows[f"chunk_{name}"] = dict(
            shape=f"B{B} C{C} H{H} N{N} f32",
            max_abs_err=errs[(B, C, H, N, torch.float32)],
            ms=cuda_ms(lambda: kernel.wkv_chunk_kernel(*ins)),
            device_ms_per_launch=device_ms,
            plain_ms=cuda_ms(lambda: ref.wkv_chunk_rows_ref(*ins)),
            library_ms=None, library=WKV_LIBRARY,
            bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
        log(f"[wkv] {name} chunk: " + json.dumps(rows[f"chunk_{name}"]))
    return rows


def wkv_layer_probe() -> dict:
    """The prefill layer's WKV (``WKV_SEQ_TIMED["prefill"]``) through
    ``rwkv.wkv_chunked`` of whichever ``repro_torch`` is imported (this
    tree's, or another's in ``wkv_layers_in_turns``): ms a layer back to
    back (CUDA events), the host's enqueue time, and from torch.profiler
    the device time and launches of all its kernels and of the WKV
    kernel's alone, per layer."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.rwkv6 import kernel
    from repro_torch.models import rwkv

    B, S, H, N, chunk, dt = WKV_SEQ_TIMED["prefill"]
    ins = wkv_seq_inputs(B, S, H, N, dt, seed=100)

    def layer():
        rwkv.wkv_chunked(*ins, chunk)

    ms = cuda_ms(layer)
    before = kernel.WKV_LAUNCHES
    layer()
    wkv_launches = kernel.WKV_LAUNCHES - before
    reps = 20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            layer()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    wkv = [e for e in kernels if "wkv_" in e.key]
    return dict(ms=ms, host_ms=host_ms(layer), wkv_launches=wkv_launches,
                device_ms=sum(_device_ms(e, self_only=True) for e in kernels) / reps,
                kernel_launches=sum(e.count for e in kernels) / reps,
                wkv_device_ms=sum(_device_ms(e, self_only=True) for e in wkv) / reps)


def wkv_layers_in_turns(parent: str) -> list:
    """By hand, on one card: ``wkv_layer_probe`` of the tree at ``parent``
    and of this tree, through ``trees_in_turns``.  Each turn is a process
    that imports its tree's ``repro_torch`` first (so it runs that tree's
    WKV and builds that tree's library) and this script's probe after."""
    code = ("import sys; sys.path.insert(0, 'src'); import repro_torch.models.rwkv; "
            f"sys.path.insert(0, {ROOT!r}); import json, chip_smoke as cs; "
            "print('WKV_LAYER ' + json.dumps(cs.wkv_layer_probe()), flush=True)")

    def turn(tree):
        out = subprocess.run([sys.executable, "-c", code], cwd=tree, check=True,
                             capture_output=True, text=True, timeout=600).stdout
        return json.loads(out.split("WKV_LAYER ", 1)[1].splitlines()[0])

    return trees_in_turns(parent, turn, "wkv")


@contextlib.contextmanager
def plain_wkv():
    """Route the model's WKV (``ops.wkv_sequence``) to its plain version on
    the card (a tool of this script: the package never sends CUDA tensors
    there)."""
    from repro_torch.kernels.rwkv6 import ops, ref

    sequence = ops.wkv_sequence
    ops.wkv_sequence = ref.wkv_sequence_ref
    try:
        yield
    finally:
        ops.wkv_sequence = sequence


def check_rwkv_f32(params, cfg, prompt) -> dict:
    """Full width in f32 (TF32 off), one unpadded prompt at B 1.

    With random weights this model is chaotic in f32: a last-bit change
    grows about tenfold every four layers, so the plain path against
    itself at B 1 and B 2 (other GEMM shapes, the same math) already
    differs by more than 1e-3 in the last logits.  Hence:
    - every layer's block on the kernel path is held to rtol = atol =
      1e-3 against the same block with the plain WKV on the same input
      (teacher-forced: its output and its state);
    - the kernel path's last-position logits against the plain path's
      within rtol = atol = 1e-3, or within that B 1 / B 2 difference of
      the plain path when it is larger;
    - prefill of S - 2 tokens plus 2 decode steps against a prefill of S
      (the state hand-off), within 2e-3 or that difference."""
    from repro_torch.kernels.rwkv6 import kernel as wkv
    from repro_torch.models import rwkv

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = tree_to(params, dtype=torch.float32)
    seq = torch.as_tensor(prompt, dtype=torch.int32, device="cuda")[None]
    S = seq.shape[1]
    torch.cuda.reset_peak_memory_stats()
    before = wkv.WKV_LAUNCHES
    with plain_wkv():
        plain, _ = rwkv.prefill(p32, seq, cfg32)
        plain2, _ = rwkv.prefill(p32, seq.repeat(2, 1), cfg32)
    if wkv.WKV_LAUNCHES != before:
        raise AssertionError("the plain path launched the kernel")
    noise = (plain - plain2[:1]).abs().max().item()

    block, layer_diffs = rwkv.block, []

    def forced(p, x, cfg, state=None, lasts=None, out=None):
        # both on the same input state, each to a new one; then into ``out``
        got = block(p, x, cfg, state, lasts)
        with plain_wkv():
            want = block(p, x, cfg, state, lasts)
        for a, b, what in ((got[0], want[0], "output"), (got[1], want[1], "state")):
            if not torch.allclose(a, b, rtol=1e-3, atol=1e-3):
                raise AssertionError(f"f32 layer {len(layer_diffs)} {what}: kernel "
                                     f"vs plain differ by {(a - b).abs().max().item()}")
        layer_diffs.append(max((got[i] - want[i]).abs().max().item() for i in (0, 1)))
        return got if out is None else (got[0], out.copy_(got[1]), got[2])

    rwkv.block = forced
    try:
        kern, _ = rwkv.prefill(p32, seq, cfg32)
    finally:
        rwkv.block = block
    launched = wkv.WKV_LAUNCHES - before
    if launched != cfg.n_layers:                   # one a layer
        raise AssertionError(f"f32 prefill: {launched} kernel launches, expected "
                             f"{cfg.n_layers}")
    kern_vs_plain = (kern - plain).abs().max().item()
    if not (torch.allclose(kern, plain, rtol=1e-3, atol=1e-3) or kern_vs_plain <= noise):
        raise AssertionError(f"f32 prefill: kernel vs plain logits differ by "
                             f"{kern_vs_plain} (plain B1 vs B2: {noise})")
    _, state = rwkv.prefill(p32, seq[:, :S - 2], cfg32)
    _, state = rwkv.decode_step(p32, state, seq[:, S - 2], S - 2, cfg32)
    inc, _ = rwkv.decode_step(p32, state, seq[:, S - 1], S - 1, cfg32)
    torch.cuda.synchronize()
    inc_vs_full = (inc - kern).abs().max().item()
    if not (torch.allclose(inc, kern, rtol=2e-3, atol=2e-3) or inc_vs_full <= noise):
        raise AssertionError(f"f32: prefill(S-2) + 2 decode steps vs prefill(S) "
                             f"logits differ by {inc_vs_full} (plain B1 vs B2: {noise})")
    out = dict(prompt_len=S, layer_kernel_vs_plain_max_abs_diff=layer_diffs,
               kernel_vs_plain_logits_max_abs_diff=kern_vs_plain,
               plain_B1_vs_B2_logits_max_abs_diff=noise,
               decode_vs_prefill_logits_max_abs_diff=inc_vs_full,
               logits_max_abs=plain.abs().max().item(),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log("[rwkv_serve_f32] " + json.dumps(out))
    return out


def phase_rwkv_serve(smi: str) -> dict:
    """RWKV-6 7B at full width, bf16, tp=1, from seeded random weights on
    the card with the reference's constant leaves perturbed: the 8 serve
    prompts through the static engine (RequestQueue, batch 4: 2
    prefills), 32 new tokens each.  The WKV launch count must be exactly
    32 a prefill and 32 a decode step (one a layer); the continuous engine
    must refuse the family.  Then the f32 checks at full width
    (``check_rwkv_f32``), then report-only times and a profile."""
    from repro_torch.configs.rwkv6_7b import make_config
    from repro_torch.kernels.rwkv6 import kernel as wkv
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import rwkv
    from repro_torch.runtime import ContinuousScheduler, RequestQueue, Server
    from repro_torch.utils.trees import flatten_with_names

    cfg = make_config()
    t0 = time.perf_counter()
    params = rwkv.perturb_constant_leaves(rwkv.init_params(cfg, seed=0, device="cuda"))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for _, p in flatten_with_names(params)[0])
    log(f"[rwkv_serve] {cfg.name}: {n_params} params, {cfg.dtype}, chunk "
        f"{cfg.chunk}, init on the card in {time.perf_counter() - t0:.1f} s")
    server = Server(cfg, make_smoke_mesh(1, 1), params, max_len=SERVE_MAX_LEN)
    prompts = serve_prompts(cfg.vocab)

    timer = DecodeLoopTimer(server)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wkv.WKV_LAUNCHES = 0
    try:
        t0 = time.perf_counter()
        rq = RequestQueue(server, batch=4)
        handles = [rq.submit(p, SERVE_MAX_NEW) for p in prompts]
        done = 0
        while done < len(prompts):
            done += rq.serve_once()
        _results(handles, "rwkv static")
        wall_s = time.perf_counter() - t0
        launches = wkv.WKV_LAUNCHES
    finally:
        server.api = timer.api
    decode_ms = timer.close(SERVE_MAX_NEW - 1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # RequestQueue serves the prompts in order, 4 a batch, left-padded to
    # the batch's longest
    lens = [max(len(p) for p in prompts[i:i + 4]) for i in range(0, len(prompts), 4)]
    per_prefill = [cfg.n_layers for _ in lens]          # one launch a layer
    per_step = cfg.n_layers
    expected = sum(per_prefill) + len(lens) * (SERVE_MAX_NEW - 1) * per_step
    if launches != expected:
        raise AssertionError(f"{launches} WKV launches, expected {expected} "
                             f"({per_prefill} for the prefills, {per_step} a "
                             f"decode step)")
    if len(decode_ms) != len(lens):
        raise AssertionError(f"{len(decode_ms)} generates timed, expected {len(lens)}")
    try:
        ContinuousScheduler(server, slots=8, block_size=128, chunk=8)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("ContinuousScheduler accepted the rwkv family")

    f32 = check_rwkv_f32(params, cfg, prompts[0])
    torch.cuda.empty_cache()

    # report only: times of the pieces, after the counted run
    toks = left_pad(prompts[:4]).cuda()
    toks = torch.nn.functional.pad(toks, (512 - toks.shape[1], 0))   # S = 512
    prefill_ms = cuda_ms(lambda: rwkv.prefill(params, toks, cfg), reps=3, warmup=1)
    tokens = SERVE_REQUESTS * SERVE_MAX_NEW
    report = {
        "card": smi, "model": cfg.name, "params": n_params,
        "requests": SERVE_REQUESTS, "prompt_lens": [len(p) for p in prompts],
        "max_new": SERVE_MAX_NEW, "engine": "static, batch 4",
        "wkv_launches": launches, "wkv_launches_per_prefill": per_prefill,
        "wkv_launches_per_decode_step": per_step,
        "continuous_refused": refused, "f32": f32,
        "wall_s": wall_s, "tokens_per_s": tokens / wall_s, "peak_mem_gb": peak_gb,
        "prefill_ms_B4_S512": prefill_ms,
        "decode_ms_per_token_step_per_generate": decode_ms,
        "decode_ms_per_token_step": sum(decode_ms) / len(decode_ms),
    }
    log("[rwkv_serve] " + json.dumps(report))
    report["profile"] = phase_serve_profile(params, cfg, tag="rwkv_serve_profile")
    return {"launches": launches, "per_prefill": per_prefill, "per_step": per_step,
            "report": report}


def phase_rwkv_cpu_vs_gpu() -> None:
    """The rwkv smoke config, the same weights, greedy through
    ``Server.generate`` on the CPU (plain versions) and on the GPU (the
    kernel): tokens equal, f32 prefill logits within 1e-4."""
    import numpy as np

    from repro_torch.configs.rwkv6_7b import make_smoke
    from repro_torch.kernels.rwkv6 import kernel as wkv
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import rwkv
    from repro_torch.runtime import Server

    cfg = make_smoke()
    params = rwkv.perturb_constant_leaves(rwkv.init_params(cfg, seed=0, device="cpu"))
    prompts = np.random.default_rng(1).integers(1, cfg.vocab, (3, 23)).astype(np.int32)
    got = {}
    for device in ("cpu", "cuda"):
        p = tree_to(params, device)
        before = wkv.WKV_LAUNCHES
        toks = Server(cfg, make_smoke_mesh(1, 1), p, max_len=64).generate(prompts, 8)
        logits, _ = rwkv.prefill(p, torch.as_tensor(prompts, device=device), cfg)
        got[device] = (toks, logits.cpu(), wkv.WKV_LAUNCHES - before)
    (t_cpu, l_cpu, n_cpu), (t_gpu, l_gpu, n_gpu) = got["cpu"], got["cuda"]
    # one launch a layer for each prefill (23 tokens) and each decode step
    if n_cpu != 0 or n_gpu != cfg.n_layers * (1 + 7 + 1):
        raise AssertionError(f"WKV launches cpu {n_cpu} gpu {n_gpu}")
    if not np.array_equal(t_cpu, t_gpu):
        raise AssertionError(f"rwkv tokens differ: cpu {t_cpu} gpu {t_gpu}")
    diff = (l_cpu - l_gpu).abs().max().item()
    if not torch.allclose(l_cpu, l_gpu, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"rwkv prefill logits cpu vs gpu differ by {diff}")
    log(f"[rwkv_cpu_vs_gpu] {cfg.name}: greedy tokens equal on CPU and GPU "
        f"({prompts.shape[0]} prompts x 8); prefill logits max abs diff {diff} "
        f"(rtol = atol = 1e-4, f32); {n_gpu} WKV launches on the GPU")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a GPU", file=sys.stderr)
        return 1
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_dist

    faulthandler.dump_traceback_later(HANG_LIMIT_S, exit=True)
    # deterministic cuBLAS for lm_train's bit-identical losses: read when
    # the first CUDA context is made, so set before any
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
        ring_quant = phase_ring_quant()
        train = phase_train()
        phase_profile(*train["live"])
        phase_cpu_vs_gpu()
        del train["live"]
        gc.collect()
        torch.cuda.empty_cache()
        lm_rows = phase_lm_kernels()
        gc.collect()
        torch.cuda.empty_cache()
        lm = phase_lm_train()
        phase_lm_cpu_vs_gpu()
        gc.collect()
        torch.cuda.empty_cache()
        inception_rows = phase_inception_kernels()
        inception = phase_inception()
        phase_inception_cpu_vs_gpu()
        phase_verify()
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    reducers = phase_reducers()
    hier = phase_hierarchical()
    flash_rows = phase_flash()
    serve = phase_serve(smi)
    phase_serve_cpu_vs_gpu()
    gc.collect()                     # Qwen3's weights go before RWKV's
    torch.cuda.empty_cache()
    log(f"[env] {torch.cuda.memory_allocated() / 1e9} GB held before RWKV")
    wkv_rows = phase_wkv()
    rwkv_serve = phase_rwkv_serve(smi)
    phase_rwkv_cpu_vs_gpu()

    src = "src/repro_torch/kernels/collectives/csrc/staging.cu"
    replaces = {"pack": "src/repro/kernels/collectives/kernel.py:76",
                "unpack": "src/repro/kernels/collectives/kernel.py:99"}
    kernels = []
    for name, r in rows.items():
        by_path = {"train": train["launches"][name], "lm_train": lm["launches"][name],
                   "inception": inception["launches"][name]}
        kernels.append({
            "name": f"{name}_bucket_kernel", "route": "cuda", "source": src,
            "replaces": replaces[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path, "launches_per_step": 24, **r,
            "layouts_built_in_train": train["layouts_built"],   # shared by both
            # the LM's layouts: the post-backward buckets (bf16 leaves, f32
            # comm) and depcha's in-backward slots, one step's worth each
            "lm_train": {"launches_per_step": {k: v["launches_per_step"]
                                               for k, v in lm["runs"].items()},
                         "max_abs_err": lm_rows["max_abs_err"],
                         "post_backward": lm_rows["post_backward"][name],
                         "slots": lm_rows["slots"][name]},
            # Inception-BN's layouts: its full-width plan's buckets (f32)
            "inception": {"launches_per_step": {k: v["launches_per_step"]
                                                for k, v in inception["runs"].items()},
                          "max_abs_err": inception_rows["max_abs_err"],
                          "buckets": inception_rows["buckets"],
                          "step": inception_rows[name]}})
    fr, f32r = flash_rows["static"], flash_rows["static_f32"]
    kernels.append({
        "name": "flash_attention_fwd", "route": "cuda",
        "source": FLASH_SOURCES[torch.bfloat16],
        "replaces": "src/repro/kernels/flash_attention/kernel.py:78",
        "launches": serve["launches"], "launches_per_prefill": 28,
        "max_abs_err": fr["max_abs_err"], "ms": fr["ms"],
        "device_ms_per_launch": fr["device_ms_per_launch"],
        "plain_ms": fr["plain_ms"], "bound_ms": fr["bound_ms"],
        "bound_by": fr["bound_by"], "library_ms": fr["library_ms"],
        "shape": fr["shape"], "continuous_shape": flash_rows["continuous"],
        "sass": fr["sass"],
        # f32 inputs: the CUDA-core kernel, launched by serve's f32 checks
        "f32_kernel": {
            "name": "flash_attention_fwd (f32)", "route": "cuda",
            "source": FLASH_SOURCES[torch.float32],
            "replaces": "src/repro/kernels/flash_attention/kernel.py:78",
            "launches": serve["f32_launches"], "max_abs_err": f32r["max_abs_err"],
            "ms": f32r["ms"], "device_ms_per_launch": f32r["device_ms_per_launch"],
            "plain_ms": f32r["plain_ms"], "bound_ms": f32r["bound_ms"],
            "bound_by": f32r["bound_by"], "library_ms": f32r["library_ms"],
            "shape": f32r["shape"]}})
    wr = wkv_rows["prefill"]
    kernels.append({
        "name": "wkv_sequence_kernel", "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6/csrc/wkv.cu",
        "replaces": "src/repro/kernels/rwkv6/kernel.py:59",
        "launches": rwkv_serve["launches"],
        "launches_per_prefill": rwkv_serve["per_prefill"],
        "launches_per_decode_step": rwkv_serve["per_step"],
        "max_abs_err": wr["max_abs_err"], "ms": wr["ms"],
        "device_ms_per_launch": wr["device_ms_per_launch"],
        "profiler_span_over_events": wr["span_over_events"],
        "plain_ms": wr["plain_ms"], "bound_ms": wr["bound_ms"],
        "bound_by": wr["bound_by"], "library_ms": None, "library": WKV_LIBRARY,
        "shape": wr["shape"], "decode_shape": wkv_rows["decode"],
        # the same kernel's one-chunk entry, on the TPU kernel's layout
        "chunk_entry": {"name": "wkv_chunk_kernel", "prefill_chunk": wkv_rows["chunk_prefill"],
                        "decode_chunk": wkv_rows["chunk_decode"]}})
    runs = reducers["runs"]
    for name, counter, row in (("ring_accum_kernel", "accum", 3),
                               ("quantize_blocks_kernel", "quantize", 6),
                               ("dequantize_sum_quantize_blocks_kernel", "sum_quantize", 6),
                               ("dequantize_blocks_kernel", "dequantize", 7),
                               ("dequantize_sum_blocks_kernel", "dequantize_sum", 7)):
        r = ring_quant[name]
        kernels.append({
            "name": name, "row": row, "route": "cuda", "source": RING_QUANT_SOURCES[name],
            "replaces": RING_QUANT_REPLACES[name],
            "launches": sum(run["launches"][counter] for run in runs.values()),
            "launches_by_run": {k: run["launches"][counter] for k, run in runs.items()},
            **r})
    kernels[-3].update(entry_of="quantize_blocks_kernel",
                       also_replaces="src/repro/core/compression.py:79-89 (phases 2 and 3)",
                       main_path_step=ring_quant["quantize_step"])
    kernels[-1].update(entry_of="dequantize_blocks_kernel",
                       also_replaces="src/repro/core/compression.py:79 (phase 2's sum)",
                       main_path=False,
                       off_main_path="the fused entry runs phases 2-3 of the compressed "
                                     "reducers: 0 launches in the reducers runs",
                       check_launches=ring_quant["peer_sum_check_launches"],
                       peer_sum_path_step=ring_quant["dequantize_step"])
    hier_runs = {k: v for k, v in hier["runs"].items() if "hierarchical_ring" in k}
    for name, counter in (("ring_reduce_scatter_kernel", "rs"),
                          ("ring_all_gather_kernel", "ag")):
        r = hier["timing"][str(HIER_LAYOUTS[0])][name]
        kernels.append({
            "name": name, "route": "cuda", "source": P2P_SOURCE,
            "replaces": P2P_REPLACES[name],
            "launches": sum(run["launches"][counter] for run in hier_runs.values()),
            "launches_by_run": {k: run["launches"][counter] for k, run in hier_runs.items()},
            "memops": sum(run["memops"][counter] for run in hier_runs.values()),
            "wrap_checks": hier["wrap_checks"],
            **r, "timing_pod1x4": hier["timing"][str(HIER_LAYOUTS[1])][name]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
