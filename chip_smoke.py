#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

  build       compile every kernel source from ``csrc/`` for sm_90a.
  vision_train  in a process of its own with the next five phases
              (``phase_xr_train``: its 68.9 GB peak, on an NVIDIA H100
              80GB HBM3 at 700.00 W, does not fit beside what the main
              process caches):
              llama-3.2-vision-11b at full width cut to 10
              layers (8 self, 2 cross: its layer_pair depth; 3,231,805,442
              params) on a one-rank NCCL group, seq 1024 x global batch 4
              with img_embeds (4, 576, 4096) from the pipeline, gate_attn
              perturbed from its zero init, AdamW, clip 1.0, remat dots,
              deterministic algorithms, TF32 off: funnel, concom and
              depcha (in-scan: a LayerSync a stack behind one StackSyncs)
              through ``lm_run``.  Losses bit-identical across the
              strategies; step ms, tokens/s, peak GB; pack and unpack
              launches exactly the schedule's buckets plus depcha's slots
              a step; 10 in-backward collectives a depcha step (one a
              layer of each stack).  Then one depcha step with CUDA events
              at its stages.
  vision_cpu_vs_gpu  the vision smoke config (gate 0.5, the arch's image
              embeddings): one forward and backward on the CPU and on the
              card, loss and gradients within ``XR_CPU_GPU_TOL``.
  rwkv_train  first the WKV kernel's chunk-state output (training's
              forward) at RWKV-6 7B's training layer (B 4, S 1024, bf16)
              against the plain version's (5e-4), timed with and without
              it.  Then RWKV-6 7B at full width cut to 8 layers
              (2,296,811,520 params), constant leaves perturbed as
              rwkv_serve's, seq 1024 x batch 4, AdamW, clip 1.0, remat
              dots, as vision_train: losses bit-identical across the
              strategies; WKV launches exactly 16 a step (each layer's
              forward and the remat's recompute; the backward is tensor
              code); 16 in-backward collectives a depcha step (a bf16 and
              an f32 slot a layer); one depcha step's stages.
  rwkv_train_cpu_vs_gpu  the rwkv smoke config (ragged last chunk): one
              forward and backward on the CPU (plain WKV, float64
              backward) and on the card (the kernel, f32 backward), loss
              and gradients within ``XR_CPU_GPU_TOL``, 4 WKV launches on
              the card.
  zamba2_train  in the same process, after them:
              zamba2-2.7b at full width cut to 18 of its 54 Mamba-2
              layers (three groups, the shared attention block at 2
              sites; 986,599,136 params), for the script's time,
              constant leaves perturbed, seq 1024 x global batch 4,
              AdamW, clip 1.0, remat dots, deterministic algorithms, TF32
              off: funnel, concom and depcha through ``lm_run``.  Losses
              bit-identical across the strategies; step ms, tokens/s,
              peak GB; pack and unpack launches exactly the schedule's
              buckets plus depcha's slots a step; 36 in-backward
              collectives a depcha step (a bf16 and an f32 slot a layer);
              one depcha step under the profiler (kernel time, idle share)
              and one with CUDA events at its stages.  Then the zamba2
              smoke config's
              loss and gradients on the CPU and on the card, within
              ``ZAMBA2_CPU_GPU_TOL``.
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
  ckpt        the checkpoint manager under the Trainer's rungs: Qwen3-1.7B
              at full width cut to 2 layers (723,003,904 params, bf16;
              for disk and time), seq 1024 x batch 4, AdamW, clip 1.0,
              funnel, deterministic algorithms: 4 steps with an async
              ``CheckpointManager`` (every 2, keep 1) and a failure at
              step 3, recovered from step 2 and replayed, bit-equal to an
              uninterrupted run (params and AdamW state); the loop's hold
              a save, the background writes, the restore's read, the
              bytes a checkpoint takes and the free bytes under the temp
              directory; pack and unpack launches the plan's a step x the
              5 steps staged.
  lm_zero1    Qwen3-1.7B at full width cut to ``LM_ZERO1_LAYERS`` (7 of
              28, 974,683,904 params, for the script's time), as lm_train
              (seq 1024 x global batch 4, AdamW, remat dots, deterministic
              algorithms), 4
              microbatches a step (f32 accumulators), one rank: ZeRO-1
              scheduled and deferred (concom, clip 1.0; the optimizer runs
              inside GradSync's StepProgram, clipped by its NORM op),
              scheduled and monolithic at clip 0 (the monolithic optimizer
              does not clip, as the reference), and the plain step under
              funnel at clip 1.0; 1 warm-up + 2 timed steps each.  Pack and
              unpack launches exactly the plan's a step
              (``zero1_staging_launches``); deferred (flushed by
              ``finalize``) = scheduled and monolithic = scheduled at clip
              0, losses and every param bit for bit; the plain run's first
              loss equal to scheduled's, the others within rtol 1e-4 (its
              sync rounds the summed gradients to bf16 before AdamW, the
              zero1 runs update from the f32 sums).  Step ms, tokens/s, peak GB,
              ``mem.state_bytes``, each stage's device span (CUDA events),
              and one profiled scheduled step: the device spans of the
              UPDATE, NORM, RS and AG ops and the idle share.
  lm_zero1_cpu_vs_gpu  the quickstart LM's widths, scheduled zero1 under
              concom with 2 microbatches, clip 1.0, 3 steps on the CPU
              (plain versions) and on the card: losses within rtol 1e-5.
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
  lm_moe_kernels  rows 1-2 bit for bit against their plain versions at
              this slice's layouts: granite-moe's post-backward buckets
              (the f32 router beside the bf16 experts, f32 comm) and its
              two depcha slots a layer (bf16; the router's f32), and rank
              0's buckets and slots of Qwen3-1.7B with FSDP at lm_fsdp's
              depth and data 2 x model 2 (no FSDP leaf in them); granite's
              step timed.
  lm_moe      granite-moe-1b-a400m at full width (24 layers, d 1024,
              16/8 heads of 64, 32 experts, top 8, d_expert 512, bf16,
              seeded weights) as lm_train (seq 1024 x batch 4, AdamW,
              clip 1, remat dots, deterministic algorithms): funnel /
              concom / depcha, 1 warm-up + 2 timed steps; losses
              bit-identical; pack/unpack = the schedule's (+ two slots a
              layer under depcha); the share of routed slots the first
              step's forward drops (C 1280 at 4,096 tokens); a profiled
              depcha step and its stages by CUDA events.
  moe_cpu_vs_gpu  granite's and kimi's smoke configs (f32), one forward
              and backward on the CPU and on the card from the same
              weights and batch: loss and gradients within
              ``MOE_CPU_GPU_TOL``.
  lm_tp_kernels  rows 1-2 at the tensor-parallel layout, bit for bit
              against their plain versions: every bucket of rank 0's
              shards of Qwen3-1.7B at lm_tp's depth (``LM_RANKS_LAYERS``)
              and data 1 x model 4 (reduce sets
              ("data",) and ("data", "model"), bf16 → f32) and each
              layer's two depcha slots (bf16), a step's worth timed; row
              3's pair kernel on the hops of the two-axis ring of data 2 x
              model 2 (rings of 2 on each replicated bucket and its half).
  pp_kernels  rows 1-2 at the pp phase's layouts, bit for bit against
              their plain versions: every bucket of rank 0's staged plan
              (data 1 x stage 2 x model 2, its stage's 2 blocks, the
              stage-replicated leaves over "stage" too) and of its
              stage-1 twin's (``pp_plan``), a staged step's worth timed.
  lm_tp       tensor parallelism: four rank processes on the one card
              (gloo, every collective staged through pinned host memory),
              which then run lm_fsdp, reducers, zero1, hierarchical and
              elastic in turn (``spawn_turns``: the processes start and
              end once).
              First serving: Qwen3-1.7B at full width and
              ``SERVE_RANKS_LAYERS`` layers (4 of 28, for the script's
              time), bf16, use_flash, on data 1 x model 4 from the seeded
              weights: the model-axis collectives of a prefill and a
              decode step with its greedy pick counted against
              ``serve_collectives``; the static engine on the serving
              prompts' first 4 (left-padded, 32 greedy tokens) and the
              continuous engine on all 8 (8 slots, blocks of 128, chunk 8,
              32 tokens): prefill ms, decode ms a step, peak GB a rank,
              flash launches one a layer a prefill, tokens bit-identical on every
              rank; then the f32 check at 2 layers, tp = 4 against tp = 1
              (``SERVE_F32_ATOL``, tokens equal).  Then training:
              Qwen3-1.7B at full width and ``LM_RANKS_LAYERS`` layers on
              data 1 x model 4 (16/4 q heads,
              8/4 kv heads sharded, ff 6144/4, vocab 151,936/4; seq 1024 x
              batch 4, AdamW, clip 1, remat dots, bf16), funnel / concom /
              depcha from the seeded weights (each rank draws the global
              tree and keeps its shards), 1 warm-up + 1 timed step: step
              ms, tokens/s, peak GB a rank, the model-axis collectives a
              step counted, sized and timed against ``lm_tp_collectives``,
              pack/unpack launches = the schedule's (+ two slots a layer
              under depcha), the replicated leaves bit-identical across
              the ranks, the first loss and the first (global) grad norm
              against the tp = 1 funnel of the same depth
              (``phase_lm_tp1``, ``LM_TP_FIRST_*_RTOL``),
              one funnel step's stages by CUDA events.  Then the
              reference's f32 ``mk_dense``, one step through
              ``make_train_step`` with a binding clip (SGD at lr 0: its new
              state is the clipped gradients), at data 1 x model 4 against
              tp = 1 for every strategy and ring / compressed /
              hierarchical, and at data 2 x model 2 under ring (row 3 on
              the two-axis ring): loss, grad norm and clipped gradients at
              compare_tp's tolerances.  Then the pp phase (``_pp_ranks``):
              Qwen3-1.7B at ``PP_LAYERS`` layers on data 1 x stage 2 x
              model 2, gpipe, 1f1b and gpipe's stage-1 twin; rank 0's
              buckets those of ``pp_plan``, pack/unpack launches and hops
              a step exact, staged gpipe bit-identical to the twin, 1f1b's
              losses and grad norms against gpipe's (``PP_1F1B_*_RTOL``).
  lm_fsdp     FSDP: four rank processes on the one card as lm_tp.  First
              serving from FSDP's storage: Qwen3-1.7B at full
              width and ``SERVE_RANKS_LAYERS`` layers with ``fsdp=True``
              at data 2 x model 2, the
              collectives of a prefill and a decode step counted (the
              FSDP gathers too), the static engine at B 4 and the
              continuous engine on 4 prompts (4 slots, chunk 4), 8 tokens
              each, tokens bit-identical on every rank; then at 2 layers
              in f32 the continuous engine against each prompt served
              alone by the static one.  Then training: Qwen3-1.7B at
              ``LM_RANKS_LAYERS`` layers with ``fsdp=True`` at data 2 x
              model 2 (the block matrices stored sharded over "data" too,
              gathered a layer): funnel / concom / depcha, 1 warm-up + 1 timed
              step: step ms, tokens/s, peak GB and params a rank; the
              FSDP gathers and reduce-scatters (and the model psums) a
              step counted and sized against ``lm_fsdp_collectives``; no
              FSDP leaf in a GradSync bucket, depcha passing them
              through; the replicated leaves bit-identical across the
              ranks; the first loss and grad norm against the tp = 1
              funnel of the same depth.  Then f32 equivalences at the same mesh:
              check 5 on ``mk_dense`` (one AdamW step against dp 1 x tp
              1), ring and compressed (rows 3, 6-7) at compare_tp's
              tolerances, and granite's smoke config with FSDP against
              tp = 1 at the same dp.  (By hand on four cards:
              ``phase_lm_fsdp(backend="nccl", data=4, model=1)``.)
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
  zero1       four rank processes on the one card as ``reducers``:
              full-width ResNet-50/CIFAR at global batch 256, SGD with
              momentum 0.9, TF32 off, 1 warm-up + 2 steps of: the flat
              allreduce (concom x flat), ZeRO-1 scheduled under concom x
              flat, concom x ring and rsag x ring, deferred, all at clip
              1.0, and scheduled and monolithic at clip 0.  Params
              bit-identical across the ranks after every step; deferred
              (flushed) = scheduled and monolithic = scheduled at clip 0
              bit for bit; scheduled's params after one step within rtol
              1e-5 of flat's (atol 1e-5 of each leaf's largest value, as
              ``reducers`` holds the gradients), after three reported;
              pack, unpack and ring-combine launches exactly the plan's;
              each rank's ``mem.state_bytes``, its optimizer state the flat
              run's / 4 plus the buckets' padding.
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
  elastic     rows 1-2 bit for bit at the state codec's layouts (rank 0's
              dp plans of both rungs, f32 both ways), before the spawn;
              then, the spawn's last turn (it wraps library functions for
              the process's life), four rank processes on the one card
              over gloo: Qwen3-1.7B's widths in
              f32 cut to 1 layer, seq 256 x global batch 4, ZeRO-1
              scheduled, concom, AdamW, clip 0, the ``Supervisor`` over
              the ladder data 2 x model 2 → data 2 x model 1 (world ranks
              0 and 1): a transient at step 1, a rank loss at 2, 2
              checkpoint-I/O faults, grow-back after 1, 4 steps; then its
              clean scripted replay.  The script ((2, tp1), (3, tp2)) and
              faulty ≡ clean bit for bit on every rank; each transition's
              bytes >= 3 x the params x 4 B; each codec program one pack
              or unpack launch a RESHARD op; each transition's latency and
              bytes, each rung's and rank's peak GB, the host seconds by
              piece.
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
  moe_serve   RWKV's weights freed first.  granite-moe-1b-a400m at full
              width (bf16, use_flash: row 8 at head_dim 64) through the
              static engine with serve's prompts: greedy tokens, prefill
              ms, decode ms a step, 48 flash launches (24 x 2 prefills),
              row 8 on layer 0's q/k/v.
  vision_serve  granite's weights freed first.  llama-3.2-vision-11b at
              full width and depth (40 layers: 32 self, 8 cross; bf16,
              use_flash; gate_attn perturbed): 4 prompts of 384-512
              tokens, one image each, through prefill, then 32 greedy
              decode_steps with the images.  32 flash launches a prefill
              (the self blocks only) and none in decode; row 8 on self
              layers 0 and 31's q/k/v; finite logits that the image
              moves; prefill ms and decode ms a step.
  zamba2_kernels  the vision model's weights freed first.  Rows 1-2 at
              zamba2_train's layouts, the leaves drawn on the card from the
              plan's shapes (no model): the 14 post-backward buckets that
              funnel stages (concom's are the same, depcha's a subset; one
              holds f32 beside bf16 leaves: two launches each way) and
              depcha's two slots of each of the 18 layers (bf16, and the
              240 f32 elements of A_log, D and dt_bias), bit for bit
              against the plain versions, outputs started as NaN, one
              launch each way a dtype's group of leaves.
  zamba2_serve  zamba2-2.7b at
              full width and depth (bf16, constant leaves perturbed): 4
              prompts of 384-512 tokens through ``Server.generate``, 32
              greedy tokens each; prefill ms, decode ms a step, peak GB;
              then decode against prefill at full width in f32 (prefill S
              − 2 and decode 2 against the prefill of S, atol = rtol =
              2e-3), and in bf16, report only.
  zamba2_serve_cpu_vs_gpu  the zamba2 smoke config: a prefill into a ring
              smaller than the prompt (37 tokens, window 16) and 20 decode
              steps that wrap it, CPU against card (1e-4), and greedy
              tokens through ``Server.generate`` equal.

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
HANG_LIMIT_S = 1180             # dump stacks and exit before the 1200 s limit


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
    a1, b1 = a.reshape(-1), b.reshape(-1)
    step = 1 << 26          # in slices: a bucket of the LM's one-bucket plan is 8 GB
    err = max(((a1[i:i + step].double() - b1[i:i + step].double()).abs().max().item()
               for i in range(0, a1.numel(), step)), default=0.0)
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
        if live is not None:
            live[0].close()
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
        ts.close()
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


# ------------------------------------------------------- the simulator

SIM_REPS = 3                   # the measured replay's timed runs an op
SIM_FIT_KIB = (16, 64, 256, 1024, 4096)    # bucket sizes of the staging fit
SIM_FIT_BUCKETS = 8            # buckets timed a size (spread over the plan)
FIELDS = ("op_id", "bucket_id", "chain", "depends_on", "kind", "phase")


def op_fields(schedule) -> list:
    return [tuple(getattr(op, f) if f != "bucket_id" else op.bucket.bucket_id
                  for f in FIELDS) for op in schedule.ops]


L2_FLUSH_BYTES = 256 << 20     # written before each timed call: 5x the H100's 50 MB L2


def device_ms_each(fn, reps: int = 10, cold: bool = True) -> float:
    """The least device time of one call of ``fn``: CUDA events around
    each call, recorded behind a sleep kernel that holds the stream while
    the host enqueues them, so the host's launch gaps fall inside the
    sleep and not between the events.  ``cold``: a 256 MiB buffer is
    written before each call (outside its events), so ``fn`` reads and
    writes through HBM, not a warm L2."""
    fn()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda") if cold else None
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda._sleep(2_000_000)
    for start, end in pairs:
        if flush is not None:
            flush.fill_(1)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return min(start.elapsed_time(end) for start, end in pairs)


def staging_fit_rows(plan_of, flat) -> list:
    """One-direction staging rows (``obs/calibrate.py::fit_staging``'s
    input) of rows 1–2 on ResNet-50's gradients: for each bucket size of
    ``SIM_FIT_KIB``, ``SIM_FIT_BUCKETS`` of the plan's buckets spread over
    it, each pack and each unpack's device time (``device_ms_each``)."""
    from repro_torch.kernels.collectives import ops

    rows = []
    outs = [torch.empty_like(t) for t in flat]
    for kib in SIM_FIT_KIB:
        buckets = plan_of(kib << 10).buckets
        step = max(1, len(buckets) // SIM_FIT_BUCKETS)
        for b in buckets[::step][:SIM_FIT_BUCKETS]:
            buf = ops.fused_pack(b, flat, torch.float32)
            for way, fn in (("pack", lambda: ops.fused_pack(b, flat, torch.float32)),
                            ("unpack", lambda: ops.fused_unpack(b, buf, outs))):
                rows.append({"nbytes": float(b.size * 4), "num_leaves": len(b.leaves),
                             "fused": True, "t": device_ms_each(fn) / 1e3,
                             "warm_t": device_ms_each(fn, cold=False) / 1e3,
                             "bucket_kib": kib, "way": way})
    return rows


def phase_sim(train: dict) -> dict:
    """The simulator on the card, on ``phase_train``'s ResNet-50/CIFAR setup
    (batch 256, 24 buckets, ``TRAIN_STEPS`` steps):

    1. ``TRAIN_STEPS`` steps under ``GradSyncConfig(strategy="auto")``:
       ``last_auto_report()`` names a winner, the delegated schedule is the
       winner's own op for op, and the losses are bit-equal to the
       winner's fixed run (``phase_train``'s, else one here).
    2. One step's schedule replayed op by op (``measured_gradsync``,
       ``SIM_REPS`` reps): the replayed gradients bit-equal to ``execute``'s,
       rows 1–2 launched once a bucket a rep; each op's measured time
       beside ``simulate``'s under the port's defaults.
    3. ``fit_staging`` from rows 1–2 timed across bucket sizes
       (``SIM_FIT_KIB``), beside the data sheet's 3.35 TB/s and the
       port's defaults (fitted so in earlier runs).
    4. The Trainer's ``sim.step_time_s`` beside the measured steps."""
    from repro_torch.configs.resnet50_cifar import make_config
    from repro_torch.core import GradSyncConfig, make_bucket_plan, plan_sync
    from repro_torch.data import ImagePipeline
    from repro_torch.kernels.collectives import kernel
    from repro_torch.launch.mesh import make_dp_mesh
    from repro_torch.models.resnet import ResNet, init_params, param_specs
    from repro_torch.obs.calibrate import fit_staging
    from repro_torch.obs.measure import measured_gradsync
    from repro_torch.optim import linear_scaling_rule, sgd
    from repro_torch.runtime import Trainer, make_train_step
    from repro_torch.sim import default_network, last_auto_report, simulate
    from repro_torch.utils.trees import flatten_with_names, tree_unflatten

    t0 = time.perf_counter()
    cfg = make_config()
    mesh = make_dp_mesh()
    pipe = ImagePipeline(cfg.img_size, cfg.num_classes, 256, seed=0, mesh=mesh, device="cuda")
    lr = linear_scaling_rule(0.1, 256, 256)

    def run(strategy: str, keep: bool = False):
        model = ResNet(cfg, init_params(cfg, seed=0, device="cuda"))
        opt = sgd(lr, momentum=0.9)
        ts = make_train_step(cfg, mesh, GradSyncConfig(strategy=strategy), opt, model=model,
                             clip_norm=1.0, batch_like=pipe.batch_at(0), device="cuda")
        report = last_auto_report() if strategy == "auto" else None
        params = dict(flatten_with_names(model.params_tree())[0])
        trainer = Trainer(ts, pipe, log_every=10 ** 9, printer=lambda _m: None)
        model, _, hist = trainer.run(model, opt.init(params), TRAIN_STEPS)
        if not keep:
            ts.close()
        return ts, model, hist, report

    kernel.PACK_LAUNCHES = kernel.UNPACK_LAUNCHES = 0
    ts, model, hist, report = run("auto", keep=True)
    launches = {"pack": kernel.PACK_LAUNCHES, "unpack": kernel.UNPACK_LAUNCHES}
    gs = ts.gradsync
    winner = report.get("winner")
    if not winner or len(gs.plan.buckets) != 24:
        raise AssertionError(f"sim: auto report {report}, {len(gs.plan.buckets)} buckets")
    want_steps = 24 * TRAIN_STEPS
    if launches != {"pack": want_steps, "unpack": want_steps}:
        raise AssertionError(f"sim: auto run launched {launches}, expected {want_steps} each")
    params_like = model.params_tree()
    fixed = plan_sync(GradSyncConfig(strategy=winner), mesh, param_specs(params_like),
                      params_like)
    if op_fields(gs.schedule) != op_fields(fixed.schedule):
        raise AssertionError(f"sim: auto's schedule is not {winner}'s op for op")
    if winner in train["hists"]:
        want_losses, source = train["hists"][winner]["losses"], "phase_train"
    else:
        want_losses, source = run(winner)[2]["losses"], "a fixed run here"
    if hist["losses"] != want_losses:
        raise AssertionError(f"sim: auto losses {hist['losses']} are not bit-equal to "
                             f"{winner}'s {want_losses} ({source})")
    log(f"[sim] auto -> {winner} (network model: {report['net']}); ranking "
        + json.dumps(report["ranking"]) + f"; schedule = {winner}'s op for op; losses "
        f"{hist['losses']} bit-equal to {winner}'s ({source})")

    # 2. the measured replay of one step's schedule, against execute
    named = flatten_with_names(params_like)[0]
    grads = [p.grad.detach().clone() for _, p in named]

    def tree():
        return tree_unflatten(gs.plan.treedef, [g.clone() for g in grads])

    want = flatten_with_names(gs(tree()))[0]
    before = (kernel.PACK_LAUNCHES, kernel.UNPACK_LAUNCHES)
    got, tl, info = measured_gradsync(gs, tree(), reps=SIM_REPS)
    replay_launches = {"pack": kernel.PACK_LAUNCHES - before[0],
                       "unpack": kernel.UNPACK_LAUNCHES - before[1]}
    for (n, a), (_, b) in zip(flatten_with_names(got)[0], want):
        same_bits(a, b, f"sim: replayed {n}")
    if replay_launches != {"pack": 24 * SIM_REPS, "unpack": 24 * SIM_REPS}:
        raise AssertionError(f"sim: the replay launched {replay_launches}, expected "
                             f"{24 * SIM_REPS} each (one a bucket a rep)")
    launches = {k: launches[k] + replay_launches[k] for k in launches}
    predicted = {e.op_id: e for e in simulate(gs.schedule, gs.mesh_shape).events}
    ops_us = [{"op": e.op_id, "kind": e.kind, "bucket": e.bucket_id, "bytes": e.nbytes,
               "measured_us": e.duration * 1e6,
               "simulated_us": predicted[e.op_id].duration * 1e6} for e in tl.events]
    log(f"[sim] replay of {winner}'s {len(tl.events)} ops, {SIM_REPS} reps, min a rep "
        f"(serial clock, synchronize around each op): grads bit-equal to execute's; "
        f"rows 1-2 launched {replay_launches} (one a bucket a rep); measured "
        f"{tl.step_time * 1e3:.3f} ms in all vs simulated {sum(o['simulated_us'] for o in ops_us) / 1e3:.3f} ms; "
        "per op " + json.dumps(ops_us))
    ts.close()

    # 3. the staging fit from rows 1-2 across bucket sizes
    specs = param_specs(params_like)

    def plan_of(bucket_bytes):
        return make_bucket_plan(params_like, specs, mesh, bucket_bytes=bucket_bytes)

    flat = [g.clone() for g in grads]
    rows = staging_fit_rows(plan_of, flat)
    fitted, fit = fit_staging(rows)
    warm, warm_fit = fit_staging([dict(r, t=r["warm_t"]) for r in rows])
    default = default_network().staging
    log(f"[sim] staging fit over {len(rows)} rows ({SIM_FIT_BUCKETS} buckets a size of "
        f"{list(SIM_FIT_KIB)} KiB, pack and unpack, fused; device time a call, L2 "
        f"flushed before each): hbm_bw {fitted.hbm_bw / 1e12:.4f} TB/s = "
        f"{fitted.hbm_bw / HBM_BYTES_PER_S:.4f} of the data sheet's "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s (the port's default {default.hbm_bw / 1e12:.4f}, "
        f"fitted so earlier); leaf_overhead {fitted.leaf_overhead * 1e6:.3f} us a launch "
        f"(default {default.leaf_overhead * 1e6:.3f} us); rel residual "
        f"{fit['rel_residual']:.4f} ({fit['quality']}); warm L2: "
        f"{warm.hbm_bw / 1e12:.4f} TB/s, {warm.leaf_overhead * 1e6:.3f} us "
        f"({warm_fit['quality']}); rows " + json.dumps(rows))

    # 4. the Trainer's gauges beside the measured steps
    gauges = {"auto": {"sim_step_time_s": hist["metrics"]["sim.step_time_s"],
                       "sim_exposed_comm_s": hist["metrics"]["sim.exposed_comm_s"],
                       "step_s": hist["step_times"], "sim_compute": True}}
    for strat, h in train["hists"].items():
        gauges[strat] = {"sim_step_time_s": h["metrics"]["sim.step_time_s"],
                         "step_s": h["step_times"], "sim_compute": False}
    for k, g in gauges.items():
        g["ratio"] = g["sim_step_time_s"] / (sum(g["step_s"]) / len(g["step_s"]))
    log("[sim] ResNet-50 gauges (sim.step_time_s beside the timed steps; sim_compute "
        "only under auto): " + json.dumps(gauges))
    seconds = time.perf_counter() - t0
    out = {"winner": winner, "ranking": report["ranking"], "net": report["net"],
           "launches": launches, "replay_launches": replay_launches, "ops": ops_us,
           "fit": {"hbm_bw": fitted.hbm_bw, "leaf_overhead": fitted.leaf_overhead,
                   "share_of_sheet": fitted.hbm_bw / HBM_BYTES_PER_S,
                   "default": {"hbm_bw": default.hbm_bw,
                               "leaf_overhead": default.leaf_overhead}, **fit,
                   "warm": {"hbm_bw": warm.hbm_bw, "leaf_overhead": warm.leaf_overhead,
                            **warm_fit}},
           "gauges": gauges, "seconds": seconds}
    log(f"[clock] sim phase: {seconds:.1f} s")
    return out


AUTO_CARDS_TURNS = ("funnel", "concom", "depcha", "depcha", "concom", "funnel")
AUTO_CARDS_STEPS = 6           # 1 warm-up + 5 timed


def _auto_cards_rank(rank: int, workdir: str, backend: str) -> None:
    """One rank of ``phase_auto_cards``: ``auto``'s ResNet-50 run at data 4
    (ranked under the profile in ``$REPRO_TORCH_NETPROFILE_DIR``, if a
    good one is there), then funnel, concom and depcha in turns
    (``AUTO_CARDS_TURNS``); to ``workdir/rank<r>.json``."""
    import datetime

    import torch.distributed as dist

    from repro_torch.configs.resnet50_cifar import make_config
    from repro_torch.core import GradSyncConfig
    from repro_torch.data import ImagePipeline
    from repro_torch.launch.mesh import init_dist, make_dp_mesh
    from repro_torch.models.resnet import ResNet, init_params
    from repro_torch.optim import linear_scaling_rule, sgd
    from repro_torch.runtime import Trainer, make_train_step
    from repro_torch.sim import last_auto_report
    from repro_torch.utils.trees import flatten_with_names

    init_dist("cuda", backend=backend, init_method=f"file://{workdir}/store",
              rank=rank, world_size=RING, timeout=datetime.timedelta(seconds=300))
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_dp_mesh()
    out: dict = {}
    cfg = make_config()
    pipe = ImagePipeline(cfg.img_size, cfg.num_classes, 256, seed=0, mesh=mesh,
                         rank=rank, device="cuda")
    runs: dict = {}
    for strat in ("auto",) + AUTO_CARDS_TURNS:
        model = ResNet(cfg, init_params(cfg, seed=0, device="cuda"))
        opt = sgd(linear_scaling_rule(0.1, 256, 256), momentum=0.9)
        ts = make_train_step(cfg, mesh, GradSyncConfig(strategy=strat), opt, model=model,
                             clip_norm=1.0, batch_like=pipe.batch_at(0), device="cuda")
        if strat == "auto":
            out["auto"] = last_auto_report()
        params = dict(flatten_with_names(model.params_tree())[0])
        trainer = Trainer(ts, pipe, log_every=10 ** 9, printer=lambda _m: None)
        _, _, hist = trainer.run(model, opt.init(params), AUTO_CARDS_STEPS)
        runs.setdefault(strat, []).append({
            "step_s": hist["step_times"], "losses": hist["losses"],
            "sim_step_time_s": hist["metrics"]["sim.step_time_s"]})
        ts.close()
        del ts, model, trainer
    out["runs"] = runs
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def phase_auto_cards(backend: str = "nccl") -> dict:
    """By hand on one host with four cards (not in ``main``), after the
    NVLink fit (``python -m repro_torch.obs --fit`` on the same four cards,
    under the same ``REPRO_TORCH_NETPROFILE_DIR``): whether ``auto``
    under that profile picks the fastest of funnel, concom and depcha as
    measured in repeated pairs (a reading, not a check).  Writes
    ``chiprun_out/auto_cards.json``."""
    ranks, wall = spawn_ranks(_auto_cards_rank, (backend,), RING)
    res = ranks[0]
    mean = {k: [sum(r["step_s"]) / len(r["step_s"]) for r in v]
            for k, v in res["runs"].items()}
    pairs = {k: v for k, v in mean.items() if k in STRATEGIES}
    fastest = min(pairs, key=lambda k: sum(pairs[k]))
    res.update(wall_s=wall, mean_step_s=mean, fastest_measured=fastest,
               auto_picked_fastest=res["auto"]["winner"] == fastest,
               cards=[torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())])
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "auto_cards.json"), "w") as f:
        json.dump(res, f, indent=1)
    log("[auto_cards] " + json.dumps({k: v for k, v in res.items() if k != "runs"}))
    return res


def lm_gauges(lm: dict) -> dict:
    """``lm_train``'s runs' ``sim.step_time_s`` (no ``sim_compute`` under a
    fixed strategy: the schedule's communication alone) beside their
    timed steps."""
    out = {strat: {"sim_step_time_s": r["sim_step_time_s"],
                   "step_s": [t / 1e3 for t in r["step_ms"]],
                   "ratio": r["sim_step_time_s"] * 1e3 / (sum(r["step_ms"]) / len(r["step_ms"]))}
           for strat, r in lm["runs"].items()}
    log("[sim] Qwen3-1.7B gauges (lm_train's runs): " + json.dumps(out))
    return out


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
    targets = {}      # one set of outputs for each leaf list, in the plan's dtypes
    for b, lv in buckets_and_leaves:
        if id(lv) not in targets:
            targets[id(lv)] = [torch.empty_like(t) for t in lv]
        for l in b.leaves:
            if targets[id(lv)][l.index].dtype != l.dtype:
                targets[id(lv)][l.index] = torch.empty(l.shape, dtype=l.dtype, device="cuda")
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
                         launches=sum(staging_launches(b) for b, _ in buckets_and_leaves),
                         turns=turns)
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
    # the schedule's ops on the device: each op's annotation span, by kind
    comm: dict = {}
    for e in prof.events():
        if getattr(e, "device_type", None) == DeviceType.CUDA and e.name.startswith("comm."):
            kind = e.name.split(".")[1]
            calls, ms = comm.get(kind, (0, 0.0))
            comm[kind] = (calls + 1, ms + e.time_range.elapsed_us() / 1e3)
    return {
        "comm_device_ms": {k: {"ops": c, "ms": ms} for k, (c, ms) in sorted(comm.items())},
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
    spans: dict = {}
    for name, start, end in marks:      # a stage run once a microbatch: summed
        spans[name] = spans.get(name, 0.0) + start.elapsed_time(end)
    return {"wall_ms": wall_ms, "stage_ms": spans,
            "first_to_last_event_ms": marks[0][1].elapsed_time(marks[-1][2]),
            "stages_in_order": list(dict.fromkeys(name for name, _, _ in marks))}


def sync_slots(layer_sync) -> int:
    """The slots an in-backward sync stages a step: one a (reduce axes,
    dtype) group a layer, of every stack it covers (a ``StackSyncs`` holds
    the transformer's self and cross stacks)."""
    if layer_sync is None:
        return 0
    return sum(s.n_layers * len(s.buckets) for s in getattr(layer_sync, "syncs", (layer_sync,)))


def lm_run(strat: str, mesh, pipe, after=None, cfg=None, make_model=None) -> dict:
    """One strategy's run of Qwen3-1.7B (or ``cfg``; the model from
    ``make_model(cfg)``, by default a ``Transformer`` of the seeded
    weights): AdamW (cosine warm-up), clip 1.0, 1 warm-up + ``LM_STEPS`` -
    1 timed steps over ``pipe``.  Pack and unpack must launch exactly the
    schedule's buckets (plus the slots of a layer, a layer, under depcha)
    a step, and depcha must issue one in-backward collective a slot a
    layer a step, the others none.
    ``after(ts, model, opt_state, run)`` runs before the run's state is
    freed; its result is kept under "after"."""
    from repro_torch.core import GradSyncConfig
    from repro_torch.kernels.collectives import kernel
    from repro_torch.models.transformer import Transformer, init_params
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.runtime import Trainer, make_train_step
    from repro_torch.utils.trees import flatten_with_names

    cfg = cfg or lm_config(strat)
    model = (make_model(cfg) if make_model is not None
             else Transformer(cfg, init_params(cfg, seed=0, device="cuda")))
    opt = adamw(cosine_warmup(3e-4, 10, 100))
    ts = make_train_step(cfg, mesh, GradSyncConfig(strategy=strat), opt, model=model,
                         clip_norm=1.0, device="cuda")
    opt_state = opt.init(dict(flatten_with_names(model.params_tree())[0]))
    trainer = Trainer(ts, pipe, log_every=10 ** 9, printer=lambda _m: None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel.PACK_LAUNCHES = kernel.UNPACK_LAUNCHES = 0
    collectives, losses, norms = [], [], []
    for step in range(LM_STEPS):
        model, opt_state, hist = trainer.run(model, opt_state, step + 1, start_step=step)
        losses.append(hist["losses"][-1])
        norms.append(hist["metrics"]["grad_norm"])
        collectives.append(ts.layer_sync.collectives if ts.layer_sync is not None else 0)
    sim_step = hist["metrics"]["sim.step_time_s"]
    launches = {"pack": kernel.PACK_LAUNCHES, "unpack": kernel.UNPACK_LAUNCHES}
    slots = sync_slots(ts.layer_sync)
    per_step = sum(staging_launches(op.bucket) for op in ts.gradsync.schedule.ops) + slots
    if launches != {"pack": per_step * LM_STEPS, "unpack": per_step * LM_STEPS}:
        raise AssertionError(f"lm {strat}: launches {launches}, expected "
                             f"{per_step} a step x {LM_STEPS}")
    want = slots if strat == "depcha" else 0
    if collectives != [want] * LM_STEPS:
        raise AssertionError(f"lm {strat}: in-backward collectives {collectives}, "
                             f"expected {want} a step")
    times = trainer.step_times
    run = {"losses": losses, "grad_norms": norms,
           "first_step_ms": trainer.first_step_time * 1e3,
           "step_ms": [t * 1e3 for t in times],
           "tokens_per_s": [pipe.global_batch * LM_SEQ / t for t in times],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "launches_per_step": per_step,
           "buckets": len(ts.gradsync.schedule.ops),
           "in_backward_collectives_per_step": collectives,
           "sim_step_time_s": sim_step}
    if after is not None:
        run["after"] = after(ts, model, opt_state, run)
    ts.close()
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


def phase_lm_tp1() -> tuple:
    """The oracle of lm_tp's and lm_fsdp's first step: Qwen3-1.7B at full
    width and ``LM_RANKS_LAYERS`` layers on one rank under funnel, as
    ``lm_train`` runs it (``lm_run``: the same seeded weights and batch,
    AdamW, clip 1.0); its first loss and first grad norm."""
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import make_dp_mesh

    mesh = make_dp_mesh()
    pipe = TokenPipeline(lm_config().vocab, LM_SEQ, LM_BATCH, seed=0, mesh=mesh,
                         device="cuda")
    run = lm_run("funnel", mesh, pipe,
                 cfg=dataclasses.replace(lm_config("funnel"), n_layers=LM_RANKS_LAYERS))
    log(f"[lm_tp1] {LM_RANKS_LAYERS} layers, tp = 1: " + json.dumps(run))
    return run["losses"][0], run["grad_norms"][0]


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
        ts.close()
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


# ------------------------------------------------------------- MoE (LM)

MOE_CPU_GPU_TOL = (1e-5, 1e-4)   # moe_cpu_vs_gpu: loss rtol; grads' max diff / leaf absmax


def moe_config(strategy: str = "funnel"):
    """granite-moe-1b-a400m at full width (24 layers, d 1024, 16/8 heads
    of 64, 32 experts, top 8, d_expert 512, bf16), depcha's in-backward
    sync on exactly under the strategies that use it."""
    from repro_torch.configs.granite_moe_1b_a400m import make_config
    from repro_torch.core import get_strategy

    return make_config(depcha_in_scan=get_strategy(strategy).uses_in_scan)


def moe_drops(cfg, params, batch) -> dict:
    """The slots a forward of ``batch`` drops: each MoE layer's routed
    (token, expert) pairs beyond an expert's capacity C, counted from the
    layer's router on the layer's input (``moe_ffn`` wrapped by this
    script, under no_grad)."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf

    real, layers = tf.moe_ffn, []

    def tally(p, x, mcfg, axis):
        ids = torch.topk(torch.softmax(x.float() @ p["router"].float(), -1), mcfg.top_k).indices
        counts = torch.bincount(ids.reshape(-1), minlength=mcfg.num_experts)
        c = moe.capacity(x.shape[0], mcfg)
        layers.append((int(ids.numel() - counts.clamp(max=c).sum()), ids.numel(), c))
        return real(p, x, mcfg, axis)

    tf.moe_ffn = tally
    try:
        with torch.no_grad():
            tf.train_forward(params, batch, cfg)
    finally:
        tf.moe_ffn = real
    dropped, routed = sum(d for d, _, _ in layers), sum(n for _, n, _ in layers)
    return {"capacity": layers[0][2], "tokens": layers[0][1] // cfg.moe.top_k,
            "dropped": dropped, "routed": routed, "share": dropped / routed,
            "share_by_layer": [d / n for d, n, _ in layers]}


def moe_plan():
    """granite's post-backward bucket plan as GradSync builds it (4 MiB
    buckets, 4 channels, f32 comm: the f32 router beside the bf16 experts)
    and depcha's slots a layer (``layer_slots``: the bf16 leaves', the f32
    router's), on ``meta``."""
    from repro_torch.core import make_bucket_plan
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.transformer import _depcha_axes, init_params, param_specs
    from repro_torch.utils.trees import flatten_with_names

    cfg = moe_config("depcha")
    params = init_params(cfg, device="meta")
    plan = make_bucket_plan(params, param_specs(params, cfg), make_smoke_mesh(1),
                            bucket_bytes=4 * 1024 * 1024, num_channels=4)
    _, slots = layer_slots(params["blocks"], _depcha_axes(cfg, params["blocks"], "blocks/"))
    return plan, flatten_with_names(params)[0], slots, cfg


def fsdp_plan(data: int = 2, model: int = 2):
    """Rank 0's post-backward bucket plan of Qwen3-1.7B at lm_fsdp's depth
    (``LM_RANKS_LAYERS``) with FSDP at data ``data`` x model ``model`` (its
    shards' shapes, 4 MiB buckets, f32
    comm: no FSDP leaf in it) and its depcha slots (the FSDP leaves pass
    through), on ``meta``."""
    from repro_torch.core import make_bucket_plan
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.transformer import _depcha_axes, init_params, param_specs
    from repro_torch.parallel.sharding import localize_structs
    from repro_torch.utils.trees import flatten_with_names

    mesh = make_smoke_mesh(data, model)
    cfg = dataclasses.replace(lm_config("depcha"), tp=model, fsdp=True,
                              n_layers=LM_RANKS_LAYERS)
    full = init_params(cfg, device="meta")
    local = localize_structs(full, param_specs(full, cfg), mesh)
    plan = make_bucket_plan(local, param_specs(local, cfg), mesh,
                            bucket_bytes=4 * 1024 * 1024, num_channels=4)
    return plan, flatten_with_names(local)[0], local["blocks"], \
        _depcha_axes(cfg, local["blocks"], "blocks/"), cfg


def layer_slots(blocks_meta, axes):
    """The slots ``LayerSync`` stages a layer into, as it builds them: one
    bucket a (reduce axes, dtype), the leaves with no reduce axes passed
    through; with the stack's (name, leaf) list."""
    from repro_torch.core.buckets import Bucket, LeafInfo
    from repro_torch.utils.trees import flatten_with_names

    stack = flatten_with_names(blocks_meta)[0]
    groups: dict = {}
    for j, ((_, w), ax) in enumerate(zip(stack, axes)):
        if ax:
            groups.setdefault((tuple(ax), w.dtype), []).append(j)
    return stack, [(Bucket(tuple(LeafInfo(stack[j][0], j, tuple(stack[j][1].shape[1:]), dt,
                                          stack[j][1][0].numel()) for j in idx), ax, 0, k), dt)
                   for k, ((ax, dt), idx) in enumerate(groups.items())]


def phase_lm_moe_kernels() -> dict:
    """Rows 1-2 at this slice's layouts, bit for bit against their plain
    versions (outputs started as NaN), one launch each way a dtype's group
    of leaves (``staging_launches``): granite's post-backward buckets (bf16 experts and the f32
    router, f32 comm) and depcha's two slots a layer (bf16, and the
    router's f32: bit copies); rank 0's buckets of Qwen3-1.7B with FSDP at
    data 2 x model 2 (no FSDP leaf in them) and its depcha slots.  Then a
    step's worth of granite's timed in turns with one PyTorch call."""
    from repro_torch.kernels.collectives import kernel

    f32 = torch.float32
    gen = torch.Generator(device="cuda").manual_seed(0)
    plan, named, slot_buckets, cfg = moe_plan()
    flat = [torch.randn(p.shape, generator=gen, device="cuda").to(p.dtype) for _, p in named]
    err, n_checks = 0.0, 0

    def check(bucket, leaves, comm, what):
        nonlocal err, n_checks
        before = (kernel.PACK_LAUNCHES, kernel.UNPACK_LAUNCHES)
        err = max(err, check_bucket(bucket, leaves, comm, 1.0))
        n = staging_launches(bucket)          # one a dtype's group of leaves
        if (kernel.PACK_LAUNCHES - before[0], kernel.UNPACK_LAUNCHES - before[1]) != (n, n):
            raise AssertionError(f"{what}: expected {n} pack and {n} unpack launches")
        n_checks += 1

    for b in plan.buckets:
        check(b, flat, f32, f"granite bucket {b.bucket_id}")
    blocks = {n[len("blocks/"):]: t for (n, _), t in zip(named, flat) if n.startswith("blocks/")}
    names = sorted(blocks)
    rows = [[blocks[n][li] for n in names] for li in range(cfg.n_layers)]
    for b, dt in slot_buckets:
        for li in range(cfg.n_layers):
            check(b, rows[li], dt, f"granite slot {b.bucket_id} of layer {li}")
    mixed = sum(1 for b in plan.buckets if len({l.dtype for l in b.leaves}) > 1)
    out = {"granite": {"buckets": len(plan.buckets), "mixed_dtype_buckets": mixed,
                       "launches_a_way": sum(staging_launches(b) for b in plan.buckets),
                       "slots_per_layer": [(str(dt), b.size) for b, dt in slot_buckets],
                       "post_backward": time_staging([(b, flat) for b in plan.buckets], f32),
                       "slots": {str(dt): time_staging([(b, r) for r in rows], dt)
                                 for b, dt in slot_buckets}}}
    del flat, rows, blocks
    fplan, fnamed, fblocks_meta, faxes, fcfg = fsdp_plan()
    flat = [torch.randn(p.shape, generator=gen, device="cuda").to(p.dtype) for _, p in fnamed]
    fsdp_leaves = {n for n, _ in fnamed if n.startswith("blocks/")
                   and n.split("/")[1] in ("wq", "wo", "wg", "wu", "wdown")}
    if {l.name for b in fplan.buckets for l in b.leaves} & fsdp_leaves:
        raise AssertionError("an FSDP leaf in a post-backward bucket")
    for b in fplan.buckets:
        check(b, flat, f32, f"fsdp bucket {b.bucket_id}")
    stack, fslots = layer_slots(fblocks_meta, faxes)
    fb = {n[len("blocks/"):]: t for (n, _), t in zip(fnamed, flat) if n.startswith("blocks/")}
    frows = [[fb[n][li] for n, _ in stack] for li in range(fcfg.n_layers)]
    for b, dt in fslots:
        for li in range(fcfg.n_layers):
            check(b, frows[li], dt, f"fsdp slot {b.bucket_id} of layer {li}")
    torch.cuda.synchronize()
    out.update(max_abs_err=err, checks=n_checks,
               fsdp={"buckets": len(fplan.buckets), "elements": sum(b.size for b in fplan.buckets),
                     "slots_per_layer": [b.size for b, _ in fslots],
                     "passthrough_per_layer": len(fsdp_leaves)})
    log(f"[lm_moe_kernels] {n_checks} checks bit-exact (max abs err {err}): granite's "
        f"{len(plan.buckets)} buckets ({mixed} holding f32 and bf16 leaves) and "
        f"{len(slot_buckets)} slots a layer; Qwen3-1.7B FSDP rank 0 at 2x2: "
        f"{len(fplan.buckets)} buckets, {len(fslots)} slots a layer; " + json.dumps(out))
    return out


def phase_lm_moe() -> dict:
    """granite-moe-1b-a400m at full width on a one-rank NCCL group, seq
    1024 x batch 4, AdamW, clip 1.0, remat dots, under funnel, concom and
    depcha (in-scan, two slots a layer: bf16 and the f32 router),
    ``lm_run`` each under torch.use_deterministic_algorithms (restored
    after): losses bit-identical across the strategies, pack/unpack
    launches the schedule's buckets plus the slots a step.  Before the
    runs, the share of slots the first step's forward drops; after
    depcha, one profiled step and one with CUDA events at its stages."""
    import warnings

    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import make_dp_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.utils.trees import tree_leaves

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_dp_mesh()
    cfg = moe_config()
    pipe = TokenPipeline(cfg.vocab, LM_SEQ, LM_BATCH, seed=0, mesh=mesh, device="cuda")
    params = init_params(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in tree_leaves(params))
    drops = moe_drops(cfg, params, pipe.batch_at(0))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[lm_moe] {cfg.name}: {n_params} params; first step's forward drops "
        f"{drops['dropped']} of {drops['routed']} routed slots ({drops['share']}) at C "
        f"{drops['capacity']} of {drops['tokens']} tokens")

    def profiled(ts, model, opt_state, run):
        out = lm_profile(ts, model, opt_state, pipe, sum(run["step_ms"]) / len(run["step_ms"]))
        out["stages"] = lm_stage_spans(ts, model, opt_state, pipe)
        return out

    runs = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for strat in STRATEGIES:
                runs[strat] = lm_run(strat, mesh, pipe, cfg=moe_config(strat),
                                     after=profiled if strat == "depcha" else None)
                log(f"[lm_moe] {strat}: " + json.dumps(
                    {k: v for k, v in runs[strat].items() if k != "after"}))
        finally:
            torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    profile_out = runs["depcha"].pop("after")
    nondeterministic = sorted({str(w.message)[:200] for w in caught
                               if "deterministic" in str(w.message)})
    base = runs[STRATEGIES[0]]["losses"]
    for strat, r in runs.items():
        if not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"lm_moe {strat}: non-finite loss {r['losses']}")
        if r["peak_gb"] >= 80:
            raise AssertionError(f"lm_moe {strat}: peak {r['peak_gb']} GB")
        if r["losses"] != base:
            raise AssertionError(f"lm_moe {strat} losses {r['losses']} are not bit-identical "
                                 f"to {STRATEGIES[0]}'s {base} (nondeterministic ops: "
                                 f"{nondeterministic})")
    out = {"runs": runs, "profile": profile_out, "nondeterministic_ops": nondeterministic,
           "params": n_params, "first_step_drops": drops,
           "launches": {k: sum(r["launches"][k] for r in runs.values())
                        for k in ("pack", "unpack")},
           "shape": {"seq": LM_SEQ, "global_batch": LM_BATCH, "layers": cfg.n_layers}}
    log("[lm_moe] " + json.dumps({k: v for k, v in out.items() if k != "runs"}))
    return out


def phase_moe_cpu_vs_gpu() -> None:
    """granite's and kimi's smoke configs (f32, 8 experts, top 2; kimi
    with a shared expert): one forward and backward of the same weights
    and batch (seq 64 x batch 4) on the CPU (plain) and on the card, TF32
    off: the loss within rtol ``MOE_CPU_GPU_TOL[0]``, every gradient
    within ``MOE_CPU_GPU_TOL[1]`` of its leaf's largest."""
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.models.transformer import Transformer, init_params
    from repro_torch.utils.trees import flatten_with_names

    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    for arch in ("granite-moe-1b-a400m", "kimi-k2-1t-a32b"):
        cfg = get_arch(arch).make_smoke()
        weights = init_params(cfg, seed=0, device="cpu")
        got = {}
        for device in ("cpu", "cuda"):
            model = Transformer(cfg, tree_to(copy.deepcopy(weights), device))
            loss = model(TokenPipeline(cfg.vocab, 64, 4, seed=0, device=device).batch_at(0))
            loss.backward()
            got[device] = (loss.item(), {n: p.grad.detach().cpu() for n, p in
                                         flatten_with_names(model.params_tree())[0]})
        (l_cpu, g_cpu), (l_gpu, g_gpu) = got["cpu"], got["cuda"]
        worst = max(((g_gpu[n] - g).abs().max() / (g.abs().max() + 1e-12)).item()
                    for n, g in g_cpu.items())
        res[arch] = {"loss_cpu": l_cpu, "loss_gpu": l_gpu, "grad_rel": worst}
        if abs(l_gpu - l_cpu) > MOE_CPU_GPU_TOL[0] * abs(l_cpu) or worst > MOE_CPU_GPU_TOL[1]:
            raise AssertionError(f"moe_cpu_vs_gpu {arch}: {res[arch]} beyond {MOE_CPU_GPU_TOL}")
    log(f"[moe_cpu_vs_gpu] (loss rtol, grad rel) {MOE_CPU_GPU_TOL}: " + json.dumps(res))


# ------------------------------------------------------- ZeRO-1 and accumulation

LM_ZERO1_MB = 4                # microbatches a step: 1,024 tokens each
STATE_STRIDE = 64              # the moments sampled to check the clip: 15M of 974M elements
# lm_zero1's depth (full width), 7 of Qwen3-1.7B's 28 layers, for the
# script's time: its steps are host-bound (idle share 0.80 at 28 layers)
LM_ZERO1_LAYERS = 7
# (run, zero1 plan or None for the plain step, strategy, clip)
LM_ZERO1_RUNS = (("scheduled", "scheduled", "concom", 1.0),
                 ("deferred", "deferred", "concom", 1.0),
                 ("scheduled_noclip", "scheduled", "concom", 0.0),
                 ("monolithic", "monolithic", "concom", 0.0),
                 ("plain", None, "funnel", 1.0))


def zero1_staging_launches(gs, plan: str | None, named, microbatch: int = 1) -> dict:
    """Pack and unpack launches of one step of ``gs``'s schedule, one a
    group of at most ``MAX_LEAVES`` leaves of one dtype, with each leaf's
    dtype when it is staged: a gradient enters f32 under accumulation,
    else in its param's dtype; a sync op writes it back in its plan
    dtype; the zero1 updates are f32.  A pack and an unpack an allreduce,
    a pack a reduce-scatter (the gradients) and an UPDATE (the param
    shard), an unpack an all-gather; the monolithic optimizer's one
    bucket packs the gradients and the params and unpacks the updates.
    An allreduce over a group of one in a larger world (the model axis
    at tp=1) whose leaves are in the comm dtype, at loss scale 1, stages
    nothing."""
    import torch.distributed as dist

    from repro_torch.core.schedule import group_size
    from repro_torch.kernels.collectives.kernel import MAX_LEAVES

    params = dict(named)
    held = {n: torch.float32 if microbatch > 1 else p.dtype for n, p in named}

    def alone_bit_copy(op) -> bool:
        comm = op.bucket.comm_dtype or gs.plan.comm_dtype
        return (op.kind == "allreduce" and gs.cfg.loss_scale == 1.0
                and group_size(op.bucket.reduce_axes, gs.mesh_shape) == 1
                < dist.get_world_size()
                and all(l.dtype == comm for l in op.bucket.leaves))

    def groups(dtypes) -> int:
        count: dict = {}
        for d in dtypes:
            count[d] = count.get(d, 0) + 1
        return sum(-(-c // MAX_LEAVES) for c in count.values())

    pack = unpack = 0
    for op in gs.schedule.ops:
        names = [l.name for l in op.bucket.leaves]
        if alone_bit_copy(op):
            continue
        if op.kind in ("allreduce", "reduce_scatter"):
            pack += groups(held[n] for n in names)
        if op.kind == "update":
            pack += groups(params[n].dtype for n in names)
        if op.kind in ("allreduce", "all_gather"):
            unpack += groups(l.dtype for l in op.bucket.leaves)
            held.update({l.name: l.dtype for l in op.bucket.leaves})
    if plan == "monolithic":
        pack += groups(held.values()) + groups(p.dtype for p in params.values())
        unpack += groups(torch.float32 for _ in params)
    return {"pack": pack, "unpack": unpack}


def bit_sums(named) -> list:
    """Each leaf's bit patterns summed as integers: equal tensors give equal
    sums (a digest to compare runs by without keeping their params)."""
    return [int(bits(p.detach()).to(torch.int64).sum()) for _, p in named]


def optimizer_bytes(state) -> int:
    from repro_torch.utils.trees import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(state)
               if isinstance(t, torch.Tensor))


def lm_zero1_config(strategy: str = "concom"):
    """Qwen3-1.7B at full width cut to ``LM_ZERO1_LAYERS`` layers."""
    return dataclasses.replace(lm_config(strategy), n_layers=LM_ZERO1_LAYERS)


def lm_zero1_run(run: str, plan, strat: str, clip: float, mesh, pipe, after=None) -> dict:
    """One run of Qwen3-1.7B (``lm_zero1_config``) with ``LM_ZERO1_MB``
    microbatches a step from the seeded weights, 1 warm-up +
    ``LM_STEPS`` - 1 timed steps; pack and
    unpack must launch exactly the plan's a step.  A deferred run is
    flushed by ``finalize`` before its params are digested."""
    from repro_torch.core import GradSyncConfig
    from repro_torch.kernels.collectives import kernel
    from repro_torch.models.transformer import Transformer, init_params
    from repro_torch.optim import adamw, cosine_warmup, zero1
    from repro_torch.runtime import Trainer, make_train_step
    from repro_torch.utils.trees import flatten_with_names

    cfg = lm_zero1_config(strat)
    model = Transformer(cfg, init_params(cfg, seed=0, device="cuda"))
    opt = adamw(cosine_warmup(3e-4, 10, 100))
    if plan is not None:
        opt = zero1(opt, ("data",), 1)
    ts = make_train_step(cfg, mesh, GradSyncConfig(strategy=strat), opt, model=model,
                         clip_norm=clip, zero1_mode=plan is not None,
                         zero1_plan=plan or "scheduled", microbatch=LM_ZERO1_MB,
                         device="cuda")
    opt_state = ts.init_opt()
    trainer = Trainer(ts, pipe, log_every=10 ** 9, printer=lambda _m: None)
    named = flatten_with_names(model.params_tree())[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel.PACK_LAUNCHES = kernel.UNPACK_LAUNCHES = 0
    losses, norms = [], []
    sample = None
    for step in range(LM_STEPS):
        model, opt_state, hist = trainer.run(model, opt_state, step + 1, start_step=step)
        losses.append(hist["losses"][-1])
        norms.append(hist["metrics"]["grad_norm"])
        if step == 0 and plan == "scheduled":
            # every STATE_STRIDE-th element of the first step's AdamW moments
            sample = {k: {mv: st[mv]["shard"][::STATE_STRIDE].cpu() for mv in ("m", "v")}
                      for k, st in opt_state["inner"].items()}
        if not (math.isfinite(losses[-1]) and math.isfinite(norms[-1])):
            bad = [n for n, p in named if not bool(torch.isfinite(p).all())]
            bad += [f"state {n}" for n, t in flatten_with_names(opt_state)[0]
                    if isinstance(t, torch.Tensor) and not bool(torch.isfinite(t).all())]
            raise AssertionError(f"lm_zero1 {run}: step {step} loss {losses[-1]} grad norm "
                                 f"{norms[-1]}; non-finite after it: {bad}")
    launches = {"pack": kernel.PACK_LAUNCHES, "unpack": kernel.UNPACK_LAUNCHES}
    per_step = zero1_staging_launches(ts.gradsync, plan, named, LM_ZERO1_MB)
    if launches != {k: v * LM_STEPS for k, v in per_step.items()}:
        raise AssertionError(f"lm_zero1 {run}: launches {launches}, expected {per_step} "
                             f"a step x {LM_STEPS}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    times = trainer.step_times
    out = {"losses": losses, "grad_norms": norms,
           "first_step_ms": trainer.first_step_time * 1e3,
           "step_ms": [t * 1e3 for t in times],
           "tokens_per_s": [pipe.global_batch * LM_SEQ / t for t in times],
           "peak_gb": peak, "launches": launches, "launches_per_step": per_step,
           "state_bytes": hist["metrics"]["mem.state_bytes"],
           "optimizer_state_bytes": optimizer_bytes(opt_state),
           "ops": ts.gradsync.schedule.stats()["kinds"],
           "dp_bucket_sizes": [b.size for b in ts.gradsync.dp_plan.buckets]
           if ts.gradsync.dp_plan is not None else None,
           "state_sample": sample}
    if ts.finalize is not None:
        ts.finalize(model, opt_state)
    out["bit_sums"] = bit_sums(named)      # before ``after`` trains on
    if after is not None:
        out["after"] = after(ts, model, opt_state, out)
    ts.close()
    del ts, model, opt_state, trainer, named
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_zero1_layouts():
    """What lm_zero1's packs and unpacks see, on ``meta``: ``lm_zero1_config``'s
    zero1 dp plan as its scheduled runs plan it (concom, 4 MiB buckets, f32
    leaves and wire), the monolithic optimizer's one bucket of every leaf,
    the named params, and each leaf's dtype when the reduce-scatter packs
    it: the f32 accumulator, or the params' dtype where the model-axis
    sync (a group of one at world 1) wrote it back."""
    from repro_torch.core import GradSyncConfig
    from repro_torch.core.buckets import Bucket, LeafInfo
    from repro_torch.core.kvstore import plan_sync
    from repro_torch.launch.mesh import make_dp_mesh
    from repro_torch.models.transformer import init_params, param_specs
    from repro_torch.utils.trees import flatten_with_names

    cfg = lm_zero1_config("concom")
    params = init_params(cfg, device="meta")
    planned = plan_sync(GradSyncConfig(strategy="concom", exclude_axes=("data",),
                                       zero1_dp_axes=("data",), zero1_clip=True),
                        make_dp_mesh(), param_specs(params, cfg), params)
    named = flatten_with_names(params)[0]
    held = [torch.float32] * len(named)
    for op in planned.schedule.ops:
        if op.kind == "allreduce":
            for l in op.bucket.leaves:
                held[l.index] = l.dtype
    f32 = torch.float32
    mono = Bucket(tuple(LeafInfo(n, i, tuple(p.shape), f32, p.numel())
                        for i, (n, p) in enumerate(named)), ("data",), 0, 0, comm_dtype=f32)
    return planned.program.dp_plan, mono, named, held


def check_pack(leaves, comm, what: str) -> float:
    """Row 1 alone (a pack whose buffer no unpack reads: the UPDATE's param
    shard) into a buffer started as NaN, bit for bit against the plain
    version."""
    from repro_torch.kernels.collectives import kernel, ref

    total = sum(t.numel() for t in leaves)
    nan = torch.full((total,), float("nan"), dtype=comm, device="cuda")
    got = kernel.pack_bucket_kernel(leaves, comm, out=nan)
    return same_bits(got, ref.leafwise_pack(leaves, comm), what)


def phase_lm_zero1_kernels() -> dict:
    """Rows 1-2 at the layouts lm_zero1 gives them, bit for bit against
    their plain versions (outputs started as NaN): every bucket of the
    zero1 dp plan (the accumulated gradients, f32 but for the model-axis
    sync's bf16 leaves, packed to f32; the gathered f32 updates unpacked
    into fresh f32 tensors) and its bf16 params packed to f32 (the
    UPDATE's param shard); then the monolithic optimizer's one bucket of
    all 974,683,904 elements the same three ways (3.90 GB of f32: byte
    offsets past 2^31).  One step's worth of the dp plan's packs and
    unpacks timed as lm_kernels times its layouts."""
    from repro_torch.kernels.collectives import kernel

    dp_plan, mono, named, held = lm_zero1_layouts()
    gen = torch.Generator(device="cuda").manual_seed(0)
    grads = [torch.randn(p.shape, generator=gen, device="cuda").to(dt)
             for (_, p), dt in zip(named, held)]
    params = [torch.randn(p.shape, generator=gen, device="cuda").to(p.dtype) for _, p in named]
    f32 = torch.float32
    err, n_checks = 0.0, 0
    before = (kernel.PACK_LAUNCHES, kernel.UNPACK_LAUNCHES)
    for b in dp_plan.buckets:
        err = max(err, check_bucket(b, grads, f32, 1.0),
                  check_pack([params[l.index] for l in b.leaves], f32,
                             f"param shard pack b{b.bucket_id}"))
        n_checks += 2
    dp_launches = (kernel.PACK_LAUNCHES - before[0], kernel.UNPACK_LAUNCHES - before[1])
    timing = time_staging([(b, grads) for b in dp_plan.buckets], f32)
    torch.cuda.synchronize()
    err = max(err, check_bucket(mono, grads, f32, 1.0))
    gc.collect()
    torch.cuda.empty_cache()
    err = max(err, check_pack(params, f32, "monolithic param pack"))
    n_checks += 2
    torch.cuda.synchronize()
    out = {"max_abs_err": err, "checks": n_checks, "dp_buckets": len(dp_plan.buckets),
           "dp_bucket_sizes": [b.size for b in dp_plan.buckets],
           "dp_check_launches": {"pack": dp_launches[0], "unpack": dp_launches[1]},
           "monolithic_elements": mono.size, "monolithic_bytes": mono.size * f32.itemsize,
           "bf16_grad_leaves": sum(dt == torch.bfloat16 for dt in held),
           "step": timing}
    log(f"[lm_zero1_kernels] {n_checks} checks bit-exact (max abs err {err}): "
        f"{len(dp_plan.buckets)} dp buckets (gradients f32 -> f32 with "
        f"{out['bf16_grad_leaves']} bf16 leaves, updates f32 -> fresh f32, params "
        f"bf16 -> f32) and the monolithic bucket of {mono.size} elements "
        f"({mono.size * 4} bytes of f32) the same three ways; " + json.dumps(out))
    del grads, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def clip_check(runs: dict) -> dict:
    """The NORM op and the clip at full width.  Scheduled's first grad
    norm is the plain run's clip norm (rtol 1e-5: the plain sync rounds
    the summed gradients to bf16 before its norm: 2.6e-6 apart on an
    H100).  It binds (above 1.0), and the first step's
    AdamW moments, from zero, are the unclipped run's times the clip scale
    c = min(1, 1/(norm + 1e-9)): m · c and v · c² (rtol 2e-6, a few f32
    roundings), on every ``STATE_STRIDE``-th element of every bucket."""
    n0, p0 = runs["scheduled"]["grad_norms"][0], runs["plain"]["grad_norms"][0]
    if abs(n0 - p0) > 1e-5 * p0:
        raise AssertionError(f"lm_zero1: scheduled's first grad norm {n0} vs the plain "
                             f"run's clip norm {p0}: beyond rtol 1e-5")
    if not n0 > 1.0:
        raise AssertionError(f"lm_zero1: the clip 1.0 does not bind at norm {n0}")
    c = min(1.0, 1.0 / (n0 + 1e-9))
    clipped, free = runs["scheduled"]["state_sample"], runs["scheduled_noclip"]["state_sample"]
    worst = {"m": 0.0, "v": 0.0}
    n = 0
    for k, st in clipped.items():
        for mv, scale in (("m", c), ("v", c * c)):
            got, want = st[mv].double(), free[k][mv].double() * scale
            if not torch.allclose(got, want, rtol=2e-6, atol=1e-30):
                raise AssertionError(f"lm_zero1: bucket {k}'s clipped {mv} is not the "
                                     f"unclipped one times {scale}: max diff "
                                     f"{(got - want).abs().max().item()}")
            rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
            worst[mv] = max(worst[mv], rel)
            n += got.numel()
    if not any(float(st["m"].abs().max()) > 0 for st in free.values()):
        raise AssertionError("lm_zero1: the sampled moments are all zero")
    res = {"grad_norm": n0, "plain_clip_norm": p0, "rel_diff": abs(n0 - p0) / p0,
           "clip_scale": c, "moments_max_rel_err": worst, "elements": n}
    log("[lm_zero1] clip: " + json.dumps(res))
    return res


def phase_lm_zero1(lm_zero1_kernels: dict) -> dict:
    """Qwen3-1.7B (``lm_zero1_config``) under ZeRO-1 and accumulation on a
    one-rank NCCL group (``LM_ZERO1_RUNS``), deterministic algorithms on
    as in lm_train, on the dp plan ``lm_zero1_kernels`` checked.  Then one more scheduled
    step under the profiler and one with CUDA events around its stages."""
    import warnings

    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import make_dp_mesh

    def profiled(ts, model, opt_state, run):
        wall = sum(run["step_ms"]) / len(run["step_ms"])
        res = lm_profile(ts, model, opt_state, pipe, wall)
        res["stages"] = lm_stage_spans(ts, model, opt_state, pipe)
        return res

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
            for run, plan, strat, clip in LM_ZERO1_RUNS:
                runs[run] = lm_zero1_run(run, plan, strat, clip, mesh, pipe,
                                         after=profiled if run == "scheduled" else None)
                log(f"[lm_zero1] {run}: " + json.dumps(
                    {k: v for k, v in runs[run].items()
                     if k not in ("after", "bit_sums", "state_sample")}))
        finally:
            torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    profile_out = runs["scheduled"].pop("after")
    nondeterministic = sorted({str(w.message)[:200] for w in caught
                               if "deterministic" in str(w.message)})
    for run, r in runs.items():
        if not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"lm_zero1 {run}: non-finite loss {r['losses']}")
        if r["peak_gb"] >= 80:
            raise AssertionError(f"lm_zero1 {run}: peak {r['peak_gb']} GB")
    for a, b in (("deferred", "scheduled"), ("monolithic", "scheduled_noclip")):
        if runs[a]["losses"] != runs[b]["losses"] or runs[a]["bit_sums"] != runs[b]["bit_sums"]:
            raise AssertionError(f"lm_zero1: {a} is not bit-identical to {b}: losses "
                                 f"{runs[a]['losses']} vs {runs[b]['losses']}")
    if runs["scheduled"]["losses"][0] != runs["scheduled_noclip"]["losses"][0]:
        raise AssertionError("lm_zero1: the first step's loss depends on the clip")
    for run in ("scheduled", "deferred", "scheduled_noclip"):
        if runs[run]["dp_bucket_sizes"] != lm_zero1_kernels["dp_bucket_sizes"]:
            raise AssertionError(f"lm_zero1 {run}: dp plan {runs[run]['dp_bucket_sizes']} is "
                                 f"not the one lm_zero1_kernels checked")
    clip = clip_check(runs)
    # the plain step's sync writes the summed gradients back in the params'
    # dtype (bf16, as the reference's unpack does) before AdamW; the zero1
    # steps reduce-scatter the f32 sums: the same first loss, then apart by
    # what AdamW makes of that rounding (1.6e-5 at the third step).  The
    # NORM op and the clip are held above at 1e-5 and by the moments.
    plain, sched = runs["plain"]["losses"], runs["scheduled"]["losses"]
    if plain[0] != sched[0] or any(abs(a - b) > 1e-4 * abs(b) for a, b in zip(plain, sched)):
        raise AssertionError(f"lm_zero1: plain losses {plain} vs scheduled {sched}: not "
                             f"the same first loss, or beyond rtol 1e-4")
    for r in runs.values():
        del r["bit_sums"], r["state_sample"]
    out = {"runs": runs, "profile": profile_out, "nondeterministic_ops": nondeterministic,
           "clip": clip,
           "launches": {k: sum(r["launches"][k] for r in runs.values())
                        for k in ("pack", "unpack")},
           "shape": {"seq": LM_SEQ, "global_batch": LM_BATCH, "microbatch": LM_ZERO1_MB,
                     "layers": LM_ZERO1_LAYERS}}
    log("[lm_zero1] " + json.dumps({k: v for k, v in out.items() if k != "runs"}))
    return out


def phase_lm_zero1_cpu_vs_gpu() -> None:
    """The quickstart LM's widths, 3 steps of scheduled zero1 under concom
    with 2 microbatches, clip 1.0, from the same weights and batches on the
    CPU (plain versions) and on the card (kernels), TF32 off: losses within
    rtol 1e-5."""
    from repro_torch.core import GradSyncConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import make_dp_mesh
    from repro_torch.models.transformer import Transformer, TransformerConfig, init_params
    from repro_torch.optim import adamw, cosine_warmup, zero1
    from repro_torch.runtime import Trainer, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TransformerConfig(name="quickstart-lm", n_layers=4, d_model=128, n_heads=8,
                            kv_heads=4, d_ff=256, vocab=512, tp=1, attn_chunk=64,
                            dtype=torch.float32)
    weights = init_params(cfg, seed=0, device="cpu")
    mesh = make_dp_mesh()
    final = {}
    for device in ("cpu", "cuda"):
        model = Transformer(cfg, tree_to(copy.deepcopy(weights), device))
        ts = make_train_step(cfg, mesh, GradSyncConfig(strategy="concom"),
                             zero1(adamw(cosine_warmup(1e-3, 20, 200)), ("data",), 1),
                             model=model, clip_norm=1.0, zero1_mode=True,
                             zero1_plan="scheduled", microbatch=2, device=device)
        pipe = TokenPipeline(cfg.vocab, 64, 8, seed=0, mesh=mesh, device=device)
        _, _, hist = Trainer(ts, pipe, log_every=10 ** 9, printer=lambda _m: None).run(
            model, ts.init_opt(), 3)
        final[device] = ({n: p.detach().cpu() for n, p in model.named_parameters()},
                         hist["losses"])
        ts.close()
    (p_cpu, l_cpu), (p_gpu, l_gpu) = final["cpu"], final["cuda"]
    for a, b in zip(l_gpu, l_cpu):
        if abs(a - b) > 1e-5 * abs(b):
            raise AssertionError(f"lm_zero1_cpu_vs_gpu: losses gpu {l_gpu} cpu {l_cpu} "
                                 f"beyond rtol 1e-5")
    worst = max((p_gpu[n] - p).abs().max().item() for n, p in p_cpu.items())
    log(f"[lm_zero1_cpu_vs_gpu] losses cpu {l_cpu} gpu {l_gpu} (rtol 1e-5); max param "
        f"diff after 3 steps {worst} (reported)")


# a zero1 run's params after REDUCER_STEPS steps stay within this many times
# the witness's distance from the flat run: a last-bit sum-order difference
# grows chaotically through BatchNorm, so the two readings agree in order
# of magnitude, not in digits
ZERO1_WITNESS_FACTOR = 10.0
# (run, zero1 plan or None for the flat allreduce, strategy, reducer, clip)
ZERO1_RANK_RUNS = (("flat", None, "concom", "flat", 1.0),
                   # the witness: the flat allreduce's sums in the ring's order
                   ("flat_ring", None, "concom", "ring", 1.0),
                   ("scheduled", "scheduled", "concom", "flat", 1.0),
                   ("scheduled_ring", "scheduled", "concom", "ring", 1.0),
                   ("rsag_ring", "scheduled", "rsag", "ring", 1.0),
                   ("deferred", "deferred", "concom", "flat", 1.0),
                   ("scheduled_noclip", "scheduled", "concom", "flat", 0.0),
                   ("monolithic", "monolithic", "concom", "flat", 0.0))


# ------------------------------------------------- tensor parallelism (LM)

LM_TP = 4                      # the model axis of lm_tp: 4 rank processes on the card
# the depth of lm_tp's and lm_fsdp's training (full width), 2 of Qwen3-1.7B's
# 28 layers, since those spawns also serve
# (``SERVE_RANKS_LAYERS``), for the script's time; their first loss and grad
# norm are held to the tp = 1 run of the same depth (``phase_lm_tp1``)
LM_RANKS_LAYERS = 2
LM_RANKS_STEPS = 2             # their steps a strategy: 1 warm-up + 1 timed
# lm_tp's first loss and first (global) grad norm against lm_train's funnel
# (tp = 1, the same seeded weights and batch), bf16 at full width
LM_TP_FIRST_LOSS_RTOL = 5e-4
LM_TP_FIRST_NORM_RTOL = 5e-3
# the f32 mk_dense equivalence on the card: compare_tp's (loss, gradient)
# tolerances (tests/_mdworker.py), and the reducers it runs
TP_EQ_TOL = {"compressed": (5e-2, 0.35), "ring": (3e-4, 5e-3)}
TP_EQ_REDUCERS = ("ring", "compressed", "hierarchical")


class _CountingDep:
    """``core.dependency`` as ``models/common.py`` sees it, counting the
    model-axis and FSDP collectives (each ``collective`` call: its output's
    bytes, and its host time, the gloo staging being synchronous), in all
    and by function (``by_fn``: name → [calls, bytes, ms])."""

    def __init__(self, dep):
        self._dep = dep
        self.calls, self.bytes, self.ms = 0, 0, 0.0
        self.by_fn: dict = {}

    def collective(self, fn, group, out, *ins):
        t0 = time.perf_counter()
        work = self._dep.collective(fn, group, out, *ins)
        ms = (time.perf_counter() - t0) * 1e3
        nbytes = out.numel() * out.element_size()
        self.ms += ms
        self.calls += 1
        self.bytes += nbytes
        kind = self.by_fn.setdefault(getattr(fn, "func", fn).__name__, [0, 0, 0.0])
        kind[0] += 1
        kind[1] += nbytes
        kind[2] += ms
        return work

    def __getattr__(self, name):
        return getattr(self._dep, name)


def lm_tp_collectives(cfg, tokens: int) -> dict:
    """The model-axis collectives of one training step of a tp > 1
    transformer, counted from the code: in the forward the embedding's
    psum, two a layer (after wo and after wdown) and three in the
    cross-entropy (the pmax, the psums of the exponentials' sum and of
    the true logit); in the backward each psum's transpose (the pmax has
    none); and the remat's recompute of each layer's first (after wo:
    its sum feeds the second norm, whose input the backward needs; the
    recompute stops there, non-reentrant checkpoint's early stop, so the
    last psum is not made again).  Bytes: the (tokens, d) activations in
    the model dtype, (tokens,) f32 in the cross-entropy."""
    L = cfg.n_layers
    recompute = L if cfg.remat in ("dots", "full") else 0
    act = tokens * cfg.d_model * cfg.dtype.itemsize
    calls = {"forward": 1 + 2 * L + 3, "backward": 1 + 2 * L + 2, "remat": recompute}
    nbytes = {"forward": (1 + 2 * L) * act + 3 * tokens * 4,
              "backward": (1 + 2 * L) * act + 2 * tokens * 4, "remat": recompute * act}
    return {"calls": calls, "bytes": nbytes, "calls_per_step": sum(calls.values()),
            "bytes_per_step": sum(nbytes.values())}


def _tp_equivalence(rank: int, say) -> dict:
    """The reference's f32 ``mk_dense`` (tests/_mdworker.py: 2 layers, d 64,
    8/2 heads, ff 128, vocab 96) on the card, one step through
    ``make_train_step``: at data 1 x model 4 for every registered strategy
    (flat) and for ring, compressed and hierarchical, then at data 2 x
    model 2 under ring (its replicated leaves' ring over ("data",
    "model") a ring an axis, row 3 on every hop).  The optimizer is SGD
    at learning rate 0 without momentum, whose new state is the step's
    gradients as the optimizer sees them (divided by tp, synced, clipped),
    and the clip binds (half the tp = 1 norm).  Each rank's loss, its
    grad norm and its clipped gradient shards are held against the tp = 1
    model on the full batch with the plain clip, at compare_tp's
    tolerances (the norm at the gradients')."""
    from repro_torch.core import GradSyncConfig, get_strategy, strategy_names
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.collectives import kernel as ck
    from repro_torch.kernels.quantize import kernel as qk
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.optim import sgd
    from repro_torch.parallel.sharding import shard_tree
    from repro_torch.runtime import make_train_step
    from repro_torch.utils.trees import flatten_with_names, tree_unflatten

    def cfg_at(tp, **over):
        return tf.TransformerConfig(name="dense", n_layers=2, d_model=64, n_heads=8,
                                    kv_heads=2, d_ff=128, vocab=96, attn_chunk=16, tp=tp,
                                    dtype=torch.float32, **over)

    seq, batch = 32, 4
    full = tf.init_params(cfg_at(1), seed=1, device="cuda")
    # tp = 1 on the whole batch, the plain clip: the oracle, on every rank alike
    tree = {n: p.clone().requires_grad_(True) for n, p in flatten_with_names(full)[0]}
    one = tree_unflatten(flatten_with_names(full)[1], list(tree.values()))
    want_loss = tf.train_forward(one, TokenPipeline(96, seq, batch, seed=3, device="cuda")
                                 .batch_at(0), cfg_at(1))
    want_loss.backward()
    want_norm = math.sqrt(sum(float(torch.sum(p.grad.double() ** 2)) for p in tree.values()))
    clip = want_norm / 2
    want = {n: p.grad * (clip / want_norm) for n, p in tree.items()}
    out = {"tp1_grad_norm": want_norm, "clip_norm": clip, "cases": {}}
    cases = [(st, "flat") for st in strategy_names()] + [("concom", r) for r in TP_EQ_REDUCERS]
    for data, model, runs in ((1, LM_TP, cases), (2, LM_TP // 2, [("concom", "ring")])):
        mesh = make_smoke_mesh(data, model)
        pipe = TokenPipeline(96, seq, batch, seed=3, mesh=mesh, rank=rank, device="cuda")
        for strategy, reducer in runs:
            cfg = cfg_at(model, depcha_in_scan=get_strategy(strategy).uses_in_scan)
            specs = tf.param_specs(full, cfg)
            local, treedef = flatten_with_names(shard_tree(full, specs, mesh, rank))
            net = tf.Transformer(cfg, tree_unflatten(treedef, [p.clone() for _, p in local]))
            opt = sgd(0.0, momentum=0.0)
            ts = make_train_step(cfg, mesh, GradSyncConfig(
                strategy=strategy, reducer=reducer, bucket_bytes=1 << 12, num_channels=3),
                opt, model=net, clip_norm=clip, device="cuda")
            accum0 = ck.ACCUM_LAUNCHES
            int80 = (qk.QUANTIZE_LAUNCHES, qk.SUM_QUANTIZE_LAUNCHES, qk.DEQUANTIZE_LAUNCHES)
            _, state, metrics = ts.fn(net, ts.init_opt(), pipe.batch_at(0), 0)
            torch.cuda.synchronize()
            accum = ck.ACCUM_LAUNCHES - accum0
            int8 = [a - b for a, b in zip((qk.QUANTIZE_LAUNCHES, qk.SUM_QUANTIZE_LAUNCHES,
                                           qk.DEQUANTIZE_LAUNCHES), int80)]
            got = state["mom"]               # the clipped gradients the update saw
            tol, grad_tol = TP_EQ_TOL.get(reducer, (3e-4, 2e-3))
            dloss = abs(float(metrics["loss"]) - want_loss.item())
            dnorm = abs(float(metrics["grad_norm"]) - want_norm) / want_norm
            cut = dict(flatten_with_names(shard_tree(want, specs, mesh, rank))[0])
            worst = max(((got[n] - cut[n]).abs().max() / (want[n].abs().max() + 1e-8)).item()
                        for n in got)
            if dloss >= tol or dnorm >= grad_tol or worst >= grad_tol:
                raise AssertionError(f"tp equivalence {strategy}/{reducer} at {data}x{model}: "
                                     f"dloss {dloss} (< {tol}), grad norm {dnorm} and "
                                     f"clipped grads {worst} (< {grad_tol})")
            if reducer == "ring" and accum == 0:
                raise AssertionError(f"ring at {data}x{model}: no ring_accum launch")
            if reducer == "compressed" and 0 in int8:
                raise AssertionError(f"compressed at {data}x{model}: int8 launches {int8}")
            out["cases"][f"{strategy}/{reducer}@{data}x{model}"] = {
                "dloss": dloss, "grad_norm_rel": dnorm, "clipped_grad_rel": worst,
                "accum_launches": accum, "quantize_launches": int8[0],
                "sum_quantize_launches": int8[1], "dequantize_launches": int8[2]}
            ts.close()
            del ts, net, state
    say(f"[lm_tp] f32 mk_dense on the card through make_train_step, tp > 1 against "
        f"tp = 1 (compare_tp's tolerances): " + json.dumps(out))
    return out


# ------------------------------------------------- serving beyond one rank
# (static rows, tokens a request, continuous prompts, slots, chunk) of the
# serving runs in the lm_tp spawn (data 1 x model 4) and the lm_fsdp one
# (data 2 x model 2, fsdp=True); blocks of 128
# the depth of the spawns' serving (full width): 4 of the 28 layers, for the
# script's time (its checks count by layer)
SERVE_RANKS_LAYERS = 4
SERVE_TP_RUN = (4, 32, 8, 8, 8)
SERVE_FSDP_RUN = (4, 8, 4, 4, 4)
# the f32 checks: Qwen3-1.7B at full width and 2 layers (TF32 off): at
# tp = 4 its prefill and 8 decode steps' logits against tp = 1's, within
# compare_tp's 3e-4 (tests/_mdworker.py; on the loss there, on logits of
# order 1 here: the two differ only in the order of the model psums' sums
# and the GEMMs' shapes, about 1e-6 of a logit at smoke size); under FSDP
# the engines against each other, prompt by prompt
SERVE_F32_LAYERS = 2
SERVE_F32_STEPS = 8
SERVE_F32_ATOL = 3e-4


def serve_collectives(cfg, rows: int, seq: int, data: int = 1) -> dict:
    """The collectives of one transformer prefill (``seq`` > 1) or decode
    step (``seq`` 1) on ``rows`` rows with its greedy pick, counted from
    the code, as (calls, bytes) by function: over "model" the embedding's
    psum and two a layer (after wo and after wdown) of the (rows, seq, d)
    activations in the model dtype, and the sampler's one all-gather of
    each rank's (rows, 2) maximum and index in f64 (its output tp·rows·2·8
    bytes); under FSDP each layer's gather of each FSDP leaf over the dp
    axes (``lm_fsdp_collectives``' gathered blocks)."""
    L = cfg.n_layers
    act = rows * seq * cfg.d_model * cfg.dtype.itemsize
    gathers = [1, cfg.tp * rows * 2 * 8]
    if cfg.fsdp:
        fs = lm_fsdp_collectives(cfg, data, 0)
        gathers = [gathers[0] + L * fs["leaves_per_layer"],
                   gathers[1] + L * fs["gathered_bytes_per_layer"]]
    return {"all_reduce": [1 + 2 * L, (1 + 2 * L) * act], "all_gather_into_tensor": gathers}


def _serve_ranks(rank: int, mesh, counting, host, say, run: tuple, fsdp: bool = False) -> dict:
    """Qwen3-1.7B at full width and ``SERVE_RANKS_LAYERS`` layers (bf16,
    ``use_flash``) served on this
    spawn's mesh from the seeded weights (every rank draws the global tree
    from seed 0 and keeps its shards: ``serve``'s weights), before the
    spawn's training.  ``run`` is (static rows, tokens, continuous
    prompts, slots, chunk): the static engine on the first rows of
    ``serve``'s prompts (left-padded), the collectives of its prefill and
    of its first decode step on the rank's rows counted (``_CountingDep``)
    and held to ``serve_collectives``; the continuous engine on the first
    prompts (blocks of 128); each engine's prefill ms and decode ms a
    step, flash launches held to one a layer a prefill, the peak GB a
    rank; the tokens bit-identical on every rank; the engines' greedy
    agreement (reported, as ``serve`` reports it at tp = 1 in bf16)."""
    import numpy as np

    from repro_torch.configs.qwen3_1_7b import make_config
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.models import transformer as tf
    from repro_torch.runtime import ContinuousScheduler, Server

    rows, new, n_cont, slots, chunk = run
    data, tp = mesh.shape["data"], mesh.shape["model"]
    cfg = make_config(use_flash=True, tp=tp, fsdp=fsdp, n_layers=SERVE_RANKS_LAYERS)
    t0 = time.perf_counter()
    params = tf.init_params(cfg, seed=0, device="cuda", mesh=mesh, rank=rank)
    server = Server(cfg, mesh, params, max_len=SERVE_MAX_LEN)
    torch.cuda.synchronize()
    out = {"mesh": dict(mesh.shape), "fsdp": fsdp, "setup_s": time.perf_counter() - t0}
    prompts = serve_prompts(cfg.vocab)
    batch = left_pad(prompts[:rows]).numpy()

    # the collectives of the static engine's prefill and of its first
    # decode step, each with its greedy pick, on the rank's rows: the
    # counts at the start of the prefill and of the first two decode steps
    api, marks = server.api, []

    def marked(fn):
        def call(*a, **kw):
            marks.append({k: v[:2] for k, v in counting.by_fn.items()})
            return fn(*a, **kw)
        return call

    server.api = dataclasses.replace(api, prefill=marked(api.prefill),
                                     decode_step=marked(api.decode_step))
    timer = DecodeLoopTimer(server)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.FLASH_LAUNCHES = 0
    t0 = time.perf_counter()
    static = server.generate(batch, new)
    static_s = time.perf_counter() - t0
    decode_ms = timer.close(new - 1)
    server.api = api
    static_launches = flash.FLASH_LAUNCHES

    def between(a, b):
        return {k: [v[0] - a.get(k, [0, 0])[0], v[1] - a.get(k, [0, 0])[1]]
                for k, v in b.items() if v[0] != a.get(k, [0, 0])[0]}

    local = rows // data
    want = {"prefill": serve_collectives(cfg, local, batch.shape[1], data),
            "decode_step": serve_collectives(cfg, local, 1, data)}
    got = {"prefill": between(marks[0], marks[1]), "decode_step": between(marks[1], marks[2])}
    if got != want:
        raise AssertionError(f"serve collectives at {dict(mesh.shape)}: {got}, predicted {want}")
    out["collectives"] = dict(got, predicted=want)
    flash.FLASH_LAUNCHES = 0
    eng = ContinuousScheduler(server, slots=slots, block_size=128, chunk=chunk)
    decode_chunk, chunk_ms = eng._decode_chunk, []

    def timed_chunk():
        t = time.perf_counter()
        res = decode_chunk()                 # ends in a host copy
        chunk_ms.append((time.perf_counter() - t) * 1e3)
        return res

    eng._decode_chunk = timed_chunk
    t0 = time.perf_counter()
    cont = eng.generate_batch(prompts[:n_cont], new)
    cont_s = time.perf_counter() - t0
    cont_launches = flash.FLASH_LAUNCHES
    launches = {"static": static_launches, "continuous": cont_launches}
    if launches != {"static": cfg.n_self, "continuous": cfg.n_self * n_cont}:
        raise AssertionError(f"serve at {dict(mesh.shape)}: flash launches {launches}, "
                             f"expected {cfg.n_self} a prefill")
    _same_on_every_rank([torch.as_tensor(static), torch.as_tensor(np.stack(cont))],
                        f"serve at {dict(mesh.shape)}: tokens", host)
    steps = len(chunk_ms) * chunk
    out.update(
        static=dict(rows=rows, tokens=new, wall_s=static_s, prefill_ms=timer.prefill_ms()[0],
                    decode_ms_per_step=decode_ms[0], flash_launches=static_launches),
        continuous=dict(prompts=n_cont, slots=slots, chunk=chunk, tokens=new, wall_s=cont_s,
                        chunk_ms=chunk_ms, decode_ms_per_step=sum(chunk_ms) / steps,
                        flash_launches=cont_launches),
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        prompt_lens=[len(p) for p in prompts[:max(rows, n_cont)]],
        static_tokens=static.tolist(),
        greedy_agreement_static_vs_continuous=float(np.mean(
            [np.mean(static[i] == cont[i]) for i in range(min(rows, n_cont))])),
        tokens_identical_on_every_rank=True, flash_launches=static_launches + cont_launches)
    server.close()
    del server, params, eng
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[serve_{'fsdp' if fsdp else 'tp'}] " + json.dumps(
        {k: v for k, v in out.items() if k != "static_tokens"}))
    return out


def _serve_tp_f32(rank: int, mesh, say) -> dict:
    """Qwen3-1.7B at full width and ``SERVE_F32_LAYERS`` layers in f32
    (TF32 off, ``use_flash``: the CUDA-core flash kernel) at this mesh's
    tp, through ``prefill`` and ``SERVE_F32_STEPS`` greedy ``decode_step``s
    on ``serve``'s first 2 prompts (left-padded), every rank drawing the
    global tree from seed 0; rank 0 also runs the tp = 1 model of the same
    seed the same way.  The tokens must be equal and the logits (the
    ranks' shards put together) within ``SERVE_F32_ATOL``."""
    import torch.nn.functional as F

    from repro_torch.configs.qwen3_1_7b import make_config
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import NO_MODEL_AXIS, model_all_gather, model_axis
    from repro_torch.runtime import sharded_argmax

    tp = mesh.shape["model"]
    cfg = make_config(n_layers=SERVE_F32_LAYERS, dtype=torch.float32, use_flash=True, tp=tp)
    toks = left_pad(serve_prompts(cfg.vocab)[:2]).cuda()
    S = toks.shape[1]

    def greedy(cfg, params, axis):
        logits, cache = tf.prefill(params, toks, cfg, model_axis=axis)
        cache = {n: F.pad(c, (0, 0, 0, 0, 0, SERVE_F32_STEPS)) for n, c in cache.items()}
        logs, tokens = [model_all_gather(logits, axis)], []
        for t in range(SERVE_F32_STEPS):
            tok = sharded_argmax(logits, cfg.tp, axis)
            tokens.append(tok)
            logits, cache = tf.decode_step(params, cache, tok, S + t, cfg, model_axis=axis)
            logs.append(model_all_gather(logits, axis))
        return torch.stack(logs), torch.stack(tokens)

    axis = model_axis(mesh, "cuda")
    flash.FLASH_LAUNCHES = 0
    logs, tokens = greedy(cfg, tf.init_params(cfg, seed=0, device="cuda", mesh=mesh,
                                              rank=rank), axis)
    out = {"layers": SERVE_F32_LAYERS, "steps": SERVE_F32_STEPS, "prompt_lens":
           [int((toks[i] != 0).sum()) for i in range(2)], "atol": SERVE_F32_ATOL,
           "flash_launches_f32": flash.FLASH_LAUNCHES}
    if rank == 0:
        cfg1 = make_config(n_layers=SERVE_F32_LAYERS, dtype=torch.float32, use_flash=True)
        want_logs, want_tokens = greedy(cfg1, tf.init_params(cfg1, seed=0, device="cuda"),
                                        NO_MODEL_AXIS)
        diff = (logs - want_logs).abs().max().item()
        out.update(tokens_equal=bool(torch.equal(tokens, want_tokens)), logits_max_abs_diff=diff,
                   logits_max_abs=want_logs.abs().max().item())
        if not out["tokens_equal"] or diff > SERVE_F32_ATOL:
            raise AssertionError(f"f32 tp = {tp} vs tp = 1: tokens equal "
                                 f"{out['tokens_equal']}, logits differ by {diff} "
                                 f"(atol {SERVE_F32_ATOL})")
    import torch.distributed as dist

    dist.destroy_process_group(axis.group)
    say("[serve_tp_f32] " + json.dumps(out))
    return out


def _serve_fsdp_f32(rank: int, mesh, say) -> dict:
    """Qwen3-1.7B at full width and ``SERVE_F32_LAYERS`` layers in f32
    under FSDP on this mesh: the continuous engine (4 slots, blocks of
    128, chunk 4) on ``serve``'s first 4 prompts against each prompt served
    alone by the static engine (a row a dp rank), ``SERVE_F32_STEPS``
    tokens each: equal, as ``serve``'s f32 engines at tp = 1."""
    import numpy as np

    from repro_torch.configs.qwen3_1_7b import make_config
    from repro_torch.models import transformer as tf
    from repro_torch.runtime import ContinuousScheduler, Server

    data, tp = mesh.shape["data"], mesh.shape["model"]
    cfg = make_config(n_layers=SERVE_F32_LAYERS, dtype=torch.float32, use_flash=True, tp=tp,
                      fsdp=True)
    server = Server(cfg, mesh, tf.init_params(cfg, seed=0, device="cuda", mesh=mesh, rank=rank),
                    max_len=SERVE_MAX_LEN)
    prompts = serve_prompts(cfg.vocab)[:4]
    alone = [server.generate(np.tile(p[None], (data, 1)), SERVE_F32_STEPS)[0] for p in prompts]
    cont = ContinuousScheduler(server, slots=4, block_size=128, chunk=4).generate_batch(
        prompts, SERVE_F32_STEPS)
    server.close()
    equal = [bool(np.array_equal(a, c)) for a, c in zip(alone, cont)]
    if not all(equal):
        raise AssertionError(f"f32 FSDP engines: static alone {alone} vs continuous {cont}")
    out = {"layers": SERVE_F32_LAYERS, "tokens": SERVE_F32_STEPS, "prompts": len(prompts),
           "continuous_equals_static": equal}
    say("[serve_fsdp_f32] " + json.dumps(out))
    return out


# ------------------------------------------------------ pipeline stages
# the pp phase, on the lm_tp spawn after its runs: Qwen3-1.7B at full width
# cut to PP_LAYERS layers (two a stage), data 1 x stage 2 x model 2, seq
# 1024 x global batch 4 in PP_M microbatches of one sequence; gpipe, then
# 1f1b, then gpipe on the stage-1 twin (data 1 x stage 1 x model 2 on world
# ranks 0-1; ranks 2-3 build the step, collective, and stay outside)
PP_LAYERS = 4
PP_MESH = (1, 2, 2)            # (data, stage, model)
PP_M = 4
PP_RUNS = (("gpipe", 2), ("1f1b", 2), ("twin", 1))     # (run, stage extent)
# 1f1b against gpipe (its chunks' gradient sums re-associated): the first
# step's loss and grad norm, then the later steps' (AdamW's first update
# magnifies the last-bit gradient differences; measured on an H100 at
# the second step: 7.9e-6 of the loss, 2.4e-5 of the grad norm)
PP_1F1B_FIRST_RTOL = 1e-5
PP_1F1B_LATER_RTOL = 1e-4


def pp_hops(schedule: str, stages: int, microbatches: int) -> int:
    """The hops a staged step makes, forward and backward: a wave program
    of m microbatches hops m + S − 2 times each way (the last wave's carry
    goes nowhere), gpipe once over M, 1f1b once a chunk of S."""
    if stages == 1:
        return 0
    chunk = microbatches if schedule == "gpipe" else stages
    return (microbatches // chunk) * 2 * (chunk + stages - 2)


def row_sums(named) -> dict:
    """``bit_sums`` a layer row for the stacked block leaves, a leaf for
    the rest: the digests a staged rank's slice and its twin's rows are
    compared by."""
    out = {}
    for n, p in named:
        p = p.detach()
        if n.startswith("blocks/"):
            out[n] = [int(bits(r).to(torch.int64).sum()) for r in p]
        else:
            out[n] = int(bits(p).to(torch.int64).sum())
    return out


def bucket_layout(buckets) -> list:
    """Each bucket's id, channel, reduce axes and leaf names, as JSON
    gives them back: how a rank's plan is held to ``pp_plan``'s."""
    return [[b.bucket_id, b.channel, list(b.reduce_axes), list(b.names)] for b in buckets]


PP_PRIVATE = ("digest", "layout")   # a run's keys read by pp_report, not reported


def pp_plan(stages: int):
    """Rank 0's post-backward buckets of the pp phase's step at ``stages``
    (its stage's slice of the blocks over "model", the stage-replicated
    leaves over "stage" too) as ``make_train_step`` plans them
    (``plan_sync`` of concom on the stage overlay of rank 0's shapes),
    and its named leaves, on ``meta``."""
    from repro_torch.core import GradSyncConfig, plan_sync
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.transformer import init_params, param_specs
    from repro_torch.parallel.sharding import stage_shard_specs
    from repro_torch.utils.trees import flatten_with_names

    data, _, model = PP_MESH
    mesh = make_smoke_mesh(data, model, stages)
    cfg = dataclasses.replace(lm_config("concom"), tp=model, n_layers=PP_LAYERS)
    local = init_params(cfg, device="meta", mesh=mesh, rank=0)
    specs = stage_shard_specs(param_specs(local, cfg))
    planned = plan_sync(GradSyncConfig(strategy="concom"), mesh, specs, local)
    return [op.bucket for op in planned.schedule.ops], flatten_with_names(local)[0]


def phase_pp_kernels() -> dict:
    """Rows 1-2 at the pp phase's layouts, bit for bit against their plain
    versions (outputs started as NaN): every bucket of rank 0's staged
    plan (stage 2) and of its stage-1 twin's (bf16 leaves, f32 comm); a
    step's worth of the staged plan's timed."""
    from repro_torch.kernels.collectives import kernel

    f32 = torch.float32
    gen = torch.Generator(device="cuda").manual_seed(0)
    err, n_checks, out = 0.0, 0, {"buckets": {}}
    for stages in (PP_MESH[1], 1):
        buckets, named = pp_plan(stages)
        flat = [torch.randn(p.shape, generator=gen, device="cuda").to(p.dtype)
                for _, p in named]
        for b in buckets:
            before = (kernel.PACK_LAUNCHES, kernel.UNPACK_LAUNCHES)
            err = max(err, check_bucket(b, flat, f32, 1.0))
            n = staging_launches(b)
            if (kernel.PACK_LAUNCHES - before[0], kernel.UNPACK_LAUNCHES - before[1]) != (n, n):
                raise AssertionError(f"pp bucket {b.bucket_id} at stage {stages}: expected "
                                     f"{n} pack and {n} unpack launches")
            n_checks += 1
        out["buckets"][f"stage{stages}"] = {str(ax): sum(1 for b in buckets
                                                         if b.reduce_axes == ax)
                                            for ax in sorted({b.reduce_axes for b in buckets})}
        if stages > 1:
            torch.cuda.synchronize()
            out["post_backward"] = time_staging([(b, flat) for b in buckets], f32)
        del flat
    out.update(max_abs_err=err, checks=n_checks)
    log(f"[pp_kernels] {n_checks} checks bit-exact (max abs err {err}): rank 0's buckets "
        f"of the staged plan and of its stage-1 twin; " + json.dumps(out))
    return out


def _pp_ranks(rank: int, say) -> dict:
    """One rank of the pp phase (``PP_RUNS``): each run ``LM_RANKS_STEPS``
    steps through ``Trainer`` (AdamW, clip 1.0, concom, remat dots,
    deterministic algorithms), its losses, grad norms, step times, peak
    memory, hops (count, bytes, host seconds), pack/unpack launches
    against the staged plan's buckets and its params' row digests; every
    step closed after its run."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.core import GradSyncConfig
    from repro_torch.core import dependency as dep
    from repro_torch.core.pipeline_program import plan_pipeline
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.collectives import kernel
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.transformer import Transformer, init_params
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.parallel import pipeline as pl
    from repro_torch.parallel.sharding import Mesh
    from repro_torch.runtime import Trainer, make_train_step
    from repro_torch.utils.trees import flatten_with_names

    data, _, model = PP_MESH
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    out = {"runs": {}, "groups_before": dep.live_groups()}
    t_phase = time.perf_counter()
    try:
        for run, stages in PP_RUNS:
            sched = "gpipe" if run == "twin" else run
            mesh = make_smoke_mesh(data, model, stages)
            if stages == 1:
                mesh = Mesh(mesh.axis_names, mesh.shape, tuple(range(data * model)))
            me = dep.mesh_rank(mesh)
            cfg = dataclasses.replace(lm_config("concom"), tp=model, n_layers=PP_LAYERS)
            net = Transformer(cfg, init_params(cfg, seed=0, device="cuda" if me is not None
                                               else "meta", mesh=mesh,
                                               rank=0 if me is None else me))
            pipe = TokenPipeline(cfg.vocab, LM_SEQ, LM_BATCH, seed=0, mesh=mesh,
                                 rank=0 if me is None else me, device="cuda")
            opt = adamw(cosine_warmup(3e-4, 10, 100))
            ts = make_train_step(cfg, mesh, GradSyncConfig(strategy="concom"), opt, model=net,
                                 clip_norm=1.0, microbatch=PP_M, pp_stages=stages,
                                 pp_schedule=sched, batch_like=pipe.batch_at(0),
                                 device="cuda")
            if me is not None:
                named = flatten_with_names(net.params_tree())[0]
                opt_state = opt.init(dict(named))
                trainer = Trainer(ts, pipe, log_every=10 ** 9, printer=lambda _m: None)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                kernel.PACK_LAUNCHES = kernel.UNPACK_LAUNCHES = 0
                losses, norms, hops, hop_bytes, hop_s = [], [], [], [], []
                for step in range(LM_RANKS_STEPS):
                    h0, b0, s0 = dep.HOPS, dep.HOP_BYTES, dep.HOP_S
                    net, opt_state, hist = trainer.run(net, opt_state, step + 1,
                                                       start_step=step)
                    losses.append(hist["losses"][-1])
                    norms.append(hist["metrics"]["grad_norm"])
                    hops.append(dep.HOPS - h0)
                    hop_bytes.append(dep.HOP_BYTES - b0)
                    hop_s.append(dep.HOP_S - s0)
                per_step = sum(staging_launches(op.bucket) for op in ts.gradsync.schedule.ops)
                launches = {"pack": kernel.PACK_LAUNCHES, "unpack": kernel.UNPACK_LAUNCHES}
                if launches != {"pack": per_step * LM_RANKS_STEPS,
                                "unpack": per_step * LM_RANKS_STEPS}:
                    raise AssertionError(f"pp {run}: launches {launches}, expected "
                                         f"{per_step} a step x {LM_RANKS_STEPS}")
                want_hops = pp_hops(sched, stages, PP_M)
                if hops != [want_hops] * LM_RANKS_STEPS:
                    raise AssertionError(f"pp {run}: hops {hops}, the waves make {want_hops}")
                if not all(math.isfinite(x) for x in losses):
                    raise AssertionError(f"pp {run}: non-finite loss {losses}")
                plan = plan_pipeline(stages, PP_M, kind=sched,
                                     activation_bytes=ts.gradsync.cfg.pp_activation_bytes,
                                     itemsize=2)
                times = trainer.step_times
                out["runs"][run] = {
                    "losses": losses, "grad_norms": norms,
                    "first_step_ms": trainer.first_step_time * 1e3,
                    "step_ms": [t * 1e3 for t in times],
                    "tokens_per_s": [LM_BATCH * LM_SEQ / t for t in times],
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "params": sum(p.numel() for _, p in named),
                    "launches": launches, "launches_per_step": per_step,
                    "buckets": len(ts.gradsync.schedule.ops),
                    "hops": hops, "hop_bytes": hop_bytes, "hop_host_s": hop_s,
                    # the rank's stage span a timed step: its wall less its
                    # time in the hops (waiting for its neighbour included)
                    "compute_ms": [(t - h) * 1e3 for t, h in zip(times, hop_s[1:])],
                    "plan_crossings": sum(op.kind == "send" for op in plan.schedule.ops),
                    "plan_crossing_bytes": plan.activation_bytes,
                    "waves": PP_M + stages - 1,
                    "bubble_fraction": pl.bubble_fraction(stages, PP_M),
                    "layout": bucket_layout(op.bucket for op in ts.gradsync.schedule.ops),
                    "digest": row_sums(named)}
                say(f"[pp] {run}: " + json.dumps({k: v for k, v in out["runs"][run].items()
                                                 if k not in PP_PRIVATE}))
                del named, opt_state, trainer
            ts.close()
            dist.barrier()
            del ts, net
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    out["groups_after"] = dep.live_groups()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _pp_rank(rank: int, workdir: str, backend: str) -> None:
    """The pp phase alone on ``LM_TP`` spawned ranks (``phase_pp``)."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_dist

    init_dist("cuda", backend=backend, init_method=f"file://{workdir}/store", rank=rank,
              world_size=LM_TP, timeout=datetime.timedelta(seconds=600))
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"pp": _pp_ranks(rank, log if rank == 0 else (lambda _m: None))}
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def phase_pp(backend: str = "gloo") -> dict:
    """The pp phase alone (``main`` runs it on the lm_tp spawn, after its
    runs): ``LM_TP`` rank processes, gloo on one card by default."""
    ranks, wall = spawn_ranks(_pp_rank, (backend,), LM_TP)
    res = pp_report(ranks)
    res["wall_s"] = wall
    log("[pp] " + json.dumps(res))
    return res


def pp_report(ranks: list) -> dict:
    """The pp phase across the ranks: rank 0's buckets in every run those
    of ``pp_plan`` (whose layouts ``phase_pp_kernels`` checks), the
    staged gpipe's losses and params bit-identical to the stage-1 twin's
    (a staged rank's block rows against its twin's rows of its stage,
    every other leaf whole), 1f1b's losses and grad norms against gpipe's
    (the first step's within ``PP_1F1B_FIRST_RTOL``, the later ones'
    within ``PP_1F1B_LATER_RTOL``), the communicators all destroyed, and
    rank 0's runs without the digests and layouts."""
    from repro_torch.launch.mesh import make_smoke_mesh

    plans = {s: bucket_layout(pp_plan(s)[0]) for s in {s for _, s in PP_RUNS}}
    for run, s in PP_RUNS:
        if ranks[0]["pp"]["runs"][run]["layout"] != plans[s]:
            raise AssertionError(f"pp {run}: rank 0's buckets are not pp_plan({s})'s")
    mesh = make_smoke_mesh(PP_MESH[0], PP_MESH[2], PP_MESH[1])
    per = PP_LAYERS // PP_MESH[1]
    for r, res in enumerate(ranks):
        pp = res["pp"]
        if pp["groups_after"] != pp["groups_before"]:
            raise AssertionError(f"pp rank {r}: {pp['groups_after']} process groups after "
                                 f"the runs, {pp['groups_before']} before")
        c = mesh.coords(r)
        twin = ranks[c["model"]]["pp"]["runs"]["twin"]
        got = pp["runs"]["gpipe"]
        if got["losses"] != twin["losses"]:
            raise AssertionError(f"pp rank {r}: staged gpipe losses {got['losses']} are not "
                                 f"the twin's {twin['losses']}")
        for n, d in got["digest"].items():
            want = twin["digest"][n]
            if n.startswith("blocks/"):
                want = want[c["stage"] * per:(c["stage"] + 1) * per]
            if d != want:
                raise AssertionError(f"pp rank {r}: {n} differs from the stage-1 twin's")
        for key in ("losses", "grad_norms"):
            for k, (a, b) in enumerate(zip(pp["runs"]["1f1b"][key], got[key])):
                rtol = PP_1F1B_FIRST_RTOL if k == 0 else PP_1F1B_LATER_RTOL
                if abs(a - b) > rtol * abs(b):
                    raise AssertionError(f"pp rank {r}: 1f1b's {key}[{k}] {a} vs gpipe's "
                                         f"{b}: rel {abs(a - b) / abs(b)} > {rtol}")
    res0 = ranks[0]["pp"]
    return {"runs": {k: {kk: vv for kk, vv in v.items() if kk not in PP_PRIVATE}
                     for k, v in res0["runs"].items()},
            "staged_vs_twin": "bit-identical (losses; every leaf's rows)",
            "f1b_vs_gpipe_rel": {key: [abs(a - b) / abs(b) for a, b in zip(
                res0["runs"]["1f1b"][key], res0["runs"]["gpipe"][key])]
                for key in ("losses", "grad_norms")},
            "stage_spans": {run: {r: {k: ranks[r]["pp"]["runs"][run][k]
                                      for k in ("step_ms", "compute_ms", "hop_host_s")}
                                  for r in range(len(ranks))}
                            for run in ("gpipe", "1f1b")},
            "groups": [res0["groups_before"], res0["groups_after"]],
            "phase_s": max(res["pp"]["phase_s"] for res in ranks)}


def _lm_tp_rank(rank: int, workdir: str, backend: str, tp1) -> None:
    """One rank of ``phase_lm_tp``: first serving (``_serve_ranks`` at
    ``SERVE_TP_RUN``, then ``_serve_tp_f32``), then Qwen3-1.7B at full width and ``LM_RANKS_LAYERS`` layers on data 1 x
    model ``LM_TP`` (seq 1024 x global batch 4, AdamW, clip 1.0, remat
    dots, bf16), each of funnel, concom and depcha (in-backward) from
    the seeded weights (each rank draws the global tree and keeps its
    shards), ``LM_RANKS_STEPS`` steps; the model-axis collectives of
    each step counted and timed (``_CountingDep``) against
    ``lm_tp_collectives``; pack/unpack launches against the schedule
    (plus depcha's two slots a layer); the replicated leaves
    bit-identical across the ranks after every run; the first loss and
    the first grad norm (the global one the clip uses) against the
    tp = 1 funnel's of the same depth (``tp1``: (loss, norm),
    ``phase_lm_tp1``); one more funnel
    step with CUDA events around its stages.  Then the f32 equivalence
    (``_tp_equivalence``).  Results to ``workdir/rank<r>.json``."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core import GradSyncConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.collectives import kernel
    from repro_torch.launch.mesh import init_dist, make_mesh
    from repro_torch.models import common
    from repro_torch.models.transformer import Transformer, init_params
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.runtime import Trainer, make_train_step
    from repro_torch.utils.trees import flatten_with_names

    init_dist("cuda", backend=backend, init_method=f"file://{workdir}/store", rank=rank,
              world_size=LM_TP, timeout=datetime.timedelta(seconds=600))
    torch.backends.cuda.matmul.allow_tf32 = False
    say = log if rank == 0 else (lambda _m: None)
    host = dist.new_group(backend="gloo")
    mesh = make_mesh(LM_TP)
    pipe = TokenPipeline(lm_config().vocab, LM_SEQ, LM_BATCH, seed=0, mesh=mesh, rank=rank,
                         device="cuda")
    counting = _CountingDep(common.dep)
    common.dep = counting
    out = {"runs": {}}
    try:
        t0 = time.perf_counter()
        out["serve"] = _serve_ranks(rank, mesh, counting, host, say, SERVE_TP_RUN)
        out["serve_f32"] = _serve_tp_f32(rank, mesh, say)
        out["serve"]["phase_s"] = time.perf_counter() - t0
        for strat in STRATEGIES:
            cfg = dataclasses.replace(lm_config(strat), tp=LM_TP, n_layers=LM_RANKS_LAYERS)
            model = Transformer(cfg, init_params(cfg, seed=0, device="cuda", mesh=mesh,
                                                 rank=rank))
            opt = adamw(cosine_warmup(3e-4, 10, 100))
            ts = make_train_step(cfg, mesh, GradSyncConfig(strategy=strat), opt, model=model,
                                 clip_norm=1.0, device="cuda")
            named = flatten_with_names(model.params_tree())[0]
            opt_state = opt.init(dict(named))
            trainer = Trainer(ts, pipe, log_every=10 ** 9, printer=lambda _m: None)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernel.PACK_LAUNCHES = kernel.UNPACK_LAUNCHES = 0
            losses, norms, calls, nbytes, coll_ms = [], [], [], [], []
            for step in range(LM_RANKS_STEPS):
                c0, b0, m0 = counting.calls, counting.bytes, counting.ms
                model, opt_state, hist = trainer.run(model, opt_state, step + 1,
                                                     start_step=step)
                losses.append(hist["losses"][-1])
                norms.append(hist["metrics"]["grad_norm"])
                calls.append(counting.calls - c0)
                nbytes.append(counting.bytes - b0)
                coll_ms.append(counting.ms - m0)
            predicted = lm_tp_collectives(cfg, LM_SEQ * LM_BATCH)
            if calls != [predicted["calls_per_step"]] * LM_RANKS_STEPS or \
                    nbytes != [predicted["bytes_per_step"]] * LM_RANKS_STEPS:
                raise AssertionError(f"lm_tp {strat}: model-axis collectives {calls} "
                                     f"({nbytes} B), predicted {predicted}")
            slots = sync_slots(ts.layer_sync)
            per_step = len(ts.gradsync.schedule.ops) + slots
            launches = {"pack": kernel.PACK_LAUNCHES, "unpack": kernel.UNPACK_LAUNCHES}
            if launches != {"pack": per_step * LM_RANKS_STEPS,
                            "unpack": per_step * LM_RANKS_STEPS}:
                raise AssertionError(f"lm_tp {strat}: launches {launches}, expected "
                                     f"{per_step} a step x {LM_RANKS_STEPS}")
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"lm_tp {strat}: non-finite loss {losses}")
            rep = [p for n, p in named if n not in ts.gradsync.model_sharded]
            _same_on_every_rank(rep, f"lm_tp {strat} replicated leaves", host)
            times = trainer.step_times
            run = {"losses": losses, "grad_norms": norms,
                   "first_step_ms": trainer.first_step_time * 1e3,
                   "step_ms": [t * 1e3 for t in times],
                   "tokens_per_s": [pipe.global_batch * LM_SEQ / t for t in times],
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "launches": launches, "launches_per_step": per_step,
                   "buckets": len(ts.gradsync.schedule.ops), "slots_per_step": slots,
                   "model_collectives_per_step": calls, "model_collective_bytes": nbytes,
                   "model_collective_host_ms": coll_ms, "predicted": predicted,
                   "replicated_leaves": len(rep)}
            if strat == "funnel":
                run["stages"] = lm_stage_spans(ts, model, opt_state, pipe)
            out["runs"][strat] = run
            say(f"[lm_tp] {strat}: " + json.dumps(run))
            ts.close()
            del ts, model, opt_state, trainer, named, rep
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        common.dep = counting._dep
    if tp1 is not None:
        for i, (what, key, rtol) in enumerate((
                ("loss", "losses", LM_TP_FIRST_LOSS_RTOL),
                ("grad_norm", "grad_norms", LM_TP_FIRST_NORM_RTOL))):
            first = [r[key][0] for r in out["runs"].values()]
            worst = max(abs(x - tp1[i]) / abs(tp1[i]) for x in first)
            out[f"first_{what}_vs_tp1"] = {"tp1": tp1[i], "tp": first, "max_rel": worst,
                                           "rtol": rtol}
            if worst > rtol:
                raise AssertionError(f"lm_tp first {what} {first} vs tp = 1 {tp1[i]}: "
                                     f"rel {worst} > {rtol}")
    out["equivalence"] = _tp_equivalence(rank, say)
    out["pp"] = _pp_ranks(rank, say)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def spawn_ranks(fn, args: tuple, nprocs: int) -> tuple[list, float]:
    """``fn(rank, workdir, *args)`` on ``nprocs`` spawned rank processes,
    each writing ``workdir/rank<r>.json``: those files in rank order, and
    the spawn's seconds (its processes' start included)."""
    import tempfile

    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=fn.__name__.strip("_") + "-") as wd:
        mp.spawn(fn, args=(wd, *args), nprocs=nprocs, join=True)
        ranks = []
        for r in range(nprocs):
            with open(os.path.join(wd, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    return ranks, time.perf_counter() - t0


def _process_settings() -> tuple:
    """What a rank function may set for its whole process: the cuDNN and
    TF32 flags, deterministic algorithms and the environment."""
    return (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(), dict(os.environ))


def _restore_process_settings(saved: tuple) -> None:
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
     torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     det, warn_only, env) = saved
    torch.use_deterministic_algorithms(det, warn_only=warn_only)
    os.environ.clear()
    os.environ.update(env)


def _turns_rank(rank: int, workdir: str, t_spawn: float, turns: tuple) -> None:
    """One process of ``spawn_turns``: each turn's ``fn(rank,
    workdir/turn<i>, *args)`` in order (``fn`` a rank function's name),
    the process-wide settings a turn changes put back after it, so each
    turn starts as in a process of its own; rank 0 writes each turn's
    seconds, and when the processes reached their first turn and left
    their last, to ``workdir/turns.json``."""
    t_start = time.time()
    seconds = []
    for i, (fn, args) in enumerate(turns):
        sub = os.path.join(workdir, f"turn{i}")
        os.makedirs(sub, exist_ok=True)
        saved = _process_settings()
        t0 = time.perf_counter()
        globals()[fn](rank, sub, *args)
        seconds.append(time.perf_counter() - t0)
        _restore_process_settings(saved)
        gc.collect()
        torch.cuda.empty_cache()
        if rank == 0:
            log(f"[clock] {fn.strip('_')}: {seconds[-1]:.1f} s in the shared spawn")
    if rank == 0:
        with open(os.path.join(workdir, "turns.json"), "w") as f:
            json.dump({"start_s": t_start - t_spawn, "seconds": seconds,
                       "end": time.time()}, f)


def spawn_turns(turns: tuple, nprocs: int) -> list:
    """``spawn_ranks`` for several rank functions in ONE spawn of
    ``nprocs`` processes, one after the other: ``turns`` holds
    ``(fn name, args)`` pairs; each turn's ``(rank files, seconds)``, in
    order.  The processes start and end once, not once a turn, and a
    later turn finds them warm (PERF.md §6 has what that saves)."""
    import tempfile

    import torch.multiprocessing as mp

    t_spawn = time.time()
    with tempfile.TemporaryDirectory(prefix="turns-") as wd:
        mp.spawn(_turns_rank, args=(wd, t_spawn, tuple(turns)), nprocs=nprocs, join=True)
        t_join = time.time()
        with open(os.path.join(wd, "turns.json")) as f:
            meta = json.load(f)
        out = []
        for i in range(len(turns)):
            ranks = []
            for r in range(nprocs):
                with open(os.path.join(wd, f"turn{i}", f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
            out.append((ranks, meta["seconds"][i]))
    log(f"[clock] shared spawn of {nprocs} processes: started in {meta['start_s']:.1f} s, "
        f"turns {sum(meta['seconds']):.1f} s, ended in {t_join - meta['end']:.1f} s")
    return out


def phase_lm_tp(tp1=None, backend: str = "gloo", spawned=None) -> dict:
    """Tensor parallelism on the card: ``LM_TP`` rank processes (with gloo,
    as ``main`` runs it, all on the one card, every collective staged
    through pinned host memory, since NCCL refuses two ranks on one
    device; ``backend="nccl"`` needs ``LM_TP`` cards, one a rank), each
    running ``_lm_tp_rank``: serving, then training.  ``tp1``:
    ``phase_lm_tp1``'s first funnel loss and grad norm (tp = 1, the same
    depth, seeded weights and batch).  ``spawned``: its turn of
    ``spawn_turns`` (the rank files and the turn's seconds), as ``main``
    runs it; else a spawn of its own."""
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    log(f"[lm_tp] {backend} on {cards}")
    ranks, wall = spawned or spawn_ranks(_lm_tp_rank, (backend, tp1), LM_TP)
    res = ranks[0]
    res["pp"] = pp_report(ranks)
    log("[pp] " + json.dumps(res["pp"]))
    res["wall_s"] = wall
    res["cards"] = cards
    res["transport"] = (
        f"gloo over pinned host memory, {LM_TP} processes on one card: the model-axis "
        f"psums and the sync's all-reduces are host copies, not a wire" if backend == "gloo"
        else f"{backend}, {LM_TP} processes on {torch.cuda.device_count()} cards")
    log("[lm_tp] " + json.dumps({k: v for k, v in res.items() if k != "runs"}))
    return res


def lm_tp_plan():
    """Rank 0's post-backward bucket plan of Qwen3-1.7B at lm_tp's depth
    (``LM_RANKS_LAYERS``) and data 1 x model ``LM_TP`` (its shards'
    shapes; 4 MiB buckets, 4 channels, f32 comm) and its depcha syncer's
    slots (the model-sharded leaves' and the replicated leaves'), on
    ``meta``."""
    from repro_torch.core import make_bucket_plan
    from repro_torch.core.overlap import LayerSync
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.transformer import _depcha_axes, init_params, param_specs
    from repro_torch.parallel.sharding import localize_structs
    from repro_torch.utils.trees import flatten_with_names

    mesh = make_smoke_mesh(1, LM_TP)
    cfg = dataclasses.replace(lm_config("depcha"), tp=LM_TP, n_layers=LM_RANKS_LAYERS)
    full = init_params(cfg, device="meta")
    local = localize_structs(full, param_specs(full, cfg), mesh)
    plan = make_bucket_plan(local, param_specs(local, cfg), mesh,
                            bucket_bytes=4 * 1024 * 1024, num_channels=4)
    axes = _depcha_axes(cfg, local["blocks"], "blocks/")
    return plan, flatten_with_names(local)[0], local["blocks"], axes, cfg


def phase_lm_tp_kernels() -> dict:
    """Rows 1-2 at the tp layout, bit for bit against their plain versions
    (outputs started as NaN): every bucket of rank 0's post-backward plan
    at data 1 x model 4 (two reduce sets: ("data",) for the model-sharded
    leaves, ("data", "model") for the replicated ones; bf16 leaves, f32
    comm) and each layer's two depcha slots (bf16, a bit copy); one step's
    worth of each timed.  Row 3 at the two-axis ring of data 2 x model 2:
    the pair kernel on the hops of the replicated buckets' ring, the
    "data" ring's on the whole bucket and the "model" ring's on its half,
    against torch.add."""
    from repro_torch.kernels.collectives import kernel

    plan, named, blocks_meta, axes, cfg = lm_tp_plan()
    gen = torch.Generator(device="cuda").manual_seed(0)
    flat = [torch.randn(p.shape, generator=gen, device="cuda").to(p.dtype) for _, p in named]
    f32 = torch.float32
    err, n_checks = 0.0, 0
    sets = sorted({b.reduce_axes for b in plan.buckets})
    for b in plan.buckets:
        before = (kernel.PACK_LAUNCHES, kernel.UNPACK_LAUNCHES)
        err = max(err, check_bucket(b, flat, f32, 1.0))
        if (kernel.PACK_LAUNCHES - before[0], kernel.UNPACK_LAUNCHES - before[1]) != (1, 1):
            raise AssertionError(f"tp bucket {b.bucket_id}: expected 1 pack and 1 unpack launch")
        n_checks += 1
    stack, slot_dts = layer_slots(blocks_meta, axes)
    slots = [b for b, _ in slot_dts]
    blocks = {n[len("blocks/"):]: t for (n, _), t in zip(named, flat) if n.startswith("blocks/")}
    rows = [[blocks[n][li] for n, _ in stack] for li in range(cfg.n_layers)]
    for slot in slots:
        for li in range(cfg.n_layers):
            err = max(err, check_bucket(slot, rows[li], cfg.dtype, 1.0))
            n_checks += 1
    # the two-axis ring at data 2 x model 2 (a bucket padded to 4 chunks):
    # the "data" ring of 2 on the bucket, the "model" ring of 2 on its half
    replicated = [-(-b.size // 4) * 4 for b in plan.buckets if "model" in b.reduce_axes]
    hops = check_accum_pairs(replicated + [n // 2 for n in replicated],
                             torch.Generator(device="cuda").manual_seed(1), g=2)
    torch.cuda.synchronize()
    out = {"post_backward": time_staging([(b, flat) for b in plan.buckets], f32),
           "slots": time_staging([(s, r) for s in slots for r in rows], cfg.dtype),
           "max_abs_err": err, "checks": n_checks, "accum_pair_checks": hops,
           "buckets": {str(ax): sum(1 for b in plan.buckets if b.reduce_axes == ax)
                       for ax in sets},
           "slot_sizes": [s.size for s in slots]}
    log(f"[lm_tp_kernels] {n_checks} checks bit-exact (max abs err {err}): "
        f"{len(plan.buckets)} buckets of rank 0's tp={LM_TP} shards over {sets} and "
        f"{len(slots)} slots a layer; {hops} ring-hop pair checks; " + json.dumps(out))
    return out


# ------------------------------------------------------------- FSDP (LM)

LM_FSDP_MESH = (2, 2)          # lm_fsdp: (data, model), 4 rank processes on the card
FSDP_LEAVES = ("wq", "wo", "wg", "wu", "wdown")     # Qwen3-1.7B's _FSDP_DIM leaves
# the f32 equivalences: check 5's limits (loss, params), compare_tp's
# (loss, gradients) and the reducers beside concom's flat
FSDP_CHECK5_TOL = (3e-4, 5e-4)
FSDP_EQ_REDUCERS = ("ring", "compressed")


def lm_fsdp_collectives(cfg, data: int, tokens: int) -> dict:
    """The FSDP collectives of one training step, counted from the code:
    each layer gathers each of its FSDP leaves in the forward
    (``all_gather_into_tensor``) and again in the remat's recompute (the
    gathers open the layer, before anything the recompute must rebuild),
    and reduce-scatters each leaf's gradient once in the backward (an
    ``all_to_all_single`` of its chunks).  Bytes: the gathered blocks (the
    rank's model shard of a layer's leaf, whole over the dp axes) for
    each gather and for each all-to-all's output.  Beside them the
    model-axis collectives of ``lm_tp_collectives`` at ``tokens`` local
    tokens (none at tp = 1)."""
    from repro_torch.models.transformer import _FSDP_DIM, init_params, param_specs
    from repro_torch.parallel.sharding import MODEL_AXIS, local_shape
    from repro_torch.launch.mesh import make_smoke_mesh

    full = init_params(cfg, device="meta")
    mesh = make_smoke_mesh(1, cfg.tp)
    specs = param_specs(full, dataclasses.replace(cfg, fsdp=False))
    layer_bytes = sum(
        math.prod(local_shape(full["blocks"][n].shape, specs["blocks"][n], mesh)[1:])
        * cfg.dtype.itemsize for n in _FSDP_DIM if n in full["blocks"])
    leaves = sum(1 for n in _FSDP_DIM if n in full["blocks"])
    L = cfg.n_layers
    gathers = 2 * L * leaves if cfg.remat in ("dots", "full") else L * leaves
    out = {"all_gather_into_tensor": {"calls": gathers,
                                      "bytes": gathers // leaves * layer_bytes},
           "all_to_all_single": {"calls": L * leaves, "bytes": L * layer_bytes},
           "leaves_per_layer": leaves, "gathered_bytes_per_layer": layer_bytes,
           "dp": data}
    if cfg.tp > 1:
        out["model_axis"] = lm_tp_collectives(cfg, tokens)
    return out


def _fsdp_equivalence(rank: int, mesh, say) -> dict:
    """f32 equivalences on the card at the lm_fsdp mesh, each through
    ``make_train_step`` with ``fsdp=True``.  (1) The reference's check 5
    on its ``mk_dense`` (2 layers, d 64, 8/2 heads, ff 128, vocab 96): one
    concom AdamW step (lr 1e-3, no clip) against the same step at dp 1 x
    tp 1 on the whole batch, the loss within 3e-4 and every param shard
    within 5e-4; then under ring and compressed (rows 3, 6-7), SGD at
    learning rate 0 without momentum, whose new state is the clipped
    gradients, at compare_tp's tolerances against tp = 1 on the whole
    batch, with a binding clip (half the tp = 1 norm).  (2) granite-moe's
    smoke config (8 experts sharded over "model", vocab 96) with FSDP,
    the same SGD step, against tp = 1 at the same dp (an expert's
    capacity follows the rank's tokens): each rank's tp = 1 loss and
    gradients on its own rows, summed over its dp group, clipped by the
    norm of the sum, at (3e-4, 2e-3)."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.core import GradSyncConfig
    from repro_torch.core import dependency as dep
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.collectives import kernel as ck
    from repro_torch.kernels.quantize import kernel as qk
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw, sgd
    from repro_torch.optim.optimizers import apply_updates
    from repro_torch.parallel.sharding import dp_index, shard_tree
    from repro_torch.runtime import make_train_step
    from repro_torch.utils.trees import flatten_with_names, tree_unflatten

    data, model = mesh.shape["data"], mesh.shape["model"]
    seq, batch = 32, 4

    def dense(tp, **over):
        return tf.TransformerConfig(name="dense", n_layers=2, d_model=64, n_heads=8,
                                    kv_heads=2, d_ff=128, vocab=96, attn_chunk=16, tp=tp,
                                    dtype=torch.float32, **over)

    def granite(tp, **over):
        return dataclasses.replace(get_arch("granite-moe-1b-a400m").make_smoke(), vocab=96,
                                   tp=tp, **over)

    def oracle(cfg1, full, b):
        """tp = 1 loss and gradients of ``full`` on batch ``b``."""
        named, treedef = flatten_with_names(full)
        leaves = {n: p.clone().requires_grad_(True) for n, p in named}
        loss = tf.train_forward(tree_unflatten(treedef, list(leaves.values())), b, cfg1)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in leaves.items()}

    def step(cfg, full, opt, clip, reducer="flat"):
        specs = tf.param_specs(full, cfg)
        local, treedef = flatten_with_names(shard_tree(full, specs, mesh, rank))
        net = tf.Transformer(cfg, tree_unflatten(treedef, [p.clone() for _, p in local]))
        ts = make_train_step(cfg, mesh, GradSyncConfig(
            strategy="concom", reducer=reducer, bucket_bytes=1 << 12, num_channels=3),
            opt, model=net, clip_norm=clip, device="cuda")
        def counts():
            return (ck.ACCUM_LAUNCHES, qk.QUANTIZE_LAUNCHES, qk.SUM_QUANTIZE_LAUNCHES,
                    qk.DEQUANTIZE_LAUNCHES)

        c0 = counts()
        net, state, metrics = ts.fn(net, ts.init_opt(), pipe.batch_at(0), 0)
        torch.cuda.synchronize()
        launches = [a - b for a, b in zip(counts(), c0)]
        ts.close()
        return net, state, metrics, specs, launches

    pipe = TokenPipeline(96, seq, batch, seed=3, mesh=mesh, rank=rank, device="cuda")
    whole = TokenPipeline(96, seq, batch, seed=3, device="cuda").batch_at(0)
    out = {"cases": {}}
    # (1) check 5, then the reducers' clipped gradients
    full = tf.init_params(dense(1), seed=1, device="cuda")
    want_loss, want = oracle(dense(1), full, whole)
    opt1 = adamw(1e-3)
    upd, _ = opt1.update(want, opt1.init(dict(flatten_with_names(full)[0])),
                         dict(flatten_with_names(full)[0]), 0)
    after = {n: p.clone() for n, p in flatten_with_names(full)[0]}
    apply_updates(after, upd)
    net, _, metrics, specs, _ = step(dense(model, fsdp=True), full, adamw(1e-3), 0.0)
    cut = dict(flatten_with_names(shard_tree(tree_unflatten(flatten_with_names(full)[1],
                                                            list(after.values())),
                                             specs, mesh, rank))[0])
    dloss = abs(float(metrics["loss"]) - want_loss.item())
    dparam = max((p.detach() - cut[n]).abs().max().item()
                 for n, p in flatten_with_names(net.params_tree())[0])
    if dloss >= FSDP_CHECK5_TOL[0] or dparam >= FSDP_CHECK5_TOL[1]:
        raise AssertionError(f"fsdp check 5 at {data}x{model}: dloss {dloss}, params {dparam}")
    out["cases"]["check5"] = {"dloss": dloss, "dparam": dparam, "tol": FSDP_CHECK5_TOL}
    norm = math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in want.values()))
    clip = norm / 2
    for reducer in FSDP_EQ_REDUCERS:
        _, state, metrics, specs, launches = step(dense(model, fsdp=True), full,
                                                  sgd(0.0, momentum=0.0), clip, reducer)
        tol, grad_tol = TP_EQ_TOL[reducer]
        cut = dict(flatten_with_names(shard_tree(want, specs, mesh, rank))[0])
        worst = max(((state["mom"][n] - cut[n] * (clip / norm)).abs().max()
                     / (want[n].abs().max() + 1e-8)).item() for n in state["mom"])
        dloss = abs(float(metrics["loss"]) - want_loss.item())
        dnorm = abs(float(metrics["grad_norm"]) - norm) / norm
        if dloss >= tol or dnorm >= grad_tol or worst >= grad_tol:
            raise AssertionError(f"fsdp {reducer} at {data}x{model}: dloss {dloss}, norm "
                                 f"{dnorm}, clipped grads {worst} (tol {tol}, {grad_tol})")
        if 0 in (launches[:1] if reducer == "ring" else launches[1:]):
            raise AssertionError(f"fsdp {reducer}: launches (accum, quantize, sum-quantize, "
                                 f"dequantize) {launches}")
        out["cases"][reducer] = {"dloss": dloss, "grad_norm_rel": dnorm,
                                 "clipped_grad_rel": worst, "accum_launches": launches[0],
                                 "quantize_launches": launches[1],
                                 "sum_quantize_launches": launches[2],
                                 "dequantize_launches": launches[3]}
    # (2) granite's MoE with FSDP against tp = 1 at the same dp
    full = tf.init_params(granite(1), seed=1, device="cuda")
    mine = TokenPipeline(96, seq, batch, seed=3, mesh=mesh, rank=rank, device="cuda").batch_at(0)
    loss1, g1 = oracle(granite(1), full, mine)
    dp_group = dep.coset_groups([("data",)], mesh, torch.device("cpu"))[
        dep.reduce_key(("data",), mesh)]
    sums = torch.cat([loss1.reshape(1)] + [g.reshape(-1) for g in g1.values()]).cpu()
    if dp_group is not None:
        dist.all_reduce(sums, group=dp_group)
    want_loss, off, want = float(sums[0]), 1, {}
    for n, g in g1.items():
        want[n] = sums[off:off + g.numel()].view(g.shape).cuda()
        off += g.numel()
    norm = math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in want.values()))
    clip = norm / 2
    _, state, metrics, specs, _ = step(granite(model, fsdp=True), full,
                                       sgd(0.0, momentum=0.0), clip)
    cut = dict(flatten_with_names(shard_tree(want, specs, mesh, rank))[0])
    worst = max(((state["mom"][n] - cut[n] * (clip / norm)).abs().max()
                 / (want[n].abs().max() + 1e-8)).item() for n in state["mom"])
    dloss = abs(float(metrics["loss"]) - want_loss)
    dnorm = abs(float(metrics["grad_norm"]) - norm) / norm
    if dloss >= 3e-4 or dnorm >= 2e-3 or worst >= 2e-3:
        raise AssertionError(f"granite fsdp at {data}x{model} vs tp = 1: dloss {dloss}, norm "
                             f"{dnorm}, clipped grads {worst}")
    out["cases"]["granite-fsdp"] = {"dloss": dloss, "grad_norm_rel": dnorm,
                                    "clipped_grad_rel": worst, "dp_index": dp_index(rank, mesh)}
    say(f"[lm_fsdp] f32 equivalences at data {data} x model {model}: " + json.dumps(out))
    return out


def _lm_fsdp_rank(rank: int, workdir: str, backend: str, tp1, data: int, model: int) -> None:
    """One rank of ``phase_lm_fsdp``: first serving from FSDP's storage
    (``_serve_ranks`` at ``SERVE_FSDP_RUN``, then ``_serve_fsdp_f32``),
    then Qwen3-1.7B at full width and
    ``LM_RANKS_LAYERS`` layers with
    ``fsdp=True`` on data ``data`` x model ``model`` (seq 1024 x global
    batch 4, AdamW, clip 1.0, remat dots, bf16), each of funnel, concom
    and depcha (in-backward: the FSDP leaves pass through) from the
    seeded weights (each rank draws the global tree and keeps its
    shards), ``LM_RANKS_STEPS`` steps; each step's collectives counted
    by kind (``_CountingDep``) against ``lm_fsdp_collectives``; pack and
    unpack launches against the schedule plus depcha's slots; the fully
    replicated leaves bit-identical across the ranks after every run;
    the first loss and grad norm against the tp = 1 funnel's of the same
    depth (``tp1``, ``phase_lm_tp1``); one more funnel step with CUDA
    events around its stages.  Then ``_fsdp_equivalence``.  Results to ``workdir/rank<r>.json``."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core import GradSyncConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.collectives import kernel
    from repro_torch.launch.mesh import init_dist, make_mesh
    from repro_torch.models import common
    from repro_torch.models.transformer import Transformer, init_params, param_specs
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.parallel.sharding import flat_spec_axes
    from repro_torch.runtime import Trainer, make_train_step
    from repro_torch.utils.trees import flatten_with_names

    world = data * model
    init_dist("cuda", backend=backend, init_method=f"file://{workdir}/store", rank=rank,
              world_size=world, timeout=datetime.timedelta(seconds=600))
    torch.backends.cuda.matmul.allow_tf32 = False
    say = log if rank == 0 else (lambda _m: None)
    host = dist.new_group(backend="gloo")
    mesh = make_mesh(model)
    pipe = TokenPipeline(lm_config().vocab, LM_SEQ, LM_BATCH, seed=0, mesh=mesh, rank=rank,
                         device="cuda")
    counting = _CountingDep(common.dep)
    common.dep = counting
    out = {"runs": {}, "mesh": {"data": data, "model": model}}
    try:
        t0 = time.perf_counter()
        out["serve"] = _serve_ranks(rank, mesh, counting, host, say, SERVE_FSDP_RUN, fsdp=True)
        out["serve_f32"] = _serve_fsdp_f32(rank, mesh, say)
        out["serve"]["phase_s"] = time.perf_counter() - t0
        for strat in STRATEGIES:
            cfg = dataclasses.replace(lm_config(strat), tp=model, fsdp=True,
                                      n_layers=LM_RANKS_LAYERS)
            net = Transformer(cfg, init_params(cfg, seed=0, device="cuda", mesh=mesh, rank=rank))
            named = flatten_with_names(net.params_tree())[0]
            n_params = sum(p.numel() for _, p in named)
            opt = adamw(cosine_warmup(3e-4, 10, 100))
            ts = make_train_step(cfg, mesh, GradSyncConfig(strategy=strat), opt, model=net,
                                 clip_norm=1.0, device="cuda")
            opt_state = opt.init(dict(named))
            trainer = Trainer(ts, pipe, log_every=10 ** 9, printer=lambda _m: None)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernel.PACK_LAUNCHES = kernel.UNPACK_LAUNCHES = 0
            losses, norms, kinds = [], [], []
            for step in range(LM_RANKS_STEPS):
                before = {k: list(v) for k, v in counting.by_fn.items()}
                net, opt_state, hist = trainer.run(net, opt_state, step + 1, start_step=step)
                losses.append(hist["losses"][-1])
                norms.append(hist["metrics"]["grad_norm"])
                kinds.append({k: [v[0] - before.get(k, [0, 0, 0.0])[0],
                                  v[1] - before.get(k, [0, 0, 0.0])[1],
                                  v[2] - before.get(k, [0, 0, 0.0])[2]]
                              for k, v in counting.by_fn.items()})
            predicted = lm_fsdp_collectives(cfg, data, LM_SEQ * LM_BATCH // data)
            for k in ("all_gather_into_tensor", "all_to_all_single"):
                got = [[s.get(k, [0, 0])[0], s.get(k, [0, 0])[1]] for s in kinds]
                want = [predicted[k]["calls"], predicted[k]["bytes"]]
                if got != [want] * LM_RANKS_STEPS:
                    raise AssertionError(f"lm_fsdp {strat}: {k} (calls, bytes) a step {got}, "
                                         f"predicted {want}")
            if model > 1:
                mp = predicted["model_axis"]
                got = [s.get("all_reduce", [0, 0])[0] for s in kinds]
                # the loss all-reduce and the clip's are the train step's, not counted here
                if got != [mp["calls_per_step"]] * LM_RANKS_STEPS:
                    raise AssertionError(f"lm_fsdp {strat}: model-axis all-reduces {got}, "
                                         f"predicted {mp['calls_per_step']}")
            slots = sync_slots(ts.layer_sync)
            per_step = sum(staging_launches(op.bucket) for op in ts.gradsync.schedule.ops) + slots
            launches = {"pack": kernel.PACK_LAUNCHES, "unpack": kernel.UNPACK_LAUNCHES}
            if launches != {"pack": per_step * LM_RANKS_STEPS,
                            "unpack": per_step * LM_RANKS_STEPS}:
                raise AssertionError(f"lm_fsdp {strat}: launches {launches}, expected "
                                     f"{per_step} a step x {LM_RANKS_STEPS}")
            bucketed = {l.name for b in ts.gradsync.plan.buckets for l in b.leaves}
            if any(n.split("/")[-1] in FSDP_LEAVES for n in bucketed):
                raise AssertionError(f"lm_fsdp {strat}: an FSDP leaf in a GradSync bucket")
            if ts.layer_sync is not None and len(ts.layer_sync.passthrough) != len(FSDP_LEAVES):
                raise AssertionError(f"lm_fsdp {strat}: passthrough {ts.layer_sync.passthrough}")
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"lm_fsdp {strat}: non-finite loss {losses}")
            specs = dict(flatten_with_names(param_specs(net.params_tree(), cfg))[0])
            rep = [p for n, p in named if not flat_spec_axes(specs[n])]
            _same_on_every_rank(rep, f"lm_fsdp {strat} replicated leaves", host)
            times = trainer.step_times
            run = {"losses": losses, "grad_norms": norms, "params_per_rank": n_params,
                   "first_step_ms": trainer.first_step_time * 1e3,
                   "step_ms": [t * 1e3 for t in times],
                   "tokens_per_s": [pipe.global_batch * LM_SEQ / t for t in times],
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "launches": launches, "launches_per_step": per_step,
                   "buckets": len(ts.gradsync.schedule.ops), "slots_per_step": slots,
                   "collectives_per_step": kinds, "predicted": predicted,
                   "replicated_leaves": len(rep)}
            if strat == "funnel":
                run["stages"] = lm_stage_spans(ts, net, opt_state, pipe)
            out["runs"][strat] = run
            say(f"[lm_fsdp] {strat}: " + json.dumps(run))
            ts.close()
            del ts, net, opt_state, trainer, named, rep
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        common.dep = counting._dep
    if tp1 is not None:
        for i, (what, key, rtol) in enumerate((
                ("loss", "losses", LM_TP_FIRST_LOSS_RTOL),
                ("grad_norm", "grad_norms", LM_TP_FIRST_NORM_RTOL))):
            first = [r[key][0] for r in out["runs"].values()]
            worst = max(abs(x - tp1[i]) / abs(tp1[i]) for x in first)
            out[f"first_{what}_vs_tp1"] = {"tp1": tp1[i], "fsdp": first, "max_rel": worst,
                                           "rtol": rtol}
            if worst > rtol:
                raise AssertionError(f"lm_fsdp first {what} {first} vs tp = 1 {tp1[i]}: "
                                     f"rel {worst} > {rtol}")
    out["equivalence"] = _fsdp_equivalence(rank, mesh, say)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def phase_lm_fsdp(tp1=None, backend: str = "gloo", data: int = LM_FSDP_MESH[0],
                  model: int = LM_FSDP_MESH[1], spawned=None) -> dict:
    """FSDP on the card: data x model rank processes (with gloo, as
    ``main`` runs it, all on the one card, every collective staged
    through pinned host memory; ``backend="nccl"`` needs a card a rank),
    each running ``_lm_fsdp_rank``: serving, then training.
    ``tp1``: ``phase_lm_tp1``'s first funnel loss and grad norm (tp = 1,
    the same depth, seeded weights and batch).  By
    hand on four cards: ``phase_lm_fsdp(backend="nccl", data=4, model=1)``
    (pure ZeRO-3).  ``spawned``: its turn of
    ``spawn_turns`` (the rank files and the turn's seconds), as ``main``
    runs it; else a spawn of its own."""
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    log(f"[lm_fsdp] {backend} on {cards}, data {data} x model {model}")
    ranks, wall = spawned or spawn_ranks(_lm_fsdp_rank, (backend, tp1, data, model),
                                         data * model)
    res = ranks[0]
    res["wall_s"] = wall
    res["cards"] = cards
    res["transport"] = (
        f"gloo over pinned host memory, {data * model} processes on one card: the FSDP "
        f"gathers and reduce-scatters, the model psums and the sync's all-reduces are host "
        f"copies, not a wire" if backend == "gloo"
        else f"{backend}, {data * model} processes on {torch.cuda.device_count()} cards")
    log("[lm_fsdp] " + json.dumps({k: v for k, v in res.items() if k != "runs"}))
    return res


def _zero1_rank(rank: int, workdir: str, backend: str) -> None:
    """One rank of the zero1 phase: every run of ``ZERO1_RANK_RUNS`` from
    the same seeded weights; checks; results to ``workdir/rank<r>.json``."""
    import datetime

    import torch.distributed as dist

    from repro_torch.configs.resnet50_cifar import make_config
    from repro_torch.core import GradSyncConfig
    from repro_torch.core.schedule import group_size
    from repro_torch.data import ImagePipeline
    from repro_torch.kernels.collectives import kernel as ck
    from repro_torch.launch.mesh import init_dist, make_dp_mesh
    from repro_torch.models.resnet import ResNet, init_params
    from repro_torch.optim import linear_scaling_rule, sgd, zero1
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
    cfg = make_config()
    mesh = make_dp_mesh()
    pipe = ImagePipeline(cfg.img_size, cfg.num_classes, 256, seed=0, mesh=mesh,
                         rank=rank, device="cuda")
    out, params_first, params_end = {"runs": {}}, {}, {}
    for run, plan, strategy, reducer, clip in ZERO1_RANK_RUNS:
        model = ResNet(cfg, init_params(cfg, seed=0, device="cuda"))
        opt = sgd(linear_scaling_rule(0.1, 256, 256), momentum=0.9)
        if plan is not None:
            opt = zero1(opt, ("data",), RING)
        sync = GradSyncConfig(strategy=strategy, reducer=reducer,
                              exclude_axes=("data",) if plan else ())
        ts = make_train_step(cfg, mesh, sync, opt, model=model, clip_norm=clip,
                             zero1_mode=plan is not None, zero1_plan=plan or "scheduled",
                             device="cuda")
        named = flatten_with_names(model.params_tree())[0]
        opt_state = ts.init_opt()
        staging = zero1_staging_launches(ts.gradsync, plan, named)
        dp_buckets = ts.gradsync.dp_plan.buckets if ts.gradsync.dp_plan is not None else ()
        # the ring combines once a hop, in each reduce-scatter or allreduce
        # of more than one rank (not the model axis's group of one)
        rings = sum(op.kind in ("reduce_scatter", "allreduce") and group_size(
            op.bucket.reduce_axes, ts.gradsync.mesh_shape) > 1
            for op in ts.gradsync.schedule.ops)
        predicted = {"pack": staging["pack"] * REDUCER_STEPS,
                     "unpack": staging["unpack"] * REDUCER_STEPS,
                     "accum": (RING - 1) * rings * REDUCER_STEPS if reducer == "ring" else 0}
        trainer = Trainer(ts, pipe, log_every=10 ** 9, printer=lambda _m: None)
        ck.PACK_LAUNCHES = ck.UNPACK_LAUNCHES = ck.ACCUM_LAUNCHES = 0
        norms = []
        for step in range(REDUCER_STEPS):
            model, opt_state, hist = trainer.run(model, opt_state, step + 1, start_step=step)
            norms.append(hist["metrics"]["grad_norm"])
            _same_on_every_rank([p for _, p in named], f"zero1 {run} params after step "
                                f"{step}", host)
            if step == 0:
                params_first[run] = [p.detach().clone() for _, p in named]
        launches = {"pack": ck.PACK_LAUNCHES, "unpack": ck.UNPACK_LAUNCHES,
                    "accum": ck.ACCUM_LAUNCHES}
        if launches != predicted:
            raise AssertionError(f"zero1 {run}: launches {launches}, predicted {predicted}")
        state_bytes = hist["metrics"]["mem.state_bytes"]
        opt_bytes = optimizer_bytes(opt_state)
        if ts.finalize is not None:
            ts.finalize(model, opt_state)
        params_end[run] = [p.detach().clone() for _, p in named]
        want_opt = (4 * sum(-(-b.size // RING) for b in dp_buckets)
                    * (2 if plan == "deferred" else 1))
        if plan == "monolithic":
            want_opt = 4 * -(-sum(p.numel() for _, p in named) // RING)
        if plan is not None and opt_bytes != want_opt:
            raise AssertionError(f"zero1 {run}: optimizer state {opt_bytes} bytes, "
                                 f"expected {want_opt}")
        out["runs"][run] = {
            "launches": launches, "dp_buckets": len(dp_buckets),
            "ops": ts.gradsync.schedule.stats()["kinds"],
            "state_bytes": state_bytes, "optimizer_state_bytes": opt_bytes,
            "first_step_ms": trainer.first_step_time * 1e3,
            "step_ms": [t * 1e3 for t in trainer.step_times],
            "losses": hist["losses"], "grad_norms": norms}
        say(f"[zero1] {run}: launches {launches} (= prediction), params bit-identical "
            f"on the {RING} ranks after each of {REDUCER_STEPS} steps; state "
            f"{state_bytes} bytes a rank (optimizer {opt_bytes}); first step "
            f"{trainer.first_step_time * 1e3:.1f} ms, then "
            f"{[round(t * 1e3, 1) for t in trainer.step_times]} ms")
        ts.close()
        del ts, model, opt_state, trainer
        gc.collect()
    for a, b in (("deferred", "scheduled"), ("monolithic", "scheduled_noclip")):
        for x, y in zip(params_end[a], params_end[b]):
            same_bits(x, y, f"zero1 {a} vs {b}")

    def apart(a, b) -> float:
        """Max over leaves of max |a - b| / the leaf's absmax in b."""
        return max((x - y).abs().max().item() / max(y.abs().max().item(), 1e-30)
                   for x, y in zip(a, b))

    # one step: the same sums in another order (the reducers phase's
    # tolerance).  After three, BatchNorm at lr 0.1 carries a last-bit
    # difference on; the witness, the flat allreduce with the ring's sum
    # order and no zero1 in it, says how far: each zero1 run stays within
    # ZERO1_WITNESS_FACTOR times the witness's distance from flat
    witness = {"after_one_step": apart(params_first["flat_ring"], params_first["flat"]),
               f"after_{REDUCER_STEPS}_steps": apart(params_end["flat_ring"],
                                                     params_end["flat"])}
    bound = ZERO1_WITNESS_FACTOR * witness[f"after_{REDUCER_STEPS}_steps"]
    worst, worst_end = 0.0, 0.0
    for run in ("scheduled", "scheduled_ring", "rsag_ring"):
        for x, y in zip(params_first[run], params_first["flat"]):
            absmax = max(y.abs().max().item(), 1e-30)
            if not torch.allclose(x, y, rtol=1e-5, atol=1e-5 * absmax):
                raise AssertionError(f"zero1 {run} vs flat params after one step differ "
                                     f"by {(x - y).abs().max().item()}")
        worst = max(worst, apart(params_first[run], params_first["flat"]))
        end = apart(params_end[run], params_end["flat"])
        if not end <= bound:
            raise AssertionError(f"zero1 {run} vs flat after {REDUCER_STEPS} steps: {end} "
                                 f"of a leaf's absmax, beyond {ZERO1_WITNESS_FACTOR} x the "
                                 f"witness's {witness}")
        worst_end = max(worst_end, end)
    # and each step's grad norm (the clip's input, before that step's
    # update) within the same factor of the witness's distance from
    # flat's, or 1e-5 where the witness has none (step 0: the NORM sums
    # the shards in another order than the flat run's clip)
    norms = {k: v["grad_norms"] for k, v in out["runs"].items()}
    apart_norms = {k: [abs(a - b) / b for a, b in zip(v, norms["flat"])]
                   for k, v in norms.items() if k in ("flat_ring", "scheduled", "scheduled_ring",
                                                      "rsag_ring", "deferred")}
    for run in ("scheduled", "scheduled_ring", "rsag_ring", "deferred"):
        for step, (d, w) in enumerate(zip(apart_norms[run], apart_norms["flat_ring"])):
            if not d <= max(ZERO1_WITNESS_FACTOR * w, 1e-5):
                raise AssertionError(f"zero1 {run}: step {step}'s grad norm {norms[run][step]} "
                                     f"is {d} from flat's {norms['flat'][step]}, beyond "
                                     f"{ZERO1_WITNESS_FACTOR} x the witness's {w}")
    flat_opt = out["runs"]["flat"]["optimizer_state_bytes"]
    out["flat_optimizer_state_over_4"] = flat_opt / RING
    out["scheduled_vs_flat_params_max_diff_over_leaf_absmax"] = {
        "after_one_step": worst, f"after_{REDUCER_STEPS}_steps": worst_end}
    out["witness_flat_ring_vs_flat_params_max_diff_over_leaf_absmax"] = witness
    out["grad_norm_rel_diff_from_flat"] = apart_norms
    say(f"[zero1] deferred = scheduled and monolithic = scheduled (clip 0) bit for bit; "
        f"scheduled (flat, ring, rsag ring) within rtol 1e-5 of the flat allreduce "
        f"after one step (max diff / leaf absmax {worst}); after {REDUCER_STEPS} steps "
        f"{worst_end}, within {ZERO1_WITNESS_FACTOR} x the witness's (the flat allreduce "
        f"in the ring's sum order) {witness}; grad norms apart from flat's, each step "
        f"within {ZERO1_WITNESS_FACTOR} x the witness's: {apart_norms}; optimizer state a rank "
        f"{out['runs']['scheduled']['optimizer_state_bytes']} bytes against the flat "
        f"run's {flat_opt} / {RING} = {flat_opt / RING}")
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def phase_zero1(backend: str = "gloo", spawned=None) -> dict:
    """Four rank processes on the one card (as ``reducers``): ZeRO-1 at
    full ResNet-50/CIFAR width (``ZERO1_RANK_RUNS``).
    ``spawned``: its turn of ``spawn_turns`` (the rank files and the
    turn's seconds), as ``main`` runs it; else a spawn of its own."""
    ranks, wall = spawned or spawn_ranks(_zero1_rank, (backend,), RING)
    for r, res in enumerate(ranks):
        if {k: v["launches"] for k, v in res["runs"].items()} != \
                {k: v["launches"] for k, v in ranks[0]["runs"].items()}:
            raise AssertionError(f"rank {r} launched other counts than rank 0")
    res = ranks[0]
    res["state_bytes_by_rank"] = {k: [rk["runs"][k]["state_bytes"] for rk in ranks]
                                  for k in res["runs"]}
    res["wall_s"] = wall
    res["transport"] = (
        f"gloo over pinned host memory, {RING} processes on one card" if backend == "gloo"
        else f"{backend}, {RING} processes on {torch.cuda.device_count()} cards")
    log("[zero1] " + json.dumps(res))
    return res


def zero1_bucket_sizes(arch: str) -> list:
    """The zero1 dp plan's bucket sizes of ``arch`` (``resnet50-cifar`` or
    ``qwen3-1.7b``) under concom, as its zero1 runs plan them, on ``meta``."""
    from repro_torch.core import GradSyncConfig
    from repro_torch.core.kvstore import plan_sync
    from repro_torch.launch.mesh import make_dp_mesh

    if arch == "resnet50-cifar":
        from repro_torch.configs.resnet50_cifar import make_config
        from repro_torch.models.resnet import init_params, param_specs
        params = init_params(make_config(), device="meta")
        specs = param_specs(params)
    else:
        from repro_torch.models.transformer import init_params, param_specs
        cfg = lm_config("concom")
        params = init_params(cfg, device="meta")
        specs = param_specs(params, cfg)
    planned = plan_sync(GradSyncConfig(strategy="concom", exclude_axes=("data",),
                                       zero1_dp_axes=("data",), zero1_clip=True),
                        make_dp_mesh(), specs, params)
    return [b.size for b in planned.program.dp_plan.buckets]


def _rs_transport_rank(rank: int, workdir: str, backend: str) -> None:
    """One rank of ``phase_rs_transport``."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core import dependency as dep
    from repro_torch.core.schedule import _rank_ordered_reduce_scatter
    from repro_torch.launch.mesh import init_dist

    init_dist("cuda", backend=backend, init_method=f"file://{workdir}/store",
              rank=rank, world_size=RING, timeout=datetime.timedelta(seconds=300))
    out = {}
    for arch in ("resnet50-cifar", "qwen3-1.7b"):
        sizes = [-(-n // RING) * RING for n in zero1_bucket_sizes(arch)]
        bufs = [torch.randn(n, generator=torch.Generator(device="cuda").manual_seed(
            1000 * rank + i), device="cuda") for i, n in enumerate(sizes)]

        def a2a():
            return [_rank_ordered_reduce_scatter(b, dist.group.WORLD, RING).wait()
                    for b in bufs]

        def rst():
            shards = []
            for b in bufs:
                shards.append(torch.empty(b.numel() // RING, device="cuda"))
                dep.collective(dist.reduce_scatter_tensor, dist.group.WORLD,
                               shards[-1], b).wait()
            return shards

        # the first bucket's shard against the plain sum over the ranks in
        # rank order (every rank's buffer made again from its seed)
        n0 = sizes[0] // RING
        plain = None
        for r in range(RING):
            x = torch.randn(sizes[0], generator=torch.Generator(device="cuda").manual_seed(
                1000 * r), device="cuda")[rank * n0:(rank + 1) * n0]
            plain = x.clone() if plain is None else plain.add_(x)
        errs = {"a2a": (a2a()[0] - plain).abs().max().item(),
                "reduce_scatter_tensor": (rst()[0] - plain).abs().max().item()}
        if errs["a2a"] != 0.0:
            raise AssertionError(f"{arch}: the all-to-all reduce-scatter is not the rank-order "
                                 f"sum: max abs err {errs['a2a']}")
        times = {"a2a": [], "reduce_scatter_tensor": []}
        for name in ("a2a", "reduce_scatter_tensor", "reduce_scatter_tensor", "a2a"):
            fn = a2a if name == "a2a" else rst
            reps = []
            for _ in range(5):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                reps.append((time.perf_counter() - t0) * 1e3)
            times[name].append(sorted(reps)[len(reps) // 2])
        out[arch] = {"buckets": len(sizes), "bytes": 4 * sum(sizes), "max_abs_err": errs,
                     "ms_per_step_median_of_5_in_turns": times,
                     "a2a_over_reduce_scatter_tensor": sum(times["a2a"])
                     / sum(times["reduce_scatter_tensor"])}
        del bufs
        torch.cuda.empty_cache()
    if rank == 0:
        with open(os.path.join(workdir, "rank0.json"), "w") as f:
            json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def phase_rs_transport(backend: str = "nccl") -> dict:
    """By hand, on four cards of one host: the zero1
    reduce-scatter's two transports over one step's buckets of each zero1
    dp plan (ResNet-50/CIFAR's, Qwen3-1.7B's; f32, padded to a multiple of
    4), one rank a card: the all-to-all plus rank-ordered adds
    (``core/schedule.py::_rank_ordered_reduce_scatter``, bit-identical
    wherever the plan cuts the buckets) against ``reduce_scatter_tensor``,
    in turns (a, b, b, a), each the median of 5 barrier-aligned wall
    times."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="rs-transport-") as wd:
        mp.spawn(_rs_transport_rank, args=(wd, backend), nprocs=RING, join=True)
        with open(os.path.join(wd, "rank0.json")) as f:
            res = json.load(f)
    res["transport"] = f"{backend}, {RING} processes on {torch.cuda.device_count()} cards"
    log("[rs_transport] " + json.dumps(res))
    return res


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
        if live is not None:
            live[0].close()
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
    ts.close()
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
        ts.close()
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


def ring_step_hops(sizes, gen, dtype=torch.float32, g: int = RING) -> list:
    """One rank's ring reduce-scatter combines over a step, as a ring of
    ``g`` forms them: per bucket (padded to g · c) and hop, the received
    messages of the two half-chunks and this rank's own rows of
    ``x2d[:, :h]`` and ``x2d[:, h:]`` (one pair when h = 0)."""
    from repro_torch.kernels.collectives import ref as cr

    hops = []
    for n in sizes:
        c = -(-n // g)
        x2d = torch.randn(g * c, generator=gen, device="cuda").to(dtype).view(g, c)
        rings = cr._rings(x2d, True)
        for s in range(1, g):
            own = [part[(0 - sgn * (s + 1)) % g] for part, sgn in rings]
            hops.append(([torch.randn(o.numel(), generator=gen, device="cuda").to(dtype)
                          for o in own], own))
    return hops


def check_accum_pairs(sizes, gen, g: int = RING) -> int:
    """The pair kernel against torch.add, bit for bit, one launch a call
    (the hops of a ring of ``g`` over ``sizes``)."""
    from repro_torch.kernels.collectives import kernel as ck

    cases = []
    for dt in ACCUM_DTYPES:
        cases += ring_step_hops(sizes, gen, dt, g)[::g - 1]      # a hop a bucket
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
    from repro_torch.core import dependency as dep
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
        ts.close()
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
    comms = dep.mesh_comms([0], [bucket.reduce_axes], mesh, inp.device)[0]
    with_kernel = co.ring_allreduce(inp.clone(), bucket.reduce_axes, mesh.shape, comms)
    buf = F.pad(inp, (0, (-inp.numel()) % RING))
    plain = cr.ring_all_gather_ref(
        cr.ring_reduce_scatter_ref(buf, group, accum=cr.ring_accum_pairs_ref), group)
    same_bits(with_kernel, plain[:inp.numel()], f"ring allreduce of bucket "
              f"{bucket.bucket_id}: kernel vs plain add")
    out["captured_bucket"] = {"bucket": bucket.bucket_id, "elements": inp.numel()}
    out["lm"] = _lm_ranks(rank, host, say)
    out["sim"] = _sim_ranks(rank, workdir, mesh, host, say)
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
        ts.close()
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


def _resnet_auto_plan(mesh, batch: int = 256) -> dict:
    """``auto``'s plan of ResNet-50/CIFAR's gradients on ``mesh`` (no
    process group: ``plan_sync``), ranked with the step's compute model at
    global ``batch``; its report."""
    from repro_torch.configs.resnet50_cifar import make_config
    from repro_torch.core import GradSyncConfig, plan_sync
    from repro_torch.models.resnet import init_params, param_specs
    from repro_torch.sim import compute_model_for, last_auto_report

    cfg = make_config()
    params = init_params(cfg, device="meta")
    compute = compute_model_for(cfg, global_batch=batch, seq_len=1, n_devices=mesh.size)
    plan_sync(GradSyncConfig(strategy="auto", sim_compute=compute), mesh,
              param_specs(params), params)
    return last_auto_report()


def _fit(rows, mesh_shape, prof_dir: str) -> dict:
    """``fit_network`` over measured rows, saved under ``prof_dir``;
    ``fitted_network`` must give it back exactly when its quality is ok."""
    from repro_torch.obs.calibrate import fit_network, fitted_network, save_profile

    model, info = fit_network(rows)
    path = save_profile(model, mesh_shape, dir=prof_dir, info=info)
    got, _ = fitted_network(mesh_shape, prof_dir)
    if (got is None) != (info["quality"] != "ok"):
        raise AssertionError(f"fitted_network gave {got} for a fit of quality "
                             f"{info['quality']}")
    return {"path": path, "used_by_auto": got is not None, **info}


def _sim_ranks(rank: int, workdir: str, mesh, host, say) -> dict:
    """The simulator's multi-rank share, on the reducers phase's spawn:
    ``python -m repro_torch.obs --fit``'s rows (concom's allreduces and
    rsag's reduce-scatters and all-gathers of ``obs/cli.py``'s stack at
    16, 64 and 256 KiB, 3 reps, on this world), ``fit_network`` and its
    quality (a host-staged gloo fit may be poor: ``fitted_network`` must
    then treat it as absent), and ``auto``'s plan of ResNet-50 at this
    data extent with its ranking, under the fitted profile when it is
    ok."""
    import torch.distributed as dist

    from repro_torch.obs.cli import fit_rows

    t0 = time.perf_counter()
    rows, mesh_shape = fit_rows(mesh, "cuda", reps=3)
    prof_dir = os.path.join(workdir, "profiles")
    out = {"rows": len(rows)}
    if rank == 0:
        out["fit"] = _fit(rows, mesh_shape, prof_dir)
    dist.barrier(group=host)
    os.environ["REPRO_TORCH_NETPROFILE_DIR"] = prof_dir
    out["auto"] = _resnet_auto_plan(mesh)
    out["seconds"] = time.perf_counter() - t0
    say(f"[sim] {len(rows)} fit rows on {mesh.size} ranks: " + json.dumps(out.get("fit"))
        + f"; auto at data {mesh.shape['data']}: " + json.dumps(out["auto"])
        + f"; {out['seconds']:.1f} s")
    return out


def phase_reducers(backend: str = "gloo", spawned=None) -> dict:
    """Four rank processes: the ring, compressed and compressed_ring
    reducers under GradSync at full ResNet-50/CIFAR width.  With gloo (as
    ``main`` runs it) all four share the one card and their communicators
    stage through pinned host memory; ``backend="nccl"`` needs four cards,
    one a rank.
    ``spawned``: its turn of ``spawn_turns`` (the rank files and the
    turn's seconds), as ``main`` runs it; else a spawn of its own."""
    ranks, wall = spawned or spawn_ranks(_reducers_rank, (backend,), RING)
    for r, res in enumerate(ranks):
        if {k: v["launches"] for k, v in res["runs"].items()} != \
                {k: v["launches"] for k, v in ranks[0]["runs"].items()}:
            raise AssertionError(f"rank {r} launched other counts than rank 0")
    res = ranks[0]
    res["wall_s"] = wall
    log(f"[clock] sim share of the reducers spawn: {res['sim']['seconds']:.1f} s")
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
    comms = dep.pod_comms([0, 1], pods, data,
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
    comm = dep.pod_comms([0], pods, data, torch.device("cuda"))[0]
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
    comm = dep.pod_comms([0], pods, data, torch.device("cuda"))[0]
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
            comm = ts.gradsync.groups[0].pod
            with_kernels = hierarchical_allreduce(inp.clone(), comm, use_ring=True)
            same_bits(with_kernels, _plain_hier(inp.clone(), comm),
                      f"hierarchical_ring of bucket {bucket.bucket_id}: kernels vs plain")
            comm.ring.check()
            out["captured_bucket"] = {"bucket": bucket.bucket_id, "elements": inp.numel()}
        say(f"[hierarchical] {run}: launches {launches} and stream waits {memops} "
            f"(= predictions), params "
            f"bit-identical on the {RING} ranks after each of {REDUCER_STEPS} steps; "
            f"first step {trainer.first_step_time * 1e3:.1f} ms, then "
            f"{[round(t * 1e3, 1) for t in trainer.step_times]} ms")
        ts.close()
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


def phase_hierarchical(backend: str = "gloo", spawned=None) -> dict:
    """Four rank processes: the peer-ring kernels and the hierarchical
    reducers under GradSync at full ResNet-50/CIFAR width, on pod 2 x
    data 2 and pod 1 x data 4.  With gloo (as ``main`` runs it) all four
    share the one card; ``backend="nccl"`` needs four cards, one a rank,
    and the intra-pod rings then cross NVLink.
    ``spawned``: its turn of ``spawn_turns`` (the rank files and the
    turn's seconds), as ``main`` runs it; else a spawn of its own."""
    ranks, wall = spawned or spawn_ranks(_hier_rank, (backend,), RING)
    for r, res in enumerate(ranks):
        if {k: v["launches"] for k, v in res["runs"].items()} != \
                {k: v["launches"] for k, v in ranks[0]["runs"].items()}:
            raise AssertionError(f"rank {r} launched other counts than rank 0")
    res = ranks[0]
    res["wall_s"] = wall
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
                  "continuous": (1, 512, 16, 8, 128),
                  # a rank's heads in the static prefill of lm_tp's serving
                  # (model 4) and of lm_fsdp's (model 2)
                  "static_tp4": (4, 493, 4, 2, 128),
                  "static_tp2": (4, 493, 8, 4, 128)}
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


def device_ms_per_launch(fn, kernel_name: str, reps: int = 50) -> float | None:
    """The device time per call of ``fn`` of the kernels named
    ``kernel_name`` (a whole word of the profiler's name, so that
    ``pack_bucket_kernel`` does not count ``unpack_bucket_kernel``), from
    torch.profiler.  A profiled loop in which the profiler saw no device
    time of those kernels is tried once more; then None: not measured."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    word = re.compile(rf"(?<![A-Za-z0-9_]){kernel_name}(?![A-Za-z0-9_])")
    for attempt in (1, 2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages()
                if getattr(e, "device_type", None) == DeviceType.CUDA and word.search(e.key)]
        total = sum(_device_ms(e, self_only=True) for e in seen)
        if total > 0:
            return total / reps
        log(f"[profiler] no {kernel_name} device time in a profiled loop (attempt {attempt})")
    return None


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
    for attempt in (1, 2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if getattr(e, "device_type", None) == DeviceType.CUDA and word.search(e.key)]
        if kernels:
            break
        log(f"[profiler] no {kernel_name} event in a profiled loop (attempt {attempt})")
    events_ms = start.elapsed_time(end)
    if not kernels:
        # the profiler saw no device time: CUDA events alone, device time not measured
        return dict(device_ms_per_launch=None, events_ms_per_launch=events_ms / reps,
                    span_over_events=None, device_events_per_call=0)
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
    the decode loop's time on the device's clock with no extra sync; and
    around each prefill (``prefill_ms``)."""

    def __init__(self, server):
        self.server, self.api, self.loops, self.prefills = server, server.api, [], []

        def prefill(*a, **kw):
            self.loops.append([torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True), 0])
            span = [torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)]
            span[0].record()
            out = self.api.prefill(*a, **kw)
            span[1].record()
            self.prefills.append(span)
            return out

        def decode_step(*a, **kw):
            loop = self.loops[-1]
            if loop[2] == 0:
                loop[0].record()
            out = self.api.decode_step(*a, **kw)
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

    def prefill_ms(self) -> list:
        """ms of each prefill (CUDA events; after ``close``)."""
        return [a.elapsed_time(b) for a, b in self.prefills]


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
    return {"launches": launches, "f32_launches": f32_launches, "report": report,
            "static_tokens": [t.tolist() for t in static_out]}


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


def phase_moe_serve() -> dict:
    """granite-moe-1b-a400m at full width (bf16, seeded weights, use_flash:
    row 8 at head_dim 64) through the static engine with the prompts and
    lengths of Qwen3's static run (8 requests of 384-512 tokens, 32 new,
    batches of 4): greedy tokens (int32, in the vocab), each prefill's ms
    by CUDA events, decode ms a step (``DecodeLoopTimer``), flash launches
    exactly 24 x 2 prefills; row 8 held against its plain version on the
    q/k/v the first prefill feeds to layer 0."""
    import numpy as np

    from repro_torch.configs.granite_moe_1b_a400m import make_config
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.runtime import RequestQueue, Server

    cfg = make_config(use_flash=True)
    params = tf.init_params(cfg, seed=0, device="cuda")
    server = Server(cfg, make_smoke_mesh(1, 1), params, max_len=SERVE_MAX_LEN)
    prompts = serve_prompts(cfg.vocab)
    attention, captured, calls = tf.attn_lib.attention, {}, [0]

    def capture(q, k, v, **kw):
        if calls[0] == 0:
            captured[0] = (q.clone(), k.clone(), v.clone())
        calls[0] += 1
        return attention(q, k, v, **kw)

    timer = DecodeLoopTimer(server)
    api, prefills = server.api, []

    def timed_prefill(*a, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = api.prefill(*a, **kw)
        end.record()
        prefills.append((start, end, tuple(a[1].shape)))
        return out

    server.api = dataclasses.replace(api, prefill=timed_prefill)
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
        out = _results(handles, "moe static")
        wall_s = time.perf_counter() - t0
    finally:
        tf.attn_lib.attention = attention
    decode_ms = timer.close(SERVE_MAX_NEW - 1)
    launches = flash.FLASH_LAUNCHES
    if launches != cfg.n_self * 2:
        raise AssertionError(f"moe serve: {launches} flash launches, expected "
                             f"{cfg.n_self} x 2 prefills")
    toks = np.stack(out)
    if toks.dtype != np.int32 or toks.min() < 0 or toks.max() >= cfg.vocab:
        raise AssertionError(f"moe serve: tokens {toks.dtype} in [{toks.min()}, {toks.max()}]")
    q, k, v = captured[0]
    err = check_flash(q, k, v, True, f"moe serve layer 0 {tuple(q.shape)}")
    res = {"tokens": toks[:, :8].tolist(), "wall_s": wall_s, "decode_ms_per_step": decode_ms,
           "prefill_ms": [s.elapsed_time(e) for s, e, _ in prefills],
           "prefill_shapes": [shp for _, _, shp in prefills],
           "tokens_per_s": len(prompts) * SERVE_MAX_NEW / wall_s,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "flash_launches": launches,
           "head_dim": cfg.hd, "flash_layer0_max_abs_err": err}
    log("[moe_serve] " + json.dumps(res))
    del server, params
    gc.collect()
    torch.cuda.empty_cache()
    return res


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
    (4, 512, 16, 64, 32, torch.bfloat16),   # a rank's prefill layer at model 4
    (4, 1, 16, 64, 32, torch.bfloat16),     # and its decode step
)
WKV_SEQ_TIMED = {"prefill": WKV_SEQ_SHAPES[0], "decode": WKV_SEQ_SHAPES[4],
                 "prefill_tp4": WKV_SEQ_SHAPES[6], "decode_tp4": WKV_SEQ_SHAPES[7]}
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

    def forced(p, x, cfg, state=None, lasts=None, out=None, **kw):
        # both on the same input state, each to a new one; then into ``out``
        got = block(p, x, cfg, state, lasts, **kw)
        with plain_wkv():
            want = block(p, x, cfg, state, lasts, **kw)
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


# ------------------------------------- cross-attention and RWKV-6 training

RWKV_TRAIN_LAYERS = 8
VISION_GATE = 0.5              # gate_attn's mean once perturbed (0 at init, as the reference)
XR_CPU_GPU_TOL = (1e-5, 1e-4)  # the cpu_vs_gpu phases: loss rtol; grads' max diff / leaf absmax
VISION_SERVE_PROMPTS = 4       # one image each, 384-512 tokens
VISION_SERVE_STEPS = 32        # greedy decode steps after the prefill


def vision_config(strategy: str = "funnel", **over):
    """llama-3.2-vision-11b at full width (d 4096, 32/8 heads of 128, ff
    14336, vocab 128,256, bf16) cut to its ``layer_pair`` depth of 10
    layers (two groups of 4 self blocks and a cross block), depcha's
    in-backward sync on exactly under the strategies that use it."""
    from repro_torch.configs.llama_3_2_vision_11b import ARCH, make_config
    from repro_torch.core import get_strategy

    over.setdefault("n_layers", ARCH.layer_pair[1])
    return make_config(depcha_in_scan=get_strategy(strategy).uses_in_scan, **over)


def perturb_gates(params: dict, seed: int = 1) -> dict:
    """``gate_attn`` from N(VISION_GATE, 0.1), in place: at its zero init
    the cross blocks add nothing to the loss and their projections get no
    gradient."""
    g = params["cross_blocks"]["gate_attn"]
    gen = torch.Generator(device=g.device).manual_seed(seed)
    noise = torch.randn(g.shape, generator=gen, device=g.device)
    g.copy_((VISION_GATE + 0.1 * noise).to(g.dtype))
    return params


def vision_model(cfg):
    from repro_torch.models.transformer import Transformer, init_params

    return Transformer(cfg, perturb_gates(init_params(cfg, seed=0, device=torch.device("cuda"))))


def vision_pipe(cfg, mesh=None, seq: int = LM_SEQ, batch: int = LM_BATCH, device="cuda"):
    """The token pipeline with the arch's extra input, ``img_embeds`` (B,
    576, d), drawn after the tokens as the reference draws it."""
    import numpy as np

    from repro_torch.configs.llama_3_2_vision_11b import ARCH
    from repro_torch.data import TokenPipeline

    extras = {name: (tuple(fn(cfg, seq)), np.float32) for name, fn, _ in ARCH.extra_inputs}
    return TokenPipeline(cfg.vocab, seq, batch, seed=0, mesh=mesh, extra_specs=extras,
                         device=device)


def rwkv_train_config(strategy: str = "funnel", **over):
    """RWKV-6 7B at full width (d 4096, 64 heads of 64, ff 14336, vocab
    65,536, bf16, chunk 32) cut to ``RWKV_TRAIN_LAYERS`` layers."""
    from repro_torch.configs.rwkv6_7b import make_config
    from repro_torch.core import get_strategy

    over.setdefault("n_layers", RWKV_TRAIN_LAYERS)
    return make_config(depcha_in_scan=get_strategy(strategy).uses_in_scan, **over)


def rwkv_model(cfg):
    from repro_torch.models import rwkv

    return rwkv.RWKV(cfg, rwkv.perturb_constant_leaves(
        rwkv.init_params(cfg, seed=0, device=torch.device("cuda"))))


def strategy_runs(tag: str, make_cfg, make_model, pipe, mesh, after=None) -> dict:
    """``lm_run`` under funnel, concom and depcha from the same seeded
    weights, under torch.use_deterministic_algorithms (restored after):
    losses finite, bit-identical across the strategies (the nondeterministic
    ops the run met are named in the failure) and the peak under 80 GB.
    ``after(strat)`` gives each run's ``after`` hook."""
    import warnings

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for strat in STRATEGIES:
                runs[strat] = lm_run(strat, mesh, pipe, cfg=make_cfg(strat),
                                     make_model=make_model,
                                     after=after(strat) if after is not None else None)
                log(f"[{tag}] {strat}: " + json.dumps(
                    {k: v for k, v in runs[strat].items() if k != "after"}))
        finally:
            torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    nondeterministic = sorted({str(w.message)[:200] for w in caught
                               if "deterministic" in str(w.message)})
    base = runs[STRATEGIES[0]]["losses"]
    for strat, r in runs.items():
        if not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"{tag} {strat}: non-finite loss {r['losses']}")
        if r["peak_gb"] >= 80:
            raise AssertionError(f"{tag} {strat}: peak {r['peak_gb']} GB")
        if r["losses"] != base:
            raise AssertionError(f"{tag} {strat} losses {r['losses']} are not bit-identical "
                                 f"to {STRATEGIES[0]}'s {base} (nondeterministic ops: "
                                 f"{nondeterministic})")
    return {"runs": runs, "nondeterministic_ops": nondeterministic,
            "launches": {k: sum(r["launches"][k] for r in runs.values())
                         for k in ("pack", "unpack")}}


def phase_vision_train() -> dict:
    """llama-3.2-vision-11b at full width cut to 10 layers (8 self, 2
    cross: the reference's layer_pair depth) on a one-rank NCCL group,
    seq 1024 x global batch 4 with ``img_embeds`` (4, 576, 4096) from the
    pipeline, ``gate_attn`` perturbed from its zero init, AdamW, clip 1.0,
    remat dots, TF32 off: ``strategy_runs`` (losses bit-identical across
    funnel, concom and depcha; pack/unpack launches exactly the schedule's
    buckets plus depcha's slots a step; 10 in-backward collectives a
    depcha step: one a layer of each stack), then one more depcha step
    with CUDA events at its stages."""
    from repro_torch.launch.mesh import make_dp_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.utils.trees import tree_leaves

    mesh = make_dp_mesh()
    cfg = vision_config()
    n_params = sum(p.numel() for p in tree_leaves(init_params(cfg, device="meta")))
    log(f"[vision_train] {cfg.name}: {cfg.n_layers} layers ({cfg.n_self} self, "
        f"{cfg.n_cross} cross), {n_params} params, {cfg.dtype}")
    pipe = vision_pipe(cfg, mesh)

    def after(strat):
        if strat != "depcha":
            return None
        return lambda ts, model, opt_state, run: {
            "stages": lm_stage_spans(ts, model, opt_state, pipe)}

    out = strategy_runs("vision_train", vision_config, vision_model, pipe, mesh, after)
    out["stages"] = out["runs"]["depcha"].pop("after")["stages"]
    want = cfg.n_self + cfg.n_cross
    got = out["runs"]["depcha"]["in_backward_collectives_per_step"]
    if got != [want] * LM_STEPS:
        raise AssertionError(f"vision_train depcha: in-backward collectives {got}, "
                             f"expected {want} a step")
    out.update(params=n_params, shape={"seq": LM_SEQ, "global_batch": LM_BATCH,
                                       "layers": cfg.n_layers, "self": cfg.n_self,
                                       "cross": cfg.n_cross, "img_tokens": 576})
    log("[vision_train] " + json.dumps({k: v for k, v in out.items() if k != "runs"}))
    return out


def rwkv_chunk_states_check() -> dict:
    """The WKV kernel's chunk-state output (training's forward) at RWKV-6
    7B's training layer (B 4, S 1024, H 64, N 64, chunk 32, bf16) against
    the plain version's, one launch into a buffer started as NaN, y and
    the final state as without it; then its time with and without the
    output (CUDA events, in turns) beside the plain version's and the
    bound, whose bytes now hold the chunk states written once."""
    from repro_torch.kernels.rwkv6 import kernel, ref

    B, S, H, N, C = 4, LM_SEQ, 64, 64, 32
    ins = wkv_seq_inputs(B, S, H, N, torch.bfloat16, seed=9)
    T = S // C
    states = torch.full((T, B, H, N, N), float("nan"), device="cuda")
    before = kernel.WKV_LAUNCHES
    y, s1 = kernel.wkv_sequence_kernel(*ins, C, states=states)
    launched = kernel.WKV_LAUNCHES - before
    want = torch.empty_like(states)
    y_want, s_want = ref.wkv_sequence_ref(*ins, C, states=want)
    y0, s0 = kernel.wkv_sequence_kernel(*ins, C)
    torch.cuda.synchronize()
    err = (states - want).abs().max().item()
    if launched != 1 or not torch.allclose(states, want, atol=5e-4, rtol=5e-4):
        raise AssertionError(f"wkv chunk states: {launched} launches, max abs err {err}")
    if not (torch.equal(y, y0) and torch.equal(s1, s0)):
        raise AssertionError("wkv chunk states: y or the final state moved with the output")
    times = cuda_ms_in_turns({
        "with_states": lambda: kernel.wkv_sequence_kernel(*ins, C, states=states),
        "without": lambda: kernel.wkv_sequence_kernel(*ins, C)})
    plain_ms = cuda_ms(lambda: ref.wkv_sequence_ref(*ins, C, states=want), reps=3, warmup=1)
    bound = wkv_seq_bound(*ins, C)
    nbytes = bound["bytes"] + states.numel() * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = {"shape": f"B{B} S{S} H{H} N{N} chunk {C} bfloat16", "chunks": T,
           "max_abs_err": err, "ms": sum(times["with_states"]) / 2,
           "ms_without_states": sum(times["without"]) / 2, "turns": times,
           "plain_ms": plain_ms, "bound_ms": max(bytes_ms, bound["operations_ms"]),
           "bound_by": "bytes" if bytes_ms >= bound["operations_ms"] else "operations",
           "bytes": nbytes, "flops": bound["flops"], "library_ms": None}
    log("[rwkv_train] chunk states: " + json.dumps(out))
    return out


def phase_rwkv_train() -> dict:
    """RWKV-6 7B at full width cut to 8 layers on a one-rank NCCL group,
    constant leaves perturbed as rwkv_serve's, seq 1024 x batch 4, AdamW,
    clip 1.0, remat dots, TF32 off: ``strategy_runs`` (losses
    bit-identical across funnel, concom and depcha; pack/unpack launches
    exactly the schedule's buckets plus depcha's slots a step; 16
    in-backward collectives a depcha step: the bf16 and the f32 (w0, u)
    slot of each layer).  The WKV kernel launches exactly 2 x 8 times a
    step: each layer's forward and the remat's recompute of it (the
    backward is tensor code, ``ops.wkv_sequence_backward``).  Before the
    runs, ``rwkv_chunk_states_check``."""
    from repro_torch.kernels.rwkv6 import kernel as wkv
    from repro_torch.launch.mesh import make_dp_mesh
    from repro_torch.data import TokenPipeline
    from repro_torch.models import rwkv
    from repro_torch.utils.trees import tree_leaves

    states = rwkv_chunk_states_check()
    mesh = make_dp_mesh()
    cfg = rwkv_train_config()
    n_params = sum(p.numel() for p in tree_leaves(rwkv.init_params(cfg, device="meta")))
    log(f"[rwkv_train] {cfg.name}: {cfg.n_layers} layers, {n_params} params, {cfg.dtype}, "
        f"chunk {cfg.chunk}, remat {cfg.remat}")
    pipe = TokenPipeline(cfg.vocab, LM_SEQ, LM_BATCH, seed=0, mesh=mesh, device="cuda")
    per_step = 2 * cfg.n_layers if cfg.remat != "none" else cfg.n_layers

    def after(strat):
        def hook(ts, model, opt_state, run):
            res = {"wkv_launches": wkv.WKV_LAUNCHES}
            if strat == "depcha":
                res["stages"] = lm_stage_spans(ts, model, opt_state, pipe)
            return res
        wkv.WKV_LAUNCHES = 0
        return hook

    out = strategy_runs("rwkv_train", rwkv_train_config, rwkv_model, pipe, mesh, after)
    launches = {}
    for strat, r in out["runs"].items():
        res = r.pop("after")
        launches[strat] = res["wkv_launches"]
        if "stages" in res:
            out["stages"] = res["stages"]
    if launches != {s: per_step * LM_STEPS for s in STRATEGIES}:
        raise AssertionError(f"rwkv_train: WKV launches {launches}, expected {per_step} a "
                             f"step x {LM_STEPS}")
    want = 2 * cfg.n_layers                    # a bf16 and an f32 slot a layer
    got = out["runs"]["depcha"]["in_backward_collectives_per_step"]
    if got != [want] * LM_STEPS:
        raise AssertionError(f"rwkv_train depcha: in-backward collectives {got}, "
                             f"expected {want} a step")
    out.update(params=n_params, chunk_states=states, wkv_launches=launches,
               wkv_launches_per_step=per_step,
               shape={"seq": LM_SEQ, "global_batch": LM_BATCH, "layers": cfg.n_layers})
    log("[rwkv_train] " + json.dumps({k: v for k, v in out.items() if k != "runs"}))
    return out


def _rwkv_tp_rank(rank: int, workdir: str, backend: str, n_layers: int) -> None:
    """One rank of ``phase_rwkv_tp``: RWKV-6 7B at full width, ``n_layers``
    layers, on data 1 x model ``LM_TP`` (seq 1024 x global batch 4, AdamW,
    clip 1.0, remat dots, bf16), each of funnel, concom and depcha from
    the same weights: the global tree drawn on every rank, its constant
    leaves perturbed as rwkv_serve's, then cut to the rank's shards, so
    the model is the tp = 1 model of the same seed.  1 warm-up + 2 timed
    steps; the replicated leaves bit-identical across the ranks after
    every run; the WKV kernel's launches a step (2 a layer) and the first
    loss equal across the strategies.  Results to ``workdir/rank<r>.json``."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core import GradSyncConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.rwkv6 import kernel as wkv
    from repro_torch.launch.mesh import init_dist, make_mesh
    from repro_torch.models import rwkv
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.parallel.sharding import flat_spec_axes, shard_tree
    from repro_torch.runtime import Trainer, make_train_step
    from repro_torch.utils.trees import flatten_with_names, tree_map_with_names

    init_dist("cuda", backend=backend, init_method=f"file://{workdir}/store", rank=rank,
              world_size=LM_TP, timeout=datetime.timedelta(seconds=600))
    torch.backends.cuda.matmul.allow_tf32 = False
    say = log if rank == 0 else (lambda _m: None)
    host = dist.new_group(backend="gloo")
    mesh = make_mesh(LM_TP)
    out = {"runs": {}}
    for strat in STRATEGIES:
        cfg = rwkv_train_config(strat, n_layers=n_layers, tp=LM_TP)
        full = rwkv.perturb_constant_leaves(rwkv.init_params(
            dataclasses.replace(cfg, tp=1), seed=0, device="cuda"))
        local = shard_tree(full, rwkv.param_specs(full, cfg), mesh, rank)
        model = rwkv.RWKV(cfg, tree_map_with_names(lambda _n, t: t.contiguous().clone(), local))
        del full, local
        pipe = TokenPipeline(cfg.vocab, LM_SEQ, LM_BATCH, seed=0, mesh=mesh, rank=rank,
                             device="cuda")
        opt = adamw(cosine_warmup(3e-4, 10, 100))
        ts = make_train_step(cfg, mesh, GradSyncConfig(strategy=strat), opt, model=model,
                             clip_norm=1.0, device="cuda")
        named = flatten_with_names(model.params_tree())[0]
        opt_state = opt.init(dict(named))
        trainer = Trainer(ts, pipe, log_every=10 ** 9, printer=lambda _m: None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wkv.WKV_LAUNCHES = 0
        losses, norms = [], []
        for step in range(LM_STEPS):
            model, opt_state, hist = trainer.run(model, opt_state, step + 1, start_step=step)
            losses.append(hist["losses"][-1])
            norms.append(hist["metrics"]["grad_norm"])
        if wkv.WKV_LAUNCHES != 2 * cfg.n_layers * LM_STEPS:
            raise AssertionError(f"rwkv_tp {strat}: {wkv.WKV_LAUNCHES} WKV launches, "
                                 f"expected {2 * cfg.n_layers} a step x {LM_STEPS}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"rwkv_tp {strat}: non-finite loss {losses}")
        specs = dict(flatten_with_names(rwkv.param_specs(model.params_tree(), cfg))[0])
        rep = [p for n, p in named if not flat_spec_axes(specs[n])]
        _same_on_every_rank(rep, f"rwkv_tp {strat} replicated leaves", host)
        times = trainer.step_times
        run = {"losses": losses, "grad_norms": norms,
               "params_per_rank": sum(p.numel() for _, p in named),
               "first_step_ms": trainer.first_step_time * 1e3,
               "step_ms": [t * 1e3 for t in times],
               "tokens_per_s": [pipe.global_batch * LM_SEQ / t for t in times],
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "wkv_launches": wkv.WKV_LAUNCHES,
               "in_backward_collectives": (ts.layer_sync.collectives
                                           if ts.layer_sync is not None else 0),
               "slots_per_step": sync_slots(ts.layer_sync)}
        if strat == "depcha":
            run["stages"] = lm_stage_spans(ts, model, opt_state, pipe)
        out["runs"][strat] = run
        say(f"[rwkv_tp] {strat}: " + json.dumps(run))
        ts.close()
        del ts, model, opt_state, trainer, named, rep
        gc.collect()
        torch.cuda.empty_cache()
    first = {s: r["losses"][0] for s, r in out["runs"].items()}
    if len(set(first.values())) != 1:
        raise AssertionError(f"rwkv_tp: first losses differ across the strategies {first}")
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def phase_rwkv_tp(backend: str = "nccl", n_layers: int = 32) -> dict:
    """By hand on a host of four cards: RWKV-6 7B at full width and depth
    on data 1 x model ``LM_TP`` over NCCL, one rank a card
    (``_rwkv_tp_rank``): ``cs.phase_build(); cs.phase_rwkv_tp()``."""
    import tempfile

    import torch.multiprocessing as mp

    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    log(f"[rwkv_tp] {backend} on {cards}, {n_layers} layers, data 1 x model {LM_TP}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="rwkv-tp-") as wd:
        mp.spawn(_rwkv_tp_rank, args=(wd, backend, n_layers), nprocs=LM_TP, join=True)
        with open(os.path.join(wd, "rank0.json")) as f:
            res = json.load(f)
    res.update(wall_s=time.perf_counter() - t0, cards=cards, layers=n_layers)
    log("[rwkv_tp] " + json.dumps({k: v for k, v in res.items() if k != "runs"}))
    return res


def _phases_rank(rank: int, workdir: str, names: tuple) -> None:
    """``phases_in_own_process``'s process: a one-rank NCCL group, then
    ``phase_<name>()`` of each name in turn; results to
    ``workdir/phases.json``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_dist

    init_dist("cuda", init_method=f"file://{workdir}/store", rank=rank, world_size=1)
    out = {}
    try:
        for name in names:
            t0 = time.perf_counter()
            out[name] = globals()[f"phase_{name}"]()
            gc.collect()
            torch.cuda.empty_cache()
            log(f"[clock] {name}: {time.perf_counter() - t0:.1f} s in its process")
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, "phases.json"), "w") as f:
        json.dump(out, f)


def phases_in_own_process(*names: str) -> dict:
    """``phase_<name>()`` of each name in turn, in one process of its own
    (a one-rank NCCL group): name → result.  A training phase that peaks
    near the card's 80 GB runs there, before the others, so that nothing
    the main process caches stands beside it."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="phases-") as wd:
        mp.spawn(_phases_rank, args=(wd, names), nprocs=1, join=True)
        with open(os.path.join(wd, "phases.json")) as f:
            return json.load(f)


def phase_xr_train() -> dict:
    """The cross-attention, RWKV and Zamba2 training phases in one process
    of their own, before the others: vision_train's 10 layers peak at
    68.9 GB (on an NVIDIA H100 80GB HBM3 at 700.00 W), more than is left
    beside the one-rank section's cached memory; zamba2_train at
    ``ZAMBA2_TRAIN_LAYERS`` peaks at 23 GB after it."""
    return phases_in_own_process("vision_train", "vision_cpu_vs_gpu", "rwkv_train",
                                 "rwkv_train_cpu_vs_gpu", "zamba2_train",
                                 "zamba2_train_cpu_vs_gpu")


def _cpu_vs_gpu(tag: str, cfg, params, batch_at, launches_fn=None,
                tol=XR_CPU_GPU_TOL) -> dict:
    """One forward and backward of ``cfg``'s model from the same weights
    and batch on the CPU (plain versions) and on the card (kernels), TF32
    off: the loss within rtol ``tol[0]``, every gradient within ``tol[1]``
    of its leaf's largest.  ``launches_fn()`` reads a launch counter,
    which must not move on the CPU."""
    from repro_torch.models.registry import family_of
    from repro_torch.utils.trees import flatten_with_names

    torch.backends.cuda.matmul.allow_tf32 = False
    module = family_of(cfg).module
    got, launched = {}, {}
    for device in ("cpu", "cuda"):
        model = module(cfg, tree_to(copy.deepcopy(params), device))
        before = launches_fn() if launches_fn else 0
        loss = model(batch_at(device))
        loss.backward()
        torch.cuda.synchronize()
        launched[device] = (launches_fn() - before) if launches_fn else 0
        got[device] = (loss.item(), {n: p.grad.detach().cpu() for n, p in
                                     flatten_with_names(model.params_tree())[0]})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = got["cpu"], got["cuda"]
    worst = max(((g_gpu[n] - g).abs().max() / (g.abs().max() + 1e-12)).item()
                for n, g in g_cpu.items())
    res = {"loss_cpu": l_cpu, "loss_gpu": l_gpu, "grad_rel": worst, "launches": launched}
    if abs(l_gpu - l_cpu) > tol[0] * abs(l_cpu) or worst > tol[1] or launched["cpu"]:
        raise AssertionError(f"{tag}: {res} beyond {tol}")
    log(f"[{tag}] {cfg.name} (loss rtol, grad rel) {tol}: " + json.dumps(res))
    return res


def phase_vision_cpu_vs_gpu() -> dict:
    """The vision smoke config (5 layers: 4 self, 1 cross; f32), its gate
    set to 0.5, seq 64 x batch 2 with the arch's image embeddings:
    ``_cpu_vs_gpu``."""
    from repro_torch.configs.llama_3_2_vision_11b import make_smoke
    from repro_torch.models.transformer import init_params

    cfg = make_smoke()
    params = init_params(cfg, seed=0, device="cpu")
    params["cross_blocks"]["gate_attn"].fill_(VISION_GATE)
    return _cpu_vs_gpu("vision_cpu_vs_gpu", cfg, params,
                       lambda dev: vision_pipe(cfg, seq=64, batch=2, device=dev).batch_at(0))


def phase_rwkv_train_cpu_vs_gpu() -> dict:
    """The rwkv smoke config (2 layers, f32, chunk 16), constant leaves
    perturbed, seq 40 x batch 2 (a ragged last chunk): ``_cpu_vs_gpu``,
    the card's WKV launches exactly 2 a layer (forward and the remat's
    recompute), the CPU's backward in float64 against the card's in f32."""
    from repro_torch.configs.rwkv6_7b import make_smoke
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.rwkv6 import kernel as wkv
    from repro_torch.models import rwkv

    cfg = make_smoke()
    params = rwkv.perturb_constant_leaves(rwkv.init_params(cfg, seed=0, device="cpu"))
    res = _cpu_vs_gpu("rwkv_train_cpu_vs_gpu", cfg, params,
                      lambda dev: TokenPipeline(cfg.vocab, 40, 2, seed=0,
                                                device=dev).batch_at(0),
                      lambda: wkv.WKV_LAUNCHES)
    if res["launches"]["cuda"] != 2 * cfg.n_layers:
        raise AssertionError(f"rwkv_train_cpu_vs_gpu: {res['launches']['cuda']} WKV "
                             f"launches on the card, expected {2 * cfg.n_layers}")
    return res


def phase_vision_serve(smi: str) -> dict:
    """llama-3.2-vision-11b at full width and depth (40 layers: 32 self, 8
    cross; bf16, use_flash), seeded weights with ``gate_attn`` perturbed:
    4 prompts of 384-512 tokens (left-padded to the longest), one seeded
    image each (4, 576, 4096), through ``prefill`` and then 32 greedy
    ``decode_step``s with the images (the engines take none, as the
    reference's).  The flash kernel must launch exactly 32 times in the
    prefill (the self blocks; a cross block is non-causal over the image
    and takes the chunked path) and never in decode; the flash kernel held
    to its plain version on the q/k/v the prefill fed to self layers 0 and
    31; logits finite; the image must move the logits (the gates are
    open).  Prefill ms (CUDA events, after a warm-up prefill) and decode
    ms a step (CUDA events over the 32 steps)."""
    from repro_torch.configs.llama_3_2_vision_11b import make_config
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.models import transformer as tf
    from repro_torch.utils.trees import flatten_with_names

    cfg = make_config(use_flash=True)
    t0 = time.perf_counter()
    params = perturb_gates(tf.init_params(cfg, seed=0, device="cuda"))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for _, p in flatten_with_names(params)[0])
    log(f"[vision_serve] {cfg.name}: {n_params} params ({cfg.n_self} self, {cfg.n_cross} "
        f"cross layers), {cfg.dtype}, use_flash, init on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = serve_prompts(cfg.vocab)[:VISION_SERVE_PROMPTS]
    toks = left_pad(prompts).cuda()
    B, S = toks.shape
    gen = torch.Generator(device="cuda").manual_seed(2)
    img = torch.randn((B, 576, cfg.d_model), generator=gen, device="cuda").to(cfg.dtype)

    attention = tf.attn_lib.attention
    captured, calls = {}, [0]

    def capture(q, k, v, **kw):       # a hook of this script: the prefill's flash inputs
        if kw.get("use_flash") and calls[0] in (0, cfg.n_self - 1):
            captured[calls[0]] = (q.clone(), k.clone(), v.clone())
        calls[0] += bool(kw.get("use_flash"))
        return attention(q, k, v, **kw)

    torch.cuda.reset_peak_memory_stats()
    tf.attn_lib.attention = capture
    try:
        before = flash.FLASH_LAUNCHES
        logits, cache = tf.prefill(params, toks, cfg, img_embeds=img)
        torch.cuda.synchronize()
        prefill_launches = flash.FLASH_LAUNCHES - before
    finally:
        tf.attn_lib.attention = attention
    if prefill_launches != cfg.n_self or sorted(captured) != [0, cfg.n_self - 1]:
        raise AssertionError(f"vision prefill: {prefill_launches} flash launches, expected "
                             f"{cfg.n_self}; captured layers {sorted(captured)}")
    errs = {li: check_flash(q, k, v, True, f"vision serve layer {li} {tuple(q.shape)}")
            for li, (q, k, v) in sorted(captured.items())}
    del captured
    no_img, _ = tf.prefill(params, toks, cfg, img_embeds=torch.zeros_like(img))
    img_moves = (logits.float() - no_img.float()).abs().max().item()
    if not torch.isfinite(logits).all() or img_moves == 0.0:
        raise AssertionError(f"vision prefill: finite {bool(torch.isfinite(logits).all())}, "
                             f"the image moves the logits by {img_moves}")
    del no_img
    prefill_ms = cuda_ms(lambda: tf.prefill(params, toks, cfg, img_embeds=img), reps=3,
                         warmup=1)
    cache = {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, VISION_SERVE_STEPS))
             for n, c in cache.items()}
    tok = torch.argmax(logits.float(), dim=-1)
    out = [tok]
    before = flash.FLASH_LAUNCHES
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for step in range(VISION_SERVE_STEPS):
        step_logits, cache = tf.decode_step(params, cache, tok, S + step, cfg, img_embeds=img)
        tok = torch.argmax(step_logits.float(), dim=-1)
        out.append(tok)
    end.record()
    torch.cuda.synchronize()
    decode_ms = start.elapsed_time(end) / VISION_SERVE_STEPS
    tokens = torch.stack(out, 1).cpu()
    if (flash.FLASH_LAUNCHES != before or not torch.isfinite(step_logits).all()
            or tokens.min() < 0 or tokens.max() >= cfg.vocab):
        raise AssertionError(f"vision decode: {flash.FLASH_LAUNCHES - before} flash launches, "
                             f"finite {bool(torch.isfinite(step_logits).all())}")
    report = {"card": smi, "model": cfg.name, "params": n_params,
              "prompt_lens": [len(p) for p in prompts], "padded_to": S, "img_tokens": 576,
              "decode_steps": VISION_SERVE_STEPS, "prefill_ms_B4": prefill_ms,
              "decode_ms_per_step": decode_ms, "flash_launches_per_prefill": prefill_launches,
              "flash_layer_max_abs_err": errs, "image_moves_logits_by": img_moves,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "tokens": tokens[:, :8].tolist()}
    log("[vision_serve] " + json.dumps(report))
    return {"launches": prefill_launches, "per_prefill": cfg.n_self, "report": report}


# ------------------------------------------------ the Zamba2 hybrid (Mamba-2)

ZAMBA2_SERVE_PROMPTS = 4       # 384-512 tokens each
ZAMBA2_HANDOFF_TOL = 2e-3      # tests/test_serve_families.py's atol = rtol
# zamba2_cpu_vs_gpu, training: loss rtol; grads' max diff / leaf absmax.  A
# Mamba block's f32 gradients are ill-conditioned: on the CPU the reference's
# own f32 gradients sit up to 4.3e-5 of a leaf's largest from its float64 run
# at the smoke config (tests/test_torch_ssm.py)
ZAMBA2_CPU_GPU_TOL = (1e-5, 5e-4)
ZAMBA2_RING = (37, 16, 20)     # zamba2_cpu_vs_gpu, serving: prompt, window, decode steps
# zamba2_train's depth: three of the 9 groups, 2 of the 8 sites.  All 54
# layers took 81-96 s of the script in their process (PERF.md §4)
ZAMBA2_TRAIN_LAYERS = 18


def zamba2_config(strategy: str = "funnel", **over):
    """zamba2-2.7b at full width (d 2560, 80 SSM heads of 64, state 64,
    chunk 64; the shared block's 32 heads of 80 and ff 10,240 after every
    6th layer; vocab 32,000; bf16) cut to ``ZAMBA2_TRAIN_LAYERS`` layers,
    depcha's in-backward sync on exactly under the strategies that use
    it."""
    from repro_torch.configs.zamba2_2_7b import make_config
    from repro_torch.core import get_strategy

    return make_config(depcha_in_scan=get_strategy(strategy).uses_in_scan,
                       n_layers=ZAMBA2_TRAIN_LAYERS, **over)


def zamba2_model(cfg):
    from repro_torch.models import ssm

    return ssm.SSM(cfg, ssm.perturb_constant_leaves(
        ssm.init_params(cfg, seed=0, device=torch.device("cuda"))))


def zamba2_plan():
    """zamba2's post-backward bucket plan as ``GradSync`` plans it under
    funnel (4 MiB buckets, 4 channels, f32 comm; concom's buckets are the
    same and depcha's a subset, which is checked) and depcha's slots a
    layer at tp = 1 (``layer_slots``: the bf16 leaves', the f32
    ``A_log``/``D``/``dt_bias``'), on ``meta``."""
    from repro_torch.core import GradSyncConfig, plan_sync
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import ssm
    from repro_torch.parallel.sharding import reduce_axes_tree
    from repro_torch.utils.trees import flatten_with_names

    cfg = zamba2_config("depcha")
    params = ssm.init_params(cfg, device="meta")
    specs, mesh = ssm.param_specs(params, cfg), make_smoke_mesh(1)
    in_scan = ssm.in_scan_param_names(params)

    def buckets(strat):
        sched = plan_sync(GradSyncConfig(strategy=strat), mesh, specs, params,
                          in_scan_names=in_scan).schedule
        return {(op.bucket.bucket_id, tuple(l.name for l in op.bucket.leaves))
                for op in sched.ops}

    plan = plan_sync(GradSyncConfig(strategy="funnel"), mesh, specs, params).plan
    funnel = {(b.bucket_id, tuple(l.name for l in b.leaves)) for b in plan.buckets}
    if buckets("funnel") != funnel or not buckets("concom") <= funnel \
            or not buckets("depcha") <= funnel:
        raise AssertionError("zamba2: a strategy stages a bucket outside funnel's plan")
    axes = reduce_axes_tree(ssm.param_rules(cfg), params["blocks"], "blocks/", cfg.dp_axes)
    stack, slots = layer_slots(params["blocks"], axes)
    return plan, flatten_with_names(params)[0], stack, slots, cfg


def phase_zamba2_kernels() -> dict:
    """Rows 1-2 at ``zamba2_train``'s layouts (``zamba2_config``, leaves
    drawn on the card from the plan's shapes, no model built), bit for bit
    against their plain versions (outputs started as NaN), one launch each
    way a dtype's group of leaves (``staging_launches``): the
    post-backward buckets (one holds f32 beside bf16 leaves; f32 comm) and
    depcha's two slots of each layer (bf16, and the f32
    ``A_log``/``D``/``dt_bias``: bit copies)."""
    from repro_torch.kernels.collectives import kernel

    f32 = torch.float32
    gen = torch.Generator(device="cuda").manual_seed(0)
    plan, named, stack, slots, cfg = zamba2_plan()
    want_slot = {torch.bfloat16: sum(w[0].numel() for _, w in stack if w.dtype != f32),
                 f32: 3 * cfg.ssm_heads}
    if sorted((str(dt), b.size) for b, dt in slots) != sorted(
            (str(dt), n) for dt, n in want_slot.items()):
        raise AssertionError(f"zamba2 slots {[(str(dt), b.size) for b, dt in slots]}, "
                             f"expected {want_slot}")
    flat = [torch.randn(p.shape, generator=gen, device="cuda").to(p.dtype) for _, p in named]
    err, n_checks, launches = 0.0, 0, 0

    def check(bucket, leaves, comm, what):
        nonlocal err, n_checks, launches
        before = (kernel.PACK_LAUNCHES, kernel.UNPACK_LAUNCHES)
        err = max(err, check_bucket(bucket, leaves, comm, 1.0))
        n = staging_launches(bucket)          # one a dtype's group of leaves
        if (kernel.PACK_LAUNCHES - before[0], kernel.UNPACK_LAUNCHES - before[1]) != (n, n):
            raise AssertionError(f"{what}: expected {n} pack and {n} unpack launches")
        n_checks += 1
        launches += n

    for b in plan.buckets:
        check(b, flat, f32, f"zamba2 bucket {b.bucket_id}")
    buckets_launches = launches
    by_name = {n: t for (n, _), t in zip(named, flat)}
    rows = [[by_name["blocks/" + n][li] for n, _ in stack] for li in range(cfg.n_layers)]
    for b, dt in slots:
        for li in range(cfg.n_layers):
            check(b, rows[li], dt, f"zamba2 slot {b.bucket_id} of layer {li}")
    torch.cuda.synchronize()
    mixed = sum(1 for b in plan.buckets if len({l.dtype for l in b.leaves}) > 1)
    out = {"buckets": len(plan.buckets), "mixed_dtype_buckets": mixed,
           "bucket_launches_a_way": buckets_launches,
           "slots_per_layer": [(str(dt), b.size) for b, dt in slots],
           "checks": n_checks, "launches_a_way": launches, "max_abs_err": err}
    log(f"[zamba2_kernels] {n_checks} checks bit-exact (max abs err {err}): "
        f"{len(plan.buckets)} buckets ({mixed} holding f32 and bf16 leaves) and "
        f"{len(slots)} slots a layer x {cfg.n_layers} layers; " + json.dumps(out))
    del flat, rows, by_name
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_zamba2_train() -> dict:
    """zamba2-2.7b (``zamba2_config``) on a one-rank NCCL group, its
    constant leaves perturbed (``A_log``, ``dt_bias``, ``D``, the norms),
    seq 1024 x global batch 4, AdamW, clip 1.0, remat dots, TF32 off:
    ``strategy_runs`` (losses bit-identical across funnel, concom and
    depcha; pack/unpack launches exactly the schedule's buckets plus
    depcha's slots a step; 2 in-backward collectives a layer a depcha
    step: its bf16 and its f32 slot), then one more depcha
    step under the profiler and one with CUDA events at its stages."""
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import make_dp_mesh
    from repro_torch.models import ssm
    from repro_torch.utils.trees import tree_leaves

    mesh = make_dp_mesh()
    cfg = zamba2_config()
    n_params = sum(p.numel() for p in tree_leaves(ssm.init_params(cfg, device="meta")))
    log(f"[zamba2_train] {cfg.name}: {cfg.n_layers} layers, {ssm.n_attn_sites(cfg)} "
        f"shared-attention sites, {n_params} params, {cfg.dtype}, chunk {cfg.chunk}, "
        f"remat {cfg.remat}")
    pipe = TokenPipeline(cfg.vocab, LM_SEQ, LM_BATCH, seed=0, mesh=mesh, device="cuda")

    def profiled(ts, model, opt_state, run):
        out = {"profile": lm_profile(ts, model, opt_state, pipe,
                                     sum(run["step_ms"]) / len(run["step_ms"]))}
        out["stages"] = lm_stage_spans(ts, model, opt_state, pipe)
        return out

    out = strategy_runs("zamba2_train", zamba2_config, zamba2_model, pipe, mesh,
                        lambda strat: profiled if strat == "depcha" else None)
    out.update(out["runs"]["depcha"].pop("after"))
    want = 2 * cfg.n_layers                    # a bf16 and an f32 slot a layer
    got = out["runs"]["depcha"]["in_backward_collectives_per_step"]
    if got != [want] * LM_STEPS:
        raise AssertionError(f"zamba2_train depcha: in-backward collectives {got}, "
                             f"expected {want} a step")
    out.update(params=n_params, shape={"seq": LM_SEQ, "global_batch": LM_BATCH,
                                       "layers": cfg.n_layers,
                                       "sites": ssm.n_attn_sites(cfg)})
    log("[zamba2_train] " + json.dumps({k: v for k, v in out.items() if k != "runs"}))
    return out


def phase_zamba2_train_cpu_vs_gpu() -> dict:
    """The zamba2 smoke config (4 layers, one shared-attention site, f32,
    chunk 16), constant leaves perturbed, seq 40 x batch 2 (a ragged last
    chunk): ``_cpu_vs_gpu`` at ``ZAMBA2_CPU_GPU_TOL``."""
    from repro_torch.configs.zamba2_2_7b import make_smoke
    from repro_torch.data import TokenPipeline
    from repro_torch.models import ssm

    cfg = make_smoke()
    params = ssm.perturb_constant_leaves(ssm.init_params(cfg, seed=0, device="cpu"))
    return _cpu_vs_gpu("zamba2_train_cpu_vs_gpu", cfg, params,
                       lambda dev: TokenPipeline(cfg.vocab, 40, 2, seed=0,
                                                 device=dev).batch_at(0),
                       tol=ZAMBA2_CPU_GPU_TOL)


def zamba2_handoff(params, cfg, toks) -> dict:
    """Decode against prefill at full width: the logits of a prefill of
    S − 2 tokens (the ring sized for S) and two ``decode_step``s against a
    prefill of all S (``tests/test_serve_families.py``'s check), within
    ``ZAMBA2_HANDOFF_TOL``."""
    from repro_torch.models import ssm

    S = toks.shape[1]
    want, _ = ssm.prefill(params, toks, cfg, attn_window=S)
    _, state = ssm.prefill(params, toks[:, :S - 2], cfg, attn_window=S)
    _, state = ssm.decode_step(params, state, toks[:, S - 2], S - 2, cfg)
    got, _ = ssm.decode_step(params, state, toks[:, S - 1], S - 1, cfg)
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    return {"dtype": str(cfg.dtype), "S": S, "max_abs_diff": diff.max().item(),
            "max_rel_to_tol": (diff / (ZAMBA2_HANDOFF_TOL * (1 + want.abs()))).max().item(),
            "logit_absmax": want.abs().max().item(),
            "argmax_equal": bool(torch.equal(got.argmax(-1), want.argmax(-1))),
            "ok": bool(torch.allclose(got, want, atol=ZAMBA2_HANDOFF_TOL,
                                      rtol=ZAMBA2_HANDOFF_TOL))}


def phase_zamba2_serve(smi: str) -> dict:
    """zamba2-2.7b at full width and depth (54 layers, 8 shared-attention
    sites, bf16), constant leaves perturbed: 4 of serve's prompts (384-512
    tokens, left-padded as ``RequestQueue`` pads them) through
    ``Server.generate``, 32 greedy tokens each (the prefill's and 31
    decode steps).  Tokens in the vocab, finite logits; prefill ms (CUDA
    events, after a warm-up) and decode ms a step (CUDA events over the
    decode loop), peak GB.  Then the decode-vs-prefill hand-off at full
    width in f32 (``zamba2_handoff``), and the same in bf16, and a profiled
    prefill and decode (``phase_serve_profile``), report only."""
    from repro_torch.configs.zamba2_2_7b import make_config
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import ssm
    from repro_torch.runtime import Server
    from repro_torch.utils.trees import flatten_with_names

    cfg = make_config()
    t0 = time.perf_counter()
    params = ssm.perturb_constant_leaves(ssm.init_params(cfg, seed=0, device="cuda"))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for _, p in flatten_with_names(params)[0])
    log(f"[zamba2_serve] {cfg.name}: {n_params} params, {cfg.dtype}, "
        f"{ssm.n_attn_sites(cfg)} sites, init on the card in {time.perf_counter() - t0:.1f} s")
    server = Server(cfg, make_smoke_mesh(1, 1), params, max_len=SERVE_MAX_LEN)
    prompts = serve_prompts(cfg.vocab)[:ZAMBA2_SERVE_PROMPTS]
    toks = left_pad(prompts)
    timer = DecodeLoopTimer(server)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        out = server.generate(toks.numpy(), SERVE_MAX_NEW)
        wall_s = time.perf_counter() - t0
    finally:
        server.api = timer.api
    decode_ms = timer.close(SERVE_MAX_NEW - 1)[0]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if out.shape != (len(prompts), SERVE_MAX_NEW) or out.min() < 0 or out.max() >= cfg.vocab:
        raise AssertionError(f"zamba2 generate: tokens {out.shape}, range "
                             f"[{out.min()}, {out.max()}]")
    gpu_toks = toks.cuda()
    logits, _ = ssm.prefill(params, gpu_toks, cfg)
    if not torch.isfinite(logits).all():
        raise AssertionError("zamba2 prefill: non-finite logits")
    prefill_ms = cuda_ms(lambda: ssm.prefill(params, gpu_toks, cfg), reps=3, warmup=1)
    bf16 = zamba2_handoff(params, cfg, gpu_toks)
    profile_out = phase_serve_profile(params, cfg, tag="zamba2_serve_profile")
    p32 = tree_to(params, dtype=torch.float32)
    del params, server, timer, logits
    gc.collect()
    torch.cuda.empty_cache()
    f32 = zamba2_handoff(p32, dataclasses.replace(cfg, dtype=torch.float32), gpu_toks)
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    report = {"card": smi, "model": cfg.name, "params": n_params,
              "prompt_lens": [len(p) for p in prompts], "padded_to": toks.shape[1],
              "max_new": SERVE_MAX_NEW, "engine": "Server.generate", "wall_s": wall_s,
              "prefill_ms_B4": prefill_ms, "decode_ms_per_step": decode_ms,
              "peak_mem_gb": peak_gb, "handoff_f32": f32, "handoff_bf16_report_only": bf16,
              "tokens": out[:, :8].tolist(), "profile": profile_out}
    log("[zamba2_serve] " + json.dumps(report))
    if not f32["ok"]:
        raise AssertionError(f"zamba2 decode vs prefill (f32, full width): {f32}")
    return report


def phase_zamba2_serve_cpu_vs_gpu() -> dict:
    """The zamba2 smoke config, constant leaves perturbed: a prefill of 37
    tokens into a ring of 16 (37 % 16 = 5: the rows ring-aligned), then 20
    decode steps that wrap the ring, on the CPU and on the card, f32:
    every step's logits and the final state within 1e-4; then greedy
    tokens through ``Server.generate`` equal."""
    import numpy as np

    from repro_torch.configs.zamba2_2_7b import make_smoke
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import ssm
    from repro_torch.runtime import Server

    cfg = make_smoke()
    S, w, steps = ZAMBA2_RING
    params = ssm.perturb_constant_leaves(ssm.init_params(cfg, seed=0, device="cpu"))
    rng = np.random.default_rng(2)
    prompt = torch.from_numpy(rng.integers(1, cfg.vocab, (2, S)).astype(np.int32))
    feed = torch.from_numpy(rng.integers(1, cfg.vocab, (steps, 2)).astype(np.int32))
    got = {}
    for device in ("cpu", "cuda"):
        p = tree_to(params, device)
        logits, state = ssm.prefill(p, prompt.to(device), cfg, attn_window=w)
        seq = [logits.cpu()]
        for i in range(steps):
            logits, state = ssm.decode_step(p, state, feed[i].to(device), S + i, cfg)
            seq.append(logits.cpu())
        toks = Server(cfg, make_smoke_mesh(1, 1), p, max_len=64).generate(prompt.numpy(), 8)
        got[device] = (torch.stack(seq), {n: t.cpu() for n, t in state.items()}, toks)
    (l_cpu, s_cpu, t_cpu), (l_gpu, s_gpu, t_gpu) = got["cpu"], got["cuda"]
    diff = max([(l_cpu - l_gpu).abs().max().item()]
               + [(s_cpu[n].float() - s_gpu[n].float()).abs().max().item() for n in s_cpu])
    ok = torch.allclose(l_cpu, l_gpu, rtol=1e-4, atol=1e-4) and all(
        torch.allclose(s_cpu[n], s_gpu[n], rtol=1e-4, atol=1e-4) for n in s_cpu)
    if not ok or not np.array_equal(t_cpu, t_gpu):
        raise AssertionError(f"zamba2 serving cpu vs gpu: max abs diff {diff}, tokens "
                             f"cpu {t_cpu} gpu {t_gpu}")
    res = {"prompt": S, "window": w, "decode_steps": steps, "max_abs_diff": diff,
           "tokens_equal": True}
    log(f"[zamba2_serve_cpu_vs_gpu] {cfg.name} (rtol = atol = 1e-4, f32): " + json.dumps(res))
    return res


# ckpt: the checkpoint manager under the Trainer's fault rungs
CKPT_LAYERS = 1                # of Qwen3-1.7B's 28: 672,667,904 params, for disk and time
CKPT_STEPS, CKPT_EVERY, CKPT_FAIL_AT = 4, 2, 3
# elastic: the Supervisor over the ladder ("tp2", "tp1") on 4 rank processes
ELASTIC_RANKS = 4
ELASTIC_LAYERS = 1            # of 28: the state is the vocab's (embed and head), for the time
ELASTIC_SEQ, ELASTIC_BATCH = 256, 4
ELASTIC_MESHES = {"tp2": ((2, 2), (0, 1, 2, 3)), "tp1": ((2, 1), (0, 1))}
ELASTIC_LADDER = ("tp2", "tp1")
# 4 steps, grow-back after 1 and a save every 8 steps (none of the 4 but the
# transitions' anchors), for the script's time
ELASTIC_STEPS, ELASTIC_EVERY, ELASTIC_GROW = 4, 8, 1
ELASTIC_PLAN = dict(rank_loss=frozenset({2}), transient=frozenset({1}), step_retries=1,
                    ckpt_io_faults=2, ckpt_retries=3)
ELASTIC_SCRIPT = ((2, "tp1"), (3, "tp2"))


def disk(path: str) -> dict:
    """Bytes of the files under ``path`` and the free bytes of its disk."""
    import shutil

    used = sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)
    return {"bytes": used, "free_bytes": shutil.disk_usage(path).free}


def phase_ckpt() -> dict:
    """The checkpoint manager under the Trainer's rungs on the card:
    Qwen3-1.7B at full width cut to ``CKPT_LAYERS`` layers, bf16, on the
    one-rank NCCL group, seq 1024 x batch 4, AdamW, clip 1.0, funnel,
    deterministic algorithms as lm_train.  ``CKPT_STEPS`` steps with an
    async ``CheckpointManager`` (every ``CKPT_EVERY``, keep 1) and a
    failure at step ``CKPT_FAIL_AT``: recovered from step 2 and replayed,
    the final params and AdamW state must equal an uninterrupted run's
    bit for bit.  Times: the loop held by each save (the host snapshot,
    and the wait for the save before), each background write, each
    restore read; the bytes a checkpoint takes and the free bytes under
    the temp directory."""
    import tempfile
    import warnings

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import GradSyncConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.collectives import kernel
    from repro_torch.launch.mesh import make_dp_mesh
    from repro_torch.models.transformer import Transformer, init_params
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.runtime import Trainer, make_train_step
    from repro_torch.utils.trees import flatten_with_names

    class Timed(CheckpointManager):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.times = {"hold_ms": [], "write_s": [], "read_s": []}
            self.sizes: list = []

        def maybe_save(self, step, tree):
            t0 = time.perf_counter()
            saved = super().maybe_save(step, tree)
            if saved:
                self.times["hold_ms"].append((time.perf_counter() - t0) * 1e3)
            return saved

        def _with_retries(self, op, fn):
            t0 = time.perf_counter()
            out = fn_out = super()._with_retries(op, fn)
            self.times["write_s" if op == "save" else "read_s"].append(
                time.perf_counter() - t0)
            if op == "save":
                self.sizes.append(disk(fn_out))
            return out

    cfg = dataclasses.replace(lm_config("funnel"), n_layers=CKPT_LAYERS)
    mesh = make_dp_mesh()
    pipe = TokenPipeline(cfg.vocab, LM_SEQ, LM_BATCH, seed=0, mesh=mesh, device="cuda")

    def run(root):
        model = Transformer(cfg, init_params(cfg, seed=0, device="cuda"))
        ts = make_train_step(cfg, mesh, GradSyncConfig(strategy="funnel"),
                             adamw(cosine_warmup(3e-4, 10, 100)), model=model, clip_norm=1.0,
                             device="cuda")
        mgr = Timed(root, every=CKPT_EVERY, keep=1) if root else None
        tr = Trainer(ts, pipe, mgr, fail_at=frozenset({CKPT_FAIL_AT}) if root else frozenset(),
                     log_every=10 ** 9, printer=lambda _m: None)
        kernel.PACK_LAUNCHES = kernel.UNPACK_LAUNCHES = 0
        t0 = time.perf_counter()
        model, state, hist = tr.run(model, ts.init_opt(), CKPT_STEPS)
        torch.cuda.synchronize()
        out = {"wall_s": time.perf_counter() - t0, "losses": hist["losses"],
               "events": [(e["kind"], e["step"]) for e in hist["events"]],
               "launches": {"pack": kernel.PACK_LAUNCHES, "unpack": kernel.UNPACK_LAUNCHES},
               "per_step": sum(staging_launches(op.bucket) for op in ts.gradsync.schedule.ops),
               "params": bit_sums(flatten_with_names(model.params_tree())[0]),
               "state": bit_sums(flatten_with_names(state)[0]),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "n_params": sum(p.numel() for p in model.parameters())}
        if mgr is not None:
            out.update(mgr.times, checkpoints=mgr.sizes)
        ts.close()
        del model, state, ts, tr
        gc.collect()
        torch.cuda.empty_cache()
        return out

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cuda.matmul.allow_tf32 = False
    with warnings.catch_warnings(record=True) as caught, \
            tempfile.TemporaryDirectory(prefix="ckpt-") as root:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            torch.cuda.reset_peak_memory_stats()
            faulty = run(root)
            clean = run(None)
        finally:
            torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    nondeterministic = sorted({str(w.message)[:200] for w in caught
                               if "deterministic" in str(w.message)})
    want_events = [("compile", 0), ("failure", CKPT_FAIL_AT), ("recover", CKPT_EVERY)]
    if faulty["events"] != want_events:
        raise AssertionError(f"ckpt: events {faulty['events']}, expected {want_events}")
    # steps 0-2, the failed 3, the replay of 2 and 3: 5 steps staged
    executed = CKPT_STEPS + (CKPT_FAIL_AT - CKPT_EVERY)
    for r, n in ((faulty, executed), (clean, CKPT_STEPS)):
        want = {"pack": r["per_step"] * n, "unpack": r["per_step"] * n}
        if r["launches"] != want:
            raise AssertionError(f"ckpt: launches {r['launches']}, expected {want}")
    if faulty["params"] != clean["params"] or faulty["state"] != clean["state"]:
        raise AssertionError(f"ckpt: the recovered run is not bit-equal to the "
                             f"uninterrupted one (nondeterministic ops: {nondeterministic})")
    out = {"layers": CKPT_LAYERS, "seq": LM_SEQ, "global_batch": LM_BATCH,
           "faulty": {k: v for k, v in faulty.items() if k not in ("params", "state")},
           "clean_wall_s": clean["wall_s"], "bit_equal": True,
           "nondeterministic_ops": nondeterministic,
           "launches": faulty["launches"], "n_params": faulty["n_params"]}
    log("[ckpt] " + json.dumps(out))
    return out


def elastic_layouts() -> dict:
    """Rank 0's dp plans of the elastic phase's two rungs (its shards'
    shapes, f32), planned on ``meta`` as the step plans them."""
    from repro_torch.core import GradSyncConfig
    from repro_torch.core.kvstore import plan_sync
    from repro_torch.models.transformer import init_params, param_specs
    from repro_torch.parallel.sharding import Mesh, localize_structs

    out = {}
    for key, ((data, model), ranks) in ELASTIC_MESHES.items():
        cfg = elastic_config(model)
        mesh = Mesh(("data", "model"), {"data": data, "model": model}, ranks)
        glob = init_params(cfg, device="meta")
        local = localize_structs(glob, param_specs(glob, cfg), mesh)
        out[key] = plan_sync(GradSyncConfig(strategy="concom", exclude_axes=("data",),
                                            zero1_dp_axes=("data",)),
                             mesh, param_specs(local, cfg), local).program.dp_plan
    return out


def elastic_config(tp: int):
    return dataclasses.replace(lm_config("concom"), n_layers=ELASTIC_LAYERS, tp=tp,
                               dtype=torch.float32)


def phase_elastic_kernels() -> dict:
    """Rows 1-2 at the state codec's layouts, bit for bit against their
    plain versions (outputs started as NaN): every bucket of rank 0's dp
    plan on each rung, f32 leaves packed to f32 (the scatter side) and
    unpacked into f32 leaves at scale 1 (the gather side)."""
    plans = elastic_layouts()
    gen = torch.Generator(device="cuda").manual_seed(0)
    err, checks = 0.0, 0
    for key, plan in plans.items():
        leaves = {l.index: l for b in plan.buckets for l in b.leaves}
        flat = [torch.randn(leaves[i].shape, generator=gen, device="cuda")
                for i in range(plan.num_leaves)]
        for b in plan.buckets:
            err = max(err, check_bucket(b, flat, torch.float32, 1.0))
            checks += 1
        del flat
        gc.collect()
        torch.cuda.empty_cache()
    out = {"max_abs_err": err, "checks": checks,
           "buckets": {k: len(p.buckets) for k, p in plans.items()},
           "launches_a_side": {k: sum(staging_launches(b) for b in p.buckets)
                               for k, p in plans.items()}}
    log(f"[elastic_kernels] {checks} buckets bit-exact both ways: " + json.dumps(out))
    return out


def _elastic_rank(rank: int, workdir: str, backend: str, anchor_ab: bool) -> None:
    """One rank of ``phase_elastic``: the Supervisor's faulty cycle over
    ``ELASTIC_LADDER``, then its clean scripted replay (and with
    ``anchor_ab`` the anchor's A/B); results to ``workdir/rank<r>.json``."""
    import datetime
    import shutil

    import torch.distributed as dist

    from repro_torch.core import GradSyncConfig
    from repro_torch.core import dependency as dep
    from repro_torch.data import TokenPipeline
    from repro_torch.elastic import FaultPlan, StateCodec, Supervisor
    from repro_torch.kernels.collectives import kernel
    from repro_torch.launch.mesh import init_dist
    from repro_torch.models.transformer import Transformer, init_params
    from repro_torch.optim import adamw, zero1
    from repro_torch.parallel.sharding import Mesh
    from repro_torch.runtime import make_train_step
    from repro_torch.utils.trees import flatten_with_names

    # four processes share the card: no memory held in split segments
    # (set at run time too: as a turn of ``spawn_turns`` the process's
    # allocator is already up)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    init_dist("cuda", backend=backend, init_method=f"file://{workdir}/store", rank=rank,
              world_size=ELASTIC_RANKS, timeout=datetime.timedelta(seconds=600))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    say = log if rank == 0 else (lambda _m: None)
    steps: dict = {}

    def step_for(key):
        if key not in steps:
            (data, model), ranks = ELASTIC_MESHES[key]
            mesh = Mesh(("data", "model"), {"data": data, "model": model}, ranks)
            cfg = elastic_config(model)
            me = dep.mesh_rank(mesh)
            shapes = Transformer(cfg, init_params(cfg, device="meta", mesh=mesh,
                                                  rank=0 if me is None else me))
            ts = make_train_step(cfg, mesh, GradSyncConfig(strategy="concom",
                                                           exclude_axes=("data",)),
                                 zero1(adamw(1e-3), ("data",), data), model=shapes,
                                 zero1_mode=True, zero1_plan="scheduled", clip_norm=0.0,
                                 device="cuda")
            pipe = (TokenPipeline(cfg.vocab, ELASTIC_SEQ, ELASTIC_BATCH, seed=0, mesh=mesh,
                                  rank=me, device="cuda") if me is not None else None)
            steps[key] = (ts, pipe, mesh, cfg, me)
        return steps[key]

    def build(key):
        ts, pipe, mesh, cfg, me = step_for(key)
        if me is None:
            return ts, None, None
        return ts, pipe, Transformer(cfg, init_params(cfg, seed=0, device="cuda", mesh=mesh,
                                                      rank=me))

    # the codec's programs: each call's staging launches against its plan
    reshard = {"gather_calls": 0, "scatter_calls": 0, "unpack": 0, "pack": 0,
               "expected_unpack": 0, "expected_pack": 0}

    def counted(fn, side):
        def wrapped(self, *a, **kw):
            p0, u0 = kernel.PACK_LAUNCHES, kernel.UNPACK_LAUNCHES
            out = fn(self, *a, **kw)
            reshard[f"{side}_calls"] += 1
            reshard["pack"] += kernel.PACK_LAUNCHES - p0
            reshard["unpack"] += kernel.UNPACK_LAUNCHES - u0
            n = sum(staging_launches(b) for b in self.dp_plan.buckets)
            reshard["expected_unpack" if side == "gather" else "expected_pack"] += n
            return out
        return wrapped

    StateCodec._gather = counted(StateCodec._gather, "gather")
    StateCodec._scatter = counted(StateCodec._scatter, "scatter")

    # where a run's time goes: host seconds in each piece, summed, and
    # each call's
    spent: dict = {}
    each: dict = {}

    def timed(owner, name, key):
        fn = getattr(owner, name)

        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                spent[key] = spent.get(key, 0.0) + dt
                each.setdefault(key, []).append(dt)
        setattr(owner, name, wrapped)

    from repro_torch.checkpoint import manager as ckpt_manager
    from repro_torch.elastic import reshard as el_reshard
    from repro_torch.elastic import supervisor as el_supervisor

    timed(el_supervisor, "reshard_state", "reshard_state")
    timed(StateCodec, "encode", "codec.encode")
    timed(StateCodec, "decode", "codec.decode")
    timed(ckpt_manager, "host_global", "host_global")
    timed(el_reshard, "host_global", "host_global(reshard)")
    timed(ckpt_manager, "_write", "write")
    timed(ckpt_manager, "restore", "read")
    timed(el_supervisor.ElasticCheckpointer, "save_view", "anchor save")
    timed(el_supervisor.ElasticCheckpointer, "save_now", "save_now")
    timed(el_supervisor.ElasticCheckpointer, "maybe_save", "periodic save")
    timed(el_supervisor.ElasticCheckpointer, "restore", "restore")

    class Peaks(Supervisor):
        """The card's peak memory while on each rung (its transition out
        included)."""
        peaks: dict = {}

        def _transition(self, resume_step, from_key, to_key, *a, **kw):
            torch.cuda.synchronize()
            self.peaks[from_key] = max(self.peaks.get(from_key, 0.0),
                                       torch.cuda.max_memory_allocated() / 1e9)
            torch.cuda.reset_peak_memory_stats()
            out = super()._transition(resume_step, from_key, to_key, *a, **kw)
            gc.collect()
            torch.cuda.empty_cache()
            return out

    def digest(model, state):
        if model is None:
            return None
        return (bit_sums(flatten_with_names(model.params_tree())[0]),
                bit_sums(flatten_with_names(state)[0]))

    out = {}
    for name, kw in (("faulty", {"plan": FaultPlan(**ELASTIC_PLAN)}), ("clean", {})):
        if name == "clean":
            kw["script"] = out["faulty"]["script"]
        root = os.path.join(workdir, f"ckpt-{name}")
        Peaks.peaks = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernel.PACK_LAUNCHES = kernel.UNPACK_LAUNCHES = 0
        for k in reshard:
            reshard[k] = 0
        spent.clear()
        each.clear()
        t0 = time.perf_counter()
        sup = Peaks(build, ELASTIC_LADDER, root, every=ELASTIC_EVERY,
                    grow_back_after=ELASTIC_GROW, printer=say, **kw)
        model, state, rep = sup.run(ELASTIC_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        Peaks.peaks[rep["final_mesh"]] = max(Peaks.peaks.get(rep["final_mesh"], 0.0),
                                             torch.cuda.max_memory_allocated() / 1e9)
        dist.barrier()
        files = disk(root) if rank == 0 else None
        if rank == 0:
            shutil.rmtree(root, ignore_errors=True)
        dist.barrier()
        out[name] = {"wall_s": wall, "script": [list(r) for r in rep["script"]],
                     "transitions": rep["transitions"],
                     "events": [(e["kind"], e.get("step")) for e in rep["events"]],
                     "peak_gb": dict(Peaks.peaks), "digest": digest(model, state),
                     "launches": {"pack": kernel.PACK_LAUNCHES,
                                  "unpack": kernel.UNPACK_LAUNCHES},
                     "reshard_launches": dict(reshard), "disk_after_run": files,
                     "host_s": dict(spent), "anchor_s": each.get("anchor save", [])}
        if name == "clean" and anchor_ab:
            # the anchor's write from the transfer's view (the last
            # transition's, onto this rung) against ``save_now`` of the
            # final state on the same rung: the state encoded and gathered
            # to the writer again, then written
            ab_root = os.path.join(workdir, "ckpt-ab")
            ab = el_supervisor.ElasticCheckpointer(
                ckpt_manager.CheckpointManager(ab_root, keep=0, blocking=True),
                sup._codec(rep["final_mesh"]))
            before = dict(spent)
            ab.save_now(ELASTIC_STEPS, {"params": model.params_tree(), "opt": state})
            dist.barrier()
            if rank == 0:
                shutil.rmtree(ab_root, ignore_errors=True)
            out["anchor_ab"] = {"mesh": rep["final_mesh"],
                                "from_view_s": each["anchor save"][-1],
                                "save_now_s": each["save_now"][-1],
                                "save_now_pieces_s": {k: v - before.get(k, 0.0)
                                                      for k, v in spent.items()
                                                      if v != before.get(k)}}
        say(f"[elastic] {name}: " + json.dumps({k: v for k, v in out[name].items()
                                                 if k != "digest"}))
        del model, state, sup
        gc.collect()
        torch.cuda.empty_cache()
    ts2 = step_for("tp2")[0]
    n_params = sum(p.numel() for _, p in flatten_with_names(
        StateCodec(ts2)._params_like())[0])
    out["n_params"] = n_params
    # the steps are shared by both supervisors' runs: closed once both are done
    for ts, *_ in steps.values():
        ts.close()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def phase_elastic(backend: str = "gloo", anchor_ab: bool = False, spawned=None,
                  kernels: dict | None = None) -> dict:
    """Elastic training on the card: ``ELASTIC_RANKS`` rank processes on
    the one card over gloo (every collective staged through pinned host
    memory, as lm_tp; ``backend="nccl"`` needs ``ELASTIC_RANKS`` cards,
    one a rank), each running ``_elastic_rank``.  Qwen3-1.7B's
    widths in f32 (the state codec's rule) cut to ``ELASTIC_LAYERS``
    layers, seq 256 x global batch 4, ZeRO-1 scheduled, concom, AdamW,
    clip 0, over the ladder data 2 x model 2 → data 2 x model 1: a
    transient at step 1, a rank loss at 2, 2 checkpoint-I/O faults,
    grow-back after 1, 4 steps, saves every ``ELASTIC_EVERY`` (so only
    the two transitions' anchors, all kept; each run's directory deleted
    after it), then the clean scripted replay.  With ``anchor_ab`` (by
    hand: 25 s more), one ``save_now`` of its final state on its final
    rung after it: the A/B of the anchor written from the transfer's
    view.  Required: the script ``ELASTIC_SCRIPT``, the faulty
    run bit-equal to the clean one on every rank, each transition's bytes
    at least 3 x the params x 4 B (params, m and v), and every codec
    program launching rows 1-2 once a RESHARD op (its bucket's
    ``staging_launches``).  ``spawned``: its turn of ``spawn_turns``
    (the last: it wraps library functions for the process's life) and
    ``kernels`` its ``phase_elastic_kernels()``, as ``main`` runs it;
    else both here."""
    if kernels is None:
        kernels = phase_elastic_kernels()
    ranks, wall = spawned or spawn_ranks(_elastic_rank, (backend, anchor_ab), ELASTIC_RANKS)
    res = ranks[0]
    for r, got in enumerate(ranks):
        if got["faulty"]["digest"] != got["clean"]["digest"]:
            raise AssertionError(f"elastic: rank {r}'s faulty run is not bit-equal to its "
                                 f"clean replay")
        for name in ("faulty", "clean"):
            if [tuple(x) for x in got[name]["script"]] != list(ELASTIC_SCRIPT):
                raise AssertionError(f"elastic {name}: rank {r}'s script "
                                     f"{got[name]['script']}, expected {ELASTIC_SCRIPT}")
            rl = got[name]["reshard_launches"]
            if (rl["unpack"], rl["pack"]) != (rl["expected_unpack"], rl["expected_pack"]):
                raise AssertionError(f"elastic {name}: rank {r}'s codec launches {rl}")
    floor = 3 * res["n_params"] * 4
    for t in res["faulty"]["transitions"]:
        if t["reshard_bytes"] < floor:
            raise AssertionError(f"elastic: transition {t} moves fewer than {floor} B")
    out = {"wall_s": wall, "kernels": kernels,
           "n_params": res["n_params"], "reshard_bytes_floor": floor,
           "transitions": {n: res[n]["transitions"] for n in ("faulty", "clean")},
           "peak_gb_by_rank": [{n: g[n]["peak_gb"] for n in ("faulty", "clean")}
                               for g in ranks],
           "reshard_launches": {n: res[n]["reshard_launches"] for n in ("faulty", "clean")},
           "launches": res["faulty"]["launches"],
           "run_wall_s": {n: res[n]["wall_s"] for n in ("faulty", "clean")},
           "host_s_by_rank": [{n: g[n]["host_s"] for n in ("faulty", "clean")} for g in ranks],
           "events": res["faulty"]["events"],
           "anchor_ab": res.get("anchor_ab"),
           "disk": {n: res[n]["disk_after_run"] for n in ("faulty", "clean")},
           "bit_equal": True, "transport": (
               f"gloo over pinned host memory, {ELASTIC_RANKS} processes on one card"
               if backend == "gloo" else
               f"{backend}, {ELASTIC_RANKS} processes on {torch.cuda.device_count()} cards")}
    log("[elastic] " + json.dumps(out))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a GPU", file=sys.stderr)
        return 1
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_dist

    faulthandler.dump_traceback_later(HANG_LIMIT_S, exit=True)
    t_start = time.perf_counter()

    def clock(tag: str) -> None:
        """The script's own wall time (its time budget), and the card's
        memory in use beside what PyTorch's allocator holds: what the
        phases so far keep outside the allocator (communicators, library
        workspaces) is what a later phase cannot have."""
        free, total = torch.cuda.mem_get_info()
        log(f"[clock] {tag}: {time.perf_counter() - t_start:.1f} s since the start; "
            f"{(total - free) / 1e9:.2f} GB of the card in use, "
            f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved by PyTorch")

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
    clock("build")
    xr = phase_xr_train()
    vision_train, rwkv_train = xr["vision_train"], xr["rwkv_train"]
    zamba2_train = xr["zamba2_train"]
    clock("xr_train")
    init_dist("cuda")
    try:
        rows = phase_kernels()
        ring_quant = phase_ring_quant()
        clock("ring_quant")
        train = phase_train()
        phase_profile(*train["live"])
        clock("train")
        sim = phase_sim(train)
        clock("sim")
        phase_cpu_vs_gpu()
        clock("cpu_vs_gpu")
        train["live"][0].close()
        del train["live"]
        gc.collect()
        torch.cuda.empty_cache()
        lm_rows = phase_lm_kernels()
        gc.collect()
        torch.cuda.empty_cache()
        clock("lm_kernels")
        lm = phase_lm_train()
        sim["lm_gauges"] = lm_gauges(lm)
        clock("lm_train")
        tp1 = phase_lm_tp1()
        phase_lm_cpu_vs_gpu()
        clock("lm_cpu_vs_gpu")
        gc.collect()
        torch.cuda.empty_cache()
        ckpt = phase_ckpt()
        clock("ckpt")
        gc.collect()
        torch.cuda.empty_cache()
        lm_zero1_rows = phase_lm_zero1_kernels()
        clock("lm_zero1_kernels")
        lm_zero1 = phase_lm_zero1(lm_zero1_rows)
        clock("lm_zero1")
        phase_lm_zero1_cpu_vs_gpu()
        clock("lm_zero1_cpu_vs_gpu")
        gc.collect()
        torch.cuda.empty_cache()
        inception_rows = phase_inception_kernels()
        inception = phase_inception()
        phase_inception_cpu_vs_gpu()
        clock("inception_cpu_vs_gpu")
        phase_verify()
        clock("verify")
        gc.collect()
        torch.cuda.empty_cache()
        # after lm_zero1, whose monolithic run needs 61 GB of the card
        lm_moe_rows = phase_lm_moe_kernels()
        lm_moe = phase_lm_moe()
        clock("lm_moe")
        phase_moe_cpu_vs_gpu()
        clock("moe_cpu_vs_gpu")
        gc.collect()
        torch.cuda.empty_cache()
        lm_tp_rows = phase_lm_tp_kernels()
        clock("lm_tp_kernels")
        pp_rows = phase_pp_kernels()
        gc.collect()
        torch.cuda.empty_cache()
        clock("pp_kernels")
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    clock("destroy")
    # the four-rank gloo phases in one spawn, one after the other: their
    # processes start and end once (elastic last: it wraps library
    # functions for the process's life)
    assert LM_TP == math.prod(LM_FSDP_MESH) == RING == ELASTIC_RANKS
    elastic_kernels = phase_elastic_kernels()
    four = spawn_turns((("_lm_tp_rank", ("gloo", tp1)),
                        ("_lm_fsdp_rank", ("gloo", tp1, *LM_FSDP_MESH)),
                        ("_reducers_rank", ("gloo",)), ("_zero1_rank", ("gloo",)),
                        ("_hier_rank", ("gloo",)), ("_elastic_rank", ("gloo", False))), RING)
    lm_tp = phase_lm_tp(tp1, spawned=four[0])
    lm_fsdp = phase_lm_fsdp(tp1, spawned=four[1])
    reducers = phase_reducers(spawned=four[2])
    zero1 = phase_zero1(spawned=four[3])
    hier = phase_hierarchical(spawned=four[4])
    elastic = phase_elastic(spawned=four[5], kernels=elastic_kernels)
    clock("four_ranks")
    flash_rows = phase_flash()
    clock("flash")
    serve = phase_serve(smi)
    phase_serve_cpu_vs_gpu()
    clock("serve_cpu_vs_gpu")
    gc.collect()                     # Qwen3's weights go before RWKV's
    torch.cuda.empty_cache()
    log(f"[env] {torch.cuda.memory_allocated() / 1e9} GB held before RWKV")
    wkv_rows = phase_wkv()
    rwkv_serve = phase_rwkv_serve(smi)
    phase_rwkv_cpu_vs_gpu()
    clock("rwkv_cpu_vs_gpu")
    gc.collect()                     # RWKV's weights go before granite's
    torch.cuda.empty_cache()
    moe_serve = phase_moe_serve()
    clock("moe_serve")
    gc.collect()                     # granite's weights go before the vision model's
    torch.cuda.empty_cache()
    vision_serve = phase_vision_serve(smi)
    clock("vision_serve")
    gc.collect()                     # the vision model's weights go before zamba2's
    torch.cuda.empty_cache()
    phase_zamba2_kernels()
    phase_zamba2_serve(smi)
    phase_zamba2_serve_cpu_vs_gpu()
    clock("zamba2_serve")

    src = "src/repro_torch/kernels/collectives/csrc/staging.cu"
    replaces = {"pack": "src/repro/kernels/collectives/kernel.py:76",
                "unpack": "src/repro/kernels/collectives/kernel.py:99"}
    kernels = []
    for name, r in rows.items():
        by_path = {"train": train["launches"][name], "lm_train": lm["launches"][name],
                   "inception": inception["launches"][name],
                   "lm_zero1": lm_zero1["launches"][name],
                   "zero1": sum(r["launches"][name] for r in zero1["runs"].values()),
                   "lm_tp": sum(r["launches"][name] for r in lm_tp["runs"].values()),
                   "lm_moe": lm_moe["launches"][name],
                   "lm_fsdp": sum(r["launches"][name] for r in lm_fsdp["runs"].values()),
                   "lm_pp": sum(r["launches"][name] for r in lm_tp["pp"]["runs"].values()),
                   "vision_train": vision_train["launches"][name],
                   "rwkv_train": rwkv_train["launches"][name],
                   "zamba2_train": zamba2_train["launches"][name],
                   "ckpt": ckpt["launches"][name],
                   "elastic": elastic["launches"][name],
                   "sim": sim["launches"][name]}
        kernels.append({
            "name": f"{name}_bucket_kernel", "route": "cuda", "source": src,
            "replaces": replaces[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path, "launches_per_step": 24, **r,
            # every layout's check: ResNet-50's, the LM's, Inception's, lm_zero1's
            "max_abs_err": max(r["max_abs_err"], lm_rows["max_abs_err"],
                               inception_rows["max_abs_err"], lm_zero1_rows["max_abs_err"],
                               lm_tp_rows["max_abs_err"], lm_moe_rows["max_abs_err"],
                               pp_rows["max_abs_err"], elastic["kernels"]["max_abs_err"]),
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
                          "step": inception_rows[name]},
            # ZeRO-1 and accumulation: the gradients' and the param shards'
            # packs, the updates' unpacks (rank 0's count on four ranks)
            "lm_zero1": {"launches_per_step": {k: v["launches_per_step"]
                                               for k, v in lm_zero1["runs"].items()},
                         "max_abs_err": lm_zero1_rows["max_abs_err"],
                         "checks": lm_zero1_rows["checks"],
                         "monolithic_elements": lm_zero1_rows["monolithic_elements"],
                         "dp_step": lm_zero1_rows["step"][name]},
            "zero1": {"launches": {k: v["launches"] for k, v in zero1["runs"].items()}},
            # tensor parallelism: rank 0's shards at data 1 x model 4 (two
            # reduce sets) and depcha's two slots a layer
            "lm_tp": {"launches_per_step": {k: v["launches_per_step"]
                                            for k, v in lm_tp["runs"].items()},
                      "max_abs_err": lm_tp_rows["max_abs_err"],
                      "checks": lm_tp_rows["checks"], "buckets": lm_tp_rows["buckets"],
                      "post_backward": lm_tp_rows["post_backward"][name],
                      "slots": lm_tp_rows["slots"][name]},
            # MoE: granite's buckets (f32 router beside bf16 experts) and
            # two slots a layer; FSDP: rank 0's buckets without the FSDP
            # leaves at data 2 x model 2 (the launches are rank 0's)
            "lm_moe": {"launches_per_step": {k: v["launches_per_step"]
                                             for k, v in lm_moe["runs"].items()},
                       "max_abs_err": lm_moe_rows["max_abs_err"],
                       "checks": lm_moe_rows["checks"],
                       "post_backward": lm_moe_rows["granite"]["post_backward"][name],
                       "slots": {dt: v[name]
                                 for dt, v in lm_moe_rows["granite"]["slots"].items()}},
            "lm_fsdp": {"launches_per_step": {k: v["launches_per_step"]
                                              for k, v in lm_fsdp["runs"].items()},
                        "layout": lm_moe_rows["fsdp"]},
            # pipeline stages: rank 0's staged plan (its stage's blocks, the
            # stage-replicated leaves) under gpipe, 1f1b and the stage-1
            # twin; each plan's buckets checked, the staged one's timed
            "lm_pp": {"launches_per_step": {k: v["launches_per_step"]
                                            for k, v in lm_tp["pp"]["runs"].items()},
                      "max_abs_err": pp_rows["max_abs_err"], "checks": pp_rows["checks"],
                      "buckets": pp_rows["buckets"],
                      "post_backward": pp_rows["post_backward"][name]},
            # cross-attention and RWKV training: each run's buckets plus
            # depcha's slots (one a layer of each stack; RWKV's bf16 and f32)
            "vision_train": {"launches_per_step": {
                k: v["launches_per_step"] for k, v in vision_train["runs"].items()}},
            "rwkv_train": {"launches_per_step": {
                k: v["launches_per_step"] for k, v in rwkv_train["runs"].items()}},
            # the Zamba2 hybrid: its buckets plus depcha's bf16 and f32 slot
            # of each Mamba layer (the shared block post-backward)
            "zamba2_train": {"launches_per_step": {
                k: v["launches_per_step"] for k, v in zamba2_train["runs"].items()}},
            # the checkpoint's recovered run (5 steps staged: 3, the failed
            # one, 2 replayed) and the elastic ladder's faulty run on rank 0:
            # its steps and the state codec's RESHARD programs, one launch a
            # RESHARD op (f32 → f32 packs, unpacks into f32 leaves)
            "ckpt": {"launches_per_step": ckpt["faulty"]["per_step"]},
            # the simulator: auto's delegated ResNet-50 run (24 a step) and
            # the measured replay of one step (24 a rep); the staging fit's
            # timing launches are not counted
            "sim": {"replay": sim["replay_launches"][name], "winner": sim["winner"],
                    "staging_fit": {k: sim["fit"][k] for k in
                                    ("hbm_bw", "leaf_overhead", "share_of_sheet",
                                     "rel_residual", "quality")}},
            "elastic": {"codec": elastic["reshard_launches"]["faulty"],
                        "codec_layouts": elastic["kernels"]}})
    fr, f32r = flash_rows["static"], flash_rows["static_f32"]
    kernels.append({
        "name": "flash_attention_fwd", "route": "cuda",
        "source": FLASH_SOURCES[torch.bfloat16],
        "replaces": "src/repro/kernels/flash_attention/kernel.py:78",
        "launches": (serve["launches"] + moe_serve["flash_launches"] + vision_serve["launches"]
                     + lm_tp["serve"]["flash_launches"] + lm_fsdp["serve"]["flash_launches"]),
        "launches_by_path": {"serve": serve["launches"],
                             "moe_serve": moe_serve["flash_launches"],
                             "vision_serve": vision_serve["launches"],
                             "serve_tp": lm_tp["serve"]["flash_launches"],
                             "serve_fsdp": lm_fsdp["serve"]["flash_launches"]},
        "launches_per_prefill": 28, "launches_per_prefill_moe": 24,
        "launches_per_prefill_vision": vision_serve["per_prefill"],
        "moe_serve_layer0_max_abs_err": moe_serve["flash_layer0_max_abs_err"],
        "max_abs_err": fr["max_abs_err"], "ms": fr["ms"],
        "device_ms_per_launch": fr["device_ms_per_launch"],
        "plain_ms": fr["plain_ms"], "bound_ms": fr["bound_ms"],
        "bound_by": fr["bound_by"], "library_ms": fr["library_ms"],
        "shape": fr["shape"], "continuous_shape": flash_rows["continuous"],
        # a rank's heads in serve_tp's (model 4) and serve_fsdp's (model 2)
        # static prefill, launched by rank 0 of each spawn
        "tp_shapes": {"serve_tp": flash_rows["static_tp4"],
                      "serve_fsdp": flash_rows["static_tp2"]},
        "sass": fr["sass"],
        # f32 inputs: the CUDA-core kernel, launched by serve's f32 checks
        "f32_kernel": {
            "name": "flash_attention_fwd (f32)", "route": "cuda",
            "source": FLASH_SOURCES[torch.float32],
            "replaces": "src/repro/kernels/flash_attention/kernel.py:78",
            "launches": serve["f32_launches"] + lm_tp["serve_f32"]["flash_launches_f32"],
            "launches_by_path": {"serve": serve["f32_launches"],
                                 "serve_tp_f32": lm_tp["serve_f32"]["flash_launches_f32"]},
            "max_abs_err": f32r["max_abs_err"],
            "ms": f32r["ms"], "device_ms_per_launch": f32r["device_ms_per_launch"],
            "plain_ms": f32r["plain_ms"], "bound_ms": f32r["bound_ms"],
            "bound_by": f32r["bound_by"], "library_ms": f32r["library_ms"],
            "shape": f32r["shape"]}})
    wr = wkv_rows["prefill"]
    kernels.append({
        "name": "wkv_sequence_kernel", "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6/csrc/wkv.cu",
        "replaces": "src/repro/kernels/rwkv6/kernel.py:59",
        "launches": rwkv_serve["launches"] + sum(rwkv_train["wkv_launches"].values()),
        "launches_by_path": {"rwkv_serve": rwkv_serve["launches"],
                             "rwkv_train": sum(rwkv_train["wkv_launches"].values())},
        "launches_per_train_step": rwkv_train["wkv_launches_per_step"],
        "training_shape": rwkv_train["chunk_states"],
        "launches_per_prefill": rwkv_serve["per_prefill"],
        "launches_per_decode_step": rwkv_serve["per_step"],
        "max_abs_err": wr["max_abs_err"], "ms": wr["ms"],
        "device_ms_per_launch": wr["device_ms_per_launch"],
        "profiler_span_over_events": wr["span_over_events"],
        "plain_ms": wr["plain_ms"], "bound_ms": wr["bound_ms"],
        "bound_by": wr["bound_by"], "library_ms": None, "library": WKV_LIBRARY,
        "shape": wr["shape"], "decode_shape": wkv_rows["decode"],
        # a rank's layer of RWKV-6 7B at model 4 (16 heads of 64)
        "tp4_shapes": {"prefill": wkv_rows["prefill_tp4"], "decode": wkv_rows["decode_tp4"]},
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
        by_run = {k: run["launches"][counter] for k, run in runs.items()}
        if counter == "accum":       # the zero1 reduce-scatters on the ring
            by_run.update({f"zero1 {k}": run["launches"]["accum"]
                           for k, run in zero1["runs"].items()})
        # tensor parallelism's f32 equivalence (rank 0's): the rings over
        # "model" at 1 x 4 and over ("data", "model") at 2 x 2, the int8
        # kernels of compressed over the world at 1 x 4
        by_run.update({f"lm_tp {k}": v[f"{counter}_launches"]
                       for k, v in lm_tp["equivalence"]["cases"].items()
                       if f"{counter}_launches" in v})
        # FSDP's f32 equivalence (rank 0's) under ring and compressed
        by_run.update({f"lm_fsdp {k}": v[f"{counter}_launches"]
                       for k, v in lm_fsdp["equivalence"]["cases"].items()
                       if f"{counter}_launches" in v})
        kernels.append({
            "name": name, "row": row, "route": "cuda", "source": RING_QUANT_SOURCES[name],
            "replaces": RING_QUANT_REPLACES[name],
            "launches": sum(by_run.values()), "launches_by_run": by_run, **r})
    by_name = {k["name"]: k for k in kernels}
    by_name["ring_accum_kernel"].update(lm_tp_pair_checks=lm_tp_rows["accum_pair_checks"])
    by_name["dequantize_sum_quantize_blocks_kernel"].update(
        entry_of="quantize_blocks_kernel",
        also_replaces="src/repro/core/compression.py:79-89 (phases 2 and 3)",
        main_path_step=ring_quant["quantize_step"])
    by_name["dequantize_sum_blocks_kernel"].update(
        entry_of="dequantize_blocks_kernel",
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
