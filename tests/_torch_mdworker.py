"""Multi-rank workers of the port's CPU checks, and their JAX counterpart.

    python tests/_torch_mdworker.py <workdir> <rank> <world> [MODE]
    python tests/_torch_mdworker.py <workdir> jax <rings|compressed|hier|inception|zero1|tp-*|serve-*|elastic|pp>
                                                  (tp-<mesh>+: SPLIT_REFERENCE's second part)

MODE: grads (the default), rings, compressed, hier, lm, inception, zero1,
tp-2x2, tp-1x4, tp-4x1, tp-ops, serve-2x2, serve-1x4, elastic, pp,
sendrecv, measure or close.

A port rank meets the other ranks on a gloo FileStore in ``workdir``:

  grads       (tests/test_torch_multirank.py, the default) reads the
              carried weights from ``workdir/params.npz`` and, for each
              (strategy, reducer) of ``CONFIGS``, computes its shard's
              ResNet smoke gradients, reduces them through the port's
              ``GradSync`` and writes them to ``<name>_rank<r>.npz``; for
              the compressed reducers also the local gradients before the
              reduction (``<name>_local_rank<r>.npz``) and, from rank 0,
              the leaves of each bucket (``<name>_buckets.json``).  Then
              the paper's KVStore depcha push/pull round trip: each rank
              pushes a power-of-two share of the values, so the pulled
              sums are exact; the pulled values, and what ``init``
              broadcast from rank 0, go to ``kvstore_rank<r>.npz``.
  rings       (tests/test_torch_ring.py) the ring reduce-scatter,
  compressed  all-gather and allreduce, or the compressed allreduce, over
              the seeded buffers of ``workdir/inputs.npz`` (row r is rank
              r's buffer); results to ``<mode>_rank<r>.npz``, for the
              compressed allreduce with the calls of ``CALLS`` counted a
              case (``calls_<case>``).

  hier        (tests/test_torch_hierarchical.py) on the ("pod", "data",
              "model") meshes of ``HIER_MESHES``: the flat, hierarchical
              and hierarchical_ring reducers over rank r's (1 + r) x
              ``inputs.npz["base"]``, as ``tests/_mdworker.py`` runs them,
              to ``hier_rank<r>.npz``; then GradSync's reduced smoke
              gradients for each of ``HIER_GRADS`` to ``<name>_rank<r>.npz``.

  lm          (tests/test_torch_overlap.py) the quickstart LM (``lm_config``)
              from ``workdir/lm_params.npz``: for each run of ``LM_RUNS``
              ``LM_STEPS`` (or 1) steps of ``make_train_step`` with AdamW
              and clip 1.0 over the rank's slice of ``TokenPipeline``;
              the losses, the in-backward collectives and the reduced
              gradients of each step, and the final params, to
              ``<run>_rank<r>.npz``; then the rank's local gradients at
              step 0, unreduced, to ``lm-local_rank<r>.npz``.

  inception   (tests/test_torch_multirank.py) the Inception-BN smoke
              config from ``workdir/inception_params.npz``: for each of
              ``INCEPTION_STRATEGIES``, ``INCEPTION_STEPS`` steps of
              ``make_train_step`` (SGD with momentum, clip 1.0) over the
              rank's slice of ``ImagePipeline``, each step's loss and
              params to ``inception-<strategy>_rank<r>.npz``; then the
              loss-scale round trip: the rank's ResNet smoke gradients
              (weights from ``params.npz``, as ``grads``) through
              ``GradSync`` at each of ``LOSS_SCALES``, to
              ``loss-scale-<scale>_rank<r>.npz``.

  zero1       (tests/test_torch_zero1_ranks.py) the reference's ZeRO-1
              parity model (``ZERO1_CFG``) from ``workdir/zero1_params.npz``:
              for each run of ``ZERO1_RUNS`` ``ZERO1_STEPS`` steps of
              ``make_train_step`` through ``Trainer`` (SGD with momentum)
              over the rank's slice of ``TokenPipeline``; the losses, grad
              norms, final params (a deferred run's flushed by
              ``finalize``), ``mem.state_bytes``, the params' bytes and
              the dp plan's bucket sizes to ``zero1-<run>_rank<r>.npz``;
              then whether ``make_train_step`` refuses zero1 with
              depcha's in-backward sum at dp 4 (``zero1-in-scan_rank<r>.npz``).

  tp-<mesh>   (tests/test_torch_tp.py) tensor parallelism on the
              ("data", "model") mesh ``TP_MESHES[<mesh>]``, the f32
              ``TP_CFG`` (the reference's ``mk_dense``) from
              ``workdir/tp_params.npz``, each rank holding its shards: for
              each (strategy, reducer) of ``TP_GRADS`` the loss (summed
              over "data") and the rank's reduced gradient shards, as
              ``tests/_mdworker.py::loss_and_grads`` computes them; one
              SGD step clipped at ``TP_CLIP`` (params, grad norm); on
              2x2 also ``TP_STEPS`` AdamW steps through ``Trainer``
              (depcha in-backward), the ZeRO-1 runs of ``TP_ZERO1``, and
              the hierarchical reducer's gradients on the pod mesh
              ``TP_POD_MESH``; on the meshes of ``FSDP_MESHES`` (4x1 is
              ``MESHES``' FSDP-only mesh, data 4 x model 1) FSDP's loss
              and gradient shards for each run of ``FSDP_GRADS``, check
              5's AdamW step, the clipped SGD step and the refusal of
              ZeRO-1 with FSDP; the MoE runs of ``MOE_RUNS`` (granite's
              and kimi's smoke configs at vocab 96, weights from
              ``moe-<arch>_params.npz``); to ``tp-<mesh>_rank<r>.npz``.
  tp-ops      (tests/test_torch_tp.py, test_torch_lm_train.py,
              test_torch_transformer.py) the vocab-sharded embedding and
              cross-entropy and the column/row-parallel matmuls over a
              model axis of ``world`` ranks, with their gradients, on
              the inputs of ``workdir/tp_ops.npz``, to
              ``tp-ops_rank<r>.npz``.

  serve-<mesh> (tests/test_torch_serve_tp.py) serving on the ("data",
              "model") mesh ``SERVE_MESHES[<mesh>]`` from the reference's
              weights in ``serve-<weights>_params.npz`` and the inputs of
              ``serve_inputs.npz``, each rank holding its shards
              (``_serve``): the engines' tokens and the logits of the
              rank's rows and vocab shard, the model functions' runs, the
              refusals at data 2, the samplers at model 4 and the
              padded-vocab witness at 2 x 2; to ``serve-<mesh>_rank<r>.npz``.

  elastic     (tests/test_torch_elastic.py) the reference elastic worker's
              model (``el_config``) from ``workdir/elastic_params.npz``
              over the ladder ``EL_LADDER`` (``EL_MESHES``: data 2 x model
              2 on the 4 ranks, data 2 x model 1 on ranks 0 and 1), ZeRO-1
              AdamW: the codec's round trips, the tp2 → tp1 → tp2 reshard,
              the transition plan, the Supervisor's faulty cycles and their
              clean replays (scheduled, deferred, the straggler shrink),
              the deferred plain-checkpoint resume and its guard on the
              2-rank rung, the plain path's refusal at tp 2, the world-rank
              repairs on a 2-rank mesh on ranks 2, 3 and on 0, 1
              (``SUB_RANKS``) and the KVStore's regroup; flags, losses and
              global params to ``elastic_rank<r>.npz``.

  pp          (tests/test_torch_pipeline.py) pipeline stages on the
              (data, stage, model) meshes of ``PP_MESHES``: for each run
              of ``PP_RUNS`` (gpipe and 1f1b staged, their stage-1 twins,
              the clipped step, the plain accumulation path, granite's
              MoE smoke config) ``PP_STEPS`` AdamW steps of
              ``make_train_step`` from ``pp_params.npz`` (granite's from
              ``pp-granite_params.npz``): losses, grad norms, hops and the
              rank's final param shards, the live process groups before
              and after (every step closed); a staged run recovered from
              its checkpoint against the same run uninterrupted; then
              ``pipeline_forward`` on four stages, both broadcasts; to
              ``pp_rank<r>.npz``.
  sendrecv    (tests/test_torch_pipeline_program.py) a SEND/RECV pair
              through ``execute`` on 2 and 4 stages, shift +1 and -1;
              what each rank received to ``sendrecv_rank<r>.npz``.

  measure     (tests/test_torch_measure.py) the measured per-op replay
              (``repro_torch.obs.measure``) at data 2 x model 2 on
              ``repro_torch.obs.cli.build_setup``'s stack, for each run of
              ``MEASURE_RUNS``: the schedule through ``GradSync`` (``execute``)
              and through ``measured_gradsync`` at reps 1 and 3 from the
              same gradients, whether their outputs (and a StepProgram's
              updates, grad norm and update shards) are bit-equal, and the
              measured Timeline's ops; to ``measure_rank<r>.npz``.

  close       (tests/test_torch_comms.py) build-step-close cycles of the
              runs of ``CLOSE_RUNS`` (concom on 4 channels, depcha's
              in-backward sync at tp 2, FSDP at 2 x 2), a regrouped
              ``KVStore`` and a ``GradSync``, counting the live process
              groups; to ``close_rank<r>.npz``.

``layer_sync_rank`` is one of 2 processes on ``cuda:0`` for
tests/test_torch_cuda.py: depcha's in-backward slot staging and the
order of its copy, collective and unpack.

``peer_rank`` is one of 2 or 4 processes on ``cuda:0`` for
tests/test_torch_cuda.py (spawned with torch.multiprocessing): the
peer-memory ring kernels against the plain rings, or a wait that runs out.

``jax`` runs the JAX package's functions on the same inputs on 4 fake CPU
devices (as ``tests/_mdworker.py`` does with 8) and writes
``<mode>_jax.npz`` with rank r's result in row r.  Only that mode imports
JAX.
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402

WORLD = 4
GLOBAL_BATCH = 8
SHARES = (0.125, 0.25, 0.125, 0.5)   # sum to 1 exactly, in any order
# (strategy, reducer) -> output name; the flat ones keep their strategy's name
CONFIGS = {
    ("funnel", "flat"): "funnel", ("concom", "flat"): "concom",
    ("depcha", "flat"): "depcha", ("rsag", "flat"): "rsag",
    ("funnel", "ring"): "funnel-ring", ("concom", "ring"): "concom-ring",
    ("depcha", "ring"): "depcha-ring", ("rsag", "ring"): "rsag-ring",
    ("funnel", "compressed"): "funnel-compressed",
    ("funnel", "compressed_ring"): "funnel-compressed_ring",
}
# ring cases: name -> (input key, ring of 4 or pairs of 2, bidirectional)
RING_CASES = {
    "rs_bidi": ("rs", 4, True), "rs_uni": ("rs", 4, False),
    "rs_c1": ("rs_c1", 4, True),           # half-chunk 0: the one-way path
    "ag_bidi": ("ag", 4, True), "ag_uni": ("ag", 4, False),
    "ar_bidi": ("ar", 4, True), "ar_uni": ("ar", 4, False),
    "rs2_bidi": ("rs2", 2, True), "rs2_uni": ("rs2", 2, False),
    "ag2_bidi": ("ag2", 2, True), "ar2_bidi": ("ar2", 2, True),
}
COMPRESSED_CASES = {"compressed": False, "compressed_ring": True}
# what the compressed mode counts a case: the calls of phases 2-3, and the
# calls the reducer no longer makes (the phase-2 sum alone, a padded copy)
CALLS = ("dequantize_sum_quantize_blocks", "dequantize_sum_blocks", "pad")
HIER_MESHES = {"2x2": (2, 2), "1x4": (1, 4)}            # (pods, data ranks a pod)
HIER_REDUCERS = ("flat", "hierarchical", "hierarchical_ring")
# (strategy, reducer, mesh) -> output name
HIER_GRADS = {(st, red, m): f"{st}-{red}-{m}"
              for st in ("funnel", "concom", "depcha")
              for red in ("hierarchical", "hierarchical_ring") for m in ("2x2",)}
HIER_GRADS.update({("funnel", red, "1x4"): f"funnel-{red}-1x4"
                   for red in ("hierarchical", "hierarchical_ring")})
LM_STEPS, LM_SEQ, LM_BATCH = 3, 64, 8
# run -> (strategy, GradSync reducer, (pods, data) or None, depcha_reducer, steps)
LM_RUNS = {
    "lm-funnel": ("funnel", "flat", None, "flat", LM_STEPS),
    "lm-concom": ("concom", "flat", None, "flat", LM_STEPS),
    "lm-depcha": ("depcha", "flat", None, "flat", LM_STEPS),
    "lm-depcha-hierarchical": ("depcha", "hierarchical", (2, 2), "hierarchical", 1),
    "lm-depcha-compressed": ("depcha", "flat", None, "compressed", 1),
    "lm-depcha-compressed-pods": ("depcha", "hierarchical", (2, 2), "compressed", 1),
}


# the reference's ZeRO-1 parity model (tests/test_pipelined.py), f32
ZERO1_CFG = dict(name="pipelined", n_layers=2, d_model=32, n_heads=4, kv_heads=2,
                 d_ff=64, vocab=64, tp=1, attn_chunk=16)
ZERO1_STEPS, ZERO1_SEQ, ZERO1_LR = 3, 16, 0.1
# run -> (zero1 plan or None, strategy, reducer, clip, microbatch)
ZERO1_RUNS = {
    "flat": (None, "concom", "flat", 0.0, 1),
    "scheduled": ("scheduled", "concom", "flat", 0.0, 1),
    "scheduled-ring": ("scheduled", "concom", "ring", 0.0, 1),
    "rsag-ring": ("scheduled", "rsag", "ring", 0.0, 1),
    "deferred": ("deferred", "concom", "flat", 0.0, 1),
    "monolithic": ("monolithic", "concom", "flat", 0.0, 1),
    "scheduled-clip": ("scheduled", "concom", "flat", 0.05, 1),
    "deferred-clip-m2": ("deferred", "concom", "flat", 0.05, 2),
}


# tensor parallelism: the reference's mk_dense (tests/_mdworker.py), f32
TP_CFG = dict(name="dense", n_layers=2, d_model=64, n_heads=8, kv_heads=2, d_ff=128,
              vocab=96, attn_chunk=16)
TP_MESHES = {"2x2": (2, 2), "1x4": (1, 4)}          # (data, model): kv 2 >= tp / < tp
TP_POD_MESH = (2, 1, 2)                            # (pod, data, model)
TP_SEQ, TP_BATCH, TP_SEED = 32, 4, 3
TP_SYNC = dict(bucket_bytes=1 << 12, num_channels=3)   # compare_tp's
# (strategy, reducer) -> run name; every registered strategy with flat
TP_GRADS = {(st, "flat"): st for st in ("funnel", "concom", "depcha", "priority", "rsag")}
TP_GRADS.update({("concom", red): red for red in ("ring", "compressed", "hierarchical")})
TP_STEPS, TP_LR, TP_CLIP = 3, 0.1, 0.05
# run -> zero1 plan (SGD with momentum, 2 steps), the last clipped at TP_CLIP
TP_ZERO1 = {"zero1-scheduled": "scheduled", "zero1-monolithic": "monolithic",
            "zero1-scheduled-clip": "scheduled"}


# FSDP (ZeRO-3 storage) and the MoE FFN on the tp spawns, and FSDP alone
# on data 4 x model 1 (mode tp-4x1)
MESHES = {**TP_MESHES, "4x1": (4, 1)}               # (data, model)
FSDP_MESHES = ("2x2", "4x1")
TP_STRATEGIES = ("funnel", "concom", "depcha", "priority", "rsag")
# mesh -> (strategy, reducer) -> run: every registered strategy with flat,
# and ring at 2 x 2
FSDP_GRADS = {m: {**{(st, "flat"): f"fsdp-{st}" for st in TP_STRATEGIES},
                  **({("concom", "ring"): "fsdp-ring"} if m == "2x2" else {})}
              for m in FSDP_MESHES}
FSDP_LR = 1e-3                                     # check 5's AdamW, unclipped
# meshes whose reference runs as two processes: tp-<mesh> and tp-<mesh>+
# (the FSDP and MoE gradients), so that neither is the spawn's long pole
SPLIT_REFERENCE = ("2x2",)
# the MoE archs' smoke configs, at vocab 96 (97 splits over no model axis)
MOE_ARCHS = {"granite": "granite-moe-1b-a400m", "kimi": "kimi-k2-1t-a32b"}
# mesh -> run -> (arch, strategy, fsdp): experts sharded over "model"
MOE_RUNS = {"2x2": {"moe-granite": ("granite", "concom", False),
                    "moe-granite-depcha": ("granite", "depcha", False),
                    "moe-granite-fsdp": ("granite", "concom", True),
                    "moe-kimi": ("kimi", "concom", False)},
            "1x4": {"moe-granite": ("granite", "concom", False)}}


# cross-attention (llama-3.2-vision), RWKV-6 and the Zamba2 hybrid on the
# tp spawns: their smoke configs at vocab 96 (so that it splits), the
# vision one with image embeddings of its 8 tokens, zamba2's also with 2
# kv heads (sliced from the replicated wk/wv at model 4); mesh -> run ->
# (kind, fsdp), each run under every strategy of XR_STRATEGIES, held to
# the reference's tp = 1 (computed by the tp-4x1 reference process)
XR_ARCHS = {"vision": "llama-3.2-vision-11b", "rwkv": "rwkv6-7b", "zamba2": "zamba2-2.7b",
            "zamba2-kv2": "zamba2-2.7b"}
XR_OVER = {"zamba2-kv2": {"kv_heads": 2}}
XR_STRATEGIES = ("funnel", "concom", "depcha")
XR_RUNS = {"4x1": {"vision": ("vision", False), "zamba2": ("zamba2", False)},
           "1x4": {"vision": ("vision", False), "rwkv": ("rwkv", False),
                   "zamba2": ("zamba2", False), "zamba2-kv2": ("zamba2-kv2", False)},
           "2x2": {"vision": ("vision", False), "vision-fsdp": ("vision", True),
                   "rwkv": ("rwkv", False), "zamba2": ("zamba2", False)}}


# serving on the ("data", "model") meshes of SERVE_MESHES (modes serve-2x2,
# serve-1x4; tests/test_torch_serve_tp.py): the reference's mk_serve
# (check 13 of tests/_mdworker.py), f32, with kv 4 (sharded over "model")
# and kv 2 (sliced at model 4), its prompt lengths, engines and budgets
SERVE_CFG = dict(name="dense", n_layers=2, d_model=64, n_heads=8, d_ff=128, vocab=96,
                 attn_chunk=16)
SERVE_MESHES = {"2x2": (2, 2), "1x4": (1, 4)}       # (data, model)
SERVE_LENS = (5, 12, 17, 3, 30, 9)
SERVE_NEW, SERVE_MAX_LEN, SERVE_SLOTS, SERVE_BLOCK, SERVE_CHUNK = 10, 64, 8, 16, 4
# the static engine's batch of rwkv's and zamba2's runs and the model
# functions' (MoE, cross-attention): prompt lengths padded to 13, off the
# dims the reference's _pad_cache would take for the prompt's (the heads
# of the recurrent states at tp 1, 2, 4, zamba2's conv 3, d_model 64)
SERVE_RECURRENT_LENS = (13, 7, 11, 5)
SERVE_FN_STEPS = 4
# mesh -> run -> (kind, weights, overrides): the engines' runs
SERVE_RUNS = {
    "2x2": {"kv4": ("dense", "kv4", {"kv_heads": 4}),
            "kv4-fsdp": ("dense", "kv4", {"kv_heads": 4, "fsdp": True}),
            "rwkv": ("rwkv", "rwkv", {}), "zamba2": ("zamba2", "zamba2", {})},
    "1x4": {"kv4": ("dense", "kv4", {"kv_heads": 4}),
            "kv2": ("dense", "kv2", {"kv_heads": 2}),
            "rwkv": ("rwkv", "rwkv", {}), "zamba2": ("zamba2", "zamba2", {})}}
# mesh -> run -> kind: prefill and decode_step called directly
SERVE_FN_RUNS = {"2x2": {"granite": "granite", "vision": "vision"}}
# the reference fault: qwen3's smoke vocab 97 at model 2 pads to 98 columns
SERVE_PAD_VOCAB = 97


# pipeline stages (tests/test_torch_pipeline.py): the reference's mk_pp
# (tests/_mdworker.py check 14: TP_CFG, f32) on (data, stage, model) meshes
PP_MESHES = {"1x2x2": (1, 2, 2), "2x2x1": (2, 2, 1)}
PP_SEQ, PP_BATCH, PP_SEED, PP_STEPS, PP_LR, PP_CLIP = 32, 8, 5, 2, 1e-3, 0.05
PP_SYNC = dict(strategy="concom", bucket_bytes=1 << 12)
# run -> (stage extent, schedule, M, clip, MoE arch): extent 1 is the
# stage = 1 twin on the first data x model ranks, 0 the plain
# accumulation path (no stage axis)
PP_RUNS = {
    "gpipe": (2, "gpipe", 4, 0.0, None),
    "gpipe-s1": (1, "gpipe", 4, 0.0, None),
    "1f1b-m2": (2, "1f1b", 2, 0.0, None),
    "gpipe-s1-m2": (1, "gpipe", 2, 0.0, None),
    "1f1b": (2, "1f1b", 4, 0.0, None),
    "1f1b-s1": (1, "1f1b", 4, 0.0, None),
    "clip": (2, "gpipe", 4, PP_CLIP, None),
    "plain": (0, None, 4, 0.0, None),
    "granite": (2, "gpipe", 4, 0.0, "granite"),
}
# the reference's runs: its staged gpipe and 1f1b (two chunks at M 4),
# its stage-1 clipped step at model 1 (the staged one's norm is its own
# fault, and at tp > 1 it clips by each model rank's shards: ROADMAP
# queue 3), granite and its plain accumulation path (no stage axis)
PP_REF_RUNS = ("gpipe", "1f1b", "clip-s1", "granite", "plain")
PP_MOE_MESHES = ("1x2x2",)           # granite's runs: experts over "model"
PP_FORWARD = (4, 6, 8)               # pipeline_forward's check: S, M, width


def pp_config(mesh_name: str, arch: str | None = None, ref: bool = False):
    """The pp runs' config at ``PP_MESHES[mesh_name]``'s model extent: mk_pp,
    or ``arch``'s MoE smoke config at vocab 96."""
    tp = PP_MESHES[mesh_name][2]
    return moe_config(arch, tp, ref=ref) if arch else tp_config(tp, ref=ref)


def serve_config(kind: str, tp: int, ref: bool = False, **over):
    """A serving run's config at ``tp`` in either package: ``dense`` is
    ``SERVE_CFG``, f32; the others the smoke configs at vocab 96
    (``xr_config``, ``moe_config``); ``qwen3-pad`` qwen3's smoke config at
    its own vocab, 97."""
    import dataclasses

    if kind == "dense":
        if ref:
            import jax.numpy as jnp

            from repro.models.transformer import TransformerConfig
            return TransformerConfig(**SERVE_CFG, tp=tp, dtype=jnp.float32, **over)
        import torch

        from repro_torch.models.transformer import TransformerConfig
        return TransformerConfig(**SERVE_CFG, tp=tp, dtype=torch.float32, **over)
    if kind == "granite":
        return moe_config("granite", tp, ref=ref, **over)
    if kind == "qwen3-pad":
        if ref:
            from repro.configs import get_arch
        else:
            from repro_torch.configs import get_arch
        return dataclasses.replace(get_arch("qwen3-1.7b").make_smoke(), tp=tp, **over)
    return xr_config(kind, tp, ref=ref, **over)


def serve_prompts() -> list:
    """Check 13's prompts (``tests/_mdworker.py``)."""
    rng = np.random.default_rng(11)
    return [rng.integers(1, 96, size=int(n)).astype(np.int32) for n in SERVE_LENS]


def left_padded(prompts) -> np.ndarray:
    """The batch ``RequestQueue`` builds: prompts left-padded with 0."""
    S = max(len(p) for p in prompts)
    out = np.zeros((len(prompts), S), np.int32)
    for i, p in enumerate(prompts):
        out[i, S - len(p):] = p
    return out


def serve_inputs() -> dict:
    """The serving runs' inputs: the engines' prompts, the recurrent runs'
    and model functions' batch, the cross-attention run's images, and
    check 13's sampler logits (``tie``: equal maxima on shards 1 and 3,
    and in row 0 a second one inside shard 1; ``rand``: normal, its row 2
    the tie row)."""
    rng = np.random.default_rng(5)
    recurrent = [rng.integers(1, 96, size=n).astype(np.int32) for n in SERVE_RECURRENT_LENS]
    v_local = 96 // 4
    tie = np.full((2, 96), -5.0, np.float32)
    tie[:, 1 * v_local + 3] = 7.0
    tie[:, 3 * v_local + 0] = 7.0
    tie[0, 1 * v_local + 5] = 7.0
    rand = np.random.default_rng(3).normal(size=(4, 96)).astype(np.float32)
    rand[2] = tie[0]
    return {"batch": left_padded(serve_prompts()), "recurrent": left_padded(recurrent),
            "img": rng.standard_normal((len(recurrent), 8, 64)).astype(np.float32),
            "tie": tie, "rand": rand}


def xr_config(kind: str, tp: int, **over):
    """``XR_ARCHS[kind]``'s smoke config at vocab 96 and ``tp`` (with
    ``XR_OVER[kind]``), in either package (``ref=True``); ``fsdp=False`` is
    the default of a family without the field."""
    if not over.get("fsdp", True):
        del over["fsdp"]
    return moe_config(kind, tp, archs=XR_ARCHS, **XR_OVER.get(kind, {}), **over)


def family_lib(cfg, ref: bool = False):
    """The model module of ``cfg``'s family (transformer, rwkv or ssm), in
    the port or in the reference (``ref=True``)."""
    if ref:
        from repro.models import rwkv, ssm
        from repro.models import transformer as tf
    else:
        from repro_torch.models import rwkv, ssm
        from repro_torch.models import transformer as tf
    return {rwkv.RWKVConfig: rwkv, ssm.SSMConfig: ssm}.get(type(cfg), tf)


def xr_extras(kind: str) -> dict:
    """The pipelines' extra inputs of a ``kind`` run: the vision config's
    image embeddings (its 8 tokens, d 64)."""
    return {"img_embeds": ((8, 64), np.float32)} if kind == "vision" else {}


def moe_config(arch: str, tp: int, **over):
    """``MOE_ARCHS[arch]``'s smoke config at vocab 96 and ``tp``, in
    either package (``ref=True``)."""
    import dataclasses

    ref = over.pop("ref", False)
    archs = over.pop("archs", MOE_ARCHS)
    if ref:
        from repro.configs import get_arch
    else:
        from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(archs[arch]).make_smoke(), vocab=96, tp=tp, **over)


def tp_config(tp: int, **over):
    """``TP_CFG`` at ``tp``, f32, in either package (``ref=True``)."""
    ref = over.pop("ref", False)
    if ref:
        import jax.numpy as jnp

        from repro.models.transformer import TransformerConfig
        return TransformerConfig(**TP_CFG, tp=tp, dtype=jnp.float32, **over)
    import torch

    from repro_torch.models.transformer import TransformerConfig
    return TransformerConfig(**TP_CFG, tp=tp, dtype=torch.float32, **over)


def tp_ops_inputs(seed: int = 0, **over) -> dict:
    """The ``tp-ops`` mode's inputs (``over`` replaces any): a 12-row
    vocab and 12 hidden units, so a model axis of 2, 3 or 4 splits them;
    ids and labels partly outside the vocab."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    out = dict(
        emb=rng.standard_normal((12, 8)).astype(f32),
        ids=rng.integers(-2, 14, (2, 5)).astype(np.int32),
        emb_cot=rng.standard_normal((2, 5, 8)).astype(f32),
        logits=(rng.standard_normal((2, 5, 12)) * 4).astype(f32),
        labels=rng.integers(-2, 14, (2, 5)).astype(np.int32),
        x=rng.standard_normal((2, 5, 8)).astype(f32),
        w1=(rng.standard_normal((8, 12)) / 3).astype(f32),
        w2=(rng.standard_normal((12, 8)) / 3).astype(f32),
        mlp_cot=rng.standard_normal((2, 5, 8)).astype(f32))
    out.update(over)
    return out


def run_tp_ops(workdir, world: int, **over) -> list[dict]:
    """``tp-ops`` over a model axis of ``world`` gloo ranks on
    ``tp_ops_inputs(**over)``; each rank's results."""
    np.savez(os.path.join(workdir, "tp_ops.npz"), **tp_ops_inputs(**over))
    run_all(workdir, "tp-ops", world=world)
    return [dict(np.load(os.path.join(workdir, f"tp-ops_rank{r}.npz")))
            for r in range(world)]


def zero1_sync(strategy: str, reducer: str, zero1: bool) -> dict:
    """GradSyncConfig's fields of a zero1 run, on both sides: several
    buckets a channel at the model's size."""
    return dict(strategy=strategy, reducer=reducer, num_channels=4, bucket_bytes=1 << 12,
                exclude_axes=("data",) if zero1 else ())


INCEPTION_STRATEGIES = ("funnel", "concom", "depcha")
INCEPTION_STEPS, INCEPTION_LR = 3, 0.1
LOSS_SCALES = (1.0, 1024.0, 1000.0)


def inception_sync(strategy: str = "concom", loss_scale: float = 1.0) -> dict:
    """GradSyncConfig's fields of the inception mode, on both sides:
    several buckets a channel at the smoke configs' sizes."""
    return dict(strategy=strategy, num_channels=4, bucket_bytes=1 << 12,
                loss_scale=loss_scale)


def lm_config(**over):
    """The quickstart LM's widths (examples/quickstart.py), f32."""
    import torch

    from repro_torch.models.transformer import TransformerConfig

    return TransformerConfig(name="quickstart-lm", n_layers=4, d_model=128, n_heads=8,
                             kv_heads=4, d_ff=256, vocab=512, tp=1, attn_chunk=64,
                             dtype=torch.float32, **over)


def _grads(workdir: str, rank: int) -> None:
    import torch

    from repro_torch.configs.resnet50_cifar import make_smoke
    from repro_torch.core import GradSync, GradSyncConfig, KVStore
    from repro_torch.data import ImagePipeline
    from repro_torch.launch.mesh import make_dp_mesh
    from repro_torch.models import resnet
    from repro_torch.utils.convert import params_from_numpy
    from repro_torch.utils.trees import flatten_with_names, tree_unflatten

    cfg = make_smoke()
    mesh = make_dp_mesh()
    named = dict(np.load(os.path.join(workdir, "params.npz")))
    batch = ImagePipeline(cfg.img_size, cfg.num_classes, GLOBAL_BATCH,
                          mesh=mesh, rank=rank, device="cpu").batch_at(0)
    for (strategy, reducer), name in CONFIGS.items():
        tree = params_from_numpy(named, "cpu")
        leaves, treedef = flatten_with_names(tree)
        for _, p in leaves:
            p.requires_grad_(True)
        resnet.train_forward(tree, batch, cfg).backward()
        gs = GradSync(GradSyncConfig(strategy=strategy, reducer=reducer,
                                     num_channels=4, bucket_bytes=64 * 1024),
                      mesh, resnet.param_specs(tree), tree, device="cpu")
        if reducer.startswith("compressed"):
            np.savez(os.path.join(workdir, f"{name}_local_rank{rank}.npz"),
                     **{n: p.grad.numpy().copy() for n, p in leaves})
            if rank == 0:
                with open(os.path.join(workdir, f"{name}_buckets.json"), "w") as f:
                    json.dump([[l.name for l in b.leaves]
                               for b in gs.plan.buckets], f)
        reduced = gs(tree_unflatten(treedef, [p.grad for _, p in leaves]))
        np.savez(os.path.join(workdir, f"{name}_rank{rank}.npz"),
                 **{n: g.numpy() for n, g in flatten_with_names(reduced)[0]})

    kv = KVStore.create("depcha", reduce_axes=("data",), num_channels=2,
                        mesh_shape=mesh.shape, device="cpu")
    values = {k: torch.ones(8, 8) * (k + 1) for k in range(4)}
    for key in range(4):
        kv.push(key, values[key] * SHARES[rank])
    pulled = {str(key): kv.pull(key).numpy() for key in range(4)}
    # paper Fig 4: every rank ends with rank 0's initial value
    pulled["init"] = kv.init(7, torch.full((3, 5), float(rank + 1))).numpy()
    np.savez(os.path.join(workdir, f"kvstore_rank{rank}.npz"), **pulled)


def _rings(workdir: str, rank: int) -> dict:
    import torch

    from repro_torch.core import dependency as dep
    from repro_torch.kernels.collectives import ops
    from repro_torch.parallel.sharding import Mesh

    inputs = dict(np.load(os.path.join(workdir, "inputs.npz")))
    cpu = torch.device("cpu")
    # a ring of 4 over "data"; rings of 2 over "ring" (ranks {0, 1}, {2, 3})
    groups = {4: dep.mesh_comms([0], [("data",)], Mesh(("data",), {"data": WORLD}), cpu)[0],
              2: dep.mesh_comms([0], [("ring",)],
                                Mesh(("pair", "ring"), {"pair": WORLD // 2, "ring": 2}),
                                cpu)[0]}
    fns = {"rs": ops.ring_reduce_scatter, "ag": ops.ring_all_gather,
           "ar": ops.ring_allreduce}
    out = {}
    for case, (key, g, bidi) in RING_CASES.items():
        axis = "data" if g == 4 else "ring"
        x = torch.from_numpy(inputs[key][rank])
        out[case] = fns[key[:2]](x, (axis,), {axis: g}, groups[g],
                                 bidirectional=bidi).numpy()
    return out


def _compressed(workdir: str, rank: int) -> dict:
    import torch

    from repro_torch.core import compression
    from repro_torch.core import dependency as dep
    from repro_torch.kernels import quantize
    from repro_torch.kernels.quantize import ops as quant_ops
    from repro_torch.parallel.sharding import Mesh

    x = np.load(os.path.join(workdir, "inputs.npz"))["compressed"][rank]
    comms = dep.mesh_comms([0], [("data",)], Mesh(("data",), {"data": WORLD}),
                           torch.device("cpu"))[0]
    counts = dict.fromkeys(CALLS, 0)

    def counted(module, name, key):
        fn = getattr(module, name)

        def wrapped(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        setattr(module, name, wrapped)

    # every name the reducer could reach them by (the plain version on the
    # CPU zero-fills its own buffer, without F.pad)
    counted(compression, "dequantize_sum_quantize_blocks", "dequantize_sum_quantize_blocks")
    for module in (quantize, quant_ops):
        counted(module, "dequantize_sum_blocks", "dequantize_sum_blocks")
    counted(torch.nn.functional, "pad", "pad")
    out = {}
    for case, use_ring in COMPRESSED_CASES.items():
        counts.update(dict.fromkeys(CALLS, 0))
        out[case] = compression.compressed_allreduce(
            torch.from_numpy(x), ("data",), {"data": WORLD}, comms,
            use_ring=use_ring).numpy()
        out[f"calls_{case}"] = np.array([counts[k] for k in CALLS])
    return out


def _hier(workdir: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.configs.resnet50_cifar import make_smoke
    from repro_torch.core import Bucket, GradSync, GradSyncConfig, LeafInfo, make_reducer
    from repro_torch.core import dependency as dep
    from repro_torch.data import ImagePipeline
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.models import resnet
    from repro_torch.utils.convert import params_from_numpy
    from repro_torch.utils.trees import flatten_with_names, tree_unflatten

    base = np.load(os.path.join(workdir, "inputs.npz"))["base"]
    x = base * np.float32(1 + rank)
    axes = ("pod", "data", "model")
    bucket = Bucket(leaves=(LeafInfo(name="x", index=0, shape=x.shape,
                                     dtype=torch.float32, size=x.size),),
                    reduce_axes=axes, channel=0, bucket_id=0)
    out = {}
    for m, (pods, data) in HIER_MESHES.items():
        mesh = make_pod_mesh(pods, data)
        comms = dep.mesh_comms([0], [axes], mesh, torch.device("cpu"))[0]
        comms.pod = dep.pod_comms([0], pods, data, torch.device("cpu"))[0]
        for red in HIER_REDUCERS:
            fn = make_reducer(red, dict(mesh.shape), mean_axes=("pod", "data"))
            out[f"{red}_{m}"] = fn(torch.from_numpy(x.copy()), bucket, comms).wait().numpy()
    np.savez(os.path.join(workdir, f"hier_rank{rank}.npz"), **out)

    cfg = make_smoke()
    named = dict(np.load(os.path.join(workdir, "params.npz")))
    for (strategy, reducer, m), name in HIER_GRADS.items():
        mesh = make_pod_mesh(*HIER_MESHES[m])
        batch = ImagePipeline(cfg.img_size, cfg.num_classes, GLOBAL_BATCH,
                              mesh=mesh, rank=rank, device="cpu").batch_at(0)
        tree = params_from_numpy(named, "cpu")
        leaves, treedef = flatten_with_names(tree)
        for _, p in leaves:
            p.requires_grad_(True)
        resnet.train_forward(tree, batch, cfg).backward()
        gs = GradSync(GradSyncConfig(strategy=strategy, reducer=reducer,
                                     num_channels=4, bucket_bytes=64 * 1024),
                      mesh, resnet.param_specs(tree), tree, device="cpu")
        reduced = gs(tree_unflatten(treedef, [p.grad for _, p in leaves]))
        np.savez(os.path.join(workdir, f"{name}_rank{rank}.npz"),
                 **{n: g.numpy() for n, g in flatten_with_names(reduced)[0]})


def _lm(workdir: str, rank: int) -> None:
    from repro_torch.core import GradSyncConfig, get_strategy
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import make_dp_mesh, make_pod_mesh
    from repro_torch.models.transformer import Transformer, train_forward
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.parallel.sharding import dp_axes_of
    from repro_torch.runtime import make_train_step
    from repro_torch.utils.convert import params_from_numpy
    from repro_torch.utils.trees import flatten_with_names

    named = dict(np.load(os.path.join(workdir, "lm_params.npz")))
    for run, (strategy, reducer, layout, depcha_reducer, steps) in LM_RUNS.items():
        mesh = make_pod_mesh(*layout) if layout else make_dp_mesh()
        cfg = lm_config(dp_axes=dp_axes_of(mesh),
                        depcha_in_scan=get_strategy(strategy).uses_in_scan,
                        depcha_reducer=depcha_reducer, intra_size=mesh.shape["data"])
        model = Transformer(cfg, params_from_numpy(named, "cpu"))
        opt = adamw(cosine_warmup(1e-3, 20, 200))
        ts = make_train_step(cfg, mesh, GradSyncConfig(strategy=strategy, reducer=reducer,
                                                       num_channels=4, bucket_bytes=1 << 16),
                             opt, model=model, clip_norm=1.0, device="cpu")
        pipe = TokenPipeline(cfg.vocab, LM_SEQ, LM_BATCH, mesh=mesh, rank=rank, device="cpu")
        params = flatten_with_names(model.params_tree())[0]
        state = opt.init(dict(params))
        out = {}
        for step in range(steps):
            model, state, m = ts.fn(model, state, pipe.batch_at(step), step)
            out[f"loss/{step}"] = m["loss"].numpy()
            out[f"collectives/{step}"] = np.array(
                ts.layer_sync.collectives if ts.layer_sync is not None else 0)
            out.update({f"grad{step}/{n}": p.grad.numpy().copy() for n, p in params})
        out.update({f"param/{n}": p.detach().numpy() for n, p in params})
        np.savez(os.path.join(workdir, f"{run}_rank{rank}.npz"), **out)

    # the rank's own gradients, unreduced (the compressed bound's inputs)
    cfg = lm_config()
    tree = params_from_numpy(named, "cpu")
    leaves = flatten_with_names(tree)[0]
    for _, p in leaves:
        p.requires_grad_(True)
    batch = TokenPipeline(cfg.vocab, LM_SEQ, LM_BATCH, mesh=make_dp_mesh(), rank=rank,
                          device="cpu").batch_at(0)
    train_forward(tree, batch, cfg).backward()
    np.savez(os.path.join(workdir, f"lm-local_rank{rank}.npz"),
             **{n: p.grad.numpy() for n, p in leaves})


def _inception(workdir: str, rank: int) -> None:
    from repro_torch.configs.inception_bn_imagenet import make_smoke
    from repro_torch.configs.resnet50_cifar import make_smoke as make_resnet_smoke
    from repro_torch.core import GradSync, GradSyncConfig
    from repro_torch.data import ImagePipeline
    from repro_torch.launch.mesh import make_dp_mesh
    from repro_torch.models import resnet
    from repro_torch.optim import sgd
    from repro_torch.runtime import make_train_step
    from repro_torch.utils.convert import params_from_numpy
    from repro_torch.utils.trees import flatten_with_names, tree_unflatten

    cfg = make_smoke()
    mesh = make_dp_mesh()
    named = dict(np.load(os.path.join(workdir, "inception_params.npz")))
    pipe = ImagePipeline(cfg.img_size, cfg.num_classes, GLOBAL_BATCH, mesh=mesh,
                         rank=rank, device="cpu")
    for strategy in INCEPTION_STRATEGIES:
        model = resnet.Inception(cfg, params_from_numpy(named, "cpu"))
        opt = sgd(INCEPTION_LR, momentum=0.9)
        ts = make_train_step(cfg, mesh, GradSyncConfig(**inception_sync(strategy)),
                             opt, model=model, clip_norm=1.0, device="cpu")
        params = flatten_with_names(model.params_tree())[0]
        state = opt.init(dict(params))
        out = {}
        for step in range(INCEPTION_STEPS):
            model, state, m = ts.fn(model, state, pipe.batch_at(step), step)
            out[f"loss/{step}"] = m["loss"].numpy()
            out.update({f"param{step}/{n}": p.detach().numpy().copy() for n, p in params})
        np.savez(os.path.join(workdir, f"inception-{strategy}_rank{rank}.npz"), **out)

    # the loss-scale round trip: the same local gradients at every scale
    cfg = make_resnet_smoke()
    tree = params_from_numpy(dict(np.load(os.path.join(workdir, "params.npz"))), "cpu")
    leaves, treedef = flatten_with_names(tree)
    for _, p in leaves:
        p.requires_grad_(True)
    batch = ImagePipeline(cfg.img_size, cfg.num_classes, GLOBAL_BATCH, mesh=mesh,
                          rank=rank, device="cpu").batch_at(0)
    resnet.train_forward(tree, batch, cfg).backward()
    for scale in LOSS_SCALES:
        grads = tree_unflatten(treedef, [p.grad.clone() for _, p in leaves])
        gs = GradSync(GradSyncConfig(**inception_sync(loss_scale=scale)), mesh,
                      resnet.param_specs(tree), tree, device="cpu")
        reduced = gs(grads)
        np.savez(os.path.join(workdir, f"loss-scale-{scale}_rank{rank}.npz"),
                 **{n: g.numpy() for n, g in flatten_with_names(reduced)[0]})


def _zero1(workdir: str, rank: int) -> None:
    import copy

    import torch

    from repro_torch.core import GradSyncConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import make_dp_mesh
    from repro_torch.models.transformer import Transformer, TransformerConfig
    from repro_torch.optim import sgd, zero1
    from repro_torch.runtime import Trainer, make_train_step
    from repro_torch.utils.convert import params_from_numpy
    from repro_torch.utils.trees import flatten_with_names

    named = dict(np.load(os.path.join(workdir, "zero1_params.npz")))
    mesh = make_dp_mesh()
    cfg = TransformerConfig(**ZERO1_CFG, dtype=torch.float32)
    for run, (plan, strategy, reducer, clip, mb) in ZERO1_RUNS.items():
        model = Transformer(cfg, params_from_numpy(named, "cpu"))
        opt = sgd(ZERO1_LR, momentum=0.9)
        if plan is not None:
            opt = zero1(opt, ("data",), WORLD)
        ts = make_train_step(cfg, mesh, GradSyncConfig(**zero1_sync(strategy, reducer, plan)),
                             opt, model=model, clip_norm=clip, zero1_mode=plan is not None,
                             zero1_plan=plan or "scheduled", microbatch=mb, device="cpu")
        pipe = TokenPipeline(cfg.vocab, ZERO1_SEQ, GLOBAL_BATCH, seed=7, mesh=mesh, rank=rank,
                             device="cpu")
        trainer = Trainer(ts, pipe, log_every=ZERO1_STEPS, printer=lambda _s: None)
        model, state, hist = trainer.run(model, ts.init_opt(), ZERO1_STEPS)
        if ts.finalize is not None:
            model = ts.finalize(copy.deepcopy(model), copy.deepcopy(state))
        params = flatten_with_names(model.params_tree())[0]
        out = {f"param/{n}": p.detach().numpy() for n, p in params}
        out.update({f"loss/{k}": np.float32(v) for k, v in enumerate(hist["losses"])})
        out["grad_norm"] = np.float32(hist["metrics"]["grad_norm"])
        out["state_bytes"] = np.int64(hist["metrics"]["mem.state_bytes"])
        out["param_bytes"] = np.int64(sum(p.numel() * p.element_size() for _, p in params))
        if ts.gradsync.dp_plan is not None:
            out["bucket_sizes"] = np.array([b.size for b in ts.gradsync.dp_plan.buckets])
        ts.close()
        np.savez(os.path.join(workdir, f"zero1-{run}_rank{rank}.npz"), **out)

    # zero1 with depcha's in-backward sum at dp 4: the port refuses
    model = Transformer(TransformerConfig(**ZERO1_CFG, dtype=torch.float32,
                                          depcha_in_scan=True), params_from_numpy(named, "cpu"))
    try:
        make_train_step(model.cfg, mesh, GradSyncConfig(**zero1_sync("depcha", "flat", True)),
                        zero1(sgd(ZERO1_LR), ("data",), WORLD), model=model, zero1_mode=True,
                        device="cpu")
        refused = ""
    except ValueError as e:
        refused = str(e)
    np.savez(os.path.join(workdir, f"zero1-in-scan_rank{rank}.npz"), refused=np.array(refused))


def _tp(workdir: str, rank: int, mesh_name: str) -> None:
    import copy
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.core import GradSync, GradSyncConfig, get_strategy
    from repro_torch.core import dependency as dep
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import make_pod_mesh, make_smoke_mesh
    from repro_torch.models.common import fsdp_axes, model_axis
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import family_of
    from repro_torch.optim import adamw, sgd, zero1
    from repro_torch.runtime import Trainer, make_train_step
    from repro_torch.utils.convert import params_from_numpy
    from repro_torch.utils.trees import flatten_with_names, tree_unflatten

    data, model = MESHES[mesh_name]
    mesh = make_smoke_mesh(data, model)
    named = dict(np.load(os.path.join(workdir, "tp_params.npz")))
    axis = model_axis(mesh, "cpu")
    dp_group = dep.coset_groups([("data",)], mesh, torch.device("cpu"))[
        dep.reduce_key(("data",), mesh)]
    out = {}

    def rules(cfg):
        return family_lib(cfg).param_rules(cfg)

    def local_params(cfg, m=mesh, weights=named):
        return params_from_numpy(weights, "cpu", mesh=m, rank=rank, rules=rules(cfg))

    def pipe(m=mesh, extras=None):
        return TokenPipeline(TP_CFG["vocab"], TP_SEQ, TP_BATCH, seed=TP_SEED, mesh=m,
                             rank=rank, extra_specs=extras, device="cpu")

    def grads(strategy, reducer, m, ax, dp, cfg, weights=named, run=None, extras=None):
        in_scan = get_strategy(strategy).uses_in_scan
        cfg = dataclasses.replace(cfg, depcha_in_scan=in_scan)
        api = family_of(cfg)
        tree = local_params(cfg, m, weights)
        leaves, treedef = flatten_with_names(tree)
        for _, p in leaves:
            p.requires_grad_(True)
        ls = api.layer_sync(cfg, tree, m, "cpu") if in_scan else None
        gs = GradSync(GradSyncConfig(strategy=strategy, reducer=reducer, **TP_SYNC), m,
                      api.param_specs(tree, cfg), tree, device="cpu",
                      in_scan_names=api.in_scan_names(tree) if in_scan else frozenset())
        kw = {"fsdp": fsdp_axes(m, cfg.dp_axes, "cpu")} if getattr(cfg, "fsdp", False) else {}
        if ls is not None:
            ls.begin()
        loss = api.train_forward(tree, pipe(m, extras).batch_at(0), cfg, layer_sync=ls,
                                 model_axis=ax, **kw)
        (loss / cfg.tp).backward()
        if ls is not None:
            ls.finish([dict(leaves)[n] for n in ls.names])
        reduced = gs(tree_unflatten(treedef, [p.grad for _, p in leaves]))
        loss = loss.detach()
        if dp is not None:
            dep.collective(dist.all_reduce, dp, loss).wait()
        if run is not None:
            # the leaves GradSync buckets, and those depcha passes through
            bucketed = sorted(l.name for b in gs.plan.buckets for l in b.leaves)
            out[f"{run}/bucketed"] = np.array(bucketed or [""])
            if ls is not None:
                out[f"{run}/passthrough"] = np.array(sorted(ls.passthrough) or [""])
        return loss, reduced

    def save_grads(run, loss, reduced):
        out[f"{run}/loss"] = loss.numpy()
        out.update({f"{run}/grad/{n}": g.numpy() for n, g in flatten_with_names(reduced)[0]})

    cfg = tp_config(model, dp_axes=("data",))
    fcfg = tp_config(model, dp_axes=("data",), fsdp=True)
    out["batch"] = pipe().batch_at(0)["tokens"].numpy()
    out.update({f"shard/{n}": p.numpy()
                for n, p in flatten_with_names(local_params(cfg))[0]})
    for (strategy, reducer), name in (TP_GRADS.items() if mesh_name in TP_MESHES else ()):
        save_grads(name, *grads(strategy, reducer, mesh, axis, dp_group, cfg))
    for (strategy, reducer), name in FSDP_GRADS.get(mesh_name, {}).items():
        save_grads(name, *grads(strategy, reducer, mesh, axis, dp_group, fcfg, run=name))
    for run, (arch, strategy, fsdp) in MOE_RUNS.get(mesh_name, {}).items():
        weights = dict(np.load(os.path.join(workdir, f"moe-{arch}_params.npz")))
        save_grads(run, *grads(strategy, "flat", mesh, axis, dp_group,
                               moe_config(arch, model, fsdp=fsdp), weights))
    for run, (kind, fsdp) in XR_RUNS.get(mesh_name, {}).items():
        weights = dict(np.load(os.path.join(workdir, f"xr-{kind}_params.npz")))
        for strategy in XR_STRATEGIES:
            save_grads(f"xr-{run}-{strategy}", *grads(
                strategy, "flat", mesh, axis, dp_group, xr_config(kind, model, fsdp=fsdp),
                weights, extras=xr_extras(kind)))

    def train(run, opt, *, clip, steps, strategy="concom", plan=None, base=cfg):
        c = dataclasses.replace(base, depcha_in_scan=get_strategy(strategy).uses_in_scan)
        m = tf.Transformer(c, local_params(c))
        sync = GradSyncConfig(strategy=strategy, exclude_axes=("data",) if plan else (),
                              **TP_SYNC)
        ts = make_train_step(c, mesh, sync, opt, model=m, clip_norm=clip,
                             zero1_mode=plan is not None, zero1_plan=plan or "scheduled",
                             device="cpu")
        trainer = Trainer(ts, pipe(), log_every=steps, printer=lambda _s: None)
        m, state, hist = trainer.run(m, ts.init_opt(), steps)
        if ts.finalize is not None:
            m = ts.finalize(copy.deepcopy(m), copy.deepcopy(state))
        ts.close()
        out.update({f"{run}/loss/{k}": np.float32(v) for k, v in enumerate(hist["losses"])})
        out[f"{run}/grad_norm"] = np.float32(hist["metrics"]["grad_norm"])
        out.update({f"{run}/param/{n}": p.detach().numpy()
                    for n, p in flatten_with_names(m.params_tree())[0]})

    if mesh_name in FSDP_MESHES:
        # check 5: one concom AdamW step, unclipped; then the clipped step
        train("fsdp-step", adamw(FSDP_LR), clip=0.0, steps=1, base=fcfg)
        train("fsdp-clip", sgd(TP_LR), clip=TP_CLIP, steps=1, base=fcfg)
        try:
            make_train_step(fcfg, mesh, GradSyncConfig(strategy="concom", **TP_SYNC),
                            zero1(sgd(TP_LR), ("data",), data), zero1_mode=True,
                            model=tf.Transformer(fcfg, local_params(fcfg)), device="cpu")
            out["fsdp-zero1-refused"] = np.array(False)
        except ValueError as e:
            out["fsdp-zero1-refused"] = np.array("ZeRO-1 with FSDP" in str(e))
    if mesh_name not in TP_MESHES:
        np.savez(os.path.join(workdir, f"tp-{mesh_name}_rank{rank}.npz"), **out)
        return
    train("clip", sgd(TP_LR), clip=TP_CLIP, steps=1)
    # the paper's KVStore over the ranks of this rank's data coordinate
    from repro_torch.core import KVStore

    kv = KVStore("depcha", reduce_axes=("model",), mesh_shape=dict(mesh.shape), device="cpu")
    kv.push(0, torch.full((5,), float(rank + 1)))
    out["kvstore"] = kv.pull(0).numpy()
    if mesh_name == "2x2":
        train("adamw", adamw(1e-3), clip=0.0, steps=TP_STEPS, strategy="depcha")
        for run, plan in TP_ZERO1.items():
            clip = TP_CLIP if run.endswith("-clip") else 0.0
            opt = sgd(TP_LR) if clip else sgd(TP_LR, momentum=0.9)
            train(run, zero1(opt, ("data",), data), clip=clip, steps=1 if clip else 2,
                  plan=plan)
        # the hierarchical reducer on pod 2 x data 1 x model 2: the pod
        # stages at the rank's model coordinate, then a psum over "model"
        pm = make_pod_mesh(*TP_POD_MESH)
        out["pod/batch"] = pipe(pm).batch_at(0)["tokens"].numpy()
        pax = model_axis(pm, "cpu")
        pdp = dep.coset_groups([("pod", "data")], pm, torch.device("cpu"))[
            dep.reduce_key(("pod", "data"), pm)]
        for strategy in ("concom", "depcha"):
            pcfg = tp_config(TP_POD_MESH[2], dp_axes=("pod", "data"),
                             depcha_reducer="hierarchical", intra_size=TP_POD_MESH[1])
            loss, reduced = grads(strategy, "hierarchical", pm, pax, pdp, pcfg)
            run = f"pod-{strategy}"
            out[f"{run}/loss"] = loss.numpy()
            out.update({f"{run}/grad/{n}": g.numpy() for n, g in flatten_with_names(reduced)[0]})
        out.update({f"pod/shard/{n}": p.numpy()
                    for n, p in flatten_with_names(local_params(pcfg, pm))[0]})
    np.savez(os.path.join(workdir, f"tp-{mesh_name}_rank{rank}.npz"), **out)


def _serve(workdir: str, rank: int, mesh_name: str) -> None:
    """Serving on the mesh ``SERVE_MESHES[mesh_name]``, each rank holding
    its shards of the weights in ``serve-<weights>_params.npz`` (the
    reference's global trees): for each run of ``SERVE_RUNS`` the static
    engine's tokens on the run's batch, the logits of the rank's rows
    and vocab shard at its prefill and each decode step, and the decode
    state a prefill of the rank's rows leaves; for the dense
    runs also the continuous engine on check 13's prompts, each prompt
    alone through the static engine, and (kv4) check 13's sampling runs
    through the continuous engine; the runs of ``SERVE_FN_RUNS`` through
    ``prefill``/``decode_step``; at data 2 the refusals of a batch or
    slots that dp does not divide; at model 4 the samplers on check 13's
    logits; at 2 x 2 the padded-vocab witness.  Results to
    ``serve-<mesh>_rank<r>.npz``."""
    import dataclasses

    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.common import model_all_gather
    from repro_torch.parallel.sharding import dp_index
    from repro_torch.runtime import (ContinuousScheduler, SamplingParams, Server,
                                     sharded_argmax, sharded_candidates, sharded_sample)
    from repro_torch.runtime.serve_loop import draw_generator
    from repro_torch.utils.convert import params_from_numpy

    data, model = SERVE_MESHES[mesh_name]
    mesh = make_smoke_mesh(data, model)
    inp = dict(np.load(os.path.join(workdir, "serve_inputs.npz")))
    prompts = serve_prompts()
    d = dp_index(rank, mesh)
    out = {}

    def weights(name):
        return dict(np.load(os.path.join(workdir, f"serve-{name}_params.npz")))

    def local(cfg, named):
        return params_from_numpy(named, "cpu", mesh=mesh, rank=rank,
                                 rules=family_lib(cfg).param_rules(cfg))

    def recording(server):
        """The server's prefill and decode_step outputs' logits, kept."""
        api, logs = server.api, []

        def rec(fn):
            def call(*a, **kw):
                res = fn(*a, **kw)
                logs.append(res[0].clone())
                return res
            return call

        server.api = dataclasses.replace(api, prefill=rec(api.prefill),
                                         decode_step=rec(api.decode_step))
        return logs

    for run, (kind, wname, over) in SERVE_RUNS[mesh_name].items():
        cfg = serve_config(kind, model, dp_axes=("data",), **over)
        srv = Server(cfg, mesh, local(cfg, weights(wname)), max_len=SERVE_MAX_LEN)
        batch = inp["batch"] if kind == "dense" else inp["recurrent"]
        api, logs = srv.api, recording(srv)
        out[f"{run}/static"] = srv.generate(batch, SERVE_NEW)
        srv.api = api
        out.update({f"{run}/logits/{t}": lg.numpy() for t, lg in enumerate(logs)})
        rows = slice(d * len(batch) // data, (d + 1) * len(batch) // data)
        _, state = family_lib(cfg).prefill(srv.params, torch.from_numpy(batch[rows]), cfg,
                                           **srv.fwd_kw)
        out.update({f"{run}/state/{n}": t.numpy() for n, t in state.items()})
        if kind == "dense":
            eng = ContinuousScheduler(srv, slots=SERVE_SLOTS, block_size=SERVE_BLOCK,
                                      chunk=SERVE_CHUNK)
            for i, o in enumerate(eng.generate_batch(prompts, SERVE_NEW)):
                out[f"{run}/cont/{i}"] = o
            for i, p in enumerate(prompts):       # a row a dp rank, as check 13's
                out[f"{run}/alone/{i}"] = srv.generate(np.tile(p[None], (data, 1)),
                                                       SERVE_NEW)[0]
            if run == "kv4":
                for name, sp in (("s42a", SamplingParams(0.8, 8, 1.0, 42)),
                                 ("s42b", SamplingParams(0.8, 8, 1.0, 42)),
                                 ("s9", SamplingParams(0.8, 8, 1.0, 9)),
                                 ("k1", SamplingParams(0.9, 1, 1.0, 3))):
                    for i, o in enumerate(eng.generate_batch(prompts[:3], SERVE_NEW, sp)):
                        out[f"{run}/{name}/{i}"] = o
            if data > 1:
                for what, call in (
                        ("batch", lambda: srv.generate(batch[:data + 1], 2)),
                        ("slots", lambda: ContinuousScheduler(srv, slots=data + 1))):
                    try:
                        call()
                        out[f"{run}/refused/{what}"] = np.array("")
                    except ValueError as e:
                        out[f"{run}/refused/{what}"] = np.array(str(e))
        srv.close()

    axis = None
    if SERVE_FN_RUNS.get(mesh_name) or model == 4:
        from repro_torch.models.common import model_axis

        axis = model_axis(mesh, "cpu")

    def greedy_loop(cfg, params, toks, kw, steps):
        """prefill, then ``steps`` greedy decode steps over a cache grown
        to SERVE_MAX_LEN: each step's logits and the tokens."""
        lib = family_lib(cfg)
        S = toks.shape[1]
        logits, cache = lib.prefill(params, toks, cfg, **kw)
        logs, tokens = [logits], []
        for t in range(steps):
            tok = sharded_argmax(logits, cfg.tp, axis)
            tokens.append(tok)
            if t == 0:
                cache = {n: F.pad(c, (0, 0, 0, 0, 0, SERVE_MAX_LEN - S)) for n, c in
                         cache.items()}
            logits, cache = lib.decode_step(params, cache, tok, S + t, cfg, **kw)
            logs.append(logits)
        return logs, torch.stack(tokens, 1)

    rows = slice(d * len(inp["recurrent"]) // data, (d + 1) * len(inp["recurrent"]) // data)
    toks = torch.from_numpy(inp["recurrent"][rows])
    for run, kind in SERVE_FN_RUNS.get(mesh_name, {}).items():
        cfg = serve_config(kind, model, dp_axes=("data",))
        kw = {"model_axis": axis}
        if kind == "vision":
            kw["img_embeds"] = torch.from_numpy(inp["img"][rows])
        logs, tokens = greedy_loop(cfg, local(cfg, weights(kind)), toks, kw, SERVE_FN_STEPS)
        out.update({f"{run}/logits/{t}": lg.numpy() for t, lg in enumerate(logs)})
        out[f"{run}/tokens"] = tokens.numpy()

    if mesh_name == "2x2":
        # the padded vocab: column 97 of lm_head is drawn, and nothing
        # masks it; doubling column k*'s weights into it (k* row 0's
        # greedy pick among the 97 real ids) makes id 97 the pick
        cfg = serve_config("qwen3-pad", model, dp_axes=("data",))
        named = weights("qwen3-pad")
        logits, _ = family_lib(cfg).prefill(local(cfg, named), torch.from_numpy(
            inp["recurrent"]), cfg, model_axis=axis)
        every = model_all_gather(logits, axis)
        k = int(torch.argmax(every[0, :SERVE_PAD_VOCAB]))
        named["lm_head"] = named["lm_head"].copy()
        named["lm_head"][:, SERVE_PAD_VOCAB] = 2 * named["lm_head"][:, k]
        srv = Server(cfg, mesh, local(cfg, named), max_len=SERVE_MAX_LEN)
        out["pad/k"] = np.array(k)
        out["pad/logit_k"] = every[0, k].numpy()
        out["pad/tokens"] = srv.generate(inp["recurrent"], 2)
        srv.close()

    if model == 4:
        cols = slice(axis.index * 24, (axis.index + 1) * 24)
        tie = torch.from_numpy(inp["tie"][:, cols])
        rand = torch.from_numpy(inp["rand"][:, cols])
        B = rand.shape[0]
        out["sample/argmax_tie"] = sharded_argmax(tie, 4, axis).numpy()
        out["sample/argmax_rand"] = sharded_argmax(rand, 4, axis).numpy()
        vals, ids = sharded_candidates(rand, 4, axis)
        out["sample/cand_vals"], out["sample/cand_ids"] = vals.numpy(), ids.numpy()

        def draws(seed, temp, top_k, top_p=1.0, positions=8):
            return np.stack([sharded_sample(
                rand, 4, [draw_generator(seed, pos, "cpu") for _ in range(B)],
                torch.full((B,), temp), torch.full((B,), top_k, dtype=torch.int32),
                torch.full((B,), top_p), axis).numpy() for pos in range(positions)])

        out["sample/temp0"] = draws(0, 0.0, 0, positions=1)[0]
        out["sample/topk1"] = draws(3, 0.9, 1)
        out["sample/s42a"], out["sample/s42b"] = draws(42, 0.8, 8), draws(42, 0.8, 8)
        out["sample/s9"] = draws(9, 0.8, 8)
        out["sample/unbounded"] = draws(1, 5.0, 0, positions=64)
    if axis is not None:
        dist.destroy_process_group(axis.group)
    np.savez(os.path.join(workdir, f"serve-{mesh_name}_rank{rank}.npz"), **out)


def _tp_ops(workdir: str, rank: int, world: int) -> None:
    """The model-axis building blocks over a model axis of ``world`` ranks
    (mesh data 1 x model world), each with its gradient."""
    import torch

    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.common import model_axis
    from repro_torch.models import common

    inp = dict(np.load(os.path.join(workdir, "tp_ops.npz")))
    axis = model_axis(make_smoke_mesh(1, world), "cpu")
    out = {}

    def shard(a, dim):
        n = a.shape[dim] // world
        return torch.from_numpy(np.ascontiguousarray(
            np.take(a, range(rank * n, (rank + 1) * n), axis=dim))).requires_grad_(True)

    emb = shard(inp["emb"], 0)
    y = common.embed_lookup(emb, torch.from_numpy(inp["ids"]), world, axis)
    (y * torch.from_numpy(inp["emb_cot"])).sum().backward()
    out["embed"], out["embed_grad"] = y.detach().numpy(), emb.grad.numpy()
    logits = shard(inp["logits"], 2)
    loss = common.sharded_softmax_xent(logits, torch.from_numpy(inp["labels"]), world, axis)
    loss.sum().backward()
    out["xent"], out["xent_grad"] = loss.detach().numpy(), logits.grad.numpy()
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    w1, w2 = shard(inp["w1"], 1), shard(inp["w2"], 0)
    y = common.row_parallel(torch.tanh(common.col_parallel(x, w1)), w2, axis)
    (y * torch.from_numpy(inp["mlp_cot"])).sum().backward()
    out.update(mlp=y.detach().numpy(), mlp_x_grad=x.grad.numpy(), mlp_w1_grad=w1.grad.numpy(),
               mlp_w2_grad=w2.grad.numpy())
    np.savez(os.path.join(workdir, f"tp-ops_rank{rank}.npz"), **out)


def layer_sync_rank(rank: int, world: int, workdir: str, case: str) -> None:
    """One of ``world`` processes on ``cuda:0`` (gloo through pinned host
    memory) for tests/test_torch_cuda.py: the qwen3 smoke config in f32
    under depcha's in-backward sync, the stacked layers' reduced gradients
    against the plain backward's summed over the ranks by one
    ``all_reduce`` a leaf,
    bit for bit (a sum of two f32 values has one rounding, in any order),
    with one pack and one unpack launch and one collective a layer.
    ``order`` first puts a 50 ms sleep on the stream before every slot's
    copy and before every collective, with the slots started as NaN: a
    collective that read its slot before the copy, or an unpack that read
    it before the collective's result came back, would show.  Writes "ok"
    or the failure to ``sync_<rank>.txt``."""
    import dataclasses
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.configs.qwen3_1_7b import make_smoke
    from repro_torch.core import dependency as dep
    from repro_torch.core import overlap
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.collectives import kernel
    from repro_torch.launch.mesh import init_dist, make_dp_mesh
    from repro_torch.models import transformer
    from repro_torch.utils.trees import flatten_with_names

    init_dist("cuda", backend="gloo", init_method=f"file://{workdir}/store", rank=rank,
              world_size=world, timeout=datetime.timedelta(seconds=120))
    said = "ok"
    try:
        cfg = dataclasses.replace(make_smoke(), depcha_in_scan=True)
        mesh = make_dp_mesh()
        batch = TokenPipeline(cfg.vocab, 40, 2 * world, mesh=mesh, rank=rank,
                              device="cuda").batch_at(0)

        def grads(sync: bool):
            model = transformer.Transformer(cfg, transformer.init_params(cfg, seed=3))
            layer_sync = transformer.layer_sync(cfg, model.params_tree(), mesh) if sync else None
            if layer_sync is not None:
                layer_sync.begin()
                if case == "order":       # slots allocated, then poisoned
                    for k in range(len(layer_sync.buckets)):
                        layer_sync._slot(k, 0)
                        layer_sync._slots[k].fill_(float("nan"))
            model(batch, layer_sync).backward()
            named = flatten_with_names(model.params_tree())[0]
            if layer_sync is not None:
                stacked = dict(named)
                layer_sync.finish([stacked[n] for n in layer_sync.names])
            torch.cuda.synchronize()
            return {n: p.grad for n, p in named}, layer_sync

        want, _ = grads(False)
        for g in want.values():
            dep.collective(dist.all_reduce, dist.group.WORLD, g).wait()
        if case == "order":
            pack, collective = overlap.coll_ops.fused_pack, dep.collective

            def slow_pack(*a, **k):
                torch.cuda._sleep(50_000_000)
                return pack(*a, **k)

            def slow_collective(*a, **k):
                torch.cuda._sleep(50_000_000)
                return collective(*a, **k)
            overlap.coll_ops.fused_pack, dep.collective = slow_pack, slow_collective
        before = (kernel.PACK_LAUNCHES, kernel.UNPACK_LAUNCHES)
        got, layer_sync = grads(True)
        launches = (kernel.PACK_LAUNCHES - before[0], kernel.UNPACK_LAUNCHES - before[1])
        if launches != (cfg.n_layers, cfg.n_layers) or layer_sync.collectives != cfg.n_layers:
            said = f"launches {launches}, collectives {layer_sync.collectives}"
        for n in layer_sync.names:      # the other leaves stay local here
            if not torch.equal(got[n].view(torch.int32), want[n].view(torch.int32)):
                said = f"{n}: max abs err {(got[n] - want[n]).abs().max().item()}"
    except Exception as e:   # reported to the test, which fails on it
        said = f"{type(e).__name__}: {e}"
    with open(os.path.join(workdir, f"sync_{rank}.txt"), "w") as f:
        f.write(said)
    dist.destroy_process_group()


def peer_rank(rank: int, world: int, workdir: str, case: str) -> None:
    """``check``: both peer-ring kernels against the plain rings bit for
    bit (f32, bf16, f16; uni- and bidirectional; c = 1, 37 and 131071,
    back to back).  ``wrap``: 3·K + 2 calls of each kernel back to back
    (K slots a direction), c alternating between 131071 and 1, so that
    every slot is rewritten at least three times, each result bit for bit
    against the plain rings, and the stream waits enqueued exactly as
    ``peer_memops`` counts them.  ``timeout``: rank 0 alone calls the reduce-scatter
    on a ring whose waits run out after 2 s; every rank writes what its
    check raised to ``peer_<rank>.txt``."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.kernels.collectives import kernel, ref
    from repro_torch.launch.mesh import init_dist

    init_dist("cuda", backend="gloo", init_method=f"file://{workdir}/store", rank=rank,
              world_size=world, timeout=datetime.timedelta(seconds=120))
    group = dist.group.WORLD

    def bits(t):
        return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])

    try:
        if case == "check":
            ring = kernel.PeerRing(group, 131071 * 4)
            gen = torch.Generator(device="cuda").manual_seed(rank)
            for dt in (torch.float32, torch.bfloat16, torch.float16):
                for bidi in (True, False):
                    xs = [torch.randn(world * c, generator=gen, device="cuda").to(dt)
                          for c in (1, 37, 131071)]
                    got = []
                    for x in xs:
                        shard = kernel.ring_reduce_scatter_kernel(ring, x, bidirectional=bidi)
                        got.append((shard, kernel.ring_all_gather_kernel(
                            ring, shard, bidirectional=bidi)))
                    for x, (shard, full) in zip(xs, got):
                        want = ref.ring_reduce_scatter_ref(x, group, bidirectional=bidi)
                        assert torch.equal(bits(shard), bits(want)), (dt, bidi, x.numel())
                        want = ref.ring_all_gather_ref(want, group, bidirectional=bidi)
                        assert torch.equal(bits(full), bits(want)), (dt, bidi, x.numel())
            ring.check()
            ring.close()
            with open(os.path.join(workdir, f"peer_{rank}.txt"), "w") as f:
                f.write("ok")
            return
        if case == "wrap":
            ring = kernel.PeerRing(group, 131071 * 4)
            gen = torch.Generator(device="cuda").manual_seed(rank)
            cs = [(131071, 1)[i % 2] for i in range(3 * ring.slots + 2)]
            xs = [torch.randn(world * c, generator=gen, device="cuda") for c in cs]
            before = kernel.stream_memops()
            got = []
            for x in xs:                          # back to back: no host sync
                shard = kernel.ring_reduce_scatter_kernel(ring, x)
                got.append((shard, kernel.ring_all_gather_kernel(ring, shard)))
            after = kernel.stream_memops()
            want_ops = sum(kernel.peer_memops(world, c > 1) for c in cs)
            assert {k: after[k] - before[k] for k in after} == \
                {"rs": want_ops, "ag": want_ops}, (before, after, want_ops)
            for x, (shard, full) in zip(xs, got):
                want = ref.ring_reduce_scatter_ref(x, group)
                assert torch.equal(bits(shard), bits(want)), x.numel()
                want = ref.ring_all_gather_ref(want, group)
                assert torch.equal(bits(full), bits(want)), x.numel()
            ring.check()
            ring.close()
            with open(os.path.join(workdir, f"peer_{rank}.txt"), "w") as f:
                f.write("ok")
            return
        ring = kernel.PeerRing(group, 64 * 4, chain=3, timeout_s=2.0)
        said = []

        def attempt(fn):
            try:
                fn()
                said.append("no error")
            except kernel.PeerRingError as e:
                said.append(str(e))

        x = torch.ones(world * 64, device="cuda")
        if rank == 0:      # hop 1 waits for rank world - 1, which never calls
            kernel.ring_reduce_scatter_kernel(ring, x)
            attempt(ring.check)
            dist.barrier()
            attempt(lambda: kernel.ring_reduce_scatter_kernel(ring, x))
        else:
            dist.barrier()
            attempt(ring.check)
        with open(os.path.join(workdir, f"peer_{rank}.txt"), "w") as f:
            f.write("\n".join(said))
        dist.barrier()
    finally:
        dist.destroy_process_group()


# ``elastic``: the reference's elastic worker (tests/_elworker.py) at its
# ladder's tp-halving shrink on 4 ranks: data 2 x model 2, then data 2 x
# model 1 on ranks 0 and 1 (the same dp extent, so the batches agree)
EL_MESHES = {"tp2": ((2, 2), (0, 1, 2, 3)), "tp1": ((2, 1), (0, 1))}
EL_LADDER = ("tp2", "tp1")
EL_SEQ, EL_BATCH, EL_SEED = 32, 8, 5             # TokenPipeline(96, 32, 8, seed=5)
EL_SYNC = dict(strategy="concom", bucket_bytes=1 << 12, exclude_axes=("data",))
EL_LR = 1e-3
EL_TOTAL, EL_EVERY, EL_GROW = 6, 4, 2
EL_PLAN = dict(rank_loss=(3,), transient=(1,), step_retries=1, ckpt_io_faults=2,
               ckpt_retries=3)
EL_SCRIPT = ((3, "tp1"), (5, "tp2"))
# check 7: two injected slow steps trip the patience window
EL_STRAGGLE = dict(straggler=(6, 7), straggler_s=3.0, straggler_shrink=True)
EL_STRAGGLE_RUN = dict(total=11, grow=2, factor=6.0, patience=2)
# the world-rank repairs: a 2-rank mesh on world ranks 2, 3 against the same
# mesh on ranks 0, 1 (the layout of a whole world of 2)
SUB_RANKS = ((2, 3), (0, 1))


def el_config(tp: int, ref: bool = False):
    """The reference elastic worker's ``mk_dense`` at ``tp`` (TP_CFG, f32)."""
    return tp_config(tp, ref=ref)


def _el_plan(**kw):
    from repro_torch.elastic import FaultPlan

    return FaultPlan(**{k: frozenset(v) if isinstance(v, tuple) else v
                        for k, v in kw.items()})


def _elastic(workdir: str, rank: int) -> None:
    """Port side of ``tests/test_torch_elastic.py`` (module docstring)."""
    import dataclasses
    import shutil
    import time

    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import host_global, train_state_layout
    from repro_torch.core import GradSyncConfig
    from repro_torch.core import dependency as dep
    from repro_torch.core.schedule import CommSchedule
    from repro_torch.data import TokenPipeline
    from repro_torch.elastic import (
        ElasticCheckpointer,
        StateCodec,
        Supervisor,
        plan_reshard,
        reshard_state,
    )
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw, zero1
    from repro_torch.parallel.sharding import Mesh
    from repro_torch.runtime import Trainer, make_train_step
    from repro_torch.utils.convert import params_from_numpy
    from repro_torch.utils.trees import flatten_with_names

    named = dict(np.load(os.path.join(workdir, "elastic_params.npz")))
    cpu = torch.device("cpu")
    out: dict = {}
    steps: dict = {}

    def mesh_of(key):
        (data, model), ranks = EL_MESHES[key]
        return Mesh(("data", "model"), {"data": data, "model": model}, ranks)

    built: dict = {}

    def step_for(mode, key):
        """(train step, pipeline, mesh), memoized: make_train_step is
        collective, every rank builds every rung."""
        if (mode, key) not in built:
            mesh = mesh_of(key)
            cfg = el_config(mesh.shape["model"])
            me = dep.mesh_rank(mesh)
            model = tf.Transformer(cfg, params_from_numpy(
                named, "cpu", mesh=mesh, rank=0 if me is None else me,
                rules=tf.param_rules(cfg)))
            ts = make_train_step(cfg, mesh, GradSyncConfig(**EL_SYNC),
                                 zero1(adamw(EL_LR), ("data",), 2), model=model,
                                 zero1_mode=True, zero1_plan=mode, clip_norm=0.0,
                                 device="cpu")
            fn = ts.fn

            def recording(model, opt_state, batch, step, _fn=fn):
                model, opt_state, m = _fn(model, opt_state, batch, step)
                steps[step] = float(m["loss"])
                return model, opt_state, m

            ts = dataclasses.replace(ts, fn=recording)
            pipe = (TokenPipeline(96, EL_SEQ, EL_BATCH, seed=EL_SEED, mesh=mesh, rank=me,
                                  device="cpu") if me is not None else None)
            built[(mode, key)] = (ts, pipe, mesh)
        return built[(mode, key)]

    def build_for(mode, key):
        """The Supervisor's builder: a fresh model at the initial weights."""
        ts, pipe, mesh = step_for(mode, key)
        me = dep.mesh_rank(mesh)
        if me is None:
            return ts, None, None
        cfg = el_config(mesh.shape["model"])
        return ts, pipe, tf.Transformer(cfg, params_from_numpy(
            named, "cpu", mesh=mesh, rank=me, rules=tf.param_rules(cfg)))

    def run_plain(mode, key, n, times=None):
        ts, pipe, model = build_for(mode, key)
        st = ts.init_opt() if ts.member else None
        for k in range(n if ts.member else 0):
            t0 = time.perf_counter()
            model, st, _ = ts.fn(model, st, pipe.batch_at(k), k)
            if times is not None and k:
                times.append(time.perf_counter() - t0)
        return ts, model, st

    def flat(model, st, prefix=""):
        res = {}
        if model is not None:
            res.update({f"{prefix}param/{n}": p.detach().numpy().copy()
                        for n, p in flatten_with_names(model.params_tree())[0]})
        if st is not None:
            res.update({f"{prefix}opt/{n}": t.numpy().copy()
                        for n, t in flatten_with_names(st)[0]})
        return res

    def same(a: dict, b: dict) -> bool:
        return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)

    def flag(name, cond):
        out[f"check/{name}"] = np.array(bool(cond))

    # each rung's uninterrupted losses (tp1 on ranks 0 and 1 of the 4), and
    # the full rung's step times on this host
    step_s: list = []
    for key in EL_LADDER:
        steps.clear()
        run_plain("scheduled", key, EL_TOTAL, times=step_s if key == EL_LADDER[0] else None)
        if rank == 0:
            out[f"plain-{key}/losses"] = np.array([steps[k] for k in range(EL_TOTAL)])

    # 1. the codec round trip on one mesh: scheduled (m, v), deferred (+ carry)
    for mode in ("scheduled", "deferred"):
        ts, model, st = run_plain(mode, "tp2", 2)
        codec = StateCodec(ts)
        enc = codec.encode(model.params_tree(), st)
        params, st2 = codec.decode(enc)
        m2 = tf.Transformer(el_config(2), params)
        flag(f"codec-roundtrip-{mode}", same(flat(model, st), flat(m2, st2))
             and ("pending" in enc["stats"]) == (mode == "deferred"))
        if mode == "scheduled":
            base = (ts, model, st, codec)
    # 2. a zero-step tp2 -> tp1 -> tp2 round trip is the identity
    ts2, model2, st2, codec2 = base
    ts1 = step_for("scheduled", "tp1")[0]
    codec1 = StateCodec(ts1)
    view: dict = {}
    p1, o1 = reshard_state(ts2, ts1, model2.params_tree(), st2, old_codec=codec2,
                           new_codec=codec1, view=view)
    m1 = tf.Transformer(el_config(1), p1) if p1 is not None else None
    # a transition's anchor: written from the transfer's view, the files
    # ``save_now`` writes of the decoded state, byte for byte
    if ts1.member:
        roots = [os.path.join(workdir, f"anchor-{i}") for i in range(2)]
        ElasticCheckpointer(CheckpointManager(roots[0], blocking=True), codec1).save_view(
            3, view if rank == 0 else None)
        ElasticCheckpointer(CheckpointManager(roots[1], blocking=True), codec1).save_now(
            3, {"params": m1.params_tree(), "opt": o1})
        if rank == 0:
            files = [sorted(os.path.relpath(os.path.join(d, f), r)
                            for d, _, fs in os.walk(r) for f in fs) for r in roots]

            def raw(r, f):
                with open(os.path.join(r, f), "rb") as fh:
                    return fh.read()
            out["anchor/files"] = np.array(files[0])
            flag("anchor-view-equals-save-now", files[0] == files[1] and all(
                raw(roots[0], f) == raw(roots[1], f) for f in files[0]))
    del view
    p2, o2 = reshard_state(ts1, ts2, m1.params_tree() if m1 is not None else None, o1,
                           old_codec=codec1, new_codec=codec2)
    flag("reshard-2-1-2-roundtrip", same(flat(model2, st2),
                                         flat(tf.Transformer(el_config(2), p2), o2)))
    # 3. plan_reshard: the byte count covers params, m and v; the reshard
    # pass rejects a PRE op crossing the REGROUP
    from repro_torch.analysis import ScheduleError, verify_schedule

    rp = plan_reshard(ts2, ts1, codec2._params_like())
    n_param = sum(p.numel() for _, p in flatten_with_names(codec2._params_like())[0])
    out["plan/reshard_bytes"] = np.int64(rp.reshard_bytes)
    out["plan/n_param"] = np.int64(n_param)
    out["plan/kinds"] = np.array([op.kind for op in rp.transition.ops])
    flag("plan-reshard-bytes-cover-streams",
         rp.reshard_bytes >= 3 * n_param * 4 and rp.streams[0] == "param")
    mut = list(rp.transition.ops)
    mut[0] = dataclasses.replace(mut[0], phase="pre")
    try:
        verify_schedule(CommSchedule(tuple(mut)), mesh_shape=None,
                        old_mesh_shape=rp.old_mesh_shape, new_mesh_shape=rp.new_mesh_shape,
                        leaf_divisibility=rp.leaf_divisibility)
        caught = False
    except ScheduleError as e:
        caught = "pre-crosses-regroup" in str(e)
    flag("plan-reshard-rejects-pre-crossing-regroup", caught)

    # 5-7. the supervisor's cycles; ``steps`` records every step's loss
    runs: list = []

    def run_super(mode, plan=None, script=None, total=EL_TOTAL, grow=EL_GROW, **kw):
        steps.clear()
        runs.append(mode)
        root = os.path.join(workdir, f"supervisor-{len(runs)}")     # every rank's
        sup = Supervisor(lambda key: build_for(mode, key), EL_LADDER, root, plan=plan,
                         script=script, every=EL_EVERY, grow_back_after=grow,
                         printer=lambda _s: None, **kw)
        model, st, rep = sup.run(total)
        dist.barrier()
        if rank == 0:
            shutil.rmtree(root, ignore_errors=True)
        return model, st, rep, dict(steps)

    def report(tag, rep, losses):
        out[f"{tag}/script"] = np.array(rep["script"], dtype=object).astype(str)
        out[f"{tag}/reasons"] = np.array([t["reason"] for t in rep["transitions"]])
        out[f"{tag}/events"] = np.array([f"{e['kind']}@{e.get('step')}" for e in rep["events"]])
        out[f"{tag}/latency_count"] = np.int64(rep["metrics"]["recovery_latency_s"]["count"])
        out[f"{tag}/reshard_bytes_total"] = np.int64(rep["metrics"]["reshard_bytes_total"])
        out[f"{tag}/final_mesh"] = np.array(rep["final_mesh"])
        out.update({f"{tag}/loss/{k}": np.float32(v) for k, v in losses.items()})

    finals = {}
    for mode in ("scheduled", "deferred"):
        mF, oF, repF, lossF = run_super(mode, plan=_el_plan(**EL_PLAN))
        report(f"{mode}-faulty", repF, lossF)
        mC, oC, repC, _ = run_super(mode, script=repF["script"])
        flag(f"supervisor-{mode}-faulty-equals-clean", same(flat(mF, oF), flat(mC, oC)))
        ts_f = step_for(mode, "tp2")[0]
        if ts_f.finalize is not None:
            mF = ts_f.finalize(mF, oF)
        finals[mode] = flat(mF, None)
        # the global params, for the reference's
        lay = StateCodec(ts_f).layout
        lay = dataclasses.replace(lay, specs={"params": lay.specs["params"]})
        out.update({f"{mode}-faulty/{n}": t.numpy() for n, t in
                    host_global({"param": mF.params_tree()}, dataclasses.replace(
                        lay, specs={"param": lay.specs["params"]}))})
    flag("supervisor-deferred-equals-scheduled", same(finals["scheduled"], finals["deferred"]))
    # an uninterrupted tp2-only run: another reduction order in the middle
    # segment, so close, not equal
    _, m_un, _ = run_plain("scheduled", "tp2", EL_TOTAL)
    out["uninterrupted-maxdiff"] = np.float64(max(
        float(np.max(np.abs(a - finals["scheduled"][k])))
        for k, a in flat(m_un, None).items()))

    # 7. straggler-driven shrink (opt-in), then its clean replay
    sr = EL_STRAGGLE_RUN
    # the injected straggler must take more than ``factor`` x the median
    # step under this host's load: the reference's 3 s, or twice that
    # bound at the slowest rank's median where a loaded host needs more
    med = torch.tensor([float(np.median(step_s))], dtype=torch.float64)
    dist.all_reduce(med, op=dist.ReduceOp.MAX)
    straggle = {**EL_STRAGGLE, "straggler_s": max(EL_STRAGGLE["straggler_s"],
                                                  2 * sr["factor"] * float(med))}
    mS, oS, repS, _ = run_super("scheduled", plan=_el_plan(**straggle), total=sr["total"],
                                grow=sr["grow"], straggler_factor=sr["factor"],
                                straggler_patience=sr["patience"])
    report("straggler", repS, {})
    remesh = [e for e in repS["events"] if e["kind"] == "remesh_requested"]
    out["straggler/decisions"] = np.array([e["decision"] for e in remesh] or [""])
    out["straggler/resume"] = np.array([t["resume_step"] for t in repS["transitions"]])
    mSc, oSc, _, _ = run_super("scheduled", script=repS["script"], total=sr["total"],
                               grow=sr["grow"])
    flag("straggler-shrink-faulty-equals-clean", same(flat(mS, oS), flat(mSc, oSc)))

    # 8. deferred exact resume through the PLAIN checkpoint path on the tp1
    # rung (2 of the 4 ranks): a killed-and-recovered run equals the
    # uninterrupted one; the guard refuses a checkpoint without the carry
    ts1d, pipe1d, _ = step_for("deferred", "tp1")
    if ts1d.member:
        def run_trainer(root, fail_at=frozenset(), ckpt=True):
            _, _, model = build_for("deferred", "tp1")
            ck = CheckpointManager(root, every=2, keep=0, blocking=True) if ckpt else None
            tr = Trainer(ts1d, pipe1d, ck, fail_at=frozenset(fail_at),
                         printer=lambda _s: None, log_every=10_000)
            return tr.run(model, ts1d.init_opt(), 8)

        roots = [os.path.join(workdir, f"plain-{i}") for i in range(3)]
        m_kill, o_kill, r_kill = run_trainer(roots[0], fail_at={5})
        m_ok, o_ok, _ = run_trainer(roots[1], ckpt=False)
        kinds = [e["kind"] for e in r_kill["events"]]
        flag("deferred-plain-ckpt-exact-resume", "recover" in kinds and same(
            flat(ts1d.finalize(m_kill, o_kill), None), flat(ts1d.finalize(m_ok, o_ok), None)))
        _, _, model = build_for("deferred", "tp1")
        no_pending = {"params": model.params_tree(),
                      "opt": {k: v for k, v in ts1d.init_opt().items() if k != "pending"}}
        ck = CheckpointManager(roots[2], every=1, blocking=True)
        ck.attach_step(ts1d)
        ck.layout = dataclasses.replace(train_state_layout(ts1d), specs={
            "params": ts1d.param_specs,
            "opt": {"inner": train_state_layout(ts1d).specs["opt"]["inner"]}})
        ck.maybe_save(1, no_pending)
        try:
            run_trainer(roots[2])
            hit = False
        except RuntimeError as e:
            hit = "pending" in str(e)
        flag("deferred-restore-guard-refuses-carry-less-ckpt", hit)
    # ZeRO-1 at tp > 1 on the plain path: refused, naming the elastic path
    try:
        train_state_layout(step_for("scheduled", "tp2")[0])
        out["plain-zero1-tp2-refusal"] = np.array("")
    except ValueError as e:
        out["plain-zero1-tp2-refusal"] = np.array(str(e))

    # the world-rank repairs: each function on a 2-rank mesh inside the
    # world of 4, on world ranks 2, 3 and on 0, 1
    from repro_torch.core import GradSync
    from repro_torch.models.common import fsdp_all_gather, fsdp_axes, model_axis, model_psum
    from repro_torch.optim.zero import zero1_state

    for ranks in SUB_RANKS:
        tag = "sub" + "".join(map(str, ranks))
        me = ranks.index(rank) if rank in ranks else None
        val = torch.arange(6, dtype=torch.float32) * (1 + (me or 0)) + 0.5
        res = {}
        m12 = Mesh(("data", "model"), {"data": 1, "model": 2}, ranks)
        m21 = Mesh(("data", "model"), {"data": 2, "model": 1}, ranks)
        cg = dep.coset_groups([("model",)], m12, cpu)[("model",)]
        pods = dep.pod_comms([0], 2, 1, cpu, 1, ranks=ranks)[0]
        ax = model_axis(m12, "cpu")
        fa = fsdp_axes(m21, ("data",), "cpu")
        cfg = el_config(1)
        gmodel = tf.Transformer(cfg, params_from_numpy(named, "cpu"))
        tree = gmodel.params_tree()
        gs = GradSync(GradSyncConfig(strategy="concom", bucket_bytes=1 << 12), m21,
                      tf.param_specs(tree, cfg), tree, device="cpu")
        gs1 = GradSync(GradSyncConfig(**{**EL_SYNC, "zero1_dp_axes": ("data",)}), m21,
                       tf.param_specs(tree, cfg), tree, device="cpu")
        if me is not None:
            t = val.clone()
            dep.collective(dist.all_reduce, cg, t).wait()
            res["coset_groups"] = t.numpy()
            t = val.clone()
            dep.collective(dist.all_reduce, pods.inter, t).wait()
            res["pod_comms"] = np.concatenate([t.numpy(), [dist.get_world_size(pods.intra),
                                                           dist.get_world_size(pods.inter)]])
            res["model_axis"] = np.concatenate([model_psum(val, ax).detach().numpy(),
                                                [ax.index, ax.size]])
            res["fsdp_axes"] = np.concatenate([fsdp_all_gather(val, 0, fa).detach().numpy(),
                                               [fa.index, fa.size]])
            res["zero1_state"] = np.array([v.numel() for _, v in flatten_with_names(
                zero1_state(adamw(EL_LR), gs1.dp_plan, 2, cpu))[0]])
            grads = {n: torch.full(p.shape, float(1 + me)) for n, p in
                     flatten_with_names(tree)[0]}
            from repro_torch.utils.trees import tree_unflatten
            red = gs(tree_unflatten(flatten_with_names(tree)[1], list(grads.values())))
            res["gradsync"] = np.array([float(g.sum()) for _, g in flatten_with_names(red)[0]])
            out.update({f"{tag}/{k}": v for k, v in res.items()})
        gs.close()
        gs1.close()
    # the KVStore's regroup on the 4 ranks: data x model, then "data" alone
    from repro_torch.core import KVStore

    kv = KVStore("concom", reduce_axes=("data", "model"), num_channels=2,
                 mesh_shape={"data": 2, "model": 2}, device="cpu")
    x = torch.full((8,), float(rank + 1))
    kv.init(0, x)
    kv.push(0, x)
    first = kv.pull(0)
    size = kv.regroup(reduce_axes=("data",), mesh_shape={"data": 2, "model": 2})
    kv.push(0, x * 3)
    out["kvstore/before"] = first.numpy()
    out["kvstore/size"] = size.numpy()
    out["kvstore/after"] = kv.pull(0).numpy()
    s = kv.schedule(verify=False)
    out["kvstore/kinds"] = np.array([op.kind for op in s.ops])
    out["kvstore/axes"] = np.array(["+".join(op.bucket.reduce_axes) for op in s.ops])
    np.savez(os.path.join(workdir, f"elastic_rank{rank}.npz"), **out)


def _elastic_reference(workdir: str) -> dict:
    """The JAX package's elastic runs on 4 fake devices: the ``("tp2",
    "tp1")`` Supervisor cycle of ``EL_PLAN`` under both plans (script,
    reasons, events, each step's loss, final params, a deferred run after
    ``finalize``) and the witness of its plain checkpoint's view of ZeRO-1
    state at tp = 2: the global flat array is model rank 0's shards."""
    import dataclasses
    import shutil
    import tempfile

    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.core import GradSyncConfig
    from repro.data import TokenPipeline
    from repro.elastic import FaultPlan, Supervisor
    from repro.models import transformer as tf
    from repro.optim import adamw, zero1
    from repro.runtime import make_train_step
    from repro.utils.trees import flatten_with_names

    named = dict(np.load(os.path.join(workdir, "elastic_params.npz")))
    params = tf.init_params(jax.random.PRNGKey(2), el_config(1, ref=True))
    for n, p in flatten_with_names(params)[0]:
        np.testing.assert_array_equal(np.asarray(p), named[n], err_msg=n)
    steps: dict = {}
    built: dict = {}

    def build_for(mode, key):
        if (mode, key) not in built:
            (data, model), ranks = EL_MESHES[key]
            mesh = jax.make_mesh((data, model), ("data", "model"),
                                 axis_types=(AxisType.Auto,) * 2,
                                 devices=jax.devices()[:len(ranks)])
            cfg = el_config(model, ref=True)
            pipe = TokenPipeline(96, EL_SEQ, EL_BATCH, seed=EL_SEED, mesh=mesh)
            ts = make_train_step(cfg, mesh, GradSyncConfig(**EL_SYNC),
                                 zero1(adamw(EL_LR), ("data",), 2),
                                 batch_like=pipe.batch_at(0), params_like=params,
                                 zero1_mode=True, zero1_plan=mode, clip_norm=0.0)
            fn = ts.fn

            def recording(p, o, b, i, _fn=fn):
                p, o, m = _fn(p, o, b, i)
                steps[int(i)] = float(m["loss"])
                return p, o, m

            ts = dataclasses.replace(ts, fn=recording)
            built[(mode, key)] = (ts, pipe, jax.device_put(params, ts.shardings(ts.param_specs)))
        return built[(mode, key)]

    out = {}
    plan = FaultPlan(**{k: frozenset(v) if isinstance(v, tuple) else v
                        for k, v in EL_PLAN.items()})
    for mode in ("scheduled", "deferred"):
        steps.clear()
        root = tempfile.mkdtemp(prefix="elastic_ref_", dir=workdir)
        sup = Supervisor(lambda key, _m=mode: build_for(_m, key), EL_LADDER, root, plan=plan,
                         every=EL_EVERY, grow_back_after=EL_GROW, printer=lambda _s: None)
        p, o, rep = sup.run(EL_TOTAL)
        shutil.rmtree(root, ignore_errors=True)
        ts = build_for(mode, "tp2")[0]
        if ts.finalize is not None:
            p = ts.finalize(p, o)
        tag = f"{mode}-faulty"
        out[f"{tag}/script"] = np.array(rep["script"], dtype=object).astype(str)
        out[f"{tag}/reasons"] = np.array([t["reason"] for t in rep["transitions"]])
        out[f"{tag}/events"] = np.array([f"{e['kind']}@{e.get('step')}"
                                         for e in rep["events"]])
        out.update({f"{tag}/loss/{k}": np.float32(v) for k, v in steps.items()})
        out.update({f"{tag}/param/{n}": np.asarray(v) for n, v in flatten_with_names(p)[0]})
    # the plain path's view of ZeRO-1 state at tp = 2 after two steps
    ts, pipe, p = build_for("scheduled", "tp2")
    o = ts.init_opt()
    for k in range(2):
        p, o, _ = ts.fn(p, o, pipe.batch_at(k), jnp.int32(k))
    for k, st in o["inner"].items():
        m = st["m"]
        out[f"witness/{k}/global"] = np.asarray(jax.device_get(m))
        for s in m.addressable_shards:       # device 2d + m holds (d, m)
            out[f"witness/{k}/shard/{s.device.id // 2}{s.device.id % 2}"] = np.asarray(s.data)
    return out


def _pp(workdir: str, rank: int) -> None:
    """Port side of ``tests/test_torch_pipeline.py``: for each mesh of
    ``PP_MESHES`` and run of ``PP_RUNS``, ``PP_STEPS`` AdamW steps of
    ``make_train_step`` from the carried weights (each rank keeping its
    stage slice and model shards): each step's loss, grad norm and hops,
    and the final param shards, to ``pp_rank<r>.npz`` (nothing from a
    rank outside a stage-1 twin's mesh).  Then ``pipeline_forward`` on
    four stages."""
    import torch

    from repro_torch.core import GradSyncConfig
    from repro_torch.core import dependency as dep
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from repro_torch.parallel import pipeline as pl
    from repro_torch.parallel.sharding import Mesh
    from repro_torch.runtime import make_train_step
    from repro_torch.utils.convert import params_from_numpy
    from repro_torch.utils.trees import flatten_with_names

    out = {"groups_before": np.int64(dep.live_groups())}
    for mesh_name, (data, stage, model) in PP_MESHES.items():
        for run, (s, sched, mb, clip, arch) in PP_RUNS.items():
            if arch and mesh_name not in PP_MOE_MESHES:
                continue
            mesh = make_smoke_mesh(data, model, s)
            if s == 1:
                mesh = Mesh(mesh.axis_names, mesh.shape, tuple(range(data * model)))
            me = dep.mesh_rank(mesh)
            cfg = pp_config(mesh_name, arch)
            weights = dict(np.load(os.path.join(
                workdir, f"pp-{arch}_params.npz" if arch else "pp_params.npz")))
            # a rank outside the twin's mesh builds the step on mesh rank 0's
            # shapes (``make_train_step`` is collective) and steps never
            net = tf.Transformer(cfg, params_from_numpy(
                weights, "cpu", mesh=mesh, rank=me or 0, rules=tf.param_rules(cfg)))
            pipe = TokenPipeline(TP_CFG["vocab"], PP_SEQ, PP_BATCH, seed=PP_SEED, mesh=mesh,
                                 rank=me or 0, device="cpu")
            kw = dict(pp_stages=s, pp_schedule=sched) if s else {}
            opt = adamw(PP_LR)
            ts = make_train_step(cfg, mesh, GradSyncConfig(**PP_SYNC), opt, model=net,
                                 clip_norm=clip, microbatch=mb, batch_like=pipe.batch_at(0),
                                 device="cpu", **kw)
            key = f"{mesh_name}/{run}"
            if me is not None:
                state = ts.init_opt()
                for k in range(PP_STEPS):
                    h0 = dep.HOPS
                    net, state, m = ts.fn(net, state, pipe.batch_at(k), k)
                    out[f"{key}/loss/{k}"] = m["loss"].numpy()
                    out[f"{key}/gnorm/{k}"] = m["grad_norm"].numpy()
                    out[f"{key}/hops/{k}"] = np.int64(dep.HOPS - h0)
                out.update({f"{key}/param/{n}": p.detach().numpy()
                            for n, p in flatten_with_names(net.params_tree())[0]})
                out[f"{key}/pp_context"] = np.array([
                    ts.gradsync.cfg.pp_stages, ts.gradsync.cfg.pp_microbatches,
                    ts.gradsync.cfg.pp_activation_bytes])
            ts.close()
    out["groups_after"] = np.int64(dep.live_groups())

    # a staged run's checkpoint: recovered from a failure at step 3 (the
    # checkpoint of step 2 restored, step 2 replayed) ≡ uninterrupted
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.runtime import Trainer

    name = PP_MOE_MESHES[0]
    data, stage, model = PP_MESHES[name]
    mesh = make_smoke_mesh(data, model, stage)
    cfg = pp_config(name)
    weights = dict(np.load(os.path.join(workdir, "pp_params.npz")))
    finals = {}
    for tag, fail in (("clean", frozenset()), ("recovered", frozenset({3}))):
        net = tf.Transformer(cfg, params_from_numpy(weights, "cpu", mesh=mesh, rank=rank,
                                                    rules=tf.param_rules(cfg)))
        pipe = TokenPipeline(TP_CFG["vocab"], PP_SEQ, PP_BATCH, seed=PP_SEED, mesh=mesh,
                             rank=rank, device="cpu")
        ts = make_train_step(cfg, mesh, GradSyncConfig(**PP_SYNC), adamw(PP_LR), model=net,
                             clip_norm=1.0, microbatch=4, pp_stages=stage,
                             pp_schedule="gpipe", device="cpu")
        ckpt = CheckpointManager(os.path.join(workdir, "pp-ckpt"), every=2) if fail else None
        trainer = Trainer(ts, pipe, ckpt, fail_at=fail, log_every=10 ** 9,
                          printer=lambda _m: None)
        net, _, hist = trainer.run(net, ts.init_opt(), 4)
        finals[tag] = [p.detach().clone() for _, p in flatten_with_names(net.params_tree())[0]]
        out[f"ckpt/{tag}/events"] = np.array([e["kind"] for e in hist["events"]])
        ts.close()
    out["ckpt/same"] = np.bool_(all(torch.equal(a, b) for a, b in
                                    zip(finals["clean"], finals["recovered"])))

    # pipeline_forward: stage i multiplies by i + 1, both broadcasts
    S, M, D = PP_FORWARD
    axis = pl.stage_axis(make_smoke_mesh(1, 1, S), "cpu")
    mbs = torch.arange(M * D, dtype=torch.float32).reshape(M, D) + 1.0
    w = torch.tensor([float(axis.index + 1)])
    for b in ("psum", "hop"):
        out[f"forward/{b}"] = pl.pipeline_forward(lambda wi, x: x * wi[0], w, mbs,
                                                  axis=axis, broadcast=b).numpy()
    out["forward/stage"] = np.int64(axis.index)
    dep.destroy_groups([axis.group])
    np.savez(os.path.join(workdir, f"pp_rank{rank}.npz"), **out)


MEASURE_MESH = (2, 2)                  # (data, model)
# run -> (strategy, zero1 StepProgram with clipping)
MEASURE_RUNS = {"concom": ("concom", False), "rsag": ("rsag", False),
                "zero1": ("concom", True)}
MEASURE_KIB = 16


def _measure(workdir: str, rank: int) -> None:
    """Port side of ``tests/test_torch_measure.py`` (module docstring)."""
    import torch

    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.obs.cli import build_setup
    from repro_torch.obs.measure import measured_gradsync
    from repro_torch.utils.trees import tree_leaves

    mesh = make_smoke_mesh(*MEASURE_MESH)
    out = {}

    def same(a, b) -> bool:
        a, b = tree_leaves(a), tree_leaves(b)
        return len(a) == len(b) and all(
            torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))

    for run, (strategy, zero1) in MEASURE_RUNS.items():
        zkw = dict(exclude_axes=("data",), zero1_dp_axes=("data",), zero1_clip=True)
        gs, grads = build_setup(strategy, "flat", MEASURE_KIB, mesh, "cpu",
                                **(zkw if zero1 else {}))
        kw = dict(update_fn=lambda op, g: g * -0.5, clip_norm=1.0) if zero1 else {}
        aux: dict = {}
        want = gs({n: g.clone() for n, g in grads.items()}, aux=aux, **kw)
        for reps in (1, 3):
            got, tl, info = measured_gradsync(gs, {n: g.clone() for n, g in grads.items()},
                                              reps=reps, **kw)
            ok = same(got, want)
            if zero1:
                ok = ok and torch.equal(info["grad_norm"], aux["grad_norm"]) and sorted(
                    info["update_shards"]) == sorted(aux["update_shards"]) and all(
                    torch.equal(info["update_shards"][k], aux["update_shards"][k])
                    for k in aux["update_shards"])
            out[f"{run}/reps{reps}/bit_equal"] = np.array(ok)
        out[f"{run}/events"] = np.array([(e.op_id, e.bucket_id) for e in tl.events])
        out[f"{run}/kinds"] = np.array([e.kind for e in tl.events])
        out[f"{run}/durations"] = np.array([e.duration for e in tl.events])
        out[f"{run}/schedule"] = np.array([(op.op_id, op.bucket.bucket_id, op.chain)
                                           for op in gs.schedule.ops])
        gs.close()
    np.savez(os.path.join(workdir, f"measure_rank{rank}.npz"), **out)


def _sendrecv(workdir: str, rank: int) -> None:
    """Port side of ``tests/test_torch_pipeline_program.py``: a SEND/RECV
    pair through ``execute`` over the stage axis of ("data", "stage")
    meshes of 2 and 4 stages, shift +1 and -1, fused staging and not, at
    loss scale 1 and 4; what each rank received, and the hops and bytes
    ``dependency.ring_exchange`` counted, to ``sendrecv_rank<r>.npz``."""
    import torch

    from repro_torch.core import dependency as dep
    from repro_torch.core.buckets import Bucket, BucketPlan, LeafInfo
    from repro_torch.core.schedule import RECV, SEND, CollectiveOp, CommSchedule, execute
    from repro_torch.core.strategies import make_reducer
    from repro_torch.parallel.sharding import Mesh
    from repro_torch.utils.trees import flatten_with_names

    N = 8
    out = {}
    for stages in (2, 4):
        mesh = Mesh(("data", "stage"), {"data": WORLD // stages, "stage": stages})
        comms = dep.mesh_comms([0], [("stage",)], mesh, torch.device("cpu"))
        bucket = Bucket(leaves=(LeafInfo(name="act", index=0, shape=(N,), dtype=torch.float32,
                                         size=N),),
                        reduce_axes=("stage",), channel=0, bucket_id=0)
        plan = BucketPlan(buckets=(bucket,), treedef=flatten_with_names([0])[1], num_leaves=1,
                          comm_dtype=torch.float32)
        for shift in (1, -1):
            sched = CommSchedule((
                CollectiveOp(op_id=0, bucket=bucket, chain=0, kind=SEND, shift=shift),
                CollectiveOp(op_id=1, bucket=bucket, chain=0, depends_on=(0,), kind=RECV,
                             shift=shift),
            )).validate()
            for fused in (True, False):
                for scale in (1.0, 4.0):
                    x = torch.arange(rank * N, (rank + 1) * N, dtype=torch.float32) / 3
                    h0, b0 = dep.HOPS, dep.HOP_BYTES
                    got = execute(sched, [x.clone()], plan,
                                  reducer=make_reducer("flat", dict(mesh.shape)),
                                  groups=comms, streams=dep.ChainStreams([0], x.device),
                                  mesh_shape=dict(mesh.shape), use_fused_staging=fused,
                                  loss_scale=scale)
                    out[f"{stages}/{shift}/{int(fused)}/{scale}"] = got[0].numpy()
                    out[f"{stages}/{shift}/{int(fused)}/{scale}/hops"] = np.array(
                        [dep.HOPS - h0, dep.HOP_BYTES - b0])
        for c in comms.values():
            dep.destroy_groups([g for g in c.groups.values() if g is not None])
    np.savez(os.path.join(workdir, f"sendrecv_rank{rank}.npz"), **out)


# the communicators' life (tests/test_torch_comms.py): build-step-close
# cycles of these runs, (strategy, (data, model), config overrides)
CLOSE_RUNS = {"concom": ("concom", (4, 1), {}),
              "depcha-tp2": ("depcha", (2, 2), {"depcha_in_scan": True}),
              "fsdp": ("concom", (2, 2), {"fsdp": True})}
CLOSE_CYCLES = 3


def _close(workdir: str, rank: int) -> None:
    """Port side of ``tests/test_torch_comms.py``: ``CLOSE_CYCLES`` cycles
    of every run of ``CLOSE_RUNS``, each a ``make_train_step``, one AdamW
    step and ``TrainStep.close``; the live process groups before the
    first cycle and after each run (``dependency.live_groups``), and the
    groups a step held, to ``close_rank<r>.npz``.  Then a ``KVStore``
    regrouped once and closed, and a ``GradSync`` closed alone."""
    import torch

    from repro_torch.core import GradSync, GradSyncConfig, KVStore
    from repro_torch.core import dependency as dep
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from repro_torch.runtime import make_train_step

    out = {"before": np.int64(dep.live_groups())}
    for cycle in range(CLOSE_CYCLES):
        for run, (strategy, (data, model), over) in CLOSE_RUNS.items():
            mesh = make_smoke_mesh(data, model)
            cfg = tp_config(model, dp_axes=("data",), **over)
            net = tf.Transformer(cfg, tf.init_params(cfg, seed=0, device="cpu", mesh=mesh,
                                                     rank=rank))
            pipe = TokenPipeline(TP_CFG["vocab"], 16, 8, seed=1, mesh=mesh, rank=rank,
                                 device="cpu")
            opt = adamw(1e-3)
            ts = make_train_step(cfg, mesh, GradSyncConfig(strategy=strategy, num_channels=4),
                                 opt, model=net, clip_norm=1.0, device="cpu")
            out[f"{run}/held/{cycle}"] = np.int64(dep.live_groups())
            _, _, m = ts.fn(net, ts.init_opt(), pipe.batch_at(cycle), cycle)
            out[f"{run}/loss/{cycle}"] = m["loss"].numpy()
            ts.close()
            out[f"{run}/after/{cycle}"] = np.int64(dep.live_groups())
    kv = KVStore("concom", reduce_axes=("data",), num_channels=2,
                 mesh_shape={"data": 4}, device="cpu")
    kv.regroup()
    kv.close()
    gs = GradSync(GradSyncConfig(strategy="concom"), make_smoke_mesh(4, 1),
                  {"w": ()}, {"w": torch.zeros(4)}, device="cpu")
    gs.close()
    out["end"] = np.int64(dep.live_groups())
    np.savez(os.path.join(workdir, f"close_rank{rank}.npz"), **out)


def run_all(workdir, mode: str, *, reference_too=False,
            timeout: int = 300, world: int = WORLD) -> None:
    """Run the ``world`` port ranks of ``mode`` (and the JAX reference of
    it; ``reference_too`` a tuple of modes: those reference processes) in
    ``workdir`` at once; raise with a failing process's output."""
    import subprocess

    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    cmds = [[sys.executable, __file__, str(workdir), str(r), str(world), mode]
            for r in range(world)]
    refs = (mode,) if reference_too is True else tuple(reference_too or ())
    cmds += [[sys.executable, __file__, str(workdir), "jax", m] for m in refs]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(c[2:])} failed:\n{out[-3000:]}")


def main(workdir: str, rank: int, world: int, mode: str = "grads") -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_dist

    torch.set_num_threads(1)
    init_dist("cpu", init_method=f"file://{workdir}/store-{mode}", rank=rank,
              world_size=world)
    try:
        if mode == "grads":
            _grads(workdir, rank)
        elif mode == "hier":
            _hier(workdir, rank)
        elif mode == "lm":
            _lm(workdir, rank)
        elif mode == "inception":
            _inception(workdir, rank)
        elif mode == "zero1":
            _zero1(workdir, rank)
        elif mode == "elastic":
            _elastic(workdir, rank)
        elif mode == "pp":
            _pp(workdir, rank)
        elif mode == "sendrecv":
            _sendrecv(workdir, rank)
        elif mode == "close":
            _close(workdir, rank)
        elif mode == "measure":
            _measure(workdir, rank)
        elif mode.startswith("serve-"):
            _serve(workdir, rank, mode[len("serve-"):])
        elif mode.startswith("tp-") and mode != "tp-ops":
            _tp(workdir, rank, mode[len("tp-"):])
        elif mode == "tp-ops":
            _tp_ops(workdir, rank, world)
        else:
            out = {"rings": _rings, "compressed": _compressed}[mode](workdir, rank)
            np.savez(os.path.join(workdir, f"{mode}_rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _inception_reference(workdir: str, mesh) -> dict:
    """The JAX package's data-parallel Inception smoke steps on the 4
    devices (batch statistics local to each), and its GradSync over each
    device's ResNet smoke gradients at each loss scale."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.configs.inception_bn_imagenet import make_smoke
    from repro.configs.resnet50_cifar import make_smoke as make_resnet_smoke
    from repro.core import GradSync, GradSyncConfig
    from repro.data import ImagePipeline
    from repro.models import resnet
    from repro.optim import sgd
    from repro.runtime import make_train_step
    from repro.utils.trees import flatten_with_names

    cfg = make_smoke()
    params = resnet.init_inception(jax.random.PRNGKey(0), cfg)
    saved = np.load(os.path.join(workdir, "inception_params.npz"))
    for n, p in flatten_with_names(params)[0]:
        np.testing.assert_array_equal(np.asarray(p), saved[n], err_msg=n)
    pipe = ImagePipeline(cfg.img_size, cfg.num_classes, GLOBAL_BATCH, mesh=mesh)
    out = {}
    for strategy in INCEPTION_STRATEGIES:
        opt = sgd(INCEPTION_LR, momentum=0.9)
        ts = make_train_step(cfg, mesh, GradSyncConfig(**inception_sync(strategy)), opt,
                             batch_like=pipe.batch_at(0), params_like=params,
                             clip_norm=1.0)
        p, state = params, opt.init(params)
        for step in range(INCEPTION_STEPS):
            p, state, m = ts.fn(p, state, pipe.batch_at(step), jnp.int32(step))
            out[f"{strategy}/loss/{step}"] = np.asarray(m["loss"])
            out.update({f"{strategy}/param{step}/{n}": np.asarray(v)
                        for n, v in flatten_with_names(p)[0]})

    cfg = make_resnet_smoke()
    params = resnet.init_params(jax.random.PRNGKey(0), cfg)
    saved = np.load(os.path.join(workdir, "params.npz"))
    for n, p in flatten_with_names(params)[0]:
        np.testing.assert_array_equal(np.asarray(p), saved[n], err_msg=n)
    pipe = ImagePipeline(cfg.img_size, cfg.num_classes, GLOBAL_BATCH, mesh=mesh)
    specs = resnet.param_rules(cfg).tree_specs(params)
    pspecs = jax.tree.map(lambda _: P(), params)
    bspecs = {"images": P("data"), "labels": P("data"), "global_tokens": P()}
    for scale in LOSS_SCALES:
        def sync(q, b, _s=scale):
            g = jax.grad(lambda x: resnet.train_forward(x, b, cfg))(q)
            gs = GradSync(GradSyncConfig(**inception_sync(loss_scale=_s)), mesh, specs,
                          jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), g))
            return gs(g)

        run = jax.jit(jax.shard_map(sync, mesh=mesh, in_specs=(pspecs, bspecs),
                                    out_specs=pspecs, check_vma=False))
        out.update({f"loss-scale-{scale}/{n}": np.asarray(v) for n, v in
                    flatten_with_names(run(params, pipe.batch_at(0)))[0]})
    return out


def _zero1_reference(workdir: str, mesh) -> dict:
    """The JAX package's runs of ``ZERO1_RUNS`` on the 4 devices (a
    deferred run as the reference's scheduled one: its own deferred step
    misses its scheduled one at seed), and the update of one step of
    zero1 with depcha's in-backward sum against zero1 under concom."""
    import jax
    import jax.numpy as jnp

    from repro.core import GradSyncConfig
    from repro.data import TokenPipeline
    from repro.models import transformer as tf
    from repro.optim import sgd, zero1
    from repro.runtime import make_train_step
    from repro.utils.trees import flatten_with_names

    def setup(**over):
        cfg = tf.TransformerConfig(**ZERO1_CFG, dtype=jnp.float32, **over)
        return cfg, tf.init_params(jax.random.PRNGKey(0), cfg)

    cfg, params = setup()
    saved = np.load(os.path.join(workdir, "zero1_params.npz"))
    for n, p in flatten_with_names(params)[0]:
        np.testing.assert_array_equal(np.asarray(p), saved[n], err_msg=n)
    pipe = TokenPipeline(cfg.vocab, ZERO1_SEQ, GLOBAL_BATCH, seed=7, mesh=mesh)

    def make(cfg, params, plan, strategy, reducer, clip, mb):
        opt = sgd(ZERO1_LR, momentum=0.9)
        kw = {}
        if plan is not None:
            opt = zero1(opt, ("data",), WORLD)
            kw = dict(zero1_mode=True, zero1_plan=plan)
        return make_train_step(cfg, mesh, GradSyncConfig(**zero1_sync(strategy, reducer, plan)),
                               opt, batch_like=pipe.batch_at(0), params_like=params,
                               clip_norm=clip, microbatch=mb, **kw)

    out = {}
    for run, (plan, *rest) in ZERO1_RUNS.items():
        ts = make(cfg, params, "scheduled" if plan == "deferred" else plan, *rest)
        p, state = params, ts.init_opt()
        for step in range(ZERO1_STEPS):
            p, state, m = ts.fn(p, state, pipe.batch_at(step), jnp.int32(step))
            out[f"{run}/loss/{step}"] = np.asarray(m["loss"])
        out.update({f"{run}/param/{n}": np.asarray(v) for n, v in flatten_with_names(p)[0]})

    # one step's update under depcha in-scan + zero1, over concom + zero1
    steps = {}
    for strategy, in_scan in (("concom", False), ("depcha", True)):
        cfg_s, params_s = setup(depcha_in_scan=in_scan)
        ts = make(cfg_s, params_s, "scheduled", strategy, "flat", 0.0, 1)
        p, _, _ = ts.fn(params_s, ts.init_opt(), pipe.batch_at(0), jnp.int32(0))
        steps[strategy] = {n: np.asarray(a) - np.asarray(b) for (n, a), (_, b) in
                           zip(flatten_with_names(p)[0], flatten_with_names(params_s)[0])}
    for n, d in steps["concom"].items():
        out[f"in_scan_ratio/{n}"] = np.float64(
            np.sum(steps["depcha"][n] * d, dtype=np.float64) / np.sum(d * d, dtype=np.float64))
    return out


def _tp_reference(workdir: str, mesh_name: str, part: str = "all") -> dict:
    """The JAX package's tensor parallelism on ``TP_MESHES[mesh_name]``
    (4 fake devices): ``tests/_mdworker.py::loss_and_grads`` for each run
    of ``TP_GRADS``, the clipped SGD step, on 2x2 the AdamW steps, the
    ZeRO-1 runs and the pod mesh's hierarchical gradients, and the tp=1
    oracles on one device.  On 1x4 also each model rank's own clip norm
    and replicated leaves after its clipped step (``fault/...``).  The
    FSDP and MoE gradients are ``part="extra"``, the rest ``"base"``:
    ``SPLIT_REFERENCE``'s meshes run them as two processes at once."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.core import GradSync, GradSyncConfig, get_strategy
    from repro.data import TokenPipeline
    from repro.models import transformer as tf
    from repro.optim import adamw, sgd, zero1
    from repro.optim.optimizers import apply_updates, clip_by_global_norm
    from repro.parallel.sharding import batch_spec
    from repro.runtime import make_train_step
    from repro.utils.trees import flatten_with_names

    auto = AxisType.Auto

    def init(cfg, saved_as):
        out = tf.init_params(jax.random.PRNGKey(1), cfg)
        saved = np.load(os.path.join(workdir, saved_as))
        for n, p in flatten_with_names(out)[0]:
            np.testing.assert_array_equal(np.asarray(p), saved[n], err_msg=n)
        return out

    params = init(tp_config(1, ref=True), "tp_params.npz")
    data, model = MESHES[mesh_name]
    mesh = jax.make_mesh((data, model), ("data", "model"), axis_types=(auto,) * 2)
    mesh1 = jax.make_mesh((1, 1), ("data", "model"), axis_types=(auto,) * 2,
                          devices=jax.devices()[:1])
    out = {}

    def structs(t):
        return jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), t)

    def loss_and_grads(cfg, m, strategy, reducer, params=params, lib=tf, extras=None):
        rules = lib.param_rules(cfg)
        pspecs = rules.tree_specs(params)
        pipe = TokenPipeline(TP_CFG["vocab"], TP_SEQ, TP_BATCH, seed=TP_SEED, mesh=m,
                             extra_specs=extras)
        batch = pipe.batch_at(0)
        bspecs = {k: (P() if np.ndim(v) == 0 else batch_spec(m)) for k, v in batch.items()}
        dp = tuple(a for a in ("pod", "data") if a in m.axis_names)
        in_scan = lib.in_scan_param_names(params) if cfg.depcha_in_scan else frozenset()
        sync = GradSyncConfig(strategy=strategy, reducer=reducer, **TP_SYNC)

        def step(p, b):
            loss, g = jax.value_and_grad(lambda q: lib.train_forward(q, b, cfg))(p)
            if cfg.tp > 1:
                g = jax.tree.map(lambda x: x / cfg.tp, g)
            g = GradSync(sync, m, pspecs, structs(g), in_scan_names=in_scan)(g)
            return jax.lax.psum(loss, dp), g

        f = jax.jit(jax.shard_map(step, mesh=m, in_specs=(pspecs, bspecs),
                                  out_specs=(P(), pspecs), check_vma=False))
        ps = jax.device_put(params, jax.tree.map(lambda s: NamedSharding(m, s), pspecs))
        return f(ps, batch)

    def save_grads(run, lg):
        out[f"{run}/loss"] = np.asarray(lg[0])
        out.update({f"{run}/grad/{n}": np.asarray(v) for n, v in flatten_with_names(lg[1])[0]})

    def in_scan(strategy):
        return get_strategy(strategy).uses_in_scan

    if part != "extra":
        for (strategy, reducer), name in (TP_GRADS.items() if mesh_name in TP_MESHES
                                          else ()):
            cfg = tp_config(model, ref=True, depcha_in_scan=in_scan(strategy))
            save_grads(name, loss_and_grads(cfg, mesh, strategy, reducer))
        save_grads("tp1", loss_and_grads(tp_config(1, ref=True), mesh1, "concom", "flat"))
    for (strategy, reducer), name in (FSDP_GRADS.get(mesh_name, {}).items()
                                      if part != "base" else ()):
        cfg = tp_config(model, ref=True, fsdp=True, depcha_in_scan=in_scan(strategy))
        save_grads(name, loss_and_grads(cfg, mesh, strategy, reducer))
    # MoE, experts sharded over "model": the same mesh, and the tp = 1
    # oracle at the same dp (an expert's capacity follows the local tokens)
    moe_runs = MOE_RUNS.get(mesh_name, {}) if part != "base" else {}
    mesh_d1 = jax.make_mesh((data, 1), ("data", "model"), axis_types=(auto,) * 2,
                            devices=jax.devices()[:data])
    for arch in sorted({a for a, _, _ in moe_runs.values()}):
        mp = init(moe_config(arch, 1, ref=True), f"moe-{arch}_params.npz")
        for run, (a, strategy, fsdp) in moe_runs.items():
            if a == arch:
                cfg = moe_config(arch, model, ref=True, fsdp=fsdp,
                                 depcha_in_scan=in_scan(strategy))
                save_grads(run, loss_and_grads(cfg, mesh, strategy, "flat", mp))
        save_grads(f"moe-{arch}-tp1", loss_and_grads(moe_config(arch, 1, ref=True), mesh_d1,
                                                      "concom", "flat", mp))
    if part == "extra":
        return out
    if mesh_name == "4x1":
        # the cross-attention, RWKV and Zamba2 runs' oracle: tp = 1 on one device
        for kind in XR_ARCHS:
            xcfg = xr_config(kind, 1, ref=True)
            lib = family_lib(xcfg, ref=True)
            named, treedef = flatten_with_names(lib.init_params(jax.random.PRNGKey(1), xcfg))
            saved = np.load(os.path.join(workdir, f"xr-{kind}_params.npz"))
            xp = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(saved[n]) for n, _ in named])
            save_grads(f"xr-{kind}-tp1", loss_and_grads(xcfg, mesh1, "concom", "flat", xp,
                                                        lib=lib, extras=xr_extras(kind)))

    def train(run, m, cfg, opt, *, clip, steps, strategy="concom", plan=None):
        pipe = TokenPipeline(TP_CFG["vocab"], TP_SEQ, TP_BATCH, seed=TP_SEED, mesh=m)
        kw = dict(zero1_mode=True, zero1_plan=plan) if plan else {}
        sync = GradSyncConfig(strategy=strategy, exclude_axes=("data",) if plan else (),
                              **TP_SYNC)
        ts = make_train_step(cfg, m, sync, opt, batch_like=pipe.batch_at(0),
                             params_like=params, clip_norm=clip, **kw)
        p = jax.device_put(params, ts.shardings(ts.param_specs))
        state = ts.init_opt() if plan else opt.init(params)
        for step in range(steps):
            p, state, met = ts.fn(p, state, pipe.batch_at(step), jnp.int32(step))
            out[f"{run}/loss/{step}"] = np.asarray(met["loss"])
        out[f"{run}/grad_norm"] = np.asarray(met["grad_norm"])
        out.update({f"{run}/param/{n}": np.asarray(v) for n, v in flatten_with_names(p)[0]})

    # the clipped step's oracle: tp = 1 on one device
    train("tp1-clip", mesh1, tp_config(1, ref=True), sgd(TP_LR), clip=TP_CLIP, steps=1)
    if mesh_name in FSDP_MESHES:
        # check 5's oracle: the AdamW step at dp 1 x tp 1
        train("tp1-adamw", mesh1, tp_config(1, ref=True), adamw(FSDP_LR), clip=0.0, steps=1)
    if mesh_name == "4x1":
        out.update(_fsdp_fault(params, mesh, tp_config(model, ref=True, fsdp=True)))
    if mesh_name in TP_MESHES:
        train("clip", mesh, tp_config(model, ref=True), sgd(TP_LR), clip=TP_CLIP, steps=1)
    if mesh_name == "2x2":
        train("adamw", mesh, tp_config(model, ref=True, depcha_in_scan=True), adamw(1e-3),
              clip=0.0, steps=TP_STEPS, strategy="depcha")
        for run, plan in TP_ZERO1.items():
            if run.endswith("-clip"):
                continue          # held to tp1-clip: the reference's own clips per rank
            train(run, mesh, tp_config(model, ref=True),
                  zero1(sgd(TP_LR, momentum=0.9), ("data",), data), clip=0.0, steps=2,
                  plan=plan)
        pods, pdata, pmodel = TP_POD_MESH
        pm = jax.make_mesh(TP_POD_MESH, ("pod", "data", "model"), axis_types=(auto,) * 3)
        for strategy in ("concom", "depcha"):
            cfg = tp_config(pmodel, ref=True, dp_axes=("pod", "data"),
                            depcha_in_scan=get_strategy(strategy).uses_in_scan,
                            depcha_reducer="hierarchical", intra_size=pdata)
            save_grads(f"pod-{strategy}", loss_and_grads(cfg, pm, strategy, "hierarchical"))
    elif mesh_name == "1x4":
        # the reference's plain clipped step inside shard_map, each model
        # rank's norm and replicated leaves kept apart (stacked on "model")
        cfg = tp_config(model, ref=True)
        pspecs = tf.param_rules(cfg).tree_specs(params)
        named_specs = dict(flatten_with_names(pspecs)[0])
        rep = sorted(n for n, sp in named_specs.items() if sp == P())
        pipe = TokenPipeline(TP_CFG["vocab"], TP_SEQ, TP_BATCH, seed=TP_SEED, mesh=mesh)
        batch = pipe.batch_at(0)
        bspecs = {k: (P() if np.ndim(v) == 0 else batch_spec(mesh)) for k, v in batch.items()}
        opt = sgd(TP_LR)

        def step(p, b):
            _, g = jax.value_and_grad(lambda q: tf.train_forward(q, b, cfg))(p)
            g = jax.tree.map(lambda x: x / cfg.tp, g)
            g = GradSync(GradSyncConfig(strategy="concom", **TP_SYNC), mesh, pspecs,
                         structs(g))(g)
            g, gnorm = clip_by_global_norm(g, TP_CLIP)
            upd, _ = opt.update(g, opt.init(p), p, 0)
            new = dict(flatten_with_names(apply_updates(p, upd))[0])
            return gnorm[None], {n: new[n][None] for n in rep}

        f = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(pspecs, bspecs),
                                  out_specs=(P("model"), {n: P("model") for n in rep}),
                                  check_vma=False))
        ps = jax.device_put(params, jax.tree.map(lambda s: NamedSharding(mesh, s), pspecs))
        norms, leaves = f(ps, batch)
        out["fault/norms"] = np.asarray(norms)
        out.update({f"fault/param/{n}": np.asarray(v) for n, v in leaves.items()})

    # the device order and what device_put gives each device: the
    # params' blocks under their specs and the batch's rows
    meshes = {"": mesh}
    if mesh_name == "2x2":
        meshes["pod/"] = jax.make_mesh(TP_POD_MESH, ("pod", "data", "model"),
                                       axis_types=(auto,) * 3)
    for tag, m in meshes.items():
        out[f"{tag}device_ids"] = np.vectorize(lambda d: d.id)(m.devices)
        cfg = tp_config(m.shape["model"], ref=True,
                        dp_axes=tuple(a for a in ("pod", "data") if a in m.axis_names))
        pspecs = tf.param_rules(cfg).tree_specs(params)
        placed = jax.device_put(params, jax.tree.map(lambda s: NamedSharding(m, s), pspecs))
        for n, x in flatten_with_names(placed)[0]:
            for sh in x.addressable_shards:
                out[f"{tag}shard/{n}/{sh.device.id}"] = np.asarray(sh.data)
        batch = TokenPipeline(TP_CFG["vocab"], TP_SEQ, TP_BATCH, seed=TP_SEED,
                              mesh=m).batch_at(0)
        for sh in batch["tokens"].addressable_shards:
            out[f"{tag}batch/{sh.device.id}"] = np.asarray(sh.data)
    return out


def _serve_reference(workdir: str, mesh_name: str) -> dict:
    """The JAX package's serving on ``SERVE_MESHES[mesh_name]`` (4 fake
    devices) from the same weights and inputs as ``_serve``: each run's
    static engine, its greedy prefill/decode_step loop through
    ``shard_map`` (the logits and the prefill's decode state, global), the
    dense runs' continuous engine,
    the model functions' runs, the padded-vocab witness at 2 x 2; at 1 x 4
    check 13's samplers and the tp = 1 engines on one device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from jax.sharding import PartitionSpec as P

    from repro.models.registry import family_of
    from repro.parallel.sharding import batch_spec
    from repro.runtime import ContinuousScheduler, Server, sharded_argmax, sharded_sample
    from repro.utils.trees import flatten_with_names

    data, model = SERVE_MESHES[mesh_name]
    auto = (AxisType.Auto,) * 2
    mesh = jax.make_mesh((data, model), ("data", "model"), axis_types=auto)
    inp = dict(np.load(os.path.join(workdir, "serve_inputs.npz")))
    out = {}
    seq_leaves = ("k", "v", "attn_k", "attn_v")

    def weights(cfg, named):
        lib = family_lib(cfg, ref=True)
        leaves, treedef = flatten_with_names(jax.eval_shape(
            lambda: lib.init_params(jax.random.PRNGKey(0), cfg)))   # the tree, not its draws
        return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(named[n]) for n, _ in leaves])

    def saved(name):
        return dict(np.load(os.path.join(workdir, f"serve-{name}_params.npz")))

    def greedy_loop(cfg, params, toks, steps, img=None):
        """prefill, then ``steps`` greedy decode steps over a cache grown
        to SERVE_MAX_LEN, in shard_map on the mesh: the global logits of
        each step, the tokens (argmax over the whole vocab: the lowest
        shard and index on ties, as sharded_argmax) and the prefill's
        decode state (global, as ``decode_state_specs`` lays it out)."""
        api, lib = family_of(cfg), family_lib(cfg, ref=True)
        pspecs = api.param_rules(cfg).tree_specs(params)
        bspec = batch_spec(mesh)
        cspecs = api.decode_state_specs(cfg, bspec[0])
        lspec = P(bspec[0], "model")
        ex, espec = ((), ()) if img is None else ((jnp.asarray(img),), (bspec,))

        def kw(e):
            return {"img_embeds": e[0]} if e else {}

        pf = jax.jit(jax.shard_map(
            lambda p, t, *e: lib.prefill(p, t, cfg, **kw(e)), mesh=mesh,
            in_specs=(pspecs, bspec) + espec, out_specs=(lspec, cspecs), check_vma=False))
        dc = jax.jit(jax.shard_map(
            lambda p, c, t, pos, *e: lib.decode_step(p, c, t, pos, cfg, **kw(e)), mesh=mesh,
            in_specs=(pspecs, cspecs, bspec, P()) + espec, out_specs=(lspec, cspecs),
            check_vma=False))
        S = toks.shape[1]
        logits, cache = pf(params, jnp.asarray(toks), *ex)
        state = {n: np.asarray(c) for n, c in cache.items()}
        logs, tokens = [np.asarray(logits)], []
        for t in range(steps):
            tok = np.argmax(logs[-1], axis=-1).astype(np.int32)
            tokens.append(tok)
            if t == 0:
                cache = {n: (jnp.pad(c, [(0, 0), (0, 0), (0, SERVE_MAX_LEN - S)]
                                     + [(0, 0)] * (c.ndim - 3)) if n in seq_leaves else c)
                         for n, c in cache.items()}
            logits, cache = dc(params, cache, jnp.asarray(tok), jnp.int32(S + t), *ex)
            logs.append(np.asarray(logits))
        return logs, (np.stack(tokens, 1) if tokens else None), state

    for run, (kind, wname, over) in SERVE_RUNS[mesh_name].items():
        cfg = serve_config(kind, model, ref=True, dp_axes=("data",), **over)
        params = weights(cfg, saved(wname))
        batch = inp["batch"] if kind == "dense" else inp["recurrent"]
        srv = Server(cfg, mesh, params, max_len=SERVE_MAX_LEN)
        out[f"{run}/static"] = srv.generate(batch, SERVE_NEW)
        logs, toks, state = greedy_loop(cfg, params, batch, SERVE_NEW - 1)
        out.update({f"{run}/logits/{t}": lg for t, lg in enumerate(logs)})
        out.update({f"{run}/state/{n}": v for n, v in state.items()})
        out[f"{run}/loop"] = toks
        if kind == "dense":
            eng = ContinuousScheduler(srv, slots=SERVE_SLOTS, block_size=SERVE_BLOCK,
                                      chunk=SERVE_CHUNK)
            for i, o in enumerate(eng.generate_batch(serve_prompts(), SERVE_NEW)):
                out[f"{run}/cont/{i}"] = o
    for run, kind in SERVE_FN_RUNS.get(mesh_name, {}).items():
        cfg = serve_config(kind, model, ref=True, dp_axes=("data",))
        logs, toks, _ = greedy_loop(cfg, weights(cfg, saved(kind)), inp["recurrent"],
                                    SERVE_FN_STEPS, img=inp["img"] if kind == "vision" else None)
        out.update({f"{run}/logits/{t}": lg for t, lg in enumerate(logs)})
        out[f"{run}/tokens"] = toks
    if mesh_name == "2x2":
        cfg = serve_config("qwen3-pad", model, ref=True, dp_axes=("data",))
        named = saved("qwen3-pad")
        every = greedy_loop(cfg, weights(cfg, named), inp["recurrent"], 0)[0][0]
        k = int(np.argmax(every[0, :SERVE_PAD_VOCAB]))
        named["lm_head"] = named["lm_head"].copy()
        named["lm_head"][:, SERVE_PAD_VOCAB] = 2 * named["lm_head"][:, k]
        srv = Server(cfg, mesh, weights(cfg, named), max_len=SERVE_MAX_LEN)
        out["pad/k"], out["pad/logit_k"] = np.array(k), every[0, k]
        out["pad/tokens"] = srv.generate(inp["recurrent"], 2)
    if mesh_name == "1x4":
        def run_argmax(logits):
            return np.asarray(jax.jit(lambda l: jax.shard_map(
                lambda x: sharded_argmax(x, 4), mesh=mesh, in_specs=(P(None, "model"),),
                out_specs=P(), check_vma=False)(l))(jnp.asarray(logits)))

        def run_sample(logits, temps, topks, topps, seeds):
            body = (lambda l, t, k, p, s: sharded_sample(
                l, 4, jax.vmap(jax.random.PRNGKey)(s), t, k, p))
            return np.asarray(jax.jit(lambda *a: jax.shard_map(
                body, mesh=mesh, in_specs=(P(None, "model"),) + (P(),) * 4,
                out_specs=P(), check_vma=False)(*a))(
                jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(topks),
                jnp.asarray(topps), jnp.asarray(seeds)))

        out["sample/argmax_tie"] = run_argmax(inp["tie"])
        out["sample/argmax_rand"] = run_argmax(inp["rand"])
        out["sample/temp0"] = run_sample(inp["rand"], np.zeros(4, np.float32),
                                         np.zeros(4, np.int32), np.ones(4, np.float32),
                                         np.arange(4, dtype=np.uint32))
        # tp = 1 on one device: the engines' oracle for every mesh
        mesh1 = jax.make_mesh((1, 1), ("data", "model"), axis_types=auto,
                              devices=jax.devices()[:1])
        for name, (kind, wname, over) in SERVE_RUNS["1x4"].items():
            cfg = serve_config(kind, 1, ref=True, **over)
            srv = Server(cfg, mesh1, weights(cfg, saved(wname)), max_len=SERVE_MAX_LEN)
            out[f"tp1/{name}/static"] = srv.generate(
                inp["batch"] if kind == "dense" else inp["recurrent"], SERVE_NEW)
    return out


def _fsdp_fault(params, mesh, cfg) -> dict:
    """The reference's plain clipped step under FSDP on data 4 x model 1
    (``train_loop.py``'s ``clip_by_global_norm`` inside ``shard_map``,
    no sum over any axis): each data rank's grad norm, and each data
    rank's copy of the leaves replicated over "data" after the SGD step,
    stacked on "data" (``fsdp-fault/...``)."""
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.core import GradSync, GradSyncConfig
    from repro.data import TokenPipeline
    from repro.models import transformer as tf
    from repro.optim import sgd
    from repro.optim.optimizers import apply_updates, clip_by_global_norm
    from repro.parallel.sharding import batch_spec, flat_spec_axes
    from repro.utils.trees import flatten_with_names

    pspecs = tf.param_rules(cfg).tree_specs(params)
    rep = sorted(n for n, sp in flatten_with_names(pspecs)[0]
                 if "data" not in flat_spec_axes(sp))
    batch = TokenPipeline(TP_CFG["vocab"], TP_SEQ, TP_BATCH, seed=TP_SEED,
                          mesh=mesh).batch_at(0)
    bspecs = {k: (P() if np.ndim(v) == 0 else batch_spec(mesh)) for k, v in batch.items()}
    opt = sgd(TP_LR)

    def step(p, b):
        _, g = jax.value_and_grad(lambda q: tf.train_forward(q, b, cfg))(p)
        g = GradSync(GradSyncConfig(strategy="concom", **TP_SYNC), mesh, pspecs,
                     jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), g))(g)
        g, gnorm = clip_by_global_norm(g, TP_CLIP)
        upd, _ = opt.update(g, opt.init(p), p, 0)
        new = dict(flatten_with_names(apply_updates(p, upd))[0])
        return gnorm[None], {n: new[n][None] for n in rep}

    f = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(pspecs, bspecs),
                              out_specs=(P("data"), {n: P("data") for n in rep}),
                              check_vma=False))
    ps = jax.device_put(params, jax.tree.map(lambda s: NamedSharding(mesh, s), pspecs))
    norms, leaves = f(ps, batch)
    out = {"fsdp-fault/norms": np.asarray(norms)}
    out.update({f"fsdp-fault/param/{n}": np.asarray(v) for n, v in leaves.items()})
    return out


def _pp_reference(workdir: str) -> dict:
    """The JAX package's pipeline runs of ``PP_REF_RUNS`` on the 4 devices
    (check 14 of ``tests/_mdworker.py``): each step's loss and grad norm,
    the global params after ``PP_STEPS`` AdamW steps, and, for the staged
    gpipe step, its GradSync's schedule (pickled)."""
    import pickle

    import jax
    import jax.numpy as jnp

    from repro.core import GradSyncConfig
    from repro.data import TokenPipeline
    from repro.launch.mesh import make_smoke_mesh
    from repro.models import transformer as tf
    from repro.optim import adamw
    from repro.runtime import make_train_step
    from repro.utils.trees import flatten_with_names

    out = {}
    runs = {"gpipe": (2, 0.0, None, "gpipe"), "1f1b": (2, 0.0, None, "1f1b"),
            "clip-s1": (1, PP_CLIP, None, "gpipe"),
            "granite": (2, 0.0, "granite", "gpipe"), "plain": (0, 0.0, None, "gpipe")}
    for mesh_name, (data, _, model) in PP_MESHES.items():
        for run in PP_REF_RUNS:
            stage, clip, arch, sched = runs[run]
            if arch and mesh_name not in PP_MOE_MESHES:
                continue
            # the clipped step at tp = 1: at tp > 1 the reference clips
            # each model rank by its own shards (ROADMAP queue 3)
            tp = 1 if run == "clip-s1" else model
            mesh = make_smoke_mesh(data, tp, stage=stage)
            cfg = moe_config(arch, tp, ref=True) if arch else tp_config(tp, ref=True)
            params = tf.init_params(jax.random.PRNGKey(2), cfg)
            saved = np.load(os.path.join(
                workdir, f"pp-{arch}_params.npz" if arch else "pp_params.npz"))
            for n, p in flatten_with_names(params)[0]:
                np.testing.assert_array_equal(np.asarray(p), saved[n], err_msg=n)
            pipe = TokenPipeline(TP_CFG["vocab"], PP_SEQ, PP_BATCH, seed=PP_SEED, mesh=mesh)
            ts = make_train_step(cfg, mesh, GradSyncConfig(**PP_SYNC), adamw(PP_LR),
                                 batch_like=pipe.batch_at(0), params_like=params,
                                 clip_norm=clip, microbatch=4, pp_stages=max(stage, 1),
                                 pp_schedule=sched)
            ps = jax.device_put(params, ts.shardings(ts.param_specs))
            st = ts.init_opt()
            key = f"{mesh_name}/{run}"
            for k in range(PP_STEPS):
                ps, st, m = ts.fn(ps, st, pipe.batch_at(k), jnp.int32(k))
                out[f"{key}/loss/{k}"] = np.asarray(m["loss"])
                out[f"{key}/gnorm/{k}"] = np.asarray(m["grad_norm"])
            out.update({f"{key}/param/{n}": np.asarray(v)
                        for n, v in flatten_with_names(ps)[0]})
            if run == "gpipe":
                with open(os.path.join(workdir, f"pp-{mesh_name}_schedule.pkl"), "wb") as f:
                    pickle.dump(ts.gradsync.schedule, f)
    return out


def reference(workdir: str, mode: str) -> None:
    """The JAX package's rings, compressed allreduce, hierarchical
    reducers, Inception steps or ZeRO-1 runs on 4 fake devices."""
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={WORLD}"
    import repro  # noqa: F401  (applies the jaxcompat shim before jax imports)
    import jax
    from jax.sharding import AxisType
    from jax.sharding import PartitionSpec as P

    from repro.core.compression import compressed_allreduce
    from repro.kernels.collectives import ops

    inputs = ({} if mode in ("inception", "zero1", "elastic", "pp")
              or mode.startswith(("tp-", "serve-"))
              else dict(np.load(os.path.join(workdir, "inputs.npz"))))
    mesh4 = jax.make_mesh((WORLD,), ("data",), axis_types=(AxisType.Auto,))
    mesh22 = jax.make_mesh((2, 2), ("pair", "ring"),
                           axis_types=(AxisType.Auto,) * 2)

    def per_rank(fn, x, mesh, spec):
        """Row r of ``x`` to device r, ``fn`` on each, rows back."""
        run = jax.jit(lambda v: jax.shard_map(
            fn, mesh=mesh, in_specs=(spec,), out_specs=spec,
            check_vma=False)(v))
        return np.asarray(run(x.reshape(-1))).reshape(WORLD, -1)

    out = {}
    if mode == "elastic":
        out = _elastic_reference(workdir)
    elif mode == "pp":
        out = _pp_reference(workdir)
    elif mode.startswith("serve-"):
        out = _serve_reference(workdir, mode[len("serve-"):])
    elif mode.startswith("tp-"):
        name = mode[len("tp-"):]
        if name.endswith("+"):
            out = _tp_reference(workdir, name[:-1], part="extra")
        else:
            out = _tp_reference(workdir, name,
                                part="base" if name in SPLIT_REFERENCE else "all")
    elif mode in ("inception", "zero1"):
        fn = _inception_reference if mode == "inception" else _zero1_reference
        out = fn(workdir, jax.make_mesh((WORLD, 1), ("data", "model"),
                                        axis_types=(AxisType.Auto,) * 2))
    elif mode == "hier":
        import jax.numpy as jnp

        from repro.core.buckets import Bucket, LeafInfo
        from repro.core.strategies import make_reducer

        # rank r's (1 + r) x base made here, not inside the program: XLA's
        # CPU build would fuse that product into the ring's first add (FMA)
        base = inputs["base"]
        rows = np.stack([base * np.float32(1 + r) for r in range(WORLD)])
        axes = ("pod", "data", "model")
        bucket = Bucket(leaves=(LeafInfo(name="x", index=0, shape=base.shape,
                                         dtype=jnp.float32, size=base.size),),
                        reduce_axes=axes, channel=0, bucket_id=0)
        for m, (pods, data) in HIER_MESHES.items():
            mesh = jax.make_mesh((pods, data, 1), axes,
                                 axis_types=(AxisType.Auto,) * 3)
            for red in HIER_REDUCERS:
                fn = make_reducer(red, {"pod": pods, "data": data, "model": 1},
                                  mean_axes=("pod", "data"))
                out[f"{red}_{m}"] = per_rank(lambda v, _f=fn: _f(v, bucket),
                                             rows, mesh, P(("pod", "data")))
    elif mode == "rings":
        fns = {"rs": ops.ring_reduce_scatter, "ag": ops.ring_all_gather,
               "ar": ops.ring_allreduce}
        for case, (key, g, bidi) in RING_CASES.items():
            axis = "data" if g == 4 else "ring"
            mesh, spec = ((mesh4, P("data")) if g == 4
                          else (mesh22, P(("pair", "ring"))))
            fn = (lambda v, _f=fns[key[:2]], _a=axis, _g=g, _b=bidi:
                  _f(v, (_a,), {_a: _g}, bidirectional=_b))
            out[case] = per_rank(fn, inputs[key], mesh, spec)
    else:
        for case, use_ring in COMPRESSED_CASES.items():
            fn = (lambda v, _r=use_ring: compressed_allreduce(
                v, ("data",), group_size=WORLD, use_ring=_r))
            out[case] = per_rank(fn, inputs["compressed"], mesh4, P("data"))
    np.savez(os.path.join(workdir, f"{mode}_jax.npz"), **out)


if __name__ == "__main__":
    if sys.argv[2] == "jax":
        reference(sys.argv[1], sys.argv[3])
    else:
        main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:])
