"""Multi-rank workers of the port's CPU checks, and their JAX counterpart.

    python tests/_torch_mdworker.py <workdir> <rank> <world> [grads|rings|compressed|hier|lm|inception]
    python tests/_torch_mdworker.py <workdir> jax <rings|compressed|hier|inception>

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
    import torch.distributed as dist

    from repro_torch.kernels.collectives import ops

    inputs = dict(np.load(os.path.join(workdir, "inputs.npz")))
    groups = {4: dist.new_group(list(range(WORLD)), backend="gloo")}
    pairs = [dist.new_group([0, 1], backend="gloo"),
             dist.new_group([2, 3], backend="gloo")]
    groups[2] = pairs[rank // 2]
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
    import torch.distributed as dist

    from repro_torch.core import compression
    from repro_torch.kernels import quantize
    from repro_torch.kernels.quantize import ops as quant_ops

    x = np.load(os.path.join(workdir, "inputs.npz"))["compressed"][rank]
    group = dist.new_group(list(range(WORLD)), backend="gloo")
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
            torch.from_numpy(x), ("data",), {"data": WORLD}, group,
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
        shape = {"pod": pods, "data": data, "model": 1}
        comm = dep.pod_comms({0: dist.group.WORLD}, pods, data, torch.device("cpu"))[0]
        for red in HIER_REDUCERS:
            fn = make_reducer(red, shape, mean_axes=("pod", "data"))
            group = comm if red.startswith("hierarchical") else dist.group.WORLD
            out[f"{red}_{m}"] = fn(torch.from_numpy(x.copy()), bucket, group).wait().numpy()
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


def run_all(workdir, mode: str, *, reference_too: bool = False,
            timeout: int = 300) -> None:
    """Run the 4 port ranks of ``mode`` (and the JAX reference of it) in
    ``workdir`` at once; raise with a failing process's output."""
    import subprocess

    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    cmds = [[sys.executable, __file__, str(workdir), str(r), str(WORLD), mode]
            for r in range(WORLD)]
    if reference_too:
        cmds.append([sys.executable, __file__, str(workdir), "jax", mode])
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
    init_dist("cpu", init_method=f"file://{workdir}/store", rank=rank,
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


def reference(workdir: str, mode: str) -> None:
    """The JAX package's rings, compressed allreduce, hierarchical
    reducers or Inception steps on 4 fake devices."""
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={WORLD}"
    import repro  # noqa: F401  (applies the jaxcompat shim before jax imports)
    import jax
    from jax.sharding import AxisType
    from jax.sharding import PartitionSpec as P

    from repro.core.compression import compressed_allreduce
    from repro.kernels.collectives import ops

    inputs = ({} if mode == "inception"
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
    if mode == "inception":
        out = _inception_reference(workdir, jax.make_mesh(
            (WORLD, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2))
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
