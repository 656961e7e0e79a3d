"""One rank of the port's multi-rank checks (tests/test_torch_multirank.py).

    python tests/_torch_mdworker.py <workdir> <rank> <world>

Meets the other ranks on a gloo FileStore in ``workdir``, reads the
carried weights from ``workdir/params.npz``, and for each strategy
computes its shard's ResNet smoke gradients, reduces them through the
port's ``GradSync`` and writes them to ``workdir/<strategy>_rank<r>.npz``.
Then the paper's KVStore depcha push/pull round trip: each rank pushes a
power-of-two share of the values, so the pulled sums are exact; the
pulled values, and what ``init`` broadcast from rank 0, go to
``workdir/kvstore_rank<r>.npz``.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.configs.resnet50_cifar import make_smoke  # noqa: E402
from repro_torch.core import GradSync, GradSyncConfig, KVStore  # noqa: E402
from repro_torch.data import ImagePipeline  # noqa: E402
from repro_torch.launch.mesh import init_dist, make_dp_mesh  # noqa: E402
from repro_torch.models import resnet  # noqa: E402
from repro_torch.utils.convert import params_from_numpy  # noqa: E402
from repro_torch.utils.trees import flatten_with_names, tree_unflatten  # noqa: E402

STRATEGIES = ("funnel", "concom", "depcha", "rsag")
GLOBAL_BATCH = 8
SHARES = (0.125, 0.25, 0.125, 0.5)   # sum to 1 exactly, in any order


def main(workdir: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    init_dist("cpu", init_method=f"file://{workdir}/store", rank=rank,
              world_size=world)
    try:
        cfg = make_smoke()
        mesh = make_dp_mesh()
        named = dict(np.load(os.path.join(workdir, "params.npz")))
        batch = ImagePipeline(cfg.img_size, cfg.num_classes, GLOBAL_BATCH,
                              mesh=mesh, rank=rank, device="cpu").batch_at(0)
        for strategy in STRATEGIES:
            tree = params_from_numpy(named, "cpu")
            leaves, treedef = flatten_with_names(tree)
            for _, p in leaves:
                p.requires_grad_(True)
            resnet.train_forward(tree, batch, cfg).backward()
            gs = GradSync(GradSyncConfig(strategy=strategy, num_channels=4,
                                         bucket_bytes=64 * 1024),
                          mesh, resnet.param_specs(tree), tree, device="cpu")
            reduced = gs(tree_unflatten(treedef, [p.grad for _, p in leaves]))
            np.savez(os.path.join(workdir, f"{strategy}_rank{rank}.npz"),
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
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
