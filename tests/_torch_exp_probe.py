"""Whether CPU ``torch.exp`` and the WKV plain version give the same
result in every process.

    PYTHONPATH=src python tests/_torch_exp_probe.py [--procs 24] [--at-once 8] [--modes ...]

Starts fresh interpreters, ``--at-once`` at a time, in four modes:

- ``exp``: the process's first ``torch.exp``, on 16,384 values in
  [-7, 0], in f32 and then in float64, against numpy's exp in float64:
  the max relative error of each.  ``torch.exp`` on a CPU tensor is
  MKL's VML (ATen's ``vml.h``), called per 2048-element grain on every
  OpenMP thread.
- ``exp1``: the same with ``torch.set_num_threads(1)``.
- ``steps``: the f32 chunk math as the plain version computed it before
  it moved to float64 (``torch.exp``, f32 products), on the first case of
  ``test_torch_wkv.py`` (B 2, C 32, H 4, N 64, f32, seed 0): for each
  intermediate, an md5 prefix and its max abs difference from the same
  math in float64.
- ``wkv``: ``ops.wkv_chunk`` on that case: an md5 of y and the new state
  (``--out`` also saves them; ``test_torch_wkv.py`` runs this child).

Prints each mode's distinct results with their counts.  Imports torch,
not JAX.
"""
import argparse
import collections
import hashlib
import subprocess
import sys


def _exp(threads1: bool) -> str:
    import numpy as np
    import torch

    if threads1:
        torch.set_num_threads(1)
    x = np.random.default_rng(0).uniform(-7, 0, 16384)
    out = []
    for dt in (np.float32, np.float64):
        xd = x.astype(dt)
        got = torch.exp(torch.from_numpy(xd)).double().numpy()
        want = np.exp(xd.astype(np.float64))
        out.append(f"{np.dtype(dt).name} max rel err {np.abs(got / want - 1).max():.3g}")
    return ", ".join(out)


def _inputs():
    import numpy as np
    import torch

    B, C, H, N = 2, 32, 4, 64
    rng = np.random.default_rng(0)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    r, k, v = normal(B, C, H, N), normal(B, C, H, N), normal(B, C, H, N)
    logw = -np.exp(normal(B, C, H, N) * 0.5 - 2.0)
    u, state = normal(H, N) * 0.1, normal(B, H, N, N) * 0.1
    return [torch.from_numpy(a) for a in (r, k, v, logw, u, state)]


def _steps() -> str:
    import torch

    r, k, v, logw, u, state = _inputs()
    B, C, H, N = r.shape

    def rows(t):
        return t.transpose(1, 2).reshape(B * H, C, N)

    def run(dt):
        rr, kk, vv, lw = (rows(t).to(dt) for t in (r, k, v, logw))
        s0 = state.reshape(B * H, N, N).to(dt)
        L = torch.cumsum(lw, dim=1)
        r_dec = rr * torch.exp(L - lw)
        att = r_dec @ (kk * torch.exp(-L)).transpose(1, 2)
        att = torch.where(torch.ones(C, C, dtype=torch.bool).tril(-1), att, 0.0)
        k_dec = kk * torch.exp(L[:, C - 1][:, None, :] - L)
        return {"r_dec": r_dec, "r_dec @ s0": r_dec @ s0, "att": att, "att @ v": att @ vv,
                "k_dec.T @ v": k_dec.transpose(1, 2) @ vv}

    f32, f64 = run(torch.float32), run(torch.float64)
    return "; ".join(
        f"{name} {hashlib.md5(t.numpy().tobytes()).hexdigest()[:8]} "
        f"{(t.double() - f64[name]).abs().max().item():.3g}" for name, t in f32.items())


def _wkv(out: str = None) -> str:
    import numpy as np

    from repro_torch.kernels.rwkv6 import ops

    y, s1 = ops.wkv_chunk(*_inputs())
    if any(m.split(".")[0] in ("jax", "repro") for m in sys.modules):
        raise SystemExit("the WKV child loaded JAX or the JAX package")
    if out:
        np.savez(out, y=y.numpy(), s1=s1.numpy())
    return "y, state md5 " + hashlib.md5(y.numpy().tobytes() + s1.numpy().tobytes()).hexdigest()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=24)
    ap.add_argument("--at-once", type=int, default=8)
    ap.add_argument("--modes", nargs="+", default=["exp", "exp1", "steps", "wkv"])
    ap.add_argument("--child", choices=("exp", "exp1", "steps", "wkv"))
    ap.add_argument("--out", help="with --child wkv: save y and the state here (.npz)")
    args = ap.parse_args()
    if args.child:
        print({"exp": lambda: _exp(False), "exp1": lambda: _exp(True), "steps": _steps,
               "wkv": lambda: _wkv(args.out)}[args.child]())
        return
    for mode in args.modes:
        seen = collections.Counter()
        for start in range(0, args.procs, args.at_once):
            n = min(args.at_once, args.procs - start)
            procs = [subprocess.Popen([sys.executable, __file__, "--child", mode],
                                      stdout=subprocess.PIPE, text=True) for _ in range(n)]
            for p in procs:
                out, _ = p.communicate(timeout=300)
                if p.returncode:
                    raise SystemExit(f"{mode}: a child failed with {p.returncode}")
                seen[out.strip()] += 1
        for result, count in seen.most_common():
            print(f"{mode}: {count} of {args.procs}: {result}")


if __name__ == "__main__":
    main()
