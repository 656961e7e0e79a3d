"""Fault-tolerant checkpointing: atomic, async, sharding-aware
(``repro/checkpoint/manager.py``).

Layout (one directory per step), the reference's byte for byte where the
values agree, so a checkpoint written by either package restores in the
other:

    <root>/step_00000100.tmp/   → written, fsync'd, then renamed to
    <root>/step_00000100/
        manifest.json           (step; leaf names, shapes, dtypes)
        <leaf-name>.npy         (the GLOBAL array of each leaf)

Leaf names are ``utils/trees.py::flatten_with_names``'s, the reference's.
numpy cannot hold bfloat16 or fp8: those leaves are widened to float32
on disk and cast back on restore (``_to_savable``).

Atomicity is tmp-dir + rename: a crash mid-write never corrupts the
latest complete checkpoint; ``latest_step`` only considers renamed dirs.

Several ranks (``Layout``): each leaf is gathered to its global view
over exactly the mesh axes its spec shards it over, on the ranks mesh
rank 0's view needs; mesh rank 0 writes, and the other ranks wait for it
on a barrier.  On restore every rank maps the files and copies out its
own block (``parallel/sharding.py::shard_leaf``).  ``train_state_layout`` gives a train step's layout; it
refuses ZeRO-1 state under tensor parallelism, whose dp shards hold
different values on each model rank: that state moves through
``repro_torch.elastic.ElasticCheckpointer`` (the reference writes one
model rank's copy there, ROADMAP queue 3).

The async writer takes a host COPY of every leaf before it returns
(``.detach().to("cpu", copy=True)``): the port's step updates the params
and the optimizer state in place, so the next step would otherwise
change what the thread writes.  Restoring returns host tensors; the
``Trainer`` writes them into the live tensors (``copy_``).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import dependency as dep
from repro_torch.parallel.sharding import dp_axes_of, shard_leaf
from repro_torch.utils.convert import tensor_from_numpy
from repro_torch.utils.trees import flatten_with_names, tree_unflatten

_SAFE = re.compile(r"[^A-Za-z0-9_.-]")
_WIDENED = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


def _fname(name: str) -> str:
    return _SAFE.sub("__", name) + ".npy"


def _to_savable(v: torch.Tensor) -> np.ndarray:
    """A host tensor as the numpy array on disk: bfloat16 and fp8, which
    numpy cannot hold, widened to float32; restore casts back to the
    target tree's dtypes."""
    if v.dtype in _WIDENED:
        v = v.to(torch.float32)
    return v.numpy()


@dataclasses.dataclass(frozen=True)
class Layout:
    """How a rank's tree maps onto the global one: ``mesh``, ``specs`` (a
    tree of param specs like the saved tree), ``comms`` (a
    ``dependency.ChainComms`` with a communicator for every spec's set of
    axes and one over the whole mesh) and the tensors' ``device``."""

    mesh: Any
    specs: Any
    comms: Any
    device: torch.device

    @property
    def rank(self) -> int | None:
        return dep.mesh_rank(self.mesh)

    @property
    def writer(self) -> bool:
        return self.rank == 0

    @property
    def group(self):
        """The communicator over the whole mesh (None for one rank)."""
        return self.comms.get(self.mesh.axis_names)

    def barrier(self) -> None:
        group = self.group
        if group is not None:
            t = torch.zeros(1, device=self.device)
            dep.collective(dist.all_reduce, group, t).wait()


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _coset(mesh, rank: int, axes: tuple[str, ...]) -> set[int]:
    """The mesh ranks that share every coordinate of ``rank`` but those
    on ``axes``."""
    mine = mesh.coords(rank)
    return {r for r in range(mesh.size)
            if all(c == mine[a] for a, c in mesh.coords(r).items() if a not in axes)}


def global_leaf(t: torch.Tensor, spec, layout: Layout,
                need: set[int] | None = None) -> torch.Tensor | None:
    """The global view of one rank's block: all-gathered along each dim
    over the axes of its spec entry (collective over those axes).  With
    ``need`` (mesh ranks) only the gathers those ranks' views depend on
    run, and the ranks that take no part get None."""
    mesh = layout.mesh
    dims = [(dim, axes) for dim, entry in enumerate(spec)
            if (axes := tuple(a for a in _axes(entry) if mesh.shape[a] > 1))]
    # the ranks each gather needs, from the last: every coset holding a
    # rank the next stage needs
    parts, cur = [], need
    for _, axes in reversed(dims):
        if cur is not None:
            cur = set().union(*(_coset(mesh, r, axes) for r in cur))
        parts.append(cur)
    parts.reverse()
    me = layout.rank
    for (dim, axes), part in zip(dims, parts):
        if part is not None and me not in part:
            return None
        g = math.prod(mesh.shape[a] for a in axes)
        x = t.movedim(dim, 0).contiguous()
        out = torch.empty((g * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
        dep.collective(dist.all_gather_into_tensor, layout.comms.get(axes), out, x).wait()
        t = out.movedim(0, dim).contiguous()
    return t if need is None or me in need else None


def global_shape(shape, spec, mesh) -> tuple[int, ...]:
    out = list(shape)
    for dim, entry in enumerate(spec):
        for a in _axes(entry):
            out[dim] *= mesh.shape[a]
    return tuple(out)


def host_global(tree: Any, layout: Layout | None = None,
                need: set[int] | None = None) -> list[tuple[str, torch.Tensor]] | None:
    """(name, host COPY of the leaf's global view) for every leaf, in
    ``flatten_with_names`` order; collective under a ``layout``.  With
    ``need`` (mesh ranks) only those ranks get the views (the others take
    part in the gathers they depend on, and get None)."""
    named = flatten_with_names(tree)[0]
    spec_of = dict(flatten_with_names(layout.specs)[0]) if layout is not None else {}
    out = []
    for n, v in named:
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.asarray(v))
        v = v.detach()
        if layout is not None:
            v = global_leaf(v, spec_of[n], layout, need)
        if v is not None:
            out.append((n, v.to("cpu", copy=True).contiguous()))
    if layout is not None and need is not None and layout.rank not in need:
        return None
    return out


def _write(root: str, step: int, host: list[tuple[str, torch.Tensor]]) -> str:
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for n, t in host:
        v = _to_savable(t)
        np.save(os.path.join(tmp, _fname(n)), v)
        manifest["leaves"].append(
            {"name": n, "shape": list(v.shape), "dtype": str(v.dtype)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(root: str, step: int, tree: Any, *, blocking: bool = True,
         layout: Layout | None = None) -> str:
    """Write a checkpoint atomically; returns the final directory path.
    With a ``layout``: collective; mesh rank 0 writes and, when
    ``blocking``, the other ranks wait for it."""
    host = host_global(tree, layout, need={0} if layout is not None else None)
    final = os.path.join(root, f"step_{step:08d}")
    if layout is not None and not layout.writer:
        if blocking:
            layout.barrier()
        return final
    if blocking:
        _write(root, step, host)
        if layout is not None:
            layout.barrier()
        return final
    threading.Thread(target=_write, args=(root, step, host), daemon=True).start()
    return final


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = []
    for d in os.listdir(root):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(root, d, "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore(root: str, step: int, like: Any, layout: Layout | None = None) -> Any:
    """Load a checkpoint into the structure of ``like`` (anything with
    ``shape`` and ``dtype`` a leaf: tensors, ``meta`` tensors), as host
    tensors of ``like``'s dtypes.  With a ``layout`` each leaf is this
    rank's block of the global array on disk, ``like`` the blocks."""
    path = os.path.join(root, f"step_{step:08d}")
    named, treedef = flatten_with_names(like)
    spec_of = dict(flatten_with_names(layout.specs)[0]) if layout is not None else {}
    coords = layout.mesh.coords(layout.rank) if layout is not None else None
    out = []
    for n, leaf in named:
        # mapped, not read: a rank copies out its own block only
        v = np.load(os.path.join(path, _fname(n)), mmap_mode="r")
        want = tuple(leaf.shape)
        if layout is not None:
            want = global_shape(want, spec_of[n], layout.mesh)
        if tuple(v.shape) != want:
            raise ValueError(f"{n}: checkpoint {v.shape} != expected {want}")
        if layout is not None:
            v = shard_leaf(v, spec_of[n], layout.mesh, coords)
        out.append(tensor_from_numpy(v).to(leaf.dtype))
    return tree_unflatten(treedef, out)


def train_state_layout(ts) -> Layout:
    """The ``Layout`` of a train step's ``{"params", "opt"}`` tree: the
    params by their specs; an optimizer state sub-tree keyed by the
    param names by the params' specs; ZeRO-1's flat shards over the dp
    axes.  ZeRO-1 under tensor parallelism is refused: its dp shards of
    each model rank hold that rank's own values, which no global flat
    array holds (the reference writes one model rank's copy, its own
    ``repro/elastic/reshard.py`` calls that view a lie); move that state
    with ``repro_torch.elastic.ElasticCheckpointer``."""
    mesh = ts.mesh
    like = ts.opt_state_like
    pspec_of = dict(flatten_with_names(ts.param_specs)[0])
    if ts.zero1:
        if mesh.shape.get("model", 1) > 1:
            raise ValueError(
                f"ZeRO-1 optimizer state at tp={mesh.shape['model']} has no "
                f"global flat view (each model rank's dp shards hold its own "
                f"values); checkpoint it with repro_torch.elastic."
                f"ElasticCheckpointer, which saves the param-shaped view")
        dp = dp_axes_of(mesh)
        dp_spec = ((dp if len(dp) > 1 else dp[0]),) if dp else ()
        named, treedef = flatten_with_names(like)
        ospecs = tree_unflatten(treedef, [dp_spec if l.dim() == 1 else () for _, l in named])
    else:
        def spec(sub):
            if isinstance(sub, dict) and set(sub) <= set(pspec_of):
                return {k: pspec_of[k] for k in sub}
            named, treedef = flatten_with_names(sub)
            return tree_unflatten(treedef, [() for _ in named])
        ospecs = {k: spec(v) for k, v in like.items()}
    gs = ts.gradsync
    return Layout(mesh, {"params": ts.param_specs, "opt": ospecs},
                  gs.groups[min(gs.groups)], ts.device)


class CheckpointManager:
    """Periodic async checkpointing with retention (keep the last k).

    ``retries``/``backoff_s`` wrap every save and restore attempt in
    retry with exponential backoff against transient I/O faults (flaky
    network filesystems, the elastic supervisor's injected faults).  Each
    attempt goes through the tmp-dir + rename protocol, so an attempt
    that dies mid-write never becomes ``latest()``.  ``fault_injector(op)``
    (op "save" or "restore") is called at the START of each attempt;
    raising ``OSError`` from it simulates the transient fault.

    Several ranks: ``layout`` (or ``attach_step(ts)``, which the
    ``Trainer`` calls: ``train_state_layout`` on the first save or
    restore) makes saves collective.  The snapshot is taken on every
    rank; only mesh rank 0 writes, so only its saves meet the fault
    injector; ``wait()`` joins its writer thread and then meets the
    other ranks on a barrier, after every save.  ``latest()`` and
    ``restore`` wait first: a save in flight lands before the directory
    is read, so every rank reads the same step.
    """

    def __init__(self, root: str, *, every: int = 100, keep: int = 3,
                 blocking: bool = False, retries: int = 0,
                 backoff_s: float = 0.05,
                 fault_injector: Callable[[str], None] | None = None,
                 layout: Layout | None = None):
        self.root = root
        self.every = every
        self.keep = keep
        self.blocking = blocking
        self.retries = retries
        self.backoff_s = backoff_s
        self.fault_injector = fault_injector
        self.layout = layout
        self._step_fn = None
        self._last_thread: Optional[threading.Thread] = None
        self._unsynced = False
        os.makedirs(root, exist_ok=True)

    def attach_step(self, ts) -> None:
        """Take the layout of ``ts``'s state (``train_state_layout``) when
        it is first needed, unless one was given."""
        self._step_fn = ts

    def _layout(self) -> Layout | None:
        if self.layout is None and self._step_fn is not None:
            self.layout = train_state_layout(self._step_fn)
        return self.layout

    def _with_retries(self, op: str, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` with up to ``retries`` retried attempts; sleeps
        ``backoff_s * 2**i`` between attempts."""
        attempts = self.retries + 1
        for i in range(attempts):
            try:
                if self.fault_injector is not None:
                    self.fault_injector(op)
                return fn()
            except OSError:
                if i == attempts - 1:
                    raise
                time.sleep(self.backoff_s * (2 ** i))

    def _save(self, step: int, tree: Any, blocking: bool) -> None:
        layout = self._layout()
        host = host_global(tree, layout, need={0} if layout is not None else None)
        self._write_host(step, host, blocking)

    def _write_host(self, step: int, host, blocking: bool) -> None:
        """Write a snapshot on the writer (``host``: ``host_global``'s
        list there, None on the other ranks), with the retry policy."""
        layout = self._layout()
        self._unsynced = layout is not None
        if layout is not None and not layout.writer:
            if blocking:
                self.wait()
            return

        def write():
            self._with_retries("save", lambda: _write(self.root, step, host))

        if blocking:
            write()
            self.wait()
        else:
            self._last_thread = threading.Thread(target=write, daemon=True)
            self._last_thread.start()

    def maybe_save(self, step: int, tree: Any) -> bool:
        if step % self.every:
            return False
        self.wait()
        self._save(step, tree, self.blocking)
        self._gc()
        return True

    def save_host(self, step: int, host) -> None:
        """Blocking save of a snapshot already on the writer's host (the
        global view ``host_global`` gives it; None on the other ranks):
        a transition's anchor, whose view the transfer assembled."""
        self.wait()
        self._write_host(step, host, True)
        self._gc()

    def save_now(self, step: int, tree: Any) -> None:
        """Blocking save with the retry policy: the supervisor's
        post-transition anchor checkpoint."""
        self.wait()
        self._save(step, tree, True)
        self._gc()

    def wait(self):
        if self._last_thread is not None:
            self._last_thread.join()
            self._last_thread = None
        if self._unsynced:
            self._unsynced = False
            self.layout.barrier()

    def _gc(self):
        if self.layout is not None and not self.layout.writer:
            return
        steps = sorted(
            int(m.group(1))
            for d in os.listdir(self.root)
            if (m := re.fullmatch(r"step_(\d+)", d)))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)

    def latest(self) -> Optional[int]:
        self.wait()
        return latest_step(self.root)

    def restore(self, like: Any, step: Optional[int] = None) -> tuple[int, Any]:
        s = self.latest() if step is None else step
        if s is None:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        self.wait()
        layout = self._layout()
        return s, self._with_retries("restore", lambda: restore(self.root, s, like, layout))

    def manifest(self, step: int) -> list[str]:
        """Leaf names recorded in a checkpoint's manifest: lets a restorer
        check the target structure (that a deferred step's
        ``opt_state["pending"]`` carry is there) before loading arrays."""
        path = os.path.join(self.root, f"step_{step:08d}", "manifest.json")
        with open(path) as f:
            return [leaf["name"] for leaf in json.load(f)["leaves"]]
