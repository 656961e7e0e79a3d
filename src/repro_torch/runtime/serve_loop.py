"""Serving runtime (``repro/runtime/serve_loop.py``): static batcher and
continuous-batching engine, on a ("data", "model") mesh of any extent.

- ``Server``/``RequestQueue`` — the static batcher: one padded batch
  prefills together and decodes to the batch-wide ``max_new``.  Decode
  tokens stay on the device and come to the host once per ``generate``.

- ``ContinuousScheduler`` — in-flight batching over a paged KV pool
  (DESIGN.md §14): a fixed-width decode batch whose slots are admitted
  and retired per step.  A new request prefills (right-padded to a
  block-aligned bucket, logits read at its true last token) into a free
  slot and its KV rows are scattered into the pool; decode runs in
  chunks of ``chunk`` steps with one host sync per chunk (tokens come
  back ``-1``-masked per slot); finished or EOS slots retire at the
  chunk boundary and their blocks return to the allocator
  (``runtime/kvcache.py``).

Where the reference donates its caches to jitted functions, the port
updates the cache and pool tensors in place: ``decode_step`` and
``decode_step_paged`` write each new k/v row into them, and admission
writes a prompt's rows into the pool.

Sharding is the reference's: heads and vocab over "model", batch rows and
slots over the dp axes.  Every rank runs the same host code on the same
requests (SPMD); its ``Server`` holds the rank's shards, its
``ModelAxis`` and its dp group (an ``FsdpAxes``, which FSDP's per-layer
gathers share), built once from the mesh.  ``generate`` prefills and
decodes dp rank d's rows of the batch and all-gathers the tokens over
the dp group once at the end.  The continuous engine's slot w belongs to
dp rank ``w // W_local`` and its blocks index that rank's pool; a
request's prefill runs on every rank (every model group's psums, every
FSDP gather) and only the owner writes its rows; each chunk decodes each
rank's ``W_local`` slots, masked where inactive, and all-gathers the
(chunk, W_local) tokens over the dp group, so that every rank's host
mirror replays the same (chunk, W) tokens.  Every rank thus issues the
same collectives in the same order on each group.

The samplers work on the vocab-sharded logits (B, V/tp) without a
full-vocab gather: ``sharded_argmax`` all-gathers each shard's maximum
and its global index, ``sharded_sample`` each shard's ``K_CAND`` best
candidates; each makes one all-gather over the model group.  The draw's
inputs are then bitwise equal on every rank of a model group, and so is
the token each draws.

A config with cross-attention (llama-3.2-vision) is refused by both
engines: its prefill and decode need image embeddings, and the
reference's engines call ``prefill(params, tokens, cfg)`` with none
(``repro/runtime/serve_loop.py:172``, ``:435``).  Such a model is served
through ``prefill``/``decode_step`` with ``img_embeds`` directly.

Sampling draws come from a ``torch.Generator`` seeded from ``(seed,
pos + 1)`` per row, where the reference folds ``pos + 1`` into
``PRNGKey(seed)``: the same request and position always draw the same
token, but the bits differ from ``jax.random``'s.  Greedy picks are exact
and equal the reference's: ``torch.argmax`` returns the first maximum,
as ``jnp.argmax`` does, and across shards the lowest shard wins a tie.
"""
from __future__ import annotations

import dataclasses
import math
import queue
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import dependency as dep
from repro_torch.models.common import (NO_FSDP, NO_MODEL_AXIS, FsdpAxes, ModelAxis,
                                       _check_axis, fsdp_all_gather, model_all_gather,
                                       model_axis)
from repro_torch.models.registry import family_of
from repro_torch.obs import MetricsRegistry
from repro_torch.parallel.sharding import MODEL_AXIS, batch_spec, dp_axes_of, dp_index
from repro_torch.runtime.kvcache import SCRATCH_BLOCK, BlockAllocator, PagedLayout
from repro_torch.utils.trees import flatten_with_names


# ------------------------------------------------------------- samplers
def sharded_argmax(logits_local: torch.Tensor, tp: int,
                   axis: ModelAxis = NO_MODEL_AXIS) -> torch.Tensor:
    """Greedy token from (B, V/tp) vocab-sharded logits → (B,) int32
    global ids.  Each shard's maximum and its first index (plus the
    shard's offset) go to every rank in one all-gather; the highest wins,
    the lowest shard on ties, and within it the lowest index."""
    _check_axis(tp, axis)
    arg = torch.argmax(logits_local, dim=-1)
    if tp == 1:
        return arg.to(torch.int32)
    B, v_local = logits_local.shape
    # f32 values and int ids are exact in f64: one tensor, one collective
    mine = torch.stack([logits_local.gather(-1, arg[:, None])[:, 0].double(),
                        (arg + axis.index * v_local).double()], dim=-1)
    every = model_all_gather(mine, axis, dim=0).view(tp, B, 2)
    best = torch.argmax(every[..., 0], dim=0)            # the first shard on ties
    return every[..., 1].gather(0, best[None])[0].to(torch.int32)


_U64 = (1 << 64) - 1
K_CAND = 16          # sampling candidates per row and shard (the reference's default)


def draw_generator(seed: int, pos: int, device) -> torch.Generator:
    """The generator of one row's draw at position ``pos``, seeded from
    ``(seed, pos + 1)`` — the reference's ``fold_in(PRNGKey(seed),
    pos + 1)``.  The pair is packed into 64 bits and mixed (splitmix64's
    finalizer), so every seed bit reaches the low 32 bits that the CPU
    generator keeps."""
    x = ((int(seed) & 0xFFFFFFFF) << 32 | ((int(pos) + 1) & 0xFFFFFFFF))
    x = (x + 0x9E3779B97F4A7C15) & _U64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _U64
    return torch.Generator(device=device).manual_seed(x ^ (x >> 31))


def sharded_candidates(logits_local: torch.Tensor, tp: int,
                       axis: ModelAxis = NO_MODEL_AXIS) -> tuple[torch.Tensor, torch.Tensor]:
    """The sampling candidates of (B, V/tp) vocab-sharded logits: each
    shard's ``K_CAND`` best in the order (value desc, index asc), by a
    stable sort; at tp > 1 one all-gather moves the tp × K_CAND of every
    shard (values and global ids, shard-major), and a stable sort by
    value, descending, orders them (value desc, shard asc, index asc).
    Returns (values (B, K) in the logits' dtype, global ids (B, K) int64),
    the same on every rank of the model group."""
    _check_axis(tp, axis)
    B, v_local = logits_local.shape
    k = min(K_CAND, v_local)
    vals, idx = torch.sort(logits_local, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    if tp == 1:
        return vals, idx
    mine = torch.stack([vals.double(), (idx + axis.index * v_local).double()], dim=-1)
    every = model_all_gather(mine, axis, dim=0).view(tp, B, k, 2)
    every = every.transpose(0, 1).reshape(B, tp * k, 2)
    order = torch.sort(every[..., 0], dim=-1, descending=True, stable=True).indices
    every = every.gather(1, order[..., None].expand(-1, -1, 2))
    return every[..., 0].to(logits_local.dtype), every[..., 1].long()


def sharded_sample(
    logits_local: torch.Tensor,          # (B, V/tp) f32 vocab-sharded logits
    tp: int,
    generators: Optional[Sequence[torch.Generator]],   # one per row, or None
    temperature: torch.Tensor,           # (B,) f32; 0 → greedy (exact argmax)
    top_k: torch.Tensor,                 # (B,) int; 0 → no top-k cap
    top_p: torch.Tensor,                 # (B,) f32; 1.0 → no nucleus cap
    axis: ModelAxis = NO_MODEL_AXIS,
) -> torch.Tensor:
    """Temperature/top-k/top-p sampling → (B,) int32 global ids.

    The candidates are ``sharded_candidates``': the head candidate is
    exactly ``sharded_argmax``'s pick, and at temperature 0 a row takes
    it.  The draw among the candidates uses each row's generator.  As the
    reference's, the draw is exact whenever the effective top-k is at
    most ``K_CAND``; an unbounded draw (top_k 0, top_p 1) is truncated to
    the tp × ``K_CAND`` candidates.  ``generators=None`` says that no row
    samples (every temperature is 0): then no draw is made and the result
    is ``sharded_argmax``'s.
    """
    if generators is None:
        return sharded_argmax(logits_local, tp, axis)
    B = logits_local.shape[0]
    if len(generators) != B:
        raise ValueError(f"{len(generators)} generators for {B} rows")
    vals, idx = sharded_candidates(logits_local, tp, axis)
    K = vals.shape[-1]
    greedy = idx[:, 0].to(torch.int32)
    t = temperature.clamp_min(1e-6)[:, None]
    scaled = vals.float() / t
    ranks = torch.arange(K, device=logits_local.device)[None, :]
    kcap = torch.where(top_k > 0, top_k.clamp_max(K), K)[:, None]
    mask = ranks < kcap
    probs = torch.softmax(torch.where(mask, scaled, -torch.inf), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # nucleus: keep candidates whose preceding mass is < top_p (the head
    # candidate always survives: its preceding mass is 0)
    mask &= (cum - probs) < top_p[:, None]
    probs = torch.softmax(torch.where(mask, scaled, -torch.inf), dim=-1)
    draw = torch.cat([torch.multinomial(probs[b], 1, generator=g)
                      for b, g in enumerate(generators)])
    sampled = idx.gather(1, draw[:, None])[:, 0].to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs; the default is greedy decoding."""
    temperature: float = 0.0
    top_k: int = 0               # 0 → no cap
    top_p: float = 1.0
    seed: int = 0


# ------------------------------------------------------- static batcher
class Server:
    """Batched greedy-decoding server for any family with serve hooks.

    ``mesh`` is the port's ``launch.mesh.Mesh``: its size must be the
    process group's world (1 without one) and its "model" extent the
    config's tp.  ``params`` is the family's parameter tree as this rank
    holds it (its shards at tp > 1 or under FSDP), on the device that
    serves.  The rank's ``ModelAxis`` and dp group are made here, once
    (collective: every rank makes its ``Server`` together); ``close``
    destroys them.
    """

    def __init__(self, cfg, mesh, params, *, max_len: int = 256,
                 metrics: MetricsRegistry | None = None):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.cfg = cfg
        self.mesh = mesh
        self.api = family_of(cfg)
        if self.api.prefill is None:
            raise ValueError(f"{cfg.name} has no serve path")
        if getattr(cfg, "n_cross", 0):
            raise ValueError(
                f"{cfg.name}: the engines take no images, and its cross-attention "
                f"layers need img_embeds (the reference's engines prefill with none); "
                f"call prefill/decode_step with img_embeds instead")
        self.params = params
        self.device = flatten_with_names(params)[0][0][1].device
        self.max_len = max_len
        self.tp = getattr(cfg, "tp", 1)
        if mesh.shape.get(MODEL_AXIS, 1) != self.tp:
            raise ValueError(f"tp={self.tp} on a mesh with model extent "
                             f"{mesh.shape.get(MODEL_AXIS, 1)}")
        world = dist.get_world_size() if dist.is_initialized() else 1
        if mesh.world_ranks[-1] >= world:
            raise ValueError(f"a mesh of {mesh.size} ranks ({dict(mesh.shape)}) does not "
                             f"fit a world of {world}")
        me = dep.mesh_rank(mesh)
        if me is None:
            raise ValueError(f"rank {dist.get_rank()} is outside the mesh over the "
                             f"world ranks {mesh.world_ranks}: it serves nothing")
        dp_axes = dp_axes_of(mesh)
        self.dp_size = math.prod(mesh.shape[a] for a in dp_axes)
        self.dp_index = dp_index(me, mesh)
        fsdp = getattr(cfg, "fsdp", False)
        if fsdp and dep.reduce_key(cfg.dp_axes, mesh) != dep.reduce_key(dp_axes, mesh):
            raise ValueError(f"{cfg.name}: FSDP shards over {cfg.dp_axes}, the mesh's dp "
                             f"axes are {dp_axes}")
        self.axis = model_axis(mesh, self.device) if self.tp > 1 else NO_MODEL_AXIS
        self.dp = NO_FSDP
        if self.dp_size > 1:     # the dp group: the tokens' gather, FSDP's gathers
            key = dep.reduce_key(dp_axes, mesh)
            self.dp = FsdpAxes(dep.coset_groups([key], mesh, self.device)[key],
                               self.dp_index, self.dp_size)
        # the family functions' keywords: the rank's axes, where they shard
        self.fwd_kw = {}
        if self.tp > 1:
            self.fwd_kw["model_axis"] = self.axis
        if fsdp and self.dp_size > 1:
            self.fwd_kw["fsdp"] = self.dp
        # the cache leaves that carry batch rows, and their batch dim (the
        # continuous engine takes its one prefill row by it)
        entry = batch_spec(mesh)[0]
        self.batch_dims = {n: spec.index(entry)
                           for n, spec in self.api.decode_state_specs(cfg, entry).items()}

    def close(self) -> None:
        """Destroy the communicators ``__init__`` made (collective)."""
        for group in (self.axis.group, self.dp.group):
            if group is not None:
                dist.destroy_process_group(group)
        self.axis, self.dp = NO_MODEL_AXIS, NO_FSDP
        self.fwd_kw = {}

    def _pad_cache(self, cache: dict, prompt_len: int) -> dict:
        """Grow the family's sequence-laid cache leaves (dim 2 =
        prompt_len) to max_len slots; every other leaf, such as a
        recurrent state, passes through untouched."""
        pad_n = self.max_len - prompt_len
        if pad_n <= 0:
            return cache
        return {n: (torch.nn.functional.pad(c, (0, 0, 0, 0, 0, pad_n))
                    if n in self.api.seq_cache_leaves else c)
                for n, c in cache.items()}

    def generate(self, prompts: np.ndarray, max_new: int) -> np.ndarray:
        """prompts: (B, S) int, the global batch → (B, max_new) int32 greedy
        continuations, the same on every rank.

        The rank prefills and decodes its dp rank's rows of the batch (B /
        dp of them, in ``batch_spec``'s order).  Tokens accumulate on the
        device, are all-gathered over the dp group once, and come to the
        host once at the end.
        """
        cfg, api = self.cfg, self.api
        B, S = prompts.shape
        if B % self.dp_size:
            raise ValueError(f"batch {B} not divisible by dp={self.dp_size}")
        rows = B // self.dp_size
        t_start = time.perf_counter()
        mine = np.asarray(prompts)[self.dp_index * rows:(self.dp_index + 1) * rows]
        toks = torch.as_tensor(mine, dtype=torch.int32, device=self.device)
        logits, cache = api.prefill(self.params, toks, cfg, **self.fwd_kw)
        tok = sharded_argmax(logits.float(), self.tp, self.axis)
        cache = self._pad_cache(cache, S)
        t_prefill = time.perf_counter()
        out = [tok]
        pos = S
        for _ in range(max_new - 1):
            logits, cache = api.decode_step(self.params, cache, tok, pos, cfg, **self.fwd_kw)
            tok = sharded_argmax(logits.float(), self.tp, self.axis)
            out.append(tok)
            pos += 1
        every = fsdp_all_gather(torch.stack(out, dim=1), 0, self.dp)
        result = every.cpu().numpy()                     # ONE host sync
        t_end = time.perf_counter()
        self.metrics.counter("serve.requests_total").inc(B)
        self.metrics.counter("serve.tokens_generated").inc(B * max_new)
        self.metrics.histogram("serve.prefill_s").observe(t_prefill - t_start)
        if max_new > 1:
            self.metrics.histogram("serve.decode_per_token_s").observe(
                (t_end - t_prefill) / (max_new - 1))
        self.metrics.gauge("serve.tokens_per_s").set(
            B * max_new / max(t_end - t_start, 1e-9))
        return result


class RequestQueue:
    """Minimal batching front-end: collects up to ``batch`` requests (or
    ``timeout_s``), left-pads them to a common length, serves, returns
    per-request.

    If ``Server.generate`` raises, the exception instance is delivered
    to EVERY waiter's done queue (callers check
    ``isinstance(result, Exception)``): waiters never block forever on a
    failed batch."""

    def __init__(self, server: Server, batch: int, timeout_s: float = 0.05):
        self.server = server
        self.batch = batch
        self.timeout_s = timeout_s
        self.q: queue.Queue = queue.Queue()

    def submit(self, prompt: np.ndarray, max_new: int) -> "queue.Queue":
        done: queue.Queue = queue.Queue(maxsize=1)
        self.q.put((prompt, max_new, done))
        return done

    def serve_once(self) -> int:
        """Drain up to ``batch`` requests, run one padded generate."""
        reqs = []
        try:
            reqs.append(self.q.get(timeout=self.timeout_s))
            while len(reqs) < self.batch:
                reqs.append(self.q.get_nowait())
        except queue.Empty:
            pass
        if not reqs:
            return 0
        max_len = max(r[0].shape[0] for r in reqs)
        max_new = max(r[1] for r in reqs)
        n = len(reqs)
        m = self.server.metrics
        m.counter("serve.batches_total").inc()
        m.gauge("serve.batch_fill").set(n / self.batch)
        toks = np.zeros((self.batch, max_len), np.int32)
        for i, (p, _, _) in enumerate(reqs):
            toks[i, max_len - p.shape[0]:] = p   # left-pad
        out: np.ndarray | None = None
        err: Exception | None = None
        try:
            out = self.server.generate(toks, max_new)
        except Exception as e:                   # noqa: BLE001 — delivered
            err = e
        for i, (_, mn, done) in enumerate(reqs):
            done.put(err if err is not None else out[i, :mn])
        return n


# -------------------------------------------- continuous-batching engine
@dataclasses.dataclass
class Request:
    """One in-flight generation request (engine-internal state)."""
    rid: int
    prompt: np.ndarray
    max_new: int
    sampling: SamplingParams
    done: queue.Queue
    tokens: list[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_first: float = 0.0


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    blocks: list[int] = dataclasses.field(default_factory=list)
    pos: int = 0                 # absolute position of ``tok``
    tok: int = 0                 # last token (feeds the next decode step)
    rem: int = 0                 # tokens still to emit (0 → inactive)

    @property
    def free(self) -> bool:
        return self.req is None


class ContinuousScheduler:
    """In-flight batching over a paged KV pool (DESIGN.md §14).

    A fixed-width decode batch of ``slots`` whose rows are admitted and
    retired independently.  Admission prefills the prompt (right-padded
    to a block-aligned bucket, logits read at the true last token via
    ``last_pos``), samples the first token, and writes the prompt's KV
    rows into the pool.  Decode then runs ``chunk`` steps with one host
    sync per chunk; slots whose budget or EOS hits mid-chunk go inactive
    on the device (they rewrite their own next row) and retire on the
    host at the chunk boundary, freeing their blocks at once.

    Greedy tokens equal the static path's when ``block_size`` divides the
    server's ``max_len``: the gathered decode extent (``max_blocks ×
    block_size``) then equals the static cache's ``max_len``, masked
    positions contribute exactly 0, and the write-then-attend order
    matches ``decode_step``.

    The slots are spread over the server's dp ranks, ``W_local = slots /
    dp`` each: slot w belongs to dp rank ``w // W_local``, whose pool
    (the rank's kv heads) holds its blocks, from that rank's allocator.
    Every rank keeps the whole host mirror (every slot, every allocator)
    and runs every admission's prefill; each chunk decodes the rank's own
    slots and all-gathers their tokens over the dp group.

    Failure semantics match ``RequestQueue``: a raise during admission
    fails that request's done queue; a raise during a decode chunk fails
    every in-flight request (the pool state is indeterminate) and the
    engine resets.
    """

    def __init__(self, server: Server, *, slots: int = 8,
                 block_size: int = 32, chunk: int = 8,
                 eos_id: int | None = None):
        self.server = server
        self.cfg = server.cfg
        self.api = server.api
        self.device = server.device
        if self.api.decode_paged is None:
            raise ValueError(f"{self.cfg.name}'s family has no paged decode hook")
        if server.max_len % block_size:
            raise ValueError(
                f"block_size {block_size} must divide max_len "
                f"{server.max_len} (bit-exact decode extent)")
        self.dp_size = server.dp_size
        if slots % self.dp_size:
            raise ValueError(f"slots {slots} not divisible by dp={self.dp_size}")
        self.W = slots
        self.W_local = slots // self.dp_size
        self._own = slice(server.dp_index * self.W_local,
                          (server.dp_index + 1) * self.W_local)
        self.chunk = chunk
        self.eos_id = -1 if eos_id is None else int(eos_id)
        self.layout = PagedLayout.for_requests(
            server.max_len, block_size, self.W_local)
        # one allocator a dp rank: slot w's blocks index rank w // W_local's pool
        self.allocators = [BlockAllocator(self.layout) for _ in range(self.dp_size)]
        self.slots = [_Slot() for _ in range(self.W)]
        self.queue: "queue.Queue[Request]" = queue.Queue()
        self._backlog: list[Request] = []    # popped but not yet admitted
        self._next_rid = 0
        self.metrics = server.metrics
        self._tables = np.full((self.W, self.layout.max_blocks),
                               SCRATCH_BLOCK, np.int32)
        self.pool_k, self.pool_v = self._init_pool()

    def _init_pool(self):
        """The rank's pool: its blocks, its kv heads."""
        cfg = self.cfg
        shape = (cfg.n_self, self.layout.num_blocks, self.layout.block_size,
                 cfg.layout.kv_local, cfg.hd)
        return (torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                torch.zeros(shape, dtype=cfg.dtype, device=self.device))

    # ------------------------------------------------------------- API
    def submit(self, prompt: np.ndarray, max_new: int,
               sampling: SamplingParams | None = None) -> "queue.Queue":
        """Enqueue one request; returns its done queue.  The result is a
        (≤ max_new,) int32 token array, or an Exception instance."""
        done: queue.Queue = queue.Queue(maxsize=1)
        sp = sampling or SamplingParams()
        L = int(prompt.shape[0])
        cap = self.layout.seq_capacity
        if L + max_new > cap or max_new < 1 or L < 1:
            done.put(ValueError(
                f"request needs {L}+{max_new} positions > capacity {cap}"))
            return done
        req = Request(self._next_rid, np.asarray(prompt, np.int32),
                      int(max_new), sp, done, t_submit=time.perf_counter())
        self._next_rid += 1
        self.queue.put(req)
        return done

    def _bucket(self, L: int) -> int:
        bs = self.layout.block_size
        return -(-L // bs) * bs

    def _allocator(self, w: int) -> BlockAllocator:
        return self.allocators[w // self.W_local]

    def _retire(self, w: int) -> None:
        s = self.slots[w]
        r = s.req
        self._allocator(w).free(s.blocks)
        self._tables[w, :] = SCRATCH_BLOCK
        self.slots[w] = _Slot()
        r.done.put(np.asarray(r.tokens, np.int32))
        self.metrics.histogram("serve.req_latency_s").observe(
            time.perf_counter() - r.t_submit)
        self.metrics.counter("serve.tokens_generated").inc(len(r.tokens))

    def _admit(self) -> int:
        """Fill free slots from the queue (FIFO, no reordering)."""
        admitted = 0
        while True:
            if not self._backlog:
                try:
                    self._backlog.append(self.queue.get_nowait())
                except queue.Empty:
                    break
            req = self._backlog[0]
            need = len(req.prompt) + req.max_new
            w = next((i for i, s in enumerate(self.slots)
                      if s.free and self._allocator(i).can_fit(need)), None)
            if w is None:
                break                            # head-of-line blocks: FIFO
            self._backlog.pop(0)
            try:
                self._start(w, req)
                admitted += 1
            except Exception as e:               # noqa: BLE001 — delivered
                req.done.put(e)
        return admitted

    def _vec(self, values, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values), dtype=dtype, device=self.device)

    def _start(self, w: int, req: Request) -> None:
        """Prefill ``req`` into slot ``w``: sample its first token and
        write the prompt's KV rows into the pool.  Every rank runs the
        prefill (its collectives are every rank's); the owner of ``w``
        writes the rows."""
        cfg, srv = self.cfg, self.server
        alloc = self._allocator(w)
        L = len(req.prompt)
        blocks = alloc.alloc(L + req.max_new)
        if blocks is None:
            raise RuntimeError("admission without room: _admit checks can_fit")
        Sb = self._bucket(L)
        toks = np.zeros((1, Sb), np.int32)
        toks[0, :L] = req.prompt                 # right-pad (causal-exact)
        sp = req.sampling
        try:
            logits, cache = self.api.prefill(
                srv.params, self._vec(toks, torch.int32), cfg, last_pos=L - 1,
                **srv.fwd_kw)
            gens = ([draw_generator(sp.seed, L - 1, self.device)]
                    if sp.temperature > 0 else None)
            tok = sharded_sample(
                logits.float(), cfg.tp, gens,
                self._vec([sp.temperature], torch.float32),
                self._vec([sp.top_k], torch.int32),
                self._vec([sp.top_p], torch.float32), srv.axis)
            if w // self.W_local == srv.dp_index:
                bs = self.layout.block_size
                row = np.asarray(alloc.table_row(blocks))
                p = np.arange(L)
                dest = self._vec(row[p // bs] * bs + p % bs, torch.long)
                rows = self.layout.num_blocks * bs
                for name, pool in (("k", self.pool_k), ("v", self.pool_v)):
                    c = cache[name].select(srv.batch_dims[name], 0)
                    pool.view(pool.shape[0], rows, *pool.shape[3:])[:, dest] = c[:, :L]
            first = int(tok[0])
        except Exception:
            alloc.free(blocks)
            raise
        req.tokens.append(first)
        req.t_first = time.perf_counter()
        self.metrics.histogram("serve.ttft_s").observe(req.t_first - req.t_submit)
        self.metrics.counter("serve.requests_total").inc()
        s = self.slots[w]
        s.req, s.blocks, s.pos, s.tok = req, blocks, L, first
        s.rem = req.max_new - 1
        if first == self.eos_id:
            s.rem = 0
        self._tables[w, :] = alloc.table_row(blocks)
        if s.rem == 0:
            self._retire(w)

    def _decode_chunk(self) -> np.ndarray:
        """``chunk`` decode steps of the rank's slots on the device, every
        step of the chunk whether or not a slot is active (inactive rows
        rewrite their own next row); returns the (chunk, W) emitted tokens
        of every rank's slots, -1 where a slot was inactive."""
        cfg, srv = self.cfg, self.server
        mine = self.slots[self._own]
        live = [s for s in mine if not s.free]
        sps = [s.req.sampling if not s.free else SamplingParams() for s in mine]
        pos0 = [s.pos for s in mine]
        toks = self._vec([s.tok for s in mine], torch.int32)
        pos = self._vec(pos0, torch.int32)
        rem = self._vec([s.rem for s in mine], torch.int32)
        temps = self._vec([sp.temperature for sp in sps], torch.float32)
        topks = self._vec([sp.top_k for sp in sps], torch.int32)
        topps = self._vec([sp.top_p for sp in sps], torch.float32)
        tables = self._vec(self._tables[self._own], torch.int32)
        sampling = any(s.req.sampling.temperature > 0 for s in live)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        outs = []
        for t in range(self.chunk):
            active = rem > 0
            logits, self.pool_k, self.pool_v = self.api.decode_paged(
                srv.params, self.pool_k, self.pool_v, tables, toks, pos, cfg,
                **srv.fwd_kw)
            # a row active at step t has been active since the chunk
            # began, so its position is pos0 + t: the host seeds its draw
            # without reading the device
            gens = ([draw_generator(sp.seed, p + t, self.device)
                     for sp, p in zip(sps, pos0)] if sampling else None)
            nxt = sharded_sample(logits.float(), cfg.tp, gens, temps, topks,
                                 topps, srv.axis)
            outs.append(torch.where(active, nxt, -1))
            fin = active & (nxt == self.eos_id)
            toks = torch.where(active, nxt, toks)
            pos = torch.where(active, pos + 1, pos)
            rem = torch.where(fin, zero, torch.where(active, rem - 1, zero))
        # every rank's (chunk, W_local) side by side: slot d·W_local + j
        every = fsdp_all_gather(torch.stack(outs), 1, srv.dp)
        return every.cpu().numpy()               # ONE host sync per chunk

    def step(self) -> int:
        """Admit waiting requests, decode one chunk, retire finished
        slots.  Returns the number of tokens emitted."""
        self._admit()
        active = [w for w, s in enumerate(self.slots) if not s.free]
        self.metrics.gauge("serve.batch_fill").set(len(active) / self.W)
        self.metrics.gauge("serve.kv_util").set(
            max(a.utilization for a in self.allocators))
        if not active:
            return 0
        try:
            outs = self._decode_chunk()
        except Exception as e:                   # noqa: BLE001 — delivered
            for w in active:
                self.slots[w].req.done.put(e)
                self._allocator(w).free(self.slots[w].blocks)
                self._tables[w, :] = SCRATCH_BLOCK
                self.slots[w] = _Slot()
            self.pool_k, self.pool_v = self._init_pool()
            return 0
        emitted = 0
        for w in active:
            s = self.slots[w]
            # replay the device transition on the host mirror
            for t in range(self.chunk):
                tok = int(outs[t, w])
                if tok < 0:
                    break
                emitted += 1
                s.req.tokens.append(tok)
                s.tok, s.pos, s.rem = tok, s.pos + 1, s.rem - 1
                if tok == self.eos_id:
                    s.rem = 0
                if s.rem == 0:
                    break
            if s.rem == 0:
                self._retire(w)
        return emitted

    @property
    def idle(self) -> bool:
        return (self.queue.empty() and not self._backlog
                and all(s.free for s in self.slots))

    def run_until_idle(self, max_steps: int = 100_000) -> int:
        total = 0
        for _ in range(max_steps):
            total += self.step()
            if self.idle:
                return total
        raise RuntimeError("run_until_idle: engine did not drain")

    def generate_batch(self, prompts: list[np.ndarray], max_new: int,
                       sampling: SamplingParams | None = None
                       ) -> list[np.ndarray]:
        """Convenience: submit all, drain, return per-request tokens
        (raises the first per-request error, if any)."""
        dones = [self.submit(p, max_new, sampling) for p in prompts]
        self.run_until_idle()
        out = []
        for d in dones:
            r = d.get_nowait()
            if isinstance(r, Exception):
                raise r
            out.append(r)
        return out
