"""Fault-injecting supervisor: the elastic policy ladder above the
Trainer (``repro/elastic/supervisor.py``).

The Trainer owns rungs 1–2 (retry the step in place, restore and
replay from a checkpoint).  Rungs 3–4 — shrink to a smaller mesh when
members are lost or persistently slow, grow back when capacity returns —
need a NEW mesh, which a loop bound to one mesh cannot build.
``Supervisor`` runs the Trainer in segments over a mesh *ladder*,
catching ``RankLost`` / ``RemeshRequest`` and executing the transition:

    finalize the deferred carry → plan_reshard (verified IR, byte count)
    → reshard_state (old-mesh gathers, the global view on the host, the
      joining ranks' blocks sent to them, new-mesh scatters) → blocking
      anchor checkpoint for the NEW mesh's codec, written from the
      transfer's view (the bytes ``save_now`` of the decoded state writes)

Every transition the faulty run *realizes* is recorded as a script
``(resume_step, mesh_key)``; replaying it with no faults gives the clean
twin, whose final state must be bit-exact with the faulty run's.

One process a rank: the supervisor runs on every world rank, and a rung
may hold fewer ranks than the world (``parallel/sharding.py::Mesh.
ranks``).  ``build(key)`` runs on every rank (its communicators are
collective over the world); a rank outside the rung gets no step, holds
no state of it (its params' memory is released) and only takes part in
the transitions.  Every rung's first world rank is one rank, the
checkpoint writer: it holds the global view at every transition.  After
each segment the rung's first rank broadcasts how it ended, so every
rank takes the same transition.  The fault plan is the same on every
rank; the checkpoint-I/O fault budget is counted per process: saves
meet it on the writer only (no other rank writes), restores on every
rank.  A "lost" rank is simulated, as in the reference: its shards are
still read.

``ElasticCheckpointer`` speaks the Trainer's ``{"params", "opt"}``
protocol but persists the ``StateCodec`` encoding: the param-shaped
global view that any mesh of the ladder can decode.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Mapping, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.elastic.reshard import StateCodec, plan_reshard, reshard_state
from repro_torch.obs import EventLog, MetricsRegistry
from repro_torch.runtime.train_loop import (
    RankLost,
    RemeshRequest,
    Trainer,
    TransientStepError,
    copy_into,
)
from repro_torch.utils.trees import flatten_with_names


class ElasticCheckpointer:
    """Mesh-portable checkpointing: the Trainer's protocol, the codec's
    encoding.

    ``maybe_save``/``save_now`` encode the live ``{"params", "opt"}``
    state into the codec's view (collective over the mesh) and hand it to
    the ``CheckpointManager`` with the codec's layout; ``restore`` reads
    this rank's blocks of that view and decodes them onto the CURRENT
    codec's mesh.  ``attach`` swaps the codec at a mesh transition: old
    checkpoints stay restorable, the trees on disk being global."""

    def __init__(self, manager: CheckpointManager, codec: StateCodec):
        self.manager = manager
        self.codec = codec
        manager.layout = codec.layout

    def attach(self, codec: StateCodec) -> None:
        self.manager.wait()
        self.codec = codec
        self.manager.layout = codec.layout

    def _encode(self, tree: Mapping[str, Any]) -> dict[str, Any]:
        return self.codec.encode(tree["params"], tree["opt"])

    def maybe_save(self, step: int, tree: Mapping[str, Any]) -> bool:
        if step % self.manager.every:
            return False
        return self.manager.maybe_save(step, self._encode(tree))

    def save_now(self, step: int, tree: Mapping[str, Any]) -> None:
        self.manager.save_now(step, self._encode(tree))

    def save_view(self, step: int, view: Mapping[str, torch.Tensor] | None) -> None:
        """Blocking save of the codec's encoding already assembled on the
        writer's host (``view``: name → global tensor there, None on the
        other ranks; a missing ``pending`` carry is written as zeros, what
        the decoded state holds): a transition's anchor, bit for bit what
        ``save_now`` of the decoded state writes, without encoding it
        again."""
        host = None
        if view is not None:
            named = flatten_with_names(self.codec.global_like())[0]
            host = [(n, view[n] if n in view else torch.zeros(l.shape, dtype=l.dtype))
                    for n, l in named]
        self.manager.save_host(step, host)

    def restore(self, like: Any, step: Optional[int] = None) -> tuple[int, Any]:
        # ``like`` (the live trees) is not read: the on-disk structure is
        # the codec's encoded view
        s, encoded = self.manager.restore(self.codec.encoded_like(), step)
        params, opt_state = self.codec.decode(encoded)
        return s, {"params": params, "opt": opt_state}

    def latest(self) -> Optional[int]:
        return self.manager.latest()

    def wait(self) -> None:
        self.manager.wait()

    def manifest(self, step: int) -> list[str]:
        return self.manager.manifest(step)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """What the supervisor injects, and how the ladder responds.

    Each step-keyed fault fires ONCE (the replayed step after recovery
    runs clean, as a recovered fleet would).  ``ckpt_io_faults`` is a
    budget of transient ``OSError``s raised at the start of checkpoint
    save/restore attempts, which the manager's retry with backoff must
    absorb without breaking the atomic rename protocol."""

    rank_loss: frozenset[int] = frozenset()     # RankLost at these steps
    transient: frozenset[int] = frozenset()     # TransientStepError once
    step_retries: int = 1                       # rung-1 budget per step
    ckpt_io_faults: int = 0                     # OSError budget (total)
    ckpt_retries: int = 3                       # manager retry budget
    straggler: frozenset[int] = frozenset()     # sleep at these steps
    straggler_s: float = 0.0
    straggler_shrink: bool = False              # opt-in rung 3 for stragglers


@dataclasses.dataclass
class Transition:
    """One realized mesh transition (also the clean-replay script row)."""

    resume_step: int
    from_key: str
    to_key: str
    reason: str
    reshard_bytes: int
    latency_s: float


_OUTCOMES = ("done", "rank_loss", "straggler_shrink")


class Supervisor:
    """Run a Trainer across a mesh ladder, injecting and surviving faults.

    ``build(key)`` returns ``(train_step, pipeline, model)`` for a mesh
    key, on every world rank (pipeline and model may be None outside the
    rung); builds are memoized.  ``ladder`` orders the keys largest
    first: ``ladder[0]`` is the full mesh, a shrink moves one rung down,
    a grow-back returns one rung up after ``grow_back_after`` steps on
    the smaller mesh.  The batch schedule must be the same on every rung
    (the same dp extent), or the replayed trajectory would diverge: the
    builder's contract, not checked here.  The steps must be ZeRO-1
    scheduled or deferred at f32 (``StateCodec``).

    ``script`` replays a recorded transition schedule with no faults:
    the clean twin of a faulty run.  Bit-exact parity between the two is
    the supervisor's correctness criterion.

    ``group`` is a gloo communicator over every world rank (the world's
    default group if it is gloo, else one is created): the segments'
    outcomes and the transitions' global views travel on it."""

    def __init__(self, build: Callable[[str], tuple[Any, Any, Any]],
                 ladder: tuple[str, ...], ckpt_root: str,
                 *, plan: FaultPlan | None = None,
                 script: tuple[tuple[int, str], ...] | None = None,
                 every: int = 4, grow_back_after: int = 4,
                 straggler_factor: float = 3.0,
                 straggler_patience: int = 3,
                 printer: Callable[[str], None] = print,
                 metrics: MetricsRegistry | None = None,
                 events_path: str | None = None, group=None):
        if len(ladder) < 1:
            raise ValueError("mesh ladder must name at least one mesh")
        self.build = build
        self.ladder = tuple(ladder)
        self.ckpt_root = ckpt_root
        self.plan = plan or FaultPlan()
        self.script = tuple(script) if script is not None else None
        self.every = every
        self.grow_back_after = grow_back_after
        self.straggler_factor = straggler_factor
        self.straggler_patience = straggler_patience
        self.printer = printer
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.events_path = events_path
        self.events: list[dict] = []
        self.transitions: list[Transition] = []
        self._built: dict[str, tuple[Any, Any, Any]] = {}
        self._codecs: dict[str, StateCodec] = {}
        self._shapes: dict[int, tuple] = {}
        self._fired: set[tuple[str, int]] = set()
        self._ckpt_io_left = 0 if self.script is not None else self.plan.ckpt_io_faults
        if group is None:
            group = (dist.group.WORLD if dist.get_backend() == "gloo"
                     else dist.new_group(backend="gloo"))
        self.group = group

    def close(self) -> None:
        """Collective (every world rank): close every step the builder
        gave the supervisor (``TrainStep.close``), in build order.  A
        build is kept for the supervisor's life, a rung's step never
        replaced, so the steps' communicators end with it.  A builder
        that shares its steps with other supervisors closes them itself
        once the last is done, and does not call this."""
        built, self._built, self._codecs = self._built, {}, {}
        for ts, _, _ in built.values():
            ts.close()

    # ------------------------------------------------------------ events

    def _event(self, kind: str, **fields) -> None:
        self.events.append({"kind": kind, **fields})
        with EventLog(self.events_path) as log:
            log.emit(kind, **fields)

    # ------------------------------------------------------- mesh builds

    def _get(self, key: str) -> tuple[Any, Any, Any]:
        if key not in self._built:
            self._built[key] = self.build(key)
        return self._built[key]

    def _codec(self, key: str) -> StateCodec:
        if key not in self._codecs:
            self._codecs[key] = StateCodec(self._get(key)[0])
        return self._codecs[key]

    def _release(self, model) -> None:
        """Free a model's parameter memory, keeping the Parameter objects
        (the step holds them) and their shapes for ``_reacquire``."""
        if model is None:
            return
        with torch.no_grad():
            for p in model.parameters():
                if p.numel():
                    self._shapes[id(p)] = tuple(p.shape)
                    p.grad = None
                    p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def _reacquire(self, model) -> None:
        with torch.no_grad():
            for p in model.parameters():
                shape = self._shapes.pop(id(p), None)
                if shape is not None:
                    p.data = torch.empty(shape, dtype=p.dtype, device=p.device)

    # --------------------------------------------------- fault injectors

    def _step_injector(self) -> Callable[[int], None] | None:
        if self.script is not None:
            return None                       # clean twin: no faults
        plan = self.plan

        def inject(step: int) -> None:
            if step in plan.transient and ("t", step) not in self._fired:
                self._fired.add(("t", step))
                raise TransientStepError(f"injected transient @ {step}")
            if step in plan.rank_loss and ("r", step) not in self._fired:
                self._fired.add(("r", step))
                raise RankLost(f"injected rank loss @ {step}")
            if step in plan.straggler and ("s", step) not in self._fired:
                self._fired.add(("s", step))
                time.sleep(plan.straggler_s)

        return inject

    def _ckpt_injector(self, op: str) -> None:
        if self._ckpt_io_left > 0:
            self._ckpt_io_left -= 1
            raise OSError(f"injected checkpoint I/O fault ({op})")

    def _remesh_hook(self, step: int) -> str | None:
        if self.script is not None:
            return None                       # clean twin: log only
        return "shrink" if self.plan.straggler_shrink else None

    def _share(self, ts, outcome: tuple[str, int]) -> tuple[str, int]:
        """The rung's first rank's segment outcome, on every world rank."""
        t = torch.tensor([_OUTCOMES.index(outcome[0]), outcome[1]], dtype=torch.int64)
        dist.broadcast(t, src=ts.mesh.world_ranks[0], group=self.group)
        return _OUTCOMES[int(t[0])], int(t[1])

    # --------------------------------------------------------- transition

    def _transition(self, resume_step: int, from_key: str, to_key: str,
                    model, opt_state, ckpt: ElasticCheckpointer, reason: str):
        """Move the live state ``from_key`` → ``to_key`` and anchor it.
        Runs on every world rank; returns the new rung's (model,
        opt_state), (None, None) outside it."""
        t0 = time.perf_counter()
        old_ts, _, old_model = self._get(from_key)
        new_ts, _, new_model = self._get(to_key)
        if old_ts.member and old_ts.finalize is not None:
            # flush the deferred carry: the pending update shards land in
            # the params NOW; the transition IR and the reshard pass forbid
            # a PRE op crossing the regroup
            model = old_ts.finalize(model, opt_state)
        rplan = plan_reshard(old_ts, new_ts, self._codec(from_key)._params_like())
        view: dict = {}
        params, new_state = reshard_state(
            old_ts, new_ts, model.params_tree() if old_ts.member else None, opt_state,
            old_codec=self._codec(from_key), new_codec=self._codec(to_key),
            include_pending=False, group=self.group, view=view)   # flushed above
        del opt_state
        self._release(old_model)
        if new_ts.member:
            self._reacquire(new_model)
            copy_into(new_model.params_tree(), params)
            del params
        ckpt.attach(self._codec(to_key))
        if new_ts.member:
            # the anchor, from the view the writer assembled in the transfer
            writer = new_ts.mesh.world_ranks[0]
            ckpt.save_view(resume_step, view if dist.get_rank() == writer else None)
        del view
        dt = time.perf_counter() - t0
        tr = Transition(resume_step=resume_step, from_key=from_key, to_key=to_key,
                        reason=reason, reshard_bytes=rplan.reshard_bytes, latency_s=dt)
        self.transitions.append(tr)
        self.metrics.histogram("recovery_latency_s").observe(dt)
        self.metrics.counter("reshard_bytes_total").inc(rplan.reshard_bytes)
        self._event("transition", step=resume_step, from_mesh=from_key, to_mesh=to_key,
                    reason=reason, reshard_bytes=rplan.reshard_bytes, latency_s=dt)
        self.printer(f"[supervisor] {reason}: {from_key} → {to_key} @ step "
                     f"{resume_step} ({rplan.reshard_bytes} B resharded, "
                     f"{dt * 1e3:.0f} ms)")
        if not new_ts.member:
            return None, None
        return new_model, new_state

    # --------------------------------------------------------------- run

    def run(self, num_steps: int) -> tuple[Any, Any, dict]:
        """Train ``num_steps`` steps across the ladder; returns the final
        ``(model, opt_state, report)`` (model and state None on a rank
        outside the final rung).  The report carries the realized
        transition script: feed it back as ``script=`` to replay the same
        mesh trajectory with no faults."""
        writers = {self._get(k)[0].mesh.world_ranks[0] for k in self.ladder}
        if len(writers) != 1:
            raise ValueError(f"the rungs of {self.ladder} start at the world ranks "
                             f"{sorted(writers)}: every rung's first rank must be one "
                             f"rank, the writer that holds the view at a transition")
        rung = 0
        key = self.ladder[rung]
        ts, _, model = self._get(key)
        opt_state = ts.init_opt() if ts.member else None
        for other in self.ladder[1:]:
            # the other rungs hold nothing until a transition reaches them
            if self._get(other)[2] is not model:
                self._release(self._get(other)[2])
        ckpt = ElasticCheckpointer(
            CheckpointManager(self.ckpt_root, every=self.every, keep=0, blocking=True,
                              retries=self.plan.ckpt_retries,
                              fault_injector=self._ckpt_injector),
            self._codec(key))
        if not ts.member:
            self._release(model)

        scripted = list(self.script) if self.script is not None else None
        grow_at: int | None = None
        segments = 0
        while True:
            segments += 1
            if segments > 64:
                raise RuntimeError("supervisor exceeded 64 trainer segments — "
                                   "fault plan or script is not converging")
            # the next planned boundary: a scripted transition or grow-back
            if scripted:
                seg_end = min(num_steps, scripted[0][0])
            elif grow_at is not None:
                seg_end = min(num_steps, grow_at)
            else:
                seg_end = num_steps

            ts, pipeline, _ = self._get(key)
            outcome = ("done", seg_end)
            if ts.member:
                trainer = Trainer(
                    ts, pipeline, ckpt,
                    step_retries=self.plan.step_retries,
                    fault_injector=self._step_injector(),
                    remesh_hook=self._remesh_hook,
                    straggler_factor=self.straggler_factor,
                    straggler_patience=self.straggler_patience,
                    printer=self.printer, metrics=self.metrics,
                    log_every=10_000, events_path=self.events_path)
                try:
                    model, opt_state, _ = trainer.run(model, opt_state, seg_end)
                except (RemeshRequest, RankLost) as e:
                    model, opt_state = e.params, e.opt_state
                    outcome = ("straggler_shrink" if isinstance(e, RemeshRequest)
                               else "rank_loss", e.step)
                self.events.extend(trainer.events)
            reason, at = self._share(ts, outcome)
            if reason != "done":
                if rung + 1 >= len(self.ladder):
                    raise RuntimeError("mesh ladder exhausted: no smaller mesh to "
                                       "shrink to")
                down = self.ladder[rung + 1]
                model, opt_state = self._transition(at, key, down, model, opt_state,
                                                    ckpt, reason)
                rung += 1
                key = down
                grow_at = at + self.grow_back_after
                continue

            if seg_end >= num_steps:
                break
            if scripted and scripted[0][0] == seg_end:
                _, to_key = scripted.pop(0)
                to_rung = self.ladder.index(to_key)
                model, opt_state = self._transition(seg_end, key, to_key, model,
                                                    opt_state, ckpt, "scripted")
                rung, key = to_rung, to_key
                # the script IS the mesh trajectory: never derive a
                # grow-back the faulty run did not realize
                grow_at = None
                continue
            if grow_at is not None and seg_end == grow_at:
                up = self.ladder[rung - 1]
                model, opt_state = self._transition(seg_end, key, up, model, opt_state,
                                                    ckpt, "grow_back")
                rung -= 1
                key = up
                grow_at = None
                continue

        if self._get(key)[0].member:
            ckpt.wait()
        report = {
            "events": self.events,
            "transitions": [dataclasses.asdict(t) for t in self.transitions],
            "script": tuple((t.resume_step, t.to_key) for t in self.transitions),
            "final_mesh": key,
            "metrics": self.metrics.snapshot(),
        }
        return model, opt_state, report
