"""Structured JSONL event stream + heartbeat line (``repro/obs/events.py``).

One event per line, each a self-describing JSON object with a ``kind``
and a UTC timestamp.  The port's train loop emits a ``compile`` event
for its first step, a ``step`` event per optimizer step and the
reference's lifecycle events (``restore``, ``recover``, ``retry``,
``retry_exhausted``, ``rank_lost``, ``failure``, ``straggler``,
``remesh_requested``; ``runtime/train_loop.py::Trainer``); the elastic
supervisor adds one ``transition`` event a mesh change
(``repro_torch.elastic``).  Anything downstream can replay the stream
without knowing the writer's version.
"""
from __future__ import annotations

import json
import time
from datetime import datetime, timezone
from typing import Any, IO


def utc_now() -> str:
    return datetime.now(timezone.utc).isoformat()


class EventLog:
    """Append-only JSONL writer.

    ``path`` may be a filesystem path (opened in append mode, so
    restarted runs extend the same stream) or an open file-like object
    (tests pass io.StringIO).  Each ``emit`` writes one line and
    flushes — a crashed run keeps every completed step's row.
    """

    def __init__(self, path: str | IO[str] | None):
        self._own = isinstance(path, str)
        self._f: IO[str] | None = (
            open(path, "a") if isinstance(path, str) else path)

    def emit(self, kind: str, **fields: Any) -> None:
        if self._f is None:
            return
        row = {"kind": kind, "t_utc": utc_now(), "t_mono": time.monotonic()}
        row.update(fields)
        self._f.write(json.dumps(row, sort_keys=True) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None and self._own:
            self._f.close()
        self._f = None

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def heartbeat_line(step: int, *, loss: float | None = None,
                   step_ms: float | None = None,
                   avg_ms: float | None = None,
                   tokens_per_s: float | None = None,
                   grad_norm: float | None = None,
                   compile_s: float | None = None) -> str:
    """One human-readable status line per reporting interval.

    Emitted by the train loop next to its per-step print; every field is
    optional so serve/bench loops can reuse the format.
    """
    parts = [f"[obs] step {step}"]
    if loss is not None:
        parts.append(f"loss {loss:.4f}")
    if step_ms is not None:
        parts.append(f"step {step_ms:.1f}ms")
    if avg_ms is not None:
        parts.append(f"avg {avg_ms:.1f}ms")
    if tokens_per_s is not None:
        parts.append(f"{tokens_per_s:,.0f} tok/s")
    if grad_norm is not None:
        parts.append(f"gnorm {grad_norm:.3f}")
    if compile_s is not None:
        parts.append(f"(compile {compile_s:.2f}s excluded)")
    return " ".join(parts)
