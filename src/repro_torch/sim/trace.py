"""Timeline exports: Chrome-trace JSON and a terminal ASCII render — the
port of ``repro/sim/trace.py``.

``chrome_trace_events`` emits the chrome://tracing / Perfetto format
("traceEvents" with phase "X" complete events, microsecond timestamps):
one process row per simulated strategy, one thread row per dependency
chain, plus a compute track showing forward/backward so overlap is
visible at a glance.
"""
from __future__ import annotations

import json
from typing import Any, Mapping

from repro_torch.sim.engine import Timeline

_US = 1e6


def chrome_trace_events(timeline: Timeline, *, pid: int = 0,
                        label: str = "schedule") -> list[dict[str, Any]]:
    ev: list[dict[str, Any]] = [
        {"ph": "M", "pid": pid, "name": "process_name",
         "args": {"name": label}},
        {"ph": "M", "pid": pid, "tid": 0, "name": "thread_name",
         "args": {"name": "compute"}},
    ]
    if timeline.t_fwd > 0:
        ev.append({"ph": "X", "pid": pid, "tid": 0, "name": "forward",
                   "ts": 0.0, "dur": timeline.t_fwd * _US})
    if timeline.t_bwd > 0:
        ev.append({"ph": "X", "pid": pid, "tid": 0, "name": "backward",
                   "ts": timeline.t_fwd * _US, "dur": timeline.t_bwd * _US})
    for ch in sorted({e.chain for e in timeline.events}):
        ev.append({"ph": "M", "pid": pid, "tid": ch + 1,
                   "name": "thread_name",
                   "args": {"name": f"chain {ch}"}})
    for e in timeline.events:
        ev.append({
            "ph": "X", "pid": pid, "tid": e.chain + 1,
            "name": f"{e.kind}:b{e.bucket_id}",
            "ts": e.start * _US, "dur": e.duration * _US,
            "args": {"op_id": e.op_id, "bytes": e.nbytes,
                     "release": e.release * _US},
        })
    return ev


def chrome_trace(timelines: Mapping[str, Timeline]) -> dict[str, Any]:
    """Multiple strategies side by side (one pid per strategy)."""
    events: list[dict[str, Any]] = []
    for pid, (name, tl) in enumerate(sorted(timelines.items())):
        events.extend(chrome_trace_events(tl, pid=pid, label=name))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, timelines: Mapping[str, Timeline]) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(timelines), f)


def ascii_timeline(timeline: Timeline, *, width: int = 64) -> str:
    """Per-chain bars on a shared time axis (for terminal output)."""
    span = max(timeline.step_time, 1e-12)
    scale = width / span
    lines = []
    cend = min(width, int(round(timeline.compute_end * scale)))
    lines.append("compute  |" + "=" * cend + " " * (width - cend) + "|")
    chains: dict[int, list] = {}
    for e in timeline.events:
        chains.setdefault(e.chain, []).append(e)
    for ch in sorted(chains):
        row = [" "] * width
        for e in chains[ch]:
            a = min(width - 1, int(e.start * scale))
            b = min(width, max(a + 1, int(round(e.end * scale))))
            glyph = {"allreduce": "#", "reduce_scatter": "<",
                     "all_gather": ">"}.get(e.kind, "#")
            for i in range(a, b):
                row[i] = glyph
        lines.append(f"chain {ch:>2} |" + "".join(row) + "|")
    lines.append(
        f"step {timeline.step_time * 1e3:.3f} ms  "
        f"exposed {timeline.exposed_comm * 1e3:.3f} ms  "
        f"overlap {timeline.overlap_fraction * 100:.0f}%")
    return "\n".join(lines)
