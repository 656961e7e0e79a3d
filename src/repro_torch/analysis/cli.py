"""``python -m repro_torch.analyze`` — lint every schedule the port plans.

Walks the reference's registry cross-product (``repro/analysis/cli.py``)

    strategy × reducer × num_channels × zero1 plan × accum

on its two stand-in meshes (the 8-rank dp mesh and the dp=2 × tp=4
smoke mesh) and plans each cell through the port's planning path
(``core/kvstore.py::plan_sync``: bucket plan, reducer, schedule; no
process group, no device), then runs the six analysis passes on the
schedule and reports.  Cells the constructor contract refuses (a
two-phase strategy with a hierarchical or compressed reducer) are
counted as rejected.  Cells the port cannot plan yet are counted as not
ported, each with the ROADMAP queue 1 item that brings it — never as
clean:

  zero1 plan other than none, or accum > 1 — item 8 (ZeRO-1 StepProgram,
                                              accumulation);
  the ``auto`` strategy                   — item 15b (the simulator).

Every dp2×tp4 cell plans (the "model" axis only shapes the reduce sets);
running one needs a communicator per axis, item 9.

Exit code 0 iff every planned cell is clean.  ``--json PATH`` writes
the machine-readable report there (nowhere by default).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any

import torch

from repro_torch.analysis.verifier import run_passes
from repro_torch.core.kvstore import GradSyncConfig, plan_sync
from repro_torch.core.registry import reducer_names, strategy_names
from repro_torch.launch.mesh import Mesh

# the reference's strategies that the port has not registered, with the
# ROADMAP queue 1 item that ports them
NOT_PORTED_STRATEGIES = {"auto": "15b"}
ZERO1_PLANS = ("none", "scheduled", "deferred")
ACCUMS = (1, 4)
CHANNELS = (1, 4)


def static_mesh(shape: dict[str, int]) -> Mesh:
    """Mesh stand-in: axis names and sizes, no process group."""
    return Mesh(tuple(shape), dict(shape))


def _model(model_axis: str | None):
    """The reference's small transformer-ish gradient tree + param specs
    (a few MiB across mixed shapes, so bucketing makes several buckets
    a channel); ``model_axis`` shards the matmul weights, whose reduce
    sets then leave that axis out, as real TP."""
    mp = model_axis
    shapes = {
        "embed": ((1024, 128), ()),
        "w_in": ((128, 512), (None, mp) if mp else ()),
        "w_out": ((512, 128), (mp, None) if mp else ()),
        "b_in": ((512,), (mp,) if mp else ()),
        "b_out": ((128,), ()),
        "head": ((128, 1024), ()),
        "scale": ((), ()),
    }
    grads = {k: torch.empty(s, dtype=torch.float32, device="meta")
             for k, (s, _) in shapes.items()}
    specs = {k: spec for k, (_, spec) in shapes.items()}
    return grads, specs


MESHES: dict[str, tuple[dict[str, int], str | None]] = {
    # name -> (axis sizes, model-sharding axis)
    "dp8": ({"data": 8}, None),
    "smoke-dp2tp4": ({"data": 2, "model": 4}, "model"),
}


def not_ported_item(strategy: str, zero1: str, accum: int) -> str | None:
    """The ROADMAP queue 1 item a cell waits on, or None if it plans."""
    if strategy in NOT_PORTED_STRATEGIES:
        return NOT_PORTED_STRATEGIES[strategy]
    if zero1 != "none" or accum > 1:
        return "8"
    return None


def lint_cell(mesh_name: str, strategy: str, reducer: str,
              num_channels: int, zero1: str, accum: int) -> dict[str, Any]:
    """Plan one cross-product cell and run the analyzer on the result."""
    cell = {
        "mesh": mesh_name, "strategy": strategy, "reducer": reducer,
        "channels": num_channels, "zero1": zero1, "accum": accum,
    }
    item = not_ported_item(strategy, zero1, accum)
    if item is not None:
        return {**cell, "status": "not_ported", "item": item}
    mesh_shape, model_axis = MESHES[mesh_name]
    grads, specs = _model(model_axis)
    cfg = GradSyncConfig(
        strategy=strategy,
        reducer=reducer,
        bucket_bytes=256 * 1024,
        num_channels=num_channels,
        verify=False,            # run_passes below collects ALL findings
    )
    try:
        planned = plan_sync(cfg, static_mesh(mesh_shape), specs, grads)
    except ValueError as e:
        # constructor contract (two-phase × hierarchical): unreachable by
        # construction, not an analyzer failure
        return {**cell, "status": "rejected", "reason": str(e)}
    report = run_passes(
        planned.schedule,
        mesh_shape=planned.mesh_shape,
        default_reducer=cfg.reducer,
        plan_comm_dtype=cfg.comm_dtype,
        expect_defer=False,
    )
    return {**cell, "status": "ok" if report.ok else "error", **report.to_dict()}


def iter_cells():
    strategies = strategy_names() + tuple(
        s for s in NOT_PORTED_STRATEGIES if s not in strategy_names())
    for mesh_name in MESHES:
        for strategy in strategies:
            for reducer in reducer_names():
                for num_channels in CHANNELS:
                    for zero1 in ZERO1_PLANS:
                        for accum in ACCUMS:
                            yield (mesh_name, strategy, reducer,
                                   num_channels, zero1, accum)


def summarize(cells: list[dict[str, Any]]) -> dict[str, Any]:
    """Counts by status, and the not-ported cells by ROADMAP item."""
    by_item: dict[str, int] = {}
    for c in cells:
        if c["status"] == "not_ported":
            by_item[c["item"]] = by_item.get(c["item"], 0) + 1
    n = {s: sum(c["status"] == s for c in cells)
         for s in ("ok", "error", "rejected", "not_ported")}
    return {"total": len(cells), "planned": n["ok"] + n["error"],
            "clean": n["ok"], "errors": n["error"], "rejected": n["rejected"],
            "not_ported": n["not_ported"], "not_ported_by_item": by_item}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analyze",
        description="statically lint the strategy x reducer x channels x "
                    "zero1 x accum cross-product the port can plan")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the machine-readable report here")
    ap.add_argument("--verbose", action="store_true",
                    help="print every cell, not just failures")
    args = ap.parse_args(argv)

    cells = [lint_cell(*c) for c in iter_cells()]
    summary = summarize(cells)

    def _label(c):
        return (f"{c['mesh']}/{c['strategy']}/{c['reducer']}"
                f"/ch{c['channels']}/{c['zero1']}/acc{c['accum']}")

    for c in cells:
        if c["status"] == "error":
            classes = sorted({f"{f['pass']}:{f['code']}"
                              for f in c["findings"]})
            print(f"ERROR    {_label(c)}: {classes}")
            for f in c["findings"]:
                print(f"         {f['message']}")
        elif args.verbose:
            print(f"{c['status']:10s} {_label(c)}")

    items = ", ".join(f"item {k}: {v}" for k, v in
                      sorted(summary["not_ported_by_item"].items()))
    print(f"repro_torch.analyze: {summary['total']} cells — "
          f"{summary['planned']} planned ({summary['clean']} clean, "
          f"{summary['errors']} with findings), {summary['rejected']} "
          f"rejected by contract, {summary['not_ported']} not ported "
          f"(ROADMAP queue 1 {items})")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"cells": cells, "summary": summary}, f, indent=2)
        print(f"report written to {args.json}")
    return 1 if summary["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
