"""Fit the alpha-beta ``NetworkModel`` (and ``StagingModel``) from
measured per-op rows, and persist fitted per-mesh profiles the ``auto``
strategy prefers over the built-in defaults — the port of
``repro/obs/calibrate.py``.

The simulator prices a flat collective over group ``g`` as per-axis
rings: ``steps · (alpha_a + (n/g)/beta_a)`` with ``steps = 2(g-1)`` for
allreduce and ``(g-1)`` for RS/AG, payload shrinking tier by tier
(``repro_torch.sim.netmodel``).  Measured time is therefore LINEAR in the
per-axis unknowns ``[alpha_a, 1/beta_a]``:

    t_row = sum_a steps_a(row) · alpha_a + wire_a(row) · (1/beta_a)

so fitting is one least-squares solve over rows spanning several bucket
sizes — the perf-modeling approach of arXiv 1711.05979.  Rows that
carry ``num_leaves`` get the (default or fitted) staging cost
subtracted first, since measured walls include CopyFromTo.

A fitted profile is a small JSON keyed by mesh shape
(``netprofile_data2_model4.json``) under ``$REPRO_TORCH_NETPROFILE_DIR``
(default ``results/netprofiles_torch``); ``fitted_network(mesh_shape)``
is the lookup ``sim/autotune.py`` calls before falling back to
``default_network()``.  The port keeps its own directory and variable:
a profile fitted for another package's hardware must never rank the
port's plans.  The schema is the reference's, so a profile saved by
either package loads into an equal model in the other.
"""
from __future__ import annotations

import json
import os
from typing import Any, Mapping, Sequence

import numpy as np

from repro_torch.obs.provenance import SCHEMA_VERSION, bench_metadata
from repro_torch.sim.compute import StagingModel
from repro_torch.sim.netmodel import LinkModel, NetworkModel, default_network

_WIRE_KINDS = ("allreduce", "reduce_scatter", "all_gather")

DEFAULT_PROFILE_DIR = "results/netprofiles_torch"
PROFILE_DIR_ENV = "REPRO_TORCH_NETPROFILE_DIR"

# Quality gate: a fit whose rms residual exceeds this fraction of the
# rms measured (staging-subtracted) row time explains too little of the
# data to rank plans with — e.g. a CPU-host smoke run, where dispatch
# jitter dwarfs the wire terms.  Such profiles are still persisted
# (quality: "poor" recorded in the doc, useful as a CI artifact and for
# --diff forensics) but `fitted_network` treats them as absent, so a
# bad calibration can never silently distort `auto`'s ranking.
REL_RESIDUAL_MAX = 0.25


def mesh_key(mesh_shape: Mapping[str, int]) -> str:
    return "_".join(f"{a}{n}" for a, n in sorted(mesh_shape.items()))


def profile_dir(override: str | None = None) -> str:
    return (override if override is not None
            else os.environ.get(PROFILE_DIR_ENV, DEFAULT_PROFILE_DIR))


def profile_path(mesh_shape: Mapping[str, int],
                 dir: str | None = None) -> str:
    return os.path.join(profile_dir(dir),
                        f"netprofile_{mesh_key(mesh_shape)}.json")


# ------------------------------------------------------------- features

def ring_features(kind: str, nbytes: float, axes: Sequence[str],
                  mesh_shape: Mapping[str, int], *,
                  ref: NetworkModel | None = None,
                  ) -> dict[str, tuple[float, float]]:
    """axis → (steps, wire_bytes): the linear-model coefficients of one
    measured row, mirroring ``NetworkModel``'s flat cost EXACTLY (same
    per-axis decomposition, same fastest-link-first ordering for the
    shrinking RS/AG payload) so a fit over synthetic rows generated from
    a known model recovers it to numerical precision."""
    if kind not in _WIRE_KINDS:
        raise ValueError(f"not a wire kind: {kind!r}")
    ref = ref or default_network()
    groups = ref._axis_groups(tuple(axes), mesh_shape)
    out: dict[str, tuple[float, float]] = {}
    if kind == "allreduce":
        for a, g in groups:
            steps = 2.0 * (g - 1)
            out[a] = (steps, steps * nbytes / g)
    else:                                   # reduce_scatter / all_gather
        n = float(nbytes)
        for a, g in groups:
            steps = float(g - 1)
            out[a] = (steps, steps * n / g)
            n /= g
    return out


def _staging_of(row: Mapping[str, Any], staging: StagingModel) -> float:
    """The CopyFromTo share of a measured wall (0 when the row carries
    no staging info — e.g. synthetic wire-only rows)."""
    leaves = row.get("num_leaves")
    if not leaves:
        return 0.0
    one = staging.stage_time(row["nbytes"], int(leaves),
                             fused=bool(row.get("fused", True)))
    return 2.0 * one if row["kind"] == "allreduce" else one


# ------------------------------------------------------------------ fit

def fit_network(
    rows: Sequence[Mapping[str, Any]],
    *,
    staging: StagingModel | None = None,
    ref: NetworkModel | None = None,
) -> tuple[NetworkModel, dict[str, Any]]:
    """Least-squares fit of per-axis (latency, bandwidth) from measured
    rows ``{kind, nbytes, axes, mesh_shape, t[, num_leaves, fused]}``.

    Returns ``(model, info)``: the fitted ``NetworkModel`` (fitted axes
    become explicit links; anything else falls back to ``ref``'s
    default link) and a fit report (per-axis params, rms residual, row
    count).  Needs rows at >= 2 distinct sizes per axis to separate
    alpha from beta — fewer rows make lstsq minimum-norm, not wrong.

    The RS/AG shrinking payload depends on the fastest-link-first axis
    ORDER, which depends on the bandwidths being fitted — so the solve
    iterates: features under the current ordering, refit, re-derive the
    ordering from the fitted bandwidths, until stable (multi-axis rows
    converge in 2-3 rounds; single-axis fits in one).
    """
    ref = ref or default_network()
    st = staging or ref.staging

    def solve(order_ref: NetworkModel):
        feats = []
        axes_order: list[str] = []
        for row in rows:
            f = ring_features(row["kind"], row["nbytes"], row["axes"],
                              row["mesh_shape"], ref=order_ref)
            feats.append(f)
            for a in f:
                if a not in axes_order:
                    axes_order.append(a)
        if not axes_order:
            raise ValueError(
                "no rows with a group size > 1 — nothing to fit")
        col = {a: i for i, a in enumerate(axes_order)}
        A = np.zeros((len(rows), 2 * len(axes_order)))
        b = np.zeros(len(rows))
        for i, (row, f) in enumerate(zip(rows, feats)):
            for a, (steps, wire) in f.items():
                A[i, 2 * col[a]] = steps          # alpha_a coefficient
                A[i, 2 * col[a] + 1] = wire       # 1/beta_a coefficient
            b[i] = row["t"] - _staging_of(row, st)
        x, *_ = np.linalg.lstsq(A, b, rcond=None)
        residual = float(np.sqrt(np.mean((A @ x - b) ** 2)))
        links = []
        params: dict[str, dict[str, float]] = {}
        for a in axes_order:
            alpha = max(float(x[2 * col[a]]), 0.0)
            inv_beta = max(float(x[2 * col[a] + 1]), 1e-15)
            bw = 1.0 / inv_beta
            links.append((a, LinkModel(a, bandwidth=bw, latency=alpha)))
            params[a] = {"latency": alpha, "bandwidth": bw}
        model = NetworkModel(
            links=tuple(links), default_link=ref.default_link,
            quantize_bw=ref.quantize_bw, staging=st)
        return model, params, residual

    model, params, residual = solve(ref)
    for _ in range(3):
        prev = residual
        model, params, residual = solve(model)
        if residual >= prev * (1.0 - 1e-9):   # ordering stabilized
            break
    # the target vector is staging-subtracted row time — independent of
    # the axis ordering, so computed once for the quality verdict
    target_rms = float(np.sqrt(np.mean(
        [(row["t"] - _staging_of(row, st)) ** 2 for row in rows])))
    rel = residual / target_rms if target_rms > 0 else float("inf")
    info = {"axes": params, "rms_residual_s": residual,
            "rel_residual": rel,
            "quality": "ok" if rel <= REL_RESIDUAL_MAX else "poor",
            "n_rows": len(rows)}
    return model, info


def fit_staging(
    rows: Sequence[Mapping[str, Any]],
    *,
    ref: StagingModel | None = None,
) -> tuple[StagingModel, dict[str, Any]]:
    """Fit ``(hbm_bw, leaf_overhead)`` from staging-only rows
    ``{nbytes, num_leaves, fused, t}`` (one direction each), keeping
    ``ref``'s pass-count convention (2 fused / 4 leafwise)."""
    ref = ref or StagingModel()
    A = np.zeros((len(rows), 2))
    b = np.zeros(len(rows))
    for i, row in enumerate(rows):
        fused = bool(row.get("fused", True))
        passes = ref.fused_passes if fused else ref.leafwise_passes
        ops = 1 if fused else max(int(row["num_leaves"]), 1)
        A[i, 0] = passes * row["nbytes"]      # 1/hbm_bw coefficient
        A[i, 1] = ops                         # leaf_overhead coefficient
        b[i] = row["t"]
    x, *_ = np.linalg.lstsq(A, b, rcond=None)
    inv_bw = max(float(x[0]), 1e-18)
    leaf = max(float(x[1]), 0.0)
    model = StagingModel(hbm_bw=1.0 / inv_bw, leaf_overhead=leaf,
                         fused_passes=ref.fused_passes,
                         leafwise_passes=ref.leafwise_passes)
    residual = float(np.sqrt(np.mean((A @ x - b) ** 2))) if len(rows) else 0.0
    target_rms = float(np.sqrt(np.mean(b ** 2))) if len(rows) else 0.0
    rel = residual / target_rms if target_rms > 0 else float("inf")
    info = {"hbm_bw": model.hbm_bw, "leaf_overhead": leaf,
            "rms_residual_s": residual, "rel_residual": rel,
            "quality": "ok" if rel <= REL_RESIDUAL_MAX else "poor",
            "n_rows": len(rows)}
    return model, info


# -------------------------------------------------------------- profiles

def save_profile(
    model: NetworkModel,
    mesh_shape: Mapping[str, int],
    *,
    dir: str | None = None,
    info: Mapping[str, Any] | None = None,
) -> str:
    """Persist a fitted model as the per-mesh JSON profile; returns the
    path ``fitted_network`` will find it at."""
    path = profile_path(mesh_shape, dir)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    doc = {
        "schema_version": SCHEMA_VERSION,
        "meta": bench_metadata(mesh_shape),
        "links": {a: {"bandwidth": lk.bandwidth, "latency": lk.latency}
                  for a, lk in model.links},
        "default_link": {"name": model.default_link.name,
                         "bandwidth": model.default_link.bandwidth,
                         "latency": model.default_link.latency},
        "quantize_bw": model.quantize_bw,
        "staging": {"hbm_bw": model.staging.hbm_bw,
                    "leaf_overhead": model.staging.leaf_overhead,
                    "fused_passes": model.staging.fused_passes,
                    "leafwise_passes": model.staging.leafwise_passes},
        "fit": dict(info or {}),
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    return path


def load_profile(path: str) -> NetworkModel:
    with open(path) as f:
        doc = json.load(f)
    links = tuple(
        (a, LinkModel(a, bandwidth=d["bandwidth"], latency=d["latency"]))
        for a, d in sorted(doc["links"].items()))
    dl = doc["default_link"]
    st = doc["staging"]
    return NetworkModel(
        links=links,
        default_link=LinkModel(dl["name"], bandwidth=dl["bandwidth"],
                               latency=dl["latency"]),
        quantize_bw=doc["quantize_bw"],
        staging=StagingModel(hbm_bw=st["hbm_bw"],
                             leaf_overhead=st["leaf_overhead"],
                             fused_passes=st["fused_passes"],
                             leafwise_passes=st["leafwise_passes"]))


def fitted_network(
    mesh_shape: Mapping[str, int],
    dir: str | None = None,
) -> tuple[NetworkModel | None, str | None]:
    """The fitted profile for this mesh if one exists — ``(model, path)``
    or ``(None, None)``.  Unreadable/corrupt profiles are treated as
    absent (a stale artifact must never break planning), and so are
    profiles whose recorded fit ``quality`` is ``"poor"`` (residual >
    ``REL_RESIDUAL_MAX`` of the measured signal): ranking plans against
    a fit that does not explain its own calibration data is worse than
    the built-in defaults."""
    path = profile_path(mesh_shape, dir)
    if not os.path.exists(path):
        return None, None
    try:
        with open(path) as f:
            doc = json.load(f)
        if doc.get("fit", {}).get("quality", "ok") != "ok":
            return None, None
        return load_profile(path), path
    except Exception:
        return None, None
