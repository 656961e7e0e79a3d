"""Alpha-beta collective cost models over the mesh topology — the port of
``repro/sim/netmodel.py``.

Shi et al.'s DAG model of S-SGD (arXiv 1805.03812) predicts collective
timelines from ``t = steps · (alpha + shard_bytes / beta)`` per ring step;
this instantiates it per mesh axis so a collective over ("pod", "data")
pays the inter-host link's latency/bandwidth on the "pod" hops and the
intra-host link's on the "data" hops.

Everything here is pure Python over numbers — no torch, no devices — so a
full strategy × channels × bucket-size sweep simulates in milliseconds.

Cost conventions (ring algorithm over group ``g`` with ``n`` bytes):
  allreduce       2(g-1) steps, shard n/g          (reduce-scatter + all-gather)
  reduce_scatter   (g-1) steps, shard n/g
  all_gather       (g-1) steps, shard n/g
  all_to_all       (g-1) steps, shard n/g
Multi-axis groups decompose axis-by-axis (fastest link first): the full
payload rides every tier.  The *hierarchical* reducer reduce-scatters
over the fast tier first, so only 1/g_fast of the payload crosses the
slow tier; the *compressed* reducer moves ~n/4 wire bytes (int8 + block
scales) plus two HBM-bound quantize passes — the cost structure of the
port's reducers in ``repro_torch.core``.

The links: "data" and "model" (every axis but "pod") ride NVLink, the
H100 SXM data sheet's 450 GB/s each way; "pod" is an inter-host link no
run of this repository can measure, so its figures are an assumption.
A profile fitted from measured runs (``repro_torch.obs.calibrate``)
replaces both.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch.sim.compute import H100_HBM_BYTES_PER_S, StagingModel

# compression wire format (mirrors repro_torch.core.compression)
_COMP_BLOCK = 256          # elements per scale block
_COMP_RATIO = 0.25 + 4.0 / (4 * _COMP_BLOCK)   # int8 + f32 scale per block


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """One interconnect tier: per-hop latency (alpha) + bandwidth (beta)."""

    name: str
    bandwidth: float     # bytes/s per device per direction
    latency: float       # seconds per ring step


# intra-host: NVLink 4, 450 GB/s each way (H100 SXM data sheet); the 1 µs
# a hop is an assumption, not measured (a fitted profile replaces it)
NVLINK = LinkModel("nvlink", bandwidth=450e9, latency=1e-6)
# inter-host: an assumption, not measured — one 400 Gb/s InfiniBand NDR
# port a card (50 GB/s) and 5 µs a hop
POD_LINK = LinkModel("pod", bandwidth=50e9, latency=5e-6)


@dataclasses.dataclass(frozen=True)
class NetworkModel:
    """Mesh-axis → link-tier map plus reducer-specific cost overheads."""

    links: tuple[tuple[str, LinkModel], ...] = (("pod", POD_LINK),)
    default_link: LinkModel = NVLINK
    quantize_bw: float = H100_HBM_BYTES_PER_S   # data sheet; HBM-bound quantize pass
    staging: StagingModel = StagingModel()   # CopyFromTo pack/unpack cost

    def link(self, axis: str) -> LinkModel:
        for name, lk in self.links:
            if name == axis:
                return lk
        return self.default_link

    # ------------------------------------------------------------ rings
    def _ring(self, nbytes: float, group: int, link: LinkModel,
              steps_factor: float) -> float:
        if group <= 1:
            return 0.0
        steps = steps_factor * (group - 1)
        return steps * (link.latency + (nbytes / group) / link.bandwidth)

    def _axis_groups(self, axes: tuple[str, ...],
                     mesh_shape: Mapping[str, int]) -> list[tuple[str, int]]:
        """(axis, size) with size>1, fastest link first (per-axis rings
        run back-to-back; order only matters for shrinking payloads)."""
        out = [(a, int(mesh_shape.get(a, 1))) for a in axes
               if int(mesh_shape.get(a, 1)) > 1]
        return sorted(out, key=lambda p: -self.link(p[0]).bandwidth)

    # ------------------------------------------------------ collectives
    def allreduce_time(self, nbytes: float, axes: tuple[str, ...],
                       mesh_shape: Mapping[str, int], *,
                       reducer: str = "flat") -> float:
        groups = self._axis_groups(axes, mesh_shape)
        if not groups:
            return 0.0
        # prefix match: the *_ring variants move the same wire bytes on
        # the same tiers — kernel ownership changes who issues the
        # copies, not the alpha-beta schedule (same rule as "ring")
        if reducer.startswith("hierarchical"):
            t = self._hierarchical_time(nbytes, groups)
            if t is not None:
                return t
        if reducer.startswith("compressed"):
            t = self._compressed_time(nbytes, groups)
            if t is not None:
                return t
        # flat sum over the product group: full payload on every tier
        return sum(self._ring(nbytes, g, self.link(a), 2.0)
                   for a, g in groups)

    def reduce_scatter_time(self, nbytes: float, axes: tuple[str, ...],
                            mesh_shape: Mapping[str, int]) -> float:
        t, n = 0.0, float(nbytes)
        for a, g in self._axis_groups(axes, mesh_shape):
            t += self._ring(n, g, self.link(a), 1.0)
            n /= g                      # each tier shrinks the shard
        return t

    def all_gather_time(self, nbytes: float, axes: tuple[str, ...],
                        mesh_shape: Mapping[str, int]) -> float:
        # mirror image of reduce_scatter: payload grows tier by tier, so
        # the total is identical
        return self.reduce_scatter_time(nbytes, axes, mesh_shape)

    def all_to_all_time(self, nbytes: float, axes: tuple[str, ...],
                        mesh_shape: Mapping[str, int]) -> float:
        return sum(self._ring(nbytes, g, self.link(a), 1.0)
                   for a, g in self._axis_groups(axes, mesh_shape))

    def p2p_time(self, nbytes: float, axis: str,
                 mesh_shape: Mapping[str, int]) -> float:
        """One point-to-point hop along ``axis`` (a pipeline SEND/RECV
        pair): single alpha plus the full payload once — every rank
        sends to its neighbor concurrently, so the step count is 1
        regardless of the axis extent."""
        if int(mesh_shape.get(axis, 1)) <= 1:
            return 0.0
        lk = self.link(axis)
        return lk.latency + nbytes / lk.bandwidth

    # ------------------------------------------------- reducer variants
    def _hierarchical_time(self, nbytes: float,
                           groups: list[tuple[str, int]]) -> float | None:
        """RS(fast tiers) → AR(slow tiers, 1/g_fast payload) → AG(fast)."""
        fast_bw = max(self.link(a).bandwidth for a, _ in groups)
        fast = [(a, g) for a, g in groups
                if self.link(a).bandwidth >= fast_bw]
        slow = [(a, g) for a, g in groups
                if self.link(a).bandwidth < fast_bw]
        if not slow:
            return None                 # single tier: same as flat
        g_fast = 1
        t, n = 0.0, float(nbytes)
        for a, g in fast:
            t += self._ring(n, g, self.link(a), 1.0)   # reduce-scatter
            n /= g
            g_fast *= g
        for a, g in slow:
            t += self._ring(n, g, self.link(a), 2.0)   # allreduce shard
        for a, g in reversed(fast):
            n *= g
            t += self._ring(n, g, self.link(a), 1.0)   # all-gather
        return t

    def _compressed_time(self, nbytes: float,
                         groups: list[tuple[str, int]]) -> float | None:
        """quantize → all-to-all int8 → local reduce → requantize →
        all-gather int8 (``repro_torch.core.compression``'s scheme)."""
        g = 1
        for _, s in groups:
            g *= s
        # the real reducer falls back to the flat sum for small buffers
        if nbytes < 4 * _COMP_BLOCK * g:
            return None
        wire = nbytes * _COMP_RATIO
        t = sum(self._ring(wire, gg, self.link(a), 1.0) for a, gg in groups)
        t += sum(self._ring(wire, gg, self.link(a), 1.0)
                 for a, gg in groups)   # all-gather phase, same volume
        t += 3.0 * nbytes / self.quantize_bw   # 2×quantize + 1×dequant
        return t

    def collective_time(self, kind: str, nbytes: float,
                        axes: tuple[str, ...],
                        mesh_shape: Mapping[str, int], *,
                        reducer: str = "flat") -> float:
        """Dispatch on the CommSchedule op kind (schedule.py constants).

        The ``ring`` reducer costs as flat: the alpha-beta ring IS this
        model's assumed algorithm."""
        if kind == "allreduce":
            return self.allreduce_time(nbytes, axes, mesh_shape,
                                       reducer=reducer)
        if kind == "reduce_scatter":
            return self.reduce_scatter_time(nbytes, axes, mesh_shape)
        if kind == "all_gather":
            return self.all_gather_time(nbytes, axes, mesh_shape)
        if kind in ("send", "recv"):
            return self.p2p_time(nbytes, axes[0] if axes else "stage",
                                 mesh_shape)
        raise ValueError(f"unknown collective kind {kind!r}")

    def staging_time(self, kind: str, nbytes: float, num_leaves: int, *,
                     fused: bool = True) -> float:
        """CopyFromTo cost around one CommSchedule op: allreduce pays
        pack AND unpack; a reduce-scatter only packs, an all-gather only
        unpacks (the RS/AG pair splits the round trip; same split for a
        SEND/RECV pair — pack at the SEND, unpack at the RECV)."""
        one = self.staging.stage_time(nbytes, num_leaves, fused=fused)
        if kind == "allreduce":
            return 2.0 * one
        if kind in ("reduce_scatter", "all_gather", "send", "recv"):
            return one
        raise ValueError(f"unknown collective kind {kind!r}")


def default_network() -> NetworkModel:
    """The standard topology: "pod" rides the inter-host link, every other
    axis NVLink."""
    return NetworkModel()
