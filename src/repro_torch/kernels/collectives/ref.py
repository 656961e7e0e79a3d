"""Plain PyTorch versions of the collectives kernels, and the rings
(``repro/kernels/collectives/ref.py``).

``leafwise_pack``/``leafwise_unpack`` are the reference's per-leaf
staging in torch: per-leaf ravel + cast (with the optional loss-scale
multiplied in f32 before the cast), one concatenate; per-leaf slice +
cast back.  They are what ``ops.fused_pack``/``fused_unpack`` run for
tensors on the CPU, the oracle the CUDA kernels are held against on the
card, and the path for buckets the kernels do not take (non-float
dtypes).

``ring_reduce_scatter_ref``/``ring_all_gather_ref`` are the reference's
chunked rings over one process group: g-1 neighbour hops, each hop one
batch of point-to-point transfers (``core/dependency.py::exchange``, the
counterpart of one ``lax.ppermute``) plus, for the reduce-scatter, a
combine of every direction's pair at once (``accum``:
``ring_accum_pairs_ref`` here, the CUDA ``ring_accum_pairs_kernel`` on
CUDA tensors when driven from ``ops``: one launch a hop).
``bidirectional=True`` splits every chunk in half and runs a clockwise
ring on ``[:h]`` and a counter-clockwise one on ``[h:]`` in the same
batches: two messages in flight per hop.  Rank
``r`` ends owning chunk ``r``, as ``reduce_scatter_tensor`` /
``all_gather_into_tensor`` lay them out, and each chunk's adds happen in
the reference's order.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch.core import dependency as dep


def leafwise_pack(leaves: Sequence[torch.Tensor], comm_dtype, *,
                  scale: float = 1.0) -> torch.Tensor:
    """Per-leaf cast + concatenate (the paper's CopyFromTo)."""
    parts = []
    for x in leaves:
        x = x.reshape(-1)
        if scale != 1.0:
            x = x.to(torch.float32) * scale
        parts.append(x.to(comm_dtype))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def leafwise_unpack(buf: torch.Tensor, sizes: Sequence[int], dtypes, *,
                    scale: float = 1.0) -> list[torch.Tensor]:
    """Per-leaf slice + cast back (1-D pieces, caller reshapes)."""
    out = []
    off = 0
    for n, dt in zip(sizes, dtypes):
        x = buf[off:off + n]
        if scale != 1.0:
            x = x.to(torch.float32) * scale
        out.append(x.to(dt))
        off += n
    return out


# ---------------------------------------------------------- ring (1 group)

def ring_accum_ref(msg: torch.Tensor, chunk: torch.Tensor) -> torch.Tensor:
    """One ring hop's combine (``ring_accum_kernel``'s plain version)."""
    return torch.add(msg, chunk)


def ring_accum_pairs_ref(msgs: Sequence[torch.Tensor],
                         chunks: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """One ring hop's combine for every direction
    (``ring_accum_pairs_kernel``'s plain version): ``torch.add`` a pair."""
    return [ring_accum_ref(m, c) for m, c in zip(msgs, chunks, strict=True)]


def _hop(msgs: Sequence[torch.Tensor], signs: Sequence[int],
         group: dist.ProcessGroup, r: int, g: int) -> list[torch.Tensor]:
    """One hop of every ring at once: ring i sends ``msgs[i]`` to rank
    r + sign_i and receives its neighbour's on the other side (tag i)."""
    recvd = [torch.empty_like(m) for m in msgs]
    dep.exchange(group,
                 [(m, (r + sgn) % g, i) for i, (m, sgn) in enumerate(zip(msgs, signs))],
                 [(t, (r - sgn) % g, i) for i, (t, sgn) in enumerate(zip(recvd, signs))])
    return recvd


def _rings(x2d: torch.Tensor, bidirectional: bool) -> list[tuple[torch.Tensor, int]]:
    """(columns of the (g, c) view, direction) per ring: one clockwise
    ring, or clockwise on ``[:h]`` and counter-clockwise on ``[h:]``."""
    h = x2d.shape[1] // 2
    if not bidirectional or h == 0:
        return [(x2d, 1)]
    return [(x2d[:, :h], 1), (x2d[:, h:], -1)]


def ring_reduce_scatter_ref(
    x: torch.Tensor, group: dist.ProcessGroup, *,
    bidirectional: bool = True,
    accum: Callable[[list, list], list] = ring_accum_pairs_ref,
) -> torch.Tensor:
    """(n,) per-rank buffer (n % g == 0) → (n/g,) reduced shard.

    ``accum(received, own)`` is the per-hop combine, called once a hop
    with one pair per ring direction (one when a half-chunk is empty)."""
    g = dist.get_world_size(group)
    if g == 1:
        return x
    r = dist.get_rank(group)
    rings = _rings(x.reshape(g, -1), bidirectional)
    signs = [sgn for _, sgn in rings]
    # hop 0's payload: our own value of chunk r ∓ 1
    msgs = [part[(r - sgn) % g] for part, sgn in rings]
    for s in range(1, g):
        # received the partials of chunks r ∓ (s+1); add our contributions
        msgs = accum(_hop(msgs, signs, group, r, g),
                     [part[(r - sgn * (s + 1)) % g] for part, sgn in rings])
    return msgs[0] if len(msgs) == 1 else torch.cat(msgs)


def ring_all_gather_ref(shard: torch.Tensor, group: dist.ProcessGroup, *,
                        bidirectional: bool = True) -> torch.Tensor:
    """(c,) owned shard (rank r owns chunk r) → (g*c,) full buffer."""
    g = dist.get_world_size(group)
    if g == 1:
        return shard
    r = dist.get_rank(group)
    rings = _rings(shard.reshape(1, -1), bidirectional)
    signs = [sgn for _, sgn in rings]
    msgs = [part[0] for part, _ in rings]
    outs = [torch.empty((g, m.numel()), dtype=m.dtype, device=m.device)
            for m in msgs]
    for out, m in zip(outs, msgs):
        out[r] = m
    for s in range(1, g):
        msgs = _hop(msgs, signs, group, r, g)
        # hop s delivers chunk r ∓ s
        for out, m, sgn in zip(outs, msgs, signs):
            out[(r - sgn * s) % g] = m
    return outs[0].reshape(-1) if len(outs) == 1 else torch.cat(outs, 1).reshape(-1)
