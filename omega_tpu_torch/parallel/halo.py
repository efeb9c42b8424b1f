"""Halo exchange over a list of shards.

The reference packs per-neighbor device buffers, posts MPI_Irecv/Isend
(device buffers under GPU-aware MPI), and unpacks in an MPI_Test polling
loop (base/Halo.h:769-915). The port is single-controller: one process
holds every shard's array in a list, each on its shard's device, and an
exchange is a pack (`index_select` on the sender), a copy to the
receiver's device (`.to(..., non_blocking=True)`: a device-local copy when
both shards share a card, a peer copy between cards) and an unpack
(`index_copy` into the receiver's halo rows). Both functions take and
return lists, so a `torch.distributed` backend can sit behind the same two
signatures later.

Two variants (the JAX package's two):
  * `exchange`           — every shard's packed boundary buffer is stacked
                           on every receiver (the all_gather form; simple,
                           O(S * boundary) traffic)
  * `exchange_permute`   — one round per distinct neighbor rank distance d,
                           each shard sending exactly its boundary to shard
                           (s + d) % S (the MPI_Isend/Irecv analogue;
                           traffic O(boundary)); index lists precomputed on
                           the host by sharded.build_permute_lists, exactly
                           like Halo::generateExchangeLists
                           (base/Halo.cpp:455)

Arrays are (..., N_local, K): the element axis is -2, any leading axes are
batch axes (tracers, bundles), any rank >= 2.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def exchange_permute(xs: Sequence[torch.Tensor], plists) -> List[torch.Tensor]:
    """Neighbor-pair halo refresh, one round per rank distance.

    xs: per-shard arrays. plists: sequence of (d, send_idx, recv_dst),
    `send_idx[s]` / `recv_dst[s]` shard s's rows (long tensors on its
    device). For distance d shard s sends to (s+d) % S and receives from
    (s-d) % S; padded slots target the dummy trailing row. Within a round
    every shard packs before any shard unpacks, as the collective does."""
    xs = list(xs)
    S = len(xs)
    for d, send_idx, recv_dst in plists:
        bufs = [torch.index_select(xs[s], xs[s].dim() - 2, send_idx[s])
                for s in range(S)]
        for s in range(S):
            r = (s + d) % S
            got = bufs[s].to(xs[r].device, non_blocking=True)
            xs[r] = _scatter(xs[r], recv_dst[r], got)
    return xs


def exchange(xs: Sequence[torch.Tensor], send_idx, recv_src_shard,
             recv_src_slot, recv_dst) -> List[torch.Tensor]:
    """Refresh the halo rows of every shard's array.

    send_idx[s]: (NS,) local indices of shard s's owned elements to publish;
    recv_src_shard[s], recv_src_slot[s], recv_dst[s]: (NH,) where shard s
    fetches each halo value (which shard's buffer, which slot of it) and
    where it stores it. Each list entry is a long tensor on its shard's
    device."""
    xs = list(xs)
    S = len(xs)
    bufs = [torch.index_select(xs[s], xs[s].dim() - 2, send_idx[s])
            for s in range(S)]                           # (..., NS, K)
    out = []
    for r in range(S):
        dev = xs[r].device
        # every shard's buffer on the receiver, the shard id leading
        gathered = torch.stack([b.to(dev, non_blocking=True) for b in bufs])
        g = gathered.movedim(0, -3)                      # (..., S, NS, K)
        vals = g[..., recv_src_shard[r], recv_src_slot[r], :]
        out.append(_scatter(xs[r], recv_dst[r], vals))
    return out


def _scatter(x, dst, vals):
    """x with x[..., dst, :] = vals (a new tensor), for any rank >= 2 (the
    reference exchanges 1-5-D arrays, base/Halo.h:45; leading axes here are
    batch dims like tracer/time-level)."""
    if x.dim() < 2:
        raise ValueError("halo arrays are (..., N_local, K)")
    return x.index_copy(x.dim() - 2, dst, vals.to(x.dtype))
