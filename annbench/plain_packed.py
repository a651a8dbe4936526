"""A plain HNSW search over packed rows that counts the rows it reads: the bytes behind ``kernel_roofline.hamming``.

``yardstick/plain_search.py`` walks f32 rows by cosine; this is the same
walk by the hamming distance on the served graph's packed rows: the uint32
lanes of the codec held as int32 (``vectors``), with the queries packed the
codec's way (bit i set iff ``x_i > 0.0``, least significant bit first,
zeros up to whole 64-bit words). The descent, the ``ef_upper`` rule and the
beams are ``plain_search``'s. It reads the graph's tables as plain tensors
and calls nothing of the program.

Each distinct store row, layer-0 link row and upper link row counts once
per call, at the configuration's widths: a store row is the packed bits
and no norm (the hamming search reads none), a layer-0 link row ``m0``
int32, an upper link row ``m`` int32 and its int32 slot-row entry, and each
query its packed bits. The count is the same whatever runs the search: the
host loop or a kernel is held to the same bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from annbench.yardstick import layers, peaks, plain_search
from annbench.yardstick import trace as ytrace
from annbench.yardstick.plain_search import RowsRead

#: the codec's word: rows are padded with zero bits to a multiple
WORD_BITS = 64
LANE_BITS = 32


def padded_bits(d: int) -> int:
    return -(-d // WORD_BITS) * WORD_BITS


def pack(x: torch.Tensor) -> torch.Tensor:
    """[B, D] float → [B, padded_bits(D) / 32] int32 lanes (the bits of the
    codec's uint32 lanes)."""
    bits = torch.zeros((x.shape[0], padded_bits(x.shape[1])), dtype=torch.int64, device=x.device)
    bits[:, : x.shape[1]] = (x > 0).long()
    weights = torch.ones(LANE_BITS, dtype=torch.int64, device=x.device) << torch.arange(LANE_BITS, device=x.device)
    lanes = (bits.view(x.shape[0], -1, LANE_BITS) * weights).sum(dim=2)
    return torch.where(lanes >= 2**31, lanes - 2**32, lanes).to(torch.int32)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 lane → int64."""
    x = x.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def rows_read(g, q: torch.Tensor, ef: int) -> RowsRead:
    """Run the plain packed search of ``q`` [B, D] (f32, packed here) on
    graph ``g`` at ``ef`` and count the distinct rows it read."""
    inf = float("inf")
    n_pad = g.vectors.shape[0]
    dev = q.device
    lanes = pack(q)
    seen_v = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    seen_l0 = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    n_levels = g.upper_links.shape[0]
    seen_up = torch.zeros((max(n_levels, 1), g.upper_links.shape[1]), dtype=torch.bool, device=dev)

    def dist(slots: torch.Tensor) -> torch.Tensor:
        ok = slots >= 0
        seen_v[slots[ok].long()] = True
        x = g.vectors[slots.clamp(min=0).long()]
        d = popcount(x ^ lanes[:, None, :]).sum(dim=2).float()
        return torch.where(ok, d, inf)

    def links(level: int, cur: torch.Tensor) -> torch.Tensor:
        ok = cur >= 0
        c = cur.clamp(min=0).long()
        if level == 0:
            seen_l0[c[ok]] = True
            nbs = g.links0[c]
        else:
            rows = g.slot_rows[level - 1][c]
            ok = ok & (rows >= 0)
            seen_up[level - 1][rows[ok].long()] = True
            nbs = g.upper_links[level - 1][rows.clamp(min=0).long()]
        nbs = torch.where(ok[:, None], nbs, -1)
        return torch.where((nbs >= 0) & g.valid[nbs.clamp(min=0).long()], nbs, -1)

    eps = g.entry_slots[g.entry_slots >= 0][None, :].expand(q.shape[0], -1)
    d = torch.where(g.valid[eps.long()], dist(eps), inf)
    best = d.argmin(dim=1, keepdim=True)
    cur, cur_d = eps.gather(1, best)[:, 0], d.gather(1, best)[:, 0]

    efu = plain_search.ef_upper_of(int(g.valid.sum()), ef)
    lowest_greedy = 2 if efu > 1 else 1
    for level in range(g.max_level, lowest_greedy - 1, -1):
        for _ in range(128):
            nbs = links(level, cur)
            nd = dist(nbs)
            j = nd.argmin(dim=1, keepdim=True)
            bd, bn = nd.gather(1, j)[:, 0], nbs.gather(1, j)[:, 0]
            better = bd < cur_d
            if not bool(better.any()):
                break
            cur, cur_d = torch.where(better, bn, cur), torch.where(better, bd, cur_d)

    seeds = cur[:, None]
    if efu > 1 and g.max_level >= 1:
        seeds = plain_search._beam(1, seeds, efu, dist, links)
    plain_search._beam(0, seeds, ef, dist, links)
    return RowsRead(int(seen_v.sum()), int(seen_l0.sum()), int(seen_up.sum()))


def bytes_read(rows: RowsRead, dim: int, m0: int, m: int, queries: int) -> int:
    """The bytes of those rows and the queries at the configuration's widths."""
    row = padded_bits(dim) // 8
    return rows.store_rows * row + rows.link0_rows * 4 * m0 + rows.upper_rows * (4 * m + 4) + queries * row


def kernel_roofline(ctx) -> float:
    """% : the least time of the bytes ``bytes_read`` counts for a sample
    of the traced calls, at the card's published bandwidth, over the device
    time of every kernel that starts inside those calls."""
    calls = ctx.calls()
    if not calls:
        raise layers.NothingToRead("no call of the traffic in the traced window")
    g = ctx.graph
    if g is None:
        raise layers.NothingToRead("the Reader serves no device graph under the name the plain search reads")
    cfg = ctx.cell.config
    rng = np.random.default_rng(ctx.seed)
    picks = sorted(rng.choice(len(calls), size=min(layers.ROOFLINE_SAMPLE, len(calls)), replace=False).tolist())
    batch, pool = ctx.cell.mix["batch"], cfg["query_pool"]
    least_s, kernel_ns = 0.0, 0
    for i in picks:
        ns = ytrace.kernel_time_in(ctx.device, [calls[i]])
        if ns <= 0:
            raise layers.NothingToRead(f"no kernel started inside call {i}")
        start = ctx.window.call_starts[i]
        q = ctx.data.queries[torch.arange(start, start + batch, device=ctx.data.queries.device) % pool]
        rows = rows_read(g, q, cfg["ef_search"])
        least_s += bytes_read(rows, cfg["dimensions"], cfg["m0"], cfg["m"], batch) / peaks.HBM_BYTES_PER_S
        kernel_ns += ns
    return 100.0 * least_s / (kernel_ns / 1e9)
