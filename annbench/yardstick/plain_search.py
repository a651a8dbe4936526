"""A plain HNSW search that counts the rows it reads: the bytes behind ``kernel_roofline``.

The search of the hannoy crate as the port runs it, in a few batched torch
operations: from the entry points a greedy walk down the upper layers, an
``ef_upper``-wide beam at layer 1 where the graph is large, and an ``ef``-wide
beam at layer 0 (each hop expands a row's best unexpanded entry while it is
no farther than the pool's worst; a candidate is taken when it is a live
item not already in the pool). It reads the graph's tables as plain
tensors (the attributes of the served graph: ``vectors``, ``norms``,
``links0``, ``upper_links``, ``slot_rows``, ``entry_slots``, ``valid``,
``max_level``) and calls nothing of the program.

It marks every store row whose distance it takes, every layer-0 link row
and every upper link row (with its slot-row entry) it reads. Each distinct
row counts once per call: that is the least a search of these queries on
this graph must bring from memory, whatever order it reads them in.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_EPS = 1.1920929e-07  # f32 epsilon, the cosine's zero-norm guard


class RowsRead(NamedTuple):
    store_rows: int
    link0_rows: int
    upper_rows: int

    def bytes(self, dim: int, m0: int, m: int, queries: int, elem: int = 4) -> int:
        """The bytes of those rows, by the configuration's widths: a store
        row is ``dim`` elements of ``elem`` bytes and its f32 norm, a
        layer-0 link row ``m0`` int32, an upper link row ``m`` int32 and
        its int32 slot-row entry; the f32 queries are read once."""
        return (
            self.store_rows * (elem * dim + 4)
            + self.link0_rows * 4 * m0
            + self.upper_rows * (4 * m + 4)
            + queries * 4 * dim
        )


def ef_upper_of(n_valid: int, ef: int) -> int:
    """The width of the layer-1 beam (the port's default rule)."""
    if n_valid >= 500_000:
        return max(1, min(32, ef))
    if n_valid >= 16_384:
        return max(1, min(8, ef))
    return 1


def rows_read(g, q: torch.Tensor, ef: int) -> RowsRead:
    """Run the plain search of ``q`` [B, D] (f32, cosine) on graph ``g`` at
    ``ef`` and count the distinct rows it read."""
    inf = float("inf")
    n_pad = g.vectors.shape[0]
    dev = q.device
    q = q.float()
    qn = q.norm(dim=1)
    seen_v = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    seen_l0 = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    n_levels = g.upper_links.shape[0]
    seen_up = torch.zeros((max(n_levels, 1), g.upper_links.shape[1]), dtype=torch.bool, device=dev)

    def dist(slots: torch.Tensor) -> torch.Tensor:
        ok = slots >= 0
        seen_v[slots[ok].long()] = True
        s = slots.clamp(min=0).long()
        x = g.vectors[s].float()
        den = g.norms[s] * qn[:, None]
        cos = (torch.einsum("bkd,bd->bk", x, q) / den.clamp(min=_EPS)).clamp(-1.0, 1.0)
        d = torch.where(den > _EPS, (1.0 - cos) * 0.5, torch.zeros_like(cos))
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
    d = dist(eps)
    d = torch.where(g.valid[eps.long()], d, inf)
    best = d.argmin(dim=1, keepdim=True)
    cur, cur_d = eps.gather(1, best)[:, 0], d.gather(1, best)[:, 0]

    efu = ef_upper_of(int(g.valid.sum()), ef)
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
        seeds = _beam(1, seeds, efu, dist, links)
    _beam(0, seeds, ef, dist, links)
    return RowsRead(int(seen_v.sum()), int(seen_l0.sum()), int(seen_up.sum()))


def _beam(level: int, seeds: torch.Tensor, ef: int, dist, links) -> torch.Tensor:
    """An ``ef``-wide beam at ``level`` from ``seeds`` [B, S] → the pool's slots [B, ef]."""
    inf = float("inf")
    b = seeds.shape[0]
    dev = seeds.device
    d = dist(seeds)
    pool_d = torch.full((b, ef), inf, device=dev)
    pool_i = torch.full((b, ef), -1, dtype=torch.long, device=dev)
    pool_x = torch.zeros((b, ef), dtype=torch.bool, device=dev)
    pool_d, pool_i, pool_x = _merge(pool_d, pool_i, pool_x, d, seeds.long(), ef)
    for _ in range(2 * ef + 16):
        unexp = torch.where(~pool_x & (pool_i >= 0), pool_d, inf)
        pos = unexp.argmin(dim=1, keepdim=True)
        exp_d = unexp.gather(1, pos)[:, 0]
        active = (exp_d <= pool_d[:, -1]) & (exp_d < inf)
        if not bool(active.any()):
            break
        pool_x = pool_x | (torch.zeros_like(pool_x).scatter(1, pos, active[:, None]))
        cur = torch.where(active, pool_i.gather(1, pos)[:, 0], -1)
        nbs = links(level, cur)
        fresh = (nbs >= 0) & ~(nbs[:, :, None] == pool_i[:, None, :]).any(dim=2)
        nbs = torch.where(fresh, nbs, -1)
        pool_d, pool_i, pool_x = _merge(pool_d, pool_i, pool_x, dist(nbs), nbs.long(), ef)
    return pool_i


def _merge(pool_d, pool_i, pool_x, d, ids, ef):
    d = torch.where(ids >= 0, d, float("inf"))
    # one entry per id: a seed list may repeat an id
    srt, order = torch.sort(ids, dim=1)
    dup = torch.zeros_like(srt, dtype=torch.bool)
    dup[:, 1:] = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    d = d.scatter(1, order, torch.where(dup, float("inf"), d.gather(1, order)))
    ids = torch.where(d < float("inf"), ids, -1)
    all_d = torch.cat([pool_d, d], dim=1)
    all_i = torch.cat([pool_i, ids], dim=1)
    all_x = torch.cat([pool_x, torch.zeros_like(ids, dtype=torch.bool)], dim=1)
    top = torch.sort(all_d, dim=1, stable=True).indices[:, :ef]
    return all_d.gather(1, top), all_i.gather(1, top), all_x.gather(1, top)
