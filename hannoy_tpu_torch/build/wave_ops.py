"""Device ops for wave-parallel graph construction.

Counterpart of the insertion half of ``hannoy_tpu/build/wave_ops.py``: a
*wave* of W items is inserted at once — one batched candidate search, one
batched α-prune, one forward-row scatter, and one deterministic
reverse-edge merge (edges sorted by (destination, distance)).

Where the JAX functions thread the graph through pure updates, these
update ``g``'s tables **in place** and return ``g`` for symmetry. Every
read that the JAX code takes from the state before an update is taken
here before the write as well (e.g. ``_ensure_inbound`` reads ``links0``
before it writes). JAX's ``.at[...].set(mode="drop")`` scatters become
masked index assignments on int64 indices; their destinations never
repeat except where noted.

``reverse_merge_edges_streamed`` is the bulk connector's global variant
of the reverse merge. ``fill_link_dists`` recomputes the link distances
of a graph loaded from the store. ``repair_deleted_rows`` and
``clear_slots`` are the deletion pass. Not ported (options that default
to off, ROADMAP.md): slack rows, prototype seeding.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.hnsw import DeviceGraph
from ..ops import beam, distances, prune, topk
from ..ops.topk import INF, NO_ID


class WaveLevelResult(NamedTuple):
    graph: DeviceGraph
    selected: torch.Tensor  # [W, cap] pruned neighbors (next level's seeds)
    dirty: torch.Tensor  # [N_pad] bool — slots whose link rows changed
    counters: torch.Tensor  # [4] i32: fwd links, reverse link delta, beam iters, row gathers


#: counters[] layout (device-accumulated build statistics)
CNT_FWD_LINKS = 0
CNT_REV_DELTA = 1
CNT_BEAM_ITERS = 2
CNT_ROW_GATHERS = 3  # unit: 1024 gathered rows
GATHER_GRANULE = 1024

#: destinations per phase-A step of the streamed reverse merge (bounds
#: its [CH, 2·cap, 2·cap] duplicate mask)
CHUNK_A = 8192
#: rows per reverse-merge α-prune step (bounds the [CH, K, D] gather)
CHUNK_B = 2048

_KEY_LAST = 2**30  # sort key that orders invalid entries last


def _ix(t: torch.Tensor) -> torch.Tensor:
    return t.clamp(min=0).long()


def _scatter_rows(table: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor) -> None:
    """``table[rows] = vals`` in place, rows at -1 dropped."""
    keep = rows >= 0
    table[rows[keep].long()] = vals[keep]


def _set_level_rows(g: DeviceGraph, level: int, slots: torch.Tensor, ids: torch.Tensor, d: torch.Tensor) -> None:
    """Overwrite link rows of ``slots`` at ``level`` in place (slots may be
    NO_ID); rows are as wide as the table."""
    if level == 0:
        _scatter_rows(g.links0, slots, ids)
        _scatter_rows(g.dists0, slots, d)
        return
    rows = torch.where(slots >= 0, g.slot_rows[level - 1][_ix(slots)], NO_ID)
    _scatter_rows(g.upper_links[level - 1], rows, ids)
    _scatter_rows(g.upper_dists[level - 1], rows, d)


def _level_rows(g: DeviceGraph, level: int, slots: torch.Tensor):
    """(ids, dists) link rows of ``slots`` at ``level``."""
    ids = beam.links_at(g, level, slots)
    if level == 0:
        d = g.dists0[_ix(slots)]
    else:
        rows = g.slot_rows[level - 1][_ix(slots)]
        d = g.upper_dists[level - 1][_ix(rows)]
        d = torch.where((rows >= 0)[:, None], d, INF)
    return ids, torch.where(ids != NO_ID, d, INF)


def _lexsort2(key: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Permutation sorting by (key, dist), ties in input order — JAX's
    two-key stable ``lax.sort`` as two stable sorts, secondary key first."""
    o1 = torch.sort(dist, stable=True).indices
    return o1[torch.sort(key[o1], stable=True).indices]


def _segments(sorted_key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Segments of equal keys in a sorted key array → (first [E] bool,
    seg_id [E], rank within segment [E])."""
    E = sorted_key.shape[0]
    idx = torch.arange(E, device=sorted_key.device)
    first = torch.ones(E, dtype=torch.bool, device=sorted_key.device)
    first[1:] = sorted_key[1:] != sorted_key[:-1]
    seg_id = torch.cumsum(first.long(), 0) - 1
    seg_start = torch.cummax(torch.where(first, idx, 0), 0).values
    return first, seg_id, idx - seg_start


def _pad_cols(ids: torch.Tensor, d: torch.Tensor, width: int):
    pad = width - ids.shape[1]
    if pad > 0:
        ids = torch.nn.functional.pad(ids, (0, pad), value=NO_ID)
        d = torch.nn.functional.pad(d, (0, pad), value=INF)
    return ids, d


def wave_insert_level(
    g: DeviceGraph,
    wave_slots: torch.Tensor,  # [W] int32 (-1 padded)
    seeds: torch.Tensor,  # [W, S] entry slots for this level's walk
    node_ok: torch.Tensor,  # [N_pad] exists-and-not-deleted (beam traversal)
    level: int,
    dirty: torch.Tensor,  # [N_pad] bool touched-row accumulator
    counters: torch.Tensor,  # [4] i32 build statistics
    ef: int = 100,
    cap: int = 32,
    alpha: float = 1.0,
    inc_cap: int = 16,
    flat: bool = False,
    beam_iters: Optional[int] = None,
    beam_tail_allow: int = 0,
    flat_members: Optional[torch.Tensor] = None,  # [U] compact member slots (-1 pad)
    flat_col_order: Optional[torch.Tensor] = None,  # [U] insertion rank per column
    flat_row_base: int = 0,  # insertion rank of wave row 0
) -> WaveLevelResult:
    """Insert one wave at one level (the batched hnsw.rs:312-327 body).

    1. candidate search: a beam at ``level``, exact top-ef against a
       compact member table (``flat_members``), or exact over every live
       slot (``flat``). Against a member table the candidates are the
       already-active members or, with ``flat_col_order``, triangular
       insertion-order visibility: column j is a candidate for wave row i
       iff ``flat_col_order[j] < flat_row_base + i`` (already active
       columns carry rank -1, columns never visible 2**30), so one wave
       can carry a whole level group. Member tables wider than 8192 are
       where the JAX package switches to ``lax.approx_max_k``; the port
       always takes the exact top-k, so it differs there only in what the
       approximate selection misses (level 1 of a 100k build at m=16 has
       about 6.3k members);
    2. α-prune → forward row scatter;
    3. deterministic reverse-edge merge with overflow α-prune;
    4. at layer 0, the stranded-insert guarantee (``_ensure_inbound``).

    ``dirty`` and ``counters`` are updated in place.
    """
    metric = g.metric
    W = wave_slots.shape[0]
    wave_ok = wave_slots >= 0
    q = g.vectors[_ix(wave_slots)]
    qn = g.norms[_ix(wave_slots)]

    if flat_members is not None:
        mem = _ix(flat_members)
        # packed rows: the table is bounded, so the popcounts ride one
        # matrix product over unpacked bits (exact)
        table_distances = distances.packed_matrix_mxu if metric.is_packed else distances.matrix_distances
        d_mat = table_distances(metric, q, qn, g.vectors[mem], g.norms[mem])
        if flat_col_order is not None:
            row_ord = flat_row_base + torch.arange(W, device=q.device)
            ok_col = flat_col_order[None, :] < row_ord[:, None]
        else:
            ok_col = ((flat_members >= 0) & g.valid[mem])[None, :]
        d_mat = torch.where(ok_col, d_mat, INF)
        cand_d, idx = topk.smallest_k(d_mat, min(ef, flat_members.shape[0]))
        cand_ids = torch.where(torch.isfinite(cand_d), flat_members[idx], NO_ID)
        cand_ids, cand_d = _pad_cols(cand_ids, cand_d, ef)
    elif flat:
        d_mat = distances.matrix_distances(metric, q, qn, g.vectors, g.norms)
        member = g.valid if level == 0 else g.valid & (g.slot_rows[level - 1] >= 0)
        d_mat = torch.where(member[None, :], d_mat, INF)
        cand_d, idx = topk.smallest_k(d_mat, min(ef, g.capacity))
        cand_ids = torch.where(torch.isfinite(cand_d), idx, NO_ID).to(torch.int32)
        cand_ids, cand_d = _pad_cols(cand_ids, cand_d, ef)
    else:
        # construction beams: ef + 16 expansions; layer 0 expands only the
        # first ``cap`` links of a row
        res = beam.beam_search(
            g, q, qn, seeds, ef,
            max_iters=beam_iters if beam_iters is not None else ef + 16,
            node_ok=node_ok, level=level,
            traverse_k=cap if level == 0 else None,
            tail_allow=beam_tail_allow if level == 0 else 0,
        )
        cand_ids, cand_d = res.slots, res.dists
        width = cap if level == 0 else g.upper_links.shape[-1]
        counters[CNT_BEAM_ITERS] += res.iters
        # every beam iteration gathers W * width vector rows
        counters[CNT_ROW_GATHERS] += res.iters * max(1, round(W * width / GATHER_GRANULE))

    # exclude self (re-inserted entry points find themselves at distance 0)
    drop = (cand_ids == wave_slots[:, None]) | ~wave_ok[:, None]
    cand_ids = torch.where(drop, NO_ID, cand_ids)
    cand_d = torch.where(drop, INF, cand_d)

    sel_ids, sel_d = prune.robust_prune(metric, g.vectors, g.norms, cand_ids, cand_d, cap, alpha)

    # ---- forward rows ----
    _set_level_rows(g, level, wave_slots, sel_ids, sel_d)
    counters[CNT_FWD_LINKS] += (sel_ids != NO_ID).sum()
    dirty[wave_slots[wave_ok].long()] = True

    # ---- reverse edges: sorted-COO segment merge ----
    g, counters, u_dst = reverse_merge_edges(
        g, level, wave_slots, sel_ids, sel_d, counters, cap, alpha, inc_cap
    )
    dirty[u_dst.long()] = True

    # ---- stranded-insert guarantee (layer 0) ----
    if level == 0:
        g, dirty, counters = _ensure_inbound(g, wave_slots, sel_ids, sel_d, dirty, counters)
    return WaveLevelResult(g, sel_ids, dirty, counters)


def reverse_merge_edges(
    g: DeviceGraph,
    level: int,
    src_slots: torch.Tensor,  # [W] edge sources (-1 padded)
    sel_ids: torch.Tensor,  # [W, cap] each source's selected destinations
    sel_d: torch.Tensor,  # [W, cap]
    counters: torch.Tensor,
    cap: int,
    alpha: float,
    inc_cap: int = 16,
) -> tuple[DeviceGraph, torch.Tensor, torch.Tensor]:
    """Merge the reverse of (src → sel) edges into destination rows.

    Edges are sorted by (destination, distance) and each destination
    keeps its ``inc_cap`` nearest incoming edges; then

    A. a cheap distance-merge with no vector gathers over every unique
       destination, finalizing rows that fit the table width, and
    B. an α-prune (``prune.merge_link_rows``) over the rows that
       overflowed, in chunks of ``CHUNK_B``.

    The JAX package runs A in chunks too; destinations are distinct, so a
    chunk never reads a row an earlier chunk wrote, and one pass gives the
    same rows. The host reads the number of unique destinations once.

    Returns (graph, counters, u_dst [U] unique destinations touched).
    """
    dst = sel_ids.reshape(-1)  # [W*cap]
    src = src_slots.repeat_interleave(cap)
    rd = sel_d.reshape(-1)
    ok = (dst != NO_ID) & (src != NO_ID)
    order = _lexsort2(torch.where(ok, dst, _KEY_LAST), rd)
    rd_s, src_s, dst_s = rd[order], src[order], dst[order]
    first, seg_id, rank = _segments(torch.where(ok, dst, _KEY_LAST)[order])
    valid_e = dst_s != NO_ID  # invalid edges sort after every valid segment

    u_dst = dst_s[first & valid_e]  # [U] unique destinations, segment order
    n_unique = u_dst.shape[0]
    keep = valid_e & (rank < inc_cap)
    inc_ids = torch.full((n_unique, inc_cap), NO_ID, dtype=torch.int32, device=dst.device)
    inc_d = torch.full((n_unique, inc_cap), INF, device=dst.device)
    inc_ids[seg_id[keep], rank[keep]] = src_s[keep]
    inc_d[seg_id[keep], rank[keep]] = rd_s[keep]

    g, counters, over = _reverse_cheap_merge(g, level, u_dst, inc_ids, inc_d, counters)
    g, counters = _reverse_prune_overflow(g, level, u_dst, inc_ids, inc_d, over, counters, cap, alpha)
    return g, counters, u_dst


def _reverse_cheap_merge(g: DeviceGraph, level: int, u_dst, inc_ids, inc_d, counters):
    """Phase A: distance-merge incoming edges into each receiving row (no
    vector gathers); finalize rows that fit the table width. Returns
    (graph, counters, positions in ``u_dst`` of the rows that overflowed)."""
    row_ids, row_d = _level_rows(g, level, u_dst)
    tw = row_ids.shape[-1]
    ids = torch.cat([row_ids, inc_ids], dim=-1)
    d = torch.cat([row_d, inc_d], dim=-1)
    keepm = topk.unique_mask(ids) & torch.isfinite(d)
    d, ids = topk.sort_by_dist(torch.where(keepm, d, INF), torch.where(keepm, ids, NO_ID))
    n_total = (ids != NO_ID).sum(-1)
    fits = n_total <= tw
    old_n = (row_ids != NO_ID).sum(-1)
    counters[CNT_REV_DELTA] += torch.where(fits, n_total - old_n, 0).sum()
    _set_level_rows(g, level, torch.where(fits, u_dst, NO_ID), ids[:, :tw], d[:, :tw])
    return g, counters, torch.nonzero(~fits)[:, 0]


def _reverse_prune_overflow(g: DeviceGraph, level: int, u_dst, inc_ids, inc_d, over, counters, cap: int, alpha: float):
    """Phase B: α-prune the rows phase A could not fit (reference
    ``add_link`` overflow branch), ``CHUNK_B`` rows per step."""
    for p0 in range(0, over.shape[0], CHUNK_B):
        p = over[p0 : p0 + CHUNK_B]
        dst_c = u_dst[p]
        row_ids, row_d = _level_rows(g, level, dst_c)
        m_ids, m_d = prune.merge_link_rows(
            g.metric, g.vectors, g.norms, row_ids, row_d, inc_ids[p], inc_d[p], cap, alpha
        )
        counters[CNT_REV_DELTA] += ((m_ids != NO_ID).sum(-1) - (row_ids != NO_ID).sum(-1)).sum()
        _set_level_rows(g, level, dst_c, m_ids, m_d)
    return g, counters


def reverse_merge_edges_streamed(
    g: DeviceGraph,
    level: int,
    src_slots: torch.Tensor,  # [n_pad] edge sources (-1 padded)
    sel_ids: torch.Tensor,  # [n_pad, cap] each source's selected destinations
    sel_d: torch.Tensor,  # [n_pad, cap]
    counters: torch.Tensor,
    cap: int,
    alpha: float,
    inc_cap: int,
) -> tuple[DeviceGraph, torch.Tensor, torch.Tensor]:
    """The bulk connector's reverse merge: ONE (destination, distance) sort
    over every reverse edge of the layer, and every destination merged
    exactly once with its ``inc_cap`` nearest incoming edges (edges beyond
    that rank would lose the α-prune against nearer ones anyway).

    Each destination's incoming edges are a window of its segment in the
    sorted edge list (``[U, inc_cap]`` tables, not ``[E, inc_cap]``).
    Phase A runs over the unique destinations in ``CHUNK_A`` steps, phase
    B over the rows that overflowed in ``CHUNK_B`` steps; destinations are
    distinct, so the chunking does not change the result. (Phase B takes
    the overflow list as it is and never re-reads a merged destination,
    which the JAX package's unpadded phase-B slice can do when its chunk
    size does not divide the table.)

    Returns (graph, counters, u_dst [U] unique destinations touched).
    """
    dst = sel_ids.reshape(-1)
    src = src_slots.repeat_interleave(sel_ids.shape[1])
    rd = sel_d.reshape(-1)
    key = torch.where((dst != NO_ID) & (src != NO_ID), dst, _KEY_LAST)
    order = _lexsort2(key, rd)
    key_s, rd_s, src_s = key[order], rd[order], src[order]
    live = key_s != _KEY_LAST  # live edges sort before every dead one
    first = torch.ones_like(live)
    first[1:] = key_s[1:] != key_s[:-1]
    starts = torch.nonzero(first & live)[:, 0]  # [U] segment starts
    u_dst = key_s[starts]
    ends = torch.cat([starts[1:], live.sum().reshape(1)])
    rank = torch.arange(inc_cap, device=dst.device)[None, :]
    window = (starts[:, None] + rank).clamp(max=max(dst.shape[0] - 1, 0))
    in_seg = rank < (ends - starts)[:, None]
    inc_ids = torch.where(in_seg, src_s[window], NO_ID)
    inc_d = torch.where(in_seg, rd_s[window], INF)

    over = []
    for p0 in range(0, u_dst.shape[0], CHUNK_A):
        part = slice(p0, p0 + CHUNK_A)
        g, counters, o = _reverse_cheap_merge(g, level, u_dst[part], inc_ids[part], inc_d[part], counters)
        over.append(o + p0)
    over = torch.cat(over) if over else starts
    g, counters = _reverse_prune_overflow(g, level, u_dst, inc_ids, inc_d, over, counters, cap, alpha)
    return g, counters, u_dst


def _ensure_inbound(
    g: DeviceGraph,
    wave_slots: torch.Tensor,  # [W]
    sel_ids: torch.Tensor,  # [W, cap] pruned forward links (ascending)
    sel_d: torch.Tensor,  # [W, cap]
    dirty: torch.Tensor,
    counters: torch.Tensor,
    k_check: int = 4,
    force_cap: int = 4,
    write_cap: Optional[int] = None,
    indeg: Optional[torch.Tensor] = None,
) -> tuple[DeviceGraph, torch.Tensor, torch.Tensor]:
    """Force ≥1 inbound layer-0 edge for wave items the reverse merge
    stranded (the JAX package's stranded-insert guarantee).

    A wave item absent from the rows of its ``k_check`` nearest selected
    neighbors is written into its nearest neighbor's row — the last
    column, or with ``indeg`` the worst column whose occupant can lose an
    in-edge — at most ``force_cap`` per destination, sorted by
    (destination, distance); touched rows are re-sorted. ``write_cap``:
    column budget the forced edge must land under (the end-of-build
    re-check passes m0). Where two forced edges would land in the same
    cell (possible only with ``indeg``), the later one in sort order wins.
    """
    W, cap = sel_ids.shape
    near = sel_ids[:, :k_check]
    rows = beam.links_at(g, 0, near.reshape(-1)).reshape(W, near.shape[1], -1)
    present = ((rows == wave_slots[:, None, None]) & (near != NO_ID)[:, :, None]).any(-1).any(-1)
    need = (wave_slots >= 0) & ~present & (sel_ids[:, 0] != NO_ID)
    dst = torch.where(need, sel_ids[:, 0], NO_ID)
    d0 = torch.where(need, sel_d[:, 0], INF)

    sort_key = torch.where(need, dst, _KEY_LAST)
    order = _lexsort2(sort_key, d0)
    dd, src_s, dst_s = d0[order], wave_slots[order], dst[order]
    _, _, rank = _segments(sort_key[order])
    keep = (dst_s != NO_ID) & (rank < force_cap)

    tw = g.links0.shape[-1]
    wc = tw if write_cap is None else min(write_cap, tw)
    rank_k = torch.where(keep, rank, 0)
    keep_write = keep
    if indeg is None:
        col = wc - 1 - rank_k
    else:
        # rank-th worst column of dst whose occupant is safe to displace
        occ = g.links0[_ix(dst_s), :wc]  # [W, wc]
        occ_safe = (occ == NO_ID) | (indeg[_ix(occ)] >= 2)
        j = torch.arange(wc, device=occ.device)[None, :]
        safe_desc = torch.sort(torch.where(occ_safe, j, -1), dim=-1, descending=True).values
        picked = safe_desc.gather(1, rank_k[:, None])[:, 0]
        col = torch.where(picked >= 0, picked, wc - 1 - rank_k)
        cell = torch.where(keep, dst_s.long() * wc + col, -1)
        later = torch.zeros_like(keep)
        for s in range(1, force_cap):
            later[:-s] |= (cell[:-s] == cell[s:]) & (cell[:-s] >= 0)
        keep_write = keep & ~later
    w_dst, w_col = dst_s[keep_write].long(), col[keep_write]
    g.links0[w_dst, w_col] = src_s[keep_write]
    g.dists0[w_dst, w_col] = dd[keep_write]

    # re-sort the touched rows (ascending-row invariant)
    touched = torch.where(keep, dst_s, NO_ID)
    t_d, t_rows = topk.sort_by_dist(g.dists0[_ix(touched)], g.links0[_ix(touched)])
    _scatter_rows(g.links0, touched, t_rows)
    _scatter_rows(g.dists0, touched, t_d)

    dirty[dst_s[keep].long()] = True
    counters[CNT_FWD_LINKS] += keep.sum()
    return g, dirty, counters


def layer0_indegree(g: DeviceGraph, cap: Optional[int] = None) -> torch.Tensor:
    """Layer-0 in-degree of every slot, counting edges from live rows only
    → [capacity] int32. ``cap``: count only the first ``cap`` columns."""
    links = g.links0 if cap is None else g.links0[:, :cap]
    links = torch.where(g.valid[:, None], links, NO_ID)
    tgt = links[links != NO_ID].long()
    return torch.bincount(tgt, minlength=g.capacity).to(torch.int32)


def layer0_degrees(g: DeviceGraph, cap: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(in-degree, out-degree) of every slot at layer 0 → two [capacity]
    int32 tensors (the end-of-build re-check's probe)."""
    links = g.links0 if cap is None else g.links0[:, :cap]
    outdeg = (links != NO_ID).sum(-1).to(torch.int32)
    return layer0_indegree(g, cap), outdeg


def force_inbound_for(
    g: DeviceGraph,
    stranded: torch.Tensor,  # [S] slots with layer-0 in-degree 0 (-1 padded)
    indeg: torch.Tensor,  # [capacity] current layer-0 in-degree
    dirty: torch.Tensor,
    counters: torch.Tensor,
    shift: int = 0,
    write_cap: Optional[int] = None,
):
    """Force one inbound edge for each already-built stranded row, using
    its current forward links as destination candidates — preferring
    neighbors whose displaced worst link's target keeps another in-edge,
    and rotating the preference by ``shift`` across re-check rounds."""
    ok = stranded != NO_ID
    rows = g.links0[_ix(stranded)][:, shift:]
    dcol = g.dists0[_ix(stranded)][:, shift:]
    vcol = (g.links0.shape[-1] if write_cap is None else write_cap) - 1
    victim = g.links0[_ix(rows), vcol]  # [S, W]
    safe = (rows != NO_ID) & ((victim == NO_ID) | (indeg[_ix(victim)] >= 2))
    # stable partition: safe destinations first, ascending order kept
    W = rows.shape[1]
    pos = torch.arange(W, device=rows.device)[None, :]
    key = torch.where(rows == NO_ID, 2 * W + pos, torch.where(safe, pos, W + pos))
    order = torch.argsort(key, dim=1)
    sel_ids = torch.where(ok[:, None], rows.gather(1, order), NO_ID)
    sel_d = torch.where(ok[:, None], dcol.gather(1, order), INF)
    return _ensure_inbound(
        g, stranded, sel_ids, sel_d, dirty, counters, write_cap=write_cap, indeg=indeg
    )


def fill_link_dists(g: DeviceGraph, host, block: int = 4096) -> DeviceGraph:
    """Recompute per-link distances for a graph loaded from the store.

    Persisted rows carry ids only (the reference stores RoaringBitmaps,
    node.rs:133-174); builders need the ScoredLink distances back. Per
    level and per block of ``block`` owners: one gather-distance call
    owner → its link row (``[block, M0 or M]`` candidates), +inf where the
    id is ``NO_ID``, and the rows written back distance-sorted (builders
    rely on ascending rows). Updates ``g`` in place; ``host`` is the
    ``HostGraph`` ``g`` was uploaded from.
    """
    for level in range(host.max_level + 1):
        owners = np.nonzero(host.levels >= 0 if level == 0 else host.slot_rows[level - 1] >= 0)[0]
        for start in range(0, len(owners), block):
            chunk = np.full(block, -1, dtype=np.int32)
            sel = owners[start : start + block]
            chunk[: len(sel)] = sel
            slots = torch.from_numpy(chunk).to(g.device)
            ids = beam.links_at(g, level, slots)
            d = beam.candidate_distances(g, g.vectors[_ix(slots)], g.norms[_ix(slots)], ids)
            d, ids = topk.sort_by_dist(torch.where(ids != NO_ID, d, INF), ids)
            _set_level_rows(g, level, slots, ids, d)
    return g


def repair_deleted_rows(
    g: DeviceGraph,
    row_slots: torch.Tensor,  # [R] owners with >= 1 deleted neighbour (-1 padded)
    deleted: torch.Tensor,  # [N_pad] bool
    level: int,
    cap: int,
    alpha: float,
    ext_cap: int = 64,
) -> DeviceGraph:
    """FreshDiskANN gap fill (the reference's fill_gaps_from_deleted,
    hnsw.rs:334-415), batched, in place.

    For each owner row: drop its deleted neighbours, splice in those
    neighbours' own rows at ``level`` — without deleted ids, self-links,
    ids already in the row or repeats, keeping the first ``ext_cap`` (the
    JAX package's documented deviation from the reference's unbounded
    splice) — compute the spliced ids' distances to the owner (the kernel,
    ``[R, ext_cap]``), and merge them into the row with
    ``prune.merge_link_rows`` (α-prune on overflow)."""
    R = row_slots.shape[0]
    row_ids, row_d = _level_rows(g, level, row_slots)

    is_del = deleted[_ix(row_ids)] & (row_ids != NO_ID)
    base_ids = torch.where(is_del, NO_ID, row_ids)
    base_d = torch.where(is_del, INF, row_d)

    ext = beam.links_at(g, level, torch.where(is_del, row_ids, NO_ID).reshape(-1)).reshape(R, -1)
    ext = torch.where(deleted[_ix(ext)], NO_ID, ext)
    ext = torch.where(ext == row_slots[:, None], NO_ID, ext)  # no self-links
    ext = torch.where(topk.contains(ext, base_ids), NO_ID, ext)
    ext = torch.where(topk.unique_mask(ext), ext, NO_ID)
    order = torch.argsort((ext == NO_ID).to(torch.int32), dim=-1, stable=True)
    ext = ext.gather(1, order)[:, :ext_cap].contiguous()

    ext_d = beam.candidate_distances(g, g.vectors[_ix(row_slots)], g.norms[_ix(row_slots)], ext)
    ext_d = torch.where(ext != NO_ID, ext_d, INF)

    merged_ids, merged_d = prune.merge_link_rows(
        g.metric, g.vectors, g.norms, base_ids, base_d, ext, ext_d, cap, alpha
    )
    _set_level_rows(g, level, row_slots, merged_ids, merged_d)
    return g


def clear_slots(g: DeviceGraph, slots: torch.Tensor) -> DeviceGraph:
    """Invalidate deleted slots and wipe their layer-0 rows, in place (the
    host wipes their upper rows, where compact row reuse is managed)."""
    keep = slots[slots >= 0].long()
    g.valid[keep] = False
    g.links0[keep] = NO_ID
    g.dists0[keep] = INF
    return g


def activate_wave(g: DeviceGraph, wave_slots: torch.Tensor) -> DeviceGraph:
    """Mark a wave's slots searchable for subsequent waves (in place)."""
    g.valid[wave_slots[wave_slots >= 0].long()] = True
    return g
