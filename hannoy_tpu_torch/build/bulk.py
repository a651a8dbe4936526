"""Bulk cluster-blocked construction — the fresh-build path for large indexes.

Counterpart of ``hannoy_tpu/build/bulk.py``, which the JAX package takes
by default for fresh builds of ``bulk_threshold`` items or more under
every metric but f32 manhattan (``eligible``). Instead of inserting items, it builds layer
0 from dense, matrix-product-shaped work:

1. **candidates**: exact kNN over all members up to ``BRUTE_MAX``
   members; above that, a k-means partition (maxmin init, Lloyd steps as
   one-hot products), then per pseudo-cluster one ``[S, A·S]`` distance
   block against its A nearest clusters (``distances.block_distances``)
   and each row's top-K, plus the closest boundary pair per adjacent
   cluster; and ``RAND_CANDIDATES`` random long-edge candidates per item,
   whose distances run through the gather-distance kernel;
2. **connect**: α-prune every candidate list into its forward row
   (pass 1), one global reverse merge
   (``wave_ops.reverse_merge_edges_streamed``, pass 2), the stranded-row
   guarantee (``wave_ops._ensure_inbound``, pass 3);
3. **cross links**: the boundary pairs forced as edges both ways.

The routing layers (every item of level >= 1) are built before this by
the insertion waves in ``builder.build_graph`` (the navigability
backbone), and only the level-0 items are connected here.

Only layer 0 is built here, with the JAX package's default knobs as the
constants below: its bulk-built upper layers (``bulk_upper``), slot
renumbering, random k-means init and the cancellable connect are not
ported (``builder._check_supported`` raises for a cancel). The top-K is
exact where the JAX package uses ``lax.approx_max_k`` (exact off the TPU
as well). Sums that the JAX package takes as one-hot products stay
products here: a scatter-add of floats on CUDA sums in a different order
on every run, and the build is deterministic.

Packed metrics cluster in the unpacked {0, 1} space: centroids are
continuous bit-probability vectors (f32 ``[C, D_pad]``) and the assignment
is by squared euclidean distance, which every packed metric is monotone
in; their candidate blocks take popcounts from products of unpacked bits
(``distances.block_distances``, ``packed_matrix_mxu``). Rows of a storage
tier cluster as the f32 values of what is stored (bf16 values, int8
codes), as in the JAX package; the cluster centroids for the adjacency
stay f32 and are compared by the metric's f32 formula (the JAX package
casts them to the rows' type, which leaves every euclidean int8 centroid
with scale 0).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.hnsw import DeviceGraph
from ..ops import beam, beam_cuda, distances, prune, topk
from ..ops.topk import INF, NO_ID
from ..utils.tracing import span
from . import wave_ops

#: member counts at or below this use exact brute-force kNN candidates
BRUTE_MAX = 16384
#: rows connected per pass step (the prune gathers [CONNECT_CHUNK, K, D])
CONNECT_CHUNK = 4096
#: k-means rows per assignment product
KMEANS_CHUNK = 8192
#: pseudo-clusters per candidate step (a [G, S, A·S] distance block)
CAND_GROUP = 4
#: rows per random-candidate distance launch
RAND_CHUNK = 8192
#: forced boundary edges per source row at most
FORCE_CAP = 4
#: k-means target cluster size, Lloyd iterations, and the adjacent
#: pseudo-clusters each one's candidate block spans
CLUSTER_SIZE = 512
KMEANS_ITERS = 3
ADJ = 8
#: members sampled for the maxmin (furthest-point) centroid init
INIT_SAMPLE = 131072
#: random long-edge candidates per item
RAND_CANDIDATES = 8
#: α of the bulk prune when the caller keeps the reference's α = 1.0:
#: kNN-only candidate lists lack the long edges of an insertion-order
#: build, and a mildly diverse prune restores navigability
BULK_ALPHA = 1.1

#: metrics the dense block path supports (f32 manhattan would
#: materialise [G, S, T, D] and stays on the wave path)
BULK_METRICS = (
    "cosine",
    "euclidean",
    "hamming",
    "binary quantized cosine",
    "binary quantized euclidean",
    "binary quantized manhattan",
)


def eligible(metric, n_active: int, n_deleted: int, n_insert: int, opts) -> bool:
    """Bulk path applies to large fresh builds of every metric except f32
    manhattan. Incremental builds and deletes keep the wave path."""
    if opts.bulk is False:
        return False
    if metric.name not in BULK_METRICS:
        return False
    if n_active or n_deleted:
        return False
    if opts.bulk is True:
        return n_insert > 1
    return n_insert >= opts.bulk_threshold


def _pad_to(a: np.ndarray, multiple: int, fill) -> np.ndarray:
    pad = (-len(a)) % multiple
    if not pad:
        return a
    return np.concatenate([a, np.full((pad,) + a.shape[1:], fill, dtype=a.dtype)])


def _ix(t: torch.Tensor) -> torch.Tensor:
    return t.clamp(min=0).long()


def _fit_rows(t: torch.Tensor, rows: int, fill) -> torch.Tensor:
    """``t`` cut or padded with ``fill`` to ``rows`` rows."""
    if t.shape[0] >= rows:
        return t[:rows]
    return torch.cat([t, torch.full((rows - t.shape[0],) + t.shape[1:], fill, dtype=t.dtype, device=t.device)])


# --------------------------------------------------------------------------
# k-means partition
# --------------------------------------------------------------------------


def _member_rows(dev: DeviceGraph, slots: torch.Tensor) -> torch.Tensor:
    """The rows of ``slots`` in the space the partition works in → f32:
    unpacked {0, 1} bits for the packed codecs, else the stored values."""
    raw = dev.vectors[_ix(slots)]
    return distances.unpack_bits(raw) if dev.metric.is_packed else raw.to(torch.float32)


def _centroid_norms(metric: distances.Metric, centroids: torch.Tensor) -> torch.Tensor:
    if metric.name == "cosine":
        return (centroids * centroids).sum(-1).sqrt()
    return torch.zeros(centroids.shape[0], dtype=torch.float32, device=centroids.device)


def _one_hot_sums(x: torch.Tensor, assign: torch.Tensor, ok: torch.Tensor, n_clusters: int):
    """Per-cluster sums and counts of the rows ``x`` with ``ok``, as the
    one-hot product the JAX package takes (a fixed-order reduction)."""
    oh = torch.nn.functional.one_hot(assign.clamp(min=0).long(), n_clusters).to(torch.float32)
    oh = oh * ok[:, None]
    return oh.T @ x, oh.sum(0)


def _kmeans_step(
    dev: DeviceGraph,
    member_slots: torch.Tensor,  # [n_pad] (-1 padded to the chunk)
    centroids: torch.Tensor,  # [C, D]
    chunk: int = KMEANS_CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd iteration → (new centroids, assignment [n_pad], -1 on
    padding). The assignment keeps only the terms that vary with the
    centroid and takes the products on bf16-rounded rows (``BULK_BF16``):
    cosine by ``-dot / |c|``, euclidean by ``|c|² - 2·dot``; the packed
    codecs by ``|c|² - 2·dot`` over unpacked bits and unrounded centroids.
    Empty clusters keep their previous centroid."""
    metric = dev.metric
    C, D = centroids.shape
    cn = _centroid_norms(metric, centroids)
    c2 = (centroids * centroids).sum(-1)
    cb = centroids if metric.is_packed else distances.bf16_round(centroids)
    sums = torch.zeros((C, D), dtype=torch.float32, device=dev.device)
    counts = torch.zeros(C, dtype=torch.float32, device=dev.device)
    assign = torch.full(member_slots.shape, NO_ID, dtype=torch.int32, device=dev.device)
    for p0 in range(0, member_slots.shape[0], chunk):
        sl = member_slots[p0 : p0 + chunk]
        ok = sl >= 0
        x = _member_rows(dev, sl)
        dots = (x if metric.is_packed else distances.bf16_round(x)) @ cb.T
        if metric.name == "cosine":
            d = -dots / cn.clamp(min=float(distances._EPS))[None, :]
        else:
            d = c2[None, :] - 2.0 * dots
        a = torch.argmin(d, dim=-1)
        s, n = _one_hot_sums(x, a, ok, C)
        sums += s
        counts += n
        assign[p0 : p0 + chunk] = torch.where(ok, a.to(torch.int32), NO_ID)
    new_c = sums / counts.clamp(min=1.0)[:, None]
    return torch.where((counts > 0)[:, None], new_c, centroids), assign


def _maxmin_indices(geom: torch.Tensor, C: int) -> torch.Tensor:
    """Furthest-point selection of C rows of ``geom [S, D]`` → [C] int64:
    pick 0 is row 0, each next pick the row furthest (squared L2, on
    bf16-rounded rows) from every earlier pick. The picks stay on the
    device: no host sync per step."""
    geom = distances.bf16_round(geom)
    g2 = (geom * geom).sum(-1)
    idxs = torch.zeros(C, dtype=torch.int64, device=geom.device)
    min_d2 = torch.full((geom.shape[0],), INF, device=geom.device)
    for j in range(1, C):
        last = geom.index_select(0, idxs[j - 1 : j])[0]
        d2 = g2 - 2.0 * (geom @ last) + last @ last
        min_d2 = torch.minimum(min_d2, d2)
        idxs[j] = torch.argmax(min_d2)
    return idxs


def kmeans_partition(
    dev: DeviceGraph,
    member_slots: np.ndarray,  # [n] valid slot ids
    n_clusters: int,
    iters: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Cluster the member vectors on the device → assignment [n] (host).

    The centroids start as a furthest-point selection over ``INIT_SAMPLE``
    random members (cosine: over unit rows), which covers every
    well-separated component of the data before Lloyd refines (the JAX
    package's ``init="maxmin"``). Draws from ``rng`` as the JAX package does.
    """
    n = len(member_slots)
    metric = dev.metric
    slots_pad = torch.tensor(_pad_to(member_slots.astype(np.int32), KMEANS_CHUNK, NO_ID), device=dev.device)
    S = min(n, max(INIT_SAMPLE, 8 * n_clusters))
    sample = member_slots[rng.choice(n, size=S, replace=False)]
    sv = _member_rows(dev, torch.tensor(sample, dtype=torch.int64, device=dev.device))
    geom = sv
    if metric.name == "cosine":
        geom = sv / (sv * sv).sum(-1).sqrt().clamp(min=1e-30)[:, None]
    with span("bulk_maxmin", sample=S, clusters=n_clusters):
        centroids = sv[_maxmin_indices(geom, n_clusters)]
    del geom, sv
    assign = None
    for _ in range(max(1, iters)):
        centroids, assign = _kmeans_step(dev, slots_pad, centroids)
    return assign[:n].cpu().numpy()


def _segment_centroids(dev: DeviceGraph, member_slots: np.ndarray, assign: np.ndarray, n_clusters: int) -> torch.Tensor:
    """Mean vector of each cluster, in the partition's space
    (``_member_rows``) → f32 [C, D] (0 for an empty cluster)."""
    width = dev.vectors.shape[1] * (distances.codecs.LANE_BITS if dev.metric.is_packed else 1)
    sums = torch.zeros((n_clusters, width), dtype=torch.float32, device=dev.device)
    counts = torch.zeros(n_clusters, dtype=torch.float32, device=dev.device)
    slots = torch.tensor(member_slots, dtype=torch.int64, device=dev.device)
    a_all = torch.tensor(assign, dtype=torch.int64, device=dev.device)
    for p0 in range(0, len(member_slots), KMEANS_CHUNK):
        sl = slots[p0 : p0 + KMEANS_CHUNK]
        s, n = _one_hot_sums(_member_rows(dev, sl), a_all[p0 : p0 + KMEANS_CHUNK], sl >= 0, n_clusters)
        sums += s
        counts += n
    return sums / counts.clamp(min=1.0)[:, None]


# --------------------------------------------------------------------------
# Candidate generation
# --------------------------------------------------------------------------


def _brute_candidates(dev: DeviceGraph, member_slots: np.ndarray, K: int, chunk: int):
    """Exact kNN candidates among the members, self excluded → (ids, dists)
    [n_pad, K], aligned with member positions (n padded to ``chunk``)."""
    metric = dev.metric
    slots = torch.tensor(_pad_to(member_slots.astype(np.int32), chunk, NO_ID), device=dev.device)
    n_pad = slots.shape[0]
    mvec, mnrm = dev.vectors[_ix(slots)], dev.norms[_ix(slots)]
    col_ok = slots >= 0
    cols = torch.arange(n_pad, device=dev.device)
    # at most BRUTE_MAX packed members: popcounts from one product (exact)
    member_distances = distances.packed_matrix_mxu if metric.is_packed else distances.matrix_distances
    out_ids = torch.full((n_pad, K), NO_ID, dtype=torch.int32, device=dev.device)
    out_d = torch.full((n_pad, K), INF, device=dev.device)
    for p0 in range(0, n_pad, chunk):
        sl = slots[p0 : p0 + chunk]
        d = member_distances(metric, mvec[p0 : p0 + chunk], mnrm[p0 : p0 + chunk], mvec, mnrm)
        d = torch.where(col_ok[None, :], d, INF)
        d = torch.where(cols[None, :] == (p0 + torch.arange(sl.shape[0], device=d.device))[:, None], INF, d)
        cd, idx = topk.smallest_k(d, K)
        row_ok = (sl >= 0)[:, None]
        out_ids[p0 : p0 + chunk] = torch.where(row_ok & torch.isfinite(cd), slots[idx], NO_ID)
        out_d[p0 : p0 + chunk] = torch.where(row_ok, cd, INF)
    return out_ids, out_d


def _pseudo_cluster_tables(assign: np.ndarray, n_clusters: int, s_cap: int) -> tuple[np.ndarray, np.ndarray]:
    """Split clusters into pseudo-clusters of at most ``s_cap`` members
    (siblings share the parent's centroid, so they pick each other as
    adjacent) → (tab_pos [Cp, s_cap] member positions, -1 padded;
    parent [Cp] cluster of each pseudo-cluster)."""
    order = np.argsort(assign, kind="stable")
    sizes = np.bincount(assign, minlength=n_clusters)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    tab_rows: list[np.ndarray] = []
    parents: list[int] = []
    for c in range(n_clusters):
        members = order[starts[c] : starts[c] + sizes[c]]
        for off in range(0, max(len(members), 1), s_cap):
            chunk = members[off : off + s_cap]
            row = np.full(s_cap, -1, dtype=np.int64)
            row[: len(chunk)] = chunk
            tab_rows.append(row)
            parents.append(c)
    return np.stack(tab_rows), np.asarray(parents, dtype=np.int64)


def _cluster_adjacency(metric: distances.Metric, centroids: torch.Tensor, parent: np.ndarray, A: int) -> np.ndarray:
    """The A nearest pseudo-clusters of each pseudo-cluster, itself
    included → [Cp, A] (ties toward the lower index: siblings share a
    centroid). Packed centroids are bit-probability vectors, compared by
    the euclidean proxy that every packed metric is monotone in."""
    if metric.is_packed:
        metric = distances.EUCLIDEAN
    pc = centroids[torch.tensor(parent, dtype=torch.int64, device=centroids.device)]
    pn = _centroid_norms(metric, pc)
    d = distances.matrix_distances(metric, pc, pn, pc, pn)
    d = d + torch.arange(d.shape[1], dtype=torch.float32, device=d.device)[None, :] * 1e-9
    return topk.smallest_k(d, A)[1].cpu().numpy()


def _cluster_candidates(
    dev: DeviceGraph,
    tab_slots: np.ndarray,  # [Cp, S] member slots per pseudo-cluster (-1 pad), Cp % CAND_GROUP == 0
    tab_pos: np.ndarray,  # [Cp, S] member positions (-1 pad)
    adj: np.ndarray,  # [Cp, A] adjacent pseudo-clusters (-1 pad)
    n: int,  # members (rows of the candidate tables)
    K: int,
):
    """Top-K candidates of every member from its pseudo-cluster's
    adjacency block, ``CAND_GROUP`` pseudo-clusters per step (one batched
    [G, S, A·S] block), and the closest boundary pair of each
    (pseudo-cluster, alien adjacent cluster) → (ids [n, K], dists [n, K],
    x_src, x_dst, x_d [Cp·A])."""
    metric, device = dev.metric, dev.device
    tab_s = torch.tensor(tab_slots.astype(np.int32), device=device)
    tab_p = torch.tensor(tab_pos, dtype=torch.int64, device=device)
    adj_t = torch.tensor(adj, dtype=torch.int64, device=device)
    Cp, S = tab_s.shape
    A, G = adj_t.shape[1], CAND_GROUP
    out_ids = torch.full((n, K), NO_ID, dtype=torch.int32, device=device)
    out_d = torch.full((n, K), INF, device=device)
    x_src = torch.full((Cp, A), NO_ID, dtype=torch.int32, device=device)
    x_dst = torch.full((Cp, A), NO_ID, dtype=torch.int32, device=device)
    x_d = torch.full((Cp, A), INF, device=device)
    row_g = torch.arange(G, device=device).repeat_interleave(S)[:, None]
    for c0 in range(0, Cp, G):
        sl, pos, ac = tab_s[c0 : c0 + G], tab_p[c0 : c0 + G], adj_t[c0 : c0 + G]
        cols = torch.where((ac >= 0)[:, :, None], tab_s[ac.clamp(min=0)], NO_ID).reshape(G, A * S)
        d = distances.block_distances(
            metric, dev.vectors[_ix(sl)], dev.norms[_ix(sl)], dev.vectors[_ix(cols)], dev.norms[_ix(cols)]
        )
        d = torch.where((cols >= 0)[:, None, :] & (cols[:, None, :] != sl[:, :, None]) & (sl >= 0)[:, :, None], d, INF)
        cd, idx = topk.smallest_k(d.reshape(G * S, A * S), K)
        cids = torch.where(torch.isfinite(cd), cols[row_g, idx], NO_ID)
        keep = sl.reshape(-1) >= 0
        rows = pos.reshape(-1)[keep]
        out_ids[rows] = cids[keep]
        out_d[rows] = cd[keep]

        # boundary pairs: the closest pair of each [S, S] sub-block
        d4 = d.reshape(G, S, A, S).permute(0, 2, 1, 3).reshape(G, A, S * S)
        am = torch.argmin(d4, dim=-1)
        bd = d4.gather(2, am[:, :, None])[:, :, 0]
        bsrc = sl.gather(1, am // S)
        bdst = cols.reshape(G, A, S).gather(2, (am % S)[:, :, None])[:, :, 0]
        own = c0 + torch.arange(G, device=device)
        alien = (ac != own[:, None]) & (ac >= 0) & torch.isfinite(bd)
        x_src[c0 : c0 + G] = torch.where(alien, bsrc, NO_ID)
        x_dst[c0 : c0 + G] = torch.where(alien, bdst, NO_ID)
        x_d[c0 : c0 + G] = torch.where(alien, bd, INF)
    return out_ids, out_d, x_src.reshape(-1), x_dst.reshape(-1), x_d.reshape(-1)


def _random_candidates(dev: DeviceGraph, members: np.ndarray, rand_slots: np.ndarray) -> torch.Tensor:
    """Distances from each member to its R random members → [n, R] (INF
    for itself). These run through the gather-distance kernel."""
    metric, device = dev.metric, dev.device
    mem = torch.tensor(members.astype(np.int32), device=device)
    rs_all = torch.tensor(rand_slots.astype(np.int32), device=device)
    out = torch.empty(rs_all.shape, dtype=torch.float32, device=device)
    for p0 in range(0, len(members), RAND_CHUNK):
        sl, rs = mem[p0 : p0 + RAND_CHUNK], rs_all[p0 : p0 + RAND_CHUNK]
        d = beam_cuda.gathered_distances(metric, dev.vectors, dev.norms, dev.vectors[_ix(sl)], dev.norms[_ix(sl)], rs)
        out[p0 : p0 + RAND_CHUNK] = torch.where((rs >= 0) & (rs != sl[:, None]), d, INF)
    return out


def layer_candidates(dev: DeviceGraph, member_slots: np.ndarray, K: int, rng: np.random.Generator):
    """Candidate lists of the members → (ids [n_pad, K], dists [n_pad, K],
    cross_edges or None), aligned with member positions. ``cross_edges``
    = (src, dst, d) of the closest boundary pair per (cluster, adjacent
    cluster), from the k-means path only."""
    n = len(member_slots)
    K = min(K, n - 1)
    if n <= BRUTE_MAX:
        with span("bulk_candidates", n=n, brute=1):
            ids, d = _brute_candidates(dev, member_slots, K, chunk=min(4096, max(256, n)))
        return ids, d, None

    C = max(8, n // CLUSTER_SIZE)
    with span("bulk_kmeans", n=n, clusters=C):
        assign = kmeans_partition(dev, member_slots, C, KMEANS_ITERS, rng)
    s_cap = int(np.ceil(1.3 * n / C))
    tab_pos, parent = _pseudo_cluster_tables(assign, C, s_cap)
    Cp = tab_pos.shape[0]
    A = min(ADJ, Cp)
    pad_rows = (-Cp) % CAND_GROUP
    if pad_rows:
        tab_pos = np.concatenate([tab_pos, np.full((pad_rows, s_cap), -1, dtype=np.int64)])
        parent = np.concatenate([parent, np.zeros(pad_rows, dtype=np.int64)])
    tab_slots = np.where(tab_pos >= 0, member_slots[np.maximum(tab_pos, 0)], -1)
    with span("bulk_adjacency", clusters=C, pseudo_clusters=Cp, adj=A):
        # the true centroids of the final assignment
        centroids = _segment_centroids(dev, member_slots, assign, C)
        adj = _cluster_adjacency(dev.metric, centroids, parent, A)
        adj[Cp:] = -1  # padding rows select nothing
    with span("bulk_candidates", n=n, pseudo_clusters=Cp, s_cap=s_cap, adj=A):
        ids, d, x_src, x_dst, x_d = _cluster_candidates(dev, tab_slots, tab_pos, adj, n, K)
    return ids, d, (x_src, x_dst, x_d)


# --------------------------------------------------------------------------
# Connect: prune + forward + reverse + inbound, then forced cross links
# --------------------------------------------------------------------------


def _bulk_connect(
    dev: DeviceGraph,
    slots_pad: np.ndarray,  # [n_pad] (-1 padded to ``chunk``)
    cand_ids: torch.Tensor,  # [n_pad, K] position-aligned
    cand_d: torch.Tensor,
    dirty: torch.Tensor,
    counters: torch.Tensor,
    cap: int,
    alpha: float,
    chunk: int,
):
    """The three connect passes at layer 0. Pass 2 and 3 read the pass-1
    selections from explicit tables: a row that absorbed reverse edges
    does not re-emit them as its own selections."""
    member = torch.tensor(slots_pad, device=dev.device)
    n_pad = member.shape[0]
    fwd_ids = torch.full((n_pad, cap), NO_ID, dtype=torch.int32, device=dev.device)
    fwd_d = torch.full((n_pad, cap), INF, device=dev.device)
    with span("connect_pass1", n=n_pad, K=cand_ids.shape[1]):
        for p0 in range(0, n_pad, chunk):
            sl = member[p0 : p0 + chunk]
            ok = (sl >= 0)[:, None]
            sel_ids, sel_d = prune.robust_prune(
                dev.metric, dev.vectors, dev.norms,
                torch.where(ok, cand_ids[p0 : p0 + chunk], NO_ID), torch.where(ok, cand_d[p0 : p0 + chunk], INF),
                cap, alpha,
            )
            wave_ops._set_level_rows(dev, 0, sl, sel_ids, sel_d)
            fwd_ids[p0 : p0 + chunk] = sel_ids
            fwd_d[p0 : p0 + chunk] = sel_d
            counters[wave_ops.CNT_FWD_LINKS] += (sel_ids != NO_ID).sum()
    with span("connect_pass2", n=n_pad):
        dev, counters, u_dst = wave_ops.reverse_merge_edges_streamed(
            dev, 0, member, fwd_ids, fwd_d, counters, cap, alpha, inc_cap=cap
        )
        dirty[u_dst.long()] = True
        dirty[member[member >= 0].long()] = True
    with span("connect_pass3", n=n_pad):
        for p0 in range(0, n_pad, chunk):
            dev, dirty, counters = wave_ops._ensure_inbound(
                dev, member[p0 : p0 + chunk], fwd_ids[p0 : p0 + chunk], fwd_d[p0 : p0 + chunk], dirty, counters
            )
    return dev, dirty, counters


def _force_cross_links(
    g: DeviceGraph,
    src: torch.Tensor,  # [E] boundary sources (-1 padded)
    dst: torch.Tensor,  # [E]
    d: torch.Tensor,  # [E]
    dirty: torch.Tensor,
    counters: torch.Tensor,
):
    """Force the closest cross-cluster boundary pairs as layer-0 edges
    (both directions), displacing each row's worst links: at most
    ``FORCE_CAP`` per source row, ranked by (source, distance). A pure-kNN
    layer of clustered data falls apart into components; these edges keep
    it connected. Touched rows are re-sorted."""
    s2, t2, dd = torch.cat([src, dst]), torch.cat([dst, src]), torch.cat([d, d])
    ok = (s2 != NO_ID) & (t2 != NO_ID) & torch.isfinite(dd)
    present = (beam.links_at(g, 0, torch.where(ok, s2, NO_ID)) == t2[:, None]).any(-1)
    key = torch.where(ok & ~present, s2, wave_ops._KEY_LAST)

    # drop repeated (src, dst) pairs, then rank each source's edges by distance
    o = wave_ops._lexsort2(key, t2)
    ks, kt, kd = key[o], t2[o], dd[o]
    dup = torch.zeros_like(ok)
    dup[1:] = (ks[1:] == ks[:-1]) & (kt[1:] == kt[:-1])
    kt = torch.where(dup, NO_ID, kt)
    ks = torch.where(kt == NO_ID, wave_ops._KEY_LAST, ks)
    o = wave_ops._lexsort2(ks, kd)
    ks, kd, kt = ks[o], kd[o], kt[o]
    _, _, rank = wave_ops._segments(ks)
    keep = (ks != wave_ops._KEY_LAST) & (kt != NO_ID) & (rank < FORCE_CAP)

    rows, col = ks[keep].long(), g.links0.shape[-1] - 1 - rank[keep]
    g.links0[rows, col] = kt[keep]
    g.dists0[rows, col] = kd[keep]
    # re-sort the touched rows; a row listed twice gets the same values twice
    touched = torch.where(keep, ks, NO_ID)
    t_d, t_ids = topk.sort_by_dist(g.dists0[_ix(touched)], g.links0[_ix(touched)])
    wave_ops._scatter_rows(g.links0, touched, t_ids)
    wave_ops._scatter_rows(g.dists0, touched, t_d)
    dirty[rows] = True
    counters[wave_ops.CNT_FWD_LINKS] += keep.sum()
    return g, dirty, counters


def bulk_build(
    g_host,
    dev: DeviceGraph,
    slots: np.ndarray,
    lvls: np.ndarray,
    opts,
    dirty: torch.Tensor,
    counters: torch.Tensor,
    connect_mask: Optional[np.ndarray] = None,
) -> tuple[DeviceGraph, torch.Tensor, torch.Tensor]:
    """Build layer 0 of a fresh index from candidate lists.

    Every item takes part in the clustering and as a candidate column.
    ``connect_mask`` (bool, aligned with ``slots``): when set, only its
    True rows get forward rows, reverse merges and the inbound repair —
    the backbone mode, where the level >= 1 items were already inserted at
    layer 0 by insertion waves, with the long edges that overwriting their
    rows would destroy. Reverse merges still extend backbone rows.
    """
    rng = np.random.default_rng(opts.seed + 0x6B)
    K = max(opts.ef_construction, g_host.m0 + 16)
    alpha = BULK_ALPHA if opts.alpha == 1.0 else opts.alpha
    members = slots.astype(np.int64)
    n = len(members)
    if not n:
        return dev, dirty, counters
    cand_ids, cand_d, cross = layer_candidates(dev, members, K, rng)
    if n > 4 * K:
        # NSW-style long-edge candidates; the α-prune keeps the uncovered ones
        rand_slots = members[rng.integers(0, n, size=(n, RAND_CANDIDATES))].astype(np.int32)
        with span("bulk_random_candidates", n=n, r=RAND_CANDIDATES):
            rd = _random_candidates(dev, members, rand_slots)
        cand_ids = torch.cat([cand_ids[:n], torch.tensor(rand_slots, device=dev.device)], dim=1)
        cand_d, cand_ids = topk.sort_by_dist(torch.cat([cand_d[:n], rd], dim=1), cand_ids)
    members_c = members
    if connect_mask is not None:
        pos = np.nonzero(connect_mask)[0]
        if not len(pos):
            return dev, dirty, counters
        members_c = members[pos]
        sel = torch.tensor(pos, dtype=torch.int64, device=dev.device)
        cand_ids, cand_d = cand_ids[sel], cand_d[sel]
    chunk = min(CONNECT_CHUNK, max(256, len(members_c)))
    slots_pad = _pad_to(members_c.astype(np.int32), chunk, NO_ID)
    cand_ids = _fit_rows(cand_ids, len(slots_pad), NO_ID)
    cand_d = _fit_rows(cand_d, len(slots_pad), INF)
    dev, dirty, counters = _bulk_connect(
        dev, slots_pad, cand_ids, cand_d, dirty, counters, cap=g_host.m0, alpha=alpha, chunk=chunk
    )
    if cross is not None:
        with span("bulk_cross_links", pairs=int(cross[0].shape[0])):
            dev, dirty, counters = _force_cross_links(dev, *cross, dirty, counters)
    return dev, dirty, counters
