"""Sharded index: one sub-HNSW per shard, fan-out search, lockstep build.

Counterpart of ``hannoy_tpu/parallel/sharded.py``. Items are partitioned
round-robin across S shards; each shard is an *independent* sub-HNSW with
no cross-shard edges, so construction needs no traffic between shards and
a query is: every shard searches its own graph → its top-k, mapped to
global ids → all S·k pairs on ``devices[0]`` → the global top-k.

The JAX package stacks the shards on a leading axis and runs each step as
one ``shard_map`` program over its mesh. Here one process drives a list
of devices (``mesh.make_mesh``): shard ``s`` is its own ``DeviceGraph`` on
``devices[s]``, and each step runs shard by shard. What the stacking
decides is kept: every shard's graph has the deepest shard's height
(``pad_to_common_shapes``, ``max_level``), which sets where each shard's
descent starts, and the merge keeps the lower position among equal
distances (shard order), as ``lax.top_k`` does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..models.hnsw import INVALID_ID, DeviceGraph, HostGraph, from_device, to_device
from ..models.flat import flat_topk
from ..ops import beam, codecs, distances, topk
from ..ops.topk import INF, NO_ID
from ..utils.tracing import span
from .mesh import make_mesh, replicated

#: ``INVALID_ID`` as the global ids are held on a device (int64)
_INVALID = int(INVALID_ID)


class ShardedIndex:
    """S per-shard graphs, shard ``s`` on ``devices[s]``. Static metadata
    (metric, ``max_level``, m0) matches across shards: the builders pad
    every shard to the same capacity and height."""

    def __init__(
        self,
        devices: Sequence[torch.device],
        graphs: list[DeviceGraph],
        ids: list[torch.Tensor],
        metric_name: str,
        max_level: int,
    ):
        self.devices = list(devices)
        self.graphs = graphs
        self.ids = ids  # per shard [N_pad] int64 global item ids per slot (INVALID_ID: free)
        self.metric_name = metric_name
        self.max_level = max_level

    @property
    def n_shards(self) -> int:
        return len(self.graphs)

    @classmethod
    def from_host_graphs(
        cls,
        graphs: list[HostGraph],
        devices: Sequence,
        serve_only: bool = False,
        tier: str = "raw",
        link_slack: int = 0,
    ) -> "ShardedIndex":
        """Upload per-shard host graphs (equal capacity, see
        ``pad_to_common_shapes``), shard ``s`` to ``devices[s]``. Each graph
        descends from the deepest shard's height, as in the JAX package's
        stacked layout (a shallower shard's missing layers are empty, and
        the descent falls through them). ``serve_only`` / ``tier`` /
        ``link_slack``: see ``models.hnsw.to_device``."""
        devices = make_mesh(devices)
        if len(devices) != len(graphs):
            raise ValueError(f"{len(graphs)} shards for {len(devices)} devices")
        max_level = max(g.max_level for g in graphs)
        devs = []
        for g, d in zip(graphs, devices):
            dev = to_device(g, d, serve_only=serve_only, tier=tier, link_slack=link_slack)
            dev.max_level = max_level
            devs.append(dev)
        ids = [torch.from_numpy(g.ids.astype(np.int64)).to(d) for g, d in zip(graphs, devices)]
        return cls(devices, devs, ids, graphs[0].metric.name, max_level)

    def search(self, queries: np.ndarray, k: int, ef: int) -> tuple[np.ndarray, np.ndarray]:
        """Fan-out search → (global item ids [B, k] uint32, dists [B, k]).

        Runs the degraded-search completion of the single-device path
        (reference reader.rs:771-795): query rows whose merged beam results
        came back short are answered again by one exact sharded scan,
        which replaces the row."""
        metric = distances.by_name(self.metric_name)
        packed = codecs.pack(np.atleast_2d(np.asarray(queries, np.float32)), metric.codec)
        norms = distances.np_norms(metric, packed)
        qs = replicated(self.devices, distances.as_lanes(packed) if metric.is_packed else packed)
        qns = replicated(self.devices, norms)
        counts = [int((ids != _INVALID).sum()) for ids in self.ids]
        ids, d = _sharded_search(self, qs, qns, k, ef, beam.default_ef_upper(max(counts), ef))
        want = min(k, sum(counts))
        deficient = np.nonzero((ids != INVALID_ID).sum(axis=1) < want)[0]
        if len(deficient):
            sel = torch.from_numpy(deficient)
            f_ids, f_d = _sharded_flat(self, [q[sel.to(q.device)] for q in qs], [n[sel.to(n.device)] for n in qns], k)
            ids[deficient] = f_ids
            d[deficient] = f_d
        return ids, d


def _merge(index: ShardedIndex, parts: list[tuple[torch.Tensor, torch.Tensor]], k: int):
    """Per-shard (dists [B, k], global ids [B, k]) → the top k of the S·k
    pairs on ``devices[0]`` → host (ids uint32, dists f32). Positions run
    shard-major, and among equal distances the lower one wins (the JAX
    package's ``lax.top_k`` over the all-gathered pairs)."""
    home = index.devices[0]
    flat_d = torch.cat([d.to(home) for d, _ in parts], dim=1)
    flat_i = torch.cat([i.to(home) for _, i in parts], dim=1)
    top_d, pos = topk.smallest_k(flat_d, k)
    top_i = flat_i.gather(1, pos)
    return top_i.cpu().numpy().astype(np.uint32), top_d.cpu().numpy()


def _sharded_search(index: ShardedIndex, qs, qns, k: int, ef: int, ef_upper: int):
    """Every shard's ``hnsw_search``, its top-k mapped to global ids
    (invalid slots at INF / ``INVALID_ID``), then ``_merge``."""
    parts = []
    for g, ids, q, qn in zip(index.graphs, index.ids, qs, qns):
        res = beam.hnsw_search(g, q, qn, ef, ef_upper=ef_upper)
        slots = res.slots[:, :k]
        ok = slots >= 0
        parts.append((torch.where(ok, res.dists[:, :k], INF), torch.where(ok, ids[slots.clamp(min=0).long()], _INVALID)))
    return _merge(index, parts, k)


def _sharded_flat(index: ShardedIndex, qs, qns, k: int):
    """Exact sharded top-k: each shard's flat scan over its live slots,
    then ``_merge`` — the distributed brute-force search
    (reader.rs:668-711) and the completion of degraded sharded beams."""
    parts = []
    for g, ids, q, qn in zip(index.graphs, index.ids, qs, qns):
        d, slots = flat_topk(index.metric_name, q, qn, g.vectors, g.norms, g.valid, k)
        if d.shape[1] < k:  # fewer slots than k
            pad = k - d.shape[1]
            d = torch.nn.functional.pad(d, (0, pad), value=INF)
            slots = torch.nn.functional.pad(slots, (0, pad), value=-1)
        parts.append((d, torch.where(slots >= 0, ids[slots.clamp(min=0).long()], _INVALID)))
    return _merge(index, parts, k)


# --------------------------------------------------------------------------
# Sharded construction
# --------------------------------------------------------------------------


def partition_round_robin(n: int, n_shards: int) -> list[np.ndarray]:
    """Deterministic round-robin item partition."""
    return [np.arange(s, n, n_shards) for s in range(n_shards)]


def pad_to_common_shapes(graphs: list[HostGraph]) -> None:
    """Equalise capacities and layer counts so that every shard has the
    same slots and heights (in place: a later ``Reader`` of the same graph
    sees more free slots and empty layers, which it does not read)."""
    cap = max(g.capacity for g in graphs)
    max_level = max(g.max_level for g in graphs)
    for g in graphs:
        g.grow(cap)
        if g.capacity < cap:  # grow() snaps to buckets; force exact match
            raise AssertionError("slot_capacity must align across shards")
        # per-shard max_level stays untouched (single-index semantics);
        # shallower shards get empty upper tables, which the descent falls
        # through harmlessly
        g.ensure_layers(max_level)
    # upper tables: equal row counts per level
    for l in range(max_level):
        rows = max((g.upper_links[l].shape[0] if l < len(g.upper_links) else 1) for g in graphs)
        for g in graphs:
            cur = g.upper_links[l].shape[0]
            if cur < rows:
                pad = rows - cur
                g.upper_links[l] = np.concatenate([g.upper_links[l], np.full((pad, g.m), -1, dtype=np.int32)])
                g.upper_dists[l] = np.concatenate([g.upper_dists[l], np.full((pad, g.m), np.inf, dtype=np.float32)])


def build_sharded(
    metric: distances.Metric,
    data: np.ndarray,  # [N, D] float32
    item_ids: np.ndarray,
    m: int,
    m0: int,
    n_shards: int,
    opts=None,
    *,
    devices: Sequence,
) -> ShardedIndex:
    """Build S independent per-shard sub-HNSWs in memory by lockstep waves.

    The multi-device form of the reference's one parallel-build mechanism
    (rayon insertion, hnsw.rs:168-185): wave i of every shard, each on its
    own device, before wave i+1; the host composes the per-shard schedules
    (``builder.plan_build``) and every candidate search, prune and link
    runs on the shards' devices. ``opts.cancel`` is checked between
    lockstep waves and inside their loops; ``opts.link_slack`` widens every
    shard's layer-0 table for the waves (``prune_slack_shards`` after
    them). The waves read no other option but ``ef_construction``,
    ``alpha`` and ``wave_size``, as in the JAX package. With slack, every
    shard then runs the single-device builder's stranding re-check
    (``recheck_shards``), which the JAX package's sharded builds lack."""
    from ..build import builder as _builder
    from ..models.hnsw import slot_capacity
    from ..utils.stats import BuildStats

    opts = opts or _builder.BuildOptions()
    n = data.shape[0]
    parts = partition_round_robin(n, n_shards)
    cap = slot_capacity(max(len(p) for p in parts))

    # ---- stage per-shard host graphs + host build plans ----
    graphs: list[HostGraph] = []
    plans = []
    for part in parts:
        g = HostGraph.empty(metric, data.shape[1], m, m0, capacity=cap)
        packed = codecs.pack(data[part], metric.codec)
        nrm = distances.np_norms(metric, packed)
        slots = np.empty(len(part), dtype=np.int64)
        for i, row in enumerate(part):
            s = g.alloc_slot(int(item_ids[row]))
            slots[i] = s
            g.vectors[s] = packed[i]
            g.norms[s] = nrm[i]
        plans.append(_builder.plan_build(g, slots, np.empty(0, dtype=np.int64), opts, BuildStats()))
        graphs.append(g)
    pad_to_common_shapes(graphs)

    index = ShardedIndex.from_host_graphs(graphs, devices, link_slack=opts.link_slack)
    node_ok = []
    for dev, (_, _, active, exists_ok) in zip(index.graphs, plans):
        dev.valid = torch.from_numpy(active).to(dev.device)
        node_ok.append(torch.from_numpy(exists_ok).to(dev.device))
    lockstep_waves(index, [(p[0], p[1]) for p in plans], [int(p[2].sum()) for p in plans], node_ok, None, opts, m0)
    if opts.link_slack:
        prune_slack_shards(index, None, m0, opts.alpha)
        recheck_shards(index, node_ok, None, m0, opts, [True] * n_shards)

    for g, dev in zip(graphs, index.graphs):
        from_device(g, dev)
    return ShardedIndex.from_host_graphs(graphs, index.devices)


def lockstep_waves(
    index: ShardedIndex,
    schedules: list[tuple[np.ndarray, np.ndarray]],  # per shard (slots, levels)
    n_active: list[int],
    node_ok: list[torch.Tensor],
    dirty: Optional[list[torch.Tensor]],
    opts,
    m0: int,
) -> int:
    """Level-descending insertion waves, in lockstep: at each step every
    shard inserts its next chunk of the level's group (its ``wave`` row,
    -1 padded) before any shard starts the next step. The width is the
    single-device ramp gated on the slowest shard (a wave is blind to its
    own members), and while that shard has at most ``FLAT_BOOTSTRAP``
    items every candidate search is exact. ``m0``: the logical layer-0
    width (the tables may be slack-widened). → the number of lockstep
    waves."""
    from ..build import builder as _builder

    probe = _builder.cancel_probe(opts.cancel)
    S = index.n_shards
    n_active = list(n_active)
    sched = [{int(lv): slots[lvls == lv] for lv in np.unique(lvls)} for slots, lvls in schedules]
    W = opts.wave_size
    waves = 0
    for lv in range(index.max_level, -1, -1):
        grps = [s.get(lv, np.empty(0, dtype=np.int64)) for s in sched]
        offs = [0] * S
        while any(offs[s] < len(grps[s]) for s in range(S)):
            probe()
            w_i = min(W, max(16, min(n_active) // 4))
            w_pad = 16
            for b in _builder._WAVE_BUCKETS:
                if b <= w_i:
                    w_pad = b
            w_pad = min(w_pad, W)
            use_flat = min(n_active) <= _builder.FLAT_BOOTSTRAP
            wave = np.full((S, w_pad), -1, dtype=np.int32)
            before = list(n_active)
            for s in range(S):
                chunk = grps[s][offs[s] : offs[s] + w_pad]
                wave[s, : len(chunk)] = chunk
                offs[s] += len(chunk)
                n_active[s] += len(chunk)
            with span("spmd_wave", level=lv, width=w_pad, shards=S):
                _insert_wave_on_shards(
                    index, wave, node_ok, dirty, lv, opts.ef_construction, m0, opts.alpha, use_flat, before, probe
                )
            waves += 1
    return waves


def _insert_wave_on_shards(
    index: ShardedIndex,
    wave_slots: np.ndarray,  # [S, W]
    node_ok: list[torch.Tensor],
    dirty: Optional[list[torch.Tensor]],
    lv: int,
    ef: int,
    cap: int,
    alpha: float,
    flat: bool,
    n_active: list[int],
    cancel: beam.Cancel = None,
) -> None:
    """One wave on every shard, in place: each shard descends to the
    wave's level, then runs the per-level beam → α-prune → link chain of
    ``builder._insert_wave`` on its own graph, and activates the wave.

    Two departures from the JAX package's SPMD wave (ROADMAP.md §3). A
    level-0 wave into a shard of ``n_active`` >= 16,384 items is seeded as
    a search is (``beam.default_ef_upper``), as the port's single-device
    builder seeds it; smaller shards take the greedy descent. And a row
    whose pruned set comes back empty — an item alone at its level, such
    as a replaced entry point re-inserted at the top — seeds the next
    level with this level's seeds: the JAX package seeds it with the empty
    set, so the item loses every link below and the rest of the graph
    becomes unreachable from the entry point. Exact (flat) waves read no
    seeds, so the small builds of the tests are the JAX package's."""
    from ..build import wave_ops

    for s, g in enumerate(index.graphs):
        w = torch.from_numpy(wave_slots[s]).to(g.device)
        counters = torch.zeros((4,), dtype=torch.int32, device=g.device)
        d = dirty[s] if dirty is not None else torch.zeros((g.capacity,), dtype=torch.bool, device=g.device)
        if g.max_level > lv and not flat:
            ef_upper = beam.default_ef_upper(n_active[s], ef) if lv == 0 else 1
            seeds = beam.descend_for_slots(g, w, g.max_level, lv + 1, node_ok=node_ok[s], ef_upper=ef_upper,
                                           cancel=cancel)
        else:
            seeds = g.entry_slots[None, :].expand(w.shape[0], -1)
        for level in range(min(lv, g.max_level), -1, -1):
            level_cap = cap if level == 0 else g.upper_links.shape[-1]
            res = wave_ops.wave_insert_level(
                g, w, seeds, node_ok[s], level, d, counters, ef=ef, cap=level_cap, alpha=alpha, flat=flat,
                cancel=cancel,
            )
            handed = torch.full_like(res.selected, NO_ID)
            width = min(seeds.shape[1], handed.shape[1])
            handed[:, :width] = seeds[:, :width]
            seeds = torch.where((res.selected >= 0).any(-1, keepdim=True), res.selected, handed)
        wave_ops.activate_wave(g, w)


def prune_slack_shards(index: ShardedIndex, dirty: Optional[list[torch.Tensor]], cap: int, alpha: float) -> None:
    """The end of a lockstep build with link slack: every shard's layer-0
    rows back to ``cap`` on its own device (``wave_ops.prune_slack_rows``;
    the pruned rows are marked in ``dirty`` where it is given)."""
    from ..build import wave_ops

    for s, g in enumerate(index.graphs):
        d = dirty[s] if dirty is not None else torch.zeros((g.capacity,), dtype=torch.bool, device=g.device)
        wave_ops.prune_slack_rows(g, d, cap=cap, alpha=alpha)


def recheck_shards(
    index: ShardedIndex,
    node_ok: list[torch.Tensor],
    dirty: Optional[list[torch.Tensor]],
    m0: int,
    opts,
    built: list[bool],
) -> list[int]:
    """The end of a lockstep build with link slack: the single-device
    builder's stranding re-check (``builder.inbound_recheck``) on every
    shard that ``built``, on its own device. The slack prune α-prunes the
    rows that overflowed M0 with no regard for the edges ``_ensure_inbound``
    forced into them, so it can take an item's only in-edge; the JAX
    package's sharded builds then leave the item unreachable. (Without
    slack the per-wave guarantee, bounded as it is, is all both packages'
    lockstep builds give; ROADMAP.md §3.) → re-check waves per shard."""
    from ..build import builder as _builder

    probe = _builder.cancel_probe(opts.cancel)
    waves = []
    for s, g in enumerate(index.graphs):
        if not built[s]:
            waves.append(0)
            continue
        d = dirty[s] if dirty is not None else torch.zeros((g.capacity,), dtype=torch.bool, device=g.device)
        counters = torch.zeros((4,), dtype=torch.int32, device=g.device)
        with span("inbound_recheck", shard=s):
            waves.append(_builder.inbound_recheck(g, m0, node_ok[s], d, counters, opts, probe)[3])
    return waves


def sharded_insert_wave(
    index: ShardedIndex,
    wave_slots: np.ndarray,  # [S, W] per-shard wave (-1 padded)
    ef: int,
    cap: int,
    alpha: float = 1.0,
    node_ok: Optional[list[torch.Tensor]] = None,  # per shard [N_pad]
    lv: int = 0,
    flat: bool = False,
) -> ShardedIndex:
    """One construction wave across every shard — the multi-device build
    step: each shard descends to the wave's level, then runs the
    per-level beam → α-prune → link chain on its own graph. The shards'
    graphs are updated in place; the index is returned (the JAX package
    donates its arrays and returns a new index)."""
    wave_slots = np.asarray(wave_slots, dtype=np.int32)
    if node_ok is None:
        node_ok = []
        for s, g in enumerate(index.graphs):
            ok = g.valid.clone()
            w = wave_slots[s]
            ok[torch.from_numpy(w[w >= 0].astype(np.int64)).to(g.device)] = True
            node_ok.append(ok)
    n_active = [int(g.valid.sum()) for g in index.graphs]
    _insert_wave_on_shards(index, wave_slots, node_ok, None, lv, ef, cap, alpha, flat, n_active)
    return index
