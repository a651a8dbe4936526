"""Wave-parallel HNSW construction — host orchestration.

Counterpart of ``hannoy_tpu/build/builder.py``: the host samples levels,
resolves entry points, composes level-descending waves, and drives the
device steps in ``wave_ops.py`` and, for large fresh builds, the bulk
connect in ``bulk.py``; all distance work runs on the device given to
``build_graph``.

Deleted slots are repaired after the waves (``_repair_deletions``, the
reference's fill_gaps_from_deleted) and then cleared. Every metric and
storage tier builds (``build_graph(tier=)``), and every ``BuildOptions``
field of the JAX package is read, with its default.

``BuildOptions.cancel`` is checked before every wave, in every beam's
loop (``beam._while_loop``), before every repair block and re-check
round, and between the bulk path's steps and chunks (``cancel_probe``);
once it returns True the build raises ``BuildCancelled``. The JAX package
switches a cancellable build to a chunked construction beam and a
chunked connect; the port keeps one algorithm, so a cancel that never
fires gives the same graph as none.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..errors import BuildCancelled
from ..models import hnsw
from ..models.hnsw import DeviceGraph, HostGraph
from ..ops import beam
from ..utils.progress import BuildStep, InsertItemsStep, NoProgress
from ..utils.stats import BuildStats
from ..utils.tracing import span
from . import bulk, wave_ops
from .levels import sample_levels

#: brute-force candidate search while the indexed graph is this small
FLAT_BOOTSTRAP = 1024
#: default wave width (items inserted per device step)
DEFAULT_WAVE = 256
#: rows repaired per device step in the deletion pass
REPAIR_BLOCK = 512
#: wave sizes snap to these buckets (the JAX package's, kept so both
#: packages insert the same items in the same waves)
_WAVE_BUCKETS = (16, 128, 1024, 4096)
#: a layer-0 wave seeds the next (chain seeding) only when it carried at
#: least this many real items
_CHAIN_MIN_PREV = 1024
#: insertion rank of "never a candidate" columns (later groups, table
#: padding) in a triangular candidate mask
_ORDER_INF = np.int32(2**30)


def _ramp_width(W: int, n_active: int, divisor: int = 4) -> int:
    """Wave-size ramp, snapped to the buckets.

    A beam-based wave is blind to its own members, so beam waves are
    capped at 1/``divisor`` of the active graph. Inside the flat bootstrap
    candidates are exact, so the ramp there is ~the active count itself.
    """
    if n_active <= FLAT_BOOTSTRAP:
        w_i = min(W, max(16, n_active))
    else:
        w_i = min(W, max(16, n_active // divisor))
    w_pad = 16
    for b in _WAVE_BUCKETS:
        if b <= w_i:
            w_pad = b
    return min(w_pad, W)


def _never_cancel() -> bool:
    """Default cancel closure: the build is never cancelled."""
    return False


def cancel_probe(cancel: Callable[[], bool]) -> Callable[[], bool]:
    """A build's check of its ``cancel`` closure: raises ``BuildCancelled``
    once the closure returns True, else returns False (so it also serves
    as a loop's ``cancel``, ``beam._while_loop``)."""

    def probe() -> bool:
        if cancel():
            raise BuildCancelled()
        return False

    return probe


@dataclasses.dataclass
class BuildOptions:
    """Runtime build configuration (reference ``BuildOption``,
    writer.rs:34-58): the JAX package's fields, with its defaults."""

    ef_construction: int = 100
    alpha: float = 1.0
    cancel: Callable[[], bool] = _never_cancel
    progress: object = dataclasses.field(default_factory=NoProgress)
    wave_size: int = DEFAULT_WAVE
    seed: int = 42
    #: extra layer-0 link columns during the build: incoming reverse edges
    #: accumulate in the slack by distance and a row is α-pruned only when
    #: the slack overflows, plus one prune of every overfull row at the end
    #: of the build (``wave_ops.prune_slack_rows``) — the DiskANN batched
    #: build's deferral of the reference's prune-on-overflow
    #: (hnsw.rs:523-560), which slack 0 reproduces exactly
    link_slack: int = 0
    #: pool entries expanded per construction-beam iteration (the
    #: reference pops one per hop). E > 1 gathers E rows' links per
    #: iteration and divides the iteration budget by E
    beam_expand: int = 1
    #: construction-beam iteration budget (None → (ef + 16) / beam_expand,
    #: rounded up)
    beam_iters: Optional[int] = None
    #: chain seeding: layer-0 waves after a wave of at least 1024 items seed
    #: each item's beam from its nearest member of the previous wave and that
    #: member's freshly pruned row (one [W, W_prev] distance product in
    #: place of the descent, ``wave_ops.proto_seed_rows``) and run the
    #: smaller ``refine_iters`` budget. Not for packed metrics or manhattan
    chain_seeding: bool = False
    #: refine-beam iteration budget of chain-seeded items
    #: (None → max(16, (ef_construction + 16) // 2))
    refine_iters: Optional[int] = None
    #: layer-0 construction beams stop once at most this fraction of a
    #: wave (of >= 1024 real items) is still expanding; stragglers keep
    #: their pooled candidates. 0.0 = the reference's termination
    beam_tail_frac: float = 0.05
    #: construction beams expand only each row's nearest ``traverse`` links
    #: (rows are distance-sorted; None = the full row, the reference's
    #: behaviour): rank-truncated expansion
    traverse: Optional[int] = None
    #: routing layers with at most this many members take exact
    #: candidates against a compact member table (one [W, U] product)
    #: instead of beams. 0 disables
    upper_flat_max: int = 65536
    #: candidate-pool width for those exact routing-layer candidates
    #: (min'd with the member count): wider than ef_construction, so that
    #: the α-prune finds the ring diversity a beam's trajectory gives
    upper_flat_pool: int = 384
    # ---- bulk (cluster-blocked) fresh-build path — see build/bulk.py ----
    #: None = auto (fresh builds of >= bulk_threshold items, every metric
    #: but f32 manhattan); True forces it for any eligible fresh build; False disables
    bulk: Optional[bool] = None
    bulk_threshold: int = 8192
    #: candidate-list length per item (None → max(ef_construction, m0 + 16))
    bulk_k: Optional[int] = None
    #: α of the bulk prune (None → 1.1 where ``alpha`` is 1.0, else
    #: ``alpha``): kNN-only candidate lists lack the long edges of an
    #: insertion-order build, and a mildly diverse prune restores them
    bulk_alpha: Optional[float] = None
    #: k-means target cluster size / Lloyd iterations / adjacent clusters
    #: each candidate block spans
    bulk_cluster_size: int = 512
    bulk_kmeans_iters: int = 3
    bulk_adj: int = 8
    #: centroid init: "maxmin" (furthest-point over a member sample, which
    #: gives every well-separated component of the data a centroid before
    #: Lloyd refines) or "random" (random members)
    bulk_init: str = "maxmin"
    bulk_init_sample: int = 131072
    #: random long-edge candidates per item (NSW wiring — the α-prune
    #: keeps the uncovered ones; 0 disables)
    bulk_rand: int = 8
    #: renumber slots into cluster-locality order at the end of a bulk build
    #: whose layer 0 took k-means candidates, so that a search hop's
    #: neighbour rows lie close in device memory. The store is keyed by
    #: item id, so the bytes on disk do not change
    bulk_renumber: bool = False
    #: wave-ramp divisor of the routing-layer waves of a bulk build without
    #: a backbone (1 = each wave as wide as the active graph)
    upper_ramp_divisor: int = 1
    #: highest layer the bulk path builds (None = 0: only layer 0); the
    #: layers above go through insertion waves first
    bulk_upper: Optional[int] = None
    #: flat backbone: the backbone's candidates come from exact triangular
    #: kNN against its compact member tables (one [W, U] product per
    #: full-width wave; item i sees the members inserted before it)
    #: instead of ramped beam waves. None = auto (on while the backbone
    #: fits ``backbone_flat_max``); False forces the beam backbone
    backbone_flat: Optional[bool] = None
    #: backbone member bound for the flat path (a [W, U] matrix per wave)
    backbone_flat_max: int = 131072
    #: candidate-pool width of the flat backbone at layer 0 (min'd with
    #: the members; the α-prune gathers [W, pool, D])
    backbone_flat_pool: int = 192
    #: navigability backbone: every level >= 1 item is inserted by waves
    #: all the way to layer 0 before the bulk connect of the level-0 items,
    #: laying down the long edges a pure-kNN layer lacks. None = auto (on
    #: where the bulk path builds layer 0 only); False runs the routing
    #: layers alone by waves and builds all of layer 0 in bulk
    bulk_backbone: Optional[bool] = None


def prepare_entry_points(
    g: HostGraph,
    insert_slots: np.ndarray,
    insert_levels: np.ndarray,
    deleted_slots: set[int],
) -> tuple[np.ndarray, np.ndarray]:
    """Resolve entry points before a (maybe incremental) build.

    Mirrors hnsw.rs:222-289. Mutates ``g.entry_slots``/``g.max_level`` and
    returns the final (slots, levels) insertion schedule — old entry points
    are appended for re-indexing at the (old) max level.
    """
    old_eps = list(dict.fromkeys(g.entry_slots))
    new_eps = [e for e in old_eps if e not in deleted_slots]
    del_eps = [e for e in old_eps if e in deleted_slots]

    if not old_eps and not deleted_slots:
        # fresh-build fast path: sort by descending level, stable;
        # top-level items become entry points
        order = np.argsort(-insert_levels, kind="stable")
        slots = insert_slots[order].astype(np.int64)
        lvls = insert_levels[order].astype(np.int32)
        cur_max = int(lvls[0]) if len(lvls) else 0
        g.max_level = max(g.max_level, cur_max)
        g.entry_slots = [int(s) for s in slots[lvls == g.max_level]]
        return slots, lvls

    # Replace deleted entry points with surviving nodes from top layers
    # (hnsw.rs:242-257: scan layer links top-down for a non-deleted node).
    if del_eps:
        l = g.max_level
        for _ in del_eps:
            while True:
                members = _layer_members(g, l)
                found = False
                for s in members:
                    if s not in deleted_slots and s not in new_eps:
                        new_eps.append(int(s))
                        found = True
                        break
                if found or l == 0:
                    break
                l -= 1

    # Case 1: whole previous graph deleted → reset height (hnsw.rs:261-263)
    if del_eps and len(new_eps) != len(old_eps):
        g.max_level = 0

    # Schedule surviving old eps for re-indexing at the old max level
    # (hnsw.rs:267-268) so old and new graphs stay connected.
    sched = {int(s): int(lv) for s, lv in zip(insert_slots, insert_levels)}
    for e in new_eps:
        sched[int(e)] = max(sched.get(int(e), 0), g.max_level)

    cur_max = int(insert_levels.max()) if len(insert_levels) else 0

    # Case 2: new build reaches higher levels → new hnsw entry points
    # (hnsw.rs:272-276).
    if cur_max > g.max_level:
        new_eps = []
        g.max_level = cur_max

    slots = np.asarray(sorted(sched, key=lambda s: -sched[s]), dtype=np.int64)
    lvls = np.asarray([sched[int(s)] for s in slots], dtype=np.int32)

    # Top-layer items become entry points, pre-added to all layers below
    # (hnsw.rs:278-287).
    for s, lv in zip(slots, lvls):
        if lv == g.max_level and int(s) not in new_eps:
            new_eps.append(int(s))

    g.entry_slots = new_eps
    return slots, lvls


def _layer_members(g: HostGraph, level: int) -> np.ndarray:
    if level == 0:
        return np.nonzero(g.levels >= 0)[0]
    if level - 1 >= len(g.slot_rows):
        return np.empty(0, dtype=np.int64)
    return np.nonzero(g.slot_rows[level - 1] >= 0)[0]


def plan_build(
    g: HostGraph,
    insert_slots: np.ndarray,
    deleted_slots: np.ndarray,
    opts: BuildOptions,
    stats: BuildStats,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host prologue: sample levels, resolve entry points, allocate upper
    rows, and derive the two device masks. Returns (slots, lvls, active,
    exists_ok) — ``active`` is the initial searchable mask; ``exists_ok``
    additionally admits the items being inserted."""
    rng = np.random.default_rng(opts.seed)
    deleted_set = {int(s) for s in deleted_slots}
    insert_levels = sample_levels(rng, g.m, len(insert_slots))

    opts.progress.update(BuildStep.RESOLVE_GRAPH_ENTRY_POINTS)
    with span("prepare_entry_points", inserts=len(insert_slots), deletes=len(deleted_set)):
        slots, lvls = prepare_entry_points(g, insert_slots, insert_levels, deleted_set)

    # Allocate upper-layer rows up front (device tables are static per build)
    g.ensure_layers(g.max_level)
    g.levels[slots] = np.maximum(g.levels[slots], lvls.astype(g.levels.dtype))
    for s, lv in zip(slots[lvls >= 1], lvls[lvls >= 1]):
        for level in range(1, lv + 1):
            g.upper_row(level, int(s))

    for lv in np.unique(lvls):
        stats.layer_dist[int(lv)] = stats.layer_dist.get(int(lv), 0) + int((lvls == lv).sum())

    active = (g.levels >= 0).copy()
    active[slots] = False
    for s in deleted_set:
        active[s] = False
    exists_ok = (g.levels >= 0).copy()
    for s_ in deleted_set:
        exists_ok[s_] = False
    return slots, lvls, active, exists_ok


def _padded_table(members: np.ndarray) -> np.ndarray:
    """A compact member table, -1 padded to a power of two (>= 16)."""
    tab = np.full(1 << max(4, int(len(members) - 1).bit_length()), -1, dtype=np.int32)
    tab[: len(members)] = members
    return tab


def _order_table(tab: np.ndarray, slot_order: np.ndarray) -> np.ndarray:
    """The insertion rank of each column of a member table (``_ORDER_INF``
    on padding) → int32: a triangular candidate mask's column orders."""
    return np.where(tab >= 0, slot_order[np.maximum(tab, 0)], _ORDER_INF).astype(np.int32)


def build_graph(
    g: HostGraph,
    insert_slots: np.ndarray,
    deleted_slots: np.ndarray,
    opts: BuildOptions,
    stats: Optional[BuildStats] = None,
    *,
    device,
    tier: str = "raw",
) -> BuildStats:
    """Run a build of the staged items on ``device``.

    Large fresh builds of every metric but f32 manhattan take the bulk
    path (``bulk.eligible``): by default the level >= 1 items are inserted
    first by waves (the navigability backbone), then ``bulk.bulk_build``
    connects the level-0 items. With ``bulk_backbone=False`` or
    ``bulk_upper`` the layers above the bulk-built ones are inserted by
    waves alone (``bulk_upper_tri`` / ``bulk_upper_wave`` spans), and the
    bulk path builds the rest for every item. Every other build inserts
    all items by waves.

    ``tier``: the storage tier the build's device rows are held in
    (``hnsw.to_device``); the graph is then built on the distances its
    readers will see.

    Preconditions: vectors/norms for ``insert_slots`` are staged in ``g``;
    ``deleted_slots`` rows still carry their old links (the reference
    deletes links *after* the build so the repair can splice through
    them, writer.rs:577-580). Raises ``BuildCancelled`` once
    ``opts.cancel`` fires (``g`` is then half-built: the caller drops it).
    """
    probe = cancel_probe(opts.cancel)
    stats = stats or BuildStats()
    device = torch.device(device)
    deleted_set = {int(s) for s in deleted_slots}

    with span("build_plan"):
        slots, lvls, active, exists_ok = plan_build(g, insert_slots, deleted_slots, opts, stats)

    slack = opts.link_slack
    with span("build_upload"):
        dev = hnsw.to_device(g, device, tier=tier, link_slack=slack)
        dev.valid = torch.tensor(active, device=device)
        # beam traversal may seed/visit anything that exists
        node_ok = torch.tensor(exists_ok, device=device)

    # ---- insertion waves, level-descending (hnsw.rs:160-185) ----
    opts.progress.update(BuildStep.BUILDING_THE_GRAPH)
    total = len(slots)
    done = 0
    n_active = int(active.sum())
    dirty = torch.zeros((g.capacity,), dtype=torch.bool, device=device)
    counters = torch.zeros((4,), dtype=torch.int32, device=device)

    # compact member tables for exact routing-layer candidates
    flat_tabs_np: dict[int, np.ndarray] = {}
    for level in range(1, g.max_level + 1):
        mem = _layer_members(g, level)
        if 0 < len(mem) <= opts.upper_flat_max:
            flat_tabs_np[level] = _padded_table(mem)
    flat_tabs = {level: torch.tensor(tab, device=device) for level, tab in flat_tabs_np.items()}

    use_bulk = bulk.eligible(g.metric, n_active, len(deleted_set), len(slots), opts)
    bulk_top = 0
    backbone_on = False
    if use_bulk:
        if opts.bulk_upper is not None:
            bulk_top = min(opts.bulk_upper, int(lvls.max(initial=0)))
        # the navigability backbone: the level >= 1 items go through the
        # wave loop below all the way to layer 0, laying down the long edges
        # a pure-kNN layer lacks; the bulk path then connects the leaves
        backbone_on = opts.bulk_backbone is not False and bulk_top == 0 and bool((lvls > 0).any())
        if not backbone_on:
            dev, dirty, counters = _upper_only_waves(
                g, dev, slots, lvls, active, bulk_top, opts, node_ok, dirty, counters, flat_tabs, flat_tabs_np,
                stats, probe,
            )
    if not use_bulk:
        groups = [(lv, slots[lvls == lv]) for lv in sorted({int(x) for x in lvls}, reverse=True)]
    elif backbone_on:
        groups = [(lv, slots[lvls == lv]) for lv in sorted({int(x) for x in lvls[lvls > 0]}, reverse=True)]
    else:
        groups = []
    # the backbone is a fresh sub-build: let its ramp reach the widest bucket
    W_groups = max(opts.wave_size, _WAVE_BUCKETS[-1]) if backbone_on else opts.wave_size

    # ---- flat backbone: exact triangular candidates, full-width waves ----
    # Column j of a member table is a candidate for backbone item i iff j
    # comes before i in the backbone's insertion sequence (groups, level
    # descending), so a wave needs no ramp and no beam.
    flat_orders = None
    bb_tab0 = None
    bb_all = np.concatenate([grp for _, grp in groups]) if backbone_on else np.empty(0, np.int64)
    if backbone_on and opts.backbone_flat is not False and 0 < len(bb_all) <= opts.backbone_flat_max:
        slot_order = np.full(g.capacity, _ORDER_INF, dtype=np.int32)
        slot_order[active] = -1  # already-active slots: always visible
        slot_order[bb_all] = np.arange(len(bb_all), dtype=np.int32)
        # every level >= 1 with at most backbone_flat_max members gets a
        # table: the first full-width wave has no other candidate source
        for level in range(1, g.max_level + 1):
            mem = _layer_members(g, level)
            if level not in flat_tabs_np and 0 < len(mem) <= opts.backbone_flat_max:
                flat_tabs_np[level] = _padded_table(mem)
                flat_tabs[level] = torch.tensor(flat_tabs_np[level], device=device)
        bb_tab0 = _padded_table(bb_all)
        flat_orders = {level: torch.tensor(_order_table(tab, slot_order), device=device)
                       for level, tab in flat_tabs_np.items()}
        flat_orders[0] = torch.tensor(_order_table(bb_tab0, slot_order), device=device)
        bb_tab0 = torch.tensor(bb_tab0, device=device)

    # already-inserted slots, tracked only inside the flat bootstrap
    active_ids = np.nonzero(active)[0].astype(np.int64)
    bb_base = 0  # insertion rank of the group's first item in the backbone

    for lv, grp in groups:
        start = 0
        prev_wave = None  # the group's last layer-0 wave of >= _CHAIN_MIN_PREV items
        while start < len(grp):
            probe()
            if bb_tab0 is not None:
                # triangular visibility needs no ramp: full-width waves
                w_pad = min(_WAVE_BUCKETS[-1], 1 << max(4, int(len(grp) - start - 1).bit_length()))
            else:
                w_pad = _ramp_width(W_groups, n_active)
            chunk = grp[start : start + w_pad]
            wave = np.full(w_pad, -1, dtype=np.int32)
            wave[: len(chunk)] = chunk
            wave_t = torch.from_numpy(wave).to(device)
            # chain seeding: after a large layer-0 wave, each item seeds from
            # its nearest previous-wave member and that member's fresh row,
            # and refines with a smaller beam budget
            seeds = beam_iters = None
            if (
                lv == 0 and opts.chain_seeding and bb_tab0 is None and prev_wave is not None
                and n_active > FLAT_BOOTSTRAP and not g.metric.is_packed and g.metric.name != "manhattan"
            ):
                seeds = wave_ops.proto_seed_rows(dev, wave_t, prev_wave)
                beam_iters = opts.refine_iters or max(16, (opts.ef_construction + 16) // 2)
            flat0 = None
            if bb_tab0 is not None:
                flat0 = bb_tab0
            elif n_active <= FLAT_BOOTSTRAP:
                tab0 = np.full(FLAT_BOOTSTRAP, -1, dtype=np.int32)
                tab0[: len(active_ids)] = active_ids[:FLAT_BOOTSTRAP]
                flat0 = torch.from_numpy(tab0).to(device)
            with span("insert_wave", level=lv, width=w_pad, active=n_active, chained=int(seeds is not None),
                      flat=int(bb_tab0 is not None)):
                dev, dirty, counters = _insert_wave(
                    dev, wave_t, lv, opts, n_active, node_ok, dirty, counters, g.m0,
                    seeds=seeds, beam_iters=beam_iters, n_real=len(chunk), flat_tabs=flat_tabs, flat0=flat0,
                    flat_orders=flat_orders, flat_row_base=bb_base + start, flat0_force=bb_tab0 is not None,
                    cancel=probe,
                )
            start += len(chunk)
            wave_ops.activate_wave(dev, wave_t)
            if lv == 0 and len(chunk) >= _CHAIN_MIN_PREV:
                prev_wave = wave_t
            if len(active_ids) <= FLAT_BOOTSTRAP:
                # kept ascending so flat-candidate ties break as in a full scan
                active_ids = np.sort(np.concatenate([active_ids, chunk.astype(np.int64)]))
            n_active += len(chunk)
            done += len(chunk)
            stats.waves += 1
            opts.progress.update(InsertItemsStep(done, total))
        bb_base += len(grp)

    # ---- bulk cluster-blocked connect (after any backbone waves) ----
    order0 = None
    if use_bulk:
        # every item goes live: the connect reads rows of any member
        dev.valid = torch.tensor(exists_ok, device=device)
        with span("bulk_build", inserts=len(slots), max_level=g.max_level):
            dev, dirty, counters, order0 = bulk.bulk_build(
                g, dev, slots, lvls, opts, dirty, counters, top_level=bulk_top,
                connect_mask=(lvls == 0) if backbone_on else None, probe=probe,
            )
        stats.waves += 1
        opts.progress.update(InsertItemsStep(total, total))

    # ---- slack rows back to m0 (α-prune over each row's whole set) ----
    if slack:
        with span("prune_slack_rows"):
            dev, dirty = wave_ops.prune_slack_rows(dev, dirty, cap=g.m0, alpha=opts.alpha)

    # ---- deletion repair (fill_gaps_from_deleted, hnsw.rs:334-415) ----
    if deleted_set:
        opts.progress.update(BuildStep.PATCH_OLD_NEW_DELETED_LINKS)
        deleted_t = torch.tensor(sorted(deleted_set), dtype=torch.int32, device=device)
        with span("repair_deletions", deleted=len(deleted_set)):
            dev = _repair_deletions(dev, deleted_t, g.m0, g.m, opts, dirty)
        wave_ops.clear_slots(dev, deleted_t)

    # ---- end-of-build stranding re-check ----
    if len(slots) or deleted_set:
        with span("inbound_recheck"):
            dev, dirty, counters, waves = inbound_recheck(dev, g.m0, node_ok, dirty, counters, opts, probe)
        stats.waves += waves

    # ---- cluster-locality renumbering (bulk builds) ----
    # The link tables are permuted on the device, the host permutes only
    # what it alone holds; the store is keyed by item id, so no persisted
    # byte changes. bulk.eligible admits fresh builds only: no deleted
    # slot to remap.
    if use_bulk and opts.bulk_renumber and order0 is not None:
        with span("bulk_renumber"):
            front = slots[order0]
            perm = np.empty(g.capacity, dtype=np.int64)
            perm[: len(front)] = front
            rest = np.ones(g.capacity, dtype=bool)
            rest[front] = False
            perm[len(front) :] = np.nonzero(rest)[0]
            inv = np.empty_like(perm)
            inv[perm] = np.arange(g.capacity, dtype=np.int64)
            perm_t = torch.from_numpy(perm).to(device)
            dev = hnsw.permute_device(dev, perm_t, torch.from_numpy(inv).to(device))
            dirty = dirty[perm_t]
            g.permute_host_only(perm, inv)

    # ---- sync back to host ----
    with span("sync_to_host"):
        hnsw.from_device(g, dev)
        if deleted_set:  # deleted rows are dropped from the store, not flushed
            dirty[deleted_t.long()] = False
        dirty_np, counters_np = dirty.cpu().numpy(), counters.cpu().numpy()
    stats.links_added += int(counters_np[wave_ops.CNT_FWD_LINKS] + counters_np[wave_ops.CNT_REV_DELTA])
    stats.beam_iters += int(counters_np[wave_ops.CNT_BEAM_ITERS])
    stats.store_gathers += int(counters_np[wave_ops.CNT_ROW_GATHERS]) * wave_ops.GATHER_GRANULE
    stats.touched = np.nonzero(dirty_np)[0].astype(np.int64)
    return stats


def inbound_recheck(
    dev: DeviceGraph,
    m0: int,
    node_ok: torch.Tensor,
    dirty: torch.Tensor,
    counters: torch.Tensor,
    opts: BuildOptions,
    probe: Callable[[], bool],
):
    """The end-of-build stranding re-check, in place: rows with no forward
    links are re-inserted with exact candidates over the whole live graph,
    and rows with in-degree 0 get one forced inbound edge, repeated until
    clean (12 rounds at most). Degrees count the first ``m0`` columns:
    readers never see slack ones. → (dev, dirty, counters, waves run)"""
    device = dev.device
    waves = 0
    for _round in range(12):
        probe()
        indeg_dev, outdeg_dev = wave_ops.layer0_degrees(dev, cap=m0)
        indeg, outdeg = indeg_dev.cpu().numpy(), outdeg_dev.cpu().numpy()
        valid_np = dev.valid.cpu().numpy()
        if int(valid_np.sum()) <= 1:
            break
        empty = np.nonzero(valid_np & (outdeg == 0))[0]
        if len(empty):
            rows_t = torch.from_numpy(empty.astype(np.int32)).to(device)
            seeds = dev.entry_slots[None, :].expand(len(empty), -1)
            dev, _, dirty, counters = wave_ops.wave_insert_level(
                dev, rows_t, seeds, node_ok, 0, dirty, counters,
                ef=opts.ef_construction, cap=m0, alpha=opts.alpha, flat=True,
            )
            waves += 1
            continue
        stranded = np.nonzero(valid_np & (indeg == 0))[0]
        if len(stranded) == 0:
            break
        dev, dirty, counters = wave_ops.force_inbound_for(
            dev, torch.from_numpy(stranded.astype(np.int32)).to(device), indeg_dev,
            dirty, counters, shift=_round % 4, write_cap=m0,
        )
    return dev, dirty, counters, waves


def _upper_only_waves(
    g: HostGraph,
    dev: DeviceGraph,
    slots: np.ndarray,
    lvls: np.ndarray,
    active: np.ndarray,
    bulk_top: int,
    opts: BuildOptions,
    node_ok: torch.Tensor,
    dirty: torch.Tensor,
    counters: torch.Tensor,
    flat_tabs: dict,
    flat_tabs_np: dict,
    stats: BuildStats,
    probe: Callable[[], bool],
):
    """The layers above ``bulk_top`` of a bulk build without a backbone,
    by insertion waves that stop at layer ``bulk_top + 1`` (the bulk path
    builds the rest), one level group after another.

    A group whose every layer down to ``bulk_top + 1`` has a compact member
    table goes in full-width waves with triangular candidates (column j
    visible to wave row i iff j comes before i in the group; active members
    always), spans ``bulk_upper_tri``; the others in waves ramped by
    ``upper_ramp_divisor`` over the routing layers' active count, spans
    ``bulk_upper_wave``."""
    device = dev.device
    n_up_active = 0
    active_now = active.copy()
    for lv in sorted({int(x) for x in lvls[lvls > bulk_top]}, reverse=True):
        grp = slots[lvls == lv]
        if all(level in flat_tabs for level in range(lv, bulk_top, -1)):
            w_pad = min(_WAVE_BUCKETS[-1], 1 << max(4, int(len(grp) - 1).bit_length()))
            slot_order = np.full(g.capacity, _ORDER_INF, dtype=np.int32)
            slot_order[active_now] = -1
            slot_order[grp] = np.arange(len(grp), dtype=np.int32)
            orders = {level: torch.tensor(_order_table(flat_tabs_np[level], slot_order), device=device)
                      for level in range(lv, bulk_top, -1)}
        else:
            orders = None
        start = 0
        while start < len(grp):
            probe()
            if orders is None:
                w_pad = _ramp_width(opts.wave_size, n_up_active, divisor=opts.upper_ramp_divisor)
            chunk = grp[start : start + w_pad]
            wave = np.full(w_pad, -1, dtype=np.int32)
            wave[: len(chunk)] = chunk
            wave_t = torch.from_numpy(wave).to(device)
            name = "bulk_upper_wave" if orders is None else "bulk_upper_tri"
            with span(name, level=lv, width=w_pad, base=start):
                dev, dirty, counters = _insert_wave(
                    dev, wave_t, lv, opts, n_up_active, node_ok, dirty, counters, g.m0,
                    n_real=len(chunk), stop_level=bulk_top + 1, flat_tabs=flat_tabs,
                    flat_orders=orders, flat_row_base=start, cancel=probe,
                )
            wave_ops.activate_wave(dev, wave_t)
            start += len(chunk)
            n_up_active += len(chunk)
            stats.waves += 1
        active_now[grp] = True
    return dev, dirty, counters


def _repair_deletions(
    dev: DeviceGraph,
    deleted: torch.Tensor,  # [D] int32 deleted slots
    m0: int,
    m: int,
    opts: BuildOptions,
    dirty: torch.Tensor,
) -> DeviceGraph:
    """Repair every row that links a deleted slot, in blocks of
    ``REPAIR_BLOCK`` owners (``wave_ops.repair_deleted_rows``), and mark
    the repaired owners dirty. ``opts.cancel`` is checked before every
    block.

    Every stored layer is scanned, not only 0..max_level: a height reset
    (``prepare_entry_points``' case 1) can leave survivors' rows above the
    new max level, and those must lose their deleted ids too (the
    reference resizes its layer list to every on-disk row for this,
    hnsw.rs:346-357). The owners are found on the device, in the order of
    the JAX package's host scan (ascending table row); owners that are
    themselves deleted are skipped (hnsw.rs:373-375)."""
    probe = cancel_probe(opts.cancel)
    del_mask = torch.zeros(dev.capacity, dtype=torch.bool, device=dev.device)
    del_mask[deleted.long()] = True
    for level in range(dev.upper_links.shape[0] + 1):
        if level == 0:
            table = dev.links0
            owners = torch.arange(dev.capacity, device=dev.device)
        else:
            table = dev.upper_links[level - 1]
            rows = dev.slot_rows[level - 1]
            owner_slots = torch.nonzero(rows >= 0)[:, 0]
            owners = torch.full((table.shape[0],), -1, dtype=torch.int64, device=dev.device)
            owners[rows[owner_slots].long()] = owner_slots
        has_del = ((table >= 0) & del_mask[table.clamp(min=0).long()]).any(-1)
        affected = owners[torch.nonzero(has_del)[:, 0]]
        affected = affected[affected >= 0]
        affected = affected[~del_mask[affected]].to(torch.int32)
        dirty[affected.long()] = True
        n_aff = int(affected.shape[0])
        n_blocks = -(-n_aff // REPAIR_BLOCK)
        with span("repair_level", level=level, owners=n_aff, blocks=n_blocks):
            for start in range(0, n_aff, REPAIR_BLOCK):
                probe()
                block = torch.full((REPAIR_BLOCK,), -1, dtype=torch.int32, device=dev.device)
                chunk = affected[start : start + REPAIR_BLOCK]
                block[: chunk.shape[0]] = chunk
                wave_ops.repair_deleted_rows(
                    dev, block, del_mask, level, cap=m0 if level == 0 else m, alpha=opts.alpha
                )
    return dev


def _insert_wave(
    dev: DeviceGraph,
    wave_t: torch.Tensor,
    lv: int,
    opts: BuildOptions,
    n_active: int,
    node_ok: torch.Tensor,
    dirty: torch.Tensor,
    counters: torch.Tensor,
    m0: int,
    seeds: Optional[torch.Tensor] = None,
    beam_iters: Optional[int] = None,
    n_real: Optional[int] = None,
    stop_level: int = 0,
    flat_tabs: Optional[dict] = None,
    flat0: Optional[torch.Tensor] = None,
    flat_orders: Optional[dict] = None,
    flat_row_base: int = 0,
    flat0_force: bool = False,
    cancel: beam.Cancel = None,
):
    """Insert one wave at levels ``lv..stop_level``: greedy descent to
    lv+1, then per-level candidates + prune + connect, chaining each
    level's pruned set as the next level's seeds (hnsw.rs:291-328).

    ``seeds`` / ``beam_iters`` replace the descent and the beams'
    iteration budget (chain seeding passes both). ``flat_tabs`` maps
    routing levels to compact member tables; ``flat0`` is the level-0
    bootstrap table. ``flat_orders`` maps levels to the insertion rank of
    each table column and ``flat_row_base`` is the rank of wave row 0:
    candidates are then triangular. ``flat0_force`` (the flat backbone):
    ``flat0`` is the backbone's level-0 table, used whatever the active
    count. ``cancel`` goes to the descent's and the beams' loops."""
    # the flat backbone runs full-width waves from a cold start: the
    # bootstrap's full-table scan is off, levels without a table take beams
    use_flat = n_active <= FLAT_BOOTSTRAP and not flat0_force

    def _fm(level: int):
        """Compact member table for exact candidates at ``level``."""
        if level == 0:
            return flat0 if (use_flat or flat0_force) else None
        return flat_tabs.get(level) if flat_tabs is not None else None

    top = min(lv, dev.max_level)
    # the greedy descent only seeds beam searches
    needs_beam = not use_flat and any(_fm(level) is None for level in range(top, stop_level - 1, -1))
    if seeds is None:
        if dev.max_level > lv and needs_beam:
            # A level-0 item's layer-0 beam is seeded as a search's is: on a
            # large clustered index the greedy walk ends in another cluster's
            # basin for some items, which then link only to far candidates
            # and cannot be found again. (Items of higher levels run an
            # ef_construction-wide beam at their own top layer already.)
            ef_upper = beam.default_ef_upper(n_active, opts.ef_construction) if lv == 0 else 1
            with span("insert_seeds", level=lv, ef_upper=ef_upper):
                seeds = beam.descend_for_slots(
                    dev, wave_t, dev.max_level, lv + 1, node_ok=node_ok, ef_upper=ef_upper, cancel=cancel
                )
        else:
            seeds = dev.entry_slots[None, :].expand(wave_t.shape[0], -1)
    if beam_iters is None:
        beam_iters = opts.beam_iters
    # Tail termination only on wide waves, sized from the REAL item count
    # snapped down to the wave buckets (padding rows converge together)
    if n_real is None:
        n_real = int((wave_t >= 0).sum())
    tail = opts.beam_tail_frac if n_real >= 1024 else 0.0
    tail_base = max((b for b in _WAVE_BUCKETS if b <= n_real), default=0)

    for level in range(top, stop_level - 1, -1):
        fm = _fm(level)
        if fm is not None and level > 0:
            ef = max(opts.ef_construction, opts.upper_flat_pool)
        elif level == 0 and flat0_force:
            # a wider exact pool keeps ring diversity, bounded: the prune
            # gathers [W, pool, D]
            ef = max(opts.ef_construction, opts.backbone_flat_pool)
        else:
            ef = opts.ef_construction
        dev, selected, dirty, counters = wave_ops.wave_insert_level(
            dev, wave_t, seeds, node_ok, level, dirty, counters,
            ef=ef,
            # logical widths: the layer-0 table may be slack-widened
            cap=m0 if level == 0 else dev.upper_links.shape[-1],
            alpha=opts.alpha,
            flat=use_flat and fm is None,
            expand=opts.beam_expand,
            beam_iters=beam_iters,
            beam_tail_allow=int(tail * tail_base),
            traverse=opts.traverse,
            flat_members=fm,
            flat_col_order=flat_orders.get(level) if flat_orders is not None else None,
            flat_row_base=flat_row_base,
            cancel=cancel,
        )
        seeds = selected
    return dev, dirty, counters
