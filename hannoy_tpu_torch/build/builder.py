"""Wave-parallel HNSW construction — host orchestration.

Counterpart of ``hannoy_tpu/build/builder.py``: the host samples levels,
resolves entry points, composes level-descending waves, and drives the
device steps in ``wave_ops.py`` and, for large fresh builds, the bulk
connect in ``bulk.py``; all distance work runs on the device given to
``build_graph``.

Deleted slots are repaired after the waves (``_repair_deletions``, the
reference's fill_gaps_from_deleted) and then cleared. Options outside the
ported paths raise ``NotImplementedError`` rather than being substituted
(see ``_check_supported``): link slack, chain seeding, ``beam_expand > 1``
and ``traverse`` (knobs that default to off). Every metric and storage
tier builds (``build_graph(tier=)``). The bulk path runs with the JAX
package's default knobs, kept as constants here and in ``bulk.py``.

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
#: insertion rank of "never a candidate" columns (table padding) in the
#: flat backbone's triangular candidate mask
_ORDER_INF = np.int32(2**30)
#: the bulk build's backbone takes exact triangular candidates against
#: compact member tables while it has at most this many members (a
#: [W, members] product per wave); above it, ramped beam waves
BACKBONE_FLAT_MAX = 131072
#: candidate-pool width of the flat backbone at layer 0 (the α-prune
#: gathers [W, pool, D])
BACKBONE_FLAT_POOL = 192


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
    """Runtime build configuration (reference ``BuildOption``): the JAX
    package's options that the wave path reads, with its defaults."""

    ef_construction: int = 100
    alpha: float = 1.0
    cancel: Callable[[], bool] = _never_cancel
    progress: object = dataclasses.field(default_factory=NoProgress)
    wave_size: int = DEFAULT_WAVE
    seed: int = 42
    #: extra layer-0 link columns during the build (not ported: must be 0)
    link_slack: int = 0
    #: pool entries expanded per construction-beam iteration (must be 1)
    beam_expand: int = 1
    #: construction-beam iteration budget (None → ef_construction + 16)
    beam_iters: Optional[int] = None
    #: prototype seeding of layer-0 waves (not ported: must be False)
    chain_seeding: bool = False
    #: layer-0 construction beams stop once at most this fraction of a
    #: wave (of >= 1024 real items) is still expanding
    beam_tail_frac: float = 0.05
    #: expand only each row's nearest ``traverse`` links (must be None)
    traverse: Optional[int] = None
    #: routing layers with at most this many members take exact
    #: candidates against a compact member table instead of beams
    upper_flat_max: int = 65536
    #: candidate-pool width for those exact routing-layer candidates
    upper_flat_pool: int = 384
    # ---- bulk (cluster-blocked) fresh-build path — see build/bulk.py ----
    #: None = auto (fresh builds of >= bulk_threshold items, every metric
    #: but f32 manhattan); True forces it for any eligible fresh build; False disables
    bulk: Optional[bool] = None
    bulk_threshold: int = 8192


def _check_supported(opts: BuildOptions) -> None:
    """Raise ``NotImplementedError`` for anything this port does not build
    (every metric and storage tier is built, with or without deletions,
    cancellable or not)."""
    for name, value, default in (
        ("link_slack", opts.link_slack, 0),
        ("chain_seeding", opts.chain_seeding, False),
        ("beam_expand", opts.beam_expand, 1),
        ("traverse", opts.traverse, None),
    ):
        if value != default:
            raise NotImplementedError(f"BuildOptions.{name}={value!r} is not ported yet (ROADMAP.md queue 1)")


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
    path (``bulk.eligible``): the level >= 1 items are inserted first by
    waves (the navigability backbone), then ``bulk.bulk_build`` connects
    the level-0 items. Every other build inserts all items by waves.

    ``tier``: the storage tier the build's device rows are held in
    (``hnsw.to_device``); the graph is then built on the distances its
    readers will see.

    Preconditions: vectors/norms for ``insert_slots`` are staged in ``g``;
    ``deleted_slots`` rows still carry their old links (the reference
    deletes links *after* the build so the repair can splice through
    them, writer.rs:577-580). Raises ``NotImplementedError`` for what the
    port does not build, and ``BuildCancelled`` once ``opts.cancel`` fires
    (``g`` is then half-built: the caller drops it).
    """
    _check_supported(opts)
    probe = cancel_probe(opts.cancel)
    stats = stats or BuildStats()
    device = torch.device(device)
    deleted_set = {int(s) for s in deleted_slots}

    slots, lvls, active, exists_ok = plan_build(g, insert_slots, deleted_slots, opts, stats)

    dev = hnsw.to_device(g, device, tier=tier)
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

    # the bulk path builds layer 0 of every level-0 item; the level >= 1
    # items (the navigability backbone) go through the waves below first,
    # all the way to layer 0, laying down the long edges a pure-kNN layer
    # lacks
    use_bulk = bulk.eligible(g.metric, n_active, len(deleted_set), len(slots), opts)
    backbone_on = use_bulk and bool((lvls > 0).any())
    if use_bulk:
        groups = [(lv, slots[lvls == lv]) for lv in sorted({int(x) for x in lvls[lvls > 0]}, reverse=True)]
    else:
        groups = [(lv, slots[lvls == lv]) for lv in sorted({int(x) for x in lvls}, reverse=True)]
    # the backbone is a fresh sub-build: let its ramp reach the widest bucket
    W_groups = max(opts.wave_size, _WAVE_BUCKETS[-1]) if backbone_on else opts.wave_size

    # ---- flat backbone: exact triangular candidates, full-width waves ----
    # Column j of a member table is a candidate for backbone item i iff j
    # comes before i in the backbone's insertion sequence (groups, level
    # descending), so a wave needs no ramp and no beam.
    flat_orders = None
    bb_all = np.concatenate([grp for _, grp in groups]) if backbone_on else np.empty(0, np.int64)
    if backbone_on and len(bb_all) <= BACKBONE_FLAT_MAX:
        slot_order = np.full(g.capacity, _ORDER_INF, dtype=np.int32)
        slot_order[active] = -1  # already-active slots: always visible
        slot_order[bb_all] = np.arange(len(bb_all), dtype=np.int32)
        # every level >= 1 with at most BACKBONE_FLAT_MAX members gets a
        # table: the first full-width wave has no other candidate source
        for level in range(1, g.max_level + 1):
            mem = _layer_members(g, level)
            if level not in flat_tabs_np and 0 < len(mem) <= BACKBONE_FLAT_MAX:
                flat_tabs_np[level] = _padded_table(mem)
        flat_tabs_np[0] = _padded_table(bb_all)
        flat_orders = {
            level: torch.tensor(np.where(tab >= 0, slot_order[np.maximum(tab, 0)], _ORDER_INF), device=device)
            for level, tab in flat_tabs_np.items()
        }
    flat_tabs = {level: torch.tensor(tab, device=device) for level, tab in flat_tabs_np.items() if level > 0}
    bb_tab0 = torch.tensor(flat_tabs_np[0], device=device) if flat_orders is not None else None

    # already-inserted slots, tracked only inside the flat bootstrap
    active_ids = np.nonzero(active)[0].astype(np.int64)
    bb_base = 0  # insertion rank of the group's first item in the backbone

    for lv, grp in groups:
        start = 0
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
            flat0 = None
            if bb_tab0 is not None:
                flat0 = bb_tab0
            elif n_active <= FLAT_BOOTSTRAP:
                tab0 = np.full(FLAT_BOOTSTRAP, -1, dtype=np.int32)
                tab0[: len(active_ids)] = active_ids[:FLAT_BOOTSTRAP]
                flat0 = torch.from_numpy(tab0).to(device)
            with span("insert_wave", level=lv, width=w_pad, active=n_active):
                dev, dirty, counters = _insert_wave(
                    dev, wave, lv, opts, n_active, node_ok, dirty, counters, g.m0,
                    n_real=len(chunk), flat_tabs=flat_tabs, flat0=flat0,
                    flat_orders=flat_orders, flat_row_base=bb_base + start, cancel=probe,
                )
            start += len(chunk)
            wave_ops.activate_wave(dev, torch.from_numpy(wave).to(device))
            if len(active_ids) <= FLAT_BOOTSTRAP:
                # kept ascending so flat-candidate ties break as in a full scan
                active_ids = np.sort(np.concatenate([active_ids, chunk.astype(np.int64)]))
            n_active += len(chunk)
            done += len(chunk)
            stats.waves += 1
            opts.progress.update(InsertItemsStep(done, total))
        bb_base += len(grp)

    # ---- bulk cluster-blocked connect of the level-0 items ----
    if use_bulk:
        # every item goes live: the connect reads rows of any member
        dev.valid = torch.tensor(exists_ok, device=device)
        with span("bulk_build", inserts=len(slots), max_level=g.max_level):
            dev, dirty, counters = bulk.bulk_build(
                g, dev, slots, lvls, opts, dirty, counters,
                connect_mask=(lvls == 0) if backbone_on else None, probe=probe,
            )
        stats.waves += 1
        opts.progress.update(InsertItemsStep(total, total))

    # ---- deletion repair (fill_gaps_from_deleted, hnsw.rs:334-415) ----
    if deleted_set:
        opts.progress.update(BuildStep.PATCH_OLD_NEW_DELETED_LINKS)
        deleted_t = torch.tensor(sorted(deleted_set), dtype=torch.int32, device=device)
        with span("repair_deletions", deleted=len(deleted_set)):
            dev = _repair_deletions(dev, deleted_t, g.m0, g.m, opts, dirty)
        wave_ops.clear_slots(dev, deleted_t)

    # ---- end-of-build stranding re-check ----
    # Rows with no forward links are re-inserted with exact candidates over
    # the whole live graph; rows with in-degree 0 get one forced inbound
    # edge; repeated until clean (capped).
    if len(slots) or deleted_set:
        with span("inbound_recheck"):
            for _round in range(12):
                probe()
                indeg_dev, outdeg_dev = wave_ops.layer0_degrees(dev, cap=g.m0)
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
                        ef=opts.ef_construction, cap=g.m0, alpha=opts.alpha, flat=True,
                    )
                    stats.waves += 1
                    continue
                stranded = np.nonzero(valid_np & (indeg == 0))[0]
                if len(stranded) == 0:
                    break
                dev, dirty, counters = wave_ops.force_inbound_for(
                    dev, torch.from_numpy(stranded.astype(np.int32)).to(device), indeg_dev,
                    dirty, counters, shift=_round % 4, write_cap=g.m0,
                )

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
    wave: np.ndarray,
    lv: int,
    opts: BuildOptions,
    n_active: int,
    node_ok: torch.Tensor,
    dirty: torch.Tensor,
    counters: torch.Tensor,
    m0: int,
    n_real: Optional[int] = None,
    flat_tabs: Optional[dict] = None,
    flat0: Optional[torch.Tensor] = None,
    flat_orders: Optional[dict] = None,
    flat_row_base: int = 0,
    cancel: beam.Cancel = None,
):
    """Insert one wave: greedy descent to lv+1, then per-level candidates
    + prune + connect, chaining each level's pruned set as the next
    level's seeds (hnsw.rs:291-328). ``flat_tabs`` maps routing levels to
    compact member tables; ``flat0`` is the level-0 bootstrap table.
    ``flat_orders`` (the flat backbone) maps levels to the insertion rank
    of each table column, ``flat_row_base`` is the rank of wave row 0:
    candidates are then triangular, and ``flat0`` is the backbone's
    level-0 table, used whatever the active count. ``cancel`` goes to the
    descent's and the beams' loops."""
    wave_t = torch.from_numpy(wave).to(dev.device)
    backbone = flat_orders is not None
    use_flat = n_active <= FLAT_BOOTSTRAP and not backbone

    def _fm(level: int):
        """Compact member table for exact candidates at ``level``."""
        if level == 0:
            return flat0 if (use_flat or backbone) else None
        return flat_tabs.get(level) if flat_tabs is not None else None

    top = min(lv, dev.max_level)
    # the greedy descent only seeds beam searches
    needs_beam = not use_flat and any(_fm(level) is None for level in range(top, -1, -1))
    if dev.max_level > lv and needs_beam:
        # A level-0 item's layer-0 beam is seeded as a search's is: on a
        # large clustered index the greedy walk ends in another cluster's
        # basin for some items, which then link only to far candidates and
        # cannot be found again. (Items of higher levels run an
        # ef_construction-wide beam at their own top layer already.)
        ef_upper = beam.default_ef_upper(n_active, opts.ef_construction) if lv == 0 else 1
        seeds = beam.descend_for_slots(
            dev, wave_t, dev.max_level, lv + 1, node_ok=node_ok, ef_upper=ef_upper, cancel=cancel
        )
    else:
        seeds = dev.entry_slots[None, :].expand(wave.shape[0], -1)
    # Tail termination only on wide waves, sized from the REAL item count
    # snapped down to the wave buckets (padding rows converge together)
    if n_real is None:
        n_real = int((wave >= 0).sum())
    tail = opts.beam_tail_frac if n_real >= 1024 else 0.0
    tail_base = max((b for b in _WAVE_BUCKETS if b <= n_real), default=0)

    for level in range(top, -1, -1):
        fm = _fm(level)
        if fm is not None and level > 0:
            ef = max(opts.ef_construction, opts.upper_flat_pool)
        elif level == 0 and backbone:
            # a wider exact pool keeps ring diversity, bounded: the prune
            # gathers [W, pool, D]
            ef = max(opts.ef_construction, BACKBONE_FLAT_POOL)
        else:
            ef = opts.ef_construction
        dev, selected, dirty, counters = wave_ops.wave_insert_level(
            dev, wave_t, seeds, node_ok, level, dirty, counters,
            ef=ef,
            cap=m0 if level == 0 else dev.upper_links.shape[-1],
            alpha=opts.alpha,
            flat=use_flat and fm is None,
            beam_iters=opts.beam_iters,
            beam_tail_allow=int(tail * tail_base),
            flat_members=fm,
            flat_col_order=flat_orders.get(level) if backbone else None,
            flat_row_base=flat_row_base,
            cancel=cancel,
        )
        seeds = selected
    return dev, dirty, counters
