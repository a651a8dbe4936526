"""Wave-parallel HNSW construction — host orchestration.

Counterpart of the insertion-wave path of ``hannoy_tpu/build/builder.py``
(the path ``BuildOptions(bulk=False)`` selects there): the host samples
levels, resolves entry points, composes level-descending waves, and
drives the device steps in ``wave_ops.py``; all distance work runs on the
device given to ``build_graph``.

Options outside this path raise ``NotImplementedError`` rather than being
substituted (see ``_check_supported``): the bulk builder, deletions and
repair, link slack, chain seeding, ``beam_expand > 1``, ``traverse`` and
in-wave cancellation are not ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..models import hnsw
from ..models.hnsw import DeviceGraph, HostGraph
from ..ops import beam, distances
from ..utils.progress import BuildStep, InsertItemsStep, NoProgress
from ..utils.stats import BuildStats
from ..utils.tracing import span
from . import bulk, wave_ops
from .levels import sample_levels

#: brute-force candidate search while the indexed graph is this small
FLAT_BOOTSTRAP = 1024
#: default wave width (items inserted per device step)
DEFAULT_WAVE = 256
#: wave sizes snap to these buckets (the JAX package's, kept so both
#: packages insert the same items in the same waves)
_WAVE_BUCKETS = (16, 128, 1024, 4096)


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
    """Default cancel sentinel (the only one this port accepts)."""
    return False


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
    #: None = the JAX package's automatic bulk choice, True forces it,
    #: False disables it; the port raises wherever bulk would run
    bulk: Optional[bool] = None
    bulk_threshold: int = 8192


def _check_supported(
    g: HostGraph, insert_slots: np.ndarray, deleted_slots: np.ndarray, opts: BuildOptions
) -> None:
    """Raise ``NotImplementedError`` for anything this port does not build."""
    distances.check_supported(g.metric)
    if len(deleted_slots):
        raise NotImplementedError("deletions and repair are not ported yet (ROADMAP.md queue 1)")
    for name, value, default in (
        ("link_slack", opts.link_slack, 0),
        ("chain_seeding", opts.chain_seeding, False),
        ("beam_expand", opts.beam_expand, 1),
        ("traverse", opts.traverse, None),
    ):
        if value != default:
            raise NotImplementedError(f"BuildOptions.{name}={value!r} is not ported yet (ROADMAP.md queue 1)")
    if opts.cancel is not _never_cancel:
        raise NotImplementedError("cancellable builds are not ported yet (ROADMAP.md queue 1)")
    # the insertion schedule plan_build will make: the new items plus the
    # surviving old entry points, which are re-inserted
    scheduled = set(int(s) for s in insert_slots) | set(int(e) for e in g.entry_slots)
    n_active = int(g.valid_mask().sum()) - sum(1 for s in scheduled if g.levels[s] >= 0)
    if bulk.eligible(g.metric, n_active, 0, len(scheduled), opts):
        raise NotImplementedError(
            "this build would take the JAX package's bulk path, which is not ported yet "
            "(ROADMAP.md queue 1); pass BuildOptions(bulk=False) for the insertion-wave path"
        )


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
) -> BuildStats:
    """Run a build of the staged items on ``device`` (insertion waves).

    Preconditions: vectors/norms for ``insert_slots`` are staged in ``g``.
    Raises ``NotImplementedError`` for what the port does not build yet.
    """
    _check_supported(g, insert_slots, deleted_slots, opts)
    stats = stats or BuildStats()
    device = torch.device(device)

    slots, lvls, active, exists_ok = plan_build(g, insert_slots, deleted_slots, opts, stats)

    dev = hnsw.to_device(g, device)
    dev.valid = torch.from_numpy(active).to(device)
    # beam traversal may seed/visit anything that exists
    node_ok = torch.from_numpy(exists_ok).to(device)

    # ---- insertion waves, level-descending (hnsw.rs:160-185) ----
    opts.progress.update(BuildStep.BUILDING_THE_GRAPH)
    total = len(slots)
    done = 0
    n_active = int(active.sum())
    dirty = torch.zeros((g.capacity,), dtype=torch.bool, device=device)
    counters = torch.zeros((4,), dtype=torch.int32, device=device)

    # compact member tables for exact routing-layer candidates
    flat_tabs: dict[int, torch.Tensor] = {}
    for level in range(1, g.max_level + 1):
        mem = _layer_members(g, level)
        if 0 < len(mem) <= opts.upper_flat_max:
            flat_tabs[level] = torch.from_numpy(_padded_table(mem)).to(device)

    # already-inserted slots, tracked only inside the flat bootstrap
    active_ids = np.nonzero(active)[0].astype(np.int64)

    for lv in sorted(set(int(x) for x in lvls), reverse=True):
        grp = slots[lvls == lv]
        start = 0
        while start < len(grp):
            w_pad = _ramp_width(opts.wave_size, n_active)
            chunk = grp[start : start + w_pad]
            start += len(chunk)
            wave = np.full(w_pad, -1, dtype=np.int32)
            wave[: len(chunk)] = chunk
            flat0 = None
            if n_active <= FLAT_BOOTSTRAP:
                tab0 = np.full(FLAT_BOOTSTRAP, -1, dtype=np.int32)
                tab0[: len(active_ids)] = active_ids[:FLAT_BOOTSTRAP]
                flat0 = torch.from_numpy(tab0).to(device)
            with span("insert_wave", level=lv, width=w_pad, active=n_active):
                dev, dirty, counters = _insert_wave(
                    dev, wave, lv, opts, n_active, node_ok, dirty, counters, g.m0,
                    n_real=len(chunk), flat_tabs=flat_tabs, flat0=flat0,
                )
            wave_ops.activate_wave(dev, torch.from_numpy(wave).to(device))
            if len(active_ids) <= FLAT_BOOTSTRAP:
                # kept ascending so flat-candidate ties break as in a full scan
                active_ids = np.sort(np.concatenate([active_ids, chunk.astype(np.int64)]))
            n_active += len(chunk)
            done += len(chunk)
            stats.waves += 1
            opts.progress.update(InsertItemsStep(done, total))

    # ---- end-of-build stranding re-check ----
    # Rows with no forward links are re-inserted with exact candidates over
    # the whole live graph; rows with in-degree 0 get one forced inbound
    # edge; repeated until clean (capped).
    if len(slots):
        with span("inbound_recheck"):
            for _round in range(12):
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
        dirty_np, counters_np = dirty.cpu().numpy(), counters.cpu().numpy()
    stats.links_added += int(counters_np[wave_ops.CNT_FWD_LINKS] + counters_np[wave_ops.CNT_REV_DELTA])
    stats.beam_iters += int(counters_np[wave_ops.CNT_BEAM_ITERS])
    stats.store_gathers += int(counters_np[wave_ops.CNT_ROW_GATHERS]) * wave_ops.GATHER_GRANULE
    stats.touched = np.nonzero(dirty_np)[0].astype(np.int64)
    return stats


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
):
    """Insert one wave: greedy descent to lv+1, then per-level candidates
    + prune + connect, chaining each level's pruned set as the next
    level's seeds (hnsw.rs:291-328). ``flat_tabs`` maps routing levels to
    compact member tables; ``flat0`` is the level-0 bootstrap table."""
    wave_t = torch.from_numpy(wave).to(dev.device)
    use_flat = n_active <= FLAT_BOOTSTRAP

    def _fm(level: int):
        """Compact member table for exact candidates at ``level``."""
        if level == 0:
            return flat0 if use_flat else None
        return flat_tabs.get(level) if flat_tabs is not None else None

    top = min(lv, dev.max_level)
    # the greedy descent only seeds beam searches
    needs_beam = not use_flat and any(_fm(level) is None for level in range(top, -1, -1))
    if dev.max_level > lv and needs_beam:
        seeds = beam.descend_for_slots(dev, wave_t, dev.max_level, lv + 1, node_ok=node_ok)
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
        dev, selected, dirty, counters = wave_ops.wave_insert_level(
            dev, wave_t, seeds, node_ok, level, dirty, counters,
            ef=(
                max(opts.ef_construction, opts.upper_flat_pool)
                if fm is not None and level > 0
                else opts.ef_construction
            ),
            cap=m0 if level == 0 else dev.upper_links.shape[-1],
            alpha=opts.alpha,
            flat=use_flat and fm is None,
            beam_iters=opts.beam_iters,
            beam_tail_allow=int(tail * tail_base),
            flat_members=fm,
        )
        seeds = selected
    return dev, dirty, counters
