"""Journal-driven lockstep construction over the durable store.

Counterpart of ``hannoy_tpu/parallel/spmd_build.py``:

1. every shard runs the single-device build **prologue** (journal scan →
   to_insert / to_delete set algebra → vector staging,
   ``Writer._build_prologue``, writer.rs:521-554);
2. all shards' device builds run in **lockstep** waves — wave i of every
   shard, each on its own device, before wave i+1 — then each shard's
   deletions are repaired (``builder._repair_deletions``, hnsw.rs:334-415)
   and, after a build with link slack, its layer 0 is re-checked for
   stranded rows (``sharded.recheck_shards``; the JAX package's SPMD build
   has no such step);
3. every shard runs the single-device **epilogue** (link deletion →
   dirty-row flush → metadata / version, ``Writer._build_epilogue``,
   writer.rs:577-600).

Per-shard dirty masks ride the device through every wave, so an
incremental sharded build flushes only touched rows. Each shard persists
as an ordinary store index, so ``NeedBuild`` gating and a per-shard
``Reader`` apply unchanged. The bulk path (build/bulk.py) stays
single-device, as in the JAX package: a large fresh build of many shards
on one card takes ``ShardedWriter.build(spmd=False)``, each shard through
the whole single-device builder.

Where the JAX package runs one ``shard_map`` program per step, one
process here runs the step shard by shard (``sharded.lockstep_waves``).
``opts.cancel`` is checked between lockstep waves, inside their loops and
between repair blocks; a build it cancels raises ``BuildCancelled`` and
leaves every shard's graph out of the cache (``Writer._forget_graph``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..build import builder as _builder
from ..build import wave_ops
from ..models.hnsw import HostGraph, from_device
from ..utils.stats import BuildStats
from ..utils.tracing import span
from .sharded import ShardedIndex, lockstep_waves, pad_to_common_shapes, prune_slack_shards, recheck_shards


def spmd_store_build(
    writers: list,
    opts: Optional[_builder.BuildOptions] = None,
    *,
    devices: Sequence,
) -> list[BuildStats]:
    """Build every shard's journal-pending changes in lockstep waves,
    shard ``s`` on ``devices[s]``.

    ``writers`` are per-shard :class:`hannoy_tpu_torch.Writer` handles
    sharing one Database and write transaction (one store index per
    shard). Inserts and deletes run on the devices; durability flows
    through each shard's ordinary epilogue. Returns per-shard BuildStats."""
    opts = opts or _builder.BuildOptions()
    try:
        plans = [w._build_prologue(opts) for w in writers]
        statses = [BuildStats() for _ in writers]
        if any(p.built for p in plans):
            _spmd_device_build(plans, statses, opts, devices, writers[0]._database.tier)
        return [w._build_epilogue(p, opts, st) for w, p, st in zip(writers, plans, statses)]
    except BaseException:
        for w in writers:
            w._forget_graph()
        raise


def _spmd_device_build(
    plans: list,
    statses: list[BuildStats],
    opts: _builder.BuildOptions,
    devices: Sequence,
    tier: str = "raw",
) -> None:
    """The steps of ``builder.build_graph`` that the lockstep path runs,
    S shards at a time: plan, pad, waves, slack prune, repair, stranding
    re-check (with slack), download."""
    S = len(plans)
    graphs: list[HostGraph] = [p.g for p in plans]

    # ---- per-shard host prologue (levels, entry points, masks) ----
    # Shards with nothing pending skip plan_build: it schedules the old
    # entry points for re-indexing (hnsw.rs:267-268), which is only wanted
    # when a build actually runs.
    dplans = []
    for p, st in zip(plans, statses):
        if p.built:
            dplans.append(_builder.plan_build(p.g, p.insert_slots, p.delete_slots, opts, st))
        else:
            live = (p.g.levels >= 0).copy()
            dplans.append((np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int32), live, live.copy()))
    deleted_sets = [{int(s) for s in p.delete_slots} for p in plans]

    # ---- equalise shapes, pad the per-shard masks to the common capacity ----
    pad_to_common_shapes(graphs)
    cap = graphs[0].capacity

    def padmask(m: np.ndarray) -> np.ndarray:
        return np.pad(m, (0, cap - len(m)), constant_values=False)

    index = ShardedIndex.from_host_graphs(graphs, devices, tier=tier, link_slack=opts.link_slack)
    node_ok, dirty = [], []
    for dev, dp in zip(index.graphs, dplans):
        dev.valid = torch.from_numpy(padmask(dp[2])).to(dev.device)
        node_ok.append(torch.from_numpy(padmask(dp[3])).to(dev.device))
        dirty.append(torch.zeros((cap,), dtype=torch.bool, device=dev.device))

    # ---- lockstep level-descending insert waves (hnsw.rs:160-185) ----
    with span("spmd_waves", shards=S):
        waves = lockstep_waves(index, [(dp[0], dp[1]) for dp in dplans], [int(dp[2].sum()) for dp in dplans],
                               node_ok, dirty, opts, graphs[0].m0)
    for st in statses:
        st.waves += waves

    # ---- slack rows back to m0 before the repair reads them ----
    if opts.link_slack:
        with span("prune_slack_rows", shards=S):
            prune_slack_shards(index, dirty, graphs[0].m0, opts.alpha)

    # ---- deletion repair per shard (fill_gaps_from_deleted) ----
    for s, dset in enumerate(deleted_sets):
        if dset:
            dev = index.graphs[s]
            deleted_t = torch.tensor(sorted(dset), dtype=torch.int32, device=dev.device)
            with span("repair_deletions", shard=s, deleted=len(dset)):
                _builder._repair_deletions(dev, deleted_t, graphs[s].m0, graphs[s].m, opts, dirty[s])
            wave_ops.clear_slots(dev, deleted_t)

    # ---- stranding re-check per shard, after the slack prune ----
    if opts.link_slack:
        for st, w in zip(statses, recheck_shards(index, node_ok, dirty, graphs[0].m0, opts, [p.built for p in plans])):
            st.waves += w

    # ---- download: per-shard device graphs → host mirrors ----
    for s, (g, dev) in enumerate(zip(graphs, index.graphs)):
        from_device(g, dev)
        touched = set(np.nonzero(dirty[s].cpu().numpy())[0].tolist()) - deleted_sets[s]
        statses[s].touched = np.asarray(sorted(touched), dtype=np.int64)
