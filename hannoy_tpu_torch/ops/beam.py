"""Batched beam search over the device-resident HNSW graph.

Counterpart of the unfiltered half of ``hannoy_tpu/ops/beam.py``:

* ``greedy_descend`` ⇔ the ef=1 ``walk_layer`` descent: a batched
  hill-climb per upper layer — every step gathers each query's current
  node's M neighbors, computes their distances in one kernel launch, and
  moves to the best neighbor until no query improves.
* ``beam_search`` ⇔ ``walk_layer`` with ef>1: a fixed-width sorted pool of
  ef (dist, id, expanded) triples per query. Each iteration expands the
  best unexpanded entry (the E best with ``expand``), gathers its
  neighbors, dedups them against the pool with a compare matrix, computes
  their distances, and sort-merges.
  A query is done when its best unexpanded distance exceeds its worst
  pooled distance.
* ``beam_search_filtered`` ⇔ the candidates-bitmap variant: the frontier
  may pass through non-candidates but results exclude them, so it carries
  a frontier pool and a result pool. ``hnsw_search_filtered`` descends
  unfiltered (upper layers route, they do not filter) and runs it at
  layer 0; the by-item search seeds it at the item's own slot.

Every hop's distances go through ``beam_cuda.gathered_distances``: the
hand-written kernel on CUDA tensors, its plain twin on CPU tensors.

JAX's ``lax.while_loop`` becomes ``_while_loop``: the loop condition stays
on the device as a ``go`` flag that gates each state update, so a row the
JAX loop would have stopped is never expanded, and the host reads the flag
only every ``SYNC_EVERY`` iterations.

Cancellation rides those reads. The JAX package runs a cancellable search
in chunks of a jitted loop with its own runners
(``hnsw_search_cancellable`` and its siblings); here every loop takes an
optional ``cancel`` closure, called where the host reads the flag anyway:
a search's closure returns True to stop the loop there (the pools so far
are the partial answer), a build's raises ``BuildCancelled``. Without one
the loops issue no extra host sync.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..models.hnsw import DeviceGraph
from . import beam_cuda, distances, topk
from .topk import INF, NO_ID

#: iterations between host reads of a device-side loop flag
SYNC_EVERY = 8

State = tuple[torch.Tensor, ...]
#: a loop's cancel closure: called at each host read of its flag; True
#: stops the loop there (a build's closure raises instead)
Cancel = Optional[Callable[[], bool]]


def _while_loop(
    cond: Callable[[State], torch.Tensor],
    body: Callable[[State], State],
    state: State,
    max_iters: int,
    cancel: Cancel = None,
) -> tuple[State, torch.Tensor]:
    """``lax.while_loop(cond & (it < max_iters), body, state)`` in eager
    PyTorch → (final state, int32 count of body executions).

    ``cond`` returns a 0-d bool tensor. Once it is false the state stops
    changing, exactly as in the JAX loop; the host stops issuing
    iterations at the next check of the flag. ``cancel`` is called at
    those checks while the loop still runs: True ends it there, with the
    state as it stands."""
    go = cond(state)
    iters = torch.zeros((), dtype=torch.int32, device=go.device)
    for it in range(max_iters):
        if it % SYNC_EVERY == 0 and (not bool(go) or (cancel is not None and cancel())):
            break
        new = body(state)
        state = tuple(torch.where(go, n, s) for n, s in zip(new, state))
        iters += go.to(torch.int32)
        go = go & cond(state)
    return state, iters


def _ix(t: torch.Tensor) -> torch.Tensor:
    """Slot/row tensor (possibly -1) → int64 gather index, -1 read as 0."""
    return t.clamp(min=0).long()


def candidate_distances(
    g: DeviceGraph, q: torch.Tensor, qn: torch.Tensor, nbs: torch.Tensor
) -> torch.Tensor:
    """Distances from queries [B] to candidate slots [B, K] — the per-hop
    hot op (entries at -1 read row 0; callers mask them). The store's
    rows may be f32, a storage tier (bf16, int8) or packed lanes; a
    search's queries are f32 (or packed lanes), a build's are rows of the
    store with their headers (``descend_for_slots``)."""
    return beam_cuda.gathered_distances(g.metric, g.vectors, g.norms, q, qn, nbs.contiguous())


def links_at(g: DeviceGraph, level: int, slots: torch.Tensor) -> torch.Tensor:
    """Neighbor slots of ``slots [B]`` at ``level`` → [B, M or M0]. Upper
    layers go through the slot→row indirection into the stacked tables."""
    safe = _ix(slots)
    if level == 0:
        nbs = g.links0[safe]
    else:
        rows = g.slot_rows[level - 1][safe]
        nbs = g.upper_links[level - 1][_ix(rows)]
        nbs = torch.where((rows >= 0)[:, None], nbs, NO_ID)
    return torch.where((slots >= 0)[:, None], nbs, NO_ID)


def seed_distances(
    metric: distances.Metric,
    vectors: torch.Tensor,
    norms: torch.Tensor,
    q: torch.Tensor,  # [B, D]
    qn: torch.Tensor,  # [B]
    slots: torch.Tensor,  # [B, S] (-1 padded)
) -> torch.Tensor:
    """Distances from each query to its seed slots; +inf on padding."""
    d = beam_cuda.gathered_distances(metric, vectors, norms, q, qn, slots.contiguous())
    return torch.where(slots >= 0, d, INF)


# --------------------------------------------------------------------------
# Upper-layer greedy descent (ef = 1)
# --------------------------------------------------------------------------


def greedy_descend(
    g: DeviceGraph,
    q: torch.Tensor,  # [B, D]
    qn: torch.Tensor,  # [B]
    from_level: int,
    to_level: int,
    max_steps_per_level: int = 128,
    node_ok: Optional[torch.Tensor] = None,
    cancel: Cancel = None,
) -> torch.Tensor:
    """Descend layers ``from_level .. to_level`` (inclusive, both >= 1)
    greedily from the best entry point; returns the best slot per query
    → [B]. ``node_ok`` (default ``g.valid``) gates which slots the walk
    may settle on — builders pass exists-and-not-deleted. A cancelled
    walk returns where it stands."""
    if node_ok is None:
        node_ok = g.valid
    eps = g.entry_slots[None, :].expand(q.shape[0], -1)
    d = seed_distances(g.metric, g.vectors, g.norms, q, qn, eps)
    d = torch.where(node_ok[_ix(eps)] & (eps >= 0), d, INF)
    best = d.argmin(-1, keepdim=True)
    cur = eps.gather(1, best)[:, 0]
    cur_d = d.gather(1, best)[:, 0]
    for level in range(from_level, to_level - 1, -1):
        cur, cur_d = _greedy_level(g, q, qn, cur, cur_d, level, max_steps_per_level, node_ok, cancel)
    return cur


def _greedy_level(
    g: DeviceGraph,
    q: torch.Tensor,
    qn: torch.Tensor,
    cur: torch.Tensor,
    cur_d: torch.Tensor,
    level: int,
    max_steps: int,
    node_ok: torch.Tensor,
    cancel: Cancel = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    slot_rows, upper = g.slot_rows[level - 1], g.upper_links[level - 1]

    def body(state):
        cur, cur_d, _ = state
        rows = slot_rows[_ix(cur)]
        nbs = upper[_ix(rows)]  # [B, M]
        nb_valid = (
            (nbs >= 0) & (rows >= 0)[:, None] & (cur >= 0)[:, None] & node_ok[_ix(nbs)]
        )
        d = torch.where(nb_valid, candidate_distances(g, q, qn, nbs), INF)
        best = d.argmin(-1, keepdim=True)
        best_d = d.gather(1, best)[:, 0]
        best_nb = nbs.gather(1, best)[:, 0]
        improved = best_d < cur_d
        return torch.where(improved, best_nb, cur), torch.minimum(best_d, cur_d), improved

    init = (cur, cur_d, torch.ones_like(cur, dtype=torch.bool))
    (cur, cur_d, _), _ = _while_loop(lambda s: s[2].any(), body, init, max_steps, cancel)
    return cur, cur_d


def descend_for_slots(
    g: DeviceGraph,
    wave_slots: torch.Tensor,  # [W]
    from_level: int,
    to_level: int,
    max_steps_per_level: int = 128,
    node_ok: Optional[torch.Tensor] = None,
    ef_upper: int = 1,
    cancel: Cancel = None,
) -> torch.Tensor:
    """Descent for a wave of *stored* items: gathers their vectors and
    walks layers ``from_level..to_level`` greedily → seed slots [W, 1].
    With ``ef_upper > 1`` the last layer is walked by an ``ef_upper``-wide
    beam instead, as ``_descend_start`` does for a search → [W, ef_upper]."""
    q = g.vectors[_ix(wave_slots)]
    qn = g.norms[_ix(wave_slots)]
    return _descend(g, q, qn, from_level, to_level, ef_upper, max_steps_per_level, node_ok, cancel)


def _descend(
    g: DeviceGraph,
    q: torch.Tensor,
    qn: torch.Tensor,
    from_level: int,
    to_level: int,
    ef_upper: int = 1,
    max_steps_per_level: int = 128,
    node_ok: Optional[torch.Tensor] = None,
    cancel: Cancel = None,
) -> torch.Tensor:
    """Seed slots for the layer below ``to_level`` → [B, S]: the greedy
    walk through ``from_level..to_level`` (``ef_upper == 1``), or greedy
    down to ``to_level + 1`` and an ``ef_upper``-wide beam at ``to_level``."""
    if ef_upper <= 1:
        return greedy_descend(g, q, qn, from_level, to_level, max_steps_per_level, node_ok, cancel)[:, None]
    if from_level > to_level:
        start = greedy_descend(g, q, qn, from_level, to_level + 1, max_steps_per_level, node_ok, cancel)[:, None]
    else:
        start = g.entry_slots[None, :].expand(q.shape[0], -1)
    return beam_search(g, q, qn, start, ef_upper, node_ok=node_ok, level=to_level, cancel=cancel).slots


# --------------------------------------------------------------------------
# Beam search
# --------------------------------------------------------------------------


class BeamResult(NamedTuple):
    dists: torch.Tensor  # [B, ef] ascending, +inf padded
    slots: torch.Tensor  # [B, ef] int32 slot ids, -1 padded
    iters: torch.Tensor  # [] int32 loop iterations executed
    #: [B] bool — rows still improving when the loop exited (the iteration
    #: cap or the tail allowance cut them off)
    active: Optional[torch.Tensor] = None


def _rows_active(pool_d: torch.Tensor, pool_id: torch.Tensor, pool_exp: torch.Tensor) -> torch.Tensor:
    """Per-row continuation test on a beam pool → [B] bool."""
    unexp_d = torch.where((pool_exp == 0) & (pool_id != NO_ID), pool_d, INF)
    best_d = unexp_d.min(-1).values
    return (best_d <= pool_d[:, -1]) & (best_d < INF)


def _filtered_rows_active(fr_d, fr_id, fr_exp, res_d) -> torch.Tensor:
    """Filtered-beam rowwise continuation: the frontier's best unexpanded
    entry against the *result* pool's worst → [B] bool."""
    unexp_d = torch.where((fr_exp == 0) & (fr_id != NO_ID), fr_d, INF)
    best_d = unexp_d.min(-1).values
    return (best_d <= res_d[:, -1]) & (best_d < INF)


def beam_search(
    g: DeviceGraph,
    q: torch.Tensor,  # [B, D]
    qn: torch.Tensor,  # [B]
    start: torch.Tensor,  # [B, S] seed slots (-1 padded)
    ef: int,
    max_iters: Optional[int] = None,
    node_ok: Optional[torch.Tensor] = None,
    level: int = 0,
    expand: int = 1,
    traverse_k: Optional[int] = None,
    tail_frac: float = 0.0,
    tail_allow: Optional[int] = None,
    cancel: Cancel = None,
) -> BeamResult:
    """Unfiltered beam search at ``level`` (builders run it per layer,
    searches at layer 0).

    ``expand``: pool entries expanded per iteration (E; at most ``ef``).
    E > 1 gathers E rows of links per iteration, so about E× fewer
    iterations (and host-issued hops) cover the same candidates; the
    default budget is divided by E.
    ``traverse_k``: expand only the first ``traverse_k`` links of a row
    (rows are distance-sorted, so its nearest).
    ``node_ok``: traversable-slot mask (default ``g.valid``).
    ``tail_frac`` / ``tail_allow``: stop once at most this many queries
    are still active (0 = the reference's termination); builders size the
    allowance from the real item count of a wave.
    ``cancel``: see ``_while_loop``; a cancelled beam returns its pool.
    """
    if max_iters is None:
        max_iters = (2 * ef + 16 + expand - 1) // expand
    if node_ok is None:
        node_ok = g.valid
    if tail_allow is None:
        tail_allow = int(tail_frac * q.shape[0])
    state = _seed_pool(g, q, qn, start, ef, node_ok)
    body, cond = _beam_step(g, q, qn, node_ok, ef, level, traverse_k, tail_allow, min(expand, ef))
    (pool_d, pool_id, pool_exp), iters = _while_loop(cond, body, state, max_iters, cancel)
    return BeamResult(pool_d, pool_id, iters, _rows_active(pool_d, pool_id, pool_exp))


def _seed_pool(g: DeviceGraph, q, qn, start, ef: int, node_ok) -> State:
    """Initialize the sorted (dist, id, expanded) pool from seed slots."""
    B = q.shape[0]
    seed_ok = (start >= 0) & node_ok[_ix(start)]
    seeds = torch.where(seed_ok, start, NO_ID)
    d = seed_distances(g.metric, g.vectors, g.norms, q, qn, seeds)
    d = torch.where(topk.unique_mask(seeds), d, INF)
    seeds = torch.where(d < INF, seeds, NO_ID)

    pool_d = torch.full((B, ef), INF, device=q.device)
    pool_id = torch.full((B, ef), NO_ID, dtype=torch.int32, device=q.device)
    pool_exp = torch.zeros((B, ef), dtype=torch.int32, device=q.device)
    pool_d, (pool_id, pool_exp) = topk.merge_sorted(
        pool_d, (pool_id, pool_exp), d, (seeds, torch.zeros_like(seeds)), ef
    )
    return pool_d, pool_id, pool_exp


def _beam_step(
    g: DeviceGraph,
    q,
    qn,
    node_ok,
    ef: int,
    level: int,
    traverse_k: Optional[int] = None,
    tail_allow: int = 0,
    E: int = 1,
):
    """(body, cond) for the beam loop over state (pool_d, pool_id,
    pool_exp). ``tail_allow``: keep looping only while *more than* this
    many queries are active. ``E``: entries expanded per iteration, the
    E best unexpanded ones (ties toward the lower position, as
    ``lax.top_k``); each takes part only while it passes the bound."""
    B = q.shape[0]

    def body(state):
        pool_d, pool_id, pool_exp = state
        unexp_d = torch.where((pool_exp == 0) & (pool_id != NO_ID), pool_d, INF)
        if E == 1:
            pos = unexp_d.argmin(-1, keepdim=True)  # [B, 1] best unexpanded
            exp_d = unexp_d.gather(1, pos)
        else:
            exp_d, pos = topk.smallest_k(unexp_d, E)  # [B, E]
        active = (exp_d <= pool_d[:, -1:]) & (exp_d < INF)  # [B, E]

        # positions are distinct, so the scatter is deterministic
        mark = torch.zeros_like(pool_exp).scatter(1, pos, active.to(pool_exp.dtype))
        pool_exp = torch.maximum(pool_exp, mark)

        cur = torch.where(active, pool_id.gather(1, pos), NO_ID)
        ln = links_at(g, level, cur.reshape(-1))
        if traverse_k is not None and traverse_k < ln.shape[-1]:
            ln = ln[:, :traverse_k]
        nbs = ln.reshape(B, -1)
        ok = (
            (nbs >= 0)
            & node_ok[_ix(nbs)]
            & ~topk.contains(nbs, pool_id)
            & topk.unique_mask(nbs)
        )
        nd = torch.where(ok, candidate_distances(g, q, qn, nbs), INF)
        nids = torch.where(ok, nbs, NO_ID)
        pd, (pid, pexp) = topk.merge_sorted(
            pool_d, (pool_id, pool_exp), nd, (nids, torch.zeros_like(nids)), ef
        )
        return pd, pid, pexp

    def cond(state):
        return _rows_active(*state).sum() > tail_allow

    return body, cond


def beam_search_filtered(
    g: DeviceGraph,
    q: torch.Tensor,  # [B, D]
    qn: torch.Tensor,  # [B]
    start: torch.Tensor,  # [B, S] seed slots (-1 padded)
    ef: int,
    candidate_mask: torch.Tensor,  # [N_pad] bool — allowed result slots
    max_iters: Optional[int] = None,
    node_ok: Optional[torch.Tensor] = None,
    cancel: Cancel = None,
) -> BeamResult:
    """Candidate-filtered layer-0 beam search (reader.rs:322-365).

    The frontier traverses any live node; the result pool admits only
    candidates. A row continues while the frontier's best unexpanded entry
    is no worse than the *result* pool's worst (reader.rs:329-336). A
    cancelled beam returns its result pool."""
    if max_iters is None:
        max_iters = 2 * ef + 16
    if node_ok is None:
        node_ok = g.valid
    state = _filtered_seed_pools(g, q, qn, start, candidate_mask, node_ok, ef)
    body, cond = _filtered_step(g, q, qn, node_ok, candidate_mask, ef)
    (fr_d, fr_id, fr_exp, res_d, res_id), iters = _while_loop(cond, body, state, max_iters, cancel)
    return BeamResult(res_d, res_id, iters, _filtered_rows_active(fr_d, fr_id, fr_exp, res_d))


def _filtered_seed_pools(g: DeviceGraph, q, qn, start, candidate_mask, node_ok, ef: int) -> State:
    """Initial (frontier, result) pools for the filtered beam: every live
    seed enters the frontier, the candidates among them the result pool."""
    B = q.shape[0]
    cand_ok = node_ok & candidate_mask
    seed_ok = (start >= 0) & node_ok[_ix(start)]
    seeds = torch.where(seed_ok, start, NO_ID)
    d = seed_distances(g.metric, g.vectors, g.norms, q, qn, seeds)
    d = torch.where(topk.unique_mask(seeds), d, INF)
    seeds = torch.where(d < INF, seeds, NO_ID)
    seed_cand = torch.where(cand_ok[_ix(seeds)] & (seeds != NO_ID), seeds, NO_ID)
    seed_cand_d = torch.where(seed_cand != NO_ID, d, INF)

    def empty():
        return (torch.full((B, ef), INF, device=q.device),
                torch.full((B, ef), NO_ID, dtype=torch.int32, device=q.device))

    fr_d, fr_id = empty()
    fr_exp = torch.zeros((B, ef), dtype=torch.int32, device=q.device)
    fr_d, (fr_id, fr_exp) = topk.merge_sorted(fr_d, (fr_id, fr_exp), d, (seeds, torch.zeros_like(seeds)), ef)
    res_d, res_id = empty()
    res_d, (res_id,) = topk.merge_sorted(res_d, (res_id,), seed_cand_d, (seed_cand,), ef)
    return fr_d, fr_id, fr_exp, res_d, res_id


def _filtered_step(g: DeviceGraph, q, qn, node_ok, candidate_mask, ef: int):
    """(body, cond) for the filtered beam loop over state (fr_d, fr_id,
    fr_exp, res_d, res_id): expand the frontier's best unexpanded entry,
    merge its unvisited live neighbours into the frontier and the
    candidates among them into the result pool."""
    cand_ok = node_ok & candidate_mask

    def body(state):
        fr_d, fr_id, fr_exp, res_d, res_id = state
        unexp_d = torch.where((fr_exp == 0) & (fr_id != NO_ID), fr_d, INF)
        pos = unexp_d.argmin(-1, keepdim=True)  # [B, 1] best unexpanded
        best_d = unexp_d.gather(1, pos)
        active = (best_d <= res_d[:, -1:]) & (best_d < INF)  # [B, 1]

        mark = torch.zeros_like(fr_exp).scatter(1, pos, active.to(fr_exp.dtype))
        fr_exp = torch.maximum(fr_exp, mark)

        cur = torch.where(active, fr_id.gather(1, pos), NO_ID)[:, 0]
        nbs = links_at(g, 0, cur)
        visited = topk.contains(nbs, fr_id) | topk.contains(nbs, res_id)
        ok = (nbs >= 0) & node_ok[_ix(nbs)] & ~visited
        nd = torch.where(ok, candidate_distances(g, q, qn, nbs), INF)
        nids = torch.where(ok, nbs, NO_ID)
        fr_d, (fr_id, fr_exp) = topk.merge_sorted(
            fr_d, (fr_id, fr_exp), nd, (nids, torch.zeros_like(nids)), ef
        )
        c_ok = ok & cand_ok[_ix(nbs)]
        cd = torch.where(c_ok, nd, INF)
        cids = torch.where(c_ok, nbs, NO_ID)
        res_d, (res_id,) = topk.merge_sorted(res_d, (res_id,), cd, (cids,), ef)
        return fr_d, fr_id, fr_exp, res_d, res_id

    def cond(state):
        fr_d, fr_id, fr_exp, res_d, _ = state
        return _filtered_rows_active(fr_d, fr_id, fr_exp, res_d).any()

    return body, cond


# --------------------------------------------------------------------------
# Full hnsw_search: descent + layer-0 beam
# --------------------------------------------------------------------------


def default_ef_upper(n_valid: int, ef: int) -> int:
    """Width of the pooled layer-1 descent (``_descend_start``): the
    greedy ef=1 walk for small graphs, a pooled layer-1 beam for larger
    ones (seed diversity on clustered data). The JAX package's defaults;
    no environment override."""
    if n_valid >= 500_000:
        return max(1, min(32, ef))
    if n_valid >= 16_384:
        return max(1, min(8, ef))
    return 1


def _descend_start(g: DeviceGraph, q: torch.Tensor, qn: torch.Tensor, ef_upper: int = 1) -> torch.Tensor:
    """Layer-0 seed slots → [B, S]: the greedy descent through layers
    L..1 (``ef_upper == 1``), or greedy through L..2 then an
    ``ef_upper``-wide beam at layer 1."""
    if g.max_level < 1:
        return g.entry_slots[None, :].expand(q.shape[0], -1)
    return _descend(g, q, qn, g.max_level, 1, ef_upper)


def hnsw_search(
    g: DeviceGraph,
    q: torch.Tensor,  # [B, D]
    qn: torch.Tensor,  # [B]
    ef: int,
    max_iters: Optional[int] = None,
    ef_upper: int = 1,
    cancel: Cancel = None,
) -> BeamResult:
    """Greedy descent from the entry points through layers L..1, then an
    ef-wide layer-0 beam (reference hnsw_search). ``ef_upper``: see
    ``_descend_start``. ``cancel`` is checked in the layer-0 beam, as the
    JAX package's ``hnsw_search_cancellable`` checks it between the
    beam's chunks (the descent runs whole); once it has returned True the
    result is the pool so far."""
    start = _descend_start(g, q, qn, ef_upper)
    return beam_search(g, q, qn, start, ef, max_iters, cancel=cancel)


def hnsw_search_filtered(
    g: DeviceGraph,
    q: torch.Tensor,  # [B, D]
    qn: torch.Tensor,  # [B]
    candidate_mask: torch.Tensor,  # [N_pad] bool
    ef: int,
    max_iters: Optional[int] = None,
    ef_upper: int = 1,
    cancel: Cancel = None,
) -> BeamResult:
    """``hnsw_search`` with a candidates filter: the descent ignores the
    mask (upper layers route, reader.rs:739-752), the layer-0 beam is
    ``beam_search_filtered``. ``cancel`` as in ``hnsw_search``."""
    start = _descend_start(g, q, qn, ef_upper)
    return beam_search_filtered(g, q, qn, start, ef, candidate_mask, max_iters, cancel=cancel)
