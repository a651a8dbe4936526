"""The search's loops as device programs: the Hopper kernels and their plain versions.

Counterpart of the JAX package's jitted ``hnsw_search``
(``hannoy_tpu/ops/beam.py``): there the greedy descent and the beams are
``lax.while_loop``s compiled into one device program, with the Pallas
gather-reduce inside each hop. ``csrc/search.cu`` holds two kernels that
run those loops on the card, one launch each for a whole batch:
``beam_search_kernel`` (one block per query, its pool in shared memory)
and ``greedy_descend_kernel``. Their distances are the gather kernel's own
bits (``csrc/row_distance.cuh``), so they equal the host loop of
``ops/beam.py`` exactly; the source's note says why running each row's
loop on its own gives the batch loop's pools.

``search_design_of`` is the fixed rule by which ``beam.beam_search`` and
``beam.greedy_descend`` choose: "kernel" for CUDA tensors of f32, bf16 or
int8 rows that the gather kernel's staged design serves, under cosine,
euclidean or manhattan, and of packed rows (the int32 lanes of hamming and
the binary quantized metrics) that its pair design serves, with one entry
expanded a hop, every link of a row and no tail allowance; "host" (the
host loop, unchanged) for everything else, CPU tensors and packed rows of
other widths among it. A launch that fails raises; nothing falls back.

``beam_search_rowwise`` and ``greedy_descend_rowwise`` are the kernels'
per-row algorithm in plain PyTorch (a loop over the rows; the first
unexpanded entry; the stable merge with the pool first), on any device.
Their distances go through ``beam_cuda.gathered_distances`` (the gather
kernel on CUDA tensors, its plain twin on CPU tensors) so that they can be
held to the kernels bit for bit, or with ``plain=True`` through
``beam_cuda.gathered_distances_plain`` on every device. Nothing on the
main path calls them.

The library is built at first use with ``nvcc`` for ``sm_90a`` into
``hannoy_tpu_torch/_build/`` (``beam_cuda.CudaLibrary``). ``KERNELS``
counts launches per kernel (``launches``), per kernel and level walked
(``by_level``) and per kernel and form (``by_form``: the gather kernel's
row type and family, ``beam_cuda.form_of``), and keeps each kernel's per-row counters of its last call
(``last``: hops or steps run, distances computed) for the bound of a
timing. A call with ``clocks=clock_buffer(B)`` records the cycles each
block's thread 0 spent in each stage of its hops (``STAGES``): the split
of a hop.

Each block of dense rows stages the rows of a hop in shared memory, a few
slots for each of its ``WARPS`` warps: ``beam_shared`` and
``greedy_shared`` size the buffer by one rule (``staged_rows``), which the
routing rule and the launches share. A block of packed rows stages
nothing: its threads load a hop's rows straight into registers, beside the
query's lanes held there, and the same two functions size its smaller
block.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Optional

import torch

from . import beam_cuda, distances
from .topk import INF, NO_ID

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "search.cu"
#: the kernels' names in ``KERNELS``' counts
BEAM, GREEDY = "beam_search", "greedy_descend"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: vectors, norms, n_rows, dim, links0, w0, upper, u_pad, wu, slot_rows, n_pad, node_ok, n_ok, n_levels, seen
_GRAPH = [_P, _P, _L, _I, _P, _I, _P, _L, _I, _P, _L, _P, _L, _L, _P]
#: warps a block of the kernels (``kWarps`` in the source)
WARPS = 8
#: the most candidates a hop or a step takes (``kMaxCap``): wider link rows take the host loop
MAX_CAP = 64
#: bytes of the per-stage clocks in a block's shared memory (``kClockBytes``)
CLOCK_BYTES = 208
#: the stages of a hop that ``clocks`` splits a launch into (``Stage`` in the source)
STAGES = ("entry", "links", "dedup", "rows", "reduce", "rank", "merge", "barriers")
#: the shared memory a block of the search kernels aims at: four blocks on
#: each of the H100's SMs (228 KB an SM, 1 KB of it kept for each block).
#: Chosen by phase 13's sweep (``chip_smoke.py --search-only``, PERF.md §6):
#: at the 1M layer-0 beam 16 rows of 768 f32 (this budget) ran 2% faster
#: than 32 (two blocks an SM), and a batch of 4096 seeds the same
BLOCK_BUDGET = 56 * 1024


def _bind(lib) -> None:
    lib.search_beam.argtypes = _GRAPH + [_P, _P, _I, _P, _I, _I, _I, _I, _I, _L, _I, _I] + [_P] * 7 + [_I, _I, _I, _P]
    lib.search_beam.restype = ctypes.c_int
    lib.search_greedy.argtypes = _GRAPH + [_P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _L] + [_P] * 6 + [_I, _I, _I, _P]
    lib.search_greedy.restype = ctypes.c_int


class SearchKernels(beam_cuda.CudaLibrary):
    """The search library and its launch counts."""

    def __init__(self) -> None:
        super().__init__(SOURCE, _bind)
        self.launches: dict[str, int] = {}
        self.by_level: dict[tuple[str, int], int] = {}
        self.by_form: dict[tuple[str, str, str], int] = {}
        #: per kernel, its last call's per-row counters and widths
        self.last: dict[str, dict] = {}

    def reset_counts(self) -> None:
        self.launches = {}
        self.by_level = {}
        self.by_form = {}

    def count(self, name: str, levels, form: tuple[str, str]) -> None:
        self.launches[name] = self.launches.get(name, 0) + 1
        for level in levels:
            self.by_level[(name, level)] = self.by_level.get((name, level), 0) + 1
        key = (name, *form)
        self.by_form[key] = self.by_form.get(key, 0) + 1


KERNELS = SearchKernels()


def staged_rows(row_bytes: int, fixed: int, width: int) -> int:
    """The staging buffer's rows (``WARPS`` x the slots a warp has): a
    slot for each of a warp's share of ``width`` candidates, as many as fit
    ``BLOCK_BUDGET`` beside the ``fixed`` bytes of the rest of the block
    (at least one a warp); a warp with more rows than slots takes them in
    rounds."""
    share = -(-max(width, 1) // WARPS)
    fit = (BLOCK_BUDGET - fixed) // (WARPS * row_bytes)
    return WARPS * max(1, min(share, fit))


def beam_shared(dim: int, row_bytes: int, ef: int, width: int, packed: bool = False) -> tuple[int, int, int]:
    """``beam_search_kernel``'s candidates a hop (``width`` link columns
    in whole warps), staging rows (``staged_rows``) and the bytes of shared
    memory its block takes, in the layout the kernel carves (``beam_bytes``
    in the source): the query (``dim`` f32), the staging rows of
    ``row_bytes``, the clocks, two pools of ``ef`` (distance, id,
    expanded; ef padded to 4), the hop's distances and ids, the warps'
    finds in the pool → (cap, rows, bytes). ``packed`` rows keep the query
    in registers and stage nothing: no query, 0 rows. The routing rule and
    the launch both size the block by it."""
    cap = (max(width, 1) + 31) // 32 * 32
    fixed = (0 if packed else 4 * dim) + CLOCK_BYTES + 24 * (-(-ef // 4) * 4) + 8 * cap + 8 * WARPS
    rows = 0 if packed else staged_rows(row_bytes, fixed, width)
    return cap, rows, fixed + rows * row_bytes


def greedy_shared(dim: int, row_bytes: int, width: int, packed: bool = False) -> tuple[int, int]:
    """``greedy_descend_kernel``'s staging rows for link rows of ``width``
    columns and the bytes of shared memory its block takes (``greedy_bytes``
    in the source: the query, the staging rows, the clocks, two buffers of
    ``MAX_CAP`` distances; ``packed`` rows: neither query nor rows) →
    (rows, bytes)."""
    fixed = (0 if packed else 4 * dim) + CLOCK_BYTES + 8 * MAX_CAP
    rows = 0 if packed else staged_rows(row_bytes, fixed, width)
    return rows, fixed + rows * row_bytes


def _rows_in_scope(metric: distances.Metric, dtype: torch.dtype) -> bool:
    """Whether the kernels take rows of ``dtype`` under ``metric``: int32
    lanes for a packed metric, a row type of ``beam_cuda.ROW_TYPES`` for
    the others. The routing rule and the launches' checks both ask it."""
    return dtype == torch.int32 if metric.is_packed else dtype in beam_cuda.ROW_TYPES


def search_design_of(
    device_type: str,
    row_dtype: torch.dtype,
    metric: distances.Metric,
    dim: int,
    aligned: bool,
    expand: int = 1,
    traverse_k: Optional[int] = None,
    tail_allow: int = 0,
    ef: int = 1,
    width: int = 0,
) -> str:
    """How a search loop runs → "kernel" or "host". The kernels take CUDA
    tensors of f32, bf16 or int8 rows that the gather kernel's staged
    design serves, and of packed rows (int32 lanes of hamming or a binary
    quantized metric, ``dim`` lanes) that its pair design serves.
    ``aligned``: the rows start at a 16-byte aligned address;
    ``traverse_k``: the links a hop reads where that cuts the row (None:
    the whole row); ``width`` (link columns) may not pass ``MAX_CAP``;
    ``ef`` and ``width`` size a beam's shared memory (``beam_shared``),
    which must fit the block's (``beam_cuda.STAGED_SMEM``)."""
    if device_type != "cuda" or not _rows_in_scope(metric, row_dtype):
        return "host"
    if beam_cuda.design_of(row_dtype, metric, dim, aligned) != ("pair" if metric.is_packed else "staged"):
        return "host"
    if expand != 1 or traverse_k is not None or tail_allow != 0 or width > MAX_CAP:
        return "host"
    if beam_shared(dim, dim * row_dtype.itemsize, ef, width, metric.is_packed)[2] > beam_cuda.STAGED_SMEM:
        return "host"
    return "kernel"


def seen_buffer(g) -> torch.Tensor:
    """Zeroed marks for a launch that records what it reads (``seen=`` of
    the wrappers): a byte per store row, layer-0 link row, upper link row
    and slot-row entry, in the order of ``mark()`` in the source."""
    levels, n_pad = g.upper_links.shape[0], g.slot_rows.shape[-1]
    n = g.vectors.shape[0] + n_pad * (1 + levels) + levels * g.upper_links.shape[1]
    return torch.zeros((n,), dtype=torch.uint8, device=g.vectors.device)


def clock_buffer(batch: int, device) -> torch.Tensor:
    """Zeroed per-block clocks for a launch that splits its time (``clocks=``
    of the wrappers): [batch, len(STAGES)] int64 cycles, added to."""
    return torch.zeros((batch, len(STAGES)), dtype=torch.int64, device=device)


def seen_counts(g, seen: torch.Tensor) -> dict[str, int]:
    """The distinct things a marked launch read → {"rows": store rows,
    "links0": layer-0 link rows, "upper": upper link rows, "slot_rows":
    slot-row entries}."""
    levels, n_pad, u_pad = g.upper_links.shape[0], g.slot_rows.shape[-1], g.upper_links.shape[1]
    parts = torch.split(seen, [g.vectors.shape[0], n_pad, levels * u_pad, levels * n_pad])
    return {name: int(p.sum()) for name, p in zip(("rows", "links0", "upper", "slot_rows"), parts)}


def _graph_args(g, node_ok: torch.Tensor, seen: Optional[torch.Tensor] = None) -> tuple:
    """The graph's C arguments (``GRAPH_PARAMS`` of the source); ``seen``:
    ``seen_buffer(g)`` for a launch that marks what it reads."""
    vectors, norms = g.vectors, g.norms
    upper, slot_rows = g.upper_links.contiguous(), g.slot_rows.contiguous()
    ok = node_ok.contiguous().view(torch.uint8)
    links0 = g.links0.contiguous()
    for name, t, dtype in (("norms", norms, torch.float32), ("links0", links0, torch.int32),
                           ("upper_links", upper, torch.int32), ("slot_rows", slot_rows, torch.int32)):
        if t.dtype != dtype:
            raise TypeError(f"search kernels: {name} must be {dtype}, got {t.dtype}")
    if not (vectors.is_contiguous() and norms.is_contiguous()):
        raise ValueError("search kernels: the store's rows and norms must be contiguous")
    if seen is not None and (seen.dtype != torch.uint8 or seen.shape != seen_buffer(g).shape
                             or links0.shape[0] > slot_rows.shape[-1]):
        raise ValueError("search kernels: seen must be seen_buffer(g)")
    keep = (upper, slot_rows, ok, links0)  # alive until the launch has been issued
    return keep, (
        vectors.data_ptr(), norms.data_ptr(), vectors.shape[0], vectors.shape[1],
        links0.data_ptr(), links0.shape[1],
        upper.data_ptr(), upper.shape[1] if upper.dim() == 3 else 0, upper.shape[-1],
        slot_rows.data_ptr(), slot_rows.shape[-1], ok.data_ptr(), ok.shape[0], upper.shape[0],
        seen.data_ptr() if seen is not None else None,
    )


def _form(g) -> tuple[int, int, int]:
    """(metric id, row-type id, scale_rows) of the graph's rows."""
    metric, dtype = g.metric, g.vectors.dtype
    if not _rows_in_scope(metric, dtype):
        raise TypeError(f"search kernels: {metric.name} on rows of {dtype} is out of their scope")
    if metric.is_packed:
        return beam_cuda.METRIC_IDS[metric.name], beam_cuda.PACKED_ROWS[1], 0
    scale_rows = dtype == torch.int8 and metric.name != "cosine"
    return beam_cuda.METRIC_IDS[metric.name], beam_cuda.ROW_TYPES[dtype][1], int(scale_rows)


def _query(g, q: torch.Tensor, qn: torch.Tensor) -> torch.Tensor:
    """The one query form the kernels take (``beam_cuda._canonical_query``),
    contiguous: f32, or for packed rows their int32 lanes."""
    qf = beam_cuda._canonical_query(g.metric, g.vectors, q, qn).contiguous()
    if g.metric.is_packed and not _rows_in_scope(g.metric, qf.dtype):
        raise TypeError(f"search kernels: {g.metric.name} takes queries of int32 lanes, got {qf.dtype}")
    return qf


def _check_devices(g, *tensors: torch.Tensor) -> torch.device:
    dev = g.vectors.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"search kernels: tensors on {[str(t.device) for t in (g.vectors, *tensors)]}, one CUDA device expected")
    return dev


def _check_clocks(clocks: Optional[torch.Tensor], batch: int, dev: torch.device) -> None:
    if clocks is not None and (clocks.dtype != torch.int64 or clocks.shape != (batch, len(STAGES))
                               or clocks.device != dev or not clocks.is_contiguous()):
        raise ValueError("search kernels: clocks must be clock_buffer(B) on the graph's device")


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel did not launch: CUDA error {rc}")


def beam_search_kernel(
    g,
    q: torch.Tensor,  # [B, D]
    qn: torch.Tensor,  # [B]
    start: torch.Tensor,  # [B, S] seed slots (-1 padded)
    ef: int,
    max_iters: int,
    node_ok: torch.Tensor,
    level: int = 0,
    cancel: Optional[Callable[[], bool]] = None,
    chunk: int = 8,
    seen: Optional[torch.Tensor] = None,
    clocks: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``beam.beam_search`` (one entry a hop, the whole row, no tail) by
    ``beam_search_kernel`` → (dists [B, ef], slots [B, ef], iters [] int32,
    active [B] bool). Without ``cancel`` one launch runs every row to its
    end; with one, a launch seeds the pool and each further launch runs at
    most ``chunk`` hops a row, the pool carried in device memory, with
    ``cancel`` called before each while a row is active (True ends it).
    ``seen``: ``seen_buffer(g)``, marked with what the launches read;
    ``clocks``: ``clock_buffer(B)``, added the cycles of each stage."""
    dev = _check_devices(g, q, qn, start, node_ok)
    metric_id, row_id, scale_rows = _form(g)
    form = beam_cuda.form_of(g.metric, g.vectors.dtype)
    B = q.shape[0]
    qf = _query(g, q, qn)
    qn32 = qn.to(torch.float32).contiguous()
    seeds = start.to(torch.int32).contiguous()
    if qf.shape != (B, g.vectors.shape[1]) or qn32.shape != (B,) or seeds.dim() != 2 or seeds.shape[0] != B:
        raise ValueError(f"beam_search_kernel: q {tuple(q.shape)} qn {tuple(qn.shape)} start {tuple(start.shape)}")
    pool_d = torch.empty((B, ef), dtype=torch.float32, device=dev)
    pool_id = torch.empty((B, ef), dtype=torch.int32, device=dev)
    pool_exp = torch.empty((B, ef), dtype=torch.int32, device=dev)
    hops = torch.zeros((B,), dtype=torch.int32, device=dev)
    n_dist = torch.zeros((B,), dtype=torch.int32, device=dev)
    active = torch.zeros((B,), dtype=torch.uint8, device=dev)
    width = g.links0.shape[1] if level == 0 else g.upper_links.shape[-1]
    KERNELS.last[BEAM] = {"hops": hops, "n_dist": n_dist, "batch": B, "ef": ef, "level": level, "width": width,
                          "n_start": seeds.shape[1], "dim": g.vectors.shape[1],
                          "row_bytes": g.vectors.shape[1] * g.vectors.element_size()}
    if B == 0:
        return pool_d, pool_id, torch.zeros((), dtype=torch.int32, device=dev), active.bool()
    keep, graph = _graph_args(g, node_ok, seen)
    _check_clocks(clocks, B, dev)
    cap, rows, smem = beam_shared(g.vectors.shape[1], g.vectors.shape[1] * g.vectors.element_size(), ef, width,
                                  g.metric.is_packed)
    lib = KERNELS.load()

    def launch(budget: int, seeded: int) -> None:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.search_beam(
                *graph, qf.data_ptr(), qn32.data_ptr(), B, seeds.data_ptr(), seeds.shape[1], level, ef, cap, rows,
                smem, budget, seeded, pool_d.data_ptr(), pool_id.data_ptr(), pool_exp.data_ptr(), hops.data_ptr(),
                n_dist.data_ptr(), active.data_ptr(), _ptr(clocks), metric_id, row_id, scale_rows, stream,
            )
        _raise_on(rc, BEAM)
        KERNELS.count(BEAM, (level,), form)

    if cancel is None:
        launch(max_iters, 0)
    else:
        launch(0, 0)
        done = 0
        while done < max_iters:
            if not bool(active.any()) or cancel():
                break
            launch(min(chunk, max_iters - done), 1)
            done += chunk
    del keep
    return pool_d, pool_id, hops.max(), active.bool()


def greedy_descend_kernel(
    g,
    q: torch.Tensor,  # [B, D]
    qn: torch.Tensor,  # [B]
    from_level: int,
    to_level: int,
    max_steps_per_level: int,
    node_ok: torch.Tensor,
    cancel: Optional[Callable[[], bool]] = None,
    chunk: int = 8,
    seen: Optional[torch.Tensor] = None,
    clocks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``beam.greedy_descend`` by ``greedy_descend_kernel`` → the slot a
    query ends on [B] int32. Without ``cancel`` one launch walks every
    level; with one, a launch starts from the entry points and each level
    runs in launches of at most ``chunk`` steps a row, ``cancel`` called
    before each while a row still improves (True ends that level).
    ``seen``: ``seen_buffer(g)``, marked with what the launches read;
    ``clocks``: ``clock_buffer(B)``, added the cycles of each stage."""
    dev = _check_devices(g, q, qn, node_ok)
    metric_id, row_id, scale_rows = _form(g)
    form = beam_cuda.form_of(g.metric, g.vectors.dtype)
    B = q.shape[0]
    qf = _query(g, q, qn)
    qn32 = qn.to(torch.float32).contiguous()
    entry = g.entry_slots.to(torch.int32).contiguous()
    cur = torch.empty((B,), dtype=torch.int32, device=dev)
    cur_d = torch.empty((B,), dtype=torch.float32, device=dev)
    improved = torch.ones((B,), dtype=torch.uint8, device=dev)
    steps = torch.zeros((B,), dtype=torch.int32, device=dev)
    n_dist = torch.zeros((B,), dtype=torch.int32, device=dev)
    KERNELS.last[GREEDY] = {"hops": steps, "n_dist": n_dist, "batch": B, "width": g.upper_links.shape[-1],
                            "n_entry": entry.shape[0], "dim": g.vectors.shape[1],
                            "row_bytes": g.vectors.shape[1] * g.vectors.element_size()}
    if B == 0:
        return cur
    keep, graph = _graph_args(g, node_ok, seen)
    _check_clocks(clocks, B, dev)
    rows, smem = greedy_shared(g.vectors.shape[1], g.vectors.shape[1] * g.vectors.element_size(),
                               g.upper_links.shape[-1], g.metric.is_packed)
    lib = KERNELS.load()

    def launch(top: int, bottom: int, budget: int, init: int) -> None:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.search_greedy(
                *graph, qf.data_ptr(), qn32.data_ptr(), B, entry.data_ptr(), entry.shape[0], top, bottom, budget,
                init, rows, smem, cur.data_ptr(), cur_d.data_ptr(), improved.data_ptr(), steps.data_ptr(),
                n_dist.data_ptr(), _ptr(clocks), metric_id, row_id, scale_rows, stream,
            )
        _raise_on(rc, GREEDY)
        KERNELS.count(GREEDY, range(top, bottom - 1, -1), form)

    if cancel is None:
        launch(from_level, to_level, max_steps_per_level, 1)
    else:
        launch(0, 1, 0, 1)  # the entry points alone
        for level in range(from_level, to_level - 1, -1):
            improved.fill_(1)
            done = 0
            while done < max_steps_per_level:
                if not bool(improved.any()) or cancel():
                    break
                launch(level, level, min(chunk, max_steps_per_level - done), 0)
                done += chunk
    del keep
    return cur


# --------------------------------------------------------------------------
# The plain versions: the kernels' per-row algorithm in PyTorch
# --------------------------------------------------------------------------


class _Row:
    """One query's view of the graph for the plain versions: the link
    tables and ``node_ok`` copied to the host once (the pool and every
    decision of a row live there), the distances computed on the graph's
    device by the gather function and brought back."""

    def __init__(self, g, node_ok: torch.Tensor, plain: bool) -> None:
        self.g = g
        self.links0 = g.links0.cpu()
        self.upper = g.upper_links.cpu()
        self.slot_rows = g.slot_rows.cpu()
        self.node_ok = node_ok.cpu()
        self.fn = beam_cuda.gathered_distances_plain if plain else beam_cuda.gathered_distances

    def distances(self, q: torch.Tensor, qn: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """From one query (``q`` [1, D], ``qn`` [1] on the device) to the
        host's ``ids`` [K] (-1 read as row 0) → [K] on the host."""
        g = self.g
        idx = ids.to(device=g.vectors.device, dtype=torch.int32)[None].contiguous()
        return self.fn(g.metric, g.vectors, g.norms, q, qn, idx)[0].cpu()

    def links(self, level: int, slot: int) -> torch.Tensor:
        """The link row of a slot at ``level`` (-1 where it has none)."""
        width = self.links0.shape[1] if level == 0 else self.upper.shape[-1]
        if slot < 0:
            return torch.full((width,), NO_ID, dtype=torch.int32)
        if level == 0:
            return self.links0[slot]
        row = int(self.slot_rows[level - 1][slot])
        return self.upper[level - 1][row] if row >= 0 else torch.full((width,), NO_ID, dtype=torch.int32)

    def ok(self, ids: torch.Tensor) -> torch.Tensor:
        return (ids >= 0) & self.node_ok[ids.clamp(min=0).long()]


def _admit(view: _Row, q, qn, ids, pool, seeds: bool):
    """Merge the candidates ``ids`` [K] into one row's pool (d, id, exp):
    keep an id >= 0, node_ok, first of its value among ``ids`` and not in
    the pool; its distance; the candidates in (distance, position) order;
    each entry placed at its position plus the other list's entries before
    it, the pool's first on ties; the first ef kept → (pool, distances
    computed)."""
    pool_d, pool_id, pool_exp = pool
    ef, k = pool_d.shape[0], ids.shape[0]
    ids = ids.to(torch.int32)
    ok = view.ok(ids)
    earlier = torch.ones(k, k, dtype=torch.bool).tril(-1)
    ok &= ~((ids[:, None] == ids[None, :]) & earlier).any(1)
    ok &= ~(ids[:, None] == pool_id[None, :]).any(1)
    d = torch.where(ok, view.distances(q, qn, ids), INF)
    kept = torch.where(ok, ids, NO_ID)
    if seeds:
        kept = torch.where(d < INF, kept, NO_ID)
    sd, order = torch.sort(d, stable=True)
    sid = kept[order]
    # new_first[r, j]: candidate r comes before pool entry j in torch.sort's
    # order (NaN last), as the kernel's count_lt / count_le compare them
    nan_sd, nan_pool = torch.isnan(sd)[:, None], torch.isnan(pool_d)[None, :]
    new_first = (sd[:, None] < pool_d[None, :]) | (nan_pool & ~nan_sd)
    at_pool = torch.arange(ef) + new_first.sum(0)
    at_new = torch.arange(k) + (~new_first).sum(1)
    out_d = torch.empty(ef + k, dtype=pool_d.dtype)
    out_id = torch.empty(ef + k, dtype=torch.int32)
    out_exp = torch.empty(ef + k, dtype=torch.int32)
    out_d[at_pool], out_id[at_pool], out_exp[at_pool] = pool_d, pool_id, pool_exp
    out_d[at_new], out_id[at_new], out_exp[at_new] = sd, sid, torch.zeros_like(sid)
    return (out_d[:ef], out_id[:ef], out_exp[:ef]), int(ok.sum())


def _row_active(pool) -> tuple[int, bool]:
    """The pool's first unexpanded entry → (its position, whether the row
    is active: its distance <= the pool's last and finite)."""
    pool_d, pool_id, pool_exp = pool
    unexp = ((pool_exp == 0) & (pool_id != NO_ID)).nonzero()
    first = int(unexp[0, 0]) if unexp.numel() else 0
    exp_d = float(pool_d[first]) if unexp.numel() else INF
    return first, exp_d <= float(pool_d[-1]) and exp_d < INF


def beam_search_rowwise(
    g,
    q: torch.Tensor,  # [B, D]
    qn: torch.Tensor,  # [B]
    start: torch.Tensor,  # [B, S]
    ef: int,
    max_iters: Optional[int] = None,
    node_ok: Optional[torch.Tensor] = None,
    level: int = 0,
    plain: bool = False,
):
    """``beam_search_kernel``'s algorithm, one row after another →
    (``beam.BeamResult`` on the queries' device, ``iters`` the most hops a
    row ran; the distances each row computed [B]). ``plain``: distances by
    the plain twin on every device."""
    from .beam import BeamResult

    if max_iters is None:
        max_iters = 2 * ef + 16
    view = _Row(g, g.valid if node_ok is None else node_ok, plain)
    B = q.shape[0]
    out_d = torch.full((B, ef), INF)
    out_id = torch.full((B, ef), NO_ID, dtype=torch.int32)
    seeds = start.cpu()
    hops, active, n_dist = [], [], []
    for b in range(B):
        qb, qnb = q[b : b + 1], qn[b : b + 1]
        pool = (torch.full((ef,), INF), torch.full((ef,), NO_ID, dtype=torch.int32), torch.zeros((ef,), dtype=torch.int32))
        pool, count = _admit(view, qb, qnb, seeds[b], pool, True)
        h = 0
        while True:
            first, act = _row_active(pool)
            if not act or h == max_iters:
                break
            slot = int(pool[1][first])
            pool[2][first] = 1
            pool, n = _admit(view, qb, qnb, view.links(level, slot), pool, False)
            count += n
            h += 1
        out_d[b], out_id[b] = pool[0], pool[1]
        hops.append(h)
        active.append(act)
        n_dist.append(count)
    dev = q.device
    res = BeamResult(out_d.to(dev), out_id.to(dev), torch.tensor(max(hops, default=0), dtype=torch.int32, device=dev),
                     torch.tensor(active, dtype=torch.bool, device=dev))
    return res, torch.tensor(n_dist, dtype=torch.int32)


def greedy_descend_rowwise(
    g,
    q: torch.Tensor,  # [B, D]
    qn: torch.Tensor,  # [B]
    from_level: int,
    to_level: int,
    max_steps_per_level: int = 128,
    node_ok: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> torch.Tensor:
    """``greedy_descend_kernel``'s algorithm, one row after another → the
    slot each query ends on [B] int32, on the queries' device."""
    view = _Row(g, g.valid if node_ok is None else node_ok, plain)
    eps = g.entry_slots.to(torch.int32).cpu()
    out = torch.empty((q.shape[0],), dtype=torch.int32)
    for b in range(q.shape[0]):
        qb, qnb = q[b : b + 1], qn[b : b + 1]
        d = torch.where(view.ok(eps), view.distances(qb, qnb, eps), INF)
        best = int(d.argmin())
        cur, cur_d = int(eps[best]), d[best]
        for level in range(from_level, to_level - 1, -1):
            for _ in range(max_steps_per_level):
                links = view.links(level, cur)
                d = torch.where(view.ok(links), view.distances(qb, qnb, links), INF)
                best = int(d.argmin())
                if not bool(d[best] < cur_d):
                    cur_d = torch.minimum(cur_d, d[best])  # a NaN stays, as in the host loop
                    break
                cur, cur_d = int(links[best]), d[best]
        out[b] = cur
    return out.to(q.device)


def hnsw_search_rowwise(g, q: torch.Tensor, qn: torch.Tensor, ef: int, max_iters: Optional[int] = None,
                        ef_upper: int = 1, plain: bool = False):
    """``beam.hnsw_search`` composed of the plain versions, as the kernels
    compose it: the greedy descent through layers L..1 (L..2 and an
    ``ef_upper``-wide layer-1 beam where ``ef_upper`` > 1), then the
    ef-wide layer-0 beam → ``beam.BeamResult``."""
    B = q.shape[0]
    if g.max_level < 1:
        start = g.entry_slots[None, :].expand(B, -1)
    elif ef_upper <= 1:
        start = greedy_descend_rowwise(g, q, qn, g.max_level, 1, plain=plain)[:, None]
    else:
        if g.max_level >= 2:
            start = greedy_descend_rowwise(g, q, qn, g.max_level, 2, plain=plain)[:, None]
        else:
            start = g.entry_slots[None, :].expand(B, -1)
        start = beam_search_rowwise(g, q, qn, start, ef_upper, level=1, plain=plain)[0].slots
    return beam_search_rowwise(g, q, qn, start, ef, max_iters, plain=plain)[0]
