"""Gather → distance for beam-search hops: the Hopper kernel and its twin.

Counterpart of ``hannoy_tpu/ops/beam_pallas.py``. The hot op of both
search and construction fetches, for each query, the rows of its current
candidates from the vector store and reduces them against the query.
``csrc/gather_distances.cu`` does that in one launch, epilogue included,
reading each candidate row once, for every row type of the package: f32,
the bf16 and int8 storage tiers, and the packed lanes of hamming and the
binary quantized metrics (the Pallas kernel takes f32 rows only; the JAX
package leaves the others to XLA). ``gathered_distances_plain`` is the
same function in plain PyTorch (a gather that materialises
``[B, K, D*]``, then ``distances.gathered_distances``).

``gathered_distances`` dispatches on where the tensors lie: CPU tensors
take the plain twin, CUDA tensors launch the kernel or raise. There is no
fallback from one to the other, nor from one kernel design to the other:
``design_of`` picks the design of each launch by a fixed rule ("staged"
for f32, bf16 and int8 rows that are whole 16-byte units from aligned
bases, "warp" for the other f32, bf16 and int8 launches; "pair" for
packed rows that are whole 16-byte units from aligned bases, "group" for
the other packed launches), and a launch the card refuses raises.

The kernel is built at first use with ``nvcc`` for ``sm_90a`` into
``hannoy_tpu_torch/_build/``, keyed by a hash of the source and of the
headers in ``csrc/`` (``row_distance.cuh`` holds the reduction of a row,
which ``csrc/search.cu`` shares), and loaded with ``ctypes``
(``CudaLibrary``, which ``search_cuda`` builds its library with too).
``KERNEL.launches`` counts the launches,
``KERNEL.by_shape`` counts them per ``(B, K)``, ``KERNEL.by_form`` per
form: ``(row type, family)`` with row type ``f32`` / ``bf16`` / ``int8`` /
``packed`` and family ``dot`` (cosine), ``difference`` (euclidean,
manhattan) or ``popcount`` (the packed metrics), and ``KERNEL.by_design``
per ``(row type, design)``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from . import distances

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "gather_distances.cu"
BUILD_DIR = _PKG / "_build"
METRIC_IDS = {
    "cosine": 0, "euclidean": 1, "manhattan": 2, "hamming": 3,
    "binary quantized cosine": 4, "binary quantized euclidean": 5, "binary quantized manhattan": 6,
}
#: device row type → (name, the kernel's row-type id)
ROW_TYPES = {torch.float32: ("f32", 0), torch.bfloat16: ("bf16", 1), torch.int8: ("int8", 2)}
PACKED_ROWS = ("packed", 3)
#: the kernel's designs and their ids in the C entry
DESIGN_IDS = {"warp": 0, "staged": 1, "group": 2, "pair": 3}
#: candidates per block of the staged design (``kTile`` in the source)
TILE = 32
#: dynamic shared memory a staged block may take: the H100's 227 KB a
#: block, less 1 KB for the kernel's static shared memory
STAGED_SMEM = 227 * 1024 - 1024
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the gather-distance kernel needs the CUDA toolkit")


class CudaLibrary:
    """A library of the port's CUDA kernels: one ``csrc/*.cu`` source built
    at first use with ``nvcc`` into ``BUILD_DIR``, keyed by a hash of that
    source and of every ``csrc/*.cuh`` header (so that a header edit
    rebuilds it), and loaded with ``ctypes``. ``bind`` sets the C entries'
    argument types on the loaded library."""

    def __init__(self, source: Path, bind) -> None:
        self.source = source
        self.bind = bind
        self.lib = None
        #: nvcc's output of the last build (``-Xptxas -v``), "" if cached
        self.build_log = ""
        self.build_seconds = 0.0

    def library_path(self) -> Path:
        digest = hashlib.sha256()
        for path in (self.source, *sorted(self.source.parent.glob("*.cuh"))):
            digest.update(path.name.encode())
            digest.update(path.read_bytes())
        return BUILD_DIR / f"{self.source.stem}_{digest.hexdigest()[:16]}.so"

    def start_build(self):
        """Start ``nvcc`` unless this version is already built → a handle
        for ``finish_build`` (None when there is nothing to wait for)."""
        so = self.library_path()
        if so.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        return proc, tmp, so, time.perf_counter()

    def finish_build(self, handle) -> Path:
        if handle is None:
            return self.library_path()
        proc, tmp, so, t0 = handle
        out, _ = proc.communicate()
        self.build_seconds = time.perf_counter() - t0
        self.build_log = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} ({proc.returncode}):\n{self.build_log}")
        os.replace(tmp, so)
        return so

    def build(self) -> Path:
        """Compile the source unless this version is already built."""
        return self.finish_build(self.start_build())

    def load(self):
        if self.lib is None:
            lib = ctypes.CDLL(str(self.build()))
            self.bind(lib)
            self.lib = lib
        return self.lib


def build_all(*libraries: CudaLibrary) -> list[Path]:
    """Build the libraries at once, one ``nvcc`` each, all started
    together → their paths."""
    handles = [lib.start_build() for lib in libraries]
    return [lib.finish_build(h) for lib, h in zip(libraries, handles)]


def _bind_gather(lib) -> None:
    fn = lib.gather_distances
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


class GatherKernel(CudaLibrary):
    """The gather-distance library and its launch counts."""

    def __init__(self) -> None:
        super().__init__(SOURCE, _bind_gather)
        self.launches = 0
        self.by_shape: dict[tuple[int, int], int] = {}
        self.by_form: dict[tuple[str, str], int] = {}
        self.by_design: dict[tuple[str, str], int] = {}

    def reset_counts(self) -> None:
        self.launches = 0
        self.by_shape = {}
        self.by_form = {}
        self.by_design = {}


KERNEL = GatherKernel()


def form_of(metric: distances.Metric, row_dtype: torch.dtype) -> tuple[str, str]:
    """The kernel form that serves ``metric`` on rows of ``row_dtype`` →
    (row type, family), the key of ``KERNEL.by_form``."""
    if metric.is_packed:
        return PACKED_ROWS[0], "popcount"
    return ROW_TYPES[row_dtype][0], "dot" if metric.name == "cosine" else "difference"


def design_of(row_dtype: torch.dtype, metric: distances.Metric, dim: int, aligned: bool) -> str:
    """The kernel design of a launch on rows of ``row_dtype`` and width
    ``dim`` under ``metric``; ``aligned``: the rows and the query start at
    16-byte aligned addresses. Packed rows (``dim`` 32-bit lanes): "pair"
    where they are whole 16-byte units (``dim % 4 == 0``) from aligned
    bases, "group" for the others. f32, bf16 and int8 rows: "staged" where
    they are whole 16-byte units from aligned bases and their tile
    (``TILE`` rows and the f32 query) fits ``STAGED_SMEM``; "warp" for the
    others."""
    if metric.is_packed:
        return "pair" if aligned and dim % 4 == 0 else "group"
    row_bytes = dim * row_dtype.itemsize
    staged = aligned and row_bytes % 16 == 0 and TILE * row_bytes + 4 * dim <= STAGED_SMEM
    return "staged" if staged else "warp"


def gathered_distances_plain(
    metric: distances.Metric,
    vectors: torch.Tensor,  # [N, D*]
    norms: torch.Tensor,  # [N]
    q: torch.Tensor,  # [B, D*]
    qn: torch.Tensor,  # [B]
    idx: torch.Tensor,  # [B, K] (-1 allowed; read as row 0, caller masks)
) -> torch.Tensor:
    """The plain PyTorch twin of the kernel → [B, K] float32. An index
    past the store (``idx >= N``) gives NaN, as the kernel does; this
    departs on purpose from the JAX package, whose XLA gather clamps such
    an index to row N-1 (no caller passes one)."""
    past = idx >= vectors.shape[0]
    safe = idx.clamp(min=0).masked_fill(past, 0).long()
    out = distances.gathered_distances(metric, q, qn, vectors[safe], norms[safe])
    return out.masked_fill(past, float("nan"))


def _canonical_query(metric: distances.Metric, vectors: torch.Tensor, q: torch.Tensor, qn: torch.Tensor) -> torch.Tensor:
    """The one query form the kernel takes for the rows' type: lanes for
    packed rows, else f32 — a query gathered from a tier store (a build)
    is upcast, and an int8 one of euclidean / manhattan dequantised by its
    scale ``qn`` (for cosine on bf16 rows the kernel rounds the query to
    bf16 values itself, as ``distances.gathered_distances`` does)."""
    if metric.is_packed:
        return q
    if vectors.dtype == torch.int8 and metric.name != "cosine":
        q = distances._deq(q, qn)
    return q.to(torch.float32).contiguous()


def gathered_distances(
    metric: distances.Metric,
    vectors: torch.Tensor,
    norms: torch.Tensor,
    q: torch.Tensor,
    qn: torch.Tensor,
    idx: torch.Tensor,
) -> torch.Tensor:
    """``distances.gathered_distances(metric, q, qn, vectors[idx], norms[idx])``
    with ``idx < 0`` read as row 0 and ``idx >= N`` giving NaN → [B, K]
    float32, for f32, bf16, int8 and packed (int32 lanes) rows. CPU tensors
    run the plain twin; CUDA tensors launch the kernel or raise."""
    tensors = (vectors, norms, q, qn, idx)
    if all(t.device.type == "cpu" for t in tensors):
        return gathered_distances_plain(metric, vectors, norms, q, qn, idx)
    dev = vectors.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"gathered_distances: tensors on mixed devices {[str(t.device) for t in tensors]}")
    if metric.is_packed:
        _, row_id = PACKED_ROWS
        row_ok, q_ok = vectors.dtype == torch.int32, q.dtype == torch.int32
    else:
        _, row_id = ROW_TYPES.get(vectors.dtype, ("", -1))
        row_ok, q_ok = row_id >= 0, q.dtype in (torch.float32, vectors.dtype)
    if not (row_ok and q_ok):
        raise TypeError(
            f"gathered_distances: {metric.name} does not take rows of {vectors.dtype} with queries of {q.dtype}"
        )
    for t, want in ((norms, torch.float32), (qn, torch.float32), (idx, torch.int32)):
        if t.dtype != want:
            raise TypeError(f"gathered_distances: expected {want}, got {t.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gathered_distances: inputs must be contiguous")
    if vectors.dim() != 2 or q.dim() != 2 or idx.dim() != 2:
        raise ValueError("gathered_distances: vectors [N,D], q [B,D], idx [B,K] expected")
    n, d = vectors.shape
    b, k = idx.shape
    if q.shape != (b, d) or norms.shape != (n,) or qn.shape != (b,):
        raise ValueError(
            f"gathered_distances: shape mismatch vectors {tuple(vectors.shape)} norms "
            f"{tuple(norms.shape)} q {tuple(q.shape)} qn {tuple(qn.shape)} idx {tuple(idx.shape)}"
        )
    out = torch.empty((b, k), dtype=torch.float32, device=dev)
    if b * k == 0:
        return out
    q = _canonical_query(metric, vectors, q, qn)
    # 16-byte loads and asynchronous copies need whole rows of them and aligned bases
    aligned = vectors.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0
    vec = (d * vectors.element_size()) % 16 == 0 and aligned
    scale_rows = vectors.dtype == torch.int8 and metric.name != "cosine"
    design = design_of(vectors.dtype, metric, d, aligned)
    lib = KERNEL.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gather_distances(
            vectors.data_ptr(), norms.data_ptr(), q.data_ptr(), qn.data_ptr(),
            idx.data_ptr(), out.data_ptr(), n, d, b, k, METRIC_IDS[metric.name], row_id,
            int(vec), int(scale_rows), DESIGN_IDS[design], stream,
        )
    if rc != 0:
        raise RuntimeError(f"gather_distances kernel ({design} design) did not launch: CUDA error {rc}")
    KERNEL.launches += 1
    KERNEL.by_shape[(b, k)] = KERNEL.by_shape.get((b, k), 0) + 1
    form = form_of(metric, vectors.dtype)
    KERNEL.by_form[form] = KERNEL.by_form.get(form, 0) + 1
    KERNEL.by_design[(form[0], design)] = KERNEL.by_design.get((form[0], design), 0) + 1
    return out
