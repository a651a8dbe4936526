"""Gather → distance for beam-search hops: the Hopper kernel and its twin.

Counterpart of ``hannoy_tpu/ops/beam_pallas.py``. The hot op of both
search and construction fetches, for each query, the rows of its current
candidates from the vector store and reduces them against the query.
``csrc/gather_distances.cu`` does that in one launch, cosine epilogue
included, reading each candidate row once; ``gathered_distances_plain``
is the same function in plain PyTorch (a gather that materialises
``[B, K, D]``, then ``distances.gathered_distances``).

``gathered_distances`` dispatches on where the tensors lie: CPU tensors
take the plain twin, CUDA tensors launch the kernel or raise. There is no
fallback from one to the other.

The kernel is built at first use with ``nvcc`` for ``sm_90a`` into
``hannoy_tpu_torch/_build/``, keyed by a hash of the source, and loaded
with ``ctypes``. ``KERNEL.launches`` counts the launches.
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
METRIC_IDS = {"cosine": 0, "euclidean": 1, "manhattan": 2}
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


class GatherKernel:
    """The compiled library, loaded once, and its launch count."""

    def __init__(self) -> None:
        self.lib = None
        self.launches = 0
        #: nvcc's output of the last build (``-Xptxas -v``), "" if cached
        self.build_log = ""
        self.build_seconds = 0.0

    def library_path(self) -> Path:
        digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
        return BUILD_DIR / f"gather_distances_{digest}.so"

    def build(self) -> Path:
        """Compile the source unless this version is already built."""
        so = self.library_path()
        if so.exists():
            return so
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        t0 = time.perf_counter()
        res = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        self.build_seconds = time.perf_counter() - t0
        self.build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{self.build_log}")
        os.replace(tmp, so)
        return so

    def load(self):
        if self.lib is None:
            lib = ctypes.CDLL(str(self.build()))
            fn = lib.gather_distances
            fn.argtypes = [ctypes.c_void_p] * 6 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            self.lib = lib
        return self.lib


KERNEL = GatherKernel()


def gathered_distances_plain(
    metric: distances.Metric,
    vectors: torch.Tensor,  # [N, D]
    norms: torch.Tensor,  # [N]
    q: torch.Tensor,  # [B, D]
    qn: torch.Tensor,  # [B]
    idx: torch.Tensor,  # [B, K] (-1 allowed; clamped, caller masks)
) -> torch.Tensor:
    """The plain PyTorch twin of the kernel → [B, K] float32."""
    safe = idx.clamp(min=0).long()
    return distances.gathered_distances(metric, q, qn, vectors[safe], norms[safe])


def gathered_distances(
    metric: distances.Metric,
    vectors: torch.Tensor,
    norms: torch.Tensor,
    q: torch.Tensor,
    qn: torch.Tensor,
    idx: torch.Tensor,
) -> torch.Tensor:
    """``distances.gathered_distances(metric, q, qn, vectors[idx], norms[idx])``
    with ``idx < 0`` read as row 0 → [B, K] float32. CPU tensors run the
    plain twin; CUDA tensors launch the kernel."""
    tensors = (vectors, norms, q, qn, idx)
    if all(t.device.type == "cpu" for t in tensors):
        return gathered_distances_plain(metric, vectors, norms, q, qn, idx)
    name = distances.check_supported(metric)
    dev = vectors.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"gathered_distances: tensors on mixed devices {[str(t.device) for t in tensors]}")
    for t, want in zip(tensors, (torch.float32,) * 4 + (torch.int32,)):
        if t.dtype != want:
            raise TypeError(f"gathered_distances: expected {want}, got {t.dtype}")
        if not t.is_contiguous():
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
    vec4 = d % 4 == 0 and vectors.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0
    out = torch.empty((b, k), dtype=torch.float32, device=dev)
    if b * k == 0:
        return out
    lib = KERNEL.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gather_distances(
            vectors.data_ptr(), norms.data_ptr(), q.data_ptr(), qn.data_ptr(),
            idx.data_ptr(), out.data_ptr(), n, d, b, k, METRIC_IDS[name], int(vec4), stream,
        )
    if rc != 0:
        raise RuntimeError(f"gather_distances kernel launch failed: CUDA error {rc}")
    KERNEL.launches += 1
    return out
