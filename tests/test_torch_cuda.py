"""The hand-written CUDA gather-distance kernel and the port's build on a
CUDA device. Marked ``cuda``: without a card every test skips. On a
machine with one (and without JAX, so without ``tests/conftest.py``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the kernel sums each row in another order than the twin, so
cosine agrees to atol 1e-5 and sqL2/L1 to rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from hannoy_tpu_torch.build import builder
from hannoy_tpu_torch.models import hnsw
from hannoy_tpu_torch.ops import beam, beam_cuda, distances

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, n, d, b, k, name):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    nrm = distances.np_norms(distances.by_name(name), x)
    q = rng.standard_normal((b, d)).astype(np.float32)
    qn = distances.np_norms(distances.by_name(name), q)
    idx = rng.integers(0, n, (b, k)).astype(np.int32)
    idx[rng.random((b, k)) < 0.05] = -1
    return [torch.from_numpy(a) for a in (x, nrm, q, qn, idx)]


@pytest.mark.parametrize("dim", [768, 130, 37])
@pytest.mark.parametrize("name", ["cosine", "euclidean", "manhattan"])
def test_kernel_matches_twin(cuda, name, dim):
    metric = distances.by_name(name)
    x, nrm, q, qn, idx = (t.to(cuda) for t in _inputs(11, 3000, dim, 67, 29, name))
    before = beam_cuda.KERNEL.launches
    got = beam_cuda.gathered_distances(metric, x, nrm, q, qn, idx)
    torch.cuda.synchronize()
    assert beam_cuda.KERNEL.launches == before + 1
    want = beam_cuda.gathered_distances_plain(metric, x, nrm, q, qn, idx)
    tol = dict(rtol=0, atol=1e-5) if name == "cosine" else dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, want, **tol)


def test_kernel_marks_out_of_range_rows_nan(cuda):
    x, nrm, q, qn, idx = (t.to(cuda) for t in _inputs(12, 100, 64, 4, 8, "cosine"))
    idx[1, 3] = 100
    got = beam_cuda.gathered_distances(distances.COSINE, x, nrm, q, qn, idx)
    assert torch.isnan(got[1, 3]) and int(torch.isnan(got).sum()) == 1


def test_kernel_wrapper_rejects_what_it_cannot_take(cuda):
    x, nrm, q, qn, idx = (t.to(cuda) for t in _inputs(13, 100, 64, 4, 8, "cosine"))
    with pytest.raises(ValueError):
        beam_cuda.gathered_distances(distances.COSINE, x, nrm, q, qn, idx.t())
    with pytest.raises(TypeError):
        beam_cuda.gathered_distances(distances.COSINE, x, nrm, q, qn, idx.long())
    with pytest.raises(NotImplementedError):
        beam_cuda.gathered_distances(distances.HAMMING, x, nrm, q, qn, idx)


def test_build_and_search_on_cuda_match_cpu(cuda):
    rng = np.random.default_rng(5)
    n, d = 1500, 48
    data = rng.standard_normal((n, d)).astype(np.float32)
    graphs = {}
    for dev in ("cpu", cuda):
        g = hnsw.HostGraph.empty(distances.COSINE, d, 8, 16, capacity=hnsw.slot_capacity(n))
        for i in range(n):
            g.alloc_slot(i)
        g.vectors[:n] = data
        g.norms[:n] = distances.np_norms(distances.COSINE, data)
        before = beam_cuda.KERNEL.launches
        builder.build_graph(g, np.arange(n), np.empty(0, np.int64),
                            builder.BuildOptions(ef_construction=32, wave_size=128, bulk=False), device=dev)
        assert (beam_cuda.KERNEL.launches > before) == (dev != "cpu")
        g.check_validity()
        graphs[str(dev)] = g
    a, b = graphs["cpu"], graphs["cuda"]
    assert np.array_equal(a.levels, b.levels) and a.entry_slots == b.entry_slots
    live = a.valid_mask()
    share = float(np.mean(np.all(a.links0[live] == b.links0[live], axis=1)))
    assert share >= 0.98, share

    q = torch.from_numpy(data[:64] + 0.01)
    qn = torch.from_numpy(distances.np_norms(distances.COSINE, data[:64] + 0.01))
    res_cpu = beam.hnsw_search(hnsw.to_device(a, "cpu"), q, qn, 48)
    res_gpu = beam.hnsw_search(hnsw.to_device(b, cuda), q.to(cuda), qn.to(cuda), 48)
    assert float((res_cpu.slots == res_gpu.slots.cpu()).float().mean()) >= 0.98
