"""The port's distance, top-k, flat top-k, prune and kernel-twin ops
against the JAX package on the same inputs (made with numpy from a seed).

Tolerances: f32 sums run in a different order in the two frameworks, so
cosine distances agree to atol 1e-5 and sqL2/L1 to rtol 1e-5; top-k ops
on exact ties must agree exactly; the α-prune reads a bf16 Gram, where a
near-tie can flip, so 99% of rows must be identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from hannoy_tpu.models import flat as jax_flat
from hannoy_tpu.ops import beam_pallas as jax_beam_pallas
from hannoy_tpu.ops import distances as jax_distances
from hannoy_tpu.ops import prune as jax_prune
from hannoy_tpu.ops import topk as jax_topk
from hannoy_tpu_torch.models import flat
from hannoy_tpu_torch.ops import beam_cuda, distances, prune, topk

torch.set_num_threads(2)

F32 = ["cosine", "euclidean", "manhattan"]


def _tol(name):
    return dict(rtol=0, atol=1e-5) if name == "cosine" else dict(rtol=1e-5, atol=1e-6)


def _data(seed, n, d):
    rng = np.random.default_rng(seed)
    return rng, rng.standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("name", F32)
def test_gathered_distances_match_jax(name):
    rng, x = _data(1, 300, 32)
    metric = distances.by_name(name)
    nrm = distances.np_norms(metric, x)
    B, K = 10, 12
    q, qn = x[:B], nrm[:B]
    idx = rng.integers(0, 300, (B, K))
    want = np.asarray(
        jax_distances.gathered_distances(
            jax_distances.by_name(name), jnp.asarray(q), jnp.asarray(qn), jnp.asarray(x[idx]), jnp.asarray(nrm[idx])
        )
    )
    got = distances.gathered_distances(
        metric, torch.from_numpy(q), torch.from_numpy(qn), torch.from_numpy(x[idx]), torch.from_numpy(nrm[idx])
    ).numpy()
    np.testing.assert_allclose(got, want, **_tol(name))
    oracle = np.stack([jax_distances.np_pairwise(jax_distances.by_name(name), q[b : b + 1], qn[b : b + 1], x[idx[b]], nrm[idx[b]])[0] for b in range(B)])
    np.testing.assert_allclose(got, oracle, **_tol(name))


@pytest.mark.parametrize("name", F32)
def test_matrix_distances_match_jax(name):
    _, x = _data(2, 200, 24)
    metric = distances.by_name(name)
    nrm = distances.np_norms(metric, x)
    q, qn = x[:16] + 0.1, distances.np_norms(metric, x[:16] + 0.1)
    jm = jax_distances.by_name(name)
    want = np.asarray(jax_distances.matrix_distances(jm, jnp.asarray(q), jnp.asarray(qn), jnp.asarray(x), jnp.asarray(nrm)))
    got = distances.matrix_distances(
        metric, torch.from_numpy(q), torch.from_numpy(qn), torch.from_numpy(x), torch.from_numpy(nrm)
    ).numpy()
    # the euclidean norm expansion cancels: compare it at its own scale
    tol = dict(rtol=1e-5, atol=1e-4) if name == "euclidean" else _tol(name)
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(got, jax_distances.np_pairwise(jm, q, qn, x, nrm), **tol)


def test_packed_metrics_raise():
    x = torch.zeros(4, 2, dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        distances.gathered_distances(distances.HAMMING, x, torch.zeros(4), x[:, None], torch.zeros(4, 1))


@pytest.mark.parametrize("name", F32)
def test_kernel_twin_matches_pallas_kernel(name):
    """The CUDA kernel's plain twin against the Pallas kernel, run in TPU
    interpret mode as tests/test_pallas.py runs it (its tolerance, 2e-4)."""
    rng, x = _data(3, 500, 128)
    metric = distances.by_name(name)
    nrm = distances.np_norms(metric, x)
    B, K = 12, 8  # B deliberately not a multiple of 8
    idx = rng.integers(0, 500, (B, K)).astype(np.int32)
    idx[::3, ::4] = -1  # padding entries read row 0; callers mask them
    with pltpu.force_tpu_interpret_mode():
        want = jax_beam_pallas.gathered_distances_pallas(
            jax_distances.by_name(name), jnp.asarray(x), jnp.asarray(nrm), jnp.asarray(x[:B]),
            jnp.asarray(nrm[:B]), jnp.asarray(idx),
        )
    t = torch.from_numpy
    got = beam_cuda.gathered_distances(metric, t(x), t(nrm), t(x[:B]), t(nrm[:B]), t(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    assert beam_cuda.KERNEL.launches == 0  # CPU tensors never reach the kernel


def test_kernel_wrapper_rejects_mixed_devices():
    x = torch.zeros(8, 4)
    meta = torch.zeros(8, 4, device="meta")
    with pytest.raises(ValueError):
        beam_cuda.gathered_distances(distances.COSINE, meta, torch.zeros(8), x[:2], torch.zeros(2), torch.zeros(2, 3, dtype=torch.int32))


def _tied_case(seed):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 4, (6, 20)).astype(np.float32)  # heavy ties
    d[:, -3:] = np.inf
    ids = rng.integers(-1, 12, (6, 20)).astype(np.int32)
    return d, ids


def test_topk_functions_match_jax_exactly_on_ties():
    d, ids = _tied_case(4)
    pay = np.arange(d.size, dtype=np.int32).reshape(d.shape)
    jd, jids, jpay = jax_topk.sort_by_dist(jnp.asarray(d), jnp.asarray(ids), jnp.asarray(pay))
    td, tids, tpay = topk.sort_by_dist(torch.from_numpy(d), torch.from_numpy(ids), torch.from_numpy(pay))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tpay.numpy(), np.asarray(jpay))

    r_d, r_ids = np.sort(d[:, :8], axis=1), ids[:, :8]
    n_d, n_ids = d[:, 8:], ids[:, 8:]
    jm_d, (jm_ids,) = jax_topk.merge_sorted(jnp.asarray(r_d), (jnp.asarray(r_ids),), jnp.asarray(n_d), (jnp.asarray(n_ids),), 10)
    tm_d, (tm_ids,) = topk.merge_sorted(torch.from_numpy(r_d), (torch.from_numpy(r_ids),), torch.from_numpy(n_d), (torch.from_numpy(n_ids),), 10)
    np.testing.assert_array_equal(tm_d.numpy(), np.asarray(jm_d))
    np.testing.assert_array_equal(tm_ids.numpy(), np.asarray(jm_ids))

    np.testing.assert_array_equal(
        topk.contains(torch.from_numpy(ids[:, :10]), torch.from_numpy(ids[:, 10:])).numpy(),
        np.asarray(jax_topk.contains(jnp.asarray(ids[:, :10]), jnp.asarray(ids[:, 10:]))),
    )
    np.testing.assert_array_equal(
        topk.unique_mask(torch.from_numpy(ids)).numpy(), np.asarray(jax_topk.unique_mask(jnp.asarray(ids)))
    )
    # smallest_k is lax.top_k(-d) negated, ties toward the lower column
    neg, jidx = jax.lax.top_k(-jnp.asarray(d), 7)
    sv, sidx = topk.smallest_k(torch.from_numpy(d), 7)
    np.testing.assert_array_equal(sv.numpy(), -np.asarray(neg))
    np.testing.assert_array_equal(sidx.numpy(), np.asarray(jidx))


def _prune_inputs(name, seed, B=64, K=32, N=400, D=32):
    rng, x = _data(seed, N, D)
    metric = distances.by_name(name)
    nrm = distances.np_norms(metric, x)
    q = rng.standard_normal((B, D)).astype(np.float32)
    cand = np.stack([rng.choice(N, K, replace=False) for _ in range(B)]).astype(np.int32)
    cd = jax_distances.np_pairwise(jax_distances.by_name(name), q, distances.np_norms(metric, q), x, nrm)
    cd = np.take_along_axis(cd, cand, axis=1)
    order = np.argsort(cd, axis=1, kind="stable")
    cand, cd = np.take_along_axis(cand, order, 1), np.take_along_axis(cd, order, 1)
    cand[:, -2:] = -1
    cd[:, -2:] = np.inf
    return metric, x, nrm, cand, cd


def _rows_equal_share(a, b):
    return float(np.mean(np.all(a == b, axis=1)))


@pytest.mark.parametrize("alpha", [1.0, 1.2])
@pytest.mark.parametrize("name", ["cosine", "euclidean"])
def test_robust_prune_and_merge_match_jax(name, alpha):
    metric, x, nrm, cand, cd = _prune_inputs(name, 5)
    jm = jax_distances.by_name(name)
    cap = 12
    j_ids, j_d = jax_prune.robust_prune(jm, jnp.asarray(x), jnp.asarray(nrm), jnp.asarray(cand), jnp.asarray(cd), cap, alpha)
    t = torch.from_numpy
    p_ids, p_d = prune.robust_prune(metric, t(x), t(nrm), t(cand), t(cd), cap, alpha)
    share = _rows_equal_share(p_ids.numpy(), np.asarray(j_ids))
    print(f"robust_prune {name} alpha={alpha}: identical rows {share:.4f}")
    assert share >= 0.99
    same = np.all(p_ids.numpy() == np.asarray(j_ids), axis=1)
    np.testing.assert_allclose(p_d.numpy()[same], np.asarray(j_d)[same], **_tol(name))

    # existing rows = first 16 candidates, incoming = the next 16
    row_ids, row_d = cand[:, :16].copy(), cd[:, :16].copy()
    inc_ids, inc_d = cand[:, 16:], cd[:, 16:]
    jm_ids, jm_d = jax_prune.merge_link_rows(
        jm, jnp.asarray(x), jnp.asarray(nrm), jnp.asarray(row_ids), jnp.asarray(row_d),
        jnp.asarray(inc_ids), jnp.asarray(inc_d), 16, alpha,
    )
    m_ids, m_d = prune.merge_link_rows(metric, t(x), t(nrm), t(row_ids), t(row_d), t(inc_ids), t(inc_d), 16, alpha)
    share = _rows_equal_share(m_ids.numpy(), np.asarray(jm_ids))
    print(f"merge_link_rows {name} alpha={alpha}: identical rows {share:.4f}")
    assert share >= 0.99


@pytest.mark.parametrize("mask_dims", [1, 2])
@pytest.mark.parametrize("name", F32)
def test_flat_topk_matches_jax(name, mask_dims):
    rng, x = _data(6, 400, 16)
    x[200:210] = x[100:110]  # exact duplicates: ties must break toward the lower slot
    metric = distances.by_name(name)
    nrm = distances.np_norms(metric, x)
    q = np.concatenate([x[100:104], rng.standard_normal((12, 16)).astype(np.float32)])
    qn = distances.np_norms(metric, q)
    mask = rng.random((16, 400) if mask_dims == 2 else 400) < 0.8
    want_d, want_s = jax_flat.flat_topk(name, jnp.asarray(q), jnp.asarray(qn), jnp.asarray(x), jnp.asarray(nrm), jnp.asarray(mask), 10)
    t = torch.from_numpy
    got_d, got_s = flat.flat_topk(name, t(q), t(qn), t(x), t(nrm), t(mask), 10)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    tol = dict(rtol=1e-5, atol=1e-4) if name == "euclidean" else _tol(name)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **tol)
