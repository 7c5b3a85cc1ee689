"""pyscamp-compatible shim: every entry point against mpx oracles.

The reference's own golden tooling is a pyscamp script
(util/matrix_profile.py:1-17); these tests pin the drop-in surface.
"""

import numpy as np
import pytest

import mpx.compat.pyscamp as psc
from mpx.reference import compute_matrix_profile_reference


def _walk(n, seed):
    return np.cumsum(np.random.default_rng(seed).standard_normal(n))


def test_selfjoin_matches_reference():
    T = _walk(600, 7)
    mp_, mpi = psc.selfjoin(T, 16)
    g, _ = compute_matrix_profile_reference(T, 16)
    np.testing.assert_allclose(mp_, g, atol=2e-3)
    assert mpi.dtype == np.int64


def test_selfjoin_reference_repo_workload():
    # the exact call the reference's util/matrix_profile.py makes:
    # selfjoin(ts, 4) on the 1024-sample dataset
    from mpx.io.datasets import dataset_path
    from mpx.io.tsb import read_binary

    T = read_binary(dataset_path("1024.tsb", "binary"), "double")
    mp_, mpi = psc.selfjoin(T, 4)
    g, _ = compute_matrix_profile_reference(np.asarray(T, np.float64), 4)
    np.testing.assert_allclose(mp_, g, atol=2e-3)


def test_selfjoin_pearson_and_double():
    T = _walk(400, 8)
    g, _ = compute_matrix_profile_reference(T, 16)
    pr, _ = psc.selfjoin(T, 16, pearson=True)
    np.testing.assert_allclose(pr, 1 - g * g / 32.0, atol=2e-3)
    mpd, _ = psc.selfjoin(T, 16, precision="double")
    np.testing.assert_allclose(mpd, g, atol=1e-8)
    with pytest.raises(ValueError):
        psc.selfjoin(T, 16, precision="quad")


def test_abjoin_directional():
    A, B = _walk(500, 9), _walk(300, 10)
    mp_, mpi = psc.abjoin(A, B, 16)
    from mpx.abjoin import compute_ab_join

    res = compute_ab_join(A, B, 16)
    np.testing.assert_allclose(mp_, np.asarray(res.mp_a), atol=1e-6)
    assert (mpi == np.asarray(res.mpi_a)).all()


def test_sum_joins_match_oracles():
    from mpx.thresh import brute_force_sum_thresh, brute_force_sum_thresh_ab

    A, B = _walk(500, 11), _walk(400, 12)
    s = psc.selfjoin_sum(A, 16, threshold=0.2)
    es, _ = brute_force_sum_thresh(A, 16, threshold=0.2)
    np.testing.assert_allclose(s, es, atol=1e-2)
    sab = psc.abjoin_sum(A, B, 16, threshold=0.2)
    eab, _ = brute_force_sum_thresh_ab(A, B, 16, threshold=0.2)
    np.testing.assert_allclose(sab, eab, atol=1e-2)


def test_knn_matches_topk_tier():
    from mpx.topk import compute_topk_profile

    T = _walk(400, 13)
    knn = psc.selfjoin_knn(T, 16, 3)
    D, I = compute_topk_profile(T, 16, k=3)
    D, I = np.asarray(D), np.asarray(I)
    w = D.shape[0]
    assert knn.shape[1] == 3
    # each (col, row, dist) row corresponds to the tier's (row, rank)
    k_eff = (np.asarray(I) >= 0).sum()
    assert knn.shape[0] == k_eff
    # spot-check row 0's matches
    r0 = knn[knn[:, 1] == 0]
    np.testing.assert_allclose(r0[:, 2], D[0][I[0] >= 0], atol=1e-6)
    assert (r0[:, 0].astype(int) == I[0][I[0] >= 0]).all()


def test_abjoin_knn_matches_oracle():
    A, B = _walk(400, 16), _walk(300, 17)
    from mpx.topk import brute_force_topk_ab

    knn = psc.abjoin_knn(A, B, 16, 3)
    eD, eI = brute_force_topk_ab(A, B, 16, 3)
    wa = A.shape[0] - 16 + 1
    assert knn.shape == (3 * wa, 3)
    for r in (0, wa // 2, wa - 1):
        got = knn[knn[:, 1] == r]
        np.testing.assert_allclose(got[:, 2], eD[r], atol=2e-3)
    # rank-1 equals the AB 1-NN tier everywhere
    from mpx.abjoin import compute_ab_join

    res = compute_ab_join(A, B, 16)
    first = knn[::3]
    np.testing.assert_allclose(first[:, 2], np.asarray(res.mp_a),
                               atol=1e-5)


def test_matrix_modes_match_distmatrix():
    from mpx.distmatrix import pooled_matrix

    A, B = _walk(500, 14), _walk(400, 15)
    np.testing.assert_allclose(
        psc.selfjoin_matrix(A, 16, mwidth=8, mheight=8),
        pooled_matrix(A, 16, mwidth=8, mheight=8), atol=1e-6)
    np.testing.assert_allclose(
        psc.abjoin_matrix(A, B, 16, mwidth=6, mheight=5, pearson=True),
        pooled_matrix(A, 16, mwidth=6, mheight=5, B=B, pearson=True),
        atol=1e-6)


def test_device_queries():
    assert psc.gpu_supported() is False  # CPU test mesh
    import jax

    assert any(d.platform == "cpu" for d in jax.devices())
