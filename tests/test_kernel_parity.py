"""Cross-kernel parity: all backends produce the same profile (within
dtype tolerance) on the same input — the analog of the reference running
Vanilla and Tiled over the same GoogleTest configs."""

import numpy as np
import pytest

from mpx import MatrixProfileConfig, compute_matrix_profile
from tests.conftest import random_walk


@pytest.mark.parametrize("n,m", [(512, 16), (1024, 32)])
def test_all_kernels_agree(n, m):
    T = random_walk(n, seed=n + 5)
    results = {}
    for kernel in ("mxu", "xla"):
        cfg = MatrixProfileConfig(
            m=m, dtype="float32", kernel=kernel, band=128, chunk=128,
            tile_rows=8, tile_cols=32,
        )
        MP, MPI = compute_matrix_profile(T, config=cfg)
        results[kernel] = (np.asarray(MP), np.asarray(MPI))

    ref_mp = results["mxu"][0]
    for kernel in ("xla",):
        np.testing.assert_allclose(
            results[kernel][0], ref_mp, atol=2e-3,
            err_msg=f"{kernel} vs mxu",
        )


def test_minimum_profile_width():
    # w = 2 is the smallest legal self-join; both entries exclude each
    # other when the separation is inside m/4, leaving sentinels.
    m = 8
    T = random_walk(m + 1, seed=3)
    cfg = MatrixProfileConfig(m=m, dtype="float64", kernel="mxu",
                              band=8, chunk=8)
    MP, MPI = compute_matrix_profile(T, config=cfg)
    assert MP.shape == (2,)
    # separation 1 < m//4 = 2: no valid neighbors
    assert np.all(np.asarray(MPI) == -1)

    # with separation >= excl the pair matches itself across the join
    T2 = random_walk(m + 2, seed=4)
    MP2, MPI2 = compute_matrix_profile(T2, config=cfg)
    assert np.asarray(MPI2)[0] == 2 and np.asarray(MPI2)[2] == 0
