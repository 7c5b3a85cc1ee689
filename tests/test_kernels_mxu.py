"""MXU (windows-matmul) kernel vs golden reference."""

import numpy as np
import pytest

from mpx import MatrixProfileConfig, compute_matrix_profile
from mpx.dtypes import distance_epsilon
from mpx.reference import compute_matrix_profile_reference
from tests.conftest import random_walk
from tests.helpers import assert_profile_close


@pytest.mark.parametrize("n,m,band,chunk,dtype", [
    (512, 16, 64, 128, "float32"),
    (1024, 32, 256, 256, "float32"),
    (1024, 16, 128, 512, "float64"),
    (300, 8, 64, 32, "float64"),
])
def test_mxu_matches_golden(n, m, band, chunk, dtype):
    T = random_walk(n, seed=n + m)
    cfg = MatrixProfileConfig(m=m, dtype=dtype, kernel="mxu",
                              band=band, chunk=chunk, tile_rows=8, tile_cols=8)
    MP, MPI = compute_matrix_profile(T, config=cfg)
    MP_exp, MPI_exp = compute_matrix_profile_reference(T, m)
    assert_profile_close(T, m, MP, MPI, MP_exp, MPI_exp,
                         eps=distance_epsilon(dtype))


def test_mxu_constant_window():
    T = random_walk(256, seed=4)
    T[100:140] = 1.0
    cfg = MatrixProfileConfig(m=16, dtype="float64", kernel="mxu",
                              band=64, chunk=64, tile_rows=8, tile_cols=8)
    MP, MPI = compute_matrix_profile(T, config=cfg)
    MPI = np.asarray(MPI)
    from mpx.ops.precompute import precompute_statistics_numpy

    inv = precompute_statistics_numpy(T, 16)["inv"]
    degenerate = ~np.isfinite(inv)
    matched = MPI[MPI >= 0]
    assert not np.isin(matched, np.nonzero(degenerate)[0]).any()


def test_auto_resolves_mxu():
    from mpx.kernels import HYBRID32_MIN_W, resolve_kernel

    assert resolve_kernel("auto", np.float32, 256) == "mxu"
    assert resolve_kernel("auto", np.float64, 256) == "mxu"
    assert resolve_kernel("auto", np.float64, 8192) == "xla"
    # Large f32 self-joins route through the hybrid tier (exact values,
    # faster than the one-pass argmax kernel); small ones do not (the
    # hybrid's fixed host work would dominate).
    assert resolve_kernel(
        "auto", np.float32, 256, allow_hybrid=True, w=HYBRID32_MIN_W
    ) == "hybrid"
    assert resolve_kernel(
        "auto", np.float32, 256, allow_hybrid=True, w=HYBRID32_MIN_W - 1
    ) == "mxu"
    assert resolve_kernel("auto", np.float32, 256, w=HYBRID32_MIN_W) == "mxu"


def test_f32_hybrid_route_matches_golden(monkeypatch):
    """Driver-level: float32 'auto' at large w routes through the hybrid
    tier and returns float32 distances matching the f64 golden."""
    import mpx.kernels as K
    from mpx.driver import compute_matrix_profile
    from mpx.config import MatrixProfileConfig
    from mpx.reference import compute_matrix_profile_reference
    from tests.conftest import random_walk
    from tests.helpers import assert_profile_close

    monkeypatch.setattr(K, "HYBRID32_MIN_W", 64)
    n, m = 1024, 32
    T = random_walk(n, seed=11)
    cfg = MatrixProfileConfig(m=m, dtype="float32", band=128, chunk=256)
    MP, MPI = compute_matrix_profile(T, config=cfg)
    assert np.asarray(MP).dtype == np.float32
    MPr, MPIr = compute_matrix_profile_reference(np.asarray(T, np.float64), m)
    assert_profile_close(
        np.asarray(T, np.float64), m, np.asarray(MP), np.asarray(MPI),
        MPr, MPIr, 1e-5,
    )


@pytest.mark.parametrize("removed", ["pallas", "mxu_fused"])
def test_removed_kernels_rejected(removed):
    """The two removed Pallas kernels: naming one fails with a
    message that lists the remaining choices, in the config, in
    resolve_kernel and in get_sweep_fn."""
    from mpx import MatrixProfileConfig
    from mpx.kernels import get_sweep_fn, resolve_kernel

    for call in (
        lambda: MatrixProfileConfig(m=16, kernel=removed),
        lambda: resolve_kernel(removed, np.float32, 16),
        lambda: get_sweep_fn(removed),
    ):
        with pytest.raises(ValueError, match=f"unknown kernel '{removed}'") as e:
            call()
        assert "mxu" in str(e.value) and "xla" in str(e.value)


def test_sweep_fn_choices():
    from mpx.kernels import SWEEP_KERNELS, get_sweep_fn
    from mpx.kernels.mxu import sweep_band_mxu
    from mpx.kernels.xla import sweep_band_xla

    assert SWEEP_KERNELS == ("mxu", "xla")
    assert get_sweep_fn("mxu") is sweep_band_mxu
    assert get_sweep_fn("xla") is sweep_band_xla
    # 'auto' and 'hybrid' are policies, not sweep kernels
    for policy in ("auto", "hybrid"):
        with pytest.raises(ValueError):
            get_sweep_fn(policy)
