"""Non-normalized (AAMP) profiles vs a brute-force oracle."""

import numpy as np
import pytest

from mpx.aamp import compute_aamp_profile
from mpx.config import MatrixProfileConfig
from mpx.reference import exclusion_zone


def aamp_oracle(T, m):
    w = T.shape[0] - m + 1
    excl = exclusion_zone(m)
    wins = np.lib.stride_tricks.sliding_window_view(
        T.astype(np.float64), m)
    D = np.full(w, np.inf)
    I = np.full(w, -1, np.int64)
    for i in range(w):
        diff = wins - wins[i]
        d = np.sqrt(np.einsum("ij,ij->i", diff, diff))
        d[max(0, i - excl + 1) : i + excl] = np.inf
        j = int(d.argmin())
        if np.isfinite(d[j]):
            D[i], I[i] = d[j], j
    return D, I


@pytest.mark.parametrize("dtype,rtol", [("float32", 2e-4), ("float64", 1e-10)])
def test_aamp_matches_oracle(dtype, rtol):
    rng = np.random.default_rng(103)
    n, m = 600, 24
    T = np.cumsum(rng.standard_normal(n)) + 500.0  # offset + drift
    D, I = compute_aamp_profile(T, m, config=MatrixProfileConfig(
        m=m, dtype=dtype, band=32, chunk=64))
    eD, eI = aamp_oracle(T, m)
    scale = eD[np.isfinite(eD)].max()
    np.testing.assert_allclose(D, eD, rtol=0, atol=rtol * scale)
    mism = I != eI
    assert np.allclose(D[mism], eD[mism], atol=rtol * scale)


def test_aamp_constant_windows_are_valid():
    # z-norm tiers mask constant windows; raw distance handles them.
    rng = np.random.default_rng(107)
    n, m = 300, 16
    T = np.cumsum(rng.standard_normal(n))
    T[40 : 40 + m] = 7.0
    T[200 : 200 + m] = 7.0
    D, I = compute_aamp_profile(T, m, config=MatrixProfileConfig(
        m=m, dtype="float64", band=32, chunk=64))
    assert D[40] < 1e-9 and int(I[40]) == 200
    eD, eI = aamp_oracle(T, m)
    np.testing.assert_allclose(D, eD, atol=1e-9)


def test_aamp_amplitude_sensitivity():
    # the point of AAMP: a scaled copy is NOT a perfect match (it is
    # under z-normalization)
    rng = np.random.default_rng(109)
    n, m = 400, 32
    T = np.cumsum(rng.standard_normal(n))
    pat = np.sin(np.linspace(0, 6, m))
    T[50 : 50 + m] = pat
    T[300 : 300 + m] = 3.0 * pat
    from mpx import compute_matrix_profile

    D, I = compute_aamp_profile(T, m, config=MatrixProfileConfig(
        m=m, dtype="float64", band=32, chunk=64))
    MPz, MPIz = compute_matrix_profile(T, config=MatrixProfileConfig(
        m=m, dtype="float64", band=32, chunk=64))
    assert np.asarray(MPz)[50] < 1e-6          # z-norm: perfect match
    assert D[50] > 1.0                          # raw: amplitude matters


def test_cli_raw(tmp_path):
    from mpx.cli import main
    from mpx.io.tsb import read_binary, write_binary

    rng = np.random.default_rng(113)
    T = np.cumsum(rng.standard_normal(500))
    src = str(tmp_path / "t.tsb")
    write_binary(src, T, "double")
    out = str(tmp_path / "res")
    rc = main(["compute", "-i", src, "-m", "24", "--raw",
               "--dtype", "double", "--band", "32", "--chunk", "64",
               "-o", out])
    assert rc == 0
    D = read_binary(out + ".mpb")
    eD, _ = aamp_oracle(T, 24)
    np.testing.assert_allclose(D, eD, atol=1e-9)
    with pytest.raises(SystemExit):
        main(["compute", "-i", src, "-m", "24", "--raw", "--approx", "0.5"])


def test_aamp_large_amplitude_regression():
    # Regression: the z-norm tiers' -1e12 aggregate floor clobbered
    # valid raw-space values 2*dot - ssq_c on large-amplitude data,
    # yielding spurious inf/-1 profile entries.
    rng = np.random.default_rng(127)
    n, m = 300, 16
    T = rng.standard_normal(n) * 1e6
    D, I = compute_aamp_profile(T, m, config=MatrixProfileConfig(
        m=m, dtype="float64", band=32, chunk=64))
    assert np.isfinite(D).all() and (I >= 0).all()
    eD, eI = aamp_oracle(T, m)
    np.testing.assert_allclose(D, eD, rtol=1e-10)


def test_aamp_rejects_ignored_knobs():
    rng = np.random.default_rng(131)
    T = rng.standard_normal(200)
    with pytest.raises(ValueError, match="single-device"):
        compute_aamp_profile(T, 16, config=MatrixProfileConfig(
            m=16, num_shards=4))
    with pytest.raises(ValueError, match="one kernel"):
        compute_aamp_profile(T, 16, config=MatrixProfileConfig(
            m=16, kernel="xla"))


def test_mass_raw_profile():
    # mass(normalize=False): the AAMP analog of query search.
    from mpx.analysis import mass

    rng = np.random.default_rng(149)
    T = np.cumsum(rng.standard_normal(800)) + 100.0
    m = 32
    Q = T[200 : 200 + m].copy()
    D = mass(Q, T, normalize=False)
    wins = np.lib.stride_tricks.sliding_window_view(T, m)
    exact = np.sqrt(((wins - Q) ** 2).sum(axis=1))
    np.testing.assert_allclose(D, exact, atol=1e-9 * exact.max())
    assert D[200] < 1e-9
    # flat query is VALID in raw space (it raises under z-norm)
    Dflat = mass(np.full(m, 3.0), T, normalize=False)
    assert np.isfinite(Dflat).all()


def test_aamp_ab_join_matches_brute_force():
    """Raw AB-join (values + indices) vs the explicit distance matrix;
    exercised at f64 (exact) and f32 (tolerance)."""
    import pytest

    from mpx.aamp import compute_aamp_ab_join
    from mpx.config import MatrixProfileConfig

    rng = np.random.default_rng(7)
    A = np.cumsum(rng.standard_normal(400))
    B = np.cumsum(rng.standard_normal(300))
    m = 20
    WA = np.lib.stride_tricks.sliding_window_view(A, m)
    WB = np.lib.stride_tricks.sliding_window_view(B, m)
    D = np.sqrt(((WA[:, None, :] - WB[None, :, :]) ** 2).sum(axis=2))

    for dtype, tol in (("float64", 1e-8), ("float32", 2e-3)):
        cfg = MatrixProfileConfig(m=m, dtype=dtype, band=64, chunk=128)
        res = compute_aamp_ab_join(A, B, config=cfg)
        np.testing.assert_allclose(res.mp_a, D.min(axis=1), atol=tol)
        np.testing.assert_allclose(res.mp_b, D.min(axis=0), atol=tol)
        if dtype == "float64":
            # index ties: the reported neighbor's distance must equal
            # the row minimum exactly
            got = D[np.arange(D.shape[0]), res.mpi_a]
            np.testing.assert_allclose(got, D.min(axis=1), atol=1e-8)
            got_b = D[res.mpi_b, np.arange(D.shape[1])]
            np.testing.assert_allclose(got_b, D.min(axis=0), atol=1e-8)
