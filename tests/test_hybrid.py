"""Hybrid double tier: f32 sweeps + exact f64 rescoring (mpx/hybrid.py).

Must match the float64 golden oracle at the reference's 1e-8 tolerance
(test/include/MatrixProfileTests.hpp:73-74), including on tie-heavy and
degenerate inputs that exercise the suspect-capture and escalation paths.
"""

import numpy as np
import pytest

from mpx.config import MatrixProfileConfig
from mpx.driver import compute_matrix_profile
from mpx.hybrid import compute_matrix_profile_f64_hybrid, default_margin
from mpx.reference import compute_matrix_profile_reference

from tests.conftest import random_walk
from tests.helpers import assert_profile_close


@pytest.fixture(autouse=True, params=["plain", "cascade"])
def _cascade_mode(request, monkeypatch):
    """Run every hybrid test with the bf16 cascade both off and forced
    on (it is opt-in, off by default)."""
    monkeypatch.setenv(
        "MPX_HYBRID_CASCADE", "1" if request.param == "cascade" else "0"
    )
    return request.param


@pytest.mark.parametrize(
    "n,m,band,chunk",
    [(256, 16, 32, 64), (1024, 16, 128, 256), (1024, 128, 256, 256)],
)
def test_hybrid_matches_golden(n, m, band, chunk):
    T = random_walk(n, seed=11)
    cfg = MatrixProfileConfig(m=m, dtype="float64", kernel="hybrid",
                              band=band, chunk=chunk,
                              tile_rows=8, tile_cols=64)
    MP, MPI = compute_matrix_profile_f64_hybrid(T, cfg)
    MP_exp, MPI_exp = compute_matrix_profile_reference(T, m)
    assert MP.dtype == np.float64
    assert_profile_close(T, m, MP, MPI, MP_exp, MPI_exp, eps=1e-8)


def test_hybrid_via_driver_auto_kernel():
    """dtype=float64 + kernel=auto routes to the hybrid tier."""
    T = random_walk(512, seed=3)
    cfg = MatrixProfileConfig(m=32, dtype="float64", band=64, chunk=128,
                              tile_rows=8, tile_cols=64)
    MP, MPI = compute_matrix_profile(T, config=cfg)
    MP_exp, MPI_exp = compute_matrix_profile_reference(T, 32)
    assert_profile_close(T, 32, MP, MPI, MP_exp, MPI_exp, eps=1e-8)


def test_hybrid_tie_heavy_escalation():
    """An exactly repeated motif creates >4 equal-correlation suspects,
    overflowing the capture slots and forcing the exact escalation scan."""
    rng = np.random.default_rng(7)
    motif = np.sin(np.linspace(0, 4 * np.pi, 32))
    T = rng.standard_normal(640) * 0.01
    for off in (0, 96, 192, 288, 384, 480, 576):  # 7 exact repeats
        T[off : off + 32] += motif
    m = 16
    cfg = MatrixProfileConfig(m=m, dtype="float64", kernel="hybrid",
                              band=64, chunk=128, tile_rows=8, tile_cols=64)
    MP, MPI = compute_matrix_profile_f64_hybrid(T, cfg)
    MP_exp, MPI_exp = compute_matrix_profile_reference(T, m)
    assert_profile_close(T, m, MP, MPI, MP_exp, MPI_exp, eps=1e-8)


def test_hybrid_ultra_escalation_host_scan():
    """>64 exact motif repeats overflow even the pass-C top-K capture,
    forcing the exact host row scan — the last-resort path."""
    rng = np.random.default_rng(13)
    motif = np.sin(np.linspace(0, 2 * np.pi, 24))
    T = rng.standard_normal(24 * 80) * 1e-3
    for r in range(80):
        T[r * 24 : r * 24 + 24] += motif
    m = 16
    cfg = MatrixProfileConfig(m=m, dtype="float64", kernel="hybrid",
                              band=64, chunk=128, tile_rows=8, tile_cols=64)
    MP, MPI = compute_matrix_profile_f64_hybrid(T, cfg)
    MP_exp, MPI_exp = compute_matrix_profile_reference(T, m)
    assert_profile_close(T, m, MP, MPI, MP_exp, MPI_exp, eps=1e-8)


def test_hybrid_degenerate_segments():
    """Constant (zero-variance) stretches must come out as unmatched
    sentinels, exactly like the strict f64 path."""
    T = random_walk(300, seed=5)
    T[100:180] = 2.5  # constant stretch
    m = 16
    cfg = MatrixProfileConfig(m=m, dtype="float64", kernel="hybrid",
                              band=32, chunk=64, tile_rows=8, tile_cols=64)
    MP, MPI = compute_matrix_profile_f64_hybrid(T, cfg)
    strict_cfg = MatrixProfileConfig(m=m, dtype="float64", kernel="mxu",
                                     band=32, chunk=64,
                                     tile_rows=8, tile_cols=64)
    MP_s, MPI_s = compute_matrix_profile(T, config=strict_cfg)
    np.testing.assert_allclose(MP, np.asarray(MP_s), atol=1e-8, rtol=0)
    # degenerate windows are unmatched on both paths
    assert (MPI[np.asarray(MPI_s) == -1] == -1).all()


def test_hybrid_numpy_fallbacks(monkeypatch):
    """The tier works without the native toolchain (numpy rescore/scan)."""
    from mpx import native

    monkeypatch.setattr(native, "is_available", lambda: False)
    T = random_walk(256, seed=9)
    m = 16
    cfg = MatrixProfileConfig(m=m, dtype="float64", kernel="hybrid",
                              band=32, chunk=64, tile_rows=8, tile_cols=64)
    MP, MPI = compute_matrix_profile_f64_hybrid(T, cfg)
    MP_exp, MPI_exp = compute_matrix_profile_reference(T, m)
    assert_profile_close(T, m, MP, MPI, MP_exp, MPI_exp, eps=1e-8)


def test_hybrid_rejects_unsupported_modes():
    T = random_walk(128, seed=1)
    cfg = MatrixProfileConfig(m=16, dtype="float64", kernel="hybrid",
                              band=32, chunk=32, tile_rows=8, tile_cols=32)
    # float32 + explicit hybrid is supported (exact f64 values cast
    # down); the result must match the f64 golden at f32-cast tolerance.
    f32_cfg = MatrixProfileConfig(m=16, dtype="float32", kernel="hybrid",
                                  band=32, chunk=32, tile_rows=8, tile_cols=32)
    MP32, MPI32 = compute_matrix_profile(T, config=f32_cfg)
    assert np.asarray(MP32).dtype == np.float32
    from mpx.reference import compute_matrix_profile_reference
    from tests.helpers import assert_profile_close

    MPr, MPIr = compute_matrix_profile_reference(np.asarray(T, np.float64), 16)
    assert_profile_close(
        np.asarray(T, np.float64), 16, np.asarray(MP32), np.asarray(MPI32),
        MPr, MPIr, 1e-5,
    )
    shard_lr_cfg = MatrixProfileConfig(m=16, dtype="float64", kernel="hybrid",
                                       band=32, chunk=32, tile_rows=8,
                                       tile_cols=32, num_shards=2)
    with pytest.raises(ValueError):
        compute_matrix_profile(T, config=shard_lr_cfg, left_right=True)


@pytest.mark.parametrize("shards", [2, 8])
def test_hybrid_sharded_matches_single(shards):
    """Multi-chip hybrid: pass A/B shard over the mesh; the result must
    equal the single-device hybrid exactly (associative merges)."""
    T = random_walk(1200, seed=91)
    m = 24
    base = dict(m=m, dtype="float64", band=64, chunk=128,
                tile_rows=8, tile_cols=64)
    MP1, MPI1 = compute_matrix_profile(
        T, config=MatrixProfileConfig(**base, kernel="hybrid"))
    MP2, MPI2 = compute_matrix_profile(
        T, config=MatrixProfileConfig(**base, kernel="hybrid",
                                      num_shards=shards))
    np.testing.assert_array_equal(MP1, MP2)
    np.testing.assert_array_equal(MPI1, MPI2)
    MP_exp, MPI_exp = compute_matrix_profile_reference(T, m)
    assert_profile_close(T, m, MP2, MPI2, MP_exp, MPI_exp, eps=1e-8)


def test_hybrid_sharded_tie_heavy():
    """Sharded pass B must fold suspect counts/captures across devices
    correctly even when capture slots overflow (pass C)."""
    rng = np.random.default_rng(93)
    motif = np.sin(np.linspace(0, 2 * np.pi, 24))
    T = rng.standard_normal(24 * 30) * 1e-3
    for r in range(30):
        T[r * 24 : r * 24 + 24] += motif
    m = 16
    cfg = MatrixProfileConfig(m=m, dtype="float64", kernel="hybrid",
                              band=32, chunk=64, tile_rows=8, tile_cols=32,
                              num_shards=4)
    MP, MPI = compute_matrix_profile(T, config=cfg)
    MP_exp, MPI_exp = compute_matrix_profile_reference(T, m)
    assert_profile_close(T, m, MP, MPI, MP_exp, MPI_exp, eps=1e-8)


def test_hybrid_left_right_matches_strict():
    """Double left/right profiles route through the hybrid tier and must
    equal the strict emulated-f64 per-side aggregates at 1e-8."""
    T = random_walk(900, seed=81)
    m = 24
    base = dict(m=m, dtype="float64", band=64, chunk=128,
                tile_rows=8, tile_cols=64)
    hyb = MatrixProfileConfig(**base, kernel="hybrid")
    strict = MatrixProfileConfig(**base, kernel="mxu")
    lh, lih, rh, rih = compute_matrix_profile(T, config=hyb, left_right=True)
    ls, lis, rs, ris = compute_matrix_profile(T, config=strict, left_right=True)
    np.testing.assert_allclose(lh, np.asarray(ls), atol=1e-8, rtol=0)
    np.testing.assert_allclose(rh, np.asarray(rs), atol=1e-8, rtol=0)
    # indices match except equidistant ties
    from tests.helpers import znorm_distance
    for got, exp in ((lih, np.asarray(lis)), (rih, np.asarray(ris))):
        for i in np.nonzero(got != exp)[0]:
            assert abs(znorm_distance(T, m, int(i), int(got[i]))
                       - znorm_distance(T, m, int(i), int(exp[i]))) <= 1e-7


def test_hybrid_left_right_tie_heavy():
    """Repeated motifs exercise the SIDED pass C / escalation paths."""
    rng = np.random.default_rng(83)
    motif = np.sin(np.linspace(0, 2 * np.pi, 24))
    T = rng.standard_normal(24 * 12) * 1e-3
    for r in range(12):
        T[r * 24 : r * 24 + 24] += motif
    m = 16
    base = dict(m=m, dtype="float64", band=32, chunk=64,
                tile_rows=8, tile_cols=32)
    hyb = MatrixProfileConfig(**base, kernel="hybrid")
    strict = MatrixProfileConfig(**base, kernel="mxu")
    lh, _, rh, _ = compute_matrix_profile(T, config=hyb, left_right=True)
    ls, _, rs, _ = compute_matrix_profile(T, config=strict, left_right=True)
    np.testing.assert_allclose(lh, np.asarray(ls), atol=1e-8, rtol=0)
    np.testing.assert_allclose(rh, np.asarray(rs), atol=1e-8, rtol=0)


def test_hybrid_ab_join_matches_brute_force():
    """Double AB-joins route to the hybrid tier and must match the
    brute-force f64 oracle at 1e-8 on both directional profiles."""
    from mpx.abjoin import brute_force_ab_join, compute_ab_join
    from mpx.hybrid import compute_ab_join_f64_hybrid

    A = random_walk(700, seed=61)
    B = random_walk(500, seed=62)
    m = 24
    cfg = MatrixProfileConfig(m=m, dtype="float64", band=64, chunk=128,
                              tile_rows=8, tile_cols=64)
    res = compute_ab_join(A, B, config=cfg)
    mpa, mpia, mpb, mpib = brute_force_ab_join(A, B, m)
    np.testing.assert_allclose(np.asarray(res.mp_a), mpa, atol=1e-8, rtol=0)
    np.testing.assert_allclose(np.asarray(res.mp_b), mpb, atol=1e-8, rtol=0)
    # direct entry point agrees
    res2 = compute_ab_join_f64_hybrid(A, B, cfg)
    np.testing.assert_array_equal(res.mp_a, res2.mp_a)


def test_hybrid_ab_join_tie_heavy():
    """Motifs repeated across A and B overflow the capture slots on both
    sides (exercises AB pass C + escalation)."""
    rng = np.random.default_rng(63)
    motif = np.sin(np.linspace(0, 2 * np.pi, 24))
    A = rng.standard_normal(24 * 12) * 1e-3
    B = rng.standard_normal(24 * 12) * 1e-3
    for r in range(12):
        A[r * 24 : r * 24 + 24] += motif
        B[r * 24 : r * 24 + 24] += motif
    m = 16
    from mpx.abjoin import brute_force_ab_join
    from mpx.hybrid import compute_ab_join_f64_hybrid

    cfg = MatrixProfileConfig(m=m, dtype="float64", band=32, chunk=64,
                              tile_rows=8, tile_cols=32)
    res = compute_ab_join_f64_hybrid(A, B, cfg)
    mpa, _, mpb, _ = brute_force_ab_join(A, B, m)
    np.testing.assert_allclose(res.mp_a, mpa, atol=1e-8, rtol=0)
    np.testing.assert_allclose(res.mp_b, mpb, atol=1e-8, rtol=0)


def test_hybrid_grouped_passes(monkeypatch, tmp_path):
    """Splitting the passes into dispatch groups (the checkpointed
    path's unit of work) must not change the result."""
    import mpx.hybrid as hybrid
    from mpx.checkpoint import HybridCheckpoint, compute_hybrid_with_checkpoint

    T = random_walk(1024, seed=71)
    m = 16
    cfg = MatrixProfileConfig(m=m, dtype="float64", kernel="hybrid",
                              band=64, chunk=128, tile_rows=8, tile_cols=64)
    MP1, MPI1 = compute_matrix_profile_f64_hybrid(T, cfg)
    monkeypatch.setattr(HybridCheckpoint, "group_jobs", 64)
    calls = []
    real = hybrid._job_groups
    monkeypatch.setattr(
        hybrid, "_job_groups",
        lambda *a, **k: calls.append(len(real(*a, **k))) or real(*a, **k),
    )
    MP2, MPI2 = compute_hybrid_with_checkpoint(
        T, cfg, str(tmp_path / "g.npz")
    )
    assert max(calls) > 1  # the passes really ran in several groups
    np.testing.assert_array_equal(MP1, MP2)
    np.testing.assert_array_equal(MPI1, MPI2)


def test_default_margin_scales_with_m():
    # true-fp32 (HIGHEST) budget: a floor, then linear in m
    assert default_margin(16) == pytest.approx(1e-4)
    assert default_margin(256) == pytest.approx(1.024e-4)
    assert default_margin(4096) == pytest.approx(4096 * 4e-7)
    from mpx.hybrid import HYBRID_PRECISION

    assert HYBRID_PRECISION == "HIGHEST"


def test_hybrid_small_fused_phase_and_staged_equivalence(monkeypatch):
    """Small self-joins run the one-dispatch fused device chain; pinning
    the cap to 0 restores the staged passes; results identical."""
    import mpx.hybrid as H
    from mpx.utils.profile import BenchmarkProfile

    T = random_walk(1200, seed=44)
    cfg = MatrixProfileConfig(m=16, dtype="float64", band=64, chunk=128,
                              tile_rows=8, tile_cols=64)
    prof = BenchmarkProfile()
    MPf, MPIf = compute_matrix_profile(T, config=cfg, profile=prof)
    assert any("fused A+B" in c for c in prof.category_totals())

    monkeypatch.setattr(H, "HYBRID_SMALL_FUSED_W", 0)
    prof = BenchmarkProfile()
    MPs, MPIs = compute_matrix_profile(T, config=cfg, profile=prof)
    assert any("pass A" in c for c in prof.category_totals())
    np.testing.assert_array_equal(np.asarray(MPf), np.asarray(MPs))
    np.testing.assert_array_equal(np.asarray(MPIf), np.asarray(MPIs))


def test_hybrid_lr_fused_matches_staged(monkeypatch):
    """Left/right fused device chain == staged passes, element-exact."""
    import mpx.hybrid as H

    T = random_walk(1100, seed=47)
    cfg = MatrixProfileConfig(m=16, dtype="float64", band=64, chunk=128,
                              tile_rows=8, tile_cols=64)
    out_f = compute_matrix_profile(T, config=cfg, left_right=True)
    monkeypatch.setattr(H, "HYBRID_SMALL_FUSED_W", 0)
    out_s = compute_matrix_profile(T, config=cfg, left_right=True)
    for a, b in zip(out_f, out_s):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestDeviceStats:
    """Device-side f64 statistics for large hybrid runs (round 4): stage
    T only, compute mu/inv on device (two-pass ssq — the cumsum form's
    relative error is unbounded on near-constant windows), reconcile the
    degenerate mask against the host classification."""

    @pytest.fixture(autouse=True)
    def _force_on(self, monkeypatch):
        monkeypatch.setenv("MPX_HYBRID_DEVICE_STATS", "1")

    def test_matches_golden(self):
        T = random_walk(1536, seed=21)
        cfg = MatrixProfileConfig(m=64, dtype="float64", kernel="hybrid",
                                  band=256, chunk=512)
        MP, MPI = compute_matrix_profile_f64_hybrid(T, cfg)
        MP_exp, MPI_exp = compute_matrix_profile_reference(T, 64)
        assert_profile_close(T, 64, MP, MPI, MP_exp, MPI_exp, eps=1e-8)

    def test_near_degenerate_matches_strict(self):
        """Windows with tiny-but-nonzero variance are the conditioning
        worst case: a cumsum-based device estimator produced inv values
        off by >margin here (a missed exact-NN candidate); the two-pass
        device form + mask reconcile must match the strict path."""
        T = random_walk(3000, seed=5)
        T[1000:1400] = T[1000] + 1e-9 * np.sin(np.arange(400))
        cfg = MatrixProfileConfig(m=64, dtype="float64", kernel="hybrid",
                                  band=256, chunk=512)
        MP, MPI = compute_matrix_profile_f64_hybrid(T, cfg)
        strict = MatrixProfileConfig(m=64, dtype="float64", kernel="mxu",
                                     band=256, chunk=512)
        MP_s, MPI_s = compute_matrix_profile(T, config=strict)
        np.testing.assert_allclose(MP, np.asarray(MP_s), atol=1e-8, rtol=0)

    def test_constant_stretch_matches_strict(self):
        T = random_walk(2000, seed=6)
        T[700:1100] = T[700]
        cfg = MatrixProfileConfig(m=64, dtype="float64", kernel="hybrid",
                                  band=256, chunk=512)
        MP, MPI = compute_matrix_profile_f64_hybrid(T, cfg)
        strict = MatrixProfileConfig(m=64, dtype="float64", kernel="mxu",
                                     band=256, chunk=512)
        MP_s, MPI_s = compute_matrix_profile(T, config=strict)
        np.testing.assert_allclose(MP, np.asarray(MP_s), atol=1e-8, rtol=0)
        assert (MPI[np.asarray(MPI_s) == -1] == -1).all()

    def test_reconcile_fixes_disagreements(self):
        """_reconcile_degenerate must force the device mask to the host
        classification in BOTH directions."""
        import jax.numpy as jnp

        from mpx.hybrid import _reconcile_degenerate
        from mpx.ops.precompute import precompute_statistics

        T = random_walk(600, seed=8)
        m, w = 32, 600 - 32 + 1
        stats = precompute_statistics(T, m, band=64, chunk=128,
                                      dtype="float32", backend="jax",
                                      matmul_only=True, windows=False)
        inv64 = 1.0 / np.sqrt(np.maximum(
            1e-6, np.ones(w)))  # host: all valid
        inv64[10] = np.inf  # host says degenerate, device says valid
        # device says degenerate where host says valid:
        stats = stats._replace(inv=stats.inv.at[20].set(jnp.inf))
        fixed = _reconcile_degenerate(stats, inv64, w)
        got = np.asarray(fixed.inv)
        assert np.isinf(got[10])
        assert np.isfinite(got[20])
        assert got[20] == np.float32(inv64[20])

    def test_gate(self, monkeypatch):
        from mpx.hybrid import HYBRID_DEVICE_STATS_MIN_W, _device_stats_enabled

        monkeypatch.setenv("MPX_HYBRID_DEVICE_STATS", "auto")
        assert not _device_stats_enabled(1024)
        assert _device_stats_enabled(HYBRID_DEVICE_STATS_MIN_W)
        monkeypatch.setenv("MPX_HYBRID_DEVICE_STATS", "0")
        assert not _device_stats_enabled(1 << 22)
        monkeypatch.setenv("MPX_HYBRID_DEVICE_STATS", "1")
        assert _device_stats_enabled(16)
