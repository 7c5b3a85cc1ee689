"""Benchmark harness smoke test (tiny n, CPU)."""

import json

import pytest


def test_bench_json_line(capsys):
    from mpx.bench import main

    rc = main(["-n", "512", "-m", "16", "--kernel", "xla",
               "--band", "64", "--chunk", "128", "--tile-rows", "8"])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    data = json.loads(line)
    assert set(data) == {"metric", "value", "unit", "vs_baseline"}
    assert data["value"] > 0
    assert data["unit"] == "pairs/s"
    assert data["vs_baseline"] == data["value"] / 3.0e10


def test_bench_suite_smoke(capsys, tmp_path):
    """--suite runs the named configs and emits one JSON array plus the
    README markdown table."""
    from mpx.bench import SUITE, main, suite_table

    out = str(tmp_path / "suite.json")
    rc = main(["--suite", "--only", "vanilla-f32-8192", "--table", "--out", out])
    assert rc == 0
    captured = capsys.readouterr()
    results = json.loads(captured.out)
    assert isinstance(results, list) and len(results) == 1
    r = results[0]
    assert r["name"] == "vanilla-f32-8192"
    assert r["n"] == 8192 and r["m"] == 32
    assert r["pairs_per_sec"] > 0 and "vs_baseline" in r
    assert "| config |" in captured.err  # markdown table on stderr
    assert json.load(open(out)) == results


def test_batch_benchmark_smoke():
    """The fleet row's harness validates and reports total + per-series
    throughput (tiny shapes here; the suite row is 256x8192)."""
    from mpx.bench import run_batch_benchmark

    r = run_batch_benchmark(n=512, m=16, b=6, band=128, chunk=128,
                            validate=2)
    assert r["pairs_per_sec"] > 0 and r["series_ms"] > 0
    assert r["validation"]["series"] == 2
    assert r["validation"]["max_abs_err"] <= r["validation"]["tol"]


def test_suite_covers_baseline_configs():
    """Every BASELINE.md:37-39 tier is represented."""
    from mpx.bench import SUITE

    names = {c["name"] for c in SUITE}
    assert "vanilla-f32-8192" in names
    assert "tiled-f32-131072" in names
    assert "showcase-f64-1048576" in names
    assert any(n.startswith("real-") for n in names)
    assert any(n.startswith("scale-") for n in names)


def test_sampled_row_validation_catches_corruption():
    """validate_sampled_rows must flag a corrupted profile (this is the
    guard that would have caught the round-2 DEFAULT-precision one-hot
    index corruption, which only manifested on hardware)."""
    import numpy as np
    import pytest

    from mpx import MatrixProfileConfig, compute_matrix_profile
    from mpx.bench import ValidationError, validate_sampled_rows
    from mpx.io.datasets import generate_random_walk

    n, m = 2048, 32
    T = generate_random_walk(n, seed=7)
    cfg = MatrixProfileConfig(m=m, dtype="float64", kernel="mxu",
                              band=256, chunk=512)
    MP, MPI = compute_matrix_profile(T, m, cfg)
    MP, MPI = np.array(MP), np.array(MPI)

    ok = validate_sampled_rows(T, m, MP, MPI, k=64, tol=1e-8)
    assert ok["rows"] == 64 and ok["max_abs_err"] <= 1e-8

    bad_val = MP.copy()
    bad_val[123] += 0.5
    with pytest.raises(ValidationError):
        validate_sampled_rows(T, m, bad_val, MPI, k=2048, tol=1e-8)

    bad_idx = MPI.copy()
    # point row 123 at a far-away, non-equidistant neighbor
    bad_idx[123] = (bad_idx[123] + 400) % (n - m + 1)
    with pytest.raises(ValidationError):
        validate_sampled_rows(T, m, MP, bad_idx, k=2048, tol=1e-8)


def test_suite_reraises_validation_errors(monkeypatch):
    """A row that raises is recorded and skipped; numeric corruption
    aborts the suite."""
    import mpx.bench as B

    def corrupt(**kw):
        raise B.ValidationError("sampled-row validation FAILED")

    monkeypatch.setattr(B, "run_benchmark", corrupt)
    with pytest.raises(B.ValidationError):
        B.run_suite(names=["vanilla-f32-8192"])

    def failing(**kw):
        raise RuntimeError("out of memory")

    monkeypatch.setattr(B, "run_benchmark", failing)
    # a failing row lands a FAILED marker row (not silence, not an
    # abort) so the run records the attempt
    rows = B.run_suite(names=["vanilla-f32-8192"])
    assert [r["name"] for r in rows] == ["vanilla-f32-8192"]
    assert "out of memory" in rows[0]["failed"]
    assert "measured_at" in rows[0]["provenance"]
    assert "pairs_per_sec" not in rows[0]


def test_thresh_benchmark_smoke():
    from mpx.bench import run_thresh_benchmark

    r = run_thresh_benchmark(n=4096, m=32, dtype="float32", threshold=0.6,
                             band=512, chunk=512, validate=8)
    assert r["validation"]["rows"] == 8
    assert r["pairs_per_sec"] > 0


def test_thresh_validation_catches_corruption(monkeypatch):
    import mpx.thresh as thresh_mod
    from mpx.bench import ValidationError, run_thresh_benchmark

    real = thresh_mod.compute_sum_thresh

    def corrupt(*a, **k):
        sums, cnts = real(*a, **k)
        sums = sums.copy()
        sums[len(sums) // 2] += 5.0
        return sums, cnts

    monkeypatch.setattr(thresh_mod, "compute_sum_thresh", corrupt)
    import pytest as _pytest

    with _pytest.raises(ValidationError):
        run_thresh_benchmark(n=2048, m=16, dtype="float64", threshold=0.2,
                             band=256, chunk=256, validate=2048)


def test_damp_benchmark_smoke():
    from mpx.bench import run_damp_benchmark

    r = run_damp_benchmark(n=4096, m=32, dtype="float32",
                           band=512, chunk=512, validate=8)
    assert r["validation"]["rows"] == 8
    assert r["pairs_per_sec"] > 0


def test_provenance_has_staleness_metadata():
    """Every artifact row must self-date (round-3 review item 7)."""
    from mpx.bench import _provenance

    p = _provenance()
    assert p["measured_at"].endswith("Z") and "T" in p["measured_at"]
    assert p["commit"] and p["commit"] != ""


def test_streaming_row_scores_against_recompute_baseline(monkeypatch):
    """The streaming suite row's vs_baseline is speedup over FULL
    recomputation at the reference roofline — not the misleading
    per-append-throughput / batch-roofline ratio (round-3 review
    item 6: the old ratio read 0.048x for a tier that is in fact far
    cheaper than recomputation)."""
    import mpx.bench as B

    def fake_streaming(**kw):
        return {
            "n": 1 << 18, "m": 256, "dtype": "float32",
            "pairs": 1.0e9, "recompute_pairs": 3.0e12,
            "baseline_model": "full recompute per append at U250 roofline",
            "wall_s": 10.0, "appends": 49, "append_ms": 204.0,
            "pairs_per_sec": 1.0e8, "mp_head": [0.0],
        }

    monkeypatch.setattr(B, "run_streaming_benchmark", fake_streaming)
    rows = B.run_suite(names=["streaming-f32-262144"])
    assert len(rows) == 1
    # (3e12 / 3e10) / 10s = 10x faster than recompute-at-roofline
    assert rows[0]["vs_baseline"] == pytest.approx(10.0)


def test_suite_exit_code_reports_failed_rows(monkeypatch, capsys):
    """`mpx bench --suite` exits non-zero when any row failed, while
    still printing every row (the failed one as a FAILED marker)."""
    import mpx.bench as B

    def failing(**kw):
        raise RuntimeError("out of memory")

    monkeypatch.setattr(B, "run_benchmark", failing)
    rc = B.main(["--suite", "--only", "vanilla-f32-8192", "--table"])
    captured = capsys.readouterr()
    assert rc == 1
    rows = json.loads(captured.out)
    assert rows[0]["name"] == "vanilla-f32-8192" and "failed" in rows[0]
    assert "FAILED" in captured.err


def test_suite_table_renders_row_shapes():
    """suite_table renders every row shape a suite run can produce:
    plain, streaming and FAILED markers."""
    from mpx.bench import suite_table

    prov = {"measured_at": "2026-01-01T00:00:00Z", "commit": "abc1234"}
    rows = [
        {"name": "vanilla-f32-8192", "n": 8192, "m": 32,
         "dtype": "float32", "wall_s": 1.5, "pairs_per_sec": 2.0e7,
         "vs_baseline": 2.0e7 / 3e10, "provenance": prov},
        {"name": "streaming-f32-262144", "n": 1 << 18, "m": 256,
         "dtype": "float32", "wall_s": 10.0, "append_ms": 204.0,
         "pairs_per_sec": 1.0e8, "vs_baseline": 10.0, "provenance": prov},
        {"name": "tiled-f32-131072", "failed": "RuntimeError('x')",
         "provenance": prov},
    ]
    table = suite_table(rows)
    assert table.count("\n") == len(rows) + 1
    assert "204 ms/append" in table and "10.0x vs recompute" in table
    assert "FAILED (2026-01-01T00:00:00Z)" in table
