"""Benchmark harness.

The analog of the reference's BenchmarkProfile runtime report
(include/host/BenchmarkProfile.hpp) plus the showcase configuration
(README.md:35: Tiled, double, n=1,048,576, m=256 on an Alveo U250).
Headline metric: distance pairs per second per chip on the self-join
(pairs = w(w-1)/2, the upper triangle, exclusion-zone pairs included —
they are computed and masked, like the reference).

``vs_baseline`` compares against the reference's ideal roofline of
3e10 pairs/s (32 PEs x ~300 MHz x 3 compute units on the U250 showcase
build — see BASELINE.md; the repo publishes no measured numbers).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# Reference U250 showcase roofline, pairs/s (BASELINE.md).
BASELINE_PAIRS_PER_SEC = 3.0e10


class ValidationError(AssertionError):
    pass


def validate_sampled_rows(T, m: int, MP, MPI, k: int = 64, seed: int = 1,
                          tol: float | None = None) -> dict:
    """Exact-oracle spot check of a computed profile: ``k`` random rows
    are rescanned in full f64 on the host (native.row_scan — the
    independent OpenMP oracle) and the benchmark result must match the
    exact distance, with index disagreements allowed only for
    equidistant ties (the reference's tie rule, tests/helpers.py).

    Raises ValidationError on any mismatch — a benchmark number with a
    wrong profile is worse than no number (this is what would have
    caught the DEFAULT-precision one-hot corruption on hardware, which
    every CPU test missed)."""
    from mpx.hybrid import _rescore_pairs, _row_scan
    from mpx.ops.precompute import precompute_statistics_numpy
    from mpx import native

    T64 = np.asarray(T, np.float64)
    w = T64.shape[0] - m + 1
    excl = m // 4
    if tol is None:
        # conservative default by output storage; callers that KNOW the
        # compute precision pass tol explicitly (an f32-computed tier
        # may store into an f64 array — storage dtype is not precision)
        tol = 1e-8 if np.asarray(MP).dtype == np.float64 else 2e-3
    MP = np.asarray(MP, np.float64)
    MPI = np.asarray(MPI)
    s64 = (
        native.precompute(T64, m) if native.is_available()
        else precompute_statistics_numpy(T64, m)
    )
    mu64 = np.asarray(s64["mu"], np.float64)
    inv64 = np.asarray(s64["inv"], np.float64)
    rows = np.sort(
        np.random.default_rng(seed).choice(w, size=min(k, w), replace=False)
    ).astype(np.int32)
    eP, eI = _row_scan(T64, mu64, inv64, m, w, excl, rows)
    eMP = np.sqrt(np.maximum(2.0 * m * (1.0 - eP), 0.0))

    derr = np.abs(MP[rows] - eMP)
    bad_d = derr > tol
    # index check: exact match, or the chosen pair is equidistant
    mism = MPI[rows] != eI
    tie_ok = np.zeros_like(mism)
    if mism.any():
        sel = np.nonzero(mism)[0]
        cP = _rescore_pairs(
            T64, mu64, inv64, m, rows[sel],
            MPI[rows[sel]].astype(np.int32),
        )
        cMP = np.sqrt(np.maximum(2.0 * m * (1.0 - cP), 0.0))
        tie_ok[sel] = np.abs(cMP - eMP[sel]) <= tol
    bad_i = mism & ~tie_ok
    if bad_d.any() or bad_i.any():
        r_d = rows[np.nonzero(bad_d)[0][:5]].tolist()
        r_i = rows[np.nonzero(bad_i)[0][:5]].tolist()
        raise ValidationError(
            f"sampled-row validation FAILED: {int(bad_d.sum())} distance "
            f"mismatches (max err {derr.max():.3e}, rows {r_d}), "
            f"{int(bad_i.sum())} non-tie index mismatches (rows {r_i})"
        )
    return {
        "rows": int(rows.shape[0]),
        "max_abs_err": float(derr.max()),
        "tie_indices": int((mism & tie_ok).sum()),
        "tol": tol,
    }


def run_benchmark(
    n: int = 1 << 20,
    m: int = 256,
    dtype: str = "float32",
    kernel: str = "auto",
    band: int = 4096,
    chunk: int = 4096,
    tile_rows: int = 64,
    shards=None,
    shard_mode: str = "jobs",
    seed: int = 0,
    verbose: bool = False,
    input_path=None,
    validate: int = 64,
    warmup: bool = True,
):
    from mpx import MatrixProfileConfig, compute_matrix_profile
    from mpx.runtime import enable_compilation_cache
    from mpx.utils.profile import BenchmarkProfile

    enable_compilation_cache()

    if input_path:
        from mpx.io.tsb import read_series

        T = read_series(input_path)
        n = T.shape[0]
    else:
        T = np.cumsum(np.random.default_rng(seed).standard_normal(n))
    w = n - m + 1
    pairs = w * (w - 1) / 2

    cfg = MatrixProfileConfig(
        m=m, dtype=dtype, kernel=kernel, band=band, chunk=chunk,
        tile_rows=tile_rows, num_shards=shards, shard_mode=shard_mode,
    )

    # Warmup run compiles everything (reference analog: bitstream build).
    # Hour-scale rows skip it (warmup=False): a ~40s cached compile inside
    # a ~3000s run is noise, and the run would otherwise execute twice.
    if warmup:
        prof = BenchmarkProfile()
        t0 = time.time()
        MP, MPI = compute_matrix_profile(T, config=cfg, profile=prof)
        np.asarray(MP)
        compile_wall = time.time() - t0
        if verbose:
            print(f"# warmup (incl compile): {compile_wall:.1f}s", file=sys.stderr)
            prof.report(file=sys.stderr)

    # Timed run; host materialization included so async-dispatch platforms
    # cannot under-report.
    prof = BenchmarkProfile()
    t0 = time.time()
    MP, MPI = compute_matrix_profile(T, config=cfg, profile=prof)
    MP = np.asarray(MP)
    MPI = np.asarray(MPI)
    wall = time.time() - t0
    if verbose:
        prof.report(file=sys.stderr)

    totals = prof.category_totals()
    # "2. Compute" phases on the staged paths; the small-n fused tier
    # runs pre+compute+post as ONE dispatch ("1-3. Fused end-to-end"),
    # which counts fully as compute time.
    compute_ns = sum(
        v for k, v in totals.items()
        if k.startswith("2.") or "Fused end-to-end" in k
    )
    pairs_per_sec_compute = pairs / (compute_ns / 1e9)
    pairs_per_sec_wall = pairs / wall

    val = None
    if validate:
        from mpx.dtypes import canonical_dtype

        tol = 1e-8 if canonical_dtype(dtype) == np.dtype(np.float64) else 2e-3
        val = validate_sampled_rows(T, m, MP, MPI, k=validate,
                                    seed=seed + 1, tol=tol)
        if verbose:
            print(f"# validated {val['rows']} sampled rows: "
                  f"max err {val['max_abs_err']:.2e}", file=sys.stderr)

    return {
        "validation": val,
        "n": n,
        "m": m,
        "dtype": dtype,
        "pairs": pairs,
        "wall_s": wall,
        "compute_s": compute_ns / 1e9,
        "pairs_per_sec": pairs_per_sec_wall,
        "pairs_per_sec_compute": pairs_per_sec_compute,
        "mp_head": np.asarray(MP[:4]).tolist(),
    }


# The benchmark suite: every configuration BASELINE.md:37-39 requires.
# band/chunk are schedule knobs (reference analogs: w=MP_SIZE_W chunks);
# m/n/dtype define the workload.
SUITE = [
    {
        # reference default build config (CMakeLists.txt:30-46)
        "name": "vanilla-f32-8192",
        "n": 8192, "m": 32, "dtype": "float32", "band": 1024, "chunk": 1024,
    },
    {
        # Tiled-equivalent float tier (w=4096 diagonal chunks)
        "name": "tiled-f32-131072",
        "n": 131072, "m": 128, "dtype": "float32", "band": 4096, "chunk": 4096,
    },
    {
        # the showcase job's float tier (the driver headline config);
        # routed through the hybrid tier (exact values), whose sparse
        # pass B wants the large-chunk schedule
        "name": "headline-f32-1048576",
        "n": 1 << 20, "m": 256, "dtype": "float32", "band": 4096, "chunk": 32768,
    },
    {
        # the showcase job (README.md:35): double, n=2^20, m=256
        "name": "showcase-f64-1048576",
        "n": 1 << 20, "m": 256, "dtype": "double", "band": 4096, "chunk": 32768,
    },
    {
        # real dataset tier
        "name": "real-sudden-cardiac-death",
        "input": "sudden-cardiac-death.txt", "m": 128, "dtype": "float32",
        "band": 4096, "chunk": 4096,
    },
    {
        # second real set, double precision end-to-end (hybrid tier)
        "name": "real-italian-power-f64",
        "input": "italianpowerdemand.txt", "m": 128, "dtype": "double",
        "band": 4096, "chunk": 4096,
    },
    {
        # scaling row: 4x the showcase pair count, float tier
        "name": "scale-f32-2097152",
        "n": 1 << 21, "m": 256, "dtype": "float32", "band": 4096, "chunk": 32768,
    },
    {
        # sharded-INPUTS tier on a 1-device mesh: the pod-scale ring
        # schedule (O(n/D) memory per device, ppermute rotation)
        # benchmarked on the one real chip — its per-chip rate is the
        # honest basis for pod projections
        "name": "ring-f32-1048576",
        "n": 1 << 20, "m": 256, "dtype": "float32",
        "shards": 1, "shard_mode": "ring", "band": 4096, "chunk": 16384,
    },
    {
        # the flagship DOUBLE over sharded inputs: ring pass A/B +
        # sharded pass C + exact host rescore (mpx/parallel/ring.py)
        "name": "ring-f64-1048576",
        "n": 1 << 20, "m": 256, "dtype": "double",
        "shards": 1, "shard_mode": "ring", "band": 4096, "chunk": 16384,
    },
    {
        # streaming tier (BASELINE item 5's single-chip analog; the
        # n=16M pod config is compile-validated in dryrun_multichip):
        # bootstrap then timed incremental appends
        "name": "streaming-f32-262144",
        "streaming": True, "n": 1 << 18, "m": 256,
        "append": 64, "rounds": 50,
    },
    {
        # k-NN profile at the showcase scale: exact double through the
        # hybrid threshold-descent tier (mpx/hybrid.py:compute_topk_...)
        # band/chunk match the showcase row so the pass-A/B executables
        # hit the persistent compile cache
        "name": "topk-f64-1048576-k4",
        "topk": True, "n": 1 << 20, "m": 256, "k": 4, "dtype": "double",
        "band": 4096, "chunk": 32768,
    },
    {
        # contrast profile (beyond the reference: class-distinguishing
        # patterns): one self-join + one AB-join, flagship dtype
        "name": "contrast-f64-524288",
        "contrast": True, "n": 1 << 19, "m": 256, "dtype": "double",
        "band": 4096, "chunk": 32768,
    },
    {
        # DAMP anomaly tier: exact left profile at the flagship dtype
        # (the hybrid left/right path) + ranked causal discords
        "name": "damp-f64-524288",
        "damp": True, "n": 1 << 19, "m": 256, "dtype": "double",
        "band": 4096, "chunk": 32768,
    },
    {
        # sum-threshold / frequency (pattern density) tier: the 1-NN
        # sweep's matmul with a sum/popcount epilogue (mpx/thresh.py)
        "name": "thresh-f32-1048576",
        "thresh": True, "n": 1 << 20, "m": 256, "threshold": 0.7,
        "dtype": "float32", "band": 4096, "chunk": 16384,
    },
    {
        # multi-dimensional (mSTAMP) tier: d-batched MXU tiles +
        # cross-dim sort; metric = dimension-pairs/s (no reference
        # analog — the HLS design is strictly 1-D)
        "name": "mstamp-f32-d4-131072",
        "mstamp": True, "n": 1 << 17, "m": 256, "d": 4,
        "dtype": "float32", "band": 2048, "chunk": 4096,
    },
    {
        # fleet tier: 256 small series per vmapped fused dispatch group
        # (the small-problem regime, batched; contrast series_ms with
        # the single-series fused dispatch latency)
        "name": "batch-f32-256x8192",
        "batch": True, "n": 8192, "m": 64, "b": 256,
        "dtype": "float32", "band": 1024, "chunk": 1024,
    },
    {
        # pooled matrix-summary tier (SCAMP matrix mode): the whole 1M
        # join as a 64x64 max-correlation heatmap in one f32 sweep
        "name": "matrix-f32-1048576",
        "matrix": True, "n": 1 << 20, "m": 256,
        "mwidth": 64, "mheight": 64, "band": 4096, "chunk": 4096,
    },
    {
        # exact multi-length discords (MERLIN use case): one fused pan
        # survey over 16 consecutive lengths + f64 margin rescore
        "name": "merlin-f32-524288-16",
        "merlin": True, "n": 1 << 19, "lo": 256, "hi": 271,
    },
    {
        # BASELINE item 5: the 16M-point workload on ONE device (1.4e14
        # pairs).  kernel=mxu pinned: the hybrid tier's pass-A capture
        # panels would need 2B*w^2*(1/S+1/W) ~ 34-86 GB at this n (its
        # 16M story is the ring tier over several devices).  Gated out
        # of default --suite runs by "huge": run explicitly with
        # --only pod-f32-16777216.
        "name": "pod-f32-16777216",
        "n": 1 << 24, "m": 256, "dtype": "float32", "kernel": "mxu",
        "band": 4096, "chunk": 16384, "huge": True, "warmup": False,
        "validate": 32,
    },
]


def run_streaming_benchmark(n: int, m: int, append: int, rounds: int,
                            seed: int = 0, verbose: bool = False):
    """Measure incremental-append throughput: bootstrap an n-point
    profile, then time ``rounds`` appends of ``append`` points each.
    Metric = appended-pairs/s (each append sweeps ~append * n pairs)."""
    import time

    from mpx.runtime import enable_compilation_cache
    from mpx.streaming import StreamingMatrixProfile

    enable_compilation_cache()
    rng = np.random.default_rng(seed)
    T = np.cumsum(rng.standard_normal(n + append * rounds))
    smp = StreamingMatrixProfile(T[:n], m=m, dtype="float32")
    # warmup append compiles the bucket executable
    smp.append(T[n : n + append])
    t0 = time.time()
    pos = n + append
    for _ in range(rounds - 1):
        smp.append(T[pos : pos + append])
        pos += append
    MP, MPI = smp.profile()  # materialization syncs the device
    wall = time.time() - t0
    done = rounds - 1
    pairs = sum(
        (append + m - 1) * (n + append * (i + 1)) for i in range(1, rounds)
    )
    # Honest baseline for an incremental tier: a batch-only engine (the
    # reference) would RE-RUN the full self-join after every append.
    # ``recompute_pairs`` is that total work; run_suite scores
    # vs_baseline as (recompute_pairs / roofline) / wall — the speedup
    # over roofline-speed full recomputation, not the meaningless ratio
    # of per-append throughput to the batch sweep roofline.
    recompute_pairs = 0.0
    for i in range(1, rounds):
        wi = (n + append * (i + 1)) - m + 1
        recompute_pairs += wi * (wi - 1) / 2
    # the streaming tier computes in f32 (stored f64): f32 tolerance
    val = validate_sampled_rows(T[:pos], m, MP, MPI, k=32, seed=seed + 1,
                                tol=2e-3)
    return {
        "validation": val,
        "n": n,
        "m": m,
        "dtype": "float32",
        "pairs": float(pairs),
        "recompute_pairs": float(recompute_pairs),
        "baseline_model": "full recompute per append at U250 roofline",
        "wall_s": wall,
        "appends": done,
        "append_ms": wall / done * 1e3,
        "pairs_per_sec": pairs / wall,
        "mp_head": np.asarray(MP[:4]).tolist(),
    }


def run_topk_benchmark(n: int, m: int, k: int, dtype: str = "double",
                       band: int = 4096, chunk: int = 16384,
                       seed: int = 0, validate: int = 32,
                       verbose: bool = False):
    """k-NN profile benchmark (hybrid exact-f64 tier for k<=8).  Metric
    = distance pairs swept per second (the sweep work is identical to
    the 1-NN job; top-k only widens capture and merge).  Validation:
    ``validate`` random rows fully rescanned by the exact host oracle
    (mpx.hybrid._row_topk_scan); all k distances must match and index
    disagreements must be equidistant ties."""
    from mpx import MatrixProfileConfig
    from mpx.topk import compute_topk_profile
    from mpx.runtime import enable_compilation_cache

    enable_compilation_cache()
    T = np.cumsum(np.random.default_rng(seed).standard_normal(n))
    w = n - m + 1
    pairs = w * (w - 1) / 2
    cfg = MatrixProfileConfig(m=m, dtype=dtype, band=band, chunk=chunk)

    D, I = compute_topk_profile(T, k=k, config=cfg)  # warmup/compile
    t0 = time.time()
    D, I = compute_topk_profile(T, k=k, config=cfg)
    D = np.asarray(D, np.float64)
    I = np.asarray(I)
    wall = time.time() - t0

    val = None
    if validate:
        from mpx.hybrid import _row_topk_scan
        from mpx.ops.precompute import precompute_statistics_numpy
        from mpx import native

        T64 = np.asarray(T, np.float64)
        s64 = (native.precompute(T64, m) if native.is_available()
               else precompute_statistics_numpy(T64, m))
        rows = np.sort(np.random.default_rng(seed + 1).choice(
            w, size=min(validate, w), replace=False)).astype(np.int32)
        eP, eI = _row_topk_scan(
            np.asarray(T64), np.asarray(s64["mu"], np.float64),
            np.asarray(s64["inv"], np.float64), m, w, m // 4, rows, k,
        )
        eD = np.sqrt(np.maximum(2.0 * m * (1.0 - eP), 0.0))
        got = D[rows]
        # missing-neighbor slots: the oracle marks them index -1 (its
        # sentinel correlation decodes to a finite-huge distance); the
        # profile stores +inf — compare only real slots, and require
        # the profile to agree a slot is missing.
        fin = eI >= 0
        if np.isfinite(got[~fin]).any():
            raise ValidationError(
                "top-k rows report neighbors where the oracle has none"
            )
        derr = np.abs(got - eD)[fin]
        if derr.size and derr.max() > 1e-8:
            raise ValidationError(
                f"top-k sampled-row validation FAILED: max err {derr.max():.3e}"
            )
        # index mismatches must be equidistant ties: rescore the
        # REPORTED neighbor exactly and compare its distance
        mism = (I[rows] != eI) & fin
        if mism.any():
            from mpx.hybrid import _rescore_pairs

            rr, cc = np.nonzero(mism)
            cP = _rescore_pairs(
                np.asarray(T64), np.asarray(s64["mu"], np.float64),
                np.asarray(s64["inv"], np.float64), m,
                rows[rr], I[rows][rr, cc].astype(np.int32),
            )
            cD = np.sqrt(np.maximum(2.0 * m * (1.0 - cP), 0.0))
            if np.abs(cD - eD[rr, cc]).max() > 1e-8:
                raise ValidationError("top-k non-tie index mismatches")
        val = {"rows": int(rows.shape[0]),
               "max_abs_err": float(derr.max()) if derr.size else 0.0,
               "tie_indices": int(mism.sum()), "tol": 1e-8}
        if verbose:
            print(f"# validated {val['rows']} top-{k} rows: "
                  f"max err {val['max_abs_err']:.2e}", file=sys.stderr)

    return {
        "validation": val,
        "n": n, "m": m, "k": k, "dtype": dtype,
        "pairs": pairs,
        "wall_s": wall,
        "pairs_per_sec": pairs / wall,
        "mp_head": D[:2, :2].tolist(),
    }


def run_contrast_benchmark(n: int, m: int, dtype: str = "double",
                           band: int = 4096, chunk: int = 16384,
                           seed: int = 0, validate: int = 32,
                           verbose: bool = False):
    """Contrast-profile benchmark: one self-join + one AB-join at the
    same n (mpx/contrast.py).  Metric = total distance pairs swept per
    second (w*(w-1)/2 self pairs + w*w cross pairs).  Validation:
    ``validate`` sampled rows recomputed exactly on the host (both the
    self and the AB nearest neighbor via the f64 row-scan oracles) and
    the CP entry must match to 1e-8 (f64) / 2e-3 (f32)."""
    import time

    from mpx import MatrixProfileConfig
    from mpx.contrast import contrast_profile
    from mpx.runtime import enable_compilation_cache

    enable_compilation_cache()
    rng = np.random.default_rng(seed)
    Tp = np.cumsum(rng.standard_normal(n))
    Tm = np.cumsum(np.random.default_rng(seed + 7).standard_normal(n))
    w = n - m + 1
    pairs = w * (w - 1) / 2 + float(w) * w
    cfg = MatrixProfileConfig(m=m, dtype=dtype, band=band, chunk=chunk)

    contrast_profile(Tp, Tm, config=cfg)  # warmup/compile
    t0 = time.time()
    res = contrast_profile(Tp, Tm, config=cfg)
    cp = np.asarray(res.cp)  # host array already; cheap
    wall = time.time() - t0

    val = None
    if validate:
        from mpx.hybrid import _row_scan, _row_scan_ab
        from mpx.ops.precompute import precompute_statistics_numpy
        from mpx import native

        Tp64 = np.asarray(Tp, np.float64)
        Tm64 = np.asarray(Tm, np.float64)
        pre = (native.precompute if native.is_available()
               else precompute_statistics_numpy)
        sp, sm = pre(Tp64, m), pre(Tm64, m)
        rows = np.sort(np.random.default_rng(seed + 1).choice(
            w, size=min(validate, w), replace=False)).astype(np.int32)
        aaP, _ = _row_scan(
            Tp64, np.asarray(sp["mu"], np.float64),
            np.asarray(sp["inv"], np.float64), m, w, m // 4, rows)
        abP, _ = _row_scan_ab(
            Tp64, np.asarray(sp["mu"], np.float64),
            np.asarray(sp["inv"], np.float64),
            Tm64, np.asarray(sm["mu"], np.float64),
            np.asarray(sm["inv"], np.float64), m, w, rows)
        d_aa = np.sqrt(np.maximum(2.0 * m * (1.0 - aaP), 0.0))
        d_ab = np.sqrt(np.maximum(2.0 * m * (1.0 - abP), 0.0))
        expect = np.clip((d_ab - d_aa) / np.sqrt(2.0 * m), 0.0, 1.0)
        tol = 1e-8 if dtype in ("double", "float64") else 2e-3
        err = np.abs(cp[rows] - expect)
        if err.size and err.max() > tol:
            raise ValidationError(
                f"contrast sampled-row validation FAILED: "
                f"max err {err.max():.3e}")
        val = {"rows": int(rows.shape[0]),
               "max_abs_err": float(err.max()) if err.size else 0.0,
               "tol": tol}
        if verbose:
            print(f"# validated {val['rows']} contrast rows: "
                  f"max err {val['max_abs_err']:.2e}", file=sys.stderr)

    return {
        "validation": val,
        "n": n, "m": m, "dtype": dtype,
        "pairs": pairs,
        "wall_s": wall,
        "pairs_per_sec": pairs / wall,
        "mp_head": cp[:4].tolist(),
    }


def run_thresh_benchmark(n: int, m: int, dtype: str = "float32",
                         threshold: float = 0.7,
                         band: int = 4096, chunk: int = 16384,
                         seed: int = 0, validate: int = 16,
                         verbose: bool = False):
    """Sum-threshold / frequency profile benchmark (mpx/thresh.py).
    Metric = pairs/s over the w*(w-1)/2 unordered pairs (each visited
    once; its correlation feeds both windows' sums).  Validation:
    ``validate`` sampled rows' sums/counts recomputed by a blocked
    host-f64 unit-window matmul over ALL columns."""
    import time

    from mpx import MatrixProfileConfig
    from mpx.runtime import enable_compilation_cache
    from mpx.thresh import compute_sum_thresh

    enable_compilation_cache()
    rng = np.random.default_rng(seed)
    T = np.cumsum(rng.standard_normal(n))
    w = n - m + 1
    pairs = w * (w - 1) / 2
    cfg = MatrixProfileConfig(m=m, dtype=dtype, band=band, chunk=chunk)

    compute_sum_thresh(T, config=cfg, threshold=threshold)  # warmup
    t0 = time.time()
    sums, cnts = compute_sum_thresh(T, config=cfg, threshold=threshold)
    wall = time.time() - t0

    val = None
    if validate:
        from mpx.ops.precompute import precompute_statistics_numpy

        T64 = np.asarray(T, np.float64)
        s = precompute_statistics_numpy(T64, m)
        mu = np.asarray(s["mu"], np.float64)
        inv = np.asarray(s["inv"], np.float64)
        rows = np.sort(np.random.default_rng(seed + 1).choice(
            w, size=min(validate, w), replace=False))
        wins = np.lib.stride_tricks.sliding_window_view(T64, m)
        Ur = (wins[rows] - mu[rows, None]) * inv[rows, None]
        excl = m // 4
        # Borderline pairs (|P - threshold| < delta) legitimately flip
        # between device-f32 and host-f64 — and each flip moves the sum
        # by ~threshold — so f32 is validated as an INTERVAL: the device
        # sum/count must land between the oracle at threshold+delta and
        # threshold-delta (plus an accumulation tolerance).  f64 uses a
        # degenerate band (exact comparison).
        delta = 0.0 if dtype in ("double", "float64") else 1e-3
        lo_s = np.zeros(rows.shape[0])
        hi_s = np.zeros(rows.shape[0])
        lo_c = np.zeros(rows.shape[0], np.int64)
        hi_c = np.zeros(rows.shape[0], np.int64)
        blk = 1 << 16
        for o in range(0, w, blk):
            e = min(o + blk, w)
            Uc = (wins[o:e] - mu[o:e, None]) * inv[o:e, None]
            P = Ur @ Uc.T
            ok = ((np.abs(rows[:, None] - np.arange(o, e)[None, :])
                   >= excl)
                  & np.isfinite(inv[rows])[:, None]
                  & np.isfinite(inv[o:e])[None, :])
            tight = ok & (P > threshold + delta)
            loose = ok & (P > threshold - delta)
            lo_s += np.where(tight, P, 0.0).sum(axis=1)
            hi_s += np.where(loose, P, 0.0).sum(axis=1)
            lo_c += tight.sum(axis=1)
            hi_c += loose.sum(axis=1)
        tol = 1e-8 if dtype in ("double", "float64") else max(
            2e-2, 1e-6 * float(hi_s.max(initial=0.0)))
        got_s = np.asarray(sums)[rows].astype(np.float64)
        got_c = np.asarray(cnts)[rows].astype(np.int64)
        sum_viol = np.maximum(lo_s - tol - got_s, got_s - hi_s - tol)
        cnt_viol = np.maximum(lo_c - got_c, got_c - hi_c)
        if (sum_viol.size and sum_viol.max() > 0) or cnt_viol.max(
                initial=0) > 0:
            raise ValidationError(
                f"thresh sampled-row validation FAILED: sum violation "
                f"{sum_viol.max():.3e}, count violation {cnt_viol.max()}")
        val = {"rows": int(rows.shape[0]),
               "max_sum_slack": float(np.maximum(sum_viol, 0.0).max())
               if sum_viol.size else 0.0,
               "band_delta": delta, "tol": tol}
        if verbose:
            print(f"# validated {val['rows']} thresh rows "
                  f"(interval, delta={delta}, tol={tol:.2e})",
                  file=sys.stderr)

    return {
        "validation": val,
        "n": n, "m": m, "dtype": dtype, "threshold": threshold,
        "pairs": pairs,
        "wall_s": wall,
        "pairs_per_sec": pairs / wall,
        "mp_head": np.asarray(sums)[:4].tolist(),
    }


def run_damp_benchmark(n: int, m: int, dtype: str = "double",
                       band: int = 4096, chunk: int = 16384,
                       seed: int = 0, validate: int = 16,
                       verbose: bool = False):
    """DAMP (left-profile anomaly) benchmark: one left/right sweep at
    ``n`` (mpx/damp.py batch path; f64 routes through the hybrid
    left/right tier).  Metric = pairs/s over the w*(w-1)/2 join pairs
    (both directional profiles fall out of the same sweep).
    Validation: ``validate`` sampled rows' left maxima recomputed by a
    blocked host-f64 matmul over the strictly-earlier columns."""
    import time

    from mpx import MatrixProfileConfig
    from mpx.damp import compute_damp
    from mpx.runtime import enable_compilation_cache

    enable_compilation_cache()
    rng = np.random.default_rng(seed)
    T = np.cumsum(rng.standard_normal(n))
    w = n - m + 1
    pairs = w * (w - 1) / 2
    cfg = MatrixProfileConfig(m=m, dtype=dtype, band=band, chunk=chunk)

    compute_damp(T, config=cfg, k=0)  # warmup/compile
    t0 = time.time()
    res = compute_damp(T, config=cfg, k=3)
    np.asarray(res.scores)
    wall = time.time() - t0

    val = None
    if validate:
        from mpx.ops.precompute import precompute_statistics_numpy

        T64 = np.asarray(T, np.float64)
        s = precompute_statistics_numpy(T64, m)
        mu = np.asarray(s["mu"], np.float64)
        inv = np.asarray(s["inv"], np.float64)
        excl = m // 4
        rows = np.sort(np.random.default_rng(seed + 1).choice(
            np.arange(excl + 1, w),
            size=min(validate, w - excl - 1), replace=False))
        wins = np.lib.stride_tricks.sliding_window_view(T64, m)
        Ur = (wins[rows] - mu[rows, None]) * inv[rows, None]
        best = np.full(rows.shape[0], -np.inf)
        blk = 1 << 16
        for o in range(0, w, blk):
            e = min(o + blk, w)
            Uc = (wins[o:e] - mu[o:e, None]) * inv[o:e, None]
            P = Ur @ Uc.T
            ok = (((rows[:, None] - np.arange(o, e)[None, :]) >= excl)
                  & np.isfinite(inv[o:e])[None, :])
            best = np.maximum(best,
                              np.where(ok, P, -np.inf).max(axis=1))
        exp = np.sqrt(np.maximum(2.0 * m * (1.0 - best), 0.0))
        tol = 1e-8 if dtype in ("double", "float64") else 2e-3
        fin = np.isfinite(exp)
        err = np.abs(res.scores[rows][fin] - exp[fin])
        if err.size and err.max() > tol:
            raise ValidationError(
                f"damp sampled-row validation FAILED: max err "
                f"{err.max():.3e}")
        val = {"rows": int(fin.sum()),
               "max_abs_err": float(err.max()) if err.size else 0.0,
               "tol": tol}
        if verbose:
            print(f"# validated {val['rows']} damp rows: max err "
                  f"{val['max_abs_err']:.2e}", file=sys.stderr)

    return {
        "validation": val,
        "n": n, "m": m, "dtype": dtype,
        "pairs": pairs,
        "wall_s": wall,
        "pairs_per_sec": pairs / wall,
        "mp_head": res.scores[m : m + 4].tolist(),
    }


def run_mstamp_benchmark(n: int, m: int, d: int, dtype: str = "float32",
                         band: int = 4096, chunk: int = 4096,
                         seed: int = 0, validate: int = 8,
                         verbose: bool = False):
    """Multi-dimensional (mSTAMP) benchmark.  Metric = dimension-pairs/s
    (d z-norm distances per subsequence pair: the sweep is a d-batched
    MXU matmul, so useful work scales with d).  Validation: ``validate``
    sampled rows fully recomputed by a blocked host oracle (per-dim
    distances -> cross-dim sort -> prefix means) across ALL k."""
    import time

    from mpx.mstamp import compute_multidim_profile
    from mpx.runtime import enable_compilation_cache

    enable_compilation_cache()
    rng = np.random.default_rng(seed)
    T = np.cumsum(rng.standard_normal((d, n)), axis=1)
    w = n - m + 1
    pairs = d * w * (w - 1) / 2
    from mpx import MatrixProfileConfig

    cfg = MatrixProfileConfig(m=m, dtype=dtype, band=band, chunk=chunk)
    prof = compute_multidim_profile(T, config=cfg)  # warmup/compile
    t0 = time.time()
    prof = compute_multidim_profile(T, config=cfg)
    np.asarray(prof.PMP)
    wall = time.time() - t0

    val = None
    if validate:
        tol = 1e-8 if dtype in ("double", "float64") else 2e-3
        excl = m // 4
        rows = np.random.default_rng(seed + 1).choice(
            w, size=min(validate, w), replace=False)
        # per-dim unit windows, built once (blocked views, f64)
        wins = [np.lib.stride_tricks.sliding_window_view(
            T[t].astype(np.float64), m) for t in range(d)]
        U = []
        for t in range(d):
            c = wins[t] - wins[t].mean(axis=1, keepdims=True)
            U.append(c / np.sqrt((c * c).sum(axis=1, keepdims=True)))
        maxerr = 0.0
        for i in rows:
            dist = np.empty((d, w))
            for t in range(d):
                p = U[t] @ U[t][i]
                dist[t] = np.sqrt(np.maximum(2.0 * m * (1.0 - p), 0.0))
            dist[:, max(0, i - excl + 1) : i + excl] = np.inf
            dk = np.cumsum(np.sort(dist, axis=0), axis=0) \
                / np.arange(1, d + 1)[:, None]
            exp = dk.min(axis=1)
            got = np.asarray(prof.PMP[:, i], np.float64)
            fin = np.isfinite(exp)
            err = np.abs(got[fin] - exp[fin]).max() if fin.any() else 0.0
            maxerr = max(maxerr, float(err))
            if err > tol:
                raise ValidationError(
                    f"mstamp sampled-row {i} FAILED: max err {err:.3e}")
        val = {"rows": int(rows.size), "max_abs_err": maxerr, "tol": tol}
        if verbose:
            print(f"# validated {rows.size} rows x {d} k-levels: "
                  f"max err {maxerr:.2e}", file=sys.stderr)

    return {
        "validation": val,
        "n": n, "m": m, "d": d, "dtype": dtype,
        "pairs": pairs,
        "wall_s": wall,
        "pairs_per_sec": pairs / wall,
        # vs_baseline context: pairs counts
        # d-weighted dimension-pairs against the 1-D U250 roofline, and
        # beyond the d matmul sweeps every pair pays a cross-dimension
        # sort + prefix-mean epilogue (ALL k levels at once) that the
        # 1-D tiers don't — the ratio under-reads the tier by design.
        "work_factor": d,
        "baseline_model": (
            "d-weighted dimension-pairs vs the 1-D U250 roofline; each "
            "pair additionally pays a cross-dim sort + prefix-mean "
            "epilogue for all k levels (VPU/HBM-bound, no 1-D analog)"
        ),
        "mp_head": np.asarray(prof.PMP[:2, :2], np.float64).tolist(),
    }


def run_matrix_benchmark(n: int, m: int, mwidth: int = 64,
                         mheight: int = 64, band: int = 4096,
                         chunk: int = 4096, seed: int = 0,
                         validate: int = 32, verbose: bool = False):
    """Pooled distance-matrix summary benchmark (mpx/distmatrix.py):
    one f32 MXU sweep of the upper triangle with the sorted-pool
    epilogue.  Metric = pairs/s over the w*(w-1)/2 join pairs.
    Validation: for ``validate`` sampled rows, the exact f64 best pair
    (native.row_scan) must be DOMINATED by its pooled cell — the cell
    covering (row, best column) must be within 2e-3 of at least that
    correlation (exactness at small n is pinned by tests/)."""
    import time

    from mpx import MatrixProfileConfig
    from mpx.distmatrix import pooled_matrix
    from mpx.runtime import enable_compilation_cache

    enable_compilation_cache()
    T = np.cumsum(np.random.default_rng(seed).standard_normal(n))
    w = n - m + 1
    pairs = w * (w - 1) / 2
    cfg = MatrixProfileConfig(m=m, band=band, chunk=chunk)

    M = pooled_matrix(T, m, mwidth=mwidth, mheight=mheight,
                      pearson=True, config=cfg)  # warmup/compile
    t0 = time.time()
    M = pooled_matrix(T, m, mwidth=mwidth, mheight=mheight,
                      pearson=True, config=cfg)
    wall = time.time() - t0

    val = None
    if validate:
        from mpx.hybrid import _row_scan
        from mpx.ops.precompute import precompute_statistics_numpy
        from mpx import native

        T64 = np.asarray(T, np.float64)
        s64 = (native.precompute(T64, m) if native.is_available()
               else precompute_statistics_numpy(T64, m))
        rows = np.sort(np.random.default_rng(seed + 1).choice(
            w, size=min(validate, w), replace=False)).astype(np.int32)
        eP, eI = _row_scan(
            T64, np.asarray(s64["mu"], np.float64),
            np.asarray(s64["inv"], np.float64), m, w, m // 4, rows)
        ph = -(-w // mheight)
        pw = -(-w // mwidth)
        ok = eI >= 0
        cell = M[rows[ok] // ph, eI[ok] // pw]
        slack = (cell - eP[ok]).min()  # >= -2e-3: cell max dominates
        if slack < -2e-3:
            raise ValidationError(
                f"pooled cell below its own row's best pair by {-slack}")
        val = {"rows": int(ok.sum()), "min_dominance_slack": float(slack)}

    res = {
        "n": n, "m": m, "dtype": "float32",
        "mwidth": mwidth, "mheight": mheight,
        "pairs": pairs, "wall_s": wall,
        "pairs_per_sec": pairs / wall,
        "matrix_max_corr": float(M.max()),
    }
    if val:
        res["validation"] = val
    return res


def run_merlin_benchmark(n: int, lo: int, hi: int, seed: int = 0,
                         validate: int = 16, verbose: bool = False):
    """Multi-length exact discord benchmark (mpx/merlin.py): ONE fused
    pan survey over every length in [lo, hi] + per-length f64 margin
    rescore.  Metric = pairs/s over the summed per-length join pairs.
    Validation: for ``validate`` sampled rows per a few lengths, the
    exact row NN distance must not exceed the reported discord."""
    import time

    from mpx.merlin import _exact_row_rescore, multi_length_discords
    from mpx.runtime import enable_compilation_cache

    enable_compilation_cache()
    T = np.cumsum(np.random.default_rng(seed).standard_normal(n))
    ms = np.arange(lo, hi + 1)
    pairs = float(sum((n - m + 1) * (n - m) / 2 for m in ms))

    res0 = multi_length_discords(T, lo, hi)  # warmup/compile
    t0 = time.time()
    result = multi_length_discords(T, lo, hi)
    wall = time.time() - t0

    val = None
    if validate:
        T64 = np.asarray(T, np.float64)
        rng = np.random.default_rng(seed + 1)
        checked = 0
        for d in result.per_length[:: max(1, len(result.per_length) // 3)]:
            w = n - d.m + 1
            rows = np.sort(rng.choice(w, size=min(validate, w),
                                      replace=False)).astype(np.int32)
            D, _ = _exact_row_rescore(T64, d.m, rows)
            if D.max() > d.distance + 1e-9:
                raise ValidationError(
                    f"m={d.m}: sampled row NN {D.max()} exceeds the "
                    f"reported discord {d.distance}")
            checked += rows.shape[0]
        val = {"rows": checked}

    res = {
        "n": n, "m": int(ms[-1]), "dtype": "float32",
        "lengths": int(ms.size), "pairs": pairs, "wall_s": wall,
        "pairs_per_sec": pairs / wall,
        "top_discord": {"m": result.top[0].m, "index": result.top[0].index,
                        "score": result.top[0].score} if result.top else None,
    }
    if val:
        res["validation"] = val
    return res


def run_batch_benchmark(n: int, m: int, b: int, dtype: str = "float32",
                        band: int = 1024, chunk: int = 1024,
                        seed: int = 0, validate: int = 4,
                        verbose: bool = False):
    """Fleet tier benchmark: B equal-length series through the vmapped
    fused path (mpx/batch.py).  Metric = total pairs/s across the fleet;
    ``series_ms`` is the amortized per-series wall to contrast with the
    single-series fused dispatch latency.  Validation: ``validate``
    sampled series spot-checked row-wise against the exact f64 oracle."""
    import time

    from mpx import MatrixProfileConfig
    from mpx.batch import compute_batch_profiles
    from mpx.runtime import enable_compilation_cache

    enable_compilation_cache()
    rng = np.random.default_rng(seed)
    batch = np.cumsum(rng.standard_normal((b, n)), axis=1)
    w = n - m + 1
    pairs = b * w * (w - 1) / 2
    cfg = MatrixProfileConfig(m=m, dtype=dtype, band=band, chunk=chunk)

    MP, MPI = compute_batch_profiles(batch, config=cfg)  # warmup/compile
    t0 = time.time()
    MP, MPI = compute_batch_profiles(batch, config=cfg)
    wall = time.time() - t0

    val = None
    if validate:
        tol = 1e-8 if dtype in ("double", "float64") else 2e-3
        picks = np.random.default_rng(seed + 1).choice(
            b, size=min(validate, b), replace=False)
        worst = 0.0
        for s in picks:
            v = validate_sampled_rows(batch[s], m, MP[s], MPI[s], k=16,
                                      seed=seed + 2, tol=tol)
            worst = max(worst, v["max_abs_err"])
        val = {"series": int(picks.size), "rows_each": 16,
               "max_abs_err": worst, "tol": tol}
        if verbose:
            print(f"# validated {picks.size} fleet series: "
                  f"max err {worst:.2e}", file=sys.stderr)

    return {
        "validation": val,
        "n": n, "m": m, "b": b, "dtype": dtype,
        "pairs": pairs,
        "wall_s": wall,
        "series_ms": wall / b * 1e3,
        "pairs_per_sec": pairs / wall,
        # vs_baseline context: the fleet tier's value is per-dispatch
        # overhead amortization (series_ms vs a single-series run), not
        # raw throughput; a single n=8192 join is far too small to fill
        # the device, so the roofline ratio under-reads the tier by
        # design.
        "baseline_model": (
            "total fleet pairs vs the U250 roofline; per-series work "
            "(w~8k windows) cannot fill the device — compare series_ms "
            "against a single-series run instead"
        ),
        "mp_head": np.asarray(MP[0, :4], np.float64).tolist(),
    }


def run_suite(names=None, verbose: bool = False, on_row=None) -> list:
    """Run the benchmark suite; returns a list of result dicts (one per
    config) each including vs_baseline against the U250 roofline.

    A row that raises is recorded as a FAILED-marker row (``failed``
    holds the error) and the suite carries on; ``main`` then exits
    non-zero.  A ValidationError (a wrong profile) aborts the suite.
    ``on_row(row)`` fires after every completed or FAILED-marker row."""
    results = []
    for cfg in SUITE:
        if names and cfg["name"] not in names:
            continue
        if cfg.get("huge") and not names:
            continue  # hour-scale rows run only when named via --only
        kwargs = {k: v for k, v in cfg.items()
                  if k not in ("name", "input", "streaming", "huge",
                               "topk", "mstamp", "batch", "contrast",
                               "thresh", "damp", "matrix", "merlin")}
        if "input" in cfg:
            from mpx.io.datasets import dataset_path

            kwargs["input_path"] = dataset_path(cfg["input"], category="real")
        if verbose:
            print(f"# running {cfg['name']} ...", file=sys.stderr)
        try:
            if cfg.get("streaming"):
                res = run_streaming_benchmark(verbose=verbose, **kwargs)
            elif cfg.get("topk"):
                res = run_topk_benchmark(verbose=verbose, **kwargs)
            elif cfg.get("mstamp"):
                res = run_mstamp_benchmark(verbose=verbose, **kwargs)
            elif cfg.get("contrast"):
                res = run_contrast_benchmark(verbose=verbose, **kwargs)
            elif cfg.get("thresh"):
                res = run_thresh_benchmark(verbose=verbose, **kwargs)
            elif cfg.get("damp"):
                res = run_damp_benchmark(verbose=verbose, **kwargs)
            elif cfg.get("batch"):
                res = run_batch_benchmark(verbose=verbose, **kwargs)
            elif cfg.get("matrix"):
                res = run_matrix_benchmark(verbose=verbose, **kwargs)
            elif cfg.get("merlin"):
                res = run_merlin_benchmark(verbose=verbose, **kwargs)
            else:
                res = run_benchmark(verbose=verbose, **kwargs)
        except ValidationError:
            # Numerically corrupt results must FAIL the suite — stale
            # prior rows silently persisting in the published artifact
            # would be worse than no row.
            raise
        except Exception as e:  # noqa: BLE001 - one failing row must not
            # discard the rows already measured; the FAILED marker row
            # records the attempt and fails the run (see main).
            print(f"# {cfg['name']} FAILED: {e!r} — continuing",
                  file=sys.stderr)
            results.append({
                "name": cfg["name"],
                "failed": repr(e),
                "provenance": _provenance(),
            })
            if on_row is not None:
                on_row(results[-1])
            continue
        res["name"] = cfg["name"]
        if "recompute_pairs" in res:
            # incremental tier: speedup over full recomputation at the
            # reference roofline (see run_streaming_benchmark)
            res["vs_baseline"] = (
                res["recompute_pairs"] / BASELINE_PAIRS_PER_SEC
            ) / res["wall_s"]
        else:
            res["vs_baseline"] = res["pairs_per_sec"] / BASELINE_PAIRS_PER_SEC
        res["provenance"] = _provenance()
        results.append(res)
        if on_row is not None:
            on_row(res)
    return results


def _git_commit() -> str:
    """Short commit hash of the benchmarked tree ('?' outside git)."""
    import subprocess

    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            capture_output=True, text=True, timeout=10,
        )
        return out.stdout.strip() or "?"
    except Exception:
        return "?"


def _provenance() -> dict:
    """Measurement provenance, the analog of the reference's generated
    build-info.txt (CMakeLists.txt:145-149).  ``measured_at``/``commit``
    date every row so stale numbers self-identify."""
    import datetime

    import jax

    import mpx
    from mpx import native

    try:
        dev = jax.devices()[0]
        backend = f"{dev.platform} x{len(jax.devices())}"
        kind = getattr(dev, "device_kind", "?")
    except Exception:
        backend, kind = "unavailable", "?"
    return {
        "mpx": mpx.__version__,
        "jax": jax.__version__,
        "backend": backend,
        "device_kind": str(kind),
        "native": native.is_available(),
        "measured_at": datetime.datetime.now(datetime.timezone.utc)
        .strftime("%Y-%m-%dT%H:%M:%SZ"),
        "commit": _git_commit(),
    }


def suite_table(results: list) -> str:
    """Markdown table for the README, generated from suite results."""
    lines = [
        "| config | n | m | dtype | wall (s) | pairs/s | vs U250 roofline |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in results:
        if "failed" in r:  # attempted but unmeasured: record honestly
            when = r.get("provenance", {}).get("measured_at", "?")
            lines.append(
                f"| {r['name']} | — | — | — | FAILED ({when}) | — | — |"
            )
            continue
        if "append_ms" in r:  # streaming tier: per-append latency;
            # vs column = speedup over full recompute at roofline
            wall = f"{r['append_ms']:.0f} ms/append"
            vs = (f"{r['vs_baseline']:.1f}x vs recompute"
                  if "vs_baseline" in r else "(incremental tier)")
        else:
            wall = f"{r['wall_s']:.2f}"
            vs = f"{r['vs_baseline']:.2f}x"
        lines.append(
            f"| {r['name']} | {r['n']:,} | {r['m']} | {r['dtype']} "
            f"| {wall} | {r['pairs_per_sec']:.3e} "
            f"| {vs} |"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mpx bench")
    p.add_argument("-n", type=int, default=int(os.environ.get("MPX_BENCH_N", 1 << 20)))
    p.add_argument("-m", type=int, default=int(os.environ.get("MPX_BENCH_M", 256)))
    p.add_argument("--dtype", default=os.environ.get("MPX_BENCH_DTYPE", "float32"))
    p.add_argument("--kernel", default="auto")
    p.add_argument("--band", type=int, default=4096)
    p.add_argument("--chunk", type=int, default=4096)
    p.add_argument("--tile-rows", type=int, default=64)
    p.add_argument("--shards", type=int, default=None)
    p.add_argument("--input", default=None, help="benchmark a dataset file instead of a random walk")
    p.add_argument("--suite", action="store_true",
                   help="run every BASELINE.md config; prints one JSON array")
    p.add_argument("--only", action="append", default=None,
                   help="restrict --suite to named configs (repeatable)")
    p.add_argument("--table", action="store_true",
                   help="with --suite: also print the README markdown table to stderr")
    p.add_argument("--out", default=None, help="with --suite: write the JSON array to a file")
    p.add_argument("--validate", type=int, default=64,
                   help="spot-check this many rows against the exact f64 "
                        "oracle (0 disables); a mismatch fails the bench")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)

    if args.suite:
        results = run_suite(names=args.only, verbose=args.verbose)
        blob = json.dumps(results, indent=2)
        print(blob)
        if args.out:
            with open(args.out, "w") as f:
                f.write(blob + "\n")
        if args.table:
            print(suite_table(results), file=sys.stderr)
        failed = [r["name"] for r in results if "failed" in r]
        if failed:
            print(f"mpx bench: {len(failed)} suite row(s) FAILED: "
                  f"{', '.join(failed)}", file=sys.stderr)
            return 1
        return 0

    res = run_benchmark(
        n=args.n, m=args.m, dtype=args.dtype, kernel=args.kernel,
        band=args.band, chunk=args.chunk, tile_rows=args.tile_rows,
        shards=args.shards, verbose=args.verbose, input_path=args.input,
        validate=args.validate,
    )
    print(
        json.dumps(
            {
                "metric": (
                    f"self-join distance-pairs/sec (n={res['n']}, m={args.m}, {args.dtype})"
                ),
                "value": res["pairs_per_sec"],
                "unit": "pairs/s",
                "vs_baseline": res["pairs_per_sec"] / BASELINE_PAIRS_PER_SEC,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
