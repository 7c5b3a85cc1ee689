#!/usr/bin/env python3
"""Prove mpx's main path on one NVIDIA GPU, at full size.

    python chip_smoke.py              # one GPU: phases 1-7
    python chip_smoke.py --four-gpu   # four GPUs: the sharded paths only

Every phase drives a user entry point (the library, the ``mpx`` CLI,
``mpx serve``'s request handler) on data made from ``--seed``, checks
the answer against an exact f64 oracle (the native golden SCAMP, or
exact row rescans for the n = 2^20 jobs), and prints its first-call time
(compilation included), its warm time, the process's peak device memory
and the card's name and power limit.  Everything runs in this one
process: a second JAX process on the card would fail for want of
memory.  Any failed phase exits non-zero before the last line, which is
exactly one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Without a GPU the script refuses to run (exit code 2).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Full sizes (ISSUE: the reference's showcase job is n = 2^20, m = 256).
FULL = {
    "flagship": dict(n=1 << 20, m=256, band=4096, chunk=32768, rows=256),
    "margin": dict(n=1 << 16, m=256, band=4096, chunk=32768, pairs=10**7),
    "one_pass": dict(n=131072, m=128),
    "strict": dict(n=1 << 16, m=256),
    "cli": dict(path="data/binary/65536.tsb", m=256),
    "serve": dict(n=8192, m=64, append=256, appends=3),
    "four": dict(n=1 << 20, m=256, band=4096, chunk=32768,
                 ring_chunk=16384),
}

# Tolerances of the correctness contract (tests/helpers.py): f64 1e-8,
# f32 2e-3; index mismatches only where the two neighbors are
# equidistant.
TOL64, TOL32 = 1e-8, 2e-3
# The phase-3 margin proof fails above this share of default_margin.
MARGIN_RATIO_MAX = 0.5


class PhaseFailure(AssertionError):
    pass


def card_info() -> str:
    """``nvidia-smi``'s name and power limit, read in a child process
    that does not import JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        lines = out.stdout.strip().splitlines()
        return lines[0].strip() if lines else f"nvidia-smi rc={out.returncode}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def device_summary() -> dict:
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu(dev: dict, count: int = 1) -> None:
    """Refuse anything but ``count`` or more GPUs: a timing or a
    correctness proof from the CPU says nothing about the card."""
    if dev["platform"] != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found no GPU (platform {dev['platform']!r})")
    if dev["count"] < count:
        raise SystemExit(
            f"chip_smoke: need {count} GPUs, JAX sees {dev['count']}")


def peak_bytes():
    """The process's peak device memory so far (None where the backend
    keeps no statistics, e.g. the CPU)."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def timed(fn):
    """(result, first-call seconds incl. compilation, warm seconds)."""
    t0 = time.perf_counter()
    fn()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = fn()
    return out, first, time.perf_counter() - t0


def random_walk(n: int, seed: int) -> np.ndarray:
    return np.cumsum(np.random.default_rng(seed).standard_normal(n))


def golden(T, m: int):
    """Exact f64 self-join profile: the native golden SCAMP (OpenMP),
    or the numpy oracle where the library did not build."""
    from mpx import native
    from mpx.reference import compute_matrix_profile_reference

    if native.is_available():
        return native.golden_scamp(np.asarray(T, np.float64), m)
    return compute_matrix_profile_reference(np.asarray(T, np.float64), m)


def compare_profiles(T, m: int, MP, MPI, MP_ref, MPI_ref, tol: float,
                     what: str) -> dict:
    """Every row: |MP - MP_ref| <= tol, and an index that differs from
    the reference's must be an equidistant tie (both exact f64
    distances within max(tol, 1e-7) — the rule of tests/helpers.py)."""
    from mpx.hybrid import _rescore_pairs
    from mpx.ops.precompute import precompute_statistics_numpy

    T64 = np.asarray(T, np.float64)
    MP = np.asarray(MP, np.float64)
    MP_ref = np.asarray(MP_ref, np.float64)
    MPI = np.asarray(MPI, np.int32)
    MPI_ref = np.asarray(MPI_ref, np.int32)
    if MP.shape != MP_ref.shape or MPI.shape != MPI_ref.shape:
        raise PhaseFailure(f"{what}: shape {MP.shape} != {MP_ref.shape}")
    if not np.isfinite(MP).all():
        raise PhaseFailure(f"{what}: non-finite distances")
    err = np.abs(MP - MP_ref)
    bad_d = np.nonzero(err > tol)[0]
    mism = np.nonzero(MPI != MPI_ref)[0]
    bad_i = np.empty(0, np.int64)
    if mism.size:
        s = precompute_statistics_numpy(T64, m)
        dist = lambda cols: np.sqrt(np.maximum(2.0 * m * (1.0 - _rescore_pairs(
            T64, s["mu"], s["inv"], m, mism.astype(np.int32), cols)), 0.0))
        d_got = dist(MPI[mism])
        d_ref = dist(MPI_ref[mism])
        bad_i = mism[np.abs(d_got - d_ref) > max(tol, 1e-7)]
    if bad_d.size or bad_i.size:
        raise PhaseFailure(
            f"{what}: {bad_d.size} distance mismatches (max err "
            f"{err.max():.3e}, rows {bad_d[:5].tolist()}), {bad_i.size} "
            f"non-tie index mismatches (rows {bad_i[:5].tolist()})")
    return {"rows": int(MP.shape[0]), "max_abs_err": float(err.max()),
            "tie_indices": int(mism.size)}


# ---------------------------------------------------------------------------
# Phases.  Each returns (dict of checks, first-call s, warm s).


def phase_flagship(T, *, m, band, chunk, rows, dtype, seed=0):
    """Phases 1-2: the showcase job through compute_matrix_profile
    (routes to the hybrid tier for double, and for float32 at this
    width), checked on ``rows`` sampled rows against exact f64 rescans."""
    from mpx import MatrixProfileConfig, compute_matrix_profile
    from mpx.bench import validate_sampled_rows
    from mpx.dtypes import canonical_dtype
    from mpx.kernels import resolve_kernel

    cfg = MatrixProfileConfig(m=m, dtype=dtype, band=band, chunk=chunk)
    kernel = resolve_kernel("auto", canonical_dtype(dtype), m,
                            allow_hybrid=True, w=T.shape[0] - m + 1)

    def run():
        MP, MPI = compute_matrix_profile(T, config=cfg)
        return np.asarray(MP), np.asarray(MPI)

    (MP, MPI), first, warm = timed(run)
    tol = TOL64 if dtype == "double" else TOL32
    val = validate_sampled_rows(T, m, MP, MPI, k=rows, seed=seed + 1,
                                tol=tol)
    return {"kernel": kernel, **val}, first, warm


def phase_margin(T, *, m, band, chunk, pairs, seed=0):
    """Phase 3: the hybrid's soundness on this device.  Every row of the
    double hybrid against the golden, then the largest |P32 - P64| over
    ``pairs`` sampled pairs at the sweep precision that ships, as a
    share of default_margin(m)."""
    import jax
    import jax.numpy as jnp

    from mpx import MatrixProfileConfig, compute_matrix_profile
    from mpx.hybrid import HYBRID_PRECISION, _prec, default_margin
    from mpx.ops.precompute import (
        precompute_statistics,
        precompute_statistics_numpy,
    )

    cfg = MatrixProfileConfig(m=m, dtype="double", kernel="hybrid",
                              band=band, chunk=chunk)
    run = lambda: compute_matrix_profile(T, config=cfg)
    (MP, MPI), first, warm = timed(run)
    MP_ref, MPI_ref = golden(T, m)
    checks = compare_profiles(T, m, MP, MPI, MP_ref, MPI_ref, TOL64,
                              "hybrid f64 vs golden")

    # The hybrid's own f32 operands: unit-normalized windows staged from
    # exact host statistics (what passes A/B/C multiply).
    T64 = np.asarray(T, np.float64)
    w = T64.shape[0] - m + 1
    s64 = precompute_statistics_numpy(T64, m)
    stats = precompute_statistics(T64, m, band=band, chunk=chunk,
                                  dtype="float32", host_stats=s64,
                                  matmul_only=True)
    rng = np.random.default_rng(seed + 3)
    nr = max(1, int(round(np.sqrt(pairs / 10))))
    nc = max(1, pairs // nr)
    rows = rng.integers(0, w, nr).astype(np.int32)
    cols = rng.integers(0, w, nc).astype(np.int32)
    win = np.lib.stride_tricks.sliding_window_view(T64, m)
    U64 = lambda idx: (win[idx] - s64["mu"][idx, None]) * s64["inv"][idx, None]
    P64 = U64(rows) @ U64(cols).T

    def max_err(precision):
        Ur = jnp.take(stats.windows, jnp.asarray(rows), axis=0)
        Uc = jnp.take(stats.windows, jnp.asarray(cols), axis=0)
        P32 = jax.jit(lambda a, b: jax.lax.dot_general(
            a, b, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32, precision=precision,
        ))(Ur, Uc)
        return float(np.abs(np.asarray(P32, np.float64) - P64).max())

    margin = default_margin(m)
    shipped = max_err(_prec(HYBRID_PRECISION))
    # For comparison only: HIGH runs in TF32 on the GPU (never shipped).
    tf32 = max_err(jax.lax.Precision.HIGH)
    checks.update({
        "pairs": int(nr * nc), "precision": HYBRID_PRECISION,
        "max_abs_dP": shipped, "margin": margin,
        "ratio": shipped / margin,
        "high_max_abs_dP": tf32, "high_ratio": tf32 / margin,
    })
    if not shipped / margin < MARGIN_RATIO_MAX:
        raise PhaseFailure(
            f"margin proof: max |P32 - P64| = {shipped:.3e} is "
            f"{shipped / margin:.3f} of default_margin({m}) = {margin:.3e} "
            f"(limit {MARGIN_RATIO_MAX})")
    return checks, first, warm


def phase_one_pass(T, *, m, dtype="float32", kernel="auto", tol=TOL32):
    """Phase 4 (float32, kernel auto -> the one-pass matmul tile) and
    phase 5 (double, kernel mxu -> native f64 matmuls through XLA):
    every row against the golden."""
    from mpx import MatrixProfileConfig, compute_matrix_profile
    from mpx.dtypes import canonical_dtype
    from mpx.kernels import resolve_kernel

    cfg = MatrixProfileConfig(m=m, dtype=dtype, kernel=kernel)
    resolved = resolve_kernel(kernel, canonical_dtype(dtype), m,
                              allow_hybrid=True, w=T.shape[0] - m + 1)

    def run():
        MP, MPI = compute_matrix_profile(T, config=cfg)
        return np.asarray(MP), np.asarray(MPI)

    (MP, MPI), first, warm = timed(run)
    MP_ref, MPI_ref = golden(T, m)
    checks = compare_profiles(T, m, MP, MPI, MP_ref, MPI_ref, tol,
                              f"{dtype} {resolved} vs golden")
    return {"kernel": resolved, **checks}, first, warm


def phase_cli(path, *, m, tmpdir):
    """Phase 6: ``mpx compute`` and ``mpx golden`` in this process on
    the same input; their .mpb/.mpib files agree under the tie rule."""
    from mpx.cli import main as cli_main
    from mpx.io.tsb import read_binary, read_series

    out = os.path.join(tmpdir, "cli")
    gold = os.path.join(tmpdir, "gold")

    def run():
        rc = cli_main(["compute", "-i", path, "-m", str(m), "-o", out])
        if rc:
            raise PhaseFailure(f"mpx compute exited {rc}")

    _, first, warm = timed(run)
    rc = cli_main(["golden", "-i", path, "-m", str(m), "-o", gold])
    if rc:
        raise PhaseFailure(f"mpx golden exited {rc}")
    T = read_series(path)
    checks = compare_profiles(
        T, m, read_binary(out + ".mpb"), read_binary(out + ".mpib", "int"),
        read_binary(gold + ".mpb"), read_binary(gold + ".mpib", "int"),
        TOL32, "mpx compute vs mpx golden")
    return checks, first, warm


def phase_serve(T, *, m, append, appends):
    """Phase 7: requests through mpx serve's handler — ping, one
    compute (against the golden), and a stream session whose profile
    must match a batch compute of the same appended series."""
    from mpx.serve import Server

    server = Server()

    def ask(**req):
        resp = server.handle(json.dumps(req))
        if "error" in resp:
            raise PhaseFailure(f"serve {req['op']}: {resp['error']}")
        return resp

    n0 = T.shape[0] - append * appends
    T0 = T[:n0]
    ping = ask(op="ping")

    def run():
        return ask(op="compute", series=T0.tolist(), m=m)

    resp, first, warm = timed(run)
    MP_ref, MPI_ref = golden(T0, m)
    compute = compare_profiles(T0, m, resp["mp"], resp["mpi"], MP_ref,
                               MPI_ref, TOL32, "serve compute vs golden")

    ask(op="stream.create", sid="s", series=T0.tolist(), m=m)
    for i in range(appends):
        lo = n0 + i * append
        got = ask(op="stream.append", sid="s",
                  points=T[lo : lo + append].tolist())
        if got["n"] != lo + append:
            raise PhaseFailure(f"stream length {got['n']} != {lo + append}")
    prof = ask(op="stream.profile", sid="s")
    batch = ask(op="compute", series=T.tolist(), m=m)
    stream = compare_profiles(T, m, prof["mp"], prof["mpi"], batch["mp"],
                              batch["mpi"], TOL32,
                              "stream profile vs batch compute")
    ask(op="stream.drop", sid="s")
    return ({"devices": ping["devices"], "compute": compute,
             "stream": stream}, first, warm)


def phase_four(T, *, m, band, chunk, ring_chunk, ndev=4):
    """--four-gpu: job sharding (double hybrid: bit-identical to one
    device; float32 one-pass: tie rule) and the ring schedule (float32:
    tie rule), each against the one-device result of this call.  Each
    configuration runs once (its time includes compilation)."""
    from mpx import MatrixProfileConfig, compute_matrix_profile

    def run(**kw):
        t0 = time.perf_counter()
        MP, MPI = compute_matrix_profile(
            T, config=MatrixProfileConfig(m=m, band=band, **kw))
        MP, MPI = np.asarray(MP), np.asarray(MPI)
        return (MP, MPI), time.perf_counter() - t0

    out = {}
    one, t1 = run(dtype="double", chunk=chunk)
    shd, t4 = run(dtype="double", chunk=chunk, num_shards=ndev)
    if not (np.array_equal(one[0], shd[0])
            and np.array_equal(one[1], shd[1])):
        raise PhaseFailure(
            "sharded f64 hybrid is not bit-identical to one device: max "
            f"|dMP| {np.abs(one[0] - shd[0]).max():.3e}, "
            f"{int((one[1] != shd[1]).sum())} index differences")
    out["jobs_f64"] = {"bit_identical": True, "one_first_s": t1,
                       "sharded_first_s": t4}

    one, t1 = run(dtype="float32", chunk=chunk, kernel="mxu")
    shd, t4 = run(dtype="float32", chunk=chunk, kernel="mxu",
                  num_shards=ndev)
    out["jobs_f32"] = {
        **compare_profiles(T, m, *shd, *one, TOL32,
                           "sharded f32 one-pass vs one device"),
        "one_first_s": t1, "sharded_first_s": t4}

    one, t1 = run(dtype="float32", chunk=ring_chunk)
    shd, t4 = run(dtype="float32", chunk=ring_chunk, num_shards=ndev,
                  shard_mode="ring")
    out["ring_f32"] = {
        **compare_profiles(T, m, *shd, *one, TOL32,
                           "ring f32 vs one device"),
        "one_first_s": t1, "sharded_first_s": t4}
    return out


# ---------------------------------------------------------------------------


def _report(name, checks, first, warm, card):
    pb = peak_bytes()
    print(f"phase {name}: first_call_s={first:.3f} warm_s={warm:.3f} "
          f"peak_bytes_in_use={pb} card=[{card}]", flush=True)
    print(f"  {name} checks: {json.dumps(checks, sort_keys=True)}",
          flush=True)


def run_phases(sizes: dict, seed: int, card: str, data_root: str) -> dict:
    """Phases 1-7 on one device; returns {phase: checks}."""
    results = {}
    with tempfile.TemporaryDirectory() as tmpdir:
        f = sizes["flagship"]
        T = random_walk(f["n"], seed)
        for name, dtype in (("1 flagship-f64", "double"),
                            ("2 flagship-f32", "float32")):
            checks, first, warm = phase_flagship(
                T, m=f["m"], band=f["band"], chunk=f["chunk"],
                rows=f["rows"], dtype=dtype, seed=seed)
            _report(name, checks, first, warm, card)
            results[name] = checks

        g = sizes["margin"]
        T = random_walk(g["n"], seed + 1)
        checks, first, warm = phase_margin(
            T, m=g["m"], band=g["band"], chunk=g["chunk"], pairs=g["pairs"],
            seed=seed)
        _report("3 margin-proof", checks, first, warm, card)
        results["3 margin-proof"] = checks
        hybrid_warm = warm

        o = sizes["one_pass"]
        checks, first, warm = phase_one_pass(
            random_walk(o["n"], seed + 2), m=o["m"])
        _report("4 one-pass-f32", checks, first, warm, card)
        results["4 one-pass-f32"] = checks

        s = sizes["strict"]  # the phase-3 series when the sizes agree
        checks, first, warm = phase_one_pass(
            random_walk(s["n"], seed + 1), m=s["m"], dtype="double",
            kernel="mxu", tol=TOL64)
        checks["hybrid_warm_s"] = hybrid_warm
        _report("5 strict-f64", checks, first, warm, card)
        print(f"  strict f64 (native f64 matmuls) warm {warm:.3f} s vs "
              f"hybrid (phase 3, same series) warm {hybrid_warm:.3f} s",
              flush=True)
        results["5 strict-f64"] = checks

        c = sizes["cli"]
        path = os.path.join(data_root, c["path"])
        checks, first, warm = phase_cli(path, m=c["m"], tmpdir=tmpdir)
        _report("6 cli", checks, first, warm, card)
        results["6 cli"] = checks

        v = sizes["serve"]
        T = random_walk(v["n"] + v["append"] * v["appends"], seed + 4)
        checks, first, warm = phase_serve(
            T, m=v["m"], append=v["append"], appends=v["appends"])
        _report("7 serve", checks, first, warm, card)
        results["7 serve"] = checks
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--four-gpu", action="store_true",
                   help="run only the four-GPU sharded paths and their "
                        "one-device comparisons")
    args = p.parse_args(argv)

    import jax

    dev = device_summary()
    card = card_info()
    print(f"device: platform={dev['platform']} kind={dev['kind']} "
          f"count={dev['count']}", flush=True)
    print(f"nvidia-smi: {card}", flush=True)
    require_gpu(dev, 4 if args.four_gpu else 1)

    from mpx import native
    from mpx.runtime import compilation_cache_dir, enable_compilation_cache

    enable_compilation_cache()
    built = native.is_available()
    print(f"jax {jax.__version__}", flush=True)
    print(f"native host library built: {built}"
          + ("" if built else f" ({native._BUILD_ERROR})"), flush=True)
    print(f"compile cache: {compilation_cache_dir()}", flush=True)
    if not built:
        raise SystemExit("chip_smoke: the native host library did not build")

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    try:
        if args.four_gpu:
            four = FULL["four"]
            res = phase_four(random_walk(four["n"], args.seed), m=four["m"],
                             band=four["band"], chunk=four["chunk"],
                             ring_chunk=four["ring_chunk"], ndev=4)
            print(f"phase 8 four-gpu: peak_bytes_in_use={peak_bytes()} "
                  f"card=[{card}]", flush=True)
            print(f"  8 four-gpu checks: {json.dumps(res, sort_keys=True)}",
                  flush=True)
            count = 4
        else:
            run_phases(FULL, args.seed, card, root)
            count = 1
    except AssertionError as e:  # PhaseFailure, bench.ValidationError
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"], "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
