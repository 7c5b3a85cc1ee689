#!/usr/bin/env python3
"""Measure the fused pan kernel against the naive per-m sum (VERDICT
round-2 item 9's criterion: n=2^20, 16 window sizes, >= 1.5x).

The naive baseline is the sum of per-m single-profile walls.  Measuring
all 16 m's directly costs 16 compiles, so the baseline is measured at 4
anchor m's (warm walls) and interpolated for
the rest with the measured cost model wall(m) ~= a*m + b — pass A is a
matmul of volume prop. to m, everything else is ~constant; the fit is
reported alongside the anchors so the extrapolation is auditable.

Usage: python scripts/pan_bench.py [n_log2] [count]
"""

import json
import sys
import time

import numpy as np

from mpx.config import MatrixProfileConfig
from mpx.driver import compute_matrix_profile
from mpx.pan import compute_pan_profile, pan_m_range
from mpx.runtime import enable_compilation_cache


def main() -> int:
    n = 1 << (int(sys.argv[1]) if len(sys.argv) > 1 else 20)
    count = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    enable_compilation_cache()
    T = np.cumsum(np.random.default_rng(5).standard_normal(n))
    ms = pan_m_range(64, 4096, count)
    print(f"# n={n}, {ms.size} window sizes: {ms.tolist()}", file=sys.stderr)

    anchors = [64, 256, 1024, 4096]
    naive = {}
    for m in anchors:
        cfg = MatrixProfileConfig(m=m, dtype="float32",
                                  band=4096, chunk=16384)
        compute_matrix_profile(T, config=cfg)  # compile/warm
        t0 = time.time()
        MP, MPI = compute_matrix_profile(T, config=cfg)
        np.asarray(MP)
        naive[m] = time.time() - t0
        print(f"# naive m={m}: {naive[m]:.2f}s", file=sys.stderr)

    # wall(m) = a*m + b least squares on the anchors
    A = np.array([[m, 1.0] for m in anchors])
    y = np.array([naive[m] for m in anchors])
    (a, b), *_ = np.linalg.lstsq(A, y, rcond=None)
    naive_sum = float(sum(a * m + b for m in ms))
    resid = float(np.abs(A @ np.array([a, b]) - y).max())

    # fused: one cold (compile) then one measured run
    t0 = time.time()
    pan = compute_pan_profile(T, ms, method="fused")
    cold = time.time() - t0
    t0 = time.time()
    pan = compute_pan_profile(T, ms, method="fused")
    fused = time.time() - t0

    # spot-validate 3 rows of the surface against the exact anchors
    from mpx.bench import validate_sampled_rows
    for r, m in enumerate(ms):
        if int(m) in anchors[:2]:
            wr = n - int(m) + 1
            validate_sampled_rows(T, int(m), pan.PMP[r, :wr],
                                  pan.PMPI[r, :wr], k=16, tol=2e-3)
    print(json.dumps({
        "n": n, "levels": int(ms.size),
        "naive_anchors_s": naive,
        "naive_model": {"a": float(a), "b": float(b),
                        "max_resid_s": resid},
        "naive_sum_s": naive_sum,
        "fused_cold_s": cold,
        "fused_warm_s": fused,
        "speedup_vs_naive": naive_sum / fused,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
