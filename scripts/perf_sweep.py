#!/usr/bin/env python3
"""Sweep the (band, chunk) job geometry of one kernel on the device.

Usage: python scripts/perf_sweep.py [-n 262144] [-m 256]
Prints pairs/sec for each configuration (compute phase only).
"""

import argparse
import itertools
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("-n", type=int, default=1 << 18)
    p.add_argument("-m", type=int, default=256)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--kernel", default="mxu")
    args = p.parse_args()

    from mpx import MatrixProfileConfig, compute_matrix_profile
    from mpx.ops.precompute import precompute_statistics
    from mpx.runtime import enable_compilation_cache
    from mpx.utils.profile import BenchmarkProfile

    enable_compilation_cache()

    T = np.cumsum(np.random.default_rng(0).standard_normal(args.n))
    w = args.n - args.m + 1
    pairs = w * (w - 1) / 2

    bands = [2048, 4096, 8192]
    chunks = [4096, 8192, 16384]
    trs = [64]

    best = None
    for band, chunk, tr in itertools.product(bands, chunks, trs):
        if band % tr or chunk % 2048:
            continue
        cfg = MatrixProfileConfig(
            m=args.m, dtype=args.dtype, kernel=args.kernel,
            band=band, chunk=chunk, tile_rows=tr, tile_cols=2048,
        )
        try:
            MP, _ = compute_matrix_profile(T, config=cfg)  # compile + warm
            np.asarray(MP)
            prof = BenchmarkProfile()
            t0 = time.time()
            MP, MPI = compute_matrix_profile(T, config=cfg, profile=prof)
            np.asarray(MP); np.asarray(MPI)  # async platforms under-report otherwise
            wall = time.time() - t0
            rate = pairs / wall
            print(f"band={band:6d} chunk={chunk:6d} tr={tr:4d}: "
                  f"{rate:.3e} pairs/s (wall {wall:.3f}s)", flush=True)
            if best is None or rate > best[0]:
                best = (rate, band, chunk, tr)
        except Exception as e:
            print(f"band={band} chunk={chunk} tr={tr}: FAILED {str(e)[:90]}",
                  flush=True)
    if best:
        print(f"BEST: {best[0]:.3e} pairs/s @ band={best[1]} chunk={best[2]} tr={best[3]}")


if __name__ == "__main__":
    main()
