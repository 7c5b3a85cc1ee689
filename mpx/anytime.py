"""Anytime / approximate matrix profiles (SCRIMP-style job sampling).

Beyond reference parity: the reference always computes the full join
(host/MatrixProfileHost.cpp:101-128 iterates every chunk).  mpx's job
grid makes an *anytime* tier nearly free — each (band x chunk) job is an
independent contribution to the profile and the max-merge is
associative, so running ANY subset of jobs yields a valid profile whose
distances are an upper bound on the truth, converging monotonically to
the exact profile as coverage -> 100% (the SCRIMP/PreSCRIMP insight,
re-cast over the device job decomposition: sampling diagonal *chunks*
instead of single diagonals keeps every dispatch matmul-shaped).

Job order:

* ``'shuffled'`` (default) — uniform convergence everywhere (a seeded
  permutation; deterministic).
* ``'diagonal'`` — near-diagonal jobs first: for smooth series most
  nearest neighbors are near the diagonal, so early batches already
  capture them (PreSCRIMP's locality argument).

``anytime_matrix_profile`` is a generator yielding
``(MP, MPI, fraction)`` after each batch — consumers can stop whenever
the profile is good enough; the final yield (fraction == 1.0) is
*exactly* the full computation (same merges, same tie rule).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from mpx.config import MatrixProfileConfig, make_job_grid
from mpx.dtypes import AGGREGATE_INIT, canonical_dtype, needs_x64, x64_scope
from mpx.ops.aggregates import init_aggregates, merge_aggregates, postcompute
from mpx.ops.precompute import precompute_statistics


def _job_order(grid, order: str, seed: int) -> np.ndarray:
    num = grid.r0.shape[0]
    if order == "shuffled":
        return np.random.default_rng(seed).permutation(num)
    if order == "diagonal":
        # ascending by diagonal offset k0, ties by row — near-diagonal
        # chunks (where smooth series' neighbors live) come first
        return np.lexsort((grid.r0, grid.k0))
    raise ValueError(f"unknown job order {order!r}")


def anytime_matrix_profile(
    T,
    m: Optional[int] = None,
    *,
    config: Optional[MatrixProfileConfig] = None,
    batches: int = 16,
    order: str = "shuffled",
    seed: int = 0,
    _first_jobs: Optional[int] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
    """Yield successively better (MP, MPI, fraction) approximations.

    Each yielded MP is a pointwise upper bound on the exact profile and
    is non-increasing across batches; the last yield (fraction 1.0)
    equals :func:`mpx.compute_matrix_profile` on the same schedule (the
    job set is identical — only the order differs, and max-merges are
    order-independent up to equidistant ties).

    ``_first_jobs`` (internal, used by :func:`approx_matrix_profile`)
    forces the first batch to exactly that many jobs; the remainder is
    split over the remaining batches.
    """
    from mpx.driver import run_jobs

    if config is None:
        config = MatrixProfileConfig(m=m if m is not None else 32)
    elif m is not None and m != config.m:
        raise ValueError(f"m={m} conflicts with config.m={config.m}")
    m = config.m
    if config.num_shards and config.num_shards > 1:
        raise ValueError("the anytime tier is single-device; drop "
                         "num_shards (run the full sharded profile or "
                         "sweep fractions per device yourself)")
    T = np.asarray(T)
    n = T.shape[0]
    config.validate_series(n, T)
    if config.input_quant is not None:
        from mpx.io.apfixed import quantize

        T = quantize(np.asarray(T, np.float64), config.input_quant)
    w = n - m + 1
    config = config.shrink_to(w)
    S, W = config.band, config.chunk
    dt = canonical_dtype(config.dtype)
    if batches < 1:
        raise ValueError("batches must be >= 1")

    from mpx.kernels import resolve_kernel

    kernel = resolve_kernel(config.kernel, dt, m, allow_hybrid=False, w=w)

    grid = make_job_grid(w, S, W)
    perm = _job_order(grid, order, seed)
    num = perm.shape[0]
    if _first_jobs is not None:
        first = min(max(1, _first_jobs), num)
        splits = [perm[:first]]
        if first < num:
            splits += list(np.array_split(
                perm[first:], min(max(1, batches - 1), num - first)))
    else:
        splits = np.array_split(perm, min(batches, num))

    with x64_scope(needs_x64(dt)):
        stats = precompute_statistics(T, m, band=S, chunk=W, dtype=dt)
        L = w + S + W
        rows_g = init_aggregates(L, dt, AGGREGATE_INIT)
        cols_g = init_aggregates(L, dt, AGGREGATE_INIT)
        done = 0
        for part in splits:
            rows_b, cols_b = run_jobs(
                stats,
                jnp.asarray(grid.r0[part]),
                jnp.asarray(grid.k0[part]),
                S=S, W=W, m=m, w=w, kernel=kernel, dtype=str(dt),
                tr=config.tile_rows, tc=config.tile_cols,
            )
            rows_g = merge_aggregates(rows_g, rows_b)
            cols_g = merge_aggregates(cols_g, cols_b)
            done += part.shape[0]
            MP, MPI = postcompute(rows_g, cols_g, m, w)
            yield np.asarray(MP), np.asarray(MPI), done / num


def approx_matrix_profile(
    T,
    m: Optional[int] = None,
    *,
    config: Optional[MatrixProfileConfig] = None,
    fraction: float = 0.25,
    order: str = "shuffled",
    seed: int = 0,
):
    """One-shot approximate profile from ``fraction`` of the job grid.

    Returns (MP, MPI, actual_fraction): distances are upper bounds on
    the exact profile (missing pairs can only lower them).  fraction=1
    is the exact computation.
    """
    if not 0.0 < fraction <= 1.0:
        raise ValueError("fraction must be in (0, 1]")
    # The first batch is sized to EXACTLY ceil(fraction * num_jobs) —
    # quantizing to 1/round(1/fraction) could deliver ~2x more or less
    # coverage than requested (e.g. 0.7 -> a full run).
    import math

    gen = anytime_matrix_profile(
        T, m, config=config, order=order, seed=seed, batches=2,
        _first_jobs=max(1, math.ceil(
            fraction * _num_jobs(np.asarray(T).shape[0], m, config))),
    )
    MP, MPI, frac = next(gen)
    gen.close()
    return MP, MPI, frac


def _num_jobs(n: int, m: Optional[int],
              config: Optional[MatrixProfileConfig]) -> int:
    cfg = config or MatrixProfileConfig(m=m if m is not None else 32)
    w = n - cfg.m + 1
    cfg = cfg.shrink_to(w)
    return make_job_grid(w, cfg.band, cfg.chunk).r0.shape[0]
