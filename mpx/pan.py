"""Pan matrix profile: the profile surface over a range of window sizes.

The reference fixes one subsequence length per run (its CMake `m`
knob); real exploratory use rarely knows m in advance.  The pan profile
(SKIMP, Madrid et al. 2019) computes the profile for a whole range of
window sizes and normalizes them onto a comparable scale, so motif
structure at ANY length shows up in one (len(ms) x w) surface.

Every row is one full run of the fastest available tier for its
(n, m) — the hybrid two-pass matmul pipeline for large jobs — so the
pan surface inherits the single-m performance work.  (SKIMP's
bisection ORDERING, which exists to make partial CPU runs useful early,
is deliberately not reproduced: on this stack each row is seconds, and
all rows are exact.)
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from mpx.config import MatrixProfileConfig


class PanProfile(NamedTuple):
    ms: np.ndarray    # (R,) int window sizes, ascending
    PMP: np.ndarray   # (R, w_max) float64 distances; +inf beyond row width
    PMPI: np.ndarray  # (R, w_max) int32 indices; -1 beyond row width

    @property
    def normalized(self) -> np.ndarray:
        """Distances scaled to [0, 1] per row (d / (2*sqrt(m)), the
        SKIMP normalization) — rows become comparable across m.
        Unmatched windows (padding tails and degenerate zero-variance
        subsequences, whose stored distance is the huge aggregate-init
        sentinel) come out as NaN."""
        scale = 2.0 * np.sqrt(self.ms.astype(np.float64))
        out = self.PMP / scale[:, None]
        matched = np.isfinite(self.PMP) & (self.PMPI >= 0)
        return np.where(matched, out, np.nan)


def pan_m_range(lo: int, hi: int, count: int = 16) -> np.ndarray:
    """Log-spaced window sizes in [lo, hi], deduplicated, ascending.
    Both endpoints are always included (np.geomspace(lo, hi, 1) would
    silently drop ``hi``)."""
    if lo < 4:
        raise ValueError("m must be >= 4 (exclusion zone is m/4)")
    if hi < lo:
        raise ValueError(f"empty range [{lo}, {hi}]")
    ms = np.round(np.geomspace(lo, hi, max(count, 1))).astype(np.int64)
    return np.unique(np.concatenate([ms, [lo, hi]]))


def compute_pan_profile(
    T,
    ms: Sequence[int],
    config: Optional[MatrixProfileConfig] = None,
    method: str = "auto",
) -> PanProfile:
    """Matrix profile at every window size in ``ms``.

    ``config`` (optional) carries dtype/kernel/schedule knobs; its ``m``
    is ignored.

    ``method``:

    * ``'fused'`` — ALL window lengths in one sweep of the pair grid
      (mpx.pan_kernel): the centered-QT panel is carried across levels,
      so the matmul volume is O(n^2 * max(ms)) instead of
      O(n^2 * sum(ms)) and statistics stage once.  f32-grade rows
      (validated at 2e-3 vs the exact per-m profile) — the right tier
      for an exploratory surface.
    * ``'exact'`` — R independent runs of the exact single-m pipeline
      (largest-m-first so the first result validates the range).
    * ``'auto'`` — fused for float32 configs (and when no config is
      given), exact for float64.
    """
    from dataclasses import replace

    from mpx.driver import compute_matrix_profile

    T = np.asarray(T)
    if config is not None and config.input_quant is not None:
        # ap_fixed input tier: quantize ONCE here so the fused path sees
        # the same cast input as the exact per-m pipeline (which would
        # otherwise quantize internally while the fused path would not).
        from mpx.io.apfixed import quantize

        T = quantize(T, config.input_quant)
    ms_arr = np.unique(np.asarray(list(ms), dtype=np.int64))
    if ms_arr.size == 0:
        raise ValueError("ms is empty")
    if method not in ("auto", "fused", "exact"):
        raise ValueError(f"unknown pan method {method!r}")
    if method == "auto":
        from mpx.dtypes import canonical_dtype

        method = (
            "exact"
            if config is not None
            and canonical_dtype(config.dtype) == np.dtype(np.float64)
            else "fused"
        )
    if config is None:
        dtype = "float32" if method == "fused" else "float64"
        config = MatrixProfileConfig(m=int(ms_arr[0]), dtype=dtype)
    n = T.shape[0]
    if n - int(ms_arr[-1]) + 1 < 2:
        raise ValueError(
            f"largest m={int(ms_arr[-1])} leaves no pairs for n={n}"
        )
    w_max = n - int(ms_arr[0]) + 1
    R = ms_arr.size

    if method == "fused":
        from mpx.pan_kernel import run_pan_jobs

        cfg = replace(config, m=int(ms_arr[0])).shrink_to(w_max)
        PMP, PMPI = run_pan_jobs(
            T, [int(m) for m in ms_arr], band=cfg.band, chunk=cfg.chunk,
        )
        return PanProfile(ms=ms_arr, PMP=PMP, PMPI=PMPI)

    PMP = np.full((R, w_max), np.inf, np.float64)
    PMPI = np.full((R, w_max), -1, np.int32)
    for r in range(R - 1, -1, -1):
        m = int(ms_arr[r])
        cfg = replace(config, m=m)
        MP, MPI = compute_matrix_profile(T, config=cfg)
        wm = n - m + 1
        PMP[r, :wm] = np.asarray(MP, np.float64)
        PMPI[r, :wm] = np.asarray(MPI, np.int32)
    return PanProfile(ms=ms_arr, PMP=PMP, PMPI=PMPI)


class PanMotif(NamedTuple):
    m: int            # window size the motif was found at
    a: int            # earlier occurrence start
    b: int            # later occurrence start
    distance: float   # raw z-normalized distance at that m
    score: float      # SKIMP-normalized distance (comparable across m)


def _suppress_span(score: np.ndarray, ms: np.ndarray, pos: int, span: int,
                   fill: float = np.inf):
    """Mask (to ``fill``) every (row, start) whose window overlaps
    [pos, pos+span): window [s, s+m_r) overlaps iff
    s in (pos - m_r, pos + span)."""
    w = score.shape[1]
    for r in range(score.shape[0]):
        lo = max(0, pos - int(ms[r]) + 1)
        score[r, lo : min(w, pos + span)] = fill


def pan_motifs(pan: PanProfile, k: int = 3) -> List[PanMotif]:
    """k best VARIABLE-LENGTH motifs from a pan surface (the SKIMP
    payoff): global minima of the cross-m normalized surface, each
    suppressing every window — at every length — overlapping either
    occurrence, so successive motifs are disjoint spans (possibly at
    different window sizes)."""
    norm = pan.normalized
    score = np.where(np.isnan(norm), np.inf, norm)
    out: List[PanMotif] = []
    claimed: List[tuple] = []
    w = score.shape[1]
    while len(out) < k:
        flat = int(score.argmin())
        r, i = divmod(flat, w)
        if not np.isfinite(score[r, i]):
            break
        m_r = int(pan.ms[r])
        j = int(pan.PMPI[r, i])
        # the source cell is unsuppressed, but its PARTNER may still
        # point into a claimed span (suppression masks sources only);
        # such a candidate is part of an already-extracted pattern —
        # drop the cell and keep scanning
        if any(j < hi and j + m_r > lo for lo, hi in claimed):
            score[r, i] = np.inf
            continue
        a, b = (i, j) if i <= j else (j, i)
        out.append(PanMotif(m_r, a, b, float(pan.PMP[r, i]),
                            float(norm[r, i])))
        _suppress_span(score, pan.ms, a, m_r)
        _suppress_span(score, pan.ms, b, m_r)
        claimed += [(a, a + m_r), (b, b + m_r)]
    return out


def pan_discords(pan: PanProfile, k: int = 3) -> List[PanMotif]:
    """k strongest variable-length discords: maxima of the normalized
    surface (windows far from EVERY other window at that length), with
    the same cross-length overlap suppression.  Returned as PanMotif
    records with ``b = PMPI`` (the nearest neighbor it is far from)."""
    norm = pan.normalized
    score = np.where(np.isnan(norm), -np.inf, norm)
    out: List[PanMotif] = []
    w = score.shape[1]
    while len(out) < k:
        flat = int(score.argmax())
        r, i = divmod(flat, w)
        if not np.isfinite(score[r, i]):
            break
        m_r = int(pan.ms[r])
        out.append(PanMotif(m_r, i, int(pan.PMPI[r, i]),
                            float(pan.PMP[r, i]), float(norm[r, i])))
        # suppress only the discord span itself (its neighbor is not an
        # anomaly) — mirror of the 1-D discord rule, across all lengths
        _suppress_span(score, pan.ms, i, m_r, fill=-np.inf)
    return out
