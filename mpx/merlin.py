"""Exact multi-length discord discovery (the MERLIN use case).

Beyond reference parity (the reference computes one fixed-m profile —
host/MatrixProfileHost.cpp:54-160): choosing the discord window length
is the classic anomaly-detection footgun, and MERLIN's answer is "run
every length".  mpx gets the same result EXACTLY from machinery it
already has, in two stages:

1. **Survey** — one fused pan sweep (mpx.pan_kernel) scores every
   window at every requested length in a single pass of the pair grid
   (the centered-QT panel is carried across levels, so the matmul
   volume is O(n^2 * max(m)), not O(n^2 * sum(m))).  f32-grade rows.
2. **Refine** — per length, every window whose approximate profile
   value is within ``2 * eps`` of the row maximum is re-scanned in full
   float64 on the host (the same independent oracle the benchmark
   validator uses, mpx.hybrid._row_scan); the exact maximum among them
   is the discord.  With the survey's absolute error bounded by
   ``eps``, the true discord is always inside that candidate band, so
   the result is exact — the hybrid tier's margin-rescore argument, one
   level up.

This trades MERLIN's adaptive-threshold early-abandon heuristics for
accelerator-shaped brute force: the survey is one matmul sweep regardless of how
many lengths are asked for, and the refine stage touches only the
candidate band.  Degenerate (zero-variance) windows and pad tails never
become candidates (they carry no valid neighbor).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from mpx.config import MatrixProfileConfig
from mpx.utils.logging import Logger

# Survey-error allowance (absolute, z-normalized distance units).  The
# fused pan tier is validated at 2e-3 against the exact per-m profiles
# (tests/test_pan.py); 5e-3 leaves a 2.5x safety factor.  The allowance
# is also CHECKED at runtime: the refine stage compares every rescored
# candidate's exact distance against its survey value, and a length
# whose observed error reaches eps is escalated to a full exact
# profile (see _per_length_extreme) — worse-conditioned inputs than the
# fuzz distribution degrade to slower, never to wrong.
_DEFAULT_EPS = 5e-3

# Refine-stage cap: candidate rows per length.  A band wider than this
# (near-constant or heavily repeating inputs) ESCALATES that length to
# an exact full profile through the hybrid f64 tier — still exact, one
# extra device sweep (escalate=False restores the round-3 truncation
# behavior: rescore only the strongest _MAX_CANDIDATES, reported in
# MerlinResult.truncated_lengths and no longer claimed exact).
_MAX_CANDIDATES = 4096


class LengthDiscord(NamedTuple):
    m: int            # window length
    index: int        # discord start
    nn_index: int     # its (exact) nearest neighbor
    distance: float   # exact f64 z-normalized NN distance
    score: float      # length-normalized distance d / (2*sqrt(m))


class MerlinResult(NamedTuple):
    per_length: List[LengthDiscord]  # exact top-1 discord per length
    top: List[LengthDiscord]         # k best across lengths, overlap-
                                     # suppressed, by normalized score
    # lengths where the candidate band overflowed (or the survey error
    # check tripped) and the length was re-swept exactly instead:
    escalated_lengths: List[int] = []
    # lengths where escalate=False truncated the band: their per_length
    # entry is "best of the strongest _MAX_CANDIDATES", NOT exact
    truncated_lengths: List[int] = []

    @property
    def exact(self) -> bool:
        """True iff every per-length entry carries the exactness
        guarantee (no truncated lengths)."""
        return not self.truncated_lengths


def _exact_row_rescore(T64, m: int, rows: np.ndarray):
    """Exact f64 (distance, nn_index) for the given rows."""
    from mpx import native
    from mpx.hybrid import _row_scan
    from mpx.ops.precompute import precompute_statistics_numpy

    w = T64.shape[0] - m + 1
    s = (native.precompute(T64, m) if native.is_available()
         else precompute_statistics_numpy(T64, m))
    P, I = _row_scan(T64, np.asarray(s["mu"], np.float64),
                     np.asarray(s["inv"], np.float64),
                     m, w, m // 4, rows.astype(np.int32))
    D = np.sqrt(np.maximum(2.0 * m * (1.0 - P), 0.0))
    return D, I


def multi_length_discords(
    T,
    lo: Optional[int] = None,
    hi: Optional[int] = None,
    *,
    ms: Optional[Sequence[int]] = None,
    k: int = 3,
    eps: float = _DEFAULT_EPS,
    escalate: bool = True,
    config: Optional[MatrixProfileConfig] = None,
) -> MerlinResult:
    """Exact top-1 discord at EVERY length in [lo, hi] (or the explicit
    ``ms`` list), plus the ``k`` strongest across lengths.

    The cross-length ranking uses the SKIMP normalization
    ``d / (2*sqrt(m))`` so lengths are comparable, and suppresses
    overlapping spans (a discord at one length shadows the same event
    at nearby lengths).

    ``escalate`` (default True) keeps the exactness guarantee
    unconditional: a length whose candidate band overflows
    _MAX_CANDIDATES, or whose observed survey error reaches ``eps``,
    is re-swept as a full exact-f64 profile (reported in
    ``result.escalated_lengths``).  ``escalate=False`` restores the
    cheaper truncation behavior; affected lengths land in
    ``result.truncated_lengths`` and ``result.exact`` turns False."""
    T = np.asarray(T)
    if ms is None:
        if lo is None or hi is None:
            raise ValueError("pass lo/hi or an explicit ms list")
        if lo < 4:
            raise ValueError("m must be >= 4 (exclusion zone is m/4)")
        if hi < lo:
            raise ValueError(f"empty length range [{lo}, {hi}]")
        ms = range(lo, hi + 1)
    ms_arr = np.unique(np.asarray(list(ms), dtype=np.int64))
    if ms_arr.size == 0:
        raise ValueError("ms is empty")
    if k < 1:
        raise ValueError("k must be >= 1")

    from mpx.pan import compute_pan_profile

    pan = compute_pan_profile(T, [int(m) for m in ms_arr],
                              config=config, method="fused")
    T64 = np.asarray(T, np.float64)

    per_length, escalated, truncated = _per_length_extreme(
        pan, T64, eps, mode="discord", escalate=escalate, config=config)
    top = _rank_suppress(per_length, k, best_first=True)
    return MerlinResult(per_length=per_length, top=top,
                        escalated_lengths=escalated,
                        truncated_lengths=truncated)


def _exact_extreme_full(T64, m: int, mode: str,
                        config) -> Optional[LengthDiscord]:
    """Escalation path: the exact extremum at one length from a full
    exact-f64 profile (hybrid tier — device f32 sweeps + host rescore,
    itself escalation-proof on tie-heavy data)."""
    import dataclasses

    from mpx.hybrid import compute_matrix_profile_f64_hybrid

    if config is None:
        cfg = MatrixProfileConfig(m=m, dtype="float64")
    else:
        cfg = dataclasses.replace(config, m=m, dtype="float64",
                                  kernel="auto")
    MP, MPI = compute_matrix_profile_f64_hybrid(T64, cfg)
    matched = np.isfinite(MP) & (MPI >= 0)
    if not matched.any():
        return None
    sign = 1.0 if mode == "discord" else -1.0
    i = int(np.argmax(np.where(matched, sign * MP, -np.inf)))
    return LengthDiscord(
        m=m, index=i, nn_index=int(MPI[i]), distance=float(MP[i]),
        score=float(MP[i] / (2.0 * np.sqrt(m))),
    )


def _per_length_extreme(pan, T64, eps: float, mode: str,
                        escalate: bool = True, config=None):
    """Exact per-length extremum of the profile (max for discords, min
    for motifs) via the margin-candidate-band + f64 rescore argument:
    with the survey error bounded by ``eps``, the true extremum's
    approximation lies within ``2*eps`` of the approximate extremum, so
    rescoring that band exactly finds it.

    Two defenses keep "exact" honest (both land in the result object):

    * candidate-band overflow (> _MAX_CANDIDATES near-tied rows) — the
      length is re-swept exactly (escalate=True, default) or truncated
      to the strongest cap with the length recorded as truncated;
    * the eps ASSUMPTION is verified per length: the rescored
      candidates' exact distances are compared against their survey
      values, and an observed error >= eps escalates the length (the
      band may have been too narrow — silently trusting it could miss
      the true extremum on inputs conditioned worse than the fuzz
      distribution, e.g. large DC offsets).

    Returns (entries, escalated_lengths, truncated_lengths)."""
    n = T64.shape[0]
    sign = 1.0 if mode == "discord" else -1.0
    out: List[LengthDiscord] = []
    escalated: List[int] = []
    truncated: List[int] = []
    for r, m in enumerate(pan.ms):
        m = int(m)
        wm = n - m + 1
        row = pan.PMP[r, :wm]
        matched = np.isfinite(row) & (pan.PMPI[r, :wm] >= 0)
        if not matched.any():
            continue
        approx = np.where(matched, sign * row, -np.inf)
        cut = float(approx.max()) - 2.0 * eps
        cand = np.nonzero(approx >= cut)[0]
        if cand.shape[0] > _MAX_CANDIDATES:
            if escalate:
                Logger.info(
                    f"merlin m={m}: candidate band {cand.shape[0]} > "
                    f"{_MAX_CANDIDATES}; escalating to a full exact "
                    f"profile at this length"
                )
                entry = _exact_extreme_full(T64, m, mode, config)
                if entry is not None:
                    out.append(entry)
                    escalated.append(m)
                continue
            Logger.warning(
                f"merlin m={m}: candidate band {cand.shape[0]} > "
                f"{_MAX_CANDIDATES}; rescoring only the strongest "
                f"{_MAX_CANDIDATES} (near-tied {mode}s) — NOT exact "
                f"(escalate=False)"
            )
            cand = cand[np.argsort(approx[cand])[::-1][:_MAX_CANDIDATES]]
            truncated.append(m)
        D, I = _exact_row_rescore(T64, m, cand)
        # a candidate can be degenerate only in exact f64 (its f32
        # survey variance rounded away from zero): no valid neighbor
        # there means no extremum, not an astronomical one
        Ds = np.where(I >= 0, sign * D, -np.inf)
        if not np.isfinite(Ds).any():
            continue
        # runtime check of the eps allowance over the rescored band
        chk = (I >= 0) & np.isfinite(row[cand])
        if chk.any():
            observed = float(np.abs(row[cand][chk] - D[chk]).max())
            if observed >= eps:
                if escalate:
                    Logger.warning(
                        f"merlin m={m}: observed survey error "
                        f"{observed:.2e} >= eps {eps:.2e}; escalating to "
                        f"a full exact profile at this length"
                    )
                    entry = _exact_extreme_full(T64, m, mode, config)
                    if entry is not None:
                        out.append(entry)
                        escalated.append(m)
                    continue
                Logger.warning(
                    f"merlin m={m}: observed survey error {observed:.2e} "
                    f">= eps {eps:.2e} with escalate=False — NOT exact"
                )
                if m not in truncated:
                    truncated.append(m)
        best = int(np.argmax(Ds))
        idx = int(cand[best])
        out.append(LengthDiscord(
            m=m, index=idx, nn_index=int(I[best]),
            distance=float(D[best]),
            score=float(D[best] / (2.0 * np.sqrt(m))),
        ))
    return out, escalated, truncated


def _rank_suppress(per_length: List[LengthDiscord], k: int,
                   best_first: bool) -> List[LengthDiscord]:
    """Cross-length ranking (normalized score) with span suppression;
    motifs (best_first=False → ascending score) suppress BOTH of the
    pair's spans."""
    order = sorted(per_length, key=lambda d: d.score, reverse=best_first)
    top: List[LengthDiscord] = []
    taken: List[tuple] = []
    for d in order:
        spans = [(d.index, d.index + d.m)]
        if not best_first and d.nn_index >= 0:
            spans.append((d.nn_index, d.nn_index + d.m))
        if any(s0 < t1 and t0 < s1 for s0, s1 in spans
               for t0, t1 in taken):
            continue
        top.append(d)
        taken.extend(spans)
        if len(top) >= k:
            break
    return top


def multi_length_motifs(
    T,
    lo: Optional[int] = None,
    hi: Optional[int] = None,
    *,
    ms: Optional[Sequence[int]] = None,
    k: int = 3,
    eps: float = _DEFAULT_EPS,
    escalate: bool = True,
    config: Optional[MatrixProfileConfig] = None,
) -> MerlinResult:
    """Exact top-1 MOTIF pair at every length in [lo, hi] (the VALMOD
    question, answered by the same survey + margin-rescore machinery as
    :func:`multi_length_discords` with the extremum flipped): per
    length, the pair at minimum z-normalized distance, exactly.  The
    cross-length ``top`` ranks by ``d / (2*sqrt(m))`` ascending and
    suppresses BOTH spans of each chosen pair.  ``escalate`` as in
    :func:`multi_length_discords` (overflow/eps-violation lengths are
    re-swept exactly by default)."""
    T = np.asarray(T)
    if ms is None:
        if lo is None or hi is None:
            raise ValueError("pass lo/hi or an explicit ms list")
        if lo < 4:
            raise ValueError("m must be >= 4 (exclusion zone is m/4)")
        if hi < lo:
            raise ValueError(f"empty length range [{lo}, {hi}]")
        ms = range(lo, hi + 1)
    ms_arr = np.unique(np.asarray(list(ms), dtype=np.int64))
    if ms_arr.size == 0:
        raise ValueError("ms is empty")
    if k < 1:
        raise ValueError("k must be >= 1")

    from mpx.pan import compute_pan_profile

    pan = compute_pan_profile(T, [int(m) for m in ms_arr],
                              config=config, method="fused")
    T64 = np.asarray(T, np.float64)
    per_length, escalated, truncated = _per_length_extreme(
        pan, T64, eps, mode="motif", escalate=escalate, config=config)
    top = _rank_suppress(per_length, k, best_first=False)
    return MerlinResult(per_length=per_length, top=top,
                        escalated_lengths=escalated,
                        truncated_lengths=truncated)


def brute_force_multi_length_discords(T, ms: Sequence[int]) -> List[LengthDiscord]:
    """O(sum_m w_m^2 m) oracle: exact discord per length from the dense
    golden profile (test-scale only)."""
    from mpx.reference import compute_matrix_profile_reference

    T64 = np.asarray(T, np.float64)
    out: List[LengthDiscord] = []
    for m in np.unique(np.asarray(list(ms), dtype=np.int64)):
        m = int(m)
        MP, MPI = compute_matrix_profile_reference(T64, m)
        matched = np.isfinite(MP) & (MPI >= 0)
        if not matched.any():
            continue
        score = np.where(matched, MP, -np.inf)
        i = int(np.argmax(score))
        out.append(LengthDiscord(
            m=m, index=i, nn_index=int(MPI[i]), distance=float(MP[i]),
            score=float(MP[i] / (2.0 * np.sqrt(m))),
        ))
    return out


def brute_force_multi_length_motifs(T, ms: Sequence[int]) -> List[LengthDiscord]:
    """O(sum_m w_m^2 m) oracle: exact motif pair per length."""
    from mpx.reference import compute_matrix_profile_reference

    T64 = np.asarray(T, np.float64)
    out: List[LengthDiscord] = []
    for m in np.unique(np.asarray(list(ms), dtype=np.int64)):
        m = int(m)
        MP, MPI = compute_matrix_profile_reference(T64, m)
        matched = np.isfinite(MP) & (MPI >= 0)
        if not matched.any():
            continue
        score = np.where(matched, MP, np.inf)
        i = int(np.argmin(score))
        out.append(LengthDiscord(
            m=m, index=i, nn_index=int(MPI[i]), distance=float(MP[i]),
            score=float(MP[i] / (2.0 * np.sqrt(m))),
        ))
    return out
