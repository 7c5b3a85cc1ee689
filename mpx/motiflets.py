"""k-Motiflets: find the k most similar occurrences of a motif.

Motiflets (Schaefer & Leser, PVLDB 16(3), 2022) replace the classic
radius parameter of set-motif discovery with the intuitive "how many
occurrences" parameter k: a *k-motiflet* is the set of k non-overlapping
windows minimizing the **extent** — the largest pairwise z-normalized
distance within the set.  The elbow curve of extents over k reveals how
often a motif truly repeats.

Device-first split: all O(n^2) similarity work runs on the device top-k
tier (mpx/topk.py — matmul sweeps; exact-f64 hybrid rescoring for the
double dtype), which yields every window's nearest-neighbor list.  The
host then does the O(candidates * k^2) combinatorial part of the paper's
approximate algorithm: rank seeds by their (k-1)-th neighbor distance (a
lower bound on any extent through that seed), greedily assemble each
seed's non-overlapping neighbor set, and score exact pairwise extents.
Seeds whose device list runs out of non-overlapping neighbors fall back
to one exact host MASS row (analysis.mass) — rare, and O(n m) each.

(Reference scope note: matrix-profile-hls computes 1-NN profiles only —
host/MatrixProfileHost.cpp:54-160; motif SETS are an mpx beyond-parity
tier like chains/snippets/contrast.)
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from mpx.config import MatrixProfileConfig
from mpx.reference import exclusion_zone


class Motiflet(NamedTuple):
    indices: np.ndarray   # (k,) sorted window positions
    extent: float         # max pairwise z-norm distance within the set
    k: int


def _unit_windows(T64: np.ndarray, m: int, idx: np.ndarray) -> np.ndarray:
    """Unit-normalized windows at ``idx`` (host, tiny: |idx| x m)."""
    wins = np.stack([T64[i : i + m] for i in idx])
    v = wins - wins.mean(axis=1, keepdims=True)
    nrm = np.linalg.norm(v, axis=1, keepdims=True)
    nrm = np.where(nrm == 0.0, np.inf, nrm)
    return v / nrm


def pairwise_extent(T64: np.ndarray, m: int, idx: Sequence[int]) -> float:
    """Exact max pairwise z-norm distance among the windows at ``idx``."""
    idx = np.asarray(sorted(int(i) for i in idx), np.int64)
    U = _unit_windows(T64, m, idx)
    C = np.clip(U @ U.T, -1.0, 1.0)
    D = np.sqrt(np.maximum(2.0 * m * (1.0 - C), 0.0))
    np.fill_diagonal(D, 0.0)
    return float(D.max())


def _greedy_set(seed: int, order: np.ndarray, dists: np.ndarray,
                need: int, zone: int) -> tuple[list, bool]:
    """Take the ``need`` nearest candidates (ascending ``dists`` order)
    pairwise non-overlapping with ``seed`` and each other."""
    chosen: List[int] = [int(seed)]
    for j, d in zip(order, dists):
        if len(chosen) - 1 >= need:
            break
        j = int(j)
        if j < 0 or not np.isfinite(d):
            continue
        if all(abs(j - c) >= zone for c in chosen):
            chosen.append(j)
    return chosen, len(chosen) - 1 >= need


def k_motiflets(
    T,
    k: int,
    m: Optional[int] = None,
    config: Optional[MatrixProfileConfig] = None,
    *,
    candidates: int = 64,
) -> Motiflet:
    """The (approximate) k-motiflet of ``T``: k non-overlapping windows
    with minimal extent.  ``candidates`` bounds the host refinement
    (seeds examined, best-bound first); raising it trades time for
    approximation quality.
    """
    return _motiflets_impl(T, [k], m, config, candidates)[0]


def motiflet_elbows(
    T,
    kmax: int,
    m: Optional[int] = None,
    config: Optional[MatrixProfileConfig] = None,
    *,
    candidates: int = 64,
):
    """Motiflets for every k in 2..kmax (one shared device sweep) plus
    the elbow points — the k values after which the extent jumps most
    (the natural occurrence counts of the data's motifs).

    Returns ``(results, elbows)``: a list of :class:`Motiflet` and the
    descending-significance list of elbow k's.
    """
    ks = list(range(2, kmax + 1))
    if not ks:
        raise ValueError("kmax must be >= 2")
    results = _motiflets_impl(T, ks, m, config, candidates)
    ext = np.asarray([r.extent for r in results])
    # jump significance of elbow k = extent(k+1) / extent(k); guard 0/inf
    jumps = []
    for i in range(len(ks) - 1):
        lo = max(float(ext[i]), 1e-12)
        hi = float(ext[i + 1])
        if np.isfinite(hi):
            jumps.append((hi / lo, ks[i]))
    elbows = [kk for ratio, kk in sorted(jumps, reverse=True)
              if ratio > 1.0]
    return results, elbows


def _motiflets_impl(T, ks: Sequence[int], m, config,
                    candidates: int) -> List[Motiflet]:
    from mpx.topk import compute_topk_profile

    if config is None:
        config = MatrixProfileConfig(m=m if m is not None else 32)
    elif m is not None and m != config.m:
        raise ValueError(f"m={m} conflicts with config.m={config.m}")
    m = config.m
    ks = sorted(set(int(k) for k in ks))
    if ks[0] < 2:
        raise ValueError("a motiflet needs k >= 2 occurrences")
    T64 = np.asarray(T, np.float64)
    w = T64.shape[0] - m + 1
    dmax = ks[-1] - 1
    zone = max(exclusion_zone(m), m // 2)
    if (dmax + 1) * zone > w:
        raise ValueError(
            f"k={ks[-1]} non-overlapping windows of {m} do not fit in "
            f"{T64.shape[0]} points")

    # Device sweep: per-window neighbor lists.  The fast tiers cap at
    # k=8 (hybrid capture width); wider lists top up via host MASS rows
    # for the examined candidates only.
    kk = min(max(dmax + 2, 4), 8)
    D, I = compute_topk_profile(T64, config=config, k=kk)
    D = np.asarray(D, np.float64)
    I = np.asarray(I)

    # Seed ranking: the d-th neighbor distance bounds any extent of a
    # set through that seed from below.  One shared candidate pool for
    # every requested k (ranked by the LARGEST k's bound).
    bound = D[:, min(dmax - 1, kk - 1)]
    order = np.argsort(np.where(np.isfinite(bound), bound, np.inf))
    seeds: List[int] = []
    for i in order:
        if not np.isfinite(bound[i]):
            break
        if len(seeds) >= candidates:
            break
        if all(abs(int(i) - s) >= zone for s in seeds):
            seeds.append(int(i))

    full_rows: dict = {}

    def row(i: int) -> np.ndarray:
        if i not in full_rows:
            from mpx.analysis import mass

            r = mass(T64[i : i + m], T64)
            lo = max(0, i - zone + 1)
            r[lo : i + zone] = np.inf
            full_rows[i] = r
        return full_rows[i]

    out: List[Motiflet] = []
    for k in ks:
        need = k - 1
        best: Optional[Motiflet] = None
        for s in seeds:
            # D[s, j] ignores overlap constraints, so it lower-bounds
            # the extent of ANY k-set through s (clamping to the device
            # list width only weakens the bound, still sound); inf means
            # too few valid windows exist for this k at all.
            if best is not None and \
                    D[s, min(need - 1, kk - 1)] >= best.extent:
                continue
            chosen, ok = _greedy_set(s, I[s], D[s], need, zone)
            if not ok:
                # device list exhausted by overlaps: one exact host row
                r = row(s)
                chosen, ok = _greedy_set(s, np.argsort(r), np.sort(r),
                                         need, zone)
                if not ok:
                    continue
            ext = pairwise_extent(T64, m, chosen)
            if best is None or ext < best.extent:
                best = Motiflet(
                    indices=np.asarray(sorted(chosen), np.int64),
                    extent=ext, k=k)
        if best is None:
            best = Motiflet(indices=np.zeros(0, np.int64),
                            extent=float("inf"), k=k)
        out.append(best)
    return out
