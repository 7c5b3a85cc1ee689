"""DAMP-style online anomaly detection (left-discord monitoring).

DAMP (Lu et al., KDD 2022 — "Matrix Profile XXIV") scores each arriving
window by its *left profile* value: the z-normalized distance to the
nearest EARLIER window.  A window far from everything that came before
it is an anomaly the moment it arrives — no future data needed, no
retroactive score changes (the left profile is append-stable), which is
exactly the contract a production monitor needs.

Design: DAMP's CPU contribution is backward-pruned search to dodge the
O(n^2) cost; mpx instead makes the exact computation cheap — the batch
scorer is the standard device left/right tier (one matmul job sweep),
and the online scorer is the
streaming tier's O(k*n) append rectangle in ``mode='left'``
(mpx/streaming.py: new rows sweep earlier columns only; no column
merge, so emitted scores are final).  Each append fetches only its own
k scores (``row_values``) — nothing O(n) crosses the host boundary.

(Reference scope note: matrix-profile-hls computes batch 1-NN profiles
only — host/MatrixProfileHost.cpp:54-160; anomaly monitoring is an mpx
beyond-parity tier like FLOSS/chains.)
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

from mpx.config import MatrixProfileConfig


class Anomaly(NamedTuple):
    index: int        # absolute window position in the stream
    distance: float   # left-profile distance when it arrived


class DampResult(NamedTuple):
    scores: np.ndarray    # (w,) left-profile distances (aMP)
    discords: List[Anomaly]  # top anomalies, strongest first
    split: int            # scores before this window index are training


def compute_damp(
    T,
    m: Optional[int] = None,
    config: Optional[MatrixProfileConfig] = None,
    *,
    split: int = 0,
    k: int = 3,
) -> DampResult:
    """Batch DAMP: exact left profile of ``T``, anomalies ranked over
    windows >= ``split`` (the training prefix is never scored).  The
    top anomaly equals DAMP's best-so-far discord, computed exactly.
    """
    from mpx.driver import compute_matrix_profile
    from mpx.reference import exclusion_zone

    if config is None:
        config = MatrixProfileConfig(m=m if m is not None else 32)
    elif m is not None and m != config.m:
        raise ValueError(f"m={m} conflicts with config.m={config.m}")
    m = config.m
    MPl, MPIl, _, _ = compute_matrix_profile(T, config=config,
                                             left_right=True)
    scores = np.asarray(MPl, np.float64)
    idx = np.asarray(MPIl)
    w = scores.shape[0]
    if not 0 <= split < w:
        raise ValueError(f"split {split} outside [0, {w})")
    # untouched entries (no earlier neighbor, e.g. the first windows)
    # are not anomalies — they are unscorable
    scorable = (idx >= 0) & np.isfinite(scores)
    ranked = np.where(scorable, scores, -np.inf).copy()
    ranked[:split] = -np.inf
    zone = max(exclusion_zone(m), m // 2)
    discords: List[Anomaly] = []
    for _ in range(max(k, 0)):
        i = int(ranked.argmax())
        if not np.isfinite(ranked[i]):
            break
        discords.append(Anomaly(index=i, distance=float(scores[i])))
        lo = max(0, i - zone + 1)
        ranked[lo : i + zone] = -np.inf
    return DampResult(scores=scores, discords=discords, split=split)


class OnlineAnomalyDetector:
    """Streaming DAMP: score every arriving window on append.

    >>> det = OnlineAnomalyDetector(T_train, m=64, threshold=None)
    >>> alerts = det.append(points)   # windows beating the discord
    >>> det.discord                   # best-so-far anomaly
    >>> det.scores(lo, hi)            # any scored span, O(hi-lo)

    ``threshold``: absolute distance above which a window alerts;
    ``None`` alerts whenever a window beats the best-so-far discord
    (DAMP's BSF semantics).  Training windows (the initial series)
    establish state but never alert.
    """

    def __init__(self, T_train, m: Optional[int] = None,
                 config: Optional[MatrixProfileConfig] = None,
                 *, threshold: Optional[float] = None):
        from mpx.streaming import StreamingMatrixProfile

        if config is None:
            config = MatrixProfileConfig(m=m if m is not None else 32)
        elif m is not None and m != config.m:
            raise ValueError(f"m={m} conflicts with config.m={config.m}")
        self.m = config.m
        self.threshold = threshold
        self._smp = StreamingMatrixProfile(
            T_train, self.m, dtype=str(config.dtype), mode="left")
        self.split = self._smp._w  # first scorable window
        self._bsf: Optional[Anomaly] = None

    @property
    def series(self) -> np.ndarray:
        return self._smp.series

    def profile(self):
        """The full left profile so far (MP_left, MPI_left) — O(n)
        fetch; per-append consumers should use :meth:`scores`."""
        return self._smp.profile()

    @property
    def discord(self) -> Optional[Anomaly]:
        """Best-so-far anomaly among scored (post-training) windows."""
        return self._bsf

    def scores(self, lo: int, hi: int) -> np.ndarray:
        """Left-profile distances for windows [lo, hi); O(hi-lo)."""
        return self._smp.row_values(lo, hi)

    def append(self, points) -> List[Anomaly]:
        """Ingest points; return alerts among the new windows.

        Scores are final on emission (left profiles are append-stable).
        Cost: one O(k * n) device rectangle + an O(k) fetch.
        """
        old_w = self._smp._w
        self._smp.append(points)
        w = self._smp._w
        if w == old_w:
            return []
        vals = self._smp.row_values(old_w, w)
        # untouched slots (flat windows: masked out of every sweep)
        # carry the -1e12 aggregate init, i.e. distances near
        # sqrt(2m(1+1e12)) — unscorable, not anomalies
        smax = np.sqrt(2.0 * self.m * (1.0 + 1e11))
        alerts: List[Anomaly] = []
        for j, d in enumerate(vals):
            if not np.isfinite(d) or d >= smax:
                continue
            a = Anomaly(index=old_w + j, distance=float(d))
            if self._bsf is None or d > self._bsf.distance:
                self._bsf = a
                if self.threshold is None:
                    alerts.append(a)
            if self.threshold is not None and d > self.threshold:
                alerts.append(a)
        return alerts
