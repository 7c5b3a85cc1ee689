"""FLOSS: online (streaming) semantic segmentation.

The batch FLUSS pipeline (mpx/analysis.py: corrected_arc_curve +
extract_regimes) scores regime boundaries from nearest-neighbor arcs of
a finished profile.  FLOSS is its streaming counterpart: maintain the
arcs over an unbounded stream inside a bounded window and re-score after
every append.  (Reference scope note: matrix-profile-hls computes raw
profiles only — host/MatrixProfileHost.cpp:54-160 is one batch run —
segmentation is an mpx beyond-parity tier, like motifs/discords.)

Design: the expensive part of a FLOSS step is the rectangle
sweep of the new subsequences against the window, and that is exactly
the windows-matmul `StreamingMatrixProfile` already runs on device —
this module adds only the two O(window) host steps (analytic
one-directional CAC + valley extraction).  Two properties make the
streaming state EXACT (not the usual approximation caveat):

* right arcs only ever IMPROVE as the stream grows (a new window can
  only add right-neighbor candidates), and `_append_step`'s column
  merge applies exactly that improvement;
* right arcs point from older to newer windows, so sliding-window
  egress is a pure head-trim — no surviving window's neighbor can be
  discarded (`StreamingMatrixProfile.trim_head`).

Hence `Floss.cac()` equals the batch one-directional CAC of the current
window, byte-for-byte at f64 (tests/test_floss.py), while appends cost
O(k * window) MXU pairs and trims amortize to O(1)/point.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from mpx.analysis import extract_regimes, one_directional_cac
from mpx.streaming import StreamingMatrixProfile


class Floss:
    """Streaming semantic segmentation over a sliding window.

    >>> fl = Floss(T0, m=64, window=4096)
    >>> fl.append(points)              # any chunk size, O(k * window)
    >>> fl.cac()                       # one-directional CAC, len = w
    >>> fl.regimes(k=1)                # ABSOLUTE stream positions
    >>> fl.score                       # min CAC (lower = stronger boundary)

    ``window`` is the retained span in POINTS (default: the initial
    series length).  The device state is allowed to grow to
    ``slack * window`` before one amortized trim back to ``window``, so
    per-point cost stays O(window) worst-case, O(1) amortized for the
    trim itself.
    """

    def __init__(self, T, m: int, window: Optional[int] = None,
                 dtype: str = "float32", slack: float = 2.0):
        T = np.asarray(T, np.float64)
        if window is None:
            window = T.shape[0]
        if window < m + m // 4:
            raise ValueError(f"window {window} < m + m//4 = {m + m // 4}")
        if slack <= 1.0:
            raise ValueError("slack must be > 1 (trim hysteresis)")
        self.m = m
        self.window = int(window)
        self.slack = float(slack)
        init_drop = max(0, T.shape[0] - window)
        self._smp = StreamingMatrixProfile(
            T[init_drop:], m, dtype=dtype, mode="right"
        )
        # absolute stream positions count from the START of the initial
        # series, including any part the window never retained
        self._smp.offset = init_drop

    @property
    def offset(self) -> int:
        """Absolute stream position of the window's first point."""
        return self._smp.offset

    @property
    def series(self) -> np.ndarray:
        """The currently retained points."""
        return self._smp.series

    def append(self, points) -> None:
        points = np.atleast_1d(np.asarray(points, np.float64))
        self._smp.append(points)
        n = self._smp.series.shape[0]
        if n > self.slack * self.window:
            self._smp.trim_head(n - self.window)

    def profile(self):
        """Current right matrix profile (MP, MPI) of the window; MPI is
        window-relative (add ``offset`` for stream positions)."""
        return self._smp.profile()

    def cac(self) -> np.ndarray:
        """One-directional corrected arc curve over the current window."""
        _, MPI = self._smp.profile()
        return one_directional_cac(MPI, self.m)

    @property
    def score(self) -> float:
        """min(CAC): 1.0 = no boundary evidence, toward 0 = boundary."""
        return float(self.cac().min())

    def regimes(self, k: int = 1) -> List[int]:
        """k strongest regime boundaries, in ABSOLUTE stream positions."""
        off = self.offset
        return [off + r for r in extract_regimes(self.cac(), self.m, k=k)]
