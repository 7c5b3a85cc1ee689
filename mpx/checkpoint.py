"""Job-level checkpoint / resume.

The reference has no checkpointing; its host-side aggregate arrays are
exactly the state one would persist between diagonal chunks (SURVEY §5;
reference analog: the host aggregate arrays of
/root/reference/host/MatrixProfileHost.cpp:41).  mpx makes that a real
feature: the job grid is processed in groups, and after each group the
partial row/column aggregates (plus a config/input fingerprint and the
next group index) are written atomically to an .npz.  A rerun with the
same input and config resumes at the first unfinished group; anything
else starts fresh.

Two tiers are resumable:

* the straight sweep tiers (mxu/xla, any dtype) via
  :func:`compute_with_checkpoint`'s group loop below;
* the hybrid exact-f64 tier — the flagship path — via
  :class:`HybridCheckpoint`, which persists pass-A maxima and pass-B
  suspect state at dispatch-group granularity (see the class docstring
  for the exactness argument).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile

import jax.numpy as jnp
import numpy as np

from mpx.config import MatrixProfileConfig, make_job_grid, pad_job_grid
from mpx.dtypes import canonical_dtype
from mpx.driver import run_jobs, _agg_length
from mpx.hybrid import HYBRID_PRECISION
from mpx.kernels import resolve_kernel
from mpx.ops.aggregates import init_aggregates, postcompute
from mpx.ops.precompute import precompute_statistics
from mpx.dtypes import AGGREGATE_INIT
from mpx.types import Aggregates
from mpx.utils.logging import Logger
from mpx.utils.profile import phase as _phase


def _fingerprint(T: np.ndarray, cfg: MatrixProfileConfig, w: int,
                 group_jobs: int = 0, kernel: str = "") -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(np.asarray(T, np.float64)).tobytes())
    meta = json.dumps(
        {
            "m": cfg.m,
            "dtype": str(canonical_dtype(cfg.dtype)),
            "band": cfg.band,
            "chunk": cfg.chunk,
            "w": w,
            # group size defines what next_group indexes; resuming with a
            # different grouping would skip or repeat jobs
            "group_jobs": group_jobs,
            # resolved kernel: merging partial aggregates produced by a
            # different backend stays within tolerance but is not
            # reproducible against an uninterrupted run
            "kernel": kernel,
        },
        sort_keys=True,
    )
    h.update(meta.encode())
    return h.hexdigest()


def _save(path: str, rows: Aggregates, cols: Aggregates, next_group: int, fp: str):
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)) or ".")
    os.close(fd)
    try:
        np.savez(
            tmp,
            rows_value=np.asarray(rows.value),
            rows_index=np.asarray(rows.index),
            cols_value=np.asarray(cols.value),
            cols_index=np.asarray(cols.index),
            next_group=next_group,
            fingerprint=fp,
        )
        os.replace(tmp + ".npz", path)
    finally:
        # a crash between savez and replace must not leave stray temp
        # files accumulating in the checkpoint directory
        for stray in (tmp, tmp + ".npz"):
            if os.path.exists(stray):
                os.remove(stray)


def _load(path: str, fp: str):
    if not os.path.exists(path):
        return None
    try:
        data = np.load(path, allow_pickle=False)
    except Exception as e:  # corrupt checkpoint -> start fresh
        Logger.warning(f"ignoring unreadable checkpoint {path}: {e}")
        return None
    if str(data["fingerprint"]) != fp:
        Logger.warning(f"checkpoint {path} does not match input/config; ignoring")
        return None
    rows = Aggregates(jnp.asarray(data["rows_value"]), jnp.asarray(data["rows_index"]))
    cols = Aggregates(jnp.asarray(data["cols_value"]), jnp.asarray(data["cols_index"]))
    return rows, cols, int(data["next_group"])


class HybridCheckpoint:
    """Pass-level checkpoint for the hybrid f64 tier (single device).

    Stage ``A`` persists the pass-A partial (rmax, cmax) maxima and the
    next dispatch-group index after every group.  The per-job captured
    maxima (the sparse pass-B skip oracle) are deliberately NOT
    persisted — at the showcase geometry they are ~0.5 GB against
    rmax/cmax's ~8 MB; jobs whose captures were lost to a crash simply
    re-sweep DENSELY in pass B.  Exactness is unaffected: the dense
    suspect sweep captures precisely the pairs at the threshold that
    the sparse sweep would (the oracle only skips rows provably without
    suspects), and all suspect merges are associative and commutative
    (merge networks — mpx.hybrid._combine_suspects), so the final
    profile is identical to an uninterrupted run.

    Stage ``B`` persists the pass-A threshold, the partial
    SuspectWindow arrays, and a done-mask over the canonical job grid
    after every dispatch batch.  Only jobs whose captures actually
    merged are marked done (sparse-overflow jobs stay pending until
    their dense re-sweep lands).  On resume, pending jobs re-sweep
    densely from the loaded state.

    The resolution stages (exact rescore / pass C / escalation) run in
    seconds even at n=2M and are rerun from scratch on resume.  Saves
    device_get the suspect state (~9 words/subsequence).

    ``group_jobs`` is the unit of work persisted: pass A saves after
    every group of that many jobs, and pass B after every group or
    sparse-tier batch.  A checkpoint records the sweep precision it was
    written under; one from another precision is refused on resume
    (see _load_raw).
    """

    STAGE_A = "A"
    STAGE_B = "B"
    group_jobs = 512

    def __init__(self, path: str, fp: str, grid):
        self.path = path
        self.fp = fp
        self._index = {
            (int(r), int(k)): i
            for i, (r, k) in enumerate(zip(grid.r0, grid.k0))
        }
        self.njobs = len(self._index)
        self.done = np.zeros(self.njobs, bool)
        self.thr = None
        # stage-A resume: job groups whose device captures were lost
        # (the orchestrator forces these through the dense pass B)
        self.uncaptured: list = []
        self._state = None
        data = _load_raw(path, fp)
        if data is not None:
            self._state = data

    # -- stage A ----------------------------------------------------
    def load_a(self):
        if self._state is None or str(self._state["stage"]) != self.STAGE_A:
            return None
        return (
            self._state["rmax"],
            self._state["cmax"],
            int(self._state["next_group"]),
        )

    def save_a(self, rmax, cmax, next_group: int):
        _save_npz(
            self.path,
            stage=self.STAGE_A,
            rmax=np.asarray(rmax),
            cmax=np.asarray(cmax),
            next_group=next_group,
            fingerprint=self.fp,
            precision=HYBRID_PRECISION,
        )

    # -- stage B ----------------------------------------------------
    def begin_b(self, thr):
        self.thr = np.asarray(thr)

    def load_b(self):
        if self._state is None or str(self._state["stage"]) != self.STAGE_B:
            return None
        self.thr = self._state["thr"]
        self.done = self._state["done"].astype(bool)
        return self._state

    def mark_done_and_save(self, rows_g, cols_g, r0s, k0s, keep=None):
        """Mark the batch's (non-pad, kept) jobs done and persist the
        suspect state.  ``keep`` masks out jobs that contributed nothing
        this batch (sparse flag-budget overflows)."""
        import jax

        r0s = np.asarray(r0s)
        k0s = np.asarray(k0s)
        for i, (r, k) in enumerate(zip(r0s, k0s)):
            if keep is not None and not keep[i]:
                continue
            j = self._index.get((int(r), int(k)))
            if j is not None:
                self.done[j] = True
        rows_h, cols_h = jax.device_get((rows_g, cols_g))
        _save_npz(
            self.path,
            stage=self.STAGE_B,
            thr=self.thr,
            rows_cnt=np.asarray(rows_h.cnt),
            rows_mn=np.asarray(rows_h.mn),
            rows_mx=np.asarray(rows_h.mx),
            cols_cnt=np.asarray(cols_h.cnt),
            cols_mn=np.asarray(cols_h.mn),
            cols_mx=np.asarray(cols_h.mx),
            done=self.done,
            fingerprint=self.fp,
            precision=HYBRID_PRECISION,
        )

    def pending_jobs(self, grid):
        todo = ~self.done
        r0 = np.asarray(grid.r0)[: self.njobs][todo]
        k0 = np.asarray(grid.k0)[: self.njobs][todo]
        return r0.astype(np.int32), k0.astype(np.int32)

    def finalize(self):
        if os.path.exists(self.path):
            os.remove(self.path)


def _save_npz(path: str, **arrays):
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(os.path.abspath(path)) or "."
    )
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp + ".npz", path)
    finally:
        for stray in (tmp, tmp + ".npz"):
            if os.path.exists(stray):
                os.remove(stray)


def _load_raw(path: str, fp: str):
    if not os.path.exists(path):
        return None
    try:
        data = np.load(path, allow_pickle=False)
    except Exception as e:  # corrupt checkpoint -> start fresh
        Logger.warning(f"ignoring unreadable checkpoint {path}: {e}")
        return None
    # Partial maxima / suspect sets swept at another precision were
    # bounded by another margin; merging them would void the exactness
    # argument.  Checkpoints that predate the field were written at
    # HIGH (TF32 on the GPU).
    prec = str(data["precision"]) if "precision" in data else "HIGH"
    if prec != HYBRID_PRECISION:
        raise ValueError(
            f"checkpoint {path} was written by sweeps at precision "
            f"{prec}, but this version sweeps at {HYBRID_PRECISION}; "
            f"its partial results are not sound here — delete the file "
            f"and rerun"
        )
    if str(data["fingerprint"]) != fp:
        Logger.warning(
            f"checkpoint {path} does not match input/config; ignoring"
        )
        return None
    return dict(data)


def _hybrid_fingerprint(T: np.ndarray, cfg: MatrixProfileConfig, w: int,
                        margin: float, group_jobs: int) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(np.asarray(T, np.float64)).tobytes())
    meta = json.dumps(
        {
            "m": cfg.m,
            "band": cfg.band,
            "chunk": cfg.chunk,
            "w": w,
            "kernel": "hybrid",
            "margin": margin,
            # stage-A next_group indexes these groups
            "group_jobs": group_jobs,
        },
        sort_keys=True,
    )
    h.update(meta.encode())
    return h.hexdigest()


def _apply_input_quant(T: np.ndarray, cfg: MatrixProfileConfig) -> np.ndarray:
    """ap_fixed input tier: apply the FileIO double->ap cast exactly as
    the non-checkpointed driver does (mpx/driver.py), BEFORE the input
    fingerprint — so resumable runs compute on (and fingerprint) the
    same quantized series as `mpx compute` without --checkpoint.
    Idempotent: already-on-grid values cast to themselves."""
    if cfg.input_quant is not None:
        from mpx.io.apfixed import quantize

        T = quantize(T, cfg.input_quant)
    return T


def compute_hybrid_with_checkpoint(
    T,
    cfg: MatrixProfileConfig,
    checkpoint_path: str,
    *,
    profile=None,
    keep_checkpoint: bool = False,
    _ckpt_cls=None,
):
    """Resumable hybrid exact-f64 computation (single device).

    The flagship double-precision path with pass-level checkpointing:
    kill it mid-pass-A or mid-pass-B and a rerun with the same input
    and config resumes instead of restarting (see HybridCheckpoint).
    Returns (MP float64, MPI int32).
    """
    from mpx.hybrid import compute_matrix_profile_f64_hybrid, default_margin

    T = _apply_input_quant(np.asarray(T, np.float64), cfg)
    n = T.shape[0]
    cfg.validate_series(n, T)
    w = n - cfg.m + 1
    cfg = cfg.shrink_to(w)
    if cfg.num_shards and cfg.num_shards > 1:
        raise ValueError("checkpointed hybrid runs execute single-device")
    margin = default_margin(cfg.m)
    cls = HybridCheckpoint if _ckpt_cls is None else _ckpt_cls
    fp = _hybrid_fingerprint(T, cfg, w, margin, cls.group_jobs)
    grid = make_job_grid(w, cfg.band, cfg.chunk)
    ckpt = cls(checkpoint_path, fp, grid)
    MP, MPI = compute_matrix_profile_f64_hybrid(
        T, cfg, margin=margin, profile=profile, ckpt=ckpt
    )
    if canonical_dtype(cfg.dtype) == np.dtype(np.float32):
        MP = MP.astype(np.float32)  # exact f64-true values, f32 storage
    if not keep_checkpoint:
        ckpt.finalize()
    return MP, MPI


def compute_with_checkpoint(
    T,
    cfg: MatrixProfileConfig,
    checkpoint_path: str,
    *,
    group_jobs: int = 64,
    profile=None,
    keep_checkpoint: bool = False,
):
    """Resumable matrix-profile computation (single device).

    Processes the job grid in groups of ``group_jobs`` jobs, persisting
    aggregates after each group.  Returns (MP, MPI) and removes the
    checkpoint on success unless ``keep_checkpoint``.
    """
    T = _apply_input_quant(np.asarray(T), cfg)
    n = T.shape[0]
    cfg.validate_series(n, T)
    m = cfg.m
    w = n - m + 1
    cfg = cfg.shrink_to(w)
    S, W = cfg.band, cfg.chunk
    dt = canonical_dtype(cfg.dtype)
    kernel = resolve_kernel(cfg.kernel, dt, m, allow_hybrid=True, w=w)
    if kernel == "hybrid":
        # the flagship path: pass-level hybrid checkpointing
        return compute_hybrid_with_checkpoint(
            T, cfg, checkpoint_path, profile=profile,
            keep_checkpoint=keep_checkpoint,
        )
    fp = _fingerprint(T, cfg, w, group_jobs, kernel)

    with _phase(profile, "1. Pre-Computation [device]"):
        stats = precompute_statistics(T, m, band=S, chunk=W, dtype=dt)

    grid = make_job_grid(w, S, W)
    grid = pad_job_grid(grid, group_jobs, dummy_r0=w)
    num_groups = grid.r0.shape[0] // group_jobs

    from mpx.dtypes import needs_x64, x64_scope

    x64 = needs_x64(dt)
    L = _agg_length(w, S, W)
    with x64_scope(x64):
        # Load inside the scope: jnp.asarray would silently canonicalize
        # float64 checkpoint arrays to float32 with x64 off.
        state = _load(checkpoint_path, fp)
        if state is None:
            rows = init_aggregates(L, dt, AGGREGATE_INIT)
            cols = init_aggregates(L, dt, AGGREGATE_INIT)
            start = 0
        else:
            rows, cols, start = state
            Logger.info(f"resuming from checkpoint: group {start}/{num_groups}")

        for g in range(start, num_groups):
            sl = slice(g * group_jobs, (g + 1) * group_jobs)
            with _phase(profile, f"2. Compute [{kernel}]", f"group_{g}"):
                g_rows, g_cols = run_jobs(
                    stats,
                    jnp.asarray(grid.r0[sl]),
                    jnp.asarray(grid.k0[sl]),
                    S=S, W=W, m=m, w=w, kernel=kernel, dtype=str(dt),
                    tr=cfg.tile_rows, tc=cfg.tile_cols,
                )
                from mpx.ops.aggregates import merge_aggregates

                rows = merge_aggregates(rows, g_rows)
                cols = merge_aggregates(cols, g_cols)
            _save(checkpoint_path, rows, cols, g + 1, fp)

        with _phase(profile, "3. Post-Computation [device]"):
            MP, MPI = postcompute(rows, cols, m, w)
            MP, MPI = np.asarray(MP), np.asarray(MPI)
    if not keep_checkpoint and os.path.exists(checkpoint_path):
        os.remove(checkpoint_path)
    return MP, MPI
