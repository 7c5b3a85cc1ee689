"""Multi-device self-join with SHARDED inputs (ring schedule).

``mpx.parallel.sharding`` replicates the statistics to every device —
fine to n ~ 16M f32, but pod-scale series must be sharded.  This module
implements the ring design (the matrix-profile cousin of ring
attention; SURVEY §5 "long-context / sequence parallelism"):

* each device owns one contiguous shard of the subsequence axis: its
  slice of the series (with an m-1 halo), rolling stats, and the
  row-side state for its shard;
* a (column block, column state) bundle rotates around the ring via
  ``ppermute`` for ⌊D/2⌋ steps; each step, a device sweeps the full
  (shard_w x shard_w) rectangle of one unordered shard pair {d, b},
  emitting BOTH row- and column-side results, so every pair of shards
  is processed exactly once and the ring only travels half-way (the
  final column states are sent home with one extra ppermute);
* the diagonal shard pair (a self-join of the shard) runs before the
  rotation with the standard upper-triangle job grid;
* per-device operand panels (the unit-normalized windows of the local
  shard, and of the visiting column block) are built ONCE per shard /
  per rotation step with the blockwise builder — never inside the job
  scan (per-job panel construction once dominated the runtime); with
  prebuilt panels the inner jobs are the same panel-slice + matmul as
  the single-device kernel (mpx.kernels.mxu._panel).

Two tiers share this machinery (one ring pass, three sweep modes):

* ``run_ring_sharded``     — one-pass float32 max/argmax profile
  (mode "maxarg");
* ``run_ring_hybrid_f64``  — the exact double tier over sharded
  inputs: ring pass A (mode "max": value-only f32 maxima at the hybrid
  precision) -> host suspect thresholds -> ring pass B (mode
  "suspects": dense threshold sweep with index capture) -> exact
  host-f64 rescoring via mpx.hybrid._resolve_side.  Same evidence
  structure and margin soundness argument as mpx.hybrid; reference
  flagship analog: /root/reference/README.md:35 (double 1M showcase)
  generalized to sharded inputs.

Per-device memory is O(n/D * m / itemsize) for the two panels — the
price of never rebuilding operands per job.  The O(n^2) sweep dwarfs
the O(n m / D) panel builds for every practical geometry.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from mpx.dtypes import AGGREGATE_INIT, INDEX_INIT, canonical_dtype
from mpx.kernels import band_geometry
from mpx.parallel.mesh import default_mesh
from mpx.types import Stats

_BIG = np.int32(2**30)

# Per-device panel budget (bytes) for the two (shard_w, m) operand
# panels; exceeding it means the shard is too wide for this device
# count (use more shards — that is what sharded inputs are for).
RING_PANEL_BUDGET = int(os.environ.get("MPX_RING_PANEL_BUDGET", 10 << 30))

# Flagged-slot budget per job for the hybrid ring's fused pass B
# (suspect flags per job are tens at the 1M showcase; overflowing jobs
# fall back to a dense capture sweep inside the same dispatch).
RING_SUSPECT_F = int(os.environ.get("MPX_RING_SUSPECT_F", 256))

# Small-panel width for the sparse pass B's per-job two-tier lax.cond:
# a job whose exact flag count fits runs the F-shaped work (panel
# compaction, the (F, W)/(F, S) products and suspect reduces) at this
# width instead of RING_SUSPECT_F — the shard_map-compatible analog of
# the jobs-mode adaptive tier routing (mpx.hybrid._choose_tiers), which
# needs a host round trip the ring schedule cannot afford per rotation
# step.  0 disables the small branch.
RING_SUSPECT_F_SMALL = int(os.environ.get("MPX_RING_SUSPECT_F_SMALL", 64))

# Per-device memory budget (bytes) for pass A's u16 per-job maxima
# capture.  Within budget the hybrid ring runs the SPARSE pass B (skinny
# gathered matmuls over flagged rows/columns only — the fused pass B's
# dense re-sweep can cost more than a whole non-ring run); beyond it
# (very long series) pass B falls back to the capture-free fused dense
# re-sweep.  2 GiB is the value the tier was introduced with; sizing it
# for an 80 GB card is open (ROADMAP).
RING_CAPTURE_BUDGET = int(os.environ.get("MPX_RING_CAPTURE_BUDGET", 2 << 30))


def _ring_capture_bytes(D: int, shard_w: int, S: int, W: int) -> int:
    """Per-device bytes of pass-A capture state for the sparse pass B:
    one (S,) + one (W,) u16 vector per diagonal job plus per rect job
    per rotation step."""
    nr, nc = shard_w // S, shard_w // W
    rr, cc = np.meshgrid(np.arange(nr) * S, np.arange(nc) * W, indexing="ij")
    gd = int((cc.ravel() + W > rr.ravel()).sum())
    gr = nr * nc
    return (gd + (D // 2) * gr) * (S + W) * 2


def _panel_block(shard_w: int) -> int:
    blk = 8192
    while shard_w % blk:
        blk //= 2
    return max(blk, 1)


def _build_panel(Tseg, mu, inv, L: int, m: int):
    """Unit-normalized window panel (L, m) from a series segment of
    length L + m - 1, built blockwise (one big stack blows the compile;
    same construction as mpx.ops.precompute.build_windows)."""
    invc = jnp.where(jnp.isfinite(inv), inv, 0)
    blk = _panel_block(L)

    def build(seg, mu_b, iv_b, count):
        Wm = jnp.stack([seg[j : j + count] for j in range(m)], axis=1)
        return (Wm - mu_b[:, None]) * iv_b[:, None]

    if L <= 2 * blk or blk < 512:
        return build(Tseg, mu, invc, L)

    def blk_fn(i):
        o = i * blk
        seg = jax.lax.dynamic_slice(Tseg, (o,), (blk + m - 1,))
        mu_b = jax.lax.dynamic_slice(mu, (o,), (blk,))
        iv_b = jax.lax.dynamic_slice(invc, (o,), (blk,))
        return build(seg, mu_b, iv_b, blk)

    out = jax.lax.map(blk_fn, jnp.arange(L // blk, dtype=jnp.int32))
    return out.reshape(L, m)


def _local_stats(panel, inv, T, mu) -> Stats:
    """A device-local Stats view over a prebuilt panel: the mxu sweeps
    slice ``windows`` and mask by ``inv`` finiteness; the remaining
    fields are unused by the matmul kernels."""
    dummy = jnp.zeros((1,), panel.dtype)
    return Stats(T=T, mu=mu, df=dummy, dg=dummy, inv=inv, qt0=dummy,
                 windows=panel)


def _shard_layout(w: int, D: int, band: int, chunk: int):
    """Per-device shard width: a multiple of both job tile sizes."""
    shard_w = int(np.ceil(w / (D * band)) * band)
    shard_w = max(shard_w, chunk)
    if shard_w % chunk:
        shard_w = int(np.ceil(shard_w / chunk) * chunk)
    if shard_w % band:
        shard_w = int(np.ceil(shard_w / band) * band)
    return shard_w


def _stage_shards(T64, host_stats, w: int, m: int, D: int, shard_w: int, dt):
    """Explicit (D, shard) input layouts with the m-1 series halo
    duplicated; pads beyond w are masked by the global bounds checks."""
    Tb = np.zeros((D, shard_w + m - 1), dt)
    mub = np.zeros((D, shard_w), dt)
    invb = np.zeros((D, shard_w), dt)
    Tpad = np.zeros(D * shard_w + m - 1, np.float64)
    Tpad[: T64.shape[0]] = T64
    for d in range(D):
        o = d * shard_w
        Tb[d] = Tpad[o : o + shard_w + m - 1].astype(dt)
        sl = host_stats["mu"][o : o + shard_w]
        mub[d, : sl.shape[0]] = sl.astype(dt)
        sl = host_stats["inv"][o : o + shard_w]
        invb[d, : sl.shape[0]] = sl.astype(dt)
    return Tb, mub, invb


def _ring_grids(shard_w: int, S: int, W: int):
    """(diag upper-triangle jobs, off-diagonal rectangle jobs), static.

    Both grids are RECTANGLE tilings (r0, c0 = r0 + k0 aligned to S/W):
    the diag block keeps only tiles touching the upper triangle
    (c0 + W > r0), masked one-sided inside the sweep.  A diagonal-chunk
    grid (mpx.config.make_job_grid) is NOT usable here: with W > S its
    last chunk emits jobs with c0 + W > shard_w, and dynamic_slice
    would clamp the local panel/state slices — silently merging into
    wrong offsets."""
    nr, nc = shard_w // S, shard_w // W
    rr, cc = np.meshgrid(
        np.arange(nr, dtype=np.int32) * S,
        np.arange(nc, dtype=np.int32) * W,
        indexing="ij",
    )
    rr, cc = rr.ravel(), cc.ravel()
    keep = cc + W > rr
    diag = (jnp.asarray(rr[keep]), jnp.asarray(cc[keep] - rr[keep]))
    rect = (jnp.asarray(rr), jnp.asarray(cc - rr))  # k0 = c0 - r0
    return diag, rect


def _check_budget(shard_w: int, m: int, itemsize: int = 4):
    need = 2 * shard_w * m * itemsize
    if need > RING_PANEL_BUDGET:
        raise ValueError(
            f"ring operand panels need {need / 2**30:.1f} GiB/device "
            f"(shard_w={shard_w}, m={m}); raise num_shards or "
            f"MPX_RING_PANEL_BUDGET"
        )


def _ring_pass(Tb, mub, invb, *, mode: str, mesh, D: int, shard_w: int,
               geom, diag, rect, prec, thrb=None, suspect_f=None,
               capture=False, caps=None, compile_only=False):
    """One full ring sweep in one dispatch.  ``mode``:

    * ``"maxarg"``   -> per-subsequence (value, index) best pair;
    * ``"max"``      -> per-subsequence max correlation only (hybrid
      pass A); with ``capture=True`` additionally returns the
      u16-encoded per-job row/col maxima (device-resident, sharded) —
      the sparse pass B's skip oracle;
    * ``"suspects"`` -> per-subsequence SuspectWindow capture at the
      per-row thresholds ``thrb`` (hybrid pass B), recomputing each
      job's maxima inline (dense re-sweep; no pass-A captures needed);
    * ``"suspects_sparse"`` -> same output, consuming pass A's captured
      maxima (``caps``) to skip unflagged rows/columns — the dense
      O(n^2/D) re-sweep collapses to skinny gathered matmuls, at the
      cost of O(jobs * (S + W)) u16 capture HBM per device (gate with
      _ring_capture_bytes / RING_CAPTURE_BUDGET).

    Every mode returns device-folded (D, shard_w[, ...]) outputs: the
    homed column-side state is merged into the row-side state on-device
    before the host fetch.
    """
    from mpx.hybrid import (
        _combine_suspects,
        _encode_max_u16,
        _init_suspects,
        _merge_suspects_at,
    )
    from mpx.kernels.mxu import (
        sweep_band_max,
        sweep_band_mxu,
        sweep_band_suspects,
        sweep_band_suspects_fused,
        sweep_band_suspects_sparse,
    )

    S, W, m = geom.S, geom.W, geom.m
    dt = jnp.float32
    init_v = jnp.asarray(AGGREGATE_INIT, dt)
    diag_r0, diag_k0 = diag
    rect_r0, rect_k0 = rect
    s_final = D // 2
    suspects = mode in ("suspects", "suspects_sparse")
    sparse = mode == "suspects_sparse"
    F = RING_SUSPECT_F if suspect_f is None else suspect_f

    def merge_at(arr, new, o, better):
        cur = jax.lax.dynamic_slice(arr, (o,), (new.shape[0],))
        win = better(new, cur)
        return jax.lax.dynamic_update_slice(
            arr, jnp.where(win, new, cur), (o,)
        )

    def sweep_jobs(st_r, st_c, r0s, k0s, rg, cg, two_sided,
                   row_st, col_st, thr_r=None, thr_c=None, job_caps=None):
        def body(carry, job):
            row_st, col_st = carry
            ys = None
            if sparse:
                r0, k0, jrow, jcol = job
            else:
                r0, k0 = job
            c0 = r0 + k0
            if suspects:
                if sparse:
                    def sparse_at(Fv):
                        return sweep_band_suspects_sparse(
                            st_r, r0, k0, jrow, jcol, geom, thr_r, Fv,
                            st_c, thr_c, precision=prec, rg=rg, cg=cg,
                            two_sided=two_sided,
                        )

                    F_small = min(RING_SUSPECT_F_SMALL, F)
                    if F_small and F_small < F:
                        # Two-tier cond: most jobs' flag counts are tens
                        # (mean 67 at the 1M showcase), so they run the
                        # F-shaped work at the small panel width; the
                        # count uses the SAME u16-decode comparisons as
                        # the kernel, so the small branch can never
                        # overflow when taken.
                        thr_cc = thr_r if thr_c is None else thr_c
                        dec = lambda q: (q.astype(jnp.float32)
                                         * jnp.float32(2.0 / 65535.0) - 1.0)
                        nr = jnp.sum(
                            dec(jrow) >= jax.lax.dynamic_slice(
                                thr_r, (r0,), (S,)),
                            dtype=jnp.int32,
                        )
                        nc = jnp.sum(
                            dec(jcol) >= jax.lax.dynamic_slice(
                                thr_cc, (c0,), (W,)),
                            dtype=jnp.int32,
                        )
                        win_r, win_c, over = jax.lax.cond(
                            (nr <= F_small) & (nc <= F_small),
                            lambda _: sparse_at(F_small),
                            lambda _: sparse_at(F),
                            None,
                        )
                    else:
                        win_r, win_c, over = sparse_at(F)
                else:
                    win_r, win_c, over = sweep_band_suspects_fused(
                        st_r, r0, k0, geom, thr_r, F, st_c,
                        thr_c, precision=prec, rg=rg, cg=cg,
                        two_sided=two_sided,
                    )

                def dense(_):
                    out = sweep_band_suspects(
                        st_r, r0, k0, geom, dt, thr_r, st_c, thr_c,
                        precision=prec, rg=rg, cg=cg,
                        two_sided=two_sided,
                    )
                    return out.row, out.col

                # Rare flag-budget overflows re-sweep densely (cond
                # runs one branch — the dense path costs nothing when
                # untaken).
                win_r, win_c = jax.lax.cond(
                    over, dense, lambda _: (win_r, win_c), None
                )
                row_st = _merge_suspects_at(row_st, win_r, r0)
                col_st = _merge_suspects_at(col_st, win_c, c0)
            elif mode == "max":
                rv, cv = sweep_band_max(
                    st_r, r0, k0, geom, dt, st_c,
                    precision=prec, rg=rg, cg=cg, two_sided=two_sided,
                )
                if capture:
                    ys = (_encode_max_u16(rv), _encode_max_u16(cv))
                row_st = merge_at(row_st, rv, r0, jnp.greater)
                col_st = merge_at(col_st, cv, c0, jnp.greater)
            else:
                out = sweep_band_mxu(
                    st_r, r0, k0, geom, dt, stats_c=st_c,
                    precision=prec, rg=rg, cg=cg, two_sided=two_sided,
                )
                rV, rI = row_st
                cV, cI = col_st

                def merge_vi(V, I, v, i, o):
                    curV = jax.lax.dynamic_slice(V, (o,), (v.shape[0],))
                    curI = jax.lax.dynamic_slice(I, (o,), (v.shape[0],))
                    win = v > curV
                    return (
                        jax.lax.dynamic_update_slice(
                            V, jnp.where(win, v, curV), (o,)),
                        jax.lax.dynamic_update_slice(
                            I, jnp.where(win, i, curI), (o,)),
                    )

                rV, rI = merge_vi(rV, rI, out.row.value, out.row.index, r0)
                cV, cI = merge_vi(cV, cI, out.col.value, out.col.index, c0)
                row_st, col_st = (rV, rI), (cV, cI)
            return (row_st, col_st), ys

        xs = (r0s, k0s) + (job_caps if sparse else ())
        carry, ys = jax.lax.scan(body, (row_st, col_st), xs)
        return (carry + (ys,)) if capture else carry

    def init_state():
        if suspects:
            return _init_suspects(shard_w)
        if mode == "max":
            return jnp.full((shard_w,), init_v, dt)
        return (jnp.full((shard_w,), init_v, dt),
                jnp.full((shard_w,), INDEX_INIT, jnp.int32))

    def fold(row_st, col_st):
        if suspects:
            return _combine_suspects(row_st, col_st)
        if mode == "max":
            return jnp.maximum(row_st, col_st)
        rV, rI = row_st
        cV, cI = col_st
        better = cV > rV
        return jnp.where(better, cV, rV), jnp.where(better, cI, rI)

    Gd = int(diag_r0.shape[0])
    Gr = int(rect_r0.shape[0])

    def local(*args):
        in_caps = None
        if sparse:
            (T_blk, mu_blk, inv_blk, thr_blk,
             jr_d, jc_d, jr_r, jc_r) = args
            thr_blk = thr_blk[0]
            in_caps = (jr_d[0], jc_d[0], jr_r[0], jc_r[0])
        elif suspects:
            T_blk, mu_blk, inv_blk, thr_blk = args
            thr_blk = thr_blk[0]
        else:
            T_blk, mu_blk, inv_blk = args
            thr_blk = None
        d = jax.lax.axis_index("jobs")
        T_blk, mu_blk, inv_blk = T_blk[0], mu_blk[0], inv_blk[0]
        goff = d.astype(jnp.int32) * shard_w
        Ur = _build_panel(T_blk, mu_blk, inv_blk, shard_w, m)
        st_r = _local_stats(Ur, inv_blk, T_blk, mu_blk)

        row_st = init_state()
        col_st = init_state()

        # Diagonal shard pair: a self-join of the shard (upper-triangle
        # job grid, one-sided exclusion — each unordered pair once).
        diag_out = sweep_jobs(
            st_r, None, diag_r0, diag_k0, goff, goff, False,
            row_st, col_st, thr_blk, None,
            job_caps=(in_caps[0], in_caps[1]) if sparse else None,
        )
        if capture:
            row_st, col_st, (cap_d_r, cap_d_c) = diag_out
        else:
            row_st, col_st = diag_out
        # zero-size when not capturing: the loop carry stays free
        nsteps = s_final if capture else 0
        cap_r_r = jnp.zeros((nsteps, Gr, S), jnp.uint16)
        cap_r_c = jnp.zeros((nsteps, Gr, W), jnp.uint16)

        if D > 1:
            perm = [(i, (i - 1) % D) for i in range(D)]

            def step(s, carry):
                cT, cMu, cInv, cThr, col_st, row_st, cap_r, cap_c = carry
                cT, cMu, cInv, cThr, col_st = jax.lax.ppermute(
                    (cT, cMu, cInv, cThr, col_st), "jobs", perm
                )
                b = (d + s) % D
                mine = s <= (D - 1) // 2
                if D % 2 == 0:
                    mine = mine | ((s == D // 2) & (d < D // 2))

                def do(args):
                    cT, cMu, cInv, cThr, col_st, row_st, cap_r, cap_c = args
                    Uc = _build_panel(cT, cMu, cInv, shard_w, m)
                    st_c = _local_stats(Uc, cInv, cT, cMu)
                    jc = None
                    if sparse:
                        # pass A captured this step's job maxima at the
                        # same (device, step) slot — both passes iterate
                        # the rotation identically
                        jc = (
                            jax.lax.dynamic_slice(
                                in_caps[2], (s - 1, 0, 0), (1, Gr, S))[0],
                            jax.lax.dynamic_slice(
                                in_caps[3], (s - 1, 0, 0), (1, Gr, W))[0],
                        )
                    out = sweep_jobs(
                        st_r, st_c, rect_r0, rect_k0,
                        goff, b.astype(jnp.int32) * shard_w, True,
                        row_st, col_st, thr_blk, cThr, job_caps=jc,
                    )
                    if capture:
                        row_st, col_st, (jr, jcc) = out
                        cap_r = jax.lax.dynamic_update_slice(
                            cap_r, jr[None], (s - 1, 0, 0))
                        cap_c = jax.lax.dynamic_update_slice(
                            cap_c, jcc[None], (s - 1, 0, 0))
                    else:
                        row_st, col_st = out
                    return row_st, col_st, cap_r, cap_c

                row_st, col_st, cap_r, cap_c = jax.lax.cond(
                    mine, do, lambda a: (a[5], a[4], a[6], a[7]),
                    (cT, cMu, cInv, cThr, col_st, row_st, cap_r, cap_c),
                )
                return (cT, cMu, cInv, cThr, col_st, row_st, cap_r, cap_c)

            thr0 = thr_blk if suspects else jnp.zeros((1,), dt)
            carry = (T_blk, mu_blk, inv_blk, thr0, col_st, row_st,
                     cap_r_r, cap_r_c)
            carry = jax.lax.fori_loop(1, s_final + 1, step, carry)
            col_st, row_st = carry[4], carry[5]
            cap_r_r, cap_r_c = carry[6], carry[7]
            # Send the traveled column state home (bundle j sits at
            # device j - s_final after the loop) and fold the sides.
            home = [(i, (i + s_final) % D) for i in range(D)]
            col_st = jax.lax.ppermute(col_st, "jobs", home)

        out = fold(row_st, col_st)
        if capture:
            out = (out, cap_d_r, cap_d_c, cap_r_r, cap_r_c)
        return jax.tree.map(lambda a: a[None], out)

    nin = 8 if sparse else (4 if suspects else 3)
    shard_fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P("jobs"),) * nin,
        out_specs=P("jobs"),
        check_vma=False,
    )
    args = (Tb, mub, invb) + ((thrb,) if suspects else ())
    if sparse:
        args = args + tuple(caps)
    with mesh:
        fn = jax.jit(shard_fn)
        if compile_only:
            # pod-scale configs (n=16M+) are validated for compilation
            # on virtual meshes where executing them would take hours
            fn.lower(*args).compile()
            return None
        return fn(*args)


def run_ring_sharded(
    T,
    m: int,
    *,
    num_shards: int,
    band: int = 4096,
    chunk: int = 16384,
    dtype: str = "float32",
    mesh=None,
    host_stats: dict | None = None,
    compile_only: bool = False,
):
    """One-pass float32 self-join with inputs sharded over a 1-D mesh.

    Returns (MP, MPI) numpy arrays.  Per-device memory is
    O(n/num_shards * (m + 1)); nothing is replicated.  The f32 matmuls
    run at the mxu kernel's HIGHEST (full-f32 products).  float64
    requests should use :func:`run_ring_hybrid_f64` (the driver routes
    there)."""
    from mpx.kernels.mxu import _PRECISION

    dt = canonical_dtype(dtype)
    if dt == np.dtype(np.float64):
        raise NotImplementedError(
            "one-pass ring sharding is float32; float64 rings run the "
            "exact hybrid tier (run_ring_hybrid_f64)"
        )
    prec = _PRECISION
    env = _ring_setup(T, m, num_shards, band, chunk, mesh, host_stats,
                      np.dtype(np.float32))
    out = _ring_pass(
        env["Tb"], env["mub"], env["invb"], mode="maxarg",
        mesh=env["mesh"], D=num_shards, shard_w=env["shard_w"],
        geom=env["geom"], diag=env["diag"], rect=env["rect"], prec=prec,
        compile_only=compile_only,
    )
    if compile_only:
        return None, None
    V, I = out
    w = env["w"]
    V = np.asarray(V).reshape(-1)[:w]
    I = np.asarray(I).reshape(-1)[:w]
    MP = np.sqrt(np.maximum(2.0 * m * (1.0 - V.astype(np.float64)), 0.0))
    return MP, I


def _ring_setup(T, m, D, band, chunk, mesh, host_stats, dt):
    """Shared staging for the ring tiers: host stats, shard layout,
    explicit (D, shard) input blocks, job grids, geometry."""
    from mpx.ops.precompute import precompute_statistics_numpy

    T64 = np.asarray(T, np.float64)
    n = T64.shape[0]
    w = n - m + 1

    if host_stats is None:
        from mpx import native

        host_stats = (
            native.precompute(T64, m) if native.is_available()
            else precompute_statistics_numpy(T64, m)
        )

    shard_w = _shard_layout(w, D, band, chunk)
    _check_budget(shard_w, m)
    Tb, mub, invb = _stage_shards(T64, host_stats, w, m, D, shard_w, dt)
    if mesh is None:
        mesh = default_mesh(D)
    # Device-put the shard blocks ONCE with their ring sharding: every
    # pass (A, B, C) reuses the resident buffers instead of paying a
    # host transfer per dispatch.
    sharding = jax.sharding.NamedSharding(mesh, P("jobs"))
    Tb = jax.device_put(Tb, sharding)
    mub = jax.device_put(mub, sharding)
    invb = jax.device_put(invb, sharding)
    S = min(band, shard_w)
    W = min(chunk, shard_w)
    geom = band_geometry(S, W, m, w, 8, min(2048, W))
    diag, rect = _ring_grids(shard_w, S, W)
    return dict(
        T64=T64, host_stats=host_stats, w=w, shard_w=shard_w,
        Tb=Tb, mub=mub, invb=invb, mesh=mesh, geom=geom,
        diag=diag, rect=rect,
    )


@jax.jit
def _thr_from_gmax(gmax, margin2):
    """Per-row pass-B thresholds computed WHERE gmax lives (on device,
    sharded): thr = gmax - 2*margin, +inf for rows with no valid pair
    (gmax still at AGGREGATE_INIT — includes the padded shard tail).
    Same f32 arithmetic as the host formula in run_ring_hybrid_f64, so
    the host copy fetched later for pass C is bit-identical."""
    return jnp.where(
        gmax > jnp.float32(AGGREGATE_INIT),
        gmax - margin2,
        jnp.full_like(gmax, jnp.inf),
    )


def _ring_pass_c(env, *, D: int, shard_w: int, m: int, w: int, excl: int,
                 mu64, inv64, thr_host, T64):
    """Sharded pass C factory: exact suspect extraction for
    capture-overflow rows over the ring's column shards.

    Returns ``passc_fn(flagged, K) -> (bv, bi, cnt)`` for
    mpx.hybrid._resolve_side: the flagged rows' unit windows are built
    on the host (F is tiny; no device holds the full query axis) and
    replicated; each device scans ITS shard of the column axis with
    scan_flagged_rows (global coordinates via col_offset); the
    per-device top-K merge to the global top-K on the host.  count <= K
    proves completeness exactly as in the single-chip tier — per-shard
    counts partition the global count."""
    from mpx.hybrid import scan_flagged_rows

    mesh = env["mesh"]

    def passc_fn(flagged: np.ndarray, K: int):
        F = max(256, ((flagged.size + 511) // 512) * 512)
        fidx = np.concatenate(
            [flagged, np.zeros(F - flagged.size, np.int32)]
        ).astype(np.int32)
        j = np.arange(m)
        Wf = T64[fidx[:, None] + j[None, :]]
        invf = inv64[fidx]
        finf = np.isfinite(invf)
        finf[flagged.size:] = False  # padded rows never match
        Uf = (
            (Wf - mu64[fidx][:, None]) * np.where(finf, invf, 0.0)[:, None]
        ).astype(np.float32)
        thr_f = thr_host[fidx].astype(np.float32)
        thr_f[flagged.size:] = np.inf

        CW = 16384
        while shard_w % CW:
            CW //= 2
        fidx_j = jnp.asarray(fidx)
        Uf_j = jnp.asarray(Uf)
        fin_j = jnp.asarray(finf)
        thr_j = jnp.asarray(thr_f)
        dummy = jnp.zeros((1,), jnp.float32)

        def local(T_blk, mu_blk, inv_blk):
            d = jax.lax.axis_index("jobs")
            goff = d.astype(jnp.int32) * shard_w
            st = Stats(T=T_blk[0], mu=mu_blk[0], df=dummy, dg=dummy,
                       inv=inv_blk[0], qt0=dummy, windows=None)
            bv, bi, cnt = scan_flagged_rows(
                st, None, fidx_j, m=m, w=w, excl=excl, K=K, CW=CW,
                Uf=Uf_j, fin_f=fin_j, thr_f=thr_j, col_offset=goff,
            )
            return bv[None], bi[None], cnt[None]

        shard_fn = jax.shard_map(
            local, mesh=mesh,
            in_specs=(P("jobs"),) * 3, out_specs=P("jobs"),
            check_vma=False,
        )
        with mesh:
            out = jax.jit(shard_fn)(env["Tb"], env["mub"], env["invb"])
        bv, bi, cnt = (np.asarray(a) for a in jax.device_get(out))
        cntm = cnt.sum(axis=0, dtype=np.int64).astype(np.int32)
        bvc = np.swapaxes(bv, 0, 1).reshape(F, D * K)
        bic = np.swapaxes(bi, 0, 1).reshape(F, D * K)
        sel = np.argsort(-bvc, axis=1)[:, :K]
        return (
            np.take_along_axis(bvc, sel, 1),
            np.take_along_axis(bic, sel, 1),
            cntm,
        )

    return passc_fn


def run_ring_hybrid_f64(
    T,
    m: int,
    *,
    num_shards: int,
    band: int = 4096,
    chunk: int = 16384,
    margin: float | None = None,
    mesh=None,
    host_stats: dict | None = None,
    suspect_f: int | None = None,
    compile_only: bool = False,
    profile=None,
):
    """Exact double-precision self-join with SHARDED inputs.

    The hybrid evidence chain (mpx.hybrid: f32 sweeps bound the f64
    optimum, exact host rescoring decides) over the ring schedule:

    1. ring pass A (mode "max")     -> per-subsequence f32 max,
    2. host thresholds              -> thr = gmax32 - 2*margin,
    3. ring pass B (mode "suspects")-> per-subsequence capture windows,
    4. mpx.hybrid._resolve_side     -> exact f64 best pair (capture
       overflow escalates to plateau-interval rescoring or the exact
       host row scan; no replicated device stats exist in this tier,
       so the device pass C is skipped).

    Both ring passes run at HYBRID_PRECISION with the same margin
    soundness argument as the single-chip tier.  Returns (MP float64,
    MPI int32) numpy arrays at the reference's 1e-8 tolerance.
    """
    from mpx.hybrid import (
        HYBRID_PRECISION,
        _prec,
        _rescore_pairs,
        _resolve_side,
        _row_scan,
        default_margin,
    )
    from mpx.utils.profile import phase as _phase

    D = num_shards
    if margin is None:
        margin = default_margin(m)
    prec = _prec(HYBRID_PRECISION)

    with _phase(profile, "1. Pre-Computation [host f64]"):
        env = _ring_setup(T, m, D, band, chunk, mesh, host_stats,
                          np.dtype(np.float32))
    T64, w, shard_w = env["T64"], env["w"], env["shard_w"]
    mu64 = np.asarray(env["host_stats"]["mu"], np.float64)
    inv64 = np.asarray(env["host_stats"]["inv"], np.float64)
    excl = m // 4

    common = dict(mesh=env["mesh"], D=D, shard_w=shard_w,
                  geom=env["geom"], diag=env["diag"], rect=env["rect"],
                  prec=prec)

    # Sparse pass B (pass-A captured maxima as the skip oracle) whenever
    # the per-device capture state fits the memory budget; very long
    # series fall back to the capture-free fused dense re-sweep.
    S_, W_ = env["geom"].S, env["geom"].W
    sparse_b = (
        _ring_capture_bytes(D, shard_w, S_, W_) <= RING_CAPTURE_BUDGET
        and os.environ.get("MPX_RING_SPARSE", "1") != "0"
    )

    with _phase(profile, f"2. Compute [ring f32 pass A x{D}]"):
        out = _ring_pass(env["Tb"], env["mub"], env["invb"],
                         mode="max", capture=sparse_b,
                         compile_only=compile_only, **common)
        caps = None
        if sparse_b and out is not None:
            gmax, caps = out[0], out[1:]
        else:
            gmax = out

    if compile_only:
        thrb = jnp.full((D, shard_w), jnp.inf, jnp.float32)
        if sparse_b:
            # compile the sparse pass B against dummy capture buffers
            gd = int(np.asarray(env["diag"][0]).shape[0])
            gr = int(np.asarray(env["rect"][0]).shape[0])
            caps = (
                jnp.zeros((D, gd, S_), jnp.uint16),
                jnp.zeros((D, gd, W_), jnp.uint16),
                jnp.zeros((D, D // 2, gr, S_), jnp.uint16),
                jnp.zeros((D, D // 2, gr, W_), jnp.uint16),
            )
    else:
        # thr = gmax - 2*margin computed ON DEVICE where gmax already
        # lives (rows with no valid pair — and padded shard tails —
        # stay +inf so they never flag, same rule as
        # mpx.hybrid._build_thr).  This removes the host round-trip
        # between the two dependent passes (fetching gmax + restaging
        # thr would cost two w-sized transfers).
        thrb = _thr_from_gmax(gmax, np.float32(2.0 * margin))

    with _phase(profile, f"2. Compute [ring f32 pass B x{D}]"):
        sus = _ring_pass(env["Tb"], env["mub"], env["invb"],
                         mode="suspects_sparse" if sparse_b else "suspects",
                         thrb=thrb, caps=caps,
                         suspect_f=suspect_f,
                         compile_only=compile_only, **common)
        if compile_only:
            return None, None
        # Overlapped with pass B's device time: the HOST thr copy that
        # the pass-C escalation closure needs (pass B has dispatched;
        # this fetch only waits on pass A).
        gmax = np.asarray(gmax).reshape(-1)[:w]
        thr = np.where(
            gmax > np.float32(AGGREGATE_INIT),
            gmax - np.float32(2.0 * margin), np.float32(np.inf),
        ).astype(np.float32)
        # one bulk transfer instead of per-array slicing executables
        sus = jax.device_get(sus)
        sus = jax.tree.map(
            lambda a: np.asarray(a).reshape((D * shard_w,) + a.shape[2:]),
            sus,
        )

    from mpx import native as _native

    sym = None
    if _native.is_available():
        sym = lambda cand: _native.resolve_slots(T64, mu64, inv64, m, cand, w)
    passc_fn = _ring_pass_c(
        env, D=D, shard_w=shard_w, m=m, w=w, excl=excl,
        mu64=mu64, inv64=inv64, thr_host=thr, T64=T64,
    )
    bestP, bestI = _resolve_side(
        sus, w, m,
        rescore=lambda r, c: _rescore_pairs(T64, mu64, inv64, m, r, c),
        stats_q=None, stats_t=None, thr_q=None, excl=excl, wt=w,
        escalate=lambda rows: _row_scan(T64, mu64, inv64, m, w, excl, rows),
        profile=profile, sym_resolve=sym, passc_fn=passc_fn,
    )

    with _phase(profile, "4. Post-Computation [host]"):
        MP = np.sqrt(np.maximum(2.0 * m * (1.0 - bestP), 0.0))
        return MP, bestI
