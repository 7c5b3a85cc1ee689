#!/usr/bin/env python3
"""mpx quickstart: the full API surface on the vendored datasets.

Run from the repo root: python examples/quickstart.py
(CPU works; on a GPU host the mxu kernel runs through cuBLAS.)
"""

import numpy as np

import mpx
from mpx.abjoin import compute_ab_join
from mpx.analysis import top_discords, top_motifs
from mpx.io.datasets import load_dataset
from mpx.streaming import StreamingMatrixProfile

# --- 1. basic self-join ---------------------------------------------------
T = load_dataset("motifs-discords-small.txt", "synthetic")
m = 64
MP, MPI = mpx.matrix_profile(T, m=m)
print(f"profile of {T.shape[0]} points, m={m}: min dist {MP.min():.4f}")

# --- 2. motifs and discords ------------------------------------------------
for mo in top_motifs(MP, MPI, m, k=2):
    print(f"motif: [{mo.a}, {mo.b}] d={mo.distance:.4f}")
for d in top_discords(MP, MPI, m, k=1):
    print(f"discord: {d.index} d={d.distance:.4f}")

# --- 3. explicit configuration (kernel, dtype, job geometry, sharding) -----
cfg = mpx.MatrixProfileConfig(
    m=m,
    dtype="float64",      # reference flagship precision
    kernel="auto",        # mxu on every backend for this m
    band=2048,            # rows per job
    chunk=2048,           # columns per job
    # num_shards=8,       # shard the job list over a device mesh
)
MP64, MPI64 = mpx.compute_matrix_profile(T, config=cfg)
print(f"f64 profile matches f32 to {np.max(np.abs(np.asarray(MP64) - MP)):.2e}")

# --- 4. left / right profiles ----------------------------------------------
mpl, mpli, mpr, mpri = mpx.compute_matrix_profile(T, config=cfg, left_right=True)
print(f"left/right profiles: {np.isfinite(np.asarray(mpl)).sum()} left matches")

# --- 5. AB-join --------------------------------------------------------------
ecg = load_dataset("ecg-heartbeat-av.txt", "real")
res = compute_ab_join(T, ecg[: T.shape[0]], m=m)
print(f"ab-join: best cross-series match d={np.asarray(res.mp_a).min():.4f}")

# --- 6. k nearest neighbors per subsequence ---------------------------------
D, I = mpx.compute_topk_profile(T, m=m, k=3)
print(f"top-3 neighbors of window 0: {np.asarray(I)[0]} d={np.asarray(D)[0].round(3)}")

# --- 7. streaming appends ----------------------------------------------------
smp = StreamingMatrixProfile(T[:-200], m=m)
smp.append(T[-200:])
MP_s, MPI_s = smp.profile()
print(f"streaming == batch: {np.allclose(MP_s, MP, atol=1e-3)}")

# --- 8. query similarity search (MASS) ---------------------------------------
Q = T[100 : 100 + m]
hits = mpx.match(Q, T, max_matches=3)
print(f"query occurrences: {[(r.index, round(r.distance, 3)) for r in hits]}")

# --- 9. multi-dimensional profiles (mSTAMP) ----------------------------------
rng = np.random.default_rng(0)
T2 = np.stack([T, np.roll(T, 3) + rng.standard_normal(T.size) * 0.1])
mprof = mpx.compute_multidim_profile(T2, m=m)
i, j, dist = mpx.multidim_motif(mprof, k=2)
print(f"best 2-dimensional motif: ({i}, {j}) d={dist:.3f}")

# --- 9b. anytime tier: monotone upper-bound profiles -------------------------
cfg_small = mpx.MatrixProfileConfig(m=m, band=64, chunk=64)
for MPa, _, frac in mpx.anytime_matrix_profile(T, config=cfg_small,
                                               batches=3):
    print(f"anytime @ {frac:.0%}: mean dist bound {MPa.mean():.4f}")

# --- 9c. raw (non-normalized) Euclidean profile — AAMP -----------------------
Draw, _ = mpx.compute_aamp_profile(T, m=m)
print(f"raw-Euclidean profile: min d={Draw.min():.4f} (amplitude-sensitive)")

# --- 9d. consensus motif across several series (ostinato) --------------------
cons = mpx.ostinato([T[:400], T[300:700], T[450:]], m=m)
print(f"consensus motif: series {cons.series} @ {cons.index} "
      f"radius {cons.radius:.3f}")

# --- 9e. online segmentation (FLOSS): stream against a sliding window --------
fl = mpx.Floss(T[:300], m=m, window=len(T))
for start in range(300, len(T), 128):
    fl.append(T[start : start + 128])
print(f"floss: min CAC {fl.score:.3f}, boundary candidates {fl.regimes(k=1)}")

# --- 9f. cluster whole series by MPdist ---------------------------------------
rng = np.random.default_rng(0)
walk = np.cumsum(rng.standard_normal(500)) * 0.2
res = mpx.cluster_series([T[:500], T[200:700], walk], m=48, n_clusters=2)
print(f"mpdist clusters: labels {res.labels.tolist()}, "
      f"medoids {[c.medoid for c in res.clusters]}")

# --- 9g. fleet of small series: all profiles in one vmapped dispatch ---------
fleet = np.cumsum(rng.standard_normal((8, 400)), axis=1)
MPb, MPIb = mpx.compute_batch_profiles(fleet, m=32)
print(f"batch tier: {MPb.shape[0]} profiles, per-series min "
      f"{MPb.min(axis=1).round(3).tolist()}")

# --- 9h. contrast profile: what does T+ have that T- doesn't? ----------------
Tminus = np.cumsum(rng.standard_normal(len(T))) * 0.2
cres = mpx.contrast_profile(T, Tminus, m=m)
cmot = mpx.top_contrast_motifs(cres, m, k=1)
print(f"contrast: peak @ {cmot[0].index} score {cmot[0].score:.3f}"
      if cmot else "contrast: no distinguishing pattern")

# --- 9i. time-series chains: patterns that DRIFT over time -------------------
chain = mpx.compute_chains(T, m=m)
print(f"chains: longest drifts through {chain.length} windows "
      f"{chain.chain[:6].tolist()}{'...' if chain.length > 6 else ''}")

# --- 9j. pattern density: how often does each shape recur? -------------------
sums, counts = mpx.compute_sum_thresh(T, m=m, threshold=0.6)
print(f"density: busiest window {int(counts.argmax())} has "
      f"{int(counts.max())} neighbors above 0.6 correlation")

# --- 9k. k-motiflets: the k most similar occurrences of a motif --------------
mf = mpx.k_motiflets(T, k=3, m=m)
print(f"3-motiflet: extent {mf.extent:.3f} at {mf.indices.tolist()}")

# --- 9l. online anomaly detection (DAMP): causal left-discord scores ---------
det = mpx.OnlineAnomalyDetector(T[:400], m=m)
det.append(T[400:])
d = det.discord
print(f"damp: strongest anomaly @ {d.index} distance {d.distance:.3f}"
      if d else "damp: nothing scorable")

# --- 10. fixed-point input tier (the reference's ap_fixed dtypes) ------------
cfg16 = mpx.MatrixProfileConfig(m=m, dtype="ap16")   # quantize to 2^-11 grid
MPq, _ = mpx.compute_matrix_profile(T / np.abs(T).max() * 8, config=cfg16)
print(f"ap16 tier: profile on the quantized input, min d={np.asarray(MPq).min():.4f}")

# --- 11. whole-join heatmap: pooled distance-matrix summary ------------------
Mx = mpx.pooled_matrix(T, m, mwidth=16, mheight=16, pearson=True)
r_, c_ = divmod(int(Mx.argmax()), 16)
print(f"matrix: 16x16 summary, hottest cell ({r_}, {c_}) "
      f"corr {Mx[r_, c_]:.3f}")

# --- 12. exact discords at EVERY length (the MERLIN question) ----------------
mres = mpx.multi_length_discords(T, lo=16, hi=48, k=1)
top = mres.top[0]
print(f"merlin: strongest discord is m={top.m} @ {top.index} "
      f"(score {top.score:.3f}) across {len(mres.per_length)} lengths")

# --- 13. drop-in ecosystem APIs ----------------------------------------------
import mpx.compat.pyscamp as pyscamp     # the reference's own golden tool
mp_ps, mpi_ps = pyscamp.selfjoin(T, m)   # util/matrix_profile.py:17, verbatim
import mpx.compat.stumpy as stumpy
mp_st = stumpy.stump(T, m)               # (w, 4): [P, I, left, right]
print(f"compat: pyscamp min {mp_ps.min():.3f} == "
      f"stumpy min {float(mp_st[:, 0].min()):.3f} == mpx min {MP.min():.3f}")
