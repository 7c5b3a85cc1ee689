"""mpx — an exact matrix-profile (SCAMP) framework in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of the
``matrix-profile-hls`` FPGA reference (Vitis HLS SCAMP self-join engine):
given a time series ``T`` of length ``n`` and a subsequence length ``m``,
compute the self-join matrix profile ``MP`` (z-normalized Euclidean distance
of each length-``m`` subsequence to its nearest non-trivial neighbor) and the
matrix profile index ``MPI``.

Architecture (accelerator-first, not a translation of the HLS dataflow
design):

* the upper-triangular (n-m+1)^2 join is decomposed into independent
  (row-band x diagonal-chunk) *jobs*;
* each job seeds its QT row exactly with the closed form
  ``QT(r, c) = SDP(r, c) - m * mu[r] * mu[c]`` (a sliding-dot-product),
  then runs the SCAMP O(1) diagonal-update recurrence over the band's
  rows — or, in the default ``mxu`` kernel, computes the whole job tile
  as one matmul of unit-normalized windows;
* row/column argmax aggregates are merged on-device with max-merges
  (the analog of the reference host driver's ``UpdateAggregates``,
  include/host/HostSideComputation.hpp:72-90);
* multi-device scaling shards the job list over a ``jax.sharding.Mesh``
  and merges partial profiles with a max/argmax allreduce (the analog of
  the reference's MP_KERNEL_REPL compute-unit replication).

Double precision (the reference's flagship dtype) is supported through
scoped JAX x64 tracing (:func:`mpx.dtypes.x64_scope`); the global x64 flag
is never touched, so float32 paths stay free of i64 index arithmetic.
"""

from __future__ import annotations

from mpx.aamp import compute_aamp_profile
from mpx.abjoin import compute_ab_join
from mpx.anytime import anytime_matrix_profile, approx_matrix_profile
from mpx.analysis import (
    all_chains,
    apply_annotation_vector,
    complexity_annotation,
    corrected_arc_curve,
    extract_regimes,
    mass,
    match,
    mpdist,
    one_directional_cac,
    regimes,
    top_discords,
    top_motifs,
    unanchored_chain,
)
from mpx.chains import ChainsResult, anchored_chain, chain_lengths, compute_chains
from mpx.damp import Anomaly, OnlineAnomalyDetector, compute_damp
from mpx.motiflets import Motiflet, k_motiflets, motiflet_elbows
from mpx.distmatrix import pooled_matrix
from mpx.merlin import (
    LengthDiscord,
    MerlinResult,
    multi_length_discords,
    multi_length_motifs,
)
from mpx.thresh import compute_sum_thresh, compute_sum_thresh_ab
from mpx.floss import Floss
from mpx.batch import compute_batch_profiles
from mpx.cluster import cluster_series, hierarchical_cluster, mpdist_matrix
from mpx.contrast import (
    best_contrast,
    contrast_profile,
    pan_contrast_profile,
    top_contrast_motifs,
)
from mpx.missing import compute_matrix_profile_masked, missing_window_mask
from mpx.mstamp import (
    MdlResult,
    multidim_mdl,
    compute_multidim_profile,
    multidim_discord,
    multidim_motif,
    multidim_subspace,
)
from mpx.ostinato import ostinato
from mpx.pan import compute_pan_profile, pan_discords, pan_m_range, pan_motifs
from mpx.snippets import snippets
from mpx.topk import compute_topk_profile
from mpx.config import MatrixProfileConfig
from mpx.driver import compute_matrix_profile, matrix_profile
from mpx.dtypes import AGGREGATE_INIT, INDEX_INIT

__version__ = "0.2.0"

__all__ = [
    "MatrixProfileConfig",
    "compute_ab_join",
    "compute_aamp_profile",
    "anytime_matrix_profile",
    "approx_matrix_profile",
    "compute_topk_profile",
    "compute_pan_profile",
    "compute_multidim_profile",
    "multidim_motif",
    "multidim_subspace",
    "multidim_mdl",
    "MdlResult",
    "multidim_discord",
    "ostinato",
    "pan_m_range",
    "pan_motifs",
    "pan_discords",
    "snippets",
    "compute_matrix_profile",
    "matrix_profile",
    "top_motifs",
    "top_discords",
    "corrected_arc_curve",
    "one_directional_cac",
    "extract_regimes",
    "regimes",
    "Floss",
    "best_contrast",
    "cluster_series",
    "contrast_profile",
    "pan_contrast_profile",
    "top_contrast_motifs",
    "compute_batch_profiles",
    "compute_matrix_profile_masked",
    "missing_window_mask",
    "hierarchical_cluster",
    "mpdist_matrix",
    "apply_annotation_vector",
    "complexity_annotation",
    "all_chains",
    "unanchored_chain",
    "ChainsResult",
    "anchored_chain",
    "chain_lengths",
    "compute_chains",
    "compute_sum_thresh",
    "compute_sum_thresh_ab",
    "pooled_matrix",
    "LengthDiscord",
    "MerlinResult",
    "multi_length_discords",
    "multi_length_motifs",
    "Motiflet",
    "k_motiflets",
    "motiflet_elbows",
    "Anomaly",
    "OnlineAnomalyDetector",
    "compute_damp",
    "mpdist",
    "mass",
    "match",
    "AGGREGATE_INIT",
    "INDEX_INIT",
    "__version__",
]
