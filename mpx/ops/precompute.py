"""O(n) vectorized precomputation of SCAMP statistics.

The analog of the reference host's ``PreComputeStatistics``
(include/host/HostSideComputation.hpp:20-45), which runs an O(n*m) scalar
loop on the host CPU.  Here the statistics are computed in a fully
vectorized form:

* ``mu``   — rolling means via cumulative sums,
* ``df``   — ``(T[i+m-1] - T[i-1]) / 2``,
* ``dg``   — ``(T[i+m-1] - mu[i]) + (T[i-1] - mu[i-1])``,
* ``inv``  — ``1/sqrt(sum((T[i+k]-mu[i])^2))`` via sum-of-squares cumsums,
* ``qt0``  — first-row dot products ``QT(0, c) = SDP(0, c) - m*mu[0]*mu[c]``
  where SDP is the sliding dot product of the first window against the
  series (an MXU-friendly closed form; the same form re-seeds QT at every
  row band, removing the reference's global row-sequential dependence).

All accumulation happens in float64 for stability (cancellation in the
sum-of-squares path is catastrophic in float32), then casts to the compute
dtype.  Both a numpy (host) and a JAX (jit, device) implementation are
provided with identical semantics.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from mpx.types import Stats


# A window's centered sum-of-squares below REL * (its raw sum-of-squares)
# is numerically indistinguishable from a constant subsequence: the
# cumsum-based variance cancels two terms of magnitude sum(T^2), leaving
# ~eps*k relative noise (~1e-13); variance below 1e-10 of the energy is
# unresolvable in float64 for any backend, so those windows are
# deterministically degenerate (inv = inf, masked by the kernels).
ZERO_VARIANCE_REL = 1e-10


_WINDOWS_BLOCK = 8192
# Normalized-windows matrix budget (bytes); beyond this the MXU kernel
# falls back to per-job window construction (overridable via env).
WINDOWS_BUDGET = int(os.environ.get("MPX_WINDOWS_BUDGET", 4 << 30))


def _padded_width(w: int, band: int, chunk: int) -> int:
    """Pad the subsequence count so every job window slice is in-bounds:
    jobs read column slices of width chunk + band starting at most at
    w - 1.  Rounded up to the windows-build block size."""
    pw = int(w + band + chunk)
    return ((pw + _WINDOWS_BLOCK - 1) // _WINDOWS_BLOCK) * _WINDOWS_BLOCK


def build_windows(stats: Stats, m: int) -> jax.Array:
    """Unit-normalized window matrix (padded_w, m), built blockwise on
    device (one big stack blows the compile; zero-variance and padded
    rows come out as zeros)."""
    pw = stats.mu.shape[0]
    nb = pw // _WINDOWS_BLOCK
    invc = jnp.where(jnp.isfinite(stats.inv), stats.inv, 0)

    def blk(i):
        o = i * _WINDOWS_BLOCK
        seg = jax.lax.dynamic_slice(stats.T, (o,), (_WINDOWS_BLOCK + m - 1,))
        Wm = jnp.stack([seg[j : j + _WINDOWS_BLOCK] for j in range(m)], axis=1)
        mu = jax.lax.dynamic_slice(stats.mu, (o,), (_WINDOWS_BLOCK,))
        iv = jax.lax.dynamic_slice(invc, (o,), (_WINDOWS_BLOCK,))
        return (Wm - mu[:, None]) * iv[:, None]

    out = jax.lax.map(blk, jnp.arange(nb, dtype=jnp.int32))
    return out.reshape(nb * _WINDOWS_BLOCK, m)


def precompute_statistics_numpy(T: np.ndarray, m: int) -> dict:
    """Float64 statistics of an unpadded series (host-side, BLAS)."""
    T = np.asarray(T, dtype=np.float64)
    n = T.shape[0]
    if m < 4:
        raise ValueError("m must be >= 4")
    if n < m:
        raise ValueError("n must be >= m")
    w = n - m + 1

    c1 = np.concatenate([[0.0], np.cumsum(T)])
    mu = (c1[m:] - c1[:-m]) / m

    df = np.zeros(w, dtype=np.float64)
    dg = np.zeros(w, dtype=np.float64)
    df[1:] = (T[m:] - T[:w - 1]) / 2
    dg[1:] = (T[m:] - mu[1:]) + (T[:w - 1] - mu[:w - 1])

    # Two-pass centered sum-of-squares — the SAME estimator as the native
    # backend (mpx/native/scamp_host.cpp) and the streaming path, so the
    # zero-variance classification below agrees across backends (the
    # cumsum form sumsq - m*mu^2 rounds differently near the threshold).
    windows = np.lib.stride_tricks.sliding_window_view(T, m)
    ssq = np.empty(w, dtype=np.float64)
    sumsq = np.empty(w, dtype=np.float64)
    blk = 1 << 16  # bound the materialized centered block to ~128 MB
    for o in range(0, w, blk):
        wv = windows[o : o + blk]
        cent = wv - mu[o : o + blk, None]
        ssq[o : o + blk] = np.einsum("ij,ij->i", cent, cent)
        sumsq[o : o + blk] = np.einsum("ij,ij->i", wv, wv)
    # Numerically-zero variance (constant subsequences up to rounding) is
    # clamped to exactly zero so inv becomes inf and the kernels' finite
    # masks skip those windows deterministically — regardless of which
    # precompute backend's rounding produced the residue.
    ssq = np.where(ssq <= ZERO_VARIANCE_REL * np.abs(sumsq), 0.0, ssq)
    with np.errstate(divide="ignore"):
        inv = 1.0 / np.sqrt(ssq)

    sdp0 = windows @ T[:m]
    qt0 = sdp0 - m * mu[0] * mu

    return {"mu": mu, "df": df, "dg": dg, "inv": inv, "qt0": qt0}


def _ssq_two_pass_jax_f64(T: jax.Array, mu: jax.Array, m: int, w: int):
    """Blockwise two-pass centered sum-of-squares + raw sum-of-squares,
    the SAME estimator as the host paths (precompute_statistics_numpy /
    the native kernel): relative error ~m*eps regardless of how small a
    window's variance is.  A cumsum-difference form is NOT usable here —
    its error scales with the PREFIX energy, so near-constant windows
    (and even ordinary walk windows once n reaches ~1M) get inv values
    whose relative error exceeds the hybrid tier's soundness margin
    (observed: a missed exact-NN candidate at margin 1.8e-4).  The
    O(n*m) emulated-f64 cost is milliseconds next to the O(n^2) sweep.
    """
    B = _WINDOWS_BLOCK
    nb = -(-w // B)
    Tp = jnp.pad(T, (0, nb * B + m - 1 - T.shape[0]))
    mup = jnp.pad(mu, (0, nb * B - w))

    def blk(i):
        o = i * B
        seg = jax.lax.dynamic_slice(Tp, (o,), (B + m - 1,))
        Wm = jnp.stack([seg[j : j + B] for j in range(m)], axis=1)
        mub = jax.lax.dynamic_slice(mup, (o,), (B,))
        cent = Wm - mub[:, None]
        return jnp.sum(cent * cent, axis=1), jnp.sum(Wm * Wm, axis=1)

    ssq, sumsq = jax.lax.map(blk, jnp.arange(nb, dtype=jnp.int32))
    return ssq.reshape(-1)[:w], sumsq.reshape(-1)[:w]


def _mu_inv_jax_f64(T: jax.Array, m: int):
    """mu (f64 cumsum) and inv (two-pass, host-matching conditioning) —
    shared by the full and matmul-only device precomputes."""
    w = T.shape[0] - m + 1
    c1 = jnp.concatenate([jnp.zeros(1, T.dtype), jnp.cumsum(T)])
    mu = (c1[m:] - c1[:-m]) / m

    ssq, sumsq = _ssq_two_pass_jax_f64(T, mu, m, w)
    ssq = jnp.where(ssq <= ZERO_VARIANCE_REL * jnp.abs(sumsq), 0.0, ssq)
    inv = 1.0 / jnp.sqrt(ssq)
    return mu, inv


def _precompute_jax_f64(T: jax.Array, m: int):
    T = T.astype(jnp.float64)
    w = T.shape[0] - m + 1

    mu, inv = _mu_inv_jax_f64(T, m)

    df = jnp.concatenate([jnp.zeros(1, T.dtype), (T[m:] - T[: w - 1]) / 2])
    dg = jnp.concatenate(
        [jnp.zeros(1, T.dtype), (T[m:] - mu[1:]) + (T[: w - 1] - mu[: w - 1])]
    )

    sdp0 = sliding_dot_product(T[:m], T)
    qt0 = sdp0 - m * mu[0] * mu
    return mu, df, dg, inv, qt0


def _precompute_jax_f64_matmul(T: jax.Array, m: int):
    """mu/inv only: the windows-matmul tiers never read the recurrence
    seeds, and qt0's sliding conv is the expensive part of the emulated
    f64 device precompute (an m-tap HIGHEST-precision conv over n)."""
    return _mu_inv_jax_f64(T.astype(jnp.float64), m)


def sliding_dot_product(q: jax.Array, T: jax.Array) -> jax.Array:
    """SDP(c) = sum_k q[k] * T[c+k] for c in [0, len(T) - len(q) + 1).

    Lowered as a 1-D convolution so XLA maps it onto the MXU.  This is the
    closed-form seed generator that replaces the reference's row-serial QT
    carry between diagonal chunks (kernel/MatrixProfileKernelVanilla.cpp:43
    initializes from driver-provided QT of row 0 only; mpx re-seeds any row
    band directly)."""
    m = q.shape[0]
    lhs = T[None, None, :]
    rhs = q[None, None, :]
    # Precision.HIGHEST: the GPU default multiplies f32 in TF32, and the
    # seed's later cancellation (SDP - m*mu_r*mu_c) amplifies that into
    # garbage QT values.
    out = jax.lax.conv_general_dilated(
        lhs,
        rhs,
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=T.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[0, 0, :]


def precompute_statistics(
    T,
    m: int,
    *,
    band: int,
    chunk: int,
    dtype=jnp.float32,
    backend: str = "auto",
    windows: bool | None = None,
    host_stats: dict | None = None,
    matmul_only: bool = False,
) -> Stats:
    """Device-resident, padded statistics in the compute dtype.

    Accumulation is always float64 (cancellation in the sum-of-squares
    path is catastrophic below that); pads with zeros so out-of-range
    lanes mirror the reference's ``InputDataPack(0)`` behavior.

    ``backend``:

    * ``'native'`` — the C++ single-pass kernel (exact reference
      semantics, OpenMP), then one O(n) host->device transfer;
    * ``'numpy'``  — vectorized host float64;
    * ``'jax'``    — jitted on-device float64 (x64-scoped tracing);
    * ``'auto'``   — native if the toolchain built, else numpy.  The
      statistics are O(n) next to the O(n^2) sweep, so the host paths
      cost one small transfer.

    ``matmul_only=True`` stages just the windows-matmul operands
    (T, mu, inv) and zero-fills df/dg/qt0 on device — the recurrence
    seeds are dead weight for the mxu/hybrid tiers, and host->device
    bandwidth is the staging cost (host backends only).
    """
    if host_stats is not None:
        backend = "precomputed"
    elif backend == "auto":
        from mpx import native

        backend = "native" if native.is_available() else "numpy"

    n = int(np.asarray(T).shape[0] if not hasattr(T, "shape") else T.shape[0])
    w = n - m + 1
    pw = _padded_width(w, band, chunk)
    dt = jnp.dtype(dtype)

    if backend in ("native", "numpy", "precomputed"):
        from mpx.dtypes import x64_scope

        T64 = np.asarray(T, dtype=np.float64)
        if backend == "precomputed":
            s = host_stats
        elif backend == "native":
            from mpx import native

            s = native.precompute(T64, m)
        else:
            s = precompute_statistics_numpy(T64, m)

        def padn(x, width):
            out = np.zeros(width, dtype=dt)
            out[: x.shape[0]] = x.astype(dt)
            return jnp.asarray(out)

        # x64 scope so float64 stats survive device staging uncanonicalized.
        with x64_scope(dt == jnp.dtype(jnp.float64)):
            zeros = lambda: jnp.zeros((pw,), dtype=dt)
            stats = Stats(
                T=padn(T64, pw + m - 1),
                mu=padn(s["mu"], pw),
                df=zeros() if matmul_only else padn(s["df"], pw),
                dg=zeros() if matmul_only else padn(s["dg"], pw),
                inv=padn(s["inv"], pw),
                qt0=zeros() if matmul_only else padn(s["qt0"], pw),
            )
            return _maybe_windows(stats, m, windows)

    if backend != "jax":
        raise ValueError(f"unknown precompute backend {backend!r}")

    from mpx.dtypes import x64_scope

    with x64_scope():
        T = jnp.asarray(T, dtype=jnp.float64)

        def pad(x, width, fill=0.0):
            return jnp.pad(x, (0, width - x.shape[0]), constant_values=fill)

        if matmul_only:
            mu, inv = jax.jit(
                _precompute_jax_f64_matmul, static_argnums=1
            )(T, m)
            zero = jnp.zeros((pw,), dtype=dt)
            df = dg = qt0 = None
        else:
            mu, df, dg, inv, qt0 = jax.jit(
                _precompute_jax_f64, static_argnums=1
            )(T, m)

        stats = Stats(
            T=pad(T.astype(dt), pw + m - 1),
            mu=pad(mu.astype(dt), pw),
            df=zero if matmul_only else pad(df.astype(dt), pw),
            dg=zero if matmul_only else pad(dg.astype(dt), pw),
            inv=pad(inv.astype(dt), pw),
            qt0=zero if matmul_only else pad(qt0.astype(dt), pw),
        )
        return _maybe_windows(stats, m, windows)


def _maybe_windows(stats: Stats, m: int, windows) -> Stats:
    """Attach the normalized-windows matrix when requested or when it
    fits the HBM budget (auto)."""
    pw = stats.mu.shape[0]
    size = pw * m * jnp.dtype(stats.mu.dtype).itemsize
    if windows is None:
        windows = size <= WINDOWS_BUDGET
    if not windows:
        return stats
    U = jax.jit(build_windows, static_argnums=1)(stats, m)
    return stats._replace(windows=U)
