"""Every f32 device matmul must run at true fp32 precision.

On the GPU an f32 ``dot_general`` at precision None, DEFAULT or HIGH
runs in TF32, which keeps 10 mantissa bits: the per-pair error of a
unit-normalized dot then reaches ~1e-3, an order of magnitude past the
hybrid tier's margin (mpx.hybrid.default_margin), and one-hot index
matmuls round integers past 2^11.  The CPU ignores precision hints
entirely, so a missing or reduced ``precision=`` passes every CPU test
and corrupts results only on the card.

This guard traces the device paths and walks their jaxprs: any f32
dot_general that does not ask for full fp32 fails here, on the CPU.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

_FULL_F32_PRESETS = ("F32_F32_F32", "F64_F64_F64", "BF16_BF16_F32_X6")


def _sub_jaxprs(v):
    if hasattr(v, "eqns"):  # core.Jaxpr (shard_map bodies)
        yield v
    elif hasattr(v, "jaxpr"):  # ClosedJaxpr (pjit, scan, while, cond)
        yield v.jaxpr
    elif isinstance(v, (list, tuple)):
        for it in v:
            yield from _sub_jaxprs(it)


def _walk(jaxpr, found):
    """Collect (precision, operand dtype) of every dot_general."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append((eqn.params.get("precision"),
                          eqn.invars[0].aval.dtype))
        for v in eqn.params.values():
            for sub in _sub_jaxprs(v):
                _walk(sub, found)


def _full_f32(p, allow=()) -> bool:
    """True when precision ``p`` (as traced) gives true-fp32 products."""
    if p is None:
        return False
    if isinstance(p, tuple):
        return all(x == jax.lax.Precision.HIGHEST for x in p)
    if p == jax.lax.Precision.HIGHEST:
        return True
    return getattr(p, "name", "") in _FULL_F32_PRESETS + tuple(allow)


def _check(jaxprs, allow=()):
    found = []
    for jp in jaxprs:
        _walk(jp.jaxpr if hasattr(jp, "jaxpr") else jp, found)
    assert found, "expected at least one dot_general"
    f32 = [p for p, dt in found if dt == jnp.float32]
    bad = [p for p in f32 if not _full_f32(p, allow)]
    assert not bad, (
        f"{len(bad)}/{len(f32)} f32 dot_general(s) trace with precision "
        f"{sorted({str(p) for p in bad})} — on the GPU that is TF32; "
        "pass precision=HIGHEST"
    )
    return found


def assert_no_default_precision(fn, *args, **kwargs):
    jaxpr = jax.make_jaxpr(lambda *a: fn(*a, **kwargs))(*args)
    _check([jaxpr])


def test_onehot_helpers_precision():
    from mpx.kernels.mxu import (
        SuspectWindow,
        _dense_merge_cols,
        _flagged_indices,
        _onehot_rows,
        _scatter_dense_max,
    )

    F, L, K = 8, 128, 4
    idx = jnp.arange(F, dtype=jnp.int32)
    win = SuspectWindow(
        cnt=jnp.zeros((F,), jnp.int32),
        mn=jnp.zeros((F, K), jnp.int32),
        mx=jnp.zeros((F, K), jnp.int32),
    )
    assert_no_default_precision(
        lambda i: _dense_merge_cols(i, win, F, L), idx
    )
    flags = jnp.zeros((L,), bool).at[3].set(True)
    assert_no_default_precision(
        lambda f: _flagged_indices(f, F, L), flags
    )
    U = jnp.ones((L, 16), jnp.float32)
    assert_no_default_precision(lambda i: _onehot_rows(i, U, F, L), idx)
    vals = jnp.ones((F,), jnp.float32)
    assert_no_default_precision(
        lambda i, v: _scatter_dense_max(i, v, F, L), idx, vals
    )


@pytest.mark.parametrize("mode", ["mxu", "max", "suspects", "sparse",
                                  "fused", "refine"])
def test_sweep_kernels_precision(mode):
    from mpx.kernels import band_geometry
    from mpx.kernels.mxu import (
        sweep_band_max,
        sweep_band_mxu,
        sweep_band_refine_sparse,
        sweep_band_suspects,
        sweep_band_suspects_fused,
        sweep_band_suspects_sparse,
    )
    from mpx.types import Stats

    S = W = 64
    m = 16
    w = 256
    geom = band_geometry(S, W, m, w, 8, W)
    L = w + max(S, W) + m
    stats = Stats(
        T=jnp.ones((L,), jnp.float32),
        mu=jnp.ones((w + W,), jnp.float32),
        df=jnp.ones((1,), jnp.float32),
        dg=jnp.ones((1,), jnp.float32),
        inv=jnp.ones((w + W,), jnp.float32),
        qt0=jnp.ones((1,), jnp.float32),
        windows=None,
    )
    thr = jnp.full((w + W,), 0.5, jnp.float32)
    r0 = jnp.int32(0)
    k0 = jnp.int32(16)
    F = 16
    jrow = jnp.zeros((S,), jnp.uint16)
    jcol = jnp.zeros((W,), jnp.uint16)

    if mode == "mxu":
        fn = lambda r: sweep_band_mxu(stats, r, k0, geom, jnp.float32)
    elif mode == "max":
        fn = lambda r: sweep_band_max(stats, r, k0, geom, jnp.float32)
    elif mode == "suspects":
        fn = lambda r: sweep_band_suspects(
            stats, r, k0, geom, jnp.float32, thr
        )
    elif mode == "sparse":
        fn = lambda r: sweep_band_suspects_sparse(
            stats, r, k0, jrow, jcol, geom, thr, F
        )
    elif mode == "fused":
        fn = lambda r: sweep_band_suspects_fused(
            stats, r, k0, geom, thr, F
        )
    else:
        fn = lambda r: sweep_band_refine_sparse(
            stats, r, k0, jrow, jcol, geom, thr, F
        )
    assert_no_default_precision(fn, r0)


def test_scan_flagged_rows_precision():
    from mpx.hybrid import scan_flagged_rows
    from mpx.types import Stats

    m, w = 16, 256
    CW = 64
    L = w + CW + m
    stats = Stats(
        T=jnp.ones((L,), jnp.float32),
        mu=jnp.ones((w + CW,), jnp.float32),
        df=jnp.ones((1,), jnp.float32),
        dg=jnp.ones((1,), jnp.float32),
        inv=jnp.ones((w + CW,), jnp.float32),
        qt0=jnp.ones((1,), jnp.float32),
        windows=None,
    )
    thr = jnp.full((w + CW,), 0.5, jnp.float32)
    flag = jnp.arange(8, dtype=jnp.int32)
    assert_no_default_precision(
        lambda f: scan_flagged_rows(
            stats, thr, f, m=m, w=w, excl=4, K=8, CW=CW
        ),
        flag,
    )


# ---------------------------------------------------------------------------
# The device paths as the program runs them: spy on the jitted functions
# each path dispatches, trace each call's jaxpr with the exact arguments
# the program passed, and check every f32 dot_general in it.


def _is_tracing(args) -> bool:
    return any(isinstance(a, jax.core.Tracer)
               for a in jax.tree_util.tree_leaves(args))


def _spy(monkeypatch, module, name, log):
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        if not _is_tracing((args, kwargs)):  # nested calls trace inside
            log.setdefault(name, []).append(
                jax.make_jaxpr(partial(real, **kwargs))(*args)
            )
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)


class _RingJax:
    """Stand-in for the ``jax`` module inside mpx.parallel.ring: every
    ``jax.jit(f)`` the ring builds at run time records f's jaxpr."""

    def __init__(self, log):
        self._log = log

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, f, **kw):
        real = jax.jit(f, **kw)
        log = self._log

        def call(*args):
            log.setdefault("ring", []).append(jax.make_jaxpr(f)(*args))
            return real(*args)

        return call


def _plateau_series(n, seed):
    # a periodic series with small noise: every row has dozens of
    # near-tied neighbors spread over the whole series, which overflows
    # the capture slots and forces the device pass C
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return np.sin(2 * np.pi * t / 32) + 1e-3 * rng.standard_normal(n)


def _run_hybrid(monkeypatch, log, *, staged=True, sparse=True):
    import mpx.hybrid as H
    from mpx.config import MatrixProfileConfig

    if staged:
        monkeypatch.setattr(H, "HYBRID_SMALL_FUSED_W", 0)
    if not sparse:
        monkeypatch.setenv("MPX_HYBRID_SPARSE", "0")
    for name in ("_max_jobs_group", "_suspect_jobs_group",
                 "_sparse_suspect_group", "scan_flagged_rows",
                 "_hybrid_small_fused", "_refine_group"):
        _spy(monkeypatch, H, name, log)
    T = _plateau_series(1024, seed=3)
    cfg = MatrixProfileConfig(m=16, dtype="float64", band=64, chunk=128)
    H.compute_matrix_profile_f64_hybrid(T, cfg)


def _case_hybrid_sparse(monkeypatch, log):
    _run_hybrid(monkeypatch, log)
    return ("_max_jobs_group", "_sparse_suspect_group", "scan_flagged_rows")


def _case_hybrid_dense(monkeypatch, log):
    _run_hybrid(monkeypatch, log, sparse=False)
    return ("_max_jobs_group", "_suspect_jobs_group", "scan_flagged_rows")


def _case_hybrid_small_fused(monkeypatch, log):
    _run_hybrid(monkeypatch, log, staged=False)
    return ("_hybrid_small_fused", "scan_flagged_rows")


def _case_ring_hybrid(monkeypatch, log):
    import mpx.parallel.ring as R

    monkeypatch.setattr(R, "jax", _RingJax(log))
    R.run_ring_hybrid_f64(_plateau_series(1024, seed=4), 16, num_shards=2,
                          band=64, chunk=64)
    return ("ring",)


def _case_pan_kernel(monkeypatch, log):
    import mpx.pan_kernel as PK

    _spy(monkeypatch, PK, "_run_pan_group", log)
    T = np.cumsum(np.random.default_rng(5).standard_normal(512))
    PK.run_pan_jobs(T, [16, 20, 24], band=64, chunk=64)
    return ("_run_pan_group",)


def _case_one_pass_tile(monkeypatch, log):
    import mpx.driver as D
    from mpx.config import MatrixProfileConfig

    monkeypatch.setattr(D, "SMALL_FUSED_MAX_W", 0)
    _spy(monkeypatch, D, "run_jobs", log)
    T = np.cumsum(np.random.default_rng(6).standard_normal(512))
    D.compute_matrix_profile(T, config=MatrixProfileConfig(
        m=16, dtype="float32", kernel="mxu", band=64, chunk=64))
    return ("run_jobs",)


_CASES = {
    "hybrid_sparse": _case_hybrid_sparse,
    "hybrid_dense": _case_hybrid_dense,
    "hybrid_small_fused": _case_hybrid_small_fused,
    "ring_hybrid": _case_ring_hybrid,
    "pan_kernel": _case_pan_kernel,
    "one_pass_tile": _case_one_pass_tile,
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_device_path_precision(monkeypatch, case):
    log = {}
    expected = _CASES[case](monkeypatch, log)
    missing = [name for name in expected if not log.get(name)]
    assert not missing, f"path never dispatched {missing}"
    _check([jp for jps in log.values() for jp in jps])


def test_cascade_bf16_sweep_is_explicit(monkeypatch):
    """The opt-in cascade's approximate sweep names its bf16 operands
    explicitly (a bounded, deliberate approximation, the same on every
    backend); its refine and pass-B sweeps are full fp32."""
    log = {}
    monkeypatch.setenv("MPX_HYBRID_CASCADE", "1")
    _run_hybrid(monkeypatch, log)
    assert log.get("_refine_group") and log.get("_max_jobs_group")
    found = _check([jp for jps in log.values() for jp in jps],
                   allow=("BF16_BF16_F32",))
    names = {getattr(p, "name", "") for p, _ in found}
    assert "BF16_BF16_F32" in names
    # the guard itself rejects the cascade's sweep outside this case
    with pytest.raises(AssertionError, match="TF32"):
        _check(log["_max_jobs_group"][:1])


def test_guard_rejects_tf32_precisions():
    """The guard flags exactly the precisions that run in TF32 on the
    GPU (None, DEFAULT, HIGH) and accepts HIGHEST."""
    x = jnp.ones((4, 8), jnp.float32)
    for prec, ok in [(None, False),
                     (jax.lax.Precision.DEFAULT, False),
                     (jax.lax.Precision.HIGH, False),
                     (jax.lax.Precision.HIGHEST, True)]:
        jp = jax.make_jaxpr(
            lambda a: jax.lax.dot_general(
                a, a, (((1,), (1,)), ((), ())), precision=prec)
        )(x)
        if ok:
            _check([jp])
        else:
            with pytest.raises(AssertionError):
                _check([jp])
    # f64 dots carry no TF32 hazard and are not checked
    from mpx.dtypes import x64_scope

    with x64_scope(True):
        jp = jax.make_jaxpr(lambda a: a @ a.T)(jnp.ones((4, 8), jnp.float64))
    assert [dt for _, dt in _check([jp])] == [jnp.float64]


def test_sweep_precision_fixed_in_code():
    """The sweep precision is a constant, not an environment knob."""
    import mpx.hybrid as H
    import mpx.kernels.mxu as MX

    assert H.HYBRID_PRECISION == "HIGHEST"
    assert MX._PRECISION == jax.lax.Precision.HIGHEST
