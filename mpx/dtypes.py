"""Dtype policy and aggregate initialization constants.

The analog of the reference's type-trait layer
(include/AggregateTypeTraits.hpp:14-38, include/Config.hpp.in:43-57):
aggregates are (Pearson-correlation value, neighbor index) pairs, initialized
to ``value = -1e12`` / ``index = -1`` so that any genuine correlation
(P in [-1, 1]) wins the max-merge, and untouched entries survive to the
output as the reference's sentinel values.

The reference supports ``double``/``float`` plus four fixed-point
ap_fixed compute dtypes (CMakeLists.txt:71).  float32 and float64 both
run natively on the GPU (float64 at a lower matmul rate); the ap_fixed tiers
map to input quantization + the narrowest exact float pipeline
(mpx/io/apfixed.py, resolved in MatrixProfileConfig — by the time a
dtype reaches this module it is one of the two floats).  bfloat16 is
accepted for the statistics inputs of experimental low-precision runs
but aggregates always accumulate in >= float32.
"""

from __future__ import annotations

import contextlib

import numpy as np

# Matches AggregateInit<double/float> = -1e12 (AggregateTypeTraits.hpp:14-22).
AGGREGATE_INIT = -1e12
# Matches IndexInit<int> = -1 (AggregateTypeTraits.hpp:32-38).
INDEX_INIT = -1

_SUPPORTED = {
    "float32": np.float32,
    "float64": np.float64,
    "f32": np.float32,
    "f64": np.float64,
    "double": np.float64,
    "float": np.float32,
}


def canonical_dtype(dtype) -> np.dtype:
    """Resolve a user-facing dtype spec to a numpy dtype.

    Accepts the reference's CMake-style names (``double``, ``float``,
    CMakeLists.txt:35) as well as numpy/JAX names.
    """
    if isinstance(dtype, str):
        key = dtype.lower()
        if key in _SUPPORTED:
            return np.dtype(_SUPPORTED[key])
        raise ValueError(
            f"Unsupported data type '{dtype}'. Data type has to be one of: "
            f"double(float64), float(float32)."
        )
    dt = np.dtype(dtype)
    if dt not in (np.dtype(np.float32), np.dtype(np.float64)):
        raise ValueError(f"Unsupported data type '{dt}'.")
    return dt


def index_dtype(n: int) -> np.dtype:
    """Index dtype policy: int32 everywhere (reference uses int,
    include/Config.hpp.in); n is validated to fit."""
    if n >= 2**31:
        raise ValueError(f"n={n} exceeds int32 index range")
    return np.dtype(np.int32)


def aggregate_init(dtype) -> float:
    """Initialization value for (max-)aggregates of the given dtype."""
    dt = canonical_dtype(dtype)
    return dt.type(AGGREGATE_INIT)


@contextlib.contextmanager
def x64_scope(enable: bool = True):
    """Scoped JAX x64 mode.

    float64 (the reference's flagship dtype) requires x64 tracing, but a
    globally-enabled x64 would turn every index in the float32 paths
    into i64.  All float64 jit tracing in mpx therefore happens inside
    this scope; float32 paths run with x64 off.
    """
    import jax

    if not enable:
        yield
        return
    prev = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def needs_x64(dtype) -> bool:
    return canonical_dtype(dtype) == np.dtype(np.float64)


def distance_epsilon(dtype) -> float:
    """Default absolute tolerance on output distances per dtype.

    float64 matches the reference test harness epsilon of 1e-8
    (test/include/MatrixProfileTests.hpp:73-74).  The reference never
    defined a float epsilon (its float configs would not even compile,
    see SURVEY §4); we define a practical tier for the f32 path.
    """
    dt = canonical_dtype(dtype)
    return 1e-8 if dt == np.dtype(np.float64) else 2e-3
