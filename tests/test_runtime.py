import os

import jax
import numpy as np

from mpx import runtime
from mpx.runtime import DeviceContext, devices


def test_device_context_roundtrip():
    ctx = DeviceContext()
    x = np.arange(16, dtype=np.float32)
    d = ctx.to_device(x)
    ns = ctx.finish(d)
    assert ns >= 0
    np.testing.assert_array_equal(ctx.to_host(d), x)
    assert ctx.platform in ("cpu", "gpu")
    assert len(devices()) >= 1


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache
    and no other is configured."""
    want = str(tmp_path / "cc")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    assert runtime.compilation_cache_dir() == want
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(runtime, "_CACHE_ENABLED", False)
    try:
        runtime.enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == want
        assert os.path.isdir(want)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    """Without the env var the cache sits at one fixed path inside the
    checkout (the path is part of the cache key), the same on every
    call; the per-machine suffix applies on the CPU backend only."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    a = runtime.compilation_cache_dir()
    b = runtime.compilation_cache_dir()
    assert a == b
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert runtime.DEFAULT_CACHE_DIR == os.path.join(repo, ".jax_cache")
    assert a.startswith(runtime.DEFAULT_CACHE_DIR)
    assert os.path.basename(a).startswith("cpu-")  # tests run on the CPU
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert runtime.compilation_cache_dir() == runtime.DEFAULT_CACHE_DIR
