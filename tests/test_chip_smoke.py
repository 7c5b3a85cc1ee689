"""chip_smoke.py at tiny sizes on the CPU: every phase's entry points,
oracles and checks run here; only the times and the device are the
card's.  The script itself refuses to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = {
    "flagship": dict(n=2048, m=32, band=256, chunk=512, rows=16),
    "margin": dict(n=2048, m=32, band=256, chunk=512, pairs=20000),
    "one_pass": dict(n=2048, m=16),
    "strict": dict(n=2048, m=32),
    "cli": dict(path="data/binary/1024.tsb", m=16),
    "serve": dict(n=600, m=16, append=32, appends=3),
    "four": dict(n=2048, m=32, band=128, chunk=256, ring_chunk=128),
}


@pytest.fixture
def hybrid_f32(monkeypatch):
    # route float32 through the hybrid tier at tiny widths, as the
    # full-size flagship does at w >= 2^19
    import mpx.kernels as K

    monkeypatch.setattr(K, "HYBRID32_MIN_W", 1024)


@pytest.mark.parametrize("dtype,kernel", [("double", "hybrid"),
                                          ("float32", "hybrid")])
def test_phase_flagship(hybrid_f32, dtype, kernel):
    f = TINY["flagship"]
    checks, first, warm = cs.phase_flagship(
        cs.random_walk(f["n"], 0), m=f["m"], band=f["band"],
        chunk=f["chunk"], rows=f["rows"], dtype=dtype)
    assert checks["kernel"] == kernel and checks["rows"] == f["rows"]
    assert first > 0 and warm > 0


def test_phase_margin():
    g = TINY["margin"]
    checks, _, _ = cs.phase_margin(
        cs.random_walk(g["n"], 1), m=g["m"], band=g["band"],
        chunk=g["chunk"], pairs=g["pairs"])
    assert checks["rows"] == g["n"] - g["m"] + 1
    assert checks["precision"] == "HIGHEST"
    assert checks["pairs"] >= g["pairs"] * 0.9
    assert 0 <= checks["ratio"] < cs.MARGIN_RATIO_MAX


@pytest.mark.parametrize("dtype,kernel,resolved,tol", [
    ("float32", "auto", "mxu", cs.TOL32),   # phase 4
    ("double", "mxu", "mxu", cs.TOL64),     # phase 5
])
def test_phase_one_pass_and_strict(dtype, kernel, resolved, tol):
    o = TINY["one_pass"]
    checks, _, _ = cs.phase_one_pass(cs.random_walk(o["n"], 2), m=o["m"],
                                     dtype=dtype, kernel=kernel, tol=tol)
    assert checks["kernel"] == resolved
    assert checks["rows"] == o["n"] - o["m"] + 1
    assert checks["max_abs_err"] <= tol


def test_phase_cli(tmp_path):
    c = TINY["cli"]
    checks, _, _ = cs.phase_cli(os.path.join(REPO, c["path"]), m=c["m"],
                                tmpdir=str(tmp_path))
    assert checks["rows"] == 1024 - c["m"] + 1


def test_phase_serve():
    v = TINY["serve"]
    T = cs.random_walk(v["n"] + v["append"] * v["appends"], 4)
    checks, _, _ = cs.phase_serve(T, m=v["m"], append=v["append"],
                                  appends=v["appends"])
    assert checks["devices"] >= 1
    assert checks["stream"]["rows"] == T.shape[0] - v["m"] + 1


def test_phase_four_on_virtual_devices():
    """The --four-gpu comparisons on 4 of the virtual CPU devices:
    sharded f64 hybrid bit-identical, f32 jobs and ring under the tie
    rule."""
    q = TINY["four"]
    out = cs.phase_four(cs.random_walk(q["n"], 5), m=q["m"], band=q["band"],
                        chunk=q["chunk"], ring_chunk=q["ring_chunk"], ndev=4)
    assert out["jobs_f64"]["bit_identical"]
    assert out["jobs_f32"]["max_abs_err"] <= cs.TOL32
    assert out["ring_f32"]["max_abs_err"] <= cs.TOL32


def test_compare_profiles_tie_rule():
    """Equidistant index swaps pass; a wrong distance or a non-tie index
    fails the phase."""
    T = cs.random_walk(512, 6)
    m = 16
    MP, MPI = cs.golden(T, m)
    cs.compare_profiles(T, m, MP, MPI, MP, MPI, cs.TOL64, "self")
    bad = MP.copy()
    bad[10] += 1e-3
    with pytest.raises(cs.PhaseFailure, match="1 distance mismatches"):
        cs.compare_profiles(T, m, bad, MPI, MP, MPI, cs.TOL64, "d")
    far = MPI.copy()
    far[10] = (far[10] + 200) % MPI.shape[0]
    with pytest.raises(cs.PhaseFailure, match="1 non-tie index"):
        cs.compare_profiles(T, m, MP, far, MP, MPI, cs.TOL64, "i")
    # an exact tie: three copies of one segment — window 1 of the first
    # copy is equidistant (0) from its twins at 257 and 513
    a = cs.random_walk(256, 7)
    P = np.concatenate([a, a, a])
    MPp, MPIp = cs.golden(P, m)
    MPp = np.nan_to_num(MPp)  # sqrt of a rounding-negative 1 - P
    assert MPIp[1] == 257
    alt = MPIp.copy()
    alt[1] = 513
    out = cs.compare_profiles(P, m, MPp, alt, MPp, MPIp, 1e-6, "tie")
    assert out["tie_indices"] == 1


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        cs.require_gpu({"platform": "cpu", "kind": "cpu", "count": 8})
    with pytest.raises(SystemExit, match="need 4 GPUs"):
        cs.require_gpu({"platform": "gpu", "kind": "H100", "count": 1}, 4)
    cs.require_gpu({"platform": "gpu", "kind": "H100", "count": 4}, 4)


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_last_line_contract(monkeypatch, capsys):
    """On a GPU the last stdout line is exactly the contract's object;
    the card's nvidia-smi line comes before it."""
    monkeypatch.setattr(cs, "device_summary", lambda: {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1})
    monkeypatch.setattr(cs, "card_info", lambda: "NVIDIA H100, 700.00 W")
    ran = []
    monkeypatch.setattr(cs, "run_phases", lambda *a: ran.append(a) or {})
    assert cs.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert ran and "nvidia-smi: NVIDIA H100, 700.00 W" in lines[:-1]
    last = json.loads(lines[-1])
    assert last == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_failed_phase_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(cs, "device_summary", lambda: {
        "platform": "gpu", "kind": "H100", "count": 1})

    def fail(*a):
        raise cs.PhaseFailure("boom")

    monkeypatch.setattr(cs, "run_phases", fail)
    assert cs.main([]) == 1
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the
    repo, the script fails and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
