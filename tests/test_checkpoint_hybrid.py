"""Checkpoint / resume for the hybrid exact-f64 tier (the flagship
path).  VERDICT r2 item 3: kill a run mid-pass-A and mid-pass-B,
resume, and require a byte-identical profile versus an uninterrupted
run (reference analog: the host aggregate arrays as natural checkpoint
state, /root/reference/host/MatrixProfileHost.cpp:41)."""

import numpy as np
import pytest

from mpx.checkpoint import HybridCheckpoint, compute_hybrid_with_checkpoint
from mpx.config import MatrixProfileConfig
from mpx.reference import compute_matrix_profile_reference
from tests.conftest import random_walk
from tests.helpers import assert_profile_close


class _Killed(RuntimeError):
    pass


def _interrupting(kill_stage: str, after: int):
    """A HybridCheckpoint that dies after ``after`` saves in the given
    stage — simulating a crash mid-pass."""

    class Interrupting(HybridCheckpoint):
        saves = 0

        def save_a(self, rmax, cmax, next_group):
            super().save_a(rmax, cmax, next_group)
            if kill_stage == "A":
                Interrupting.saves += 1
                if Interrupting.saves >= after:
                    raise _Killed

        def mark_done_and_save(self, rows_g, cols_g, r0s, k0s, keep=None):
            super().mark_done_and_save(rows_g, cols_g, r0s, k0s, keep=keep)
            if kill_stage == "B":
                Interrupting.saves += 1
                if Interrupting.saves >= after:
                    raise _Killed

    return Interrupting


@pytest.fixture()
def small_groups(monkeypatch):
    """Shrink the checkpoint group so tiny test problems span
    multiple pass-A groups and pass-B batches."""
    monkeypatch.setattr(HybridCheckpoint, "group_jobs", 64)


@pytest.mark.parametrize("kill_stage,after", [("A", 2), ("B", 1)])
def test_hybrid_resume_byte_identical(tmp_path, small_groups, kill_stage,
                                      after):
    from mpx.hybrid import compute_matrix_profile_f64_hybrid

    T = random_walk(3000, seed=71)
    m = 16
    cfg = MatrixProfileConfig(m=m, dtype="float64", band=64, chunk=64)
    path = str(tmp_path / "hy.npz")

    MP0, MPI0 = compute_matrix_profile_f64_hybrid(T, cfg)

    with pytest.raises(_Killed):
        compute_hybrid_with_checkpoint(
            T, cfg, path, _ckpt_cls=_interrupting(kill_stage, after)
        )
    assert (tmp_path / "hy.npz").exists()

    MP1, MPI1 = compute_hybrid_with_checkpoint(T, cfg, path)
    np.testing.assert_array_equal(MP0, MP1)
    np.testing.assert_array_equal(MPI0, MPI1)
    assert not (tmp_path / "hy.npz").exists()  # removed on success

    MP_exp, MPI_exp = compute_matrix_profile_reference(T, m)
    assert_profile_close(T, m, MP1, MPI1, MP_exp, MPI_exp, eps=1e-8)


def test_hybrid_resume_after_pass_a(tmp_path, small_groups):
    """Crash exactly between pass A and the first pass-B save: the
    stage-A record is complete, every job re-sweeps densely."""
    from mpx.hybrid import compute_matrix_profile_f64_hybrid

    T = random_walk(2000, seed=72)
    m = 16
    cfg = MatrixProfileConfig(m=m, dtype="float64", band=64, chunk=64)
    path = str(tmp_path / "hy.npz")

    MP0, MPI0 = compute_matrix_profile_f64_hybrid(T, cfg)

    class DieOnBeginB(HybridCheckpoint):
        def begin_b(self, thr):
            super().begin_b(thr)
            raise _Killed

    with pytest.raises(_Killed):
        compute_hybrid_with_checkpoint(T, cfg, path, _ckpt_cls=DieOnBeginB)

    MP1, MPI1 = compute_hybrid_with_checkpoint(T, cfg, path)
    np.testing.assert_array_equal(MP0, MP1)
    np.testing.assert_array_equal(MPI0, MPI1)


def test_checkpoint_routes_hybrid(tmp_path):
    """compute_with_checkpoint with dtype=float64 kernel=auto now takes
    the hybrid tier (VERDICT r2: the ValueError is gone) and matches
    the golden profile exactly."""
    from mpx.checkpoint import compute_with_checkpoint

    T = random_walk(1200, seed=73)
    m = 16
    cfg = MatrixProfileConfig(m=m, dtype="float64", band=64, chunk=64)
    path = str(tmp_path / "auto.npz")
    MP, MPI = compute_with_checkpoint(T, cfg, path)
    MP_exp, MPI_exp = compute_matrix_profile_reference(T, m)
    assert MP.dtype == np.float64
    assert_profile_close(T, m, MP, MPI, MP_exp, MPI_exp, eps=1e-8)


def test_hybrid_fingerprint_mismatch_restarts(tmp_path, small_groups):
    """A checkpoint from different data must be ignored, not resumed."""
    T1 = random_walk(1500, seed=74)
    T2 = random_walk(1500, seed=75)
    cfg = MatrixProfileConfig(m=16, dtype="float64", band=64, chunk=64)
    path = str(tmp_path / "fp.npz")

    with pytest.raises(_Killed):
        compute_hybrid_with_checkpoint(
            T1, cfg, path, _ckpt_cls=_interrupting("A", 1)
        )
    # resume with DIFFERENT data: stale state ignored, fresh exact run
    MP, MPI = compute_hybrid_with_checkpoint(T2, cfg, path)
    MP_exp, MPI_exp = compute_matrix_profile_reference(T2, 16)
    assert_profile_close(T2, 16, MP, MPI, MP_exp, MPI_exp, eps=1e-8)


@pytest.mark.parametrize("stored", ["HIGH", None])
def test_checkpoint_from_other_precision_refused(tmp_path, small_groups,
                                                 stored):
    """A checkpoint swept at HIGH (TF32 on the GPU, outside the margin)
    — or one that predates the precision record, when HIGH was the
    default — is refused with a clear message, never resumed."""
    import mpx.checkpoint as C

    T = random_walk(1500, seed=76)
    cfg = MatrixProfileConfig(m=16, dtype="float64", band=64, chunk=64)
    path = str(tmp_path / "old.npz")
    with pytest.raises(_Killed):
        compute_hybrid_with_checkpoint(
            T, cfg, path, _ckpt_cls=_interrupting("A", 1)
        )
    data = dict(np.load(path, allow_pickle=False))
    assert str(data.pop("precision")) == "HIGHEST"
    if stored is not None:
        data["precision"] = stored
    C._save_npz(path, **data)
    with pytest.raises(ValueError, match="precision HIGH"):
        compute_hybrid_with_checkpoint(T, cfg, path)
