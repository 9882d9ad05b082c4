"""GPU health sweep of the PyTorch port (tpu_operator_torch/validator/workload.py)
held against the JAX sweep (tpu_operator/validator/workload.py) on the CPU:
gloo ranks stand in for GPUs, JAX's virtual CPU devices for TPU chips.

The twin of tests/test_multihost.py.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tpu_operator.validator import feature_discovery
from tpu_operator.validator import status as ref_status
from tpu_operator.validator import workload as ref_workload
from tpu_operator_torch.ranks import run_ranks
from tpu_operator_torch.validator import status as port_status
from tpu_operator_torch.validator import workload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: every spawn/join in this file waits at most this long
JOIN_TIMEOUT_S = 120


def _corrupt_rank(rank, n, device, t0, matrix_dim, bad_rank, a_bad):
    """One rank of a sweep in which ``bad_rank`` multiplies a corrupted
    operand (a worker target: module level, so spawned ranks import it)."""
    a = (torch.from_numpy(a_bad).to(device=device, dtype=torch.bfloat16)
         if rank == bad_rank else None)
    b = workload.gemm_operands(matrix_dim, device)[1] if rank == bad_rank else None
    return workload.sweep_rank(matrix_dim, device, a=a, b=b).cpu().numpy()


def test_four_rank_sweep_matches_jax_sweep():
    port = workload.ici_health_check(matrix_dim=64, device="cpu", world_size=4)
    ref = ref_workload.ici_health_check(matrix_dim=64, devices=jax.devices()[:4])
    for field in ("details", "passed", "n_devices", "local_chips",
                  "failed_local_chips", "platform"):
        assert getattr(port, field) == getattr(ref, field), field
    assert port.passed and port.n_devices == 4
    assert set(port.to_dict()) == set(ref.to_dict())
    assert port.compile_s > 0 and port.elapsed_s >= port.compile_s


def test_one_rank_sweep_runs_in_process():
    report = workload.ici_health_check(matrix_dim=64, device="cpu")
    assert report.passed and report.n_devices == 1
    assert report.local_chips == [0] and report.failed_local_chips == []
    assert not torch.distributed.is_initialized()


def test_corrupted_gemm_rank_is_attributed(tmp_path, monkeypatch):
    """A rank whose GEMM input is corrupted fails the compute check alone,
    and the barrier written from its report reads as that chip failing
    through the JAX package's own readers."""
    dim, bad = 64, 2
    rng = np.random.default_rng(20261016)
    a_bad = np.ones((dim, dim), dtype=np.float32)
    a_bad[rng.integers(dim), rng.integers(dim)] = 3.0  # exact in bf16
    flags = run_ranks(_corrupt_rank, 4, "cpu", args=(dim, bad, a_bad),
                      timeout_s=JOIN_TIMEOUT_S)
    # every rank holds the same all-reduced matrix
    for f in flags[1:]:
        np.testing.assert_array_equal(f, flags[0])
    report = workload.build_report(flags[0], [0, 1, 2, 3], "cpu", 0.1, 0.05)
    assert not report.passed
    assert report.details["compute"] == {"passed": False, "failed_chips": [bad]}
    for name in ("psum", "ring", "all_gather"):
        assert report.details[name]["passed"], name
    assert report.failed_local_chips == [bad]

    status_dir = tmp_path / "validations"
    port_status.StatusFiles(str(status_dir)).write("workload", report.to_dict())
    info = ref_status.StatusFiles(str(status_dir)).read("workload")
    assert ref_status.failed_local_chips(info, 4) == frozenset({bad})
    assert port_status.failed_local_chips(info, 4) == frozenset({bad})
    devdir = tmp_path / "dev"
    devdir.mkdir()
    for i in range(4):
        (devdir / f"accel{i}").touch()
    monkeypatch.setenv("TPU_DEV_GLOBS", str(devdir / "accel*"))
    monkeypatch.setenv("STATUS_DIR", str(status_dir))
    assert feature_discovery.workload_health_verdict() == f"failed:{bad}"


def _multihost_worker(rank, n, coordinator, status_root, init_timeout):
    argv = [sys.executable, "-m", "tpu_operator_torch.cmd.validator",
            "-c", "workload-multihost", f"--coordinator={coordinator}",
            f"--num-processes={n}", f"--process-id={rank}", "--matrix-dim=64",
            f"--init-timeout={init_timeout}", "--device=cpu",
            f"--status-dir={status_root}/v{rank}"]
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _last_json(stdout):
    return json.loads([line for line in stdout.splitlines() if line.startswith("{")][-1])


def test_multihost_four_ranks_write_attributable_barriers(tmp_path):
    coordinator = "file://" + str(tmp_path / "store")
    procs = [_multihost_worker(r, 4, coordinator, tmp_path, 60) for r in range(4)]
    for rank, p in enumerate(procs):
        out, err = p.communicate(timeout=JOIN_TIMEOUT_S)
        assert p.returncode == 0, err[-2000:]
        report = _last_json(out)
        assert report["passed"] and report["n_devices"] == 4
        assert report["local_chips"] == [rank] and report["failed_local_chips"] == []
        info = ref_status.StatusFiles(str(tmp_path / f"v{rank}")).read("workload")
        assert ref_status.StatusFiles(str(tmp_path / f"v{rank}")).is_ready("workload")
        assert ref_status.partial_sweep(info, 1) is False


def test_three_of_four_rendezvous_fails_closed(tmp_path):
    """A worker that never joins fails every other worker closed within the
    rendezvous budget: nonzero exit, no barrier written."""
    coordinator = "file://" + str(tmp_path / "store")
    procs = [_multihost_worker(r, 4, coordinator, tmp_path, 5) for r in range(3)]
    for rank, p in enumerate(procs):
        out, _ = p.communicate(timeout=JOIN_TIMEOUT_S)
        assert p.returncode == 1
        assert _last_json(out)["passed"] is False
        assert not (tmp_path / f"v{rank}" / "workload-ready").exists()


def test_init_method_for():
    assert workload.init_method_for("10.0.0.1:29500") == "tcp://10.0.0.1:29500"
    assert workload.init_method_for("file:///x/store") == "file:///x/store"


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs the sweep")
    with pytest.raises(RuntimeError, match="CUDA"):
        workload.ici_health_check(matrix_dim=64)
