"""GPU health sweep of the PyTorch port (tpu_operator_torch/validator/workload.py)
held against the JAX sweep (tpu_operator/validator/workload.py) on the CPU:
gloo ranks stand in for GPUs, JAX's virtual CPU devices for TPU chips.

The twin of tests/test_multihost.py. A multi-node sweep runs one process per
node, each with every GPU of its node as one rank of one world (the
reference's process per host with all of its chips): the 2 processes x 2
local ranks case runs beside the reference's 2 x 2 in tier-1, and the
reference's slow shapes (2 x 4, 4 x 2, a worker killed before it joins and
then a clean retry, the 4 x 4 north star, the 16-rank dry run) are its slow
twins here, with the reference's counts and a rendezvous through a
``file://`` store under ``tmp_path``; every join waits at most 120 s.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from tpu_operator.validator import feature_discovery
from tpu_operator.validator import status as ref_status
from tpu_operator.validator import workload as ref_workload
from tpu_operator_torch import graft_entry
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


def _multihost_worker(rank, n, coordinator, status_root, init_timeout, local_ranks=None,
                      script=None):
    """One node's ``workload-multihost`` process (``script``: a file that
    runs the CLI, in place of the module)."""
    entry = [script] if script else ["-m", "tpu_operator_torch.cmd.validator"]
    argv = [sys.executable, *entry,
            "-c", "workload-multihost", f"--coordinator={coordinator}",
            f"--num-processes={n}", f"--process-id={rank}", "--matrix-dim=64",
            f"--init-timeout={init_timeout}", "--device=cpu",
            f"--status-dir={status_root}/v{rank}"]
    if local_ranks is not None:
        argv.append(f"--local-ranks={local_ranks}")
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _reference_worker(pid, n, port, chips, status_root):
    """One host of the reference's sweep: ``chips`` virtual CPU devices,
    ``jax.distributed`` through the TCP coordinator at ``port``."""
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.path.expanduser("~"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={chips}",
           "PYTHONPATH": REPO}
    argv = [sys.executable, "-m", "tpu_operator.cmd.validator", "-c", "workload-multihost",
            f"--coordinator=127.0.0.1:{port}", f"--num-processes={n}",
            f"--process-id={pid}", "--matrix-dim=64", f"--status-dir={status_root}/v{pid}"]
    return subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _reports(procs, expect_rc=0):
    """Each process's last JSON line, once every one has exited with
    ``expect_rc`` (any code when None)."""
    out = []
    for rank, p in enumerate(procs):
        stdout, stderr = p.communicate(timeout=JOIN_TIMEOUT_S)
        assert expect_rc is None or p.returncode == expect_rc, \
            f"process {rank}:\n{stderr[-2000:]}"
        out.append(_last_json(stdout))
    return out


def _run_nodes(tmp_path, n, local_ranks, init_timeout=60):
    """``n`` nodes' processes of ``local_ranks`` each through one
    ``file://`` store, all passing; their reports."""
    coordinator = "file://" + str(tmp_path / "store")
    procs = [_multihost_worker(r, n, coordinator, tmp_path, init_timeout, local_ranks)
             for r in range(n)]
    return _reports(procs)


def _check_full_nodes(tmp_path, reports, local_ranks):
    """Every node swept all of its GPUs, as contiguous global ordinals, and
    wrote a barrier that both packages read as a full sweep."""
    n_devices = len(reports) * local_ranks
    for rank, report in enumerate(reports):
        assert report["passed"] and report["n_devices"] == n_devices, report
        for check in workload.CHECK_NAMES:
            assert report["details"][check]["passed"], report["details"]
        assert report["local_chips"] == list(range(local_ranks * rank,
                                                   local_ranks * (rank + 1)))
        assert report["failed_local_chips"] == []
        status = ref_status.StatusFiles(str(tmp_path / f"v{rank}"))
        assert status.is_ready("workload")
        info = status.read("workload")
        assert ref_status.partial_sweep(info, local_ranks) is False
        assert port_status.partial_sweep(info, local_ranks) is False


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


def test_two_nodes_of_two_gpus_match_the_reference_s_two_hosts_of_two_chips(tmp_path):
    """2 processes x 2 local ranks beside the reference's 2 processes x 2
    chips: the same verdicts, 4 devices, ``local_chips`` [0, 1] and [2, 3],
    barriers written and read as full sweeps on both sides."""
    port = _free_port()
    ref_procs = [_reference_worker(pid, 2, port, 2, tmp_path / "ref") for pid in range(2)]
    coordinator = "file://" + str(tmp_path / "port" / "store")
    (tmp_path / "port").mkdir()
    port_procs = [_multihost_worker(r, 2, coordinator, tmp_path / "port", 60, local_ranks=2)
                  for r in range(2)]
    ref_reports, port_reports = _reports(ref_procs), _reports(port_procs)
    for side, reports in (("ref", ref_reports), ("port", port_reports)):
        _check_full_nodes(tmp_path / side, reports, 2)
    for ref, got in zip(ref_reports, port_reports):
        for field in ("passed", "n_devices", "details", "local_chips", "failed_local_chips"):
            assert got[field] == ref[field], field


#: a node-side wrapper of the validator's CLI whose sweep corrupts one
#: global rank's GEMM operand. Spawned ranks re-import their parent's main
#: file, so the patch reaches every rank of the node.
CORRUPT_SCRIPT = textwrap.dedent("""\
    import os
    import sys

    import torch

    from tpu_operator_torch.validator import workload

    BAD = int(os.environ["CORRUPT_GLOBAL_RANK"])
    _operands = workload.gemm_operands


    def corrupted(matrix_dim, device):
        a, b = _operands(matrix_dim, device)
        if torch.distributed.get_rank() == BAD:
            a = a.clone()
            a[3, 5] = 3.0  # exact in bf16
        return a, b


    workload.gemm_operands = corrupted

    if __name__ == "__main__":
        from tpu_operator_torch.validator import main
        sys.exit(main.main(sys.argv[1:]))
""")


def test_a_corrupted_gpu_on_the_second_node_is_attributed_to_it(tmp_path, monkeypatch):
    """2 nodes x 2 GPUs, node 1's second GPU (global ordinal 3) corrupted:
    the compute check names ordinal 3 on both nodes, node 1's barrier reads
    as its local GPU 1 failing through both packages' readers, node 0's as
    no GPU of its own failing."""
    script = tmp_path / "corrupt_sweep.py"
    script.write_text(CORRUPT_SCRIPT)
    monkeypatch.setenv("CORRUPT_GLOBAL_RANK", "3")
    coordinator = "file://" + str(tmp_path / "store")
    procs = [_multihost_worker(r, 2, coordinator, tmp_path, 60, local_ranks=2,
                               script=str(script)) for r in range(2)]
    reports = _reports(procs, expect_rc=None)
    assert [r["n_devices"] for r in reports] == [4, 4]
    assert [r["local_chips"] for r in reports] == [[0, 1], [2, 3]]
    assert [p.returncode for p in procs] == [1, 1]
    for report in reports:
        assert not report["passed"]
        assert report["details"]["compute"] == {"passed": False, "failed_chips": [3]}
        for name in ("psum", "ring", "all_gather"):
            assert report["details"][name]["passed"], name
    assert [r["failed_local_chips"] for r in reports] == [[], [1]]
    for rank, failed in ((0, frozenset()), (1, frozenset({1}))):
        info = ref_status.StatusFiles(str(tmp_path / f"v{rank}")).read("workload")
        assert ref_status.failed_local_chips(info, 2) == failed
        assert port_status.failed_local_chips(info, 2) == failed


def test_nodes_with_different_gpu_counts_number_their_gpus_node_by_node(tmp_path):
    """The local counts are traded through the store and their prefix sums
    number the ranks, as JAX numbers a multi-process run's devices: a node
    of 1 GPU and a node of 3 make one sweep of 4, ordinals [0] and [1, 2, 3]."""
    coordinator = "file://" + str(tmp_path / "store")
    procs = [_multihost_worker(r, 2, coordinator, tmp_path, 60, local_ranks=count)
             for r, count in enumerate((1, 3))]
    reports = _reports(procs)
    assert [r["n_devices"] for r in reports] == [4, 4]
    assert [r["local_chips"] for r in reports] == [[0], [1, 2, 3]]
    assert all(r["passed"] and r["failed_local_chips"] == [] for r in reports)


def test_a_multinode_sweep_on_cuda_takes_every_visible_gpu(monkeypatch):
    """On the card the local count is the visible GPUs: any other count is
    refused, so no node writes a subset sweep as its own."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    cuda = torch.device("cuda", 0)
    assert workload.local_rank_count(cuda) == 8
    assert workload.local_rank_count(cuda, 8) == 8
    with pytest.raises(ValueError, match="every GPU"):
        workload.local_rank_count(cuda, 1)
    assert workload.local_rank_count(torch.device("cpu")) == 1
    assert workload.local_rank_count(torch.device("cpu"), 4) == 4


@pytest.mark.slow
def test_two_nodes_of_four_gpus(tmp_path):
    """Twin of ``test_two_process_multihost_validation``: 2 x 4, 8 devices."""
    _check_full_nodes(tmp_path, _run_nodes(tmp_path, 2, 4), 4)


@pytest.mark.slow
def test_four_nodes_of_two_gpus(tmp_path):
    """Twin of ``test_four_process_multihost_validation``: 4 x 2, all 8
    devices validated by every node, every sub-check passed."""
    _check_full_nodes(tmp_path, _run_nodes(tmp_path, 4, 2), 2)


@pytest.mark.slow
def test_a_worker_killed_before_joining_fails_closed_then_a_retry_is_clean(tmp_path):
    """Twin of ``test_worker_killed_fails_closed_then_retries_clean``: node
    3 of 4 is killed at once; the other three fail closed within the 30 s
    rendezvous budget (non-zero exit, no barrier), then a fresh 4 x 2
    attempt on a fresh store passes."""
    coordinator = "file://" + str(tmp_path / "store")
    procs = [_multihost_worker(r, 4, coordinator, tmp_path, 30, local_ranks=2)
             for r in range(4)]
    procs[3].send_signal(signal.SIGKILL)
    procs[3].communicate(timeout=30)
    for rank, p in enumerate(procs[:3]):
        out, _ = p.communicate(timeout=JOIN_TIMEOUT_S)
        assert p.returncode != 0, f"node {rank} must fail closed:\n{out}"
        assert not (tmp_path / f"v{rank}" / "workload-ready").exists()
    retry = tmp_path / "retry"
    retry.mkdir()
    _check_full_nodes(retry, _run_nodes(retry, 4, 2), 2)


@pytest.mark.slow
def test_four_nodes_of_four_gpus_the_north_star_shape(tmp_path):
    """Twin of ``test_four_process_four_chip_rendezvous_north_star_shape``:
    4 x 4, 16 devices, node ``i``'s GPUs global ordinals ``4i .. 4i+3``."""
    reports = _run_nodes(tmp_path, 4, 4)
    _check_full_nodes(tmp_path, reports, 4)
    assert [r["local_chips"] for r in reports] == [list(range(4 * i, 4 * i + 4))
                                                   for i in range(4)]


@pytest.mark.slow
def test_dryrun_multichip_over_sixteen_ranks():
    """Twin of ``test_dryrun_multichip_16_device_v5e16_mesh``: the mesh step
    over 16 gloo ranks at the 4 x 4 mesh."""
    assert graft_entry._mesh_factors(16) == (4, 4)
    graft_entry.dryrun_multichip(16, device="cpu")


def test_init_method_for():
    assert workload.init_method_for("10.0.0.1:29500") == "tcp://10.0.0.1:29500"
    assert workload.init_method_for("file:///x/store") == "file:///x/store"


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs the sweep")
    with pytest.raises(RuntimeError, match="CUDA"):
        workload.ici_health_check(matrix_dim=64)
