"""``gpuop-cfg`` against the reference's ``tpuop-cfg``, on the cases of
tests/test_cfgtool.py: ``validate``, ``sample`` and ``status`` give the
same exit codes and, after the one mapping
(tests/test_torch_operator_mapping.py), the same output.

``validate-partitions`` takes a link class and a GPU count where the
reference takes a TPU generation and a chip count (the port has no chip
grid; ROADMAP Queue 3): its cases are the reference's tables, with the
same verdicts.
"""

import copy
import json
import os
import subprocess
import sys

import pytest
import yaml

from test_torch_operator_mapping import (
    map_driver,
    map_labels,
    map_partition_args,
    map_sample,
    map_spec,
    map_status_text,
)
from tpu_operator import consts as ref_consts
from tpu_operator.cfgtool.main import run as ref_run
from tpu_operator.client.rest import RestClient as RefRest
from tpu_operator.testing import MiniApiServer as RefServer
from tpu_operator_torch import consts, yamlsubset
from tpu_operator_torch.api.clusterpolicy import ClusterPolicy
from tpu_operator_torch.api.gpudriver import GPUDriver
from tpu_operator_torch.cfgtool.main import run
from tpu_operator_torch.client.rest import RestClient
from tpu_operator_torch.testing.apiserver import MiniApiServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_SAMPLES = os.path.join(REPO, "config", "samples")
PORT_SAMPLES = os.path.join(REPO, "tpu_operator_torch", "manifests", "samples")


def _port_doc(doc):
    if doc.get("kind") == "TPUDriver":
        return map_driver(doc)
    out = copy.deepcopy(doc)
    if "spec" in out:
        out["spec"] = map_spec(out["spec"])
    return out


def _twin_files(tmp_path, name, docs):
    """The reference's YAML file and the port's (its documents mapped)."""
    ref = tmp_path / f"ref-{name}.yaml"
    ref.write_text(yaml.safe_dump_all(docs))
    port = tmp_path / f"port-{name}.yaml"
    port.write_text("---\n".join(yamlsubset.dump(_port_doc(d)) + "\n" for d in docs))
    return str(ref), str(port)


def _both(capsys, ref_argv, port_argv):
    want = ref_run(ref_argv)
    want_out = capsys.readouterr().out
    got = run(port_argv)
    got_out = capsys.readouterr().out
    assert got == want
    return got, want_out, got_out


def _lines(out, path):
    return [line.replace(path, "<file>") for line in out.splitlines()]


def test_samples_validate(tmp_path, capsys):
    """The reference's samples, mapped, validate as they do there; the
    port's own samples validate."""
    for fname in sorted(os.listdir(REF_SAMPLES)):
        with open(os.path.join(REF_SAMPLES, fname)) as f:
            docs = [d for d in yaml.safe_load_all(f) if d]
        ref, port = _twin_files(tmp_path, fname, docs)
        rc, want, got = _both(capsys, ["validate", ref], ["validate", port])
        assert rc == 0 and "OK" in got
        assert _lines(got, port) == [map_status_text(line) for line in _lines(want, ref)]
    files = [os.path.join(PORT_SAMPLES, f) for f in sorted(os.listdir(PORT_SAMPLES))]
    assert run(["validate"] + files) == 0
    assert capsys.readouterr().out.count(": OK") == 2


@pytest.mark.parametrize("spec,needle", [
    ({"operator": {"defaultRuntime": "rkt"}}, "defaultRuntime"),
    ({"driver": {"env": "oops"}}, "expected array"),
    ({"driver": {"libtpuVerion": "2025.1.0"}}, "unknown field"),
], ids=["bad spec", "type-mangled", "typo'd field"])
def test_validate_catches_what_the_reference_catches(tmp_path, capsys, spec, needle):
    doc = {"apiVersion": "tpu.ai/v1", "kind": "ClusterPolicy",
           "metadata": {"name": "x"}, "spec": spec}
    ref, port = _twin_files(tmp_path, "bad", [doc])
    rc, want, got = _both(capsys, ["validate", ref], ["validate", port])
    assert rc == 1 and needle in got
    assert _lines(got, port) == _lines(want, ref)


def test_validate_unsupported_kind(tmp_path, capsys):
    doc = {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": "p"}}
    ref, port = _twin_files(tmp_path, "pod", [doc])
    rc, want, got = _both(capsys, ["validate", ref], ["validate", port])
    assert rc == 1
    assert _lines(got, port) == [line.replace("TPUDriver", "GPUDriver")
                                 for line in _lines(want, ref)]


def test_validate_reads_json_and_refuses_text_outside_the_subset(tmp_path, capsys):
    good = tmp_path / "cp.json"
    good.write_text(json.dumps({"apiVersion": "tpu.ai/v1", "kind": "ClusterPolicy",
                                "metadata": {"name": "x"}, "spec": {}}))
    assert run(["validate", str(good)]) == 0
    bad = tmp_path / "bad.yaml"
    bad.write_text("apiVersion: tpu.ai/v1\nkind: ClusterPolicy\nspec: &a {x: 1}\n")
    assert run(["validate", str(bad)]) == 1
    assert "unreadable" in capsys.readouterr().out


@pytest.mark.parametrize("kind,port_kind", [("clusterpolicy", "clusterpolicy"),
                                            ("tpudriver", "gpudriver")])
def test_sample_output_round_trips(capsys, kind, port_kind):
    assert ref_run(["sample", kind]) == 0
    want = yaml.safe_load(capsys.readouterr().out)
    assert run(["sample", port_kind]) == 0
    text = capsys.readouterr().out
    doc = yamlsubset.parse(text)
    assert doc == yaml.safe_load(text) == map_sample(want)
    typed = ClusterPolicy if port_kind == "clusterpolicy" else GPUDriver
    assert typed.from_obj(doc).spec.validate() == []


# -- status ------------------------------------------------------------------------------

def _serve(m_server, m_rest, objects, run_fn, argv_rounds, edits=()):
    """Create ``objects`` on a server, run ``argv_rounds`` of the CLI, with
    each edit applied between rounds; returns (rc, out) per round."""
    srv = m_server()
    base = srv.start()
    try:
        client = m_rest(base_url=base)
        for obj in objects:
            client.create(obj)
        out = []
        for i, argv in enumerate(argv_rounds):
            if i:
                edits[i - 1](client)
            out.append(run_fn(argv + ["--base-url", base]))
        return out
    finally:
        srv.stop()


def _status_twin(capsys, ref_objects, port_objects, ref_edits=(), port_edits=(), rounds=1,
                 normalize=lambda text: text):
    results = []
    for m_server, m_rest, run_fn, objects, edits in (
            (RefServer, RefRest, ref_run, ref_objects, ref_edits),
            (MiniApiServer, RestClient, run, port_objects, port_edits)):
        def run_capture(argv, run_fn=run_fn):
            rc = run_fn(argv)
            return rc, capsys.readouterr().out
        results.append(_serve(m_server, m_rest, objects, run_capture,
                              [["status"]] * rounds, edits))
    want, got = results
    assert [rc for rc, _ in got] == [rc for rc, _ in want]
    assert [normalize(out) for _, out in got] == [normalize(map_status_text(out))
                                                 for _, out in want]
    return got


def _ref_node(name, labels, annotations=None, capacity="4"):
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": labels,
                         **({"annotations": annotations} if annotations else {})},
            "status": {"capacity": {ref_consts.TPU_RESOURCE_NAME: capacity}}}


def _port_node(node):
    out = copy.deepcopy(node)
    out["metadata"]["labels"] = map_labels(node["metadata"]["labels"])
    out["status"] = {"capacity": {consts.GPU_RESOURCE_NAME: node["status"]["capacity"][
        ref_consts.TPU_RESOURCE_NAME]}}
    return out


def test_status_against_live_harness(capsys):
    from tpu_operator.api.clusterpolicy import new_cluster_policy

    policy = new_cluster_policy()
    policy["status"] = {"state": "notReady", "conditions": [
        {"type": "Ready", "status": "False", "reason": "OperandNotReady",
         "message": "state-device-plugin not ready"}]}
    node = _ref_node("node-0", {
        ref_consts.TPU_PRESENT_LABEL: "true", ref_consts.UPGRADE_STATE_LABEL: "upgrade-done",
        ref_consts.TPU_SLICE_CONFIG_LABEL: "split-2x2", ref_consts.TPU_SLICE_STATE_LABEL: "failed",
        ref_consts.SERVING_SLO_LABEL: "passed"},
        {ref_consts.SERVING_SLO_ANNOTATION: "p99_ms=3.2,tokens_per_s=1234.5,attainment=1.0"})
    ds = {"apiVersion": "apps/v1", "kind": "DaemonSet",
          "metadata": {"name": "driver-ds", "namespace": "tpu-operator"},
          "spec": {"template": {"metadata": {}, "spec": {}}},
          "status": {"desiredNumberScheduled": 1, "numberAvailable": 1,
                     "updatedNumberScheduled": 1}}

    def allocatable(resource):
        def edit(client):
            live = client.get("v1", "Node", "node-0")
            live["status"]["allocatable"] = {resource: "3"}
            client.update_status(live)
        return edit

    def ready(client):
        cp = client.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")
        cp["status"]["state"] = "ready"
        client.update_status(cp)

    port_policy = copy.deepcopy(policy)
    got = _status_twin(capsys, [policy, node, ds], [port_policy, _port_node(node), ds],
                       [allocatable(ref_consts.TPU_RESOURCE_NAME), ready],
                       [allocatable(consts.GPU_RESOURCE_NAME), ready], rounds=3)
    (rc1, out1), (rc2, out2), (rc3, _) = got
    assert (rc1, rc2, rc3) == (1, 1, 0)
    assert "ClusterPolicy/cluster-policy: notReady" in out1 and "OperandNotReady" in out1
    assert "upgrade-done" in out1 and "split-2x2=failed" in out1
    assert "passed p99=3.2ms" in out1 and "driver-ds" in out1 and "HEALTHY" in out1
    assert "3!" in out2


def test_status_lists_gpudrivers_and_their_pools(capsys):
    from tpu_operator.api.clusterpolicy import new_cluster_policy
    from tpu_operator.api.tpudriver import new_tpu_driver

    policy = new_cluster_policy()
    policy["status"] = {"state": "ready"}
    driver = new_tpu_driver("default")
    driver["status"] = {"state": "ready", "pools": {"v5-lite-podslice-2x4": 1}}
    node = _ref_node("node-0", {ref_consts.TPU_PRESENT_LABEL: "true",
                                ref_consts.GKE_TPU_ACCELERATOR_LABEL: "tpu-v5-lite-podslice"})
    port_driver = map_driver(driver)
    got = _status_twin(capsys, [policy, driver, node],
                       [copy.deepcopy(policy), port_driver, _port_node(node)])
    assert got[0][0] == 0
    assert "GPUDriver/default: ready pools={'nvidia-h100-80gb': 1}" in got[0][1]


def test_status_autoscale_column(capsys):
    import time

    from tpu_operator.api.clusterpolicy import new_cluster_policy

    policy = new_cluster_policy(spec={"autoscale": {
        "enabled": True, "minNodes": {"default": 1}, "maxNodes": {"default": 8}}})
    nodes = [_ref_node(f"node-{i}", {ref_consts.TPU_PRESENT_LABEL: "true",
                                     ref_consts.GKE_TPU_ACCELERATOR_LABEL: "tpu-v5-lite-podslice",
                                     ref_consts.GKE_TPU_TOPOLOGY_LABEL: "2x2"})
             for i in range(2)]
    cooldown = time.time() + 3600.0

    def state(pool):
        def edit(client):
            cp = client.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")
            cp["metadata"].setdefault("annotations", {})[
                consts.AUTOSCALE_STATE_ANNOTATION] = json.dumps({pool: {
                    "target": 5, "seq": 3, "cooldown_until": cooldown,
                    "resize": {"node": "node-1", "direction": "down",
                               "fingerprint": "abc", "deadline": 0.0}}})
            client.update(cp)
        return edit

    def disable(client):
        cp = client.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")
        cp["spec"]["autoscale"]["enabled"] = False
        client.update(cp)

    # the cooldown left is computed at each run's own clock: compared to
    # within the seconds between the two runs
    import re

    got = _status_twin(capsys, [policy] + nodes,
                       [copy.deepcopy(policy)] + [_port_node(n) for n in nodes],
                       [state("v5-lite-podslice-2x2"), disable],
                       [state("nvidia-h100-80gb"), disable], rounds=3,
                       normalize=lambda text: re.sub(r"cd=\d+s", "cd=<s>", text))
    assert "2/5[1-8] resizing:down cd=" in got[1][1]
    left = [int(x) for x in re.findall(r"cd=(\d+)s", got[1][1])]
    assert left and all(3590 <= x <= 3600 for x in left)
    assert "2/5[1-8]" not in got[2][1]
    for line in got[2][1].splitlines():
        if line.startswith("node-"):
            assert line.rstrip().endswith("-")


def test_status_upgrade_state_column_shows_what_the_machine_writes(capsys):
    """Each package's upgrade machine sweeps its own cluster between the
    runs: the UPGRADE-STATE column reads ``-``, ``upgrade-required``, then
    ``pod-restart-required``, as the reference's does."""
    from test_torch_operator_mapping import map_object
    from tpu_operator.api.clusterpolicy import new_cluster_policy
    from tpu_operator.api.common import UpgradePolicySpec as RefPolicySpec
    from tpu_operator.upgrade import machine as ref_machine
    from tpu_operator_torch.api.common import UpgradePolicySpec
    from tpu_operator_torch.upgrade import machine

    policy = new_cluster_policy()
    policy["status"] = {"state": "ready"}
    node = _ref_node("node-0", {ref_consts.TPU_PRESENT_LABEL: "true",
                                ref_consts.deploy_label("driver"): "true"})
    ds = {"apiVersion": "apps/v1", "kind": "DaemonSet",
          "metadata": {"name": "driver", "namespace": "tpu-operator"},
          "spec": {"template": {
              "metadata": {"labels": {"app.kubernetes.io/component": "tpu-driver"}},
              "spec": {"nodeSelector": {ref_consts.deploy_label("driver"): "true"},
                       "containers": [{"name": "i", "image": "img:2"}]}}},
          "status": {"desiredNumberScheduled": 1, "numberAvailable": 1,
                     "updatedNumberScheduled": 1}}
    pod = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": "drv-0", "namespace": "tpu-operator",
                        "labels": {"app.kubernetes.io/component": "tpu-driver"}},
           "spec": {"nodeName": "node-0", "containers": [{"name": "i", "image": "img:1"}]},
           "status": {"phase": "Running"}}

    def sweep(m, policy_cls):
        def edit(client):
            m.UpgradeStateMachine(client, "tpu-operator", policy_cls.from_dict(
                {"autoUpgrade": True})).process(client.list("v1", "Node"))
        return edit

    got = _status_twin(capsys, [policy, node, ds, pod],
                       [copy.deepcopy(policy), _port_node(node), map_object(ds),
                        map_object(pod)],
                       [sweep(ref_machine, RefPolicySpec)] * 2,
                       [sweep(machine, UpgradePolicySpec)] * 2, rounds=3)
    columns = [next(line for line in out.splitlines() if line.startswith("node-0")).split()
               for _, out in got]
    assert [c[4] for c in columns] == ["-", "upgrade-required", "pod-restart-required"]


def test_status_unreachable_cluster_fails_cleanly(capsys):
    assert ref_run(["status", "--base-url", "http://127.0.0.1:1"]) == 2
    want = capsys.readouterr().err
    assert run(["status", "--base-url", "http://127.0.0.1:1"]) == 2
    err = capsys.readouterr().err
    assert "cannot reach the cluster" in err and "cannot reach the cluster" in want
    assert "Traceback" not in err


def test_status_and_validate_import_no_torch(tmp_path):
    """``gpuop-cfg`` in a fresh process: status against a server with a GPU
    node (its CAPACITY column reads the serving frontier schema, whose
    package holds the torch probe), validate on the samples; neither
    imports torch (nor the reference, nor yaml)."""
    script = (
        "import sys\n"
        "from tpu_operator_torch.testing.apiserver import MiniApiServer\n"
        "from tpu_operator_torch.cmd.cfg import main\n"
        "srv = MiniApiServer(); base = srv.start()\n"
        "srv.backend.create({'apiVersion': 'v1', 'kind': 'Node', 'metadata': {'name': 'n1',\n"
        "    'labels': {'tpu.ai/gpu.present': 'true'}}})\n"
        "rc = main(['status', '--base-url', base])\n"
        f"rc2 = main(['validate', {PORT_SAMPLES!r} + '/v1_clusterpolicy.json'])\n"
        "srv.stop()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'tpu_operator', 'yaml', 'prometheus_client'))\n"
        "print(rc, rc2, bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr[-2000:]
    assert result.stdout.strip().splitlines()[-1] == "1 0 []"


# -- validate-partitions -------------------------------------------------------------------

def test_validate_partitions_offline(tmp_path, capsys):
    """The reference's tables, on an 8-GPU NVLink node where the reference
    checks a v5e 2x4 grid: the same verdicts, the port's groups."""
    table = tmp_path / "partitions.yaml"
    table.write_text("partitions:\n  split-2x2:\n    - chips: 4\n    - chips: 4\n"
                     "  broken:\n    - chips: 8\n      topology: 1x8\n")
    argv = ["validate-partitions", str(table)]
    assert ref_run(argv) == 1
    want = capsys.readouterr().out
    assert run(map_partition_args(argv)) == 1
    out = capsys.readouterr().out
    assert "'split-2x2' on tpu-v5-lite-podslice/8 chips: OK" in want
    assert "'split-2x2' on 8 GPUs (nvlink): OK: nvlink[0, 1, 2, 3], nvlink[4, 5, 6, 7]" in out
    assert "'broken' on 8 GPUs (nvlink): INVALID" in out and "INVALID" in want

    good = tmp_path / "good.yaml"
    good.write_text("partitions:\n  singles:\n    - chips: 1\n      count: all\n")
    argv = ["validate-partitions", str(good), "--accelerator", "tpu-v4-podslice", "--chips", "4"]
    assert ref_run(argv) == 0
    capsys.readouterr()
    assert map_partition_args(argv)[-4:] == ["--link", "pcie-switch", "--gpus", "4"]
    assert run(map_partition_args(argv)) == 0
    assert "single[0], single[1], single[2], single[3]" in capsys.readouterr().out


def test_validate_partitions_refuses_an_unknown_link_class(tmp_path, capsys):
    table = tmp_path / "t.yaml"
    table.write_text("partitions:\n  one:\n    - chips: 1\n")
    assert run(["validate-partitions", str(table), "--link", "ici"]) == 1
    assert "not one of" in capsys.readouterr().out


def test_the_console_script_is_declared():
    text = open(os.path.join(REPO, "pyproject.toml")).read()
    assert 'gpuop-cfg = "tpu_operator_torch.cmd.cfg:main"' in text
    assert '"api/crds/*.yaml"' in text


# -- explain ------------------------------------------------------------------------------

def _journal(journal_cls, **kwargs):
    j = journal_cls(now=lambda: 100.0, **kwargs)
    j.record_decision(
        "health", "drain-plan", "ep-disk", {"type": "verdict", "plan": "7c1e"},
        inputs={"deadline_s": 5}, decision={"node": "node-a", "plan": "7c1e"},
        alternatives=[{"option": "force-immediate", "rejected": "drain window"}],
        actuations=[{"verb": "plan", "kind": "Node", "name": "node-a"}], node="node-a")
    j.record_decision(
        "health", "health-recover", "ep-disk", {"type": "verdict", "value": "passed"},
        decision={"node": "node-a"}, outcome="recovered", node="node-a")
    return j


def test_explain_renders_the_chain_from_a_disk_journal(tmp_path, capsys):
    from tpu_operator.provenance import DecisionJournal as RefJournal
    from tpu_operator_torch.provenance import DecisionJournal

    paths = {"ref": str(tmp_path / "ref.jsonl"), "port": str(tmp_path / "port.jsonl")}
    _journal(RefJournal, path=paths["ref"])
    _journal(DecisionJournal, path=paths["port"])
    assert ref_run(["explain", "node", "node-a", "--journal-path", paths["ref"]]) == 0
    want = capsys.readouterr().out
    assert run(["explain", "node", "node-a", "--journal-path", paths["port"]]) == 0
    got = capsys.readouterr().out
    assert got == want and "episode ep-disk  drain-plan  node=node-a  CLOSED" in got
    for runner, path in ((ref_run, paths["ref"]), (run, paths["port"])):
        assert runner(["explain", "node", "ghost", "--journal-path", path]) == 1
        assert "no decision records" in capsys.readouterr().out


def test_explain_reads_the_mirror_configmaps(capsys):
    from tpu_operator_torch.provenance import DecisionJournal

    srv = MiniApiServer()
    base = srv.start()
    try:
        _journal(DecisionJournal, client=RestClient(base), namespace="tpu-operator")
        assert run(["explain", "episode", "ep-disk", "--base-url", base]) == 0
        got = capsys.readouterr().out
        # the reference's tpuop-cfg reads the same ConfigMaps the same way
        assert ref_run(["explain", "episode", "ep-disk", "--base-url", base]) == 0
        assert got == capsys.readouterr().out
        assert "health/drain-plan" in got and "outcome: recovered" in got
    finally:
        srv.stop()
    assert run(["explain", "node", "node-a", "--base-url", "http://127.0.0.1:1"]) == 2
    assert "cannot reach the cluster" in capsys.readouterr().err
