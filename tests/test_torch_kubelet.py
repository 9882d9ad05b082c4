"""The process kubelet (tpu_operator_torch/testing/kubelet.py) as the
rolling upgrade needs it: a DaemonSet pod's Pod object carries the
kubelet's status (phase, ``Ready``, container statuses with restart counts
and ``CrashLoopBackOff`` during a back-off); ``updateStrategy: OnDelete``
leaves a running pod on its old template until the Pod object is deleted,
where ``RollingUpdate`` reruns it; and a deleted or evicted pod's process
is killed before the delete returns.
"""

import os
import sys
import time

import pytest

from tpu_operator_torch.client.fake import FakeClient
from tpu_operator_torch.testing import kubelet as k
from tpu_operator_torch.upgrade.machine import crash_looping

NS = "tpu-operator"
NODE = "gpu-node"


def wait(predicate, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def python(code):
    return {"command": [sys.executable, "-c", code]}


def daemonset(init_code="pass", strategy=None, env_value="1"):
    ds = {"apiVersion": "apps/v1", "kind": "DaemonSet",
          "metadata": {"name": "drv", "namespace": NS, "labels": {"app": "drv"}},
          "spec": {"template": {
              "metadata": {"labels": {"app": "drv", "app.kubernetes.io/component": "gpu-driver",
                                      "tpu.ai/template-hash": f"h{env_value}"}},
              "spec": {"initContainers": [dict(python(init_code), name="install")],
                       "containers": [dict(python("import time; time.sleep(120)"), name="main",
                                           env=[{"name": "V", "value": env_value}])]}}}}
    if strategy:
        ds["spec"]["updateStrategy"] = {"type": strategy}
    return ds


@pytest.fixture
def cluster(tmp_path, monkeypatch):
    monkeypatch.setattr(k, "READY_AFTER_S", 0.3)
    client = FakeClient()
    client.create({"apiVersion": "v1", "kind": "Node", "metadata": {"name": NODE}})
    kubelet = k.ProcessKubelet(client, NODE, NS, str(tmp_path / "logs"),
                               {"PATH": os.environ.get("PATH", "")}, {},
                               modes={"drv": k.RUN})
    kubelet.backoff = lambda failures: 0.4
    yield client, kubelet.start(), tmp_path
    kubelet.stop()


def pod(client):
    try:
        return client.get("v1", "Pod", f"drv-{NODE}", NS)
    except Exception:
        return None


def ready(p):
    return p is not None and any(c["type"] == "Ready" and c["status"] == "True"
                                 for c in p["status"].get("conditions") or [])


def test_a_daemonset_pod_reports_ready_and_its_containers(cluster):
    client, kubelet, _ = cluster
    client.create(daemonset())
    p = wait(lambda: ready(pod(client)) and pod(client), "the pod Ready")
    status = p["status"]
    assert status["phase"] == "Running"
    assert [(s["name"], s["restartCount"], s["state"]) for s in status["initContainerStatuses"]] \
        == [("install", 0, {"terminated": {"exitCode": 0, "reason": "Completed"}})]
    assert [(s["name"], s["ready"], list(s["state"])) for s in status["containerStatuses"]] \
        == [("main", True, ["running"])]
    assert p["metadata"]["labels"]["tpu.ai/template-hash"] == "h1"
    ds = wait(lambda: (client.get("apps/v1", "DaemonSet", "drv", NS).get("status") or {})
              .get("numberAvailable") == 1 and client.get("apps/v1", "DaemonSet", "drv", NS),
              "the DaemonSet available")
    assert ds["status"]["updatedNumberScheduled"] == 1
    assert not crash_looping(p)


def test_a_crash_loop_shows_in_the_container_statuses(cluster):
    client, kubelet, tmp_path = cluster
    marker = tmp_path / "fixed"
    client.create(daemonset(f"import os, sys; sys.exit(0 if os.path.exists({str(marker)!r}) "
                            f"else 3)"))
    p = wait(lambda: (lambda q: q if q and q["status"].get("initContainerStatuses") and
                      q["status"]["initContainerStatuses"][0]["restartCount"] >= 2 and
                      "waiting" in q["status"]["initContainerStatuses"][0]["state"]
                      else None)(pod(client)), "two restarts")
    init = p["status"]["initContainerStatuses"][0]
    assert init["state"]["waiting"]["reason"] == "CrashLoopBackOff"
    assert p["status"]["phase"] == "Pending" and not ready(p)
    assert crash_looping(p)
    marker.touch()
    p = wait(lambda: ready(pod(client)) and pod(client), "Ready once the fault is gone")
    init = p["status"]["initContainerStatuses"][0]
    assert init["restartCount"] >= 2 and "terminated" in init["state"]
    assert kubelet.matching("init-exit", rc=3)


@pytest.mark.parametrize("strategy", ["OnDelete", "RollingUpdate"])
def test_a_template_change_waits_for_the_pod_s_deletion_under_on_delete(cluster, strategy):
    client, kubelet, _ = cluster
    client.create(daemonset(strategy=strategy))
    first = wait(lambda: ready(pod(client)) and pod(client), "the first pod Ready")
    ds = client.get("apps/v1", "DaemonSet", "drv", NS)
    ds["spec"]["template"] = daemonset(env_value="2")["spec"]["template"]
    client.update(ds)
    if strategy == "RollingUpdate":
        p = wait(lambda: ready(pod(client)) and pod(client)["metadata"]["labels"][
            "tpu.ai/template-hash"] == "h2" and pod(client), "the pod rerun on the new template")
        assert p["metadata"]["uid"] != first["metadata"]["uid"]
        return
    # the DaemonSet reports the pod outdated, and the pod runs on
    status = wait(lambda: (lambda s: s if s.get("observedGeneration") == 2 else None)(
        client.get("apps/v1", "DaemonSet", "drv", NS).get("status") or {}), "status seen")
    assert status["updatedNumberScheduled"] == 0 and status["numberAvailable"] == 1
    time.sleep(0.5)
    assert pod(client)["metadata"]["uid"] == first["metadata"]["uid"]
    assert len(kubelet.matching("pod-start", ds="drv")) == 1
    client.delete("v1", "Pod", f"drv-{NODE}", NS)
    p = wait(lambda: ready(pod(client)) and pod(client), "the pod rerun after its deletion")
    assert p["metadata"]["labels"]["tpu.ai/template-hash"] == "h2"
    assert p["metadata"]["uid"] != first["metadata"]["uid"]
    assert kubelet.first("pod-deleted", ds="drv")
    wait(lambda: (client.get("apps/v1", "DaemonSet", "drv", NS).get("status") or {})
         .get("updatedNumberScheduled") == 1, "updated again")


@pytest.mark.parametrize("how", ["delete", "evict"])
def test_a_deleted_pod_s_process_is_killed_before_the_delete_returns(cluster, how):
    client, kubelet, _ = cluster
    client.create({"apiVersion": "v1", "kind": "Pod",
                   "metadata": {"name": "consumer", "namespace": "default"},
                   "spec": {"nodeName": NODE, "containers": [
                       dict(python("import time; time.sleep(120)"), name="c")]},
                   "status": {"phase": "Pending"}})
    wait(lambda: kubelet.first("pod-running", pod="consumer"), "the consumer running")
    live = client.get("v1", "Pod", "consumer", "default")
    procs = wait(lambda: kubelet._spawned.get(live["metadata"]["uid"]), "its process")
    assert procs[0].proc.poll() is None
    if how == "delete":
        client.delete("v1", "Pod", "consumer", "default")
    else:
        client.evict("consumer", "default")
    assert procs[0].proc.poll() is not None  # gone before the call returned
    assert kubelet.first("pod-killed", pod="consumer")
    time.sleep(0.3)
    assert not kubelet.matching("pod-exit", pod="consumer", phase="Succeeded")
