"""The process kubelet (tpu_operator_torch/testing/kubelet.py) as the
rolling upgrade needs it: a DaemonSet pod's Pod object carries the
kubelet's status (phase, ``Ready``, container statuses with restart counts
and ``CrashLoopBackOff`` during a back-off); ``updateStrategy: OnDelete``
leaves a running pod on its old template until the Pod object is deleted,
where ``RollingUpdate`` reruns it; a deleted or evicted pod's process
is killed before the delete returns; the node's GPUs go with the
device plugin's pod and come back with it; and a spawned Pod's
``nvidia.com/gpu`` limit is allocated in ``CUDA_VISIBLE_DEVICES`` as the
device plugin's Allocate would.
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


def test_the_plugin_s_gpus_go_with_its_pod_and_come_back_with_it(tmp_path, monkeypatch):
    """The device plugin's pod gives the node its GPUs; deleting its
    DaemonSet stops the pod and takes them back to 0, as a kubelet drops a
    plugin's devices once its endpoint goes; the DaemonSet back, they come
    back. (The reference's simulator, ``KubeletSimulator._register_tpus``,
    only ever adds them.)"""
    monkeypatch.setattr(k, "READY_AFTER_S", 0.3)
    client = FakeClient()
    client.create({"apiVersion": "v1", "kind": "Node", "metadata": {"name": NODE}})
    kubelet = k.ProcessKubelet(client, NODE, NS, str(tmp_path / "logs"),
                               {"PATH": os.environ.get("PATH", "")}, {},
                               modes={"plugin": k.INIT}, capacity_app="plugin", gpu_count=8)
    plugin = {"apiVersion": "apps/v1", "kind": "DaemonSet",
              "metadata": {"name": "plugin", "namespace": NS, "labels": {"app": "plugin"}},
              "spec": {"template": {
                  "metadata": {"labels": {"app": "plugin"}},
                  "spec": {"initContainers": [dict(python("pass"), name="wait")],
                           "containers": [dict(python("pass"), name="plugin")]}}}}

    def gpus():
        node = client.get("v1", "Node", NODE)
        return [(node.get("status") or {}).get(f, {}).get("nvidia.com/gpu")
                for f in ("capacity", "allocatable")]

    kubelet.start()
    try:
        client.create(plugin)
        wait(lambda: gpus() == ["8", "8"], "the plugin's GPUs")
        client.delete("apps/v1", "DaemonSet", "plugin", NS)
        wait(lambda: gpus() == ["0", "0"], "the GPUs taken back")
        assert kubelet.first("capacity-withdrawn", ds="plugin")
        client.create(plugin)
        wait(lambda: gpus() == ["8", "8"], "the GPUs back with the plugin")
    finally:
        kubelet.stop()


def test_a_pod_s_gpu_limit_is_allocated_as_the_device_plugin_would(tmp_path):
    """A spawned Pod's container with an ``nvidia.com/gpu`` limit sees that
    many of the node's GPU ids in ``CUDA_VISIBLE_DEVICES``, none another Pod
    holds; a container without a limit sees what the host shows; a Pod whose
    GPUs are held waits Pending until they are freed; one asking for more
    than the node has fails admission; a test's injected env wins."""
    client = FakeClient()
    client.create({"apiVersion": "v1", "kind": "Node", "metadata": {"name": NODE}})
    kubelet = k.ProcessKubelet(client, NODE, NS, str(tmp_path / "logs"),
                               {"PATH": os.environ.get("PATH", ""),
                                "CUDA_VISIBLE_DEVICES": "host"}, {},
                               gpu_count=2, gpu_ids=["GPU-a", "GPU-b"])
    show = ("import os, time; print(os.environ.get('CUDA_VISIBLE_DEVICES'), flush=True); "
            "time.sleep(float(os.environ.get('HOLD', '0')))")

    def consumer(name, gpus=None, hold="0"):
        ctr = dict(python(show), name="c", env=[{"name": "HOLD", "value": hold}])
        if gpus is not None:
            ctr["resources"] = {"limits": {"nvidia.com/gpu": str(gpus)}}
        client.create({"apiVersion": "v1", "kind": "Pod",
                       "metadata": {"name": name, "namespace": "default"},
                       "spec": {"nodeName": NODE, "containers": [ctr]},
                       "status": {"phase": "Pending"}})

    def seen(name):
        uid = client.get("v1", "Pod", name, "default")["metadata"]["uid"]
        wait(lambda: kubelet.first("pod-exit", pod=name), f"{name} done")
        return kubelet._spawned[uid][0].output().strip()

    kubelet.start()
    try:
        consumer("one", 1, hold="120")
        wait(lambda: kubelet.first("pod-running", pod="one"), "one running")
        consumer("two", 1)
        assert seen("two") == "GPU-b"
        assert kubelet.first("gpu-allocated", pod="one")["ids"] == ["GPU-a"]
        consumer("both", 2)
        wait(lambda: kubelet.first("pod-waiting-for-gpus", pod="both"), "both waiting")
        assert client.get("v1", "Pod", "both", "default")["status"]["phase"] == "Pending"
        client.delete("v1", "Pod", "one", "default")
        assert seen("both") == "GPU-a,GPU-b"
        assert seen(consumer("none") or "none") == "host"
        consumer("three", 3)
        wait(lambda: kubelet.first("pod-admission-failed", pod="three"), "three refused")
        assert client.get("v1", "Pod", "three", "default")["status"]["phase"] == "Failed"
        kubelet.pod_env = {"CUDA_VISIBLE_DEVICES": ""}
        assert seen(consumer("faulted", 1) or "faulted") == ""
        assert kubelet._allocated == {}
    finally:
        kubelet.stop()
