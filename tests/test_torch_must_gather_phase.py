"""``chip_smoke.py`` phases 12 (its chart install) and 18 rehearsed on the
CPU.

Phase 12's install: the chart rendered with the phase's values, every
object applied to a ``MiniApiServer``, the operator's command line and env
taken from the rendered Deployment. Phase 18, the smoke's own
``must_gather_phase``, on such a cluster with one node as the card's phase
12 leaves it (``nvidia.com/gpu`` at the GPU count, the three barrier files,
two exporters serving ``/metrics``): a fresh operator from the Deployment,
``gpu-must-gather`` in a fresh process that must map neither torch nor
libcuda, the tarball's sections and ``DEBUG_ROUTES``, then ``gpuop-cfg
validate-csv`` and ``schema_gen --check`` in torch-free processes.
"""

import http.server
import json
import os
import threading
import types

from tpu_operator_torch import consts
from tpu_operator_torch.controllers.manager import DEBUG_ROUTES
from tpu_operator_torch.testing import helmlite
from tpu_operator_torch.testing.apiserver import MiniApiServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODE = "runsc"
GPUS = 1


def _exporter(text: bytes):
    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", str(len(text)))
            self.end_headers()
            self.wfile.write(text)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}/metrics"


def test_phase_12_installs_from_the_chart(tmp_path, monkeypatch):
    import chip_smoke

    monkeypatch.setenv("GPU_DEV_GLOBS", "/dev/nvidia0")
    status_dir = str(tmp_path / "status")
    values = chip_smoke.chart_values(str(tmp_path), status_dir)
    rendered = chip_smoke.install_from_chart(REPO, values, consts.DEFAULT_NAMESPACE)
    assert [o["kind"] for o in rendered] == [
        "CustomResourceDefinition", "CustomResourceDefinition", "Namespace", "ServiceAccount",
        "ClusterRole", "ClusterRoleBinding", "Deployment", "ClusterPolicy"]
    spec = next(o for o in rendered if o["kind"] == "ClusterPolicy")["spec"]
    # the overrides phase 12 set on the sample before, now chart values
    assert spec["hostPaths"] == {"validationStatusDir": status_dir,
                                 "partitionHandoffDir": str(tmp_path / "handoff"),
                                 "driverInstallDir": str(tmp_path / "driver-install"),
                                 "devGlobs": ["/dev/nvidia0"]}
    assert spec["validator"]["revalidateIntervalS"] == 0
    assert spec["health"]["enabled"] is False
    assert spec["featureDiscovery"]["sleepInterval"] == "5s"
    assert spec["telemetry"]["metricsPort"] == values["telemetry"]["metricsPort"]
    # the components the kubelet maps to the validator's CLI, as the sample's
    for key in ("driver", "devicePlugin", "featureDiscovery", "telemetry",
                "nodeStatusExporter", "validator"):
        assert spec[key]["enabled"] and spec[key]["image"] == "gpu-validator", key
    for key in ("slicePartitioner", "serving", "cdi"):
        assert spec[key]["enabled"] is False
    deployment = next(o for o in rendered if o["kind"] == "Deployment")
    argv, env = chip_smoke.deployment_process(REPO, deployment)
    assert argv[1:] == ["-m", "tpu_operator_torch.cmd.operator", "--log-level=info"]
    assert env[consts.NAMESPACE_ENV] == consts.DEFAULT_NAMESPACE
    assert env["VALIDATOR_IMAGE"] == "registry.example.com/gpu-operator/gpu-validator:0.1.0"
    srv = MiniApiServer()
    srv.start()
    try:
        helmlite.apply(srv.backend, rendered)
        assert srv.backend.get("v1", "Namespace", consts.DEFAULT_NAMESPACE)
        assert srv.backend.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")["spec"] == spec
    finally:
        srv.stop()


def test_phase_18_on_the_cpu(tmp_path, monkeypatch):
    import chip_smoke

    monkeypatch.setenv("GPU_DEV_GLOBS", "/dev/nvidia0")
    status_dir = tmp_path / "status"
    status_dir.mkdir()
    for name in ("driver", "plugin", "workload"):
        (status_dir / f"{name}-ready").write_text(json.dumps({"passed": True, "name": name}))
    rendered = chip_smoke.install_from_chart(
        REPO, chip_smoke.chart_values(str(tmp_path), str(status_dir)), consts.DEFAULT_NAMESPACE)
    srv = MiniApiServer()
    base = srv.start()
    exporters = [_exporter(b"# TYPE gpu_count gauge\ngpu_count 1.0\n"),
                 _exporter(b"# TYPE gpu_temperature gauge\ngpu_temperature 41.0\n")]
    try:
        helmlite.apply(srv.backend, rendered)
        srv.backend.create({"apiVersion": "v1", "kind": "Node", "metadata": {
            "name": NODE, "labels": {consts.NFD_NVIDIA_PCI_LABEL: "true"}},
            "status": {"capacity": {consts.GPU_RESOURCE_NAME: str(GPUS)}}})
        env = {k: v for k, v in os.environ.items()
               if k != "PYTHONPATH" and not k.startswith("GPU_")}
        ctx = types.SimpleNamespace(
            srv=srv, base=base, namespace=consts.DEFAULT_NAMESPACE, node_name=NODE,
            repo=REPO, work=str(tmp_path), card="cpu", operator_env=env,
            deployment=next(o for o in rendered if o["kind"] == "Deployment"),
            gpu_count=GPUS, status_dir=str(status_dir),
            exporter_urls=[url for _, url in exporters])
        numbers = chip_smoke.must_gather_phase(ctx)
    finally:
        for exporter, _ in exporters:
            exporter.shutdown()
        srv.stop()
    assert numbers["errors"] == [] and all(numbers["files"].values())
    assert numbers["debug_routes"] == sorted(DEBUG_ROUTES)
    assert numbers["node_summary"]["CAPACITY"] == str(GPUS)
    assert numbers["barriers"] == ["driver-ready", "plugin-ready", "workload-ready"]
    assert {name: r["rc"] for name, r in numbers["torch_free"].items()} == {
        "validate_csv": 0, "schema_gen_check": 0}
    assert numbers["phase_s"] < 60
    # the operator's Pod is gone with its process
    assert not [p for p in srv.backend.list("v1", "Pod", consts.DEFAULT_NAMESPACE)]
