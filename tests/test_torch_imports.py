"""The PyTorch port stands alone: no module of tpu_operator_torch (nor
chip_smoke.py) imports jax or anything of tpu_operator, nor
prometheus_client, yaml or requests (the port writes the text format,
reads its YAML itself and speaks HTTP through the standard library), and
importing the package builds and loads no kernel and loads no jinja2 (the
manifest renderer imports it when it renders). grpc and google.protobuf
are imported only by the device plugin's wire layer: the package, the
plugin's plan layer included, imports without them. The operator's
process, like the node daemons and the fleet simulator, imports no
torch."""

import ast
import glob
import os
import pkgutil
import re
import subprocess
import sys

import pytest

import tpu_operator_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "tpu_operator_torch")
FORBIDDEN = ("jax", "jaxlib", "tpu_operator", "__graft_entry__", "triton",
             "prometheus_client", "yaml", "requests")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(tpu_operator_torch.__path__,
                                                        "tpu_operator_torch."))


def _python_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PACKAGE):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_every_module_imports_without_jax_or_reference():
    """Run in a fresh interpreter: this test process already holds jax
    (conftest imports it)."""
    script = (
        "import importlib, sys\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "from tpu_operator_torch.kernels import _build\n"
        "jinja = 'jinja2' in sys.modules\n"
        "print(len(sys.modules), bad, sorted(_build._loaded), jinja)\n"
        "sys.exit(1 if bad or _build._loaded or jinja else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stdout + result.stderr


def test_port_module_list_is_complete():
    names = set(_port_modules())
    for expected in ("consts", "utils", "device", "ranks", "graft_entry",
                     "validator.status", "validator.driver", "validator.plugin",
                     "validator.workload", "validator.perf", "validator.main",
                     "kernels._build", "kernels.stream_copy", "cmd.validator",
                     "client", "serving", "serving.frontier", "serving.probe",
                     "validator.serving", "tracing", "joinprofile", "joinprofile.records",
                     "health", "health.drain", "validator.feature_discovery",
                     "validator.info", "validator.metrics", "nvml", "cuda_driver",
                     "partitioner", "partitioner.partitioner", "deviceplugin",
                     "deviceplugin.plugin", "deviceplugin.grpc_api",
                     "deviceplugin.proto", "deviceplugin.proto.deviceplugin_pb2",
                     "validator.cdi", "validator.telemetry", "testing",
                     "testing.fake_nvml", "partitioner.topology", "validator.native",
                     "events", "migrate", "migrate.agent", "migrate.checkpoint",
                     "yamlsubset", "client.errors", "client.interface", "client.scheme",
                     "client.fake", "client.batch", "client.preconditions", "client.rest",
                     "api", "api.specbase", "api.common", "api.k8s_schemas",
                     "api.clusterpolicy", "conditions", "render", "nodeinfo",
                     "nodeinfo.node_info", "nodeinfo.labeler", "state", "state.skel",
                     "state.manager", "state.nodepool", "state.driver", "state.multihost",
                     "state.operands", "controllers", "controllers.runtime",
                     "controllers.predicates", "controllers.metrics",
                     "controllers.clusterpolicy_controller", "controllers.manager",
                     "cmd.operator", "testing.apiserver", "testing.kubelet",
                     "api.gpudriver", "api.schema_gen", "api.schema_validate",
                     "controllers.gpudriver_controller", "controllers.leader",
                     "client.resilience", "client.fenced", "client.cache",
                     "cfgtool", "cfgtool.main", "cmd.cfg",
                     "health.machine", "provenance", "provenance.journal",
                     "provenance.audit", "provenance.explain", "joinprofile.critical_path",
                     "joinprofile.collector", "upgrade", "upgrade.machine",
                     "controllers.upgrade_controller", "client.chaos", "testing.chaos",
                     "testing.trainjob", "autoscale", "autoscale.predictor",
                     "autoscale.engine", "autoscale.controller", "capacity",
                     "capacity.collector", "migrate.controller", "utils.objects",
                     "utils.hash", "utils.clock", "utils.seeds", "serving.traffic",
                     "simulator", "simulator.clock", "simulator.seeds", "simulator.scenario",
                     "simulator.engine", "simulator.fuzz", "simulator.minimize",
                     "simulator.artifacts", "cmd.sim", "clusterinfo", "testing.helmlite",
                     "testing.cluster", "cmd.must_gather", "utils.locks", "sanitizer",
                     "sanitizer.core", "sanitizer.hooks", "sanitizer.locks",
                     "sanitizer.perturb", "sanitizer.registry", "sanitizer.crosscheck",
                     "cmd.opsan"):
        assert f"tpu_operator_torch.{expected}" in names


@pytest.mark.parametrize("path", _python_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [alias.name.split(".")[0] for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        for root in roots:
            assert root not in FORBIDDEN, f"{path}:{node.lineno} imports {root}"


def _lane_files():
    """The port's files outside the package: its shell e2e, envtest and
    kind lanes, images, make file, workflow, real-hardware lane and runbook."""
    globs = ("tests/scripts/torch/*.sh", "tests/cases/torch/*.sh", "tests/*-gpu.sh",
             "tests/gpu-ci.yaml", "tests/torch_envtest_driver.py", "docker/gpu-*.Dockerfile",
             "multi-arch-gpu.mk", ".github/workflows/ci-gpu.yaml", "docs/gpu/*.md")
    return sorted({p for g in globs for p in glob.glob(os.path.join(REPO, g))})


def test_the_lane_file_list_is_complete():
    names = {os.path.relpath(p, REPO) for p in _lane_files()}
    assert len(names) == 26
    assert {"tests/e2e-envtest-gpu.sh", "tests/e2e-kind-gpu.sh", "tests/ci-run-e2e-gpu.sh",
            "docker/gpu-validator.Dockerfile", "tests/cases/torch/gpudriver.sh",
            "docs/gpu/quickstart.md", "docs/gpu/static-analysis.md"} <= names


@pytest.mark.parametrize("path", _lane_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_lane_file_names_the_reference(path):
    """The port's lanes run the port only: no script, case, image, make file
    or workflow names the reference's package or its ``tpuop-`` tools."""
    with open(path) as f:
        text = f.read()
    hit = re.search(r"\btpu_operator[./]|tpuop-", text)
    assert hit is None, f"{os.path.relpath(path, REPO)} names {hit[0]!r}"



#: the only modules that may import grpc or google.protobuf at module level;
#: plugin.py only inside functions (its wire layer), and chip_smoke.py only
#: inside the function that talks to that layer as a kubelet does
WIRE_MODULES = {os.path.join(PACKAGE, "deviceplugin", "grpc_api.py"),
                os.path.join(PACKAGE, "deviceplugin", "proto", "deviceplugin_pb2.py")}
WIRE_ROOTS = ("grpc", "google")


@pytest.mark.parametrize("path", _python_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_grpc_and_protobuf_only_in_the_wire_layer(path):
    tree = ast.parse(open(path).read(), filename=path)
    in_function = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            in_function.update(id(n) for n in ast.walk(node))
    callers = (os.path.join(PACKAGE, "deviceplugin", "plugin.py"),
               os.path.join(REPO, "chip_smoke.py"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [alias.name.split(".")[0] for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            module = node.module or ""
            roots = [module.split(".")[0]] if node.level == 0 else [
                "grpc" if module in ("grpc_api", "proto") or module.startswith("proto.")
                else ""]
        else:
            continue
        if not set(roots) & set(WIRE_ROOTS) or path in WIRE_MODULES:
            continue
        assert path in callers and id(node) in in_function, \
            f"{path}:{node.lineno} imports the wire layer's packages"


#: a finder that refuses grpc and google.protobuf, as on a machine without them
_BLOCK = (
    "import sys\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] == 'grpc' or name.startswith('google.protobuf'):\n"
    "            raise ImportError(f'No module named {name!r}')\n"
    "sys.meta_path.insert(0, Block())\n")


def test_the_package_imports_without_grpc_and_the_wire_layer_names_it(tmp_path):
    script = _BLOCK + (
        "import importlib\n"
        "for name in ('tpu_operator_torch.deviceplugin', 'tpu_operator_torch.deviceplugin.plugin',\n"
        "             'tpu_operator_torch.validator.cdi', 'tpu_operator_torch.validator.telemetry',\n"
        "             'tpu_operator_torch.validator.main'):\n"
        "    importlib.import_module(name)\n"
        "from tpu_operator_torch.testing import fake_nvml as f\n"
        "from tpu_operator_torch.deviceplugin.plugin import GPUDevicePlugin\n"
        "fake = f.FakeNvml(f.random_gpus(2, 0))\n"
        f"p = GPUDevicePlugin(plugin_dir={str(tmp_path)!r}, status_dir={str(tmp_path)!r}, "
        "nvml_lib=fake)\n"
        "p.refresh_units()\n"
        "assert p.allocation_plan(['gpu-1']).envs['CUDA_VISIBLE_DEVICES']\n"
        "try:\n"
        "    p.start()\n"
        "except ImportError as e:\n"
        "    print('ImportError:', e)\n"
        "f.install(fake)\n"
        "from tpu_operator_torch.validator.main import main\n"
        f"rc = main(['-c', 'device-plugin', '--status-dir={tmp_path}'])\n"
        "print('rc', rc, 'grpc' in sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr[-2000:]
    assert "ImportError: the device plugin's wire layer needs the grpc package" in result.stdout
    assert result.stdout.strip().splitlines()[-1] == "rc 1 False"
    assert "grpc" in result.stderr  # the CLI's error names it


#: the node daemons and the operator, which open no CUDA context and never
#: import torch
DAEMON_MODULES = ("tpu_operator_torch.cmd.operator", "tpu_operator_torch.controllers.manager",
                  "tpu_operator_torch.testing.apiserver", "tpu_operator_torch.testing.kubelet",
                  "tpu_operator_torch.partitioner.partitioner",
                  "tpu_operator_torch.partitioner.topology",
                  "tpu_operator_torch.validator.driver", "tpu_operator_torch.validator.native",
                  "tpu_operator_torch.validator.metrics", "tpu_operator_torch.migrate.agent",
                  "tpu_operator_torch.migrate.checkpoint", "tpu_operator_torch.events",
                  "tpu_operator_torch.validator.main",
                  "tpu_operator_torch.controllers.gpudriver_controller",
                  "tpu_operator_torch.controllers.leader", "tpu_operator_torch.client.resilience",
                  "tpu_operator_torch.client.fenced", "tpu_operator_torch.client.cache",
                  "tpu_operator_torch.api.schema_gen", "tpu_operator_torch.api.schema_validate",
                  "tpu_operator_torch.cfgtool.main", "tpu_operator_torch.cmd.cfg",
                  "tpu_operator_torch.health.machine", "tpu_operator_torch.provenance",
                  "tpu_operator_torch.joinprofile.collector",
                  "tpu_operator_torch.joinprofile.critical_path",
                  "tpu_operator_torch.upgrade.machine",
                  "tpu_operator_torch.controllers.upgrade_controller",
                  "tpu_operator_torch.client.chaos", "tpu_operator_torch.autoscale",
                  "tpu_operator_torch.autoscale.controller", "tpu_operator_torch.capacity",
                  "tpu_operator_torch.migrate.controller", "tpu_operator_torch.testing.chaos",
                  "tpu_operator_torch.testing.trainjob", "tpu_operator_torch.utils",
                  "tpu_operator_torch.serving.traffic", "tpu_operator_torch.simulator",
                  "tpu_operator_torch.simulator.fuzz", "tpu_operator_torch.simulator.minimize",
                  "tpu_operator_torch.simulator.artifacts", "tpu_operator_torch.cmd.sim",
                  "tpu_operator_torch.clusterinfo", "tpu_operator_torch.testing.helmlite",
                  "tpu_operator_torch.testing.cluster", "tpu_operator_torch.cmd.must_gather")


def test_the_node_daemons_import_no_torch(tmp_path):
    """The partitioner, the driver daemon and probe, the exporter and the
    migrate agent, imported and each run once through the CLI against fake
    NVML, in a fresh interpreter: no torch, no jax, nothing of the
    reference."""
    status = tmp_path / "st"
    script = (
        "import importlib, sys, time\n"
        f"for name in {DAEMON_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "from tpu_operator_torch.testing import fake_nvml as f\n"
        "f.install(f.FakeNvml(f.random_gpus(2, 0)))\n"
        "from tpu_operator_torch.validator import driver, main\n"
        f"assert main.main(['-c', 'driver-probe', '--install-dir={tmp_path}', "
        f"'--status-dir={status}']) == 1\n"
        "class Stop(Exception):\n"
        "    pass\n"
        "def stop(_):\n"
        "    raise Stop\n"
        "time.sleep = stop\n"
        "class Client:\n"
        "    def get(self, *a, **k):\n"
        "        return {'metadata': {'name': 'n1', 'labels': {}}}\n"
        "import os\n"
        "os.environ['NODE_NAME'] = 'n1'\n"
        "for argv in (['-c', 'slice-partitioner'], ['-c', 'migrate-agent'],\n"
        f"             ['-c', 'driver-daemon', '--install-dir={tmp_path}']):\n"
        "    try:\n"
        f"        main.run(argv + ['--status-dir={status}', '--handoff-dir={tmp_path}'], "
        "client=Client())\n"
        "    except Stop:\n"
        "        pass\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('torch',)!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "GPU_DRIVER_SRC")}
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stdout + result.stderr[-3000:]
    assert result.stdout.strip() == "[]"


def _module_file(name):
    path = os.path.join(REPO, *name.split("."))
    return path + ".py" if os.path.exists(path + ".py") else os.path.join(path, "__init__.py")


def _module_level_imports(name):
    """The modules ``name`` imports outside its functions, package-relative
    imports resolved to absolute names."""
    path = _module_file(name)
    package = name if path.endswith("__init__.py") else name.rpartition(".")[0]
    tree = ast.parse(open(path).read(), filename=path)
    in_function = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            in_function.update(id(n) for n in ast.walk(node) if n is not node)
    found = []
    for node in ast.walk(tree):
        if id(node) in in_function:
            continue
        if isinstance(node, ast.Import):
            found += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = package.split(".")
                base = ".".join(parts[:len(parts) - node.level + 1] + ([base] if base else []))
            found.append(base)
            found += [f"{base}.{alias.name}" for alias in node.names
                      if os.path.exists(_module_file(f"{base}.{alias.name}"))]
    return found


@pytest.mark.parametrize("daemon", DAEMON_MODULES)
def test_no_daemon_module_imports_torch_at_module_level(daemon):
    """The AST side of the rule: walking the package modules each daemon
    imports at module level, none imports torch at module level."""
    seen, todo = set(), [daemon]
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        for imported in _module_level_imports(name):
            assert imported.split(".")[0] != "torch", f"{name} imports {imported}"
            if imported.split(".")[0] == "tpu_operator_torch":
                todo.append(imported)
    if daemon.endswith("partitioner.partitioner"):  # the walk follows the package
        assert {"tpu_operator_torch.nvml", "tpu_operator_torch.health.drain"} <= seen


def test_jinja2_loads_with_the_first_render():
    script = (
        "import sys\n"
        "from tpu_operator_torch.state.operands import cluster_policy_states\n"
        "from tpu_operator_torch.controllers import manager\n"
        "before = 'jinja2' in sys.modules\n"
        "states = cluster_policy_states(client=None)\n"
        "print(before, 'jinja2' in sys.modules, 'torch' in sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr[-2000:]
    assert result.stdout.split() == ["False", "True", "False"]
