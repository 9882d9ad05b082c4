"""The PyTorch port stands alone: no module of tpu_operator_torch (nor
chip_smoke.py) imports jax or anything of tpu_operator, nor
prometheus_client or yaml (the card's machine has neither), and importing
the package builds and loads no kernel."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest

import tpu_operator_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "tpu_operator_torch")
FORBIDDEN = ("jax", "jaxlib", "tpu_operator", "__graft_entry__", "triton",
             "prometheus_client", "yaml")


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
        "print(len(sys.modules), bad, sorted(_build._loaded))\n"
        "sys.exit(1 if bad or _build._loaded else 0)\n")
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
                     "validator.info", "validator.metrics"):
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

