"""The twin of tests/test_rest_client_urls.py: the port's ``RestClient``
(``tpu_operator_torch/client/rest.py``, on ``http.client``) builds the
reference's URLs, its selectors, evictions and all-namespaces lists, over
the wire to the port's ``MiniApiServer``. The port keeps the path
(``resource_path``) apart from the base URL, which its transport holds; the
reference's ``resource_url`` joins them. Every case compares the two over
the same grid of kinds, namespaces, names and subresources.
"""

import itertools

import pytest

from tpu_operator.client.rest import RestClient as RefRestClient
from tpu_operator_torch.client import NotFoundError, RestClient, TooManyRequestsError
from tpu_operator_torch.testing.apiserver import MiniApiServer

BASE = "https://apiserver:6443"


def client():
    return RestClient(base_url=BASE, token="t")


def url(c, *args):
    return BASE + c.resource_path(*args)


def test_core_namespaced_url():
    assert url(client(), "v1", "Pod", "ns1", "p1") == f"{BASE}/api/v1/namespaces/ns1/pods/p1"


def test_core_cluster_scoped_url():
    assert url(client(), "v1", "Node", None, "n1") == f"{BASE}/api/v1/nodes/n1"


def test_group_url_and_status_subresource():
    assert url(client(), "apps/v1", "DaemonSet", "tpu-operator", "gpu-driver", "status") == \
        f"{BASE}/apis/apps/v1/namespaces/tpu-operator/daemonsets/gpu-driver/status"


def test_crd_urls():
    assert url(client(), "tpu.ai/v1", "ClusterPolicy", None, "cluster-policy") == \
        f"{BASE}/apis/tpu.ai/v1/clusterpolicies/cluster-policy"
    assert url(client(), "tpu.ai/v1alpha1", "GPUDriver", None, "main") == \
        f"{BASE}/apis/tpu.ai/v1alpha1/gpudrivers/main"


def test_selector_param():
    assert RestClient._selector_param({"a": "1", "b": None}) == "a=1,b"


def test_eviction_url():
    assert url(client(), "v1", "Pod", "ns1", "p1", "eviction") == \
        f"{BASE}/api/v1/namespaces/ns1/pods/p1/eviction"


def test_eviction_over_the_wire():
    """POST pods/<name>/eviction: a budget blocks with a 429, raised as
    TooManyRequestsError; with headroom the pod is deleted."""
    srv = MiniApiServer()
    c = RestClient(base_url=srv.start())
    try:
        c.create({"apiVersion": "v1", "kind": "Pod",
                  "metadata": {"name": "w", "namespace": "ns1", "labels": {"app": "train"}},
                  "spec": {}, "status": {"phase": "Running"}})
        c.create({"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
                  "metadata": {"name": "pdb", "namespace": "ns1"},
                  "spec": {"selector": {"matchLabels": {"app": "train"}}, "minAvailable": 1}})
        with pytest.raises(TooManyRequestsError):
            c.evict("w", "ns1")
        c.create({"apiVersion": "v1", "kind": "Pod",
                  "metadata": {"name": "w2", "namespace": "ns1", "labels": {"app": "train"}},
                  "spec": {}, "status": {"phase": "Running"}})
        c.evict("w", "ns1")
        with pytest.raises(NotFoundError):
            c.get("v1", "Pod", "w", "ns1")
    finally:
        c.stop()
        srv.stop()


def test_all_namespaces_list_url():
    c = RestClient(base_url=BASE)
    assert url(c, "v1", "Pod") == f"{BASE}/api/v1/pods"
    # a named operation still defaults the namespace
    assert url(c, "v1", "Pod", None, "p1") == f"{BASE}/api/v1/namespaces/default/pods/p1"


def test_all_namespaces_list_over_the_wire():
    srv = MiniApiServer()
    c = RestClient(base_url=srv.start())
    try:
        for ns in ("default", "ml-team"):
            c.create({"apiVersion": "v1", "kind": "Pod",
                      "metadata": {"name": f"p-{ns}", "namespace": ns},
                      "spec": {"nodeName": "n0"}})
        assert {p["metadata"]["name"] for p in c.list("v1", "Pod")} == {"p-default", "p-ml-team"}
        assert len(c.list("v1", "Pod", "ml-team")) == 1
    finally:
        c.stop()
        srv.stop()


KINDS = [("v1", "Pod"), ("v1", "Node"), ("v1", "Service"), ("v1", "Event"),
         ("apps/v1", "DaemonSet"), ("rbac.authorization.k8s.io/v1", "ClusterRole"),
         ("coordination.k8s.io/v1", "Lease"), ("policy/v1", "PodDisruptionBudget"),
         ("tpu.ai/v1", "ClusterPolicy")]


def test_both_packages_build_the_same_urls():
    port, ref = client(), RefRestClient(base_url=BASE, token="t")
    for (api, kind), ns, name, sub in itertools.product(
            KINDS, (None, "ns1"), (None, "x"), (None, "status")):
        if sub and not name:
            continue
        assert url(port, api, kind, ns, name, sub) == ref.resource_url(api, kind, ns, name, sub)
    for selector in ({"a": "1"}, {"a": "1", "b": None}, {"k": None}, {}):
        assert RestClient._selector_param(selector) == (
            RefRestClient._selector_param(selector) if selector else None)
