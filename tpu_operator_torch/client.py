"""The validator's apiserver client: the few calls its components make
(counterpart of the parts of tpu_operator/client/rest.py they use), and
:func:`preconditioned_patch` (tpu_operator/client/preconditions.py).

``get``, ``list`` (with a field selector), ``create``, ``patch`` (JSON
merge patch) and ``delete`` of ``v1`` Nodes, Pods and Events over
HTTP(S), with the pod's service-account token. Error
statuses raise :class:`ApiError` carrying the HTTP code; 404 raises
:class:`NotFoundError` and 409 :class:`ConflictError`. Callers test
``code`` (:func:`is_not_found`, :func:`is_conflict`), so any client whose
errors carry the same ``code`` (the operator's own) serves them as well.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Optional

log = logging.getLogger(__name__)

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

#: (apiVersion, kind) -> (plural, namespaced)
_RESOURCES = {("v1", "Node"): ("nodes", False), ("v1", "Pod"): ("pods", True),
              ("v1", "Event"): ("events", True)}


class ApiError(Exception):
    """Apiserver error with its HTTP status code."""

    code = 500

    def __init__(self, message: str, code: Optional[int] = None):
        super().__init__(message)
        if code is not None:
            self.code = code


class NotFoundError(ApiError):
    code = 404


class ConflictError(ApiError):
    code = 409


def is_not_found(error: BaseException) -> bool:
    return getattr(error, "code", None) == 404


def is_conflict(error: BaseException) -> bool:
    return getattr(error, "code", None) == 409


class ApiClient:
    """Reads ``$KUBE_API_URL`` when set (:meth:`from_env`), else the
    in-cluster service address and token."""

    def __init__(self, base_url: str, token: Optional[str] = None, verify=True,
                 timeout: float = 10.0):
        import requests

        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self._session = requests.Session()
        self._session.verify = verify
        if token:
            self._session.headers["Authorization"] = f"Bearer {token}"

    @classmethod
    def from_env(cls) -> "ApiClient":
        url = os.environ.get("KUBE_API_URL")
        if url:
            return cls(url)
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        if not host:
            raise RuntimeError("no apiserver: set KUBE_API_URL or run in-cluster")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        with open(os.path.join(SA_DIR, "token")) as f:
            token = f.read().strip()
        ca = os.path.join(SA_DIR, "ca.crt")
        return cls(f"https://{host}:{port}", token, ca if os.path.exists(ca) else True)

    def _url(self, api_version: str, kind: str, namespace: Optional[str] = None,
             name: Optional[str] = None, all_namespaces: bool = False) -> str:
        try:
            plural, namespaced = _RESOURCES[(api_version, kind)]
        except KeyError:
            raise ValueError(f"the validator's client serves v1 Nodes and Pods (and "
                             f"Events), not {api_version} {kind}") from None
        parts = [self.base_url, "api", api_version]
        if namespaced and not (all_namespaces and namespace is None):
            parts += ["namespaces", namespace or "default"]
        parts.append(plural)
        if name:
            parts.append(name)
        return "/".join(parts)

    def _request(self, method: str, url: str, **kwargs):
        resp = self._session.request(method, url, timeout=self.timeout, **kwargs)
        if resp.status_code >= 400:
            try:
                message = resp.json().get("message", resp.text)
            except ValueError:
                message = resp.text
            if resp.status_code == 404:
                raise NotFoundError(message)
            if resp.status_code == 409:
                raise ConflictError(message)
            raise ApiError(message, resp.status_code)
        return resp

    def get(self, api_version: str, kind: str, name: str, namespace=None) -> dict:
        return self._request("GET", self._url(api_version, kind, namespace, name)).json()

    def list(self, api_version: str, kind: str, namespace=None,
             field_selector: Optional[dict] = None) -> list:
        """The objects of a kind, in ``namespace`` (every namespace when
        None), those whose fields equal ``field_selector``'s."""
        params = {}
        if field_selector:
            params["fieldSelector"] = ",".join(f"{k}={v}" for k, v in field_selector.items())
        url = self._url(api_version, kind, namespace, all_namespaces=True)
        return self._request("GET", url, params=params).json().get("items", [])

    def create(self, obj: dict) -> dict:
        namespace = obj.get("metadata", {}).get("namespace")
        return self._request("POST", self._url(obj["apiVersion"], obj["kind"], namespace),
                             json=obj).json()

    def patch(self, api_version: str, kind: str, name: str, patch: dict,
              namespace=None) -> dict:
        """JSON merge patch; a ``metadata.resourceVersion`` in it makes the
        apiserver refuse the write with 409 if the object changed since."""
        return self._request(
            "PATCH", self._url(api_version, kind, namespace, name), json=patch,
            headers={"Content-Type": "application/merge-patch+json"}).json()

    def delete(self, api_version: str, kind: str, name: str, namespace=None) -> None:
        self._request("DELETE", self._url(api_version, kind, namespace, name))


#: re-read-and-reapply budget: conflicts mean a live competing writer, and
#: an unbounded loop against one would spin forever
DEFAULT_ATTEMPTS = 6


def preconditioned_patch(client, api_version: str, kind: str, name: str,
                         build: Callable[[dict], Optional[dict]],
                         namespace: Optional[str] = None,
                         attempts: int = DEFAULT_ATTEMPTS,
                         sleep: Callable[[float], None] = time.sleep) -> dict:
    """Read ``name``, let ``build(fresh_obj)`` compute a JSON merge patch
    from it (None: nothing to do), and apply it preconditioned on the
    resourceVersion read. On 409, re-read and rebuild: ``build`` sees the
    competing writer's state, so the lost write is re-derived, never
    replayed, and must be a pure function of the object it is handed.

    Returns the patched object (the fresh read when ``build`` declined). A
    404 propagates: the object's lifecycle is the caller's policy."""
    last_exc: Optional[BaseException] = None
    for attempt in range(attempts):
        if attempt:
            # a cache-backed read lags the competing write by one event
            sleep(min(0.25, 0.02 * (2 ** attempt)))
        obj = client.get(api_version, kind, name, namespace)
        patch = build(obj)
        if patch is None:
            return obj
        rv = obj.get("metadata", {}).get("resourceVersion")
        if rv is not None:
            patch.setdefault("metadata", {})["resourceVersion"] = rv
        try:
            return client.patch(api_version, kind, name, patch, namespace)
        except Exception as e:
            if not is_conflict(e):
                raise
            last_exc = e
            log.debug("preconditioned patch of %s/%s conflicted at rv %s "
                      "(attempt %d/%d); re-reading", kind, name, rv, attempt + 1,
                      attempts)
    raise last_exc if last_exc is not None else ConflictError(
        f"preconditioned patch of {kind}/{name} never applied")
