"""The validator's apiserver client: the few calls its components make
(counterpart of the parts of tpu_operator/client/rest.py they use).

``get``, ``create`` and ``delete`` of ``v1`` Nodes and Pods over HTTP(S),
with the pod's service-account token. Error statuses raise :class:`ApiError`
carrying the HTTP code; 404 raises :class:`NotFoundError` (``code`` 404).
Callers that must tolerate absence test ``code == 404``, so any client whose
errors carry the same ``code`` (the operator's own) serves them as well.
"""

from __future__ import annotations

import os
from typing import Optional

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

#: (apiVersion, kind) -> (plural, namespaced)
_RESOURCES = {("v1", "Node"): ("nodes", False), ("v1", "Pod"): ("pods", True)}


class ApiError(Exception):
    """Apiserver error with its HTTP status code."""

    code = 500

    def __init__(self, message: str, code: Optional[int] = None):
        super().__init__(message)
        if code is not None:
            self.code = code


class NotFoundError(ApiError):
    code = 404


def is_not_found(error: BaseException) -> bool:
    return getattr(error, "code", None) == 404


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
             name: Optional[str] = None) -> str:
        try:
            plural, namespaced = _RESOURCES[(api_version, kind)]
        except KeyError:
            raise ValueError(f"the validator's client serves v1 Nodes and Pods, "
                             f"not {api_version} {kind}") from None
        parts = [self.base_url, "api", api_version]
        if namespaced:
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
            raise ApiError(message, resp.status_code)
        return resp

    def get(self, api_version: str, kind: str, name: str, namespace=None) -> dict:
        return self._request("GET", self._url(api_version, kind, namespace, name)).json()

    def create(self, obj: dict) -> dict:
        namespace = obj.get("metadata", {}).get("namespace")
        return self._request("POST", self._url(obj["apiVersion"], obj["kind"], namespace),
                             json=obj).json()

    def delete(self, api_version: str, kind: str, name: str, namespace=None) -> None:
        self._request("DELETE", self._url(api_version, kind, namespace, name))
