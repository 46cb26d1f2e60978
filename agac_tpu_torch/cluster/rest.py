"""REST client for a real kube-apiserver.

The production counterpart of ``FakeCluster``: the same
``ClusterClient`` interface implemented over the Kubernetes HTTP API
with nothing but the standard library (urllib + ssl), covering the
operations the framework uses — typed CRUD, status subresource
updates, and streaming watches.  The analog of the reference's
client-go clientset + generated CRD clientset (SURVEY.md §2 rows 4,
17) and of ``clientcmd.BuildConfigFromFlags`` kubeconfig resolution
(``cmd/controller/controller.go:50,84-98``).

Transport is injectable for tests: ``transport(method, url, headers,
body, timeout, stream)`` returns ``(status, body_bytes)`` or, when
``stream=True``, ``(status, line_iterator)``.
"""

from __future__ import annotations

import base64
import json
import os
import socket
import ssl
import tempfile
import urllib.error
import urllib.parse
import threading
import time
import urllib.request
from typing import Any, Callable, Iterator, Optional

from .. import klog
from ..apis.endpointgroupbinding import EndpointGroupBinding
from ..errors import AlreadyExistsError, ConflictError, NotFoundError
from .client import ClusterClient, WatchEvent
from .objects import Event, Ingress, Lease, Service
from .serde import from_wire, to_wire

# client-go reflectors list in pages of 500 (WatchListPageSize default)
LIST_PAGE_SIZE = 500

# kind -> (api prefix, plural, type, apiVersion string)
KIND_REGISTRY: dict[str, tuple[str, str, type, str]] = {
    "Service": ("api/v1", "services", Service, "v1"),
    "Event": ("api/v1", "events", Event, "v1"),
    "Ingress": (
        "apis/networking.k8s.io/v1",
        "ingresses",
        Ingress,
        "networking.k8s.io/v1",
    ),
    "Lease": (
        "apis/coordination.k8s.io/v1",
        "leases",
        Lease,
        "coordination.k8s.io/v1",
    ),
    "EndpointGroupBinding": (
        "apis/operator.h3poteto.dev/v1alpha1",
        "endpointgroupbindings",
        EndpointGroupBinding,
        "operator.h3poteto.dev/v1alpha1",
    ),
}


class ClusterAPIError(Exception):
    def __init__(self, status: int, message: str):
        self.status = status
        super().__init__(f"apiserver returned {status}: {message}")


def _raise_for_status(status: int, body: bytes, context: str) -> None:
    message = ""
    try:
        message = json.loads(body).get("message", "")
    except Exception:
        message = body[:200].decode(errors="replace")
    if status == 404:
        raise NotFoundError("", context)
    if status == 409:
        if "already exists" in message:
            raise AlreadyExistsError(message)
        raise ConflictError(message)
    raise ClusterAPIError(status, message or context)


class RestClusterClient(ClusterClient):
    def __init__(
        self,
        base_url: str,
        token: Optional[str] = None,
        ssl_context: Optional[ssl.SSLContext] = None,
        transport: Optional[Callable] = None,
        token_provider: Optional[Callable[[], Optional[str]]] = None,
    ):
        self.base_url = base_url.rstrip("/")
        self._token = token
        # dynamic credentials (exec plugins, rotated token files)
        # re-resolved per request; wins over the static token
        self._token_provider = token_provider
        self._ssl_context = ssl_context
        self._transport = transport or self._default_transport

    # ------------------------------------------------------------------
    # transport
    # ------------------------------------------------------------------
    def _default_transport(self, method, url, headers, body, timeout, stream):
        request = urllib.request.Request(url, data=body, headers=headers, method=method)
        try:
            response = urllib.request.urlopen(
                request, timeout=timeout, context=self._ssl_context
            )
        except urllib.error.HTTPError as err:
            return err.code, err.read()
        if stream:
            # file-like: the watch loop reads lines itself so it can
            # poll stop() on idle-read timeouts
            return response.status, response
        with response:
            return response.status, response.read()

    def _request(
        self, method: str, path: str, body: Optional[dict] = None, timeout: float = 30.0, stream: bool = False
    ):
        url = f"{self.base_url}/{path}"
        headers = {"Accept": "application/json"}
        token = self._token_provider() if self._token_provider else self._token
        if token:
            headers["Authorization"] = f"Bearer {token}"
        data = None
        if body is not None:
            headers["Content-Type"] = "application/json"
            data = json.dumps(body).encode()
        return self._send_with_auth_retry(method, url, headers, data, timeout, stream)

    def _send_with_auth_retry(self, method, url, headers, data, timeout, stream):
        status, payload = self._transport(method, url, headers, data, timeout, stream)
        if status == 401 and self._token_provider is not None:
            # the server rejected the cached credential (early
            # revocation, clock skew): force a refresh and retry once,
            # like client-go's exec authenticator
            invalidate = getattr(self._token_provider, "invalidate", None)
            if invalidate is not None:
                invalidate()
                token = self._token_provider()
                if token:
                    headers["Authorization"] = f"Bearer {token}"
                else:
                    # refresh yielded nothing — never resend the header
                    # the server just rejected
                    headers.pop("Authorization", None)
                status, payload = self._transport(
                    method, url, headers, data, timeout, stream
                )
        return status, payload

    def raw_request(
        self,
        method: str,
        path: str,
        body: Optional[bytes] = None,
        content_type: str = "application/json",
        timeout: float = 30.0,
    ) -> tuple[int, bytes]:
        """Untyped request sharing this client's base URL, TLS and
        credentials — the escape hatch the dynamic client
        (``cluster/dynamic.py``) builds on for kinds outside
        ``KIND_REGISTRY``.  Returns ``(status, body)`` without raising.
        Shares ``request()``'s 401 invalidate-and-retry path so a
        rotated service-account token refreshes instead of surfacing
        as a hard error in long e2e runs."""
        url = f"{self.base_url}/{path.lstrip('/')}"
        headers = {"Accept": "application/json"}
        token = self._token_provider() if self._token_provider else self._token
        if token:
            headers["Authorization"] = f"Bearer {token}"
        if body is not None:
            headers["Content-Type"] = content_type
        return self._send_with_auth_retry(method, url, headers, body, timeout, False)

    # ------------------------------------------------------------------
    # paths and serde
    # ------------------------------------------------------------------
    @staticmethod
    def _kind_info(kind: str):
        info = KIND_REGISTRY.get(kind)
        if info is None:
            raise ValueError(f"unregistered kind: {kind}")
        return info

    def _collection_path(self, kind: str, namespace: Optional[str]) -> str:
        prefix, plural, _, _ = self._kind_info(kind)
        if namespace:
            return f"{prefix}/namespaces/{namespace}/{plural}"
        return f"{prefix}/{plural}"

    def _object_path(self, kind: str, namespace: str, name: str) -> str:
        return f"{self._collection_path(kind, namespace)}/{name}"

    def _encode(self, kind: str, obj: Any) -> dict:
        _, _, _, api_version = self._kind_info(kind)
        wire = to_wire(obj)
        wire["apiVersion"] = api_version
        wire["kind"] = kind
        return wire

    def _decode(self, kind: str, data: dict) -> Any:
        _, _, cls, _ = self._kind_info(kind)
        return from_wire(cls, data)

    # ------------------------------------------------------------------
    # ClusterClient
    # ------------------------------------------------------------------
    def get(self, kind: str, namespace: str, name: str) -> Any:
        path = self._object_path(kind, namespace, name)
        status, body = self._request("GET", path)
        if status >= 300:
            _raise_for_status(status, body, f"{kind} {namespace}/{name}")
        return self._decode(kind, json.loads(body))

    def list(self, kind: str, namespace: Optional[str] = None) -> tuple[list[Any], str]:
        """Chunked list, the way client-go reflectors do it: page
        through ``limit``/``continue`` so a large collection never
        arrives as one giant response."""
        base = self._collection_path(kind, namespace)
        items: list[Any] = []
        token = ""
        restarted = False
        while True:
            query = f"?limit={LIST_PAGE_SIZE}"
            if token:
                query += f"&continue={urllib.parse.quote(token)}"
            status, body = self._request("GET", base + query)
            if status == 410 and token and not restarted:
                # continue token expired (apiserver compaction):
                # restart the whole list once, like client-go's pager
                items, token, restarted = [], "", True
                continue
            if status >= 300:
                _raise_for_status(status, body, f"list {kind}")
            payload = json.loads(body)
            items.extend(self._decode(kind, item) for item in payload.get("items", []))
            metadata = payload.get("metadata") or {}
            token = metadata.get("continue") or ""
            if not token:
                return items, metadata.get("resourceVersion", "")

    def create(self, kind: str, obj: Any) -> Any:
        path = self._collection_path(kind, obj.metadata.namespace or None)
        status, body = self._request("POST", path, self._encode(kind, obj))
        if status >= 300:
            _raise_for_status(status, body, f"create {kind}")
        return self._decode(kind, json.loads(body))

    def update(self, kind: str, obj: Any) -> Any:
        path = self._object_path(kind, obj.metadata.namespace, obj.metadata.name)
        status, body = self._request("PUT", path, self._encode(kind, obj))
        if status >= 300:
            _raise_for_status(status, body, f"update {kind}")
        return self._decode(kind, json.loads(body))

    def update_status(self, kind: str, obj: Any) -> Any:
        path = self._object_path(kind, obj.metadata.namespace, obj.metadata.name) + "/status"
        status, body = self._request("PUT", path, self._encode(kind, obj))
        if status >= 300:
            _raise_for_status(status, body, f"update status {kind}")
        return self._decode(kind, json.loads(body))

    def delete(self, kind: str, namespace: str, name: str) -> None:
        path = self._object_path(kind, namespace, name)
        status, body = self._request("DELETE", path)
        if status >= 300:
            _raise_for_status(status, body, f"delete {kind} {namespace}/{name}")

    # watch stream tuning: the server closes the stream politely after
    # WATCH_SERVER_TIMEOUT (a clean relist boundary); the short socket
    # timeout is only a stop()-polling interval — an idle read timeout
    # resumes the same stream, so quiet clusters do NOT trigger
    # relist/resync storms.
    WATCH_SERVER_TIMEOUT = 240
    WATCH_POLL_INTERVAL = 5.0

    def watch(
        self, kind: str, resource_version: str, stop: Callable[[], bool]
    ) -> Iterator[WatchEvent]:
        """One watch stream.  A normally ended stream returns (the
        informer relists and re-watches); hard failures — connect
        errors, non-2xx — RAISE so the informer's error path applies
        its backoff instead of relisting in a tight loop."""
        query = urllib.parse.urlencode(
            {
                "watch": "true",
                "resourceVersion": resource_version or "0",
                "timeoutSeconds": str(self.WATCH_SERVER_TIMEOUT),
            }
        )
        path = f"{self._collection_path(kind, None)}?{query}"
        status, stream = self._request(
            "GET", path, timeout=self.WATCH_POLL_INTERVAL, stream=True
        )
        if status >= 300:
            raise ClusterAPIError(status, f"watch {kind}")
        try:
            while not stop():
                try:
                    line = stream.readline()
                except socket.timeout:
                    continue  # idle: poll stop() and keep the stream
                except (TimeoutError, ssl.SSLError) as err:
                    if "timed out" in str(err).lower():
                        continue
                    raise
                if not line:
                    return  # server closed; informer relists
                if not line.strip():
                    continue
                try:
                    payload = json.loads(line)
                except ValueError:
                    # a line truncated by a mid-read timeout parses as
                    # garbage; skipping is safe — the next relist
                    # (level trigger) recovers any lost event
                    continue
                event_type = payload.get("type", "")
                if event_type == "BOOKMARK":
                    continue
                if event_type == "ERROR":
                    # e.g. 410 Gone — return so the informer relists
                    # at a fresh resourceVersion
                    klog.errorf("watch %s: %r", kind, payload.get("object"))
                    return
                obj = self._decode(kind, payload.get("object") or {})
                yield WatchEvent(event_type, obj)
        except (urllib.error.URLError, ConnectionError, OSError) as err:
            klog.v(4).infof("watch %s: stream ended: %s", kind, err)
        finally:
            try:
                stream.close()
            except Exception:
                pass


# ---------------------------------------------------------------------------
# kubeconfig / in-cluster config resolution
# ---------------------------------------------------------------------------


def _b64_to_tempfile(data_b64: str, suffix: str) -> str:
    raw = base64.b64decode(data_b64)
    handle = tempfile.NamedTemporaryFile(suffix=suffix, delete=False)
    handle.write(raw)
    handle.close()
    return handle.name


class ExecCredentialProvider:
    """client.authentication.k8s.io exec-plugin credentials — how
    kubectl authenticates to EKS (``aws eks get-token``).  Runs the
    configured command, parses the ExecCredential JSON, caches the
    token until its expirationTimestamp (re-execs ~1 min early)."""

    def __init__(self, exec_spec: dict, timeout: float = 60.0):
        self._spec = exec_spec
        self._timeout = timeout
        self._lock = threading.Lock()
        self._token: Optional[str] = None
        self._expires: float = 0.0

    def __call__(self) -> Optional[str]:
        with self._lock:
            if self._token is not None and (
                self._expires == 0.0 or time.time() < self._expires - 60
            ):
                return self._token
            self._token, self._expires = self._fetch()
            return self._token

    def invalidate(self) -> None:
        """Drop the cached token so the next call re-execs — the
        client retries once with a fresh credential when the server
        rejects the cached one (early revocation, clock skew)."""
        with self._lock:
            self._token = None
            self._expires = 0.0

    def _fetch(self) -> tuple[Optional[str], float]:
        import subprocess

        command = [self._spec["command"]] + list(self._spec.get("args") or [])
        env = dict(os.environ)
        for pair in self._spec.get("env") or []:
            env[pair["name"]] = pair["value"]
        try:
            result = subprocess.run(
                command, env=env, capture_output=True, text=True, timeout=self._timeout
            )
        except subprocess.TimeoutExpired as err:
            raise ClusterAPIError(
                401,
                f"exec credential plugin {command[0]!r} timed out after {self._timeout}s",
            ) from err
        if result.returncode != 0:
            raise ClusterAPIError(
                401,
                f"exec credential plugin {command[0]!r} failed: {result.stderr.strip()}",
            )
        try:
            credential = json.loads(result.stdout)
        except ValueError as err:
            raise ClusterAPIError(
                401,
                f"exec credential plugin {command[0]!r} printed invalid JSON",
            ) from err
        status = credential.get("status") or {}
        token = status.get("token")
        raw_expiry = status.get("expirationTimestamp")
        if not raw_expiry:
            return token, 0.0  # no expiry advertised: cache for the process
        import datetime

        try:
            expires = datetime.datetime.fromisoformat(
                raw_expiry.replace("Z", "+00:00")
            ).timestamp()
        except ValueError:
            # unparseable expiry must fail STALE (re-exec next call),
            # never "never expires"
            expires = time.time()
        return token, expires


class TokenFileProvider:
    """Rotated token files (projected SA tokens).  The token is cached
    for a short TTL like client-go's file-token cache (~1 min) instead
    of paying an open/read/close on every API request; ``invalidate``
    forces a re-read, which wires token files into the client's
    401-refresh retry."""

    def __init__(self, path: str, ttl: float = 60.0):
        self._path = path
        self._ttl = ttl
        self._lock = threading.Lock()
        self._token: Optional[str] = None
        self._fresh_until = 0.0

    def __call__(self) -> Optional[str]:
        with self._lock:
            now = time.time()
            if self._token is not None and now < self._fresh_until:
                return self._token
            try:
                with open(self._path) as fh:
                    self._token = fh.read().strip()
            except OSError as err:
                if self._token is not None:
                    # transient rotate failure: keep serving the cached
                    # token (client-go's cachingTokenSource does the
                    # same); invalidate() clears it, so real auth
                    # failures still surface through the 401 path
                    klog.warningf(
                        "token file %s unreadable, serving cached token: %s",
                        self._path,
                        err,
                    )
                    return self._token
                raise ClusterAPIError(
                    401, f"token file {self._path!r} unreadable: {err}"
                ) from err
            self._fresh_until = now + self._ttl
            return self._token

    def invalidate(self) -> None:
        with self._lock:
            self._token = None
            self._fresh_until = 0.0


def build_client_from_kubeconfig(
    kubeconfig_path: str, master_url: str = "", context_name: str = ""
) -> RestClusterClient:
    """Parse a kubeconfig (the subset covering clusters/users/contexts
    with certificate/token/exec-plugin auth) and build a client;
    ``master_url`` overrides the cluster server like the reference's
    ``--master`` flag."""
    import yaml

    with open(kubeconfig_path) as fh:
        config = yaml.safe_load(fh) or {}

    contexts = {c["name"]: c["context"] for c in config.get("contexts", [])}
    clusters = {c["name"]: c["cluster"] for c in config.get("clusters", [])}
    users = {u["name"]: u["user"] for u in config.get("users", [])}
    context_name = context_name or config.get("current-context", "")
    if context_name not in contexts:
        raise ValueError(f"kubeconfig has no context {context_name!r}")
    context = contexts[context_name]
    cluster = clusters[context["cluster"]]
    user = users.get(context.get("user", ""), {})

    server = master_url or cluster.get("server", "")
    ssl_context = None
    if server.startswith("https"):
        ssl_context = ssl.create_default_context()
        if cluster.get("insecure-skip-tls-verify"):
            ssl_context.check_hostname = False
            ssl_context.verify_mode = ssl.CERT_NONE
        elif cluster.get("certificate-authority-data"):
            ssl_context = ssl.create_default_context(
                cafile=_b64_to_tempfile(cluster["certificate-authority-data"], ".crt")
            )
        elif cluster.get("certificate-authority"):
            ssl_context = ssl.create_default_context(
                cafile=cluster["certificate-authority"]
            )
        cert_file = user.get("client-certificate")
        key_file = user.get("client-key")
        if user.get("client-certificate-data"):
            cert_file = _b64_to_tempfile(user["client-certificate-data"], ".crt")
        if user.get("client-key-data"):
            key_file = _b64_to_tempfile(user["client-key-data"], ".key")
        if cert_file and key_file:
            ssl_context.load_cert_chain(cert_file, key_file)

    token = user.get("token")
    token_provider: Optional[Callable[[], Optional[str]]] = None
    if user.get("exec"):
        token_provider = ExecCredentialProvider(user["exec"])
    elif user.get("tokenFile") and not token:
        # clientcmd gives a static `token` priority over `tokenFile`
        token_provider = TokenFileProvider(user["tokenFile"])
    return RestClusterClient(
        server, token=token, ssl_context=ssl_context, token_provider=token_provider
    )


SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


def build_in_cluster_client() -> RestClusterClient:
    """In-cluster config from the mounted service account, the analog
    of ``rest.InClusterConfig``."""
    host = os.environ.get("KUBERNETES_SERVICE_HOST")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    if not host:
        raise RuntimeError("not running in a cluster (KUBERNETES_SERVICE_HOST unset)")
    token_path = os.path.join(SERVICE_ACCOUNT_DIR, "token")
    with open(token_path):
        pass  # fail fast if the mount is missing
    ssl_context = ssl.create_default_context(
        cafile=os.path.join(SERVICE_ACCOUNT_DIR, "ca.crt")
    )
    # projected SA tokens rotate; cached re-reads like client-go
    return RestClusterClient(
        f"https://{host}:{port}",
        ssl_context=ssl_context,
        token_provider=TokenFileProvider(token_path),
    )


def build_client(kubeconfig: str = "", master: str = "") -> RestClusterClient:
    """Kubeconfig if given (or discoverable), else in-cluster — the
    resolution order of ``clientcmd.BuildConfigFromFlags``."""
    if kubeconfig:
        return build_client_from_kubeconfig(kubeconfig, master)
    if master:
        return RestClusterClient(master)
    return build_in_cluster_client()
