"""An embeddable kube-apiserver speaking the Kubernetes REST protocol
over real HTTP, backed by ``FakeCluster``.

The envtest/kind analog for this framework (the reference's tier-2
test strategy runs a kind cluster, SURVEY.md §4): full controller
processes — REST client, informers with streaming watches, leader
election leases, CRD finalizer flows — run against it without a real
control plane.  Endpoints implemented (for every kind in
``KIND_REGISTRY``):

- ``GET    /{prefix}/{plural}``                       list (all namespaces)
- ``GET    /{prefix}/{plural}?watch=true&...``        streaming watch
- ``GET    /{prefix}/namespaces/{ns}/{plural}``       namespaced list
- ``GET    /{prefix}/namespaces/{ns}/{plural}/{name}``
- ``POST   /{prefix}/namespaces/{ns}/{plural}``       create
- ``PUT    .../{name}``                               update
- ``PUT    .../{name}/status``                        status subresource
- ``PATCH  .../{name}`` (``application/apply-patch+yaml``) server-side apply
- ``DELETE .../{name}``                               delete (finalizer-aware)

Errors are k8s ``Status`` JSON with the proper HTTP codes so the REST
client's error mapping round-trips (404 NotFound, 409 Conflict /
AlreadyExists).

Validating admission webhooks can be registered per kind
(``register_validating_webhook``): CREATE/UPDATE requests are wrapped
in an AdmissionReview, POSTed to the webhook URL, and rejected with
403 when not allowed — the flow the reference's kind e2e exercises
against the real apiserver (``e2e/e2e_test.go:78-98``).
"""

from __future__ import annotations

import itertools
import json
import select
import socket
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..errors import AlreadyExistsError, ConflictError, NotFoundError
from .fake import FakeCluster
from .rest import KIND_REGISTRY
from .serde import from_wire, to_wire

# path prefix -> kind, e.g. ("api/v1", "services") -> "Service"
_PATH_TO_KIND = {
    (prefix, plural): kind
    for kind, (prefix, plural, _, _) in KIND_REGISTRY.items()
}


def _deep_merge(base: dict, overlay: dict) -> dict:
    """Recursive map merge for the apply route: nested dicts merge
    key-by-key, everything else (scalars, lists) is replaced by the
    overlay — the approximation of SSA the fallback-equivalence tests
    rely on."""
    merged = dict(base)
    for key, value in overlay.items():
        if isinstance(value, dict) and isinstance(merged.get(key), dict):
            merged[key] = _deep_merge(merged[key], value)
        else:
            merged[key] = value
    return merged


# identity fields every applier co-owns without conflict (the real
# apiserver's managedFields never attribute these to one manager)
_APPLY_IDENTITY_FIELDS = frozenset(
    {"apiVersion", "kind", "metadata.name", "metadata.namespace",
     "metadata.resourceVersion"}
)


def _apply_leaf_paths(manifest: dict, prefix: tuple = ()) -> list[str]:
    """Dot-joined leaf field paths an apply of ``manifest`` claims:
    maps recurse, scalars/lists/empty-maps are leaves (the granularity
    real SSA tracks atomic fields at — list-item-level ownership is
    beyond this server's charter).  Identity fields are excluded."""
    paths = []
    if isinstance(manifest, dict) and manifest:
        for key, value in manifest.items():
            paths.extend(_apply_leaf_paths(value, prefix + (str(key),)))
    else:
        path = ".".join(prefix)
        if path and path not in _APPLY_IDENTITY_FIELDS:
            paths.append(path)
    return paths


def _full_wire(kind: str, obj) -> dict:
    """Wire envelope: serde dict stamped with apiVersion + kind."""
    _, _, _, api_version = KIND_REGISTRY[kind]
    wire = to_wire(obj)
    wire["apiVersion"] = api_version
    wire["kind"] = kind
    return wire


def _status_body(code: int, reason: str, message: str) -> bytes:
    return json.dumps(
        {
            "kind": "Status",
            "apiVersion": "v1",
            "status": "Failure",
            "message": message,
            "reason": reason,
            "code": code,
        }
    ).encode()


class _Route:
    def __init__(self, kind: str, namespace: str, name: str, subresource: str):
        self.kind = kind
        self.namespace = namespace
        self.name = name
        self.subresource = subresource


def _parse_path(path: str) -> _Route | None:
    """Resolve a request path to (kind, namespace, name, subresource)."""
    parts = [p for p in path.split("/") if p]
    # prefixes are 2 ("api/v1") or 3 ("apis/group/version") segments
    for prefix_len in (2, 3):
        if len(parts) < prefix_len + 1:
            continue
        prefix = "/".join(parts[:prefix_len])
        rest = parts[prefix_len:]
        namespace = ""
        if rest and rest[0] == "namespaces" and len(rest) >= 2:
            namespace = rest[1]
            rest = rest[2:]
        if not rest:
            continue
        plural = rest[0]
        kind = _PATH_TO_KIND.get((prefix, plural))
        if kind is None:
            continue
        name = rest[1] if len(rest) > 1 else ""
        subresource = rest[2] if len(rest) > 2 else ""
        return _Route(kind, namespace, name, subresource)
    return None


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "agac-testserver/0.1"

    def log_message(self, fmt, *args):
        pass  # quiet

    @property
    def cluster(self) -> FakeCluster:
        return self.server.cluster  # type: ignore[attr-defined]

    # ------------------------------------------------------------------
    def _send(self, code: int, body: bytes, content_type="application/json", chunked=False):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        if chunked:
            self.send_header("Transfer-Encoding", "chunked")
        else:
            self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if not chunked and body:
            self.wfile.write(body)

    def _send_obj(self, code: int, kind: str, obj) -> None:
        self._send(code, json.dumps(_full_wire(kind, obj)).encode())

    def _send_error_status(self, err: Exception, context: str) -> None:
        if isinstance(err, NotFoundError):
            self._send(404, _status_body(404, "NotFound", f"{context} not found"))
        elif isinstance(err, AlreadyExistsError):
            self._send(409, _status_body(409, "AlreadyExists", f"{context} already exists"))
        elif isinstance(err, ConflictError):
            self._send(409, _status_body(409, "Conflict", str(err)))
        else:
            self._send(500, _status_body(500, "InternalError", str(err)))

    def _read_object(self, kind: str):
        length = int(self.headers.get("Content-Length") or 0)
        payload = json.loads(self.rfile.read(length)) if length else {}
        _, _, cls, _ = KIND_REGISTRY[kind]
        return from_wire(cls, payload)

    def _admit(self, kind: str, operation: str, obj, old_obj) -> str | None:
        """Run registered validating webhooks; returns a denial message
        or None if allowed (failurePolicy=Fail semantics: webhook
        errors reject the request, like the reference's configuration,
        ``config/webhook/manifests.yaml`` failurePolicy: Fail)."""
        webhook_url = self.server.webhooks.get(kind)  # type: ignore[attr-defined]
        if webhook_url is None:
            return None
        import urllib.request
        import uuid

        def wrap(o):
            return None if o is None else _full_wire(kind, o)

        review = {
            "apiVersion": "admission.k8s.io/v1",
            "kind": "AdmissionReview",
            "request": {
                "uid": str(uuid.uuid4()),
                "kind": {"kind": kind},
                "operation": operation,
                "object": wrap(obj),
                "oldObject": wrap(old_obj),
            },
        }
        request = urllib.request.Request(
            webhook_url,
            data=json.dumps(review).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(request, timeout=10) as response:
                result = json.loads(response.read())
        except Exception as err:
            return f"admission webhook call failed: {err}"
        resp = result.get("response") or {}
        if resp.get("allowed"):
            return None
        # or-fallback, not get-default: an explicit null message must
        # still read as a denial
        return (resp.get("status") or {}).get("message") or "denied by admission webhook"

    # ------------------------------------------------------------------
    def do_GET(self):
        parsed = urllib.parse.urlsplit(self.path)
        route = _parse_path(parsed.path)
        if route is None:
            self._send(404, _status_body(404, "NotFound", f"unknown path {parsed.path}"))
            return
        query = dict(urllib.parse.parse_qsl(parsed.query))
        if route.name:
            try:
                obj = self.cluster.get(route.kind, route.namespace, route.name)
            except Exception as err:
                self._send_error_status(err, f"{route.kind} {route.name}")
                return
            self._send_obj(200, route.kind, obj)
            return
        if query.get("watch") == "true":
            self._serve_watch(route.kind, query)
            return
        # chunked listing: honor limit/continue the way a real
        # apiserver does — continue pages are served from a PINNED
        # snapshot (never a fresh re-list, which would skip objects
        # deleted between pages), and an expired/unknown token gets a
        # 410 so clients restart the list
        try:
            limit = int(query.get("limit") or 0)
        except ValueError:
            self._send(400, _status_body(400, "BadRequest", "invalid limit"))
            return
        token = query.get("continue") or ""
        snapshots = self.server.list_snapshots  # type: ignore[attr-defined]
        snapshots_lock = self.server.snapshots_lock  # type: ignore[attr-defined]
        if token:
            try:
                snap_id, offset_str = token.split(":", 1)
                offset = int(offset_str)
            except ValueError:
                self._send(400, _status_body(400, "BadRequest", "invalid continue token"))
                return
            with snapshots_lock:
                snapshot = snapshots.get(snap_id)
            if snapshot is None:
                self._send(
                    410, _status_body(410, "Expired", "continue token expired")
                )
                return
            objs, rv = snapshot
        else:
            objs, rv = self.cluster.list(route.kind, route.namespace or None)
            offset = 0
        _, _, _, api_version = KIND_REGISTRY[route.kind]
        metadata: dict = {"resourceVersion": rv}
        page = objs[offset:]
        if limit and len(page) > limit:
            page = page[:limit]
            snap_id = (
                token.split(":", 1)[0]
                if token
                else f"s{next(self.server.snapshot_counter)}"  # type: ignore[attr-defined]
            )
            with snapshots_lock:
                # LRU: move-to-end on every touch so an ACTIVE
                # pagination outlives younger abandoned ones, then
                # evict oldest (clients holding an evicted token get
                # the 410 above)
                snapshots.pop(snap_id, None)
                snapshots[snap_id] = (objs, rv)
                while len(snapshots) > 32:
                    snapshots.pop(next(iter(snapshots)))
            metadata["continue"] = f"{snap_id}:{offset + limit}"
        elif token:
            with snapshots_lock:
                snapshots.pop(token.split(":", 1)[0], None)  # fully consumed
        items = [_full_wire(route.kind, obj) for obj in page]
        body = json.dumps(
            {
                "apiVersion": api_version,
                "kind": f"{route.kind}List",
                "metadata": metadata,
                "items": items,
            }
        ).encode()
        self._send(200, body)

    def _serve_watch(self, kind: str, query: dict) -> None:
        import time

        timeout_seconds = float(query.get("timeoutSeconds", 240))
        deadline = time.monotonic() + timeout_seconds
        stopped = threading.Event()
        start_generation = getattr(self.server, "watch_generation", 0)

        def broken() -> bool:
            return getattr(self.server, "watch_generation", 0) != start_generation

        def gone() -> bool:
            # the client closed the stream (a reflector that watches
            # again, a process that died): no event would tell this
            # thread, which would poll the store until the deadline
            try:
                readable, _, _ = select.select([self.connection], [], [], 0)
                return bool(readable) and not self.connection.recv(1, socket.MSG_PEEK)
            except OSError:
                return True

        def stop() -> bool:
            return (
                stopped.is_set() or time.monotonic() >= deadline or broken() or gone()
            )

        self._send(200, b"", chunked=True)
        try:
            for event in self.cluster.watch(kind, query.get("resourceVersion", "0"), stop):
                line = (
                    json.dumps(
                        {"type": event.type, "object": _full_wire(kind, event.obj)}
                    ).encode()
                    + b"\n"
                )
                self.wfile.write(f"{len(line):x}\r\n".encode() + line + b"\r\n")
                self.wfile.flush()
            if broken():
                # the apiserver expired this watch: emit the 410 ERROR
                # event clients must answer with a fresh list+watch
                line = (
                    json.dumps(
                        {"type": "ERROR", "object": {"code": 410, "reason": "Gone"}}
                    ).encode()
                    + b"\n"
                )
                self.wfile.write(f"{len(line):x}\r\n".encode() + line + b"\r\n")
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            stopped.set()
            return
        try:
            self.wfile.write(b"0\r\n\r\n")  # chunked terminator
        except (BrokenPipeError, ConnectionResetError):
            pass

    def do_POST(self):
        route = _parse_path(urllib.parse.urlsplit(self.path).path)
        if route is None:
            self._send(404, _status_body(404, "NotFound", "unknown path"))
            return
        try:
            obj = self._read_object(route.kind)
            denial = self._admit(route.kind, "CREATE", obj, None)
            if denial is not None:
                self._send(403, _status_body(403, "Forbidden", denial))
                return
            created = self.cluster.create(route.kind, obj)
        except Exception as err:
            self._send_error_status(err, route.kind)
            return
        self._send_obj(201, route.kind, created)

    def do_PUT(self):
        route = _parse_path(urllib.parse.urlsplit(self.path).path)
        if route is None or not route.name:
            self._send(404, _status_body(404, "NotFound", "unknown path"))
            return
        try:
            obj = self._read_object(route.kind)
            if route.subresource == "status":
                updated = self.cluster.update_status(route.kind, obj)
            else:
                old_obj = None
                try:
                    old_obj = self.cluster.get(route.kind, route.namespace, route.name)
                except NotFoundError:
                    pass
                denial = self._admit(route.kind, "UPDATE", obj, old_obj)
                if denial is not None:
                    self._send(403, _status_body(403, "Forbidden", denial))
                    return
                updated = self.cluster.update(route.kind, obj)
        except Exception as err:
            self._send_error_status(err, f"{route.kind} {route.name}")
            return
        self._send_obj(200, route.kind, updated)

    def do_PATCH(self):
        """Server-side apply (``application/apply-patch+yaml``), the
        route ``DynamicClient.apply`` hits first — create-or-merge with
        the fieldManager recorded in ``server.apply_managers`` so tests
        can assert WHICH branch ran (reference analog: SSA through the
        dynamic client, ``e2e/pkg/util/manifests.go:83-141``).  Field
        ownership is tracked per leaf path in ``server.field_owners``:
        a second manager applying an owned field gets 409 Conflict
        unless ``force=true`` takes the field over — so the client's
        force contract is asserted against a server that can say no.

        ``TestApiServer(ssa=False)`` answers 501 instead, standing in
        for pre-SSA servers so the client's create-or-replace fallback
        stays testable."""
        parsed = urllib.parse.urlsplit(self.path)
        route = _parse_path(parsed.path)
        if route is None or not route.name:
            self._send(404, _status_body(404, "NotFound", "unknown path"))
            return
        if route.subresource:
            # the real apiserver supports apply on /status; this server
            # does not emulate field ownership per subresource — be
            # LOUD (400 propagates through DynamicClient, no fallback)
            # rather than silently applying to the whole object
            self._send(
                400,
                _status_body(
                    400,
                    "BadRequest",
                    f"apply to subresource {route.subresource!r} is not "
                    "implemented by the test apiserver",
                ),
            )
            return
        if not getattr(self.server, "ssa_enabled", True):
            self._send(
                501, _status_body(501, "NotImplemented", "SSA disabled")
            )
            return
        content_type = (self.headers.get("Content-Type") or "").split(";")[0]
        if content_type != "application/apply-patch+yaml":
            # merge/json/strategic patch are not implemented here —
            # 415 is what a server without the route family answers
            self._send(
                415,
                _status_body(
                    415, "UnsupportedMediaType", f"unsupported patch {content_type}"
                ),
            )
            return
        query = dict(urllib.parse.parse_qsl(parsed.query))
        field_manager = query.get("fieldManager", "")
        force = query.get("force", "false") == "true"
        if not field_manager:
            # the real apiserver rejects apply without a manager; NOT
            # a fallback trigger (400 must propagate to the client)
            self._send(
                400,
                _status_body(400, "BadRequest", "fieldManager is required for apply"),
            )
            return
        import yaml as _yaml_mod

        length = int(self.headers.get("Content-Length") or 0)
        try:
            manifest = _yaml_mod.safe_load(self.rfile.read(length)) or {}
        except _yaml_mod.YAMLError as err:
            self._send(400, _status_body(400, "BadRequest", f"bad YAML: {err}"))
            return
        metadata = (manifest.get("metadata") or {}) if isinstance(manifest, dict) else {}
        body_name = metadata.get("name")
        body_namespace = metadata.get("namespace")
        if (body_name and body_name != route.name) or (
            body_namespace and route.namespace and body_namespace != route.namespace
        ):
            # the real apiserver 400s on URL/body identity mismatch;
            # silently creating the BODY's name would let smoke-mode
            # tests pass that fail on kind
            self._send(
                400,
                _status_body(
                    400,
                    "BadRequest",
                    f"manifest identity {body_namespace}/{body_name} does not "
                    f"match request path {route.namespace}/{route.name}",
                ),
            )
            return
        _, _, cls, _ = KIND_REGISTRY[route.kind]
        owner_key = (route.kind, route.namespace, route.name)
        claimed = _apply_leaf_paths(manifest)
        # the whole read-adjudicate-write sequence must be atomic under
        # ThreadingHTTPServer: without this, two concurrent non-force
        # applies from different managers both read a not-yet-written
        # owners map, both pass the conflict gate, and the last writer
        # silently takes fields the real apiserver would 409
        with self.server.apply_lock:  # type: ignore[attr-defined]
            self._apply_locked(route, cls, owner_key, claimed, manifest,
                               field_manager, force)

    def _apply_locked(
        self, route, cls, owner_key, claimed, manifest, field_manager, force
    ):
        try:
            current = None
            try:
                current = self.cluster.get(route.kind, route.namespace, route.name)
            except NotFoundError:
                pass
            if current is not None:
                # field-manager conflict semantics (the contract
                # ``DynamicClient.apply(force=...)`` is written
                # against, reference ``e2e/pkg/util/manifests.go:
                # 120-141`` Force: true): a field owned by a DIFFERENT
                # manager conflicts — 409 without force, ownership
                # takeover with it.  Value equality does not matter:
                # real SSA conflicts between appliers regardless of
                # the value being applied.
                owners = self.server.field_owners.get(owner_key, {})  # type: ignore[attr-defined]
                conflicts = sorted(
                    (path, owners[path])
                    for path in claimed
                    if owners.get(path) not in (None, field_manager)
                )
                if conflicts and not force:
                    detail = ", ".join(
                        f'conflict with "{manager}": .{path}'
                        for path, manager in conflicts
                    )
                    plural = "s" if len(conflicts) != 1 else ""
                    self._send(
                        409,
                        _status_body(
                            409,
                            "Conflict",
                            f"Apply failed with {len(conflicts)} "
                            f"conflict{plural}: {detail}",
                        ),
                    )
                    return
            if current is None:
                obj = from_wire(cls, manifest)
                denial = self._admit(route.kind, "CREATE", obj, None)
                if denial is not None:
                    self._send(403, _status_body(403, "Forbidden", denial))
                    return
                result = self.cluster.create(route.kind, obj)
                code = 201
            else:
                # apply over the live object (conflicts already
                # adjudicated above): deep-merge the manifest's fields
                # (maps merge, scalars/lists replace), on the CURRENT
                # resourceVersion so the storage update itself never
                # optimistic-locks
                merged = _deep_merge(_full_wire(route.kind, current), manifest)
                merged.setdefault("metadata", {})["resourceVersion"] = (
                    to_wire(current).get("metadata", {}).get("resourceVersion")
                )
                obj = from_wire(cls, merged)
                denial = self._admit(route.kind, "UPDATE", obj, current)
                if denial is not None:
                    self._send(403, _status_body(403, "Forbidden", denial))
                    return
                result = self.cluster.update(route.kind, obj)
                code = 200
        except Exception as err:
            self._send_error_status(err, f"{route.kind} {route.name}")
            return
        self.server.apply_managers[  # type: ignore[attr-defined]
            (route.kind, route.namespace, route.name)
        ] = field_manager
        # the applier now owns every field it claimed (including any
        # it took over with force)
        owned = self.server.field_owners.setdefault(owner_key, {})  # type: ignore[attr-defined]
        for path in claimed:
            owned[path] = field_manager
        self._send_obj(code, route.kind, result)

    def do_DELETE(self):
        route = _parse_path(urllib.parse.urlsplit(self.path).path)
        if route is None or not route.name:
            self._send(404, _status_body(404, "NotFound", "unknown path"))
            return
        try:
            self.cluster.delete(route.kind, route.namespace, route.name)
        except Exception as err:
            self._send_error_status(err, f"{route.kind} {route.name}")
            return
        # a deleted object's field ownership dies with it: a future
        # namesake starts with a clean managedFields slate
        with self.server.apply_lock:  # type: ignore[attr-defined]
            self.server.field_owners.pop(  # type: ignore[attr-defined]
                (route.kind, route.namespace, route.name), None
            )
            self.server.apply_managers.pop(  # type: ignore[attr-defined]
                (route.kind, route.namespace, route.name), None
            )
        self._send(200, _status_body(200, "Success", "deleted").replace(b"Failure", b"Success"))


class TestApiServer:
    """Lifecycle wrapper: ``with TestApiServer() as server:`` gives
    ``server.url`` for a RestClusterClient and ``server.cluster`` for
    direct state manipulation/assertions."""

    __test__ = False  # not a pytest collection target

    def __init__(
        self, cluster: FakeCluster | None = None, port: int = 0, ssa: bool = True
    ):
        self.cluster = cluster or FakeCluster()
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
        self._httpd.cluster = self.cluster  # type: ignore[attr-defined]
        self._httpd.webhooks = {}  # type: ignore[attr-defined]
        # SSA apply support (do_PATCH); ssa=False answers 501 so the
        # DynamicClient's create-or-replace fallback can be exercised
        self._httpd.ssa_enabled = ssa  # type: ignore[attr-defined]
        # (kind, namespace, name) -> last apply fieldManager; only the
        # SSA route writes this, so tests can prove which branch ran
        self.apply_managers: dict[tuple[str, str, str], str] = {}
        self._httpd.apply_managers = self.apply_managers  # type: ignore[attr-defined]
        # (kind, namespace, name) -> {leaf field path -> fieldManager}:
        # enough managed-fields bookkeeping to say NO — overlapping
        # apply from a second manager is 409 without force, takeover
        # with it (the real apiserver's apply conflict contract)
        self.field_owners: dict[tuple[str, str, str], dict[str, str]] = {}
        self._httpd.field_owners = self.field_owners  # type: ignore[attr-defined]
        # serializes apply conflict adjudication (read owners → admit →
        # write → record owners) across handler threads
        self._httpd.apply_lock = threading.Lock()  # type: ignore[attr-defined]
        # pagination snapshots: initialized once here (not lazily per
        # request — the threaded server would race and drop one) and
        # keyed by a monotonic counter, never id(), which CPython can
        # reuse after GC and silently resume a stale token against the
        # wrong snapshot instead of 410ing
        self._httpd.list_snapshots = {}  # type: ignore[attr-defined]
        self._httpd.snapshots_lock = threading.Lock()  # type: ignore[attr-defined]
        self._httpd.snapshot_counter = itertools.count(1)  # type: ignore[attr-defined]
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    def register_validating_webhook(self, kind: str, url: str) -> None:
        """Route CREATE/UPDATE admission for ``kind`` through the
        webhook at ``url`` (the ValidatingWebhookConfiguration analog)."""
        self._httpd.webhooks[kind] = url  # type: ignore[attr-defined]

    def break_watches(self) -> None:
        """Expire every active watch stream with a 410 Gone ERROR
        event — the compaction/timeout fault real apiservers serve,
        which clients must answer with a fresh list+watch."""
        self._httpd.watch_generation = (  # type: ignore[attr-defined]
            getattr(self._httpd, "watch_generation", 0) + 1
        )

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "TestApiServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="test-apiserver"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self) -> "TestApiServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
