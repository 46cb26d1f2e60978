"""The webhook HTTP(S) server.

Capability parity with the reference's ``pkg/webhoook/webhook.go:14-91``:
stdlib HTTP server (no framework), optional TLS from cert/key files,
``/healthz`` returning 200, and ``/validate-endpointgroupbinding``
doing strict request parsing — Content-Type must be application/json
(400 otherwise), empty body is 400, a review without a request is 400 —
then dispatching to the validator.
"""

from __future__ import annotations

import json
import os
import ssl
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import klog
from .validator import validate


class _Handler(BaseHTTPRequestHandler):
    # keep-alive: the apiserver calls this webhook on every CRD write
    # (failurePolicy=Fail) and must not pay a TCP+TLS handshake each time
    protocol_version = "HTTP/1.1"

    # quiet the default per-request stderr lines; klog covers it
    def log_message(self, fmt, *args):
        klog.v(4).infof("webhook http: " + fmt, *args)

    def do_GET(self):
        if self.path == "/healthz":
            # kubelet probes hit this every few seconds — verbose
            # level, or the probe traffic floods the logs
            klog.v(4).infof("healthz")
            # Content-Length is mandatory under keep-alive: without it
            # the client waits forever for a body that never comes
            self._respond(200, b"ok", content_type="text/plain")
            return
        self.send_error(404)

    def do_POST(self):
        if self.path != "/validate-endpointgroupbinding":
            self.send_error(404)
            return
        klog.infof("validate-endpointgroupbinding")
        review, err = self._parse_request()
        if err is not None:
            klog.error(err)
            self._respond(400, err.encode(), content_type="text/plain")
            return
        try:
            response = validate(review)
            body = json.dumps(response).encode()
        except Exception as exc:
            klog.error(exc)
            self._respond(500, str(exc).encode(), content_type="text/plain")
            return
        self._respond(200, body)

    def _parse_request(self):
        """(review, error) — mirrors ``parseRequest`` (webhook.go:61-85)."""
        content_type = self.headers.get("Content-Type", "")
        if content_type.split(";")[0].strip() != "application/json":
            return None, "invalid Content-Type"
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        if not body:
            return None, "empty body"
        try:
            review = json.loads(body)
        except ValueError as err:
            return None, f"failed to unmarshal body: {err}"
        if not isinstance(review, dict) or not review.get("request"):
            return None, "empty request"
        return review, None

    def _respond(self, code: int, body: bytes, content_type: str = "application/json"):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def _reloading_tls_context(cert_file: str, key_file: str) -> ssl.SSLContext:
    """TLS context that re-reads the cert/key when the files change.

    cert-manager rotates webhook certificates in place; the reference's
    Go server loads the pair once at startup and serves the stale cert
    until the pod restarts.  Here every handshake's SNI callback checks
    the files' mtimes and swaps in a freshly loaded context when they
    moved — a half-written rotation (cert/key momentarily mismatched)
    keeps serving the previous pair instead of breaking handshakes.
    The kube-apiserver always sends SNI (it dials the service DNS
    name); a client that omits SNI keeps the startup certificate.
    """
    lock = threading.Lock()
    state: dict = {"mtime": None, "context": None}

    def mtimes():
        return (os.stat(cert_file).st_mtime_ns, os.stat(key_file).st_mtime_ns)

    def load() -> ssl.SSLContext:
        context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        context.load_cert_chain(cert_file, key_file)
        context.sni_callback = sni
        return context

    def current() -> ssl.SSLContext:
        try:
            mtime = mtimes()
        except OSError:
            return state["context"]  # mid-rotation: files briefly absent
        with lock:
            if mtime != state["mtime"]:
                try:
                    state["context"] = load()
                    state["mtime"] = mtime
                    klog.infof("Loaded TLS certificate from %s", cert_file)
                except (ssl.SSLError, OSError) as err:
                    klog.errorf("Failed to reload TLS certificate: %s", err)
            return state["context"]

    def sni(sslobj, server_name, base_context):
        fresh = current()
        if fresh is not None and fresh is not sslobj.context:
            sslobj.context = fresh
        return None

    # first load is outside current(): a bad pair at startup must
    # fail fast with the real SSLError, not an opaque None downstream
    state["mtime"] = mtimes()
    state["context"] = load()
    return state["context"]


def make_server(port: int, tls_cert_file: str = "", tls_key_file: str = "", host: str = "") -> ThreadingHTTPServer:
    """Build the server (separately from serving, so tests can bind
    port 0 and shut down cleanly)."""
    server = ThreadingHTTPServer((host, port), _Handler)
    ssl_on = bool(tls_cert_file and tls_key_file)
    if ssl_on:
        context = _reloading_tls_context(tls_cert_file, tls_key_file)
        server.socket = context.wrap_socket(server.socket, server_side=True)
    klog.infof("Listening on :%d, SSL is %s", port, str(ssl_on).lower())
    return server


def Server(port: int, tls_cert_file: str = "", tls_key_file: str = "") -> None:
    """Blocking entry point, the analog of ``webhook.Server``."""
    make_server(port, tls_cert_file, tls_key_file).serve_forever()
