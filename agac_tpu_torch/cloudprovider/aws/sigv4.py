"""AWS Signature Version 4 request signing and credential resolution,
stdlib only.

The authentication layer the reference gets from aws-sdk-go-v2's
``config.LoadDefaultConfig`` (``pkg/cloudprovider/aws/aws.go:18-38``).
Credential resolution order: environment (``AWS_ACCESS_KEY_ID`` /
``AWS_SECRET_ACCESS_KEY`` / ``AWS_SESSION_TOKEN``) → IRSA web
identity (``AWS_ROLE_ARN`` + ``AWS_WEB_IDENTITY_TOKEN_FILE``, the
standard EKS service-account setup, exchanged through STS
``AssumeRoleWithWebIdentity`` — an unsigned call) → shared
credentials file (``~/.aws/credentials``, profile from
``AWS_PROFILE``).  ``CredentialProvider`` caches and transparently
re-resolves expiring session credentials, which a long-running
controller needs.
"""

from __future__ import annotations

import configparser
import datetime
import hashlib
import hmac
import os
import threading
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Callable, Optional


@dataclass
class Credentials:
    access_key_id: str
    secret_access_key: str
    session_token: Optional[str] = None
    expiration: Optional[float] = None  # unix epoch; None = static

STS_ENDPOINT = "https://sts.amazonaws.com/"
_EXPIRY_MARGIN = 300.0  # refresh 5 min before expiry


def xml_strip_ns(root: ET.Element) -> ET.Element:
    """Strip XML namespaces in place (AWS XML responses are easier to
    navigate without them); shared with the real service clients."""
    for element in root.iter():
        if "}" in element.tag:
            element.tag = element.tag.split("}", 1)[1]
    return root


def _assume_role_with_web_identity(
    role_arn: str, token_file: str, urlopen=urllib.request.urlopen
) -> Credentials:
    """IRSA: exchange the projected service-account token for session
    credentials.  AssumeRoleWithWebIdentity takes no signature."""
    with open(token_file) as fh:
        token = fh.read().strip()
    body = urllib.parse.urlencode(
        {
            "Action": "AssumeRoleWithWebIdentity",
            "Version": "2011-06-15",
            "RoleArn": role_arn,
            "RoleSessionName": os.environ.get(
                "AWS_ROLE_SESSION_NAME", "aws-global-accelerator-controller"
            ),
            "WebIdentityToken": token,
        }
    ).encode()
    request = urllib.request.Request(
        STS_ENDPOINT,
        data=body,
        headers={"Content-Type": "application/x-www-form-urlencoded"},
        method="POST",
    )
    with urlopen(request, timeout=30) as response:
        payload = response.read()
    root = xml_strip_ns(ET.fromstring(payload))
    creds = root.find(".//Credentials")
    if creds is None:
        raise RuntimeError("STS AssumeRoleWithWebIdentity returned no credentials")
    expiration_text = creds.findtext("Expiration", "")
    expiration = None
    if expiration_text:
        expiration = (
            datetime.datetime.strptime(expiration_text, "%Y-%m-%dT%H:%M:%SZ")
            .replace(tzinfo=datetime.timezone.utc)
            .timestamp()
        )
    return Credentials(
        access_key_id=creds.findtext("AccessKeyId", ""),
        secret_access_key=creds.findtext("SecretAccessKey", ""),
        session_token=creds.findtext("SessionToken"),
        expiration=expiration,
    )


def resolve_credentials(urlopen=urllib.request.urlopen) -> Credentials:
    access_key = os.environ.get("AWS_ACCESS_KEY_ID")
    secret_key = os.environ.get("AWS_SECRET_ACCESS_KEY")
    if access_key and secret_key:
        return Credentials(access_key, secret_key, os.environ.get("AWS_SESSION_TOKEN"))
    role_arn = os.environ.get("AWS_ROLE_ARN")
    token_file = os.environ.get("AWS_WEB_IDENTITY_TOKEN_FILE")
    if role_arn and token_file:
        return _assume_role_with_web_identity(role_arn, token_file, urlopen)
    path = os.environ.get(
        "AWS_SHARED_CREDENTIALS_FILE", os.path.expanduser("~/.aws/credentials")
    )
    profile = os.environ.get("AWS_PROFILE", "default")
    parser = configparser.ConfigParser()
    if parser.read(path) and parser.has_section(profile):
        section = parser[profile]
        if "aws_access_key_id" in section and "aws_secret_access_key" in section:
            return Credentials(
                section["aws_access_key_id"],
                section["aws_secret_access_key"],
                section.get("aws_session_token"),
            )
    raise RuntimeError(
        "no AWS credentials found (env AWS_ACCESS_KEY_ID/AWS_SECRET_ACCESS_KEY, "
        f"IRSA AWS_ROLE_ARN/AWS_WEB_IDENTITY_TOKEN_FILE, or {path} profile {profile!r})"
    )


class CredentialProvider:
    """Caches credentials and re-resolves them before expiry; safe to
    share across service clients and threads.

    Resolved credentials WITHOUT an expiration (env vars, shared
    credentials file) are still re-resolved every
    ``STATIC_REFRESH_SECONDS`` so in-place key rotation is picked up —
    the provider is shared process-wide, and without a TTL a rotated
    credentials file would be ignored until restart (the reference
    re-resolves per reconcile via its ``NewAWS`` calls).  Explicit
    static ``Credentials`` passed to the constructor are honored as-is:
    non-expiring ones never re-resolve; expiring ones (e.g. session
    credentials) are served until the expiry margin, after which the
    resolver is *tried* for fresher credentials — but a failing
    resolver falls back to the static while it remains actually valid
    (the margin is an optimization, not a validity boundary).
    """

    STATIC_REFRESH_SECONDS = 300.0

    def __init__(
        self,
        static: Optional[Credentials] = None,
        resolver: Callable[[], Credentials] = resolve_credentials,
        clock: Callable[[], float] = None,
    ):
        import time as _time

        self._static = static
        self._resolver = resolver
        self._clock = clock or _time.time
        self._cached: Optional[Credentials] = static
        self._lock = threading.Lock()
        self._resolve_cooldown_until = 0.0
        self._resolved_at = 0.0

    def get(self) -> Credentials:
        with self._lock:
            cached = self._cached
            if cached is self._static and cached is not None:
                # explicit static creds: never re-resolve while valid —
                # non-expiring ones forever, expiring ones until the
                # expiry margin (only then fall through to the resolver)
                if (
                    cached.expiration is None
                    or cached.expiration - self._clock() > _EXPIRY_MARGIN
                ):
                    return cached
            elif cached is not None:
                fresh_enough = (
                    self._clock() - self._resolved_at < self.STATIC_REFRESH_SECONDS
                    if cached.expiration is None
                    else cached.expiration - self._clock() > _EXPIRY_MARGIN
                )
                if fresh_enough:
                    return cached
            if self._static is not None and self._static.expiration is None:
                return self._static
            def cached_still_valid() -> bool:
                return cached is not None and (
                    cached.expiration is None or cached.expiration > self._clock()
                )

            # after a resolver failure, don't retry on every call —
            # each attempt can block tens of seconds under this lock;
            # serve the still-valid cache during the cooldown
            if self._clock() < self._resolve_cooldown_until and cached_still_valid():
                return cached
            try:
                self._cached = self._resolver()
                self._resolved_at = self._clock()
                self._resolve_cooldown_until = 0.0
            except Exception:
                # transient resolver failure (e.g. STS unreachable):
                # keep serving cached credentials while they are still
                # actually valid — refresh margin is an optimization,
                # not a validity boundary
                self._resolve_cooldown_until = self._clock() + 30.0
                if cached_still_valid():
                    return cached
                raise
            return self._cached


def _sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _hmac(key: bytes, message: str) -> bytes:
    return hmac.new(key, message.encode(), hashlib.sha256).digest()


def derive_signing_key(
    secret_access_key: str, date_stamp: str, region: str, service: str
) -> bytes:
    """The SigV4 key-derivation chain
    ``HMAC(HMAC(HMAC(HMAC("AWS4"+secret, date), region), service), "aws4_request")``.
    Validated byte-for-byte against AWS's published derivation examples
    (``tests/test_sigv4_aws_vectors.py``)."""
    return _hmac(
        _hmac(
            _hmac(_hmac(f"AWS4{secret_access_key}".encode(), date_stamp), region),
            service,
        ),
        "aws4_request",
    )


def _canonical_query(query: str) -> str:
    pairs = urllib.parse.parse_qsl(query, keep_blank_values=True)
    encoded = [
        (urllib.parse.quote(k, safe="-_.~"), urllib.parse.quote(v, safe="-_.~"))
        for k, v in pairs
    ]
    return "&".join(f"{k}={v}" for k, v in sorted(encoded))


def sign_request(
    method: str,
    url: str,
    headers: dict[str, str],
    body: bytes,
    service: str,
    region: str,
    credentials: Credentials,
    now: Optional[datetime.datetime] = None,
) -> dict[str, str]:
    """Return ``headers`` plus the SigV4 ``Authorization``,
    ``X-Amz-Date`` (and session-token) headers for the request."""
    parsed = urllib.parse.urlsplit(url)
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    date_stamp = now.strftime("%Y%m%d")

    signed = dict(headers)
    signed["Host"] = parsed.netloc
    signed["X-Amz-Date"] = amz_date
    if credentials.session_token:
        signed["X-Amz-Security-Token"] = credentials.session_token

    payload_hash = _sha256_hex(body or b"")
    lower = {k.lower(): v.strip() for k, v in signed.items()}
    signed_header_names = ";".join(sorted(lower))
    canonical_headers = "".join(f"{k}:{lower[k]}\n" for k in sorted(lower))
    canonical_request = "\n".join(
        [
            method,
            urllib.parse.quote(parsed.path or "/", safe="/-_.~%"),
            _canonical_query(parsed.query),
            canonical_headers,
            signed_header_names,
            payload_hash,
        ]
    )
    scope = f"{date_stamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join(
        [
            "AWS4-HMAC-SHA256",
            amz_date,
            scope,
            _sha256_hex(canonical_request.encode()),
        ]
    )
    key = derive_signing_key(
        credentials.secret_access_key, date_stamp, region, service
    )
    signature = hmac.new(key, string_to_sign.encode(), hashlib.sha256).hexdigest()
    signed["Authorization"] = (
        "AWS4-HMAC-SHA256 "
        f"Credential={credentials.access_key_id}/{scope}, "
        f"SignedHeaders={signed_header_names}, "
        f"Signature={signature}"
    )
    return signed
