"""Dynamic (untyped) client + server-side apply.

The analog of the reference's e2e manifest helpers
(``e2e/pkg/util/manifests.go:72-141``, duplicated at
``local_e2e/pkg/fixtures/manifests.go:72-131``): parse arbitrary YAML
manifests and apply them to an apiserver without typed clients — used
by the real-cluster e2e tier (``tests/test_kind_e2e.py``) to install
the CRD, RBAC, and ValidatingWebhookConfiguration exactly the way
``kubectl apply --server-side`` would.

Apply strategy, like the reference's ``Patch(..., types.ApplyPatchType)``:
server-side apply (``PATCH`` with ``application/apply-patch+yaml`` and
a field manager, force=true).  Servers without SSA (the in-repo test
apiserver) get a create-or-replace fallback so the tier's own logic
stays testable offline.
"""

from __future__ import annotations

import json
from typing import Optional

from .rest import RestClusterClient

# (apiVersion, kind) → plural for everything this repo's manifests and
# e2e tiers touch.  A real dynamic client would use API discovery; a
# static table keeps the client dependency-free and is exactly as
# wide as the manifests we ship (config/, charts/).
WELL_KNOWN_PLURALS: dict[tuple[str, str], str] = {
    ("v1", "Service"): "services",
    ("v1", "ServiceAccount"): "serviceaccounts",
    ("v1", "Namespace"): "namespaces",
    ("v1", "ConfigMap"): "configmaps",
    ("v1", "Secret"): "secrets",
    ("v1", "Event"): "events",
    ("v1", "Pod"): "pods",
    ("apps/v1", "Deployment"): "deployments",
    ("networking.k8s.io/v1", "Ingress"): "ingresses",
    ("coordination.k8s.io/v1", "Lease"): "leases",
    ("rbac.authorization.k8s.io/v1", "Role"): "roles",
    ("rbac.authorization.k8s.io/v1", "RoleBinding"): "rolebindings",
    ("rbac.authorization.k8s.io/v1", "ClusterRole"): "clusterroles",
    ("rbac.authorization.k8s.io/v1", "ClusterRoleBinding"): "clusterrolebindings",
    ("apiextensions.k8s.io/v1", "CustomResourceDefinition"): "customresourcedefinitions",
    (
        "admissionregistration.k8s.io/v1",
        "ValidatingWebhookConfiguration",
    ): "validatingwebhookconfigurations",
    ("operator.h3poteto.dev/v1alpha1", "EndpointGroupBinding"): "endpointgroupbindings",
    # shipped by the Helm chart's webhook template (cert-manager path)
    ("cert-manager.io/v1", "Certificate"): "certificates",
}

CLUSTER_SCOPED_KINDS = {
    "Namespace",
    "ClusterRole",
    "ClusterRoleBinding",
    "CustomResourceDefinition",
    "ValidatingWebhookConfiguration",
}

DEFAULT_FIELD_MANAGER = "aws-global-accelerator-controller"


class DynamicApplyError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


def _yaml():
    import yaml

    return yaml


class DynamicClient:
    """Untyped CRUD + apply over a ``RestClusterClient``'s transport
    (shares its base URL, TLS and credentials)."""

    def __init__(self, rest: RestClusterClient):
        self._rest = rest

    # ------------------------------------------------------------------
    # paths
    # ------------------------------------------------------------------
    @staticmethod
    def _collection_path(manifest: dict) -> str:
        api_version = manifest.get("apiVersion", "")
        kind = manifest.get("kind", "")
        plural = WELL_KNOWN_PLURALS.get((api_version, kind))
        if plural is None:
            raise ValueError(f"no known plural for {api_version}/{kind}")
        prefix = "api/v1" if api_version == "v1" else f"apis/{api_version}"
        if kind in CLUSTER_SCOPED_KINDS:
            return f"{prefix}/{plural}"
        namespace = manifest.get("metadata", {}).get("namespace") or "default"
        return f"{prefix}/namespaces/{namespace}/{plural}"

    @classmethod
    def _object_path(cls, manifest: dict) -> str:
        name = manifest.get("metadata", {}).get("name")
        if not name:
            raise ValueError("manifest has no metadata.name")
        return f"{cls._collection_path(manifest)}/{name}"

    # ------------------------------------------------------------------
    # operations
    # ------------------------------------------------------------------
    def get(self, manifest: dict) -> Optional[dict]:
        """Current object for a manifest-shaped reference, or None."""
        status, body = self._rest.raw_request("GET", self._object_path(manifest))
        if status == 404:
            return None
        if status >= 300:
            raise DynamicApplyError(status, body.decode(errors="replace"))
        return json.loads(body)

    def apply(
        self,
        manifest: dict,
        field_manager: str = DEFAULT_FIELD_MANAGER,
        force: bool = True,
    ) -> dict:
        """Server-side apply; create-or-replace fallback on servers
        without SSA support (405/415/501 from the PATCH verb — genuine
        SSA rejections like 400/403/409/422 propagate).

        ``force=True`` (the default, matching the reference's
        ``Force: true``, ``e2e/pkg/util/manifests.go:120-141``) takes
        ownership of fields held by other field managers; with
        ``force=False`` an overlapping apply surfaces the server's
        409 Conflict as ``DynamicApplyError``."""
        path = (
            f"{self._object_path(manifest)}"
            f"?fieldManager={field_manager}&force={'true' if force else 'false'}"
        )
        status, body = self._rest.raw_request(
            "PATCH",
            path,
            _yaml().safe_dump(manifest).encode(),
            content_type="application/apply-patch+yaml",
        )
        if status < 300:
            return json.loads(body)
        if status in (405, 415, 501):
            # server has no SSA PATCH route (the in-repo test
            # apiserver); genuine SSA rejections (400/403/409/422)
            # propagate untouched
            return self._create_or_replace(manifest)
        raise DynamicApplyError(status, body.decode(errors="replace"))

    def _create_or_replace(self, manifest: dict) -> dict:
        current = self.get(manifest)
        if current is None:
            status, body = self._rest.raw_request(
                "POST",
                self._collection_path(manifest),
                json.dumps(manifest).encode(),
            )
        else:
            replacement = dict(manifest)
            metadata = dict(replacement.get("metadata", {}))
            metadata["resourceVersion"] = current["metadata"].get("resourceVersion")
            replacement["metadata"] = metadata
            status, body = self._rest.raw_request(
                "PUT",
                self._object_path(manifest),
                json.dumps(replacement).encode(),
            )
        if status >= 300:
            raise DynamicApplyError(status, body.decode(errors="replace"))
        return json.loads(body)

    def delete(self, manifest: dict) -> None:
        status, body = self._rest.raw_request("DELETE", self._object_path(manifest))
        if status >= 300 and status != 404:
            raise DynamicApplyError(status, body.decode(errors="replace"))

    # ------------------------------------------------------------------
    # YAML entry points (multi-document, like kubectl apply -f)
    # ------------------------------------------------------------------
    def apply_yaml(self, text: str, field_manager: str = DEFAULT_FIELD_MANAGER) -> list[dict]:
        applied = []
        for doc in _yaml().safe_load_all(text):
            if doc:
                applied.append(self.apply(doc, field_manager))
        return applied

    def apply_file(self, path: str, field_manager: str = DEFAULT_FIELD_MANAGER) -> list[dict]:
        with open(path) as fh:
            return self.apply_yaml(fh.read(), field_manager)

    def delete_yaml(self, text: str) -> None:
        for doc in _yaml().safe_load_all(text):
            if doc:
                self.delete(doc)
