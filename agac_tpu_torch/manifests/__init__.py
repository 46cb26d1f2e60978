"""Deploy/config manifest generation.

The analog of the reference's ``controller-gen``-produced ``config/``
tree (SURVEY.md §2 row 22 and the manifest-drift CI check): the CRD,
the ValidatingWebhookConfiguration, the ClusterRole, and sample
objects are generated from the code in this package, and
``write_manifests`` regenerates them on disk so a CI step can fail if
the committed YAML drifts (mirroring ``.github/workflows/manifests.yml``).

The generated documents are structurally equivalent to the
reference's ``config/crd/operator.h3poteto.dev_endpointgroupbindings.yaml``,
``config/webhook/manifests.yaml`` and ``config/rbac/role.yaml``.
"""

from .generate import (
    crd_manifest,
    rbac_manifest,
    sample_manifests,
    validating_webhook_manifest,
    write_manifests,
)

__all__ = [
    "crd_manifest",
    "validating_webhook_manifest",
    "rbac_manifest",
    "sample_manifests",
    "write_manifests",
]
