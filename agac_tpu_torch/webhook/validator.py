"""AdmissionReview validation for EndpointGroupBinding.

Capability parity with the reference's
``pkg/webhoook/endpointgroupbinding/validator.go:15-58``:

- request kind != EndpointGroupBinding → denied, code 400;
- operation != UPDATE → allowed (creates pass through);
- no oldObject → allowed;
- ``spec.endpointGroupArn`` changed → denied, code 403,
  message "Spec.EndpointGroupArn is immutable";
- otherwise allowed, code 200, message "valid".

Works on wire-format dicts (the AdmissionReview JSON), decoding the
embedded objects through the generic serde.
"""

from __future__ import annotations

from typing import Any

from .. import klog
from ..apis.endpointgroupbinding import EndpointGroupBinding
from ..cluster.serde import from_wire


def _review_response(uid: str, allowed: bool, code: int, reason: str) -> dict[str, Any]:
    return {
        "apiVersion": "admission.k8s.io/v1",
        "kind": "AdmissionReview",
        "response": {
            "uid": uid,
            "allowed": allowed,
            # AdmissionResponse.Result serializes under the "status"
            # key (metav1.Status), as in the reference's responses
            "status": {"code": code, "message": reason},
        },
    }


def validate(review: dict[str, Any]) -> dict[str, Any]:
    request = review.get("request") or {}
    uid = request.get("uid", "")

    kind = (request.get("kind") or {}).get("kind")
    if kind != "EndpointGroupBinding":
        klog.errorf("%s is not supported", kind)
        return _review_response(uid, False, 400, f"{kind} is not supported")

    if request.get("operation") != "UPDATE":
        klog.v(4).infof("Operation is not Update")
        return _review_response(uid, True, 200, "")

    old_raw = request.get("oldObject")
    if not old_raw:
        klog.v(4).infof("OldObject is nil")
        return _review_response(uid, True, 200, "")

    try:
        previous = from_wire(EndpointGroupBinding, old_raw)
        new = from_wire(EndpointGroupBinding, request.get("object") or {})
    except Exception as err:
        klog.error(err)
        return _review_response(uid, False, 500, str(err))

    if previous.spec.endpoint_group_arn != new.spec.endpoint_group_arn:
        klog.errorf("Spec.EndpointGroupArn is immutable")
        return _review_response(uid, False, 403, "Spec.EndpointGroupArn is immutable")

    return _review_response(uid, True, 200, "valid")
