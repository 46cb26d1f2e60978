"""The annotation contract — the framework's user-facing API.

Capability parity with the reference's ``pkg/apis/type.go:3-12`` and
the annotation table in its ``README.md:232-241``: five controller
annotations plus two foreign annotations the predicates recognize.
The annotation domain is kept identical so manifests written for the
reference work unchanged against this framework.
"""

# Controller annotations (the user API)
AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION = (
    "aws-global-accelerator-controller.h3poteto.dev/global-accelerator-managed"
)
ROUTE53_HOSTNAME_ANNOTATION = (
    "aws-global-accelerator-controller.h3poteto.dev/route53-hostname"
)
CLIENT_IP_PRESERVATION_ANNOTATION = (
    "aws-global-accelerator-controller.h3poteto.dev/client-ip-preservation"
)
AWS_GLOBAL_ACCELERATOR_NAME_ANNOTATION = (
    "aws-global-accelerator-controller.h3poteto.dev/global-accelerator-name"
)
AWS_GLOBAL_ACCELERATOR_TAGS_ANNOTATION = (
    "aws-global-accelerator-controller.h3poteto.dev/global-accelerator-tags"
)

# Foreign annotations recognized by the predicates
AWS_LOAD_BALANCER_TYPE_ANNOTATION = "service.beta.kubernetes.io/aws-load-balancer-type"
INGRESS_CLASS_ANNOTATION = "kubernetes.io/ingress.class"

# ALB listen-ports annotation consumed for listener derivation
# (reference ``pkg/cloudprovider/aws/global_accelerator.go:521``)
ALB_LISTEN_PORTS_ANNOTATION = "alb.ingress.kubernetes.io/listen-ports"
