"""Manifest builders (see package docstring)."""

from __future__ import annotations

import json
import os

import yaml

from .. import apis
from ..apis.endpointgroupbinding.v1alpha1 import GROUP, KIND, PLURAL, VERSION


def crd_manifest() -> dict:
    """The EndpointGroupBinding CRD, structurally equivalent to the
    reference's generated
    ``config/crd/operator.h3poteto.dev_endpointgroupbindings.yaml``."""
    spec_schema = {
        "properties": {
            "clientIPPreservation": {"default": False, "type": "boolean"},
            "endpointGroupArn": {"type": "string"},
            "ingressRef": {
                "properties": {"name": {"type": "string"}},
                "required": ["name"],
                "type": "object",
            },
            "serviceRef": {
                "properties": {"name": {"type": "string"}},
                "required": ["name"],
                "type": "object",
            },
            "weight": {"format": "int32", "nullable": True, "type": "integer"},
        },
        "required": ["endpointGroupArn"],
        "type": "object",
    }
    status_schema = {
        "properties": {
            "endpointIds": {"items": {"type": "string"}, "type": "array"},
            "observedGeneration": {"default": 0, "format": "int64", "type": "integer"},
        },
        "required": ["observedGeneration"],
        "type": "object",
    }
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"{PLURAL}.{GROUP}"},
        "spec": {
            "group": GROUP,
            "names": {
                "kind": KIND,
                "listKind": f"{KIND}List",
                "plural": PLURAL,
                "singular": PLURAL[:-1],
            },
            "scope": "Namespaced",
            "versions": [
                {
                    "additionalPrinterColumns": [
                        {
                            "jsonPath": ".spec.endpointGroupArn",
                            "name": "EndpointGroupArn",
                            "type": "string",
                        },
                        {
                            "jsonPath": ".status.endpointIds",
                            "name": "EndpointIds",
                            "type": "string",
                        },
                        {
                            "jsonPath": ".metadata.creationTimestamp",
                            "name": "Age",
                            "type": "date",
                        },
                    ],
                    "name": VERSION,
                    "schema": {
                        "openAPIV3Schema": {
                            "description": KIND,
                            "properties": {
                                "apiVersion": {"type": "string"},
                                "kind": {"type": "string"},
                                "metadata": {"type": "object"},
                                "spec": spec_schema,
                                "status": status_schema,
                            },
                            "type": "object",
                        }
                    },
                    "served": True,
                    "storage": True,
                    "subresources": {"status": {}},
                }
            ],
        },
    }


def validating_webhook_manifest(
    service_name: str = "webhook-service", service_namespace: str = "system"
) -> dict:
    """ValidatingWebhookConfiguration, equivalent to the reference's
    ``config/webhook/manifests.yaml`` (failurePolicy Fail, CREATE +
    UPDATE on endpointgroupbindings)."""
    return {
        "apiVersion": "admissionregistration.k8s.io/v1",
        "kind": "ValidatingWebhookConfiguration",
        "metadata": {"name": "validating-webhook-configuration"},
        "webhooks": [
            {
                "admissionReviewVersions": ["v1"],
                "clientConfig": {
                    "service": {
                        "name": service_name,
                        "namespace": service_namespace,
                        "path": "/validate-endpointgroupbinding",
                    }
                },
                "failurePolicy": "Fail",
                "name": "validate-endpointgroupbinding.h3poteto.dev",
                "rules": [
                    {
                        "apiGroups": [GROUP],
                        "apiVersions": [VERSION],
                        "operations": ["CREATE", "UPDATE"],
                        "resources": [PLURAL],
                    }
                ],
                "sideEffects": "None",
            }
        ],
    }


def rbac_manifest() -> dict:
    """ClusterRole equivalent to the reference's generated
    ``config/rbac/role.yaml`` (aggregated from its kubebuilder rbac
    markers: configmaps + leases for leader election, events for the
    recorder, services/ingresses read-only, the CRD + its status)."""
    rule = lambda groups, resources, verbs: {
        "apiGroups": groups,
        "resources": resources,
        "verbs": verbs,
    }
    all_verbs = ["create", "delete", "get", "list", "patch", "update", "watch"]
    return {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "ClusterRole",
        "metadata": {"name": "global-accelerator-manager-role"},
        "rules": [
            rule([""], ["configmaps"], all_verbs),
            rule([""], ["configmaps/status"], ["get", "patch", "update"]),
            rule([""], ["events"], ["create", "patch"]),
            rule([""], ["services"], ["get", "list", "watch"]),
            rule(["coordination.k8s.io"], ["leases"], all_verbs),
            rule(["networking.k8s.io"], ["ingresses"], ["get", "list", "watch"]),
            rule([GROUP], [PLURAL], all_verbs),
            rule([GROUP], [f"{PLURAL}/status"], ["get", "patch", "update"]),
        ],
    }


def service_account_manifest(namespace: str = "kube-system") -> dict:
    return {
        "apiVersion": "v1",
        "kind": "ServiceAccount",
        "metadata": {
            "name": "aws-global-accelerator-controller",
            "namespace": namespace,
        },
    }


def cluster_role_binding_manifest(namespace: str = "kube-system") -> dict:
    return {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "ClusterRoleBinding",
        "metadata": {"name": "global-accelerator-manager-rolebinding"},
        "roleRef": {
            "apiGroup": "rbac.authorization.k8s.io",
            "kind": "ClusterRole",
            "name": "global-accelerator-manager-role",
        },
        "subjects": [
            {
                "kind": "ServiceAccount",
                "name": "aws-global-accelerator-controller",
                "namespace": namespace,
            }
        ],
    }


def sample_manifests() -> dict[str, dict]:
    """Sample objects, the analog of ``config/samples/``."""
    return {
        "nlb-public-service.yaml": {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {
                "name": "sample-nlb",
                "namespace": "default",
                "annotations": {
                    apis.AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION: "true",
                    apis.ROUTE53_HOSTNAME_ANNOTATION: "sample.example.com",
                    apis.AWS_LOAD_BALANCER_TYPE_ANNOTATION: "external",
                    "service.beta.kubernetes.io/aws-load-balancer-nlb-target-type": "ip",
                    "service.beta.kubernetes.io/aws-load-balancer-scheme": "internet-facing",
                },
            },
            "spec": {
                "type": "LoadBalancer",
                "selector": {"app": "sample"},
                "ports": [{"name": "http", "port": 80, "protocol": "TCP"}],
            },
        },
        "nlb-internal-service.yaml": {
            # wildcard hostname + client-ip-preservation, mirrors the
            # reference's config/samples/nlb-internal-service.yaml
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {
                "name": "sample-nlb-internal",
                "namespace": "default",
                "annotations": {
                    apis.AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION: "true",
                    apis.ROUTE53_HOSTNAME_ANNOTATION: "*.internal.example.com",
                    apis.CLIENT_IP_PRESERVATION_ANNOTATION: "true",
                    apis.AWS_LOAD_BALANCER_TYPE_ANNOTATION: "external",
                    "service.beta.kubernetes.io/aws-load-balancer-nlb-target-type": "instance",
                    "service.beta.kubernetes.io/aws-load-balancer-scheme": "internet-facing",
                    "service.beta.kubernetes.io/aws-load-balancer-cross-zone-load-balancing-enabled": "true",
                },
            },
            "spec": {
                "type": "LoadBalancer",
                "externalTrafficPolicy": "Local",
                "selector": {"app": "sample"},
                "ports": [
                    {"name": "http", "port": 80, "protocol": "TCP", "targetPort": 80},
                    {"name": "https", "port": 443, "protocol": "TCP", "targetPort": 443},
                ],
            },
        },
        "nlb-public-ip-service.yaml": {
            # ip-target NLB without controller annotations (the LB the
            # EndpointGroupBinding sample points at), mirrors the
            # reference's config/samples/nlb-public-ip-service.yaml
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {
                "name": "sample-nlb-ip",
                "namespace": "default",
                "annotations": {
                    apis.AWS_LOAD_BALANCER_TYPE_ANNOTATION: "external",
                    "service.beta.kubernetes.io/aws-load-balancer-nlb-target-type": "ip",
                    "service.beta.kubernetes.io/aws-load-balancer-scheme": "internet-facing",
                },
            },
            "spec": {
                "type": "LoadBalancer",
                "selector": {"app": "sample"},
                "ports": [{"name": "http", "port": 80, "protocol": "TCP", "targetPort": 80}],
            },
        },
        "service.yaml": {
            # plain NodePort backend for the ALB ingress sample,
            # mirrors the reference's config/samples/service.yaml
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": "sample", "namespace": "default"},
            "spec": {
                "type": "NodePort",
                "selector": {"app": "sample"},
                "ports": [
                    {"name": "http", "port": 80, "protocol": "TCP", "targetPort": 80},
                    {"name": "https", "port": 443, "protocol": "TCP", "targetPort": 443},
                ],
            },
        },
        "alb-public-ingress.yaml": {
            "apiVersion": "networking.k8s.io/v1",
            "kind": "Ingress",
            "metadata": {
                "name": "sample-alb",
                "namespace": "default",
                "annotations": {
                    apis.AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION: "true",
                    apis.ROUTE53_HOSTNAME_ANNOTATION: "alb.example.com",
                    "alb.ingress.kubernetes.io/scheme": "internet-facing",
                    apis.ALB_LISTEN_PORTS_ANNOTATION: '[{"HTTP":80}]',
                },
            },
            "spec": {
                "ingressClassName": "alb",
                "rules": [
                    {
                        "http": {
                            "paths": [
                                {
                                    "pathType": "Prefix",
                                    "path": "/",
                                    "backend": {
                                        "service": {
                                            "name": "sample",
                                            "port": {"number": 80},
                                        }
                                    },
                                }
                            ]
                        }
                    }
                ],
            },
        },
        "alb-internal-ingress.yaml": {
            # internal-scheme ALB with multiple route53 hostnames and
            # HTTPS listen-ports, mirrors the reference's
            # config/samples/alb-internal-ingress.yaml
            "apiVersion": "networking.k8s.io/v1",
            "kind": "Ingress",
            "metadata": {
                "name": "sample-alb-internal",
                "namespace": "default",
                "annotations": {
                    apis.AWS_GLOBAL_ACCELERATOR_MANAGED_ANNOTATION: "true",
                    apis.ROUTE53_HOSTNAME_ANNOTATION: "foo.example.com,bar.example.com",
                    "alb.ingress.kubernetes.io/scheme": "internal",
                    apis.ALB_LISTEN_PORTS_ANNOTATION: '[{"HTTPS":443}]',
                },
            },
            "spec": {
                "ingressClassName": "alb",
                "rules": [
                    {
                        "http": {
                            "paths": [
                                {
                                    "pathType": "Prefix",
                                    "path": "/",
                                    "backend": {
                                        "service": {
                                            "name": "sample",
                                            "port": {"number": 80},
                                        }
                                    },
                                }
                            ]
                        }
                    }
                ],
            },
        },
        "deployment.yaml": {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {"name": "aws-global-accelerator-controller", "namespace": "kube-system"},
            "spec": {
                "replicas": 2,  # leader election makes this active/standby
                "selector": {"matchLabels": {"app": "aws-global-accelerator-controller"}},
                "template": {
                    "metadata": {"labels": {"app": "aws-global-accelerator-controller"}},
                    "spec": {
                        "serviceAccountName": "aws-global-accelerator-controller",
                        "containers": [
                            {
                                "name": "controller",
                                "image": "aws-global-accelerator-controller:latest",
                                "args": ["-v", "2", "controller", "--cluster-name", "default"],
                                "env": [
                                    {
                                        "name": "POD_NAMESPACE",
                                        "valueFrom": {
                                            "fieldRef": {"fieldPath": "metadata.namespace"}
                                        },
                                    }
                                ],
                            }
                        ],
                    },
                },
            },
        },
        "endpointgroupbinding.yaml": {
            "apiVersion": f"{GROUP}/{VERSION}",
            "kind": KIND,
            "metadata": {"name": "sample-binding", "namespace": "default"},
            "spec": {
                "endpointGroupArn": "arn:aws:globalaccelerator::123456789012:accelerator/example/listener/example/endpoint-group/example",
                "weight": 128,
                "serviceRef": {"name": "sample-nlb"},
            },
        },
    }


def iam_policy() -> dict:
    """The minimal AWS IAM policy the controller needs, as published in
    the reference's IRSA e2e setup (``local_e2e/cluster.yaml:37-76``)."""
    return {
        "Version": "2012-10-17",
        "Statement": [
            {
                "Effect": "Allow",
                "Action": [
                    "elasticloadbalancing:DescribeLoadBalancers",
                    "globalaccelerator:DescribeAccelerator",
                    "globalaccelerator:ListAccelerators",
                    "globalaccelerator:ListTagsForResource",
                    "globalaccelerator:TagResource",
                    "globalaccelerator:CreateAccelerator",
                    "globalaccelerator:UpdateAccelerator",
                    "globalaccelerator:DeleteAccelerator",
                    "globalaccelerator:ListListeners",
                    "globalaccelerator:CreateListener",
                    "globalaccelerator:UpdateListener",
                    "globalaccelerator:DeleteListener",
                    "globalaccelerator:ListEndpointGroups",
                    "globalaccelerator:CreateEndpointGroup",
                    "globalaccelerator:UpdateEndpointGroup",
                    "globalaccelerator:DeleteEndpointGroup",
                    "globalaccelerator:AddEndpoints",
                    "globalaccelerator:RemoveEndpoints",
                    "route53:ChangeResourceRecordSets",
                    "route53:ListHostedZones",
                    # canonical casing; the reference's policy says
                    # "ListHostedzonesByName" (IAM matches actions
                    # case-insensitively, so both authorize)
                    "route53:ListHostedZonesByName",
                    "route53:ListResourceRecordSets",
                ],
                "Resource": "*",
            }
        ],
    }


def write_manifests(directory: str) -> list[str]:
    """Regenerate the config tree under ``directory``; returns the
    relative paths written (the ``make manifests`` analog)."""
    written = []

    def emit(relpath: str, doc: dict) -> None:
        path = os.path.join(directory, relpath)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            yaml.safe_dump(doc, fh, sort_keys=True, default_flow_style=False)
        written.append(relpath)

    emit(f"crd/{GROUP}_{PLURAL}.yaml", crd_manifest())
    emit("webhook/manifests.yaml", validating_webhook_manifest())
    emit("rbac/role.yaml", rbac_manifest())
    emit("rbac/service_account.yaml", service_account_manifest())
    emit("rbac/role_binding.yaml", cluster_role_binding_manifest())
    for name, doc in sample_manifests().items():
        emit(f"samples/{name}", doc)

    policy_path = os.path.join(directory, "iam", "policy.json")
    os.makedirs(os.path.dirname(policy_path), exist_ok=True)
    with open(policy_path, "w") as fh:
        json.dump(iam_policy(), fh, indent=2)
        fh.write("\n")
    written.append("iam/policy.json")

    # remove orphans: a manifest renamed or dropped from the builders
    # must disappear from the tree, or the drift check can never catch
    # the stale committed copy — any file of the extension we generate
    # in that subtree and not written this run is stale.  User-placed
    # subdirectories (kustomize overlays) and foreign-extension files
    # are not ours to delete.
    generated_ext = {
        "crd": ".yaml",
        "webhook": ".yaml",
        "rbac": ".yaml",
        "samples": ".yaml",
        "iam": ".json",
    }
    for sub, ext in generated_ext.items():
        subdir = os.path.join(directory, sub)
        if not os.path.isdir(subdir):
            continue
        for entry in os.listdir(subdir):
            rel = f"{sub}/{entry}"
            path = os.path.join(subdir, entry)
            if rel not in written and os.path.isfile(path) and entry.endswith(ext):
                os.remove(path)
    return written
