"""Cloud provider dispatch.

Capability parity with the reference's ``pkg/cloudprovider/provider.go:8-17``:
the trailing two DNS labels of a load-balancer hostname select the
provider; only AWS exists, and the function is the extension seam for
other clouds.
"""

from __future__ import annotations


def detect_cloud_provider(hostname: str) -> str:
    """Return the provider name for an LB hostname, or raise ValueError."""
    parts = hostname.split(".")
    if len(parts) < 2:
        raise ValueError(f"Unknown cloud provider: {hostname}")
    domain = parts[-2] + "." + parts[-1]
    if domain == "amazonaws.com":
        return "aws"
    raise ValueError(f"Unknown cloud provider: {domain}")
