"""Validating admission webhook — a separate process from the
controller, like the reference's ``webhook`` subcommand.

Capability parity with ``pkg/webhoook/`` [sic] (161 LoC): a plain
stdlib HTTP(S) server with two routes — ``/healthz`` and
``/validate-endpointgroupbinding`` — and a validator enforcing
``spec.endpointGroupArn`` immutability on UPDATE.
"""

from .server import Server, make_server
from .validator import validate

__all__ = ["Server", "make_server", "validate"]
