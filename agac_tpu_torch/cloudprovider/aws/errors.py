"""AWS API error model.

The reference distinguishes AWS failures by smithy error code
(``awsErr.ErrorCode() == ErrEndpointGroupNotFoundException``,
reference ``pkg/controller/endpointgroupbinding/reconcile.go:48-64``)
and by typed not-found exceptions
(``gatypes.ListenerNotFoundException`` handling in
``pkg/cloudprovider/aws/global_accelerator.go:296-310``).  Here every
API error carries a ``code``; the two not-found codes the drivers
branch on get their own subclasses.
"""

from __future__ import annotations


ERR_LISTENER_NOT_FOUND = "ListenerNotFoundException"
ERR_ENDPOINT_GROUP_NOT_FOUND = "EndpointGroupNotFoundException"
ERR_ACCELERATOR_NOT_FOUND = "AcceleratorNotFoundException"
ERR_ACCELERATOR_NOT_DISABLED = "AcceleratorNotDisabledException"
ERR_ASSOCIATED_LISTENER_FOUND = "AssociatedListenerFoundException"
ERR_ASSOCIATED_ENDPOINT_GROUP_FOUND = "AssociatedEndpointGroupFoundException"
ERR_LOAD_BALANCER_NOT_FOUND = "LoadBalancerNotFound"
ERR_NO_SUCH_HOSTED_ZONE = "NoSuchHostedZone"
ERR_INVALID_CHANGE_BATCH = "InvalidChangeBatch"
ERR_INVALID_ARGUMENT = "InvalidArgumentException"
ERR_INVALID_PORT_RANGE = "InvalidPortRangeException"
ERR_LIMIT_EXCEEDED = "LimitExceededException"


class AWSAPIError(Exception):
    """An AWS API failure with a service error code."""

    def __init__(self, code: str, message: str = ""):
        self.code = code
        super().__init__(f"{code}: {message}" if message else code)


class ListenerNotFoundException(AWSAPIError):
    def __init__(self, message: str = ""):
        super().__init__(ERR_LISTENER_NOT_FOUND, message)


class EndpointGroupNotFoundException(AWSAPIError):
    def __init__(self, message: str = ""):
        super().__init__(ERR_ENDPOINT_GROUP_NOT_FOUND, message)


def aws_error_code(err: BaseException) -> str:
    """The smithy ``ErrorCode()`` analog: empty for non-AWS errors."""
    return err.code if isinstance(err, AWSAPIError) else ""
