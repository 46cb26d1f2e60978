"""Error taxonomy for the reconcile pipeline.

Capability parity with the reference's ``pkg/errors/errors.go:1-40``:
a ``NoRetryError`` marker suppresses the rate-limited requeue that the
reconcile kernel otherwise performs on any processing error, and
``is_no_retry`` walks the exception chain the way Go's ``errors.As``
unwraps wrapped errors (``errors.go:33-39``).

``NotFoundError`` is the analog of apimachinery's IsNotFound: the
reconcile kernel dispatches to the delete path when an object lookup
raises it (reference ``pkg/reconcile/reconcile.go:62-63``).
"""

from __future__ import annotations


class NoRetryError(Exception):
    """An error that must not trigger a rate-limited requeue."""


def no_retry_errorf(fmt: str, *args) -> NoRetryError:
    """Build a NoRetryError from a printf-style format.

    Mirrors ``NewNoRetryErrorf`` (reference ``pkg/errors/errors.go:19-23``).
    """
    return NoRetryError(fmt % args if args else fmt)


def is_no_retry(err: BaseException | None) -> bool:
    """True if ``err`` or any exception in its explicit cause chain
    (``raise ... from inner``) is a NoRetryError.

    Follows only ``__cause__`` — the analog of Go's ``errors.As``
    unwrapping explicit wrapping (reference ``pkg/errors/errors.go:33-39``).
    Implicit ``__context__`` is deliberately ignored: an exception that
    merely *occurred inside* an ``except NoRetryError`` block was not
    wrapped by the raiser and must keep its own retry semantics.
    """
    seen = set()
    while err is not None and id(err) not in seen:
        if isinstance(err, NoRetryError):
            return True
        seen.add(id(err))
        err = err.__cause__
    return False


class NotFoundError(Exception):
    """Raised by cluster/cloud lookups when an object does not exist."""

    def __init__(self, kind: str = "", name: str = ""):
        self.kind = kind
        self.name = name
        super().__init__(f"{kind} {name!r} not found" if kind or name else "not found")


def is_not_found(err: BaseException | None) -> bool:
    return isinstance(err, NotFoundError)


class ConflictError(Exception):
    """Optimistic-concurrency conflict: the object's resourceVersion is
    stale (the apiserver's 409).  Leader election retries on it."""


class AlreadyExistsError(Exception):
    """Create of an object that already exists (the apiserver's 409)."""

