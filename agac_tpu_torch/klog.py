"""Verbosity-gated logging, the analog of k8s.io/klog/v2.

The reference logs exclusively through klog with ``--v`` gated detail
(e.g. per-item sync timing at verbosity 4, reference
``pkg/reconcile/reconcile.go:52-55``).  This module provides the same
surface on top of the stdlib ``logging`` package:

    klog.v(4).infof("Finished syncing %q (%v)", key, elapsed)
    klog.infof / warningf / errorf / fatalf

Verbosity is process-global and set from the CLI's ``-v`` flag
(reference wires klog flags at ``cmd/root.go:20-24``).
"""

from __future__ import annotations

import logging
import sys
import threading

_logger = logging.getLogger("agac")
_verbosity = 0
_lock = threading.Lock()
_configured = False


def init(verbosity: int = 0, stream=None) -> None:
    """Configure the process-global logger.  Safe to call repeatedly;
    a later call may change verbosity and/or redirect the stream."""
    global _verbosity, _configured
    with _lock:
        _verbosity = verbosity
        if not _configured:
            handler = logging.StreamHandler(stream or sys.stderr)
            handler.setFormatter(
                logging.Formatter(
                    fmt="%(levelname).1s%(asctime)s.%(msecs)03d %(name)s %(message)s",
                    datefmt="%m%d %H:%M:%S",
                )
            )
            _logger.addHandler(handler)
            _logger.setLevel(logging.DEBUG)
            _logger.propagate = False
            _configured = True
        elif stream is not None:
            for handler in _logger.handlers:
                if isinstance(handler, logging.StreamHandler):
                    handler.setStream(stream)


def verbosity() -> int:
    return _verbosity


class _V:
    """A verbosity-gated handle, the analog of ``klog.V(n)``."""

    def __init__(self, level: int):
        self._enabled = level <= _verbosity

    def enabled(self) -> bool:
        return self._enabled

    def infof(self, fmt: str, *args) -> None:
        if self._enabled:
            _logger.info(fmt % args if args else fmt)


def v(level: int) -> _V:
    return _V(level)


def infof(fmt: str, *args) -> None:
    _logger.info(fmt % args if args else fmt)


def info(msg: str) -> None:
    _logger.info(msg)


def warningf(fmt: str, *args) -> None:
    _logger.warning(fmt % args if args else fmt)


def warning(msg) -> None:
    _logger.warning(str(msg))


def errorf(fmt: str, *args) -> None:
    _logger.error(fmt % args if args else fmt)


def error(msg) -> None:
    _logger.error(str(msg))


def fatalf(fmt: str, *args) -> None:
    _logger.critical(fmt % args if args else fmt)
    raise SystemExit(255)
