"""spdlog-style logging with the reference CLI's seven levels.

Counterpart of ``ipu_path_trace_tpu/utils/logging.py``.  Every module of
the port logs to ``logging.getLogger(__name__)``, a child of the package
logger ``ipu_path_trace_tpu_torch``, so ``set_log_level`` governs them
all.  The package logger has no handler of its own and propagates: the
CLI installs ``handler()`` on the root logger when the root has none, and
an embedding program's root handlers see the port's records unchanged.
"""

from __future__ import annotations

import logging
import threading

TRACE = 5  # below DEBUG: per-span timings

_LEVELS = {
    "trace": TRACE,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "err": logging.ERROR,
    "critical": logging.CRITICAL,
    "off": logging.CRITICAL + 10,
}
_LETTER = {TRACE: "T", logging.DEBUG: "D", logging.INFO: "I", logging.WARNING: "W",
           logging.ERROR: "E", logging.CRITICAL: "C"}

_logger = logging.getLogger("ipu_path_trace_tpu_torch")


class _Formatter(logging.Formatter):
    """``[%H:%M:%S.%f] [%L] [%t] %v`` (src/main.cpp of the reference)."""

    def __init__(self):
        super().__init__("[%(asctime)s.%(msecs)03d] [%(letter)s] [%(tid)d] %(message)s",
                         "%H:%M:%S")

    def format(self, record):
        record.tid = threading.get_native_id()
        record.letter = _LETTER.get(record.levelno, record.levelname[:1])
        return super().format(record)


def logger() -> logging.Logger:
    return _logger


def handler() -> logging.Handler:
    """A stderr handler with the spdlog-style format."""
    h = logging.StreamHandler()
    h.setFormatter(_Formatter())
    return h


def set_log_level(level: str) -> None:
    """Set one of: trace, debug, info, warn, err, critical, off."""
    if level not in _LEVELS:
        raise ValueError(f"Invalid log-level: '{level}'")
    _logger.setLevel(_LEVELS[level])
