"""Structured logging (≙ reference logger/ — zerolog global with
disable/override, logger/logger.go:17-40; auto-quiet under pytest).

Copied from gnark_icicle_tpu/logger.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations

import logging
import os
import sys

_logger: logging.Logger | None = None


def logger() -> logging.Logger:
    global _logger
    if _logger is None:
        lg = logging.getLogger("gnark_icicle_tpu")
        if not lg.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(
                logging.Formatter("%(asctime)s %(levelname).3s %(message)s",
                                  "%H:%M:%S")
            )
            lg.addHandler(h)
        # quiet under test runners, like the reference's go-test detection
        quiet = "PYTEST_CURRENT_TEST" in os.environ or "pytest" in sys.modules
        lg.setLevel(logging.WARNING if quiet else logging.INFO)
        _logger = lg
    return _logger


def set_logger(lg: logging.Logger):
    global _logger
    _logger = lg


def disable():
    logger().setLevel(logging.CRITICAL + 1)
