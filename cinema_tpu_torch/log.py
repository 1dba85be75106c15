"""The logger of the port's preprocessing CLIs (port of ``get_logger``, cinema_tpu/log.py:15-32)."""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s | %(levelname)s | %(process)d | %(name)s | %(message)s"


def get_logger(name: str) -> logging.Logger:
    """A logger named ``name`` that writes to stdout at INFO, with one stream handler and no propagation."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger
