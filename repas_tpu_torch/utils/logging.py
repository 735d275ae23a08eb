"""Structured logging with the reference's [TAG]-prefix style.

Port of ``repas_tpu/utils/logging.py``, unchanged.

The reference logs via print() with bracket prefixes ([INTR], [PnP],
[AVG], [CAD], [ICP], [SAVE], [FIX], [WARN] — e.g.
mpa_final_view_with_export.py:315-345). This module provides real loggers
whose format preserves that greppable prefix convention.
"""
from __future__ import annotations

import logging
import os
import sys

_FMT = "[%(name)s] %(message)s"


def get_logger(tag: str) -> logging.Logger:
    name = tag.upper()
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(h)
        logger.setLevel(os.environ.get("REPAS_LOG_LEVEL", "INFO"))
        logger.propagate = False
    return logger
