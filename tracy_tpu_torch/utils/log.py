"""Logging (equivalent of reference TracyLog, src/log.h:12-25, plus levels).

A copy of tracy_tpu/utils/log.py: the same logger name and format, so the
two packages' messages read alike.
"""

from __future__ import annotations

import logging
import sys

_logger = logging.getLogger("tracy_tpu")
if not _logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("[tracy-tpu] %(message)s"))
    _logger.addHandler(_h)
    _logger.setLevel(logging.INFO)


def log(msg: str, *args):
    _logger.info(msg % args if args else msg)


def warn(msg: str, *args):
    _logger.warning(msg % args if args else msg)


def set_verbosity(level: int):
    _logger.setLevel(level)
