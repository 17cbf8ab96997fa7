"""Structured logging.

Counterpart of ``python_audio_mastering_tpu.utils.logging``.
:func:`get_logger` returns a stdlib logger with human-readable or JSON-line
records (``PAM_LOG_FORMAT=json``, the form a log collector of the serving
deployment reads).  The reference engine's one quantitative line, the
loudness measurement (engine:221), goes through :func:`log_loudness` so
that scrapers of that line keep working.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

__all__ = ["get_logger", "log_loudness"]


class _JsonFormatter(logging.Formatter):
    def format(self, record):
        payload = {
            "ts": round(time.time(), 3),
            "severity": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        extra = getattr(record, "extra_fields", None)
        if extra:
            payload.update(extra)
        return json.dumps(payload)


def get_logger(name: str = "pam") -> logging.Logger:
    """The logger ``name``, given one stdout handler at first use: JSON
    records when ``PAM_LOG_FORMAT=json``, the level from ``PAM_LOG_LEVEL``
    (INFO by default)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        if os.environ.get("PAM_LOG_FORMAT") == "json":
            handler.setFormatter(_JsonFormatter())
        else:
            handler.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("PAM_LOG_LEVEL", "INFO"))
        logger.propagate = False
    return logger


def log_loudness(logger: logging.Logger, measured: float, gain_db: float):
    """The reference engine's loudness line (engine:221)."""
    logger.info("Current loudness: %.2f LUFS. Applying %.2f dB gain...",
                measured, gain_db)
