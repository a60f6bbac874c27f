"""Loggers (reference mr_gen/utils/logger_gen.py:7-33); a copy of
``multimodalreactiongeneration_tpu/utils/logging.py``."""

from __future__ import annotations

import logging
import os
from datetime import datetime


def set_logger(name: str, log_dir: str = "log") -> logging.Logger:
    """Timestamped file + stream handlers (reference :7-29)."""
    os.makedirs(log_dir, exist_ok=True)
    ts = datetime.now().strftime("%Y%m%d%H%M%S")
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        fh = logging.FileHandler(os.path.join(log_dir, f"main.log.{ts}"))
        sh = logging.StreamHandler()
        fmt = logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s: %(message)s"
        )
        fh.setFormatter(fmt)
        sh.setFormatter(fmt)
        logger.addHandler(fh)
        logger.addHandler(sh)
    return logger


class DummyLogger:
    """No-op logger for headless builders (reference :32-33)."""

    def info(self, *args, **kwargs):
        pass

    def warning(self, *args, **kwargs):
        pass

    def error(self, *args, **kwargs):
        pass

    def debug(self, *args, **kwargs):
        pass
