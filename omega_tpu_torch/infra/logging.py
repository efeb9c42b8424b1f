"""Logging — the spdlog analogue (infra/Logging.h:24-97).

Per-task log files aren't needed: the port runs as one process (rank 0),
so messages go to one stream or file.
"""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "[%(asctime)s] [%(levelname)s] [%(filename)s:%(lineno)d] %(message)s"


def init_logging(level: str = None, logfile: str | None = None) -> logging.Logger:
    level = level or os.environ.get("OMEGA_LOG_LEVEL", "INFO")
    logger = logging.getLogger("omega_tpu_torch")
    logger.setLevel(getattr(logging, level.upper()))
    if not logger.handlers:
        handler = (logging.FileHandler(logfile) if logfile
                   else logging.StreamHandler(sys.stderr))
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
    return logger


def get_logger() -> logging.Logger:
    return logging.getLogger("omega_tpu_torch")
