"""Logging setup (port of oatx/utils/logging.py, the reference logger/logger.py:
console + rotating file handlers; the console on process 0 only)."""

from __future__ import annotations

import logging
import logging.handlers
import sys
from pathlib import Path
from typing import Optional

VERBOSITY = {0: logging.WARNING, 1: logging.INFO, 2: logging.DEBUG}


def setup_logging(
    log_dir: Optional[str | Path] = None,
    name: str = "oatx_torch",
    verbosity: int = 2,
    process_index: int = 0,
) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(VERBOSITY.get(verbosity, logging.DEBUG))
    logger.propagate = False
    if logger.handlers:
        return logger

    fmt = logging.Formatter("%(asctime)s %(levelname).1s %(name)s: %(message)s",
                            datefmt="%H:%M:%S")
    if process_index == 0:  # console on the lead host only
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_dir is not None:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        fh = logging.handlers.RotatingFileHandler(
            Path(log_dir) / f"info_p{process_index}.log",
            maxBytes=10 * 1024 * 1024, backupCount=5)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    return logger
