"""Rank-aware logging.

Counterpart of the JAX package's ``utils/logger.py``: ``create_logger`` gives
per-module loggers that log below ERROR only on the main process;
``set_logger`` tees stdout and stderr to a timestamped file under ``./log/``.
"""
from __future__ import annotations

import logging
import os
import sys
import time
from typing import Optional

from ..parallel.distribute import is_main_process


def create_logger(name: str, terminal_level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(terminal_level if is_main_process() else logging.ERROR)
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(handler)
    logger.propagate = False
    return logger


class _Tee:
    def __init__(self, stream, f):
        self.stream = stream
        self.f = f

    def write(self, data):
        self.stream.write(data)
        self.f.write(data)

    def flush(self):
        self.stream.flush()
        self.f.flush()


def set_logger(info: str, log_dir: str = "./log") -> Optional[str]:
    """Tee stdout/stderr to ``log/<info>-<timestamp>.log`` (main process)."""
    if not is_main_process():
        return None
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{info}-{time.strftime('%Y%m%d-%H%M%S')}.log")
    f = open(path, "a")
    sys.stdout = _Tee(sys.__stdout__, f)
    sys.stderr = _Tee(sys.__stderr__, f)
    return path
