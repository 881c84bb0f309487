"""Logging utilities (reference llava/utils.py:16-90 build_logger and
train.py:47-49 rank0_print); port of ``videollamb_tpu/utils/logging.py``.
``rank0_print`` reads the ``torch.distributed`` rank (0 without a group)."""

from __future__ import annotations

import logging
import logging.handlers
import os
from typing import Optional

import torch.distributed as dist

_handler: Optional[logging.Handler] = None

LOGDIR = os.environ.get("VIDEOLLAMB_LOGDIR", ".")


def rank0_print(*args, **kwargs) -> None:
    if not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0:
        print(*args, **kwargs)


def build_logger(logger_name: str, logger_filename: str) -> logging.Logger:
    """Rotating-file logger; the root logger is mirrored to the file."""
    global _handler

    formatter = logging.Formatter(
        fmt="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO)
    logging.getLogger().handlers[0].setFormatter(formatter)

    if _handler is None:
        os.makedirs(LOGDIR, exist_ok=True)
        _handler = logging.handlers.TimedRotatingFileHandler(
            os.path.join(LOGDIR, logger_filename), when="D", utc=True)
        _handler.setFormatter(formatter)
        for item in logging.root.manager.loggerDict.values():
            if isinstance(item, logging.Logger):
                item.addHandler(_handler)

    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)
    logger.addHandler(_handler)
    return logger


def pretty_print_semaphore(semaphore) -> str:
    if semaphore is None:
        return "None"
    return f"Semaphore(value={semaphore._value}, locked={semaphore.locked()})"
