"""Logger, meters and small filesystem helpers.

Counterpart of ``dyadic_interaction_modeling_tpu/utils/logging.py`` (the
reference's ``base/utilities.py:24-66``). The main process is rank 0 of
``torch.distributed`` when a process group is up, else the only process.
"""

from __future__ import annotations

import logging
import os


def get_logger(name: str = "main-logger") -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    handler = logging.StreamHandler()
    fmt = "[%(asctime)s %(levelname)s %(filename)s line %(lineno)d %(process)d]=>%(message)s"
    handler.setFormatter(logging.Formatter(fmt))
    logger.addHandler(handler)
    logger.propagate = False
    return logger


class AverageMeter:
    """Computes and stores the average and current value."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def check_makedirs(dir_name: str) -> None:
    os.makedirs(dir_name, exist_ok=True)


def main_process() -> bool:
    """True in the process that should log and save: rank 0, or the only one."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
