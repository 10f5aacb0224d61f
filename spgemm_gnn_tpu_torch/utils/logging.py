"""Logging (counterpart of `spgemm_gnn_tpu/utils/logging.py`): a file +
stdout logger, and the parameter size in MB."""
from __future__ import annotations

import logging
import sys

from torch import nn


def get_logger(file_path: str | None, name: str = "spgemm_gnn_tpu_torch"):
    logger = logging.getLogger(name)
    logger.handlers.clear()
    formatter = logging.Formatter("%(message)s")
    if file_path:
        fh = logging.FileHandler(file_path)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(formatter)
    logger.addHandler(sh)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    return logger


def param_size(model: nn.Module) -> float:
    """Number of parameters, in millions of 2^20."""
    return sum(p.numel() for p in model.parameters()) / 1024.0 / 1024.0
