"""Rank-aware logging + tensorboard writer
(ref: util/common_utils.py:316-330, tensorboardX usage tool/train.py).

A copy of ``doda_tpu/utils/logging.py``, logging as ``doda_tpu_torch``."""

from __future__ import annotations

import logging


def get_logger(log_file=None, rank=0, log_level=logging.INFO):
    """(ref: util/common_utils.py:316-330)"""
    logger = logging.getLogger('doda_tpu_torch')
    logger.setLevel(log_level if rank == 0 else logging.ERROR)
    logger.handlers.clear()
    fmt = '[%(asctime)s %(levelname)s %(filename)s %(process)d] %(message)s'
    console = logging.StreamHandler()
    console.setLevel(log_level if rank == 0 else logging.ERROR)
    console.setFormatter(logging.Formatter(fmt))
    logger.addHandler(console)
    if log_file is not None:
        fh = logging.FileHandler(filename=str(log_file))
        fh.setLevel(log_level if rank == 0 else logging.ERROR)
        fh.setFormatter(logging.Formatter(fmt))
        logger.addHandler(fh)
    logger.propagate = False
    return logger


def make_writer(log_dir, rank=0):
    """TensorBoard scalar writer; no-op off rank 0 or when tensorboardX
    is unavailable."""
    if rank != 0:
        return _NullWriter()
    try:
        from tensorboardX import SummaryWriter
        return SummaryWriter(str(log_dir))
    except ImportError:
        return _NullWriter()


class _NullWriter:
    def add_scalar(self, *a, **k):
        pass

    def close(self):
        pass
