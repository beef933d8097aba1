"""Logging and timing helpers (counterpart of
``segmif_tpu/utils/logging.py``: the reference's setup_logger and cal_eta,
without the divide-by-zero at iter 0), under the logger name
``segmif_tpu_torch``."""
from __future__ import annotations

import datetime
import logging
import sys
from typing import Optional


def setup_logger(filename: Optional[str] = None,
                 level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger("segmif_tpu_torch")
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s",
                            datefmt="%H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if filename:
        fh = logging.FileHandler(filename)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


def eta(start_time: datetime.datetime, cur_iter: int, max_iter: int):
    """(elapsed_str, eta_str); safe at iter 0."""
    now = datetime.datetime.now().replace(microsecond=0)
    elapsed = now - start_time.replace(microsecond=0)
    done = max(cur_iter, 1)
    remaining = elapsed * max(max_iter - cur_iter, 0) / done
    return str(elapsed), str(datetime.timedelta(seconds=int(
        remaining.total_seconds())))
