"""Run-dir + logger utilities (ref utils.py:7-51 semantics): the port's own
copy of ``msa_tpu/utils/logging.py``, logging under the name
``msa_tpu_torch``."""

from __future__ import annotations

import datetime
import logging
import os
from typing import Tuple


def get_logger(log_path: str = "./logs", name: str = "msa_tpu_torch") -> Tuple[logging.Logger, str]:
    """Date-indexed file logger + stream handler (ref utils.py:7-33)."""
    os.makedirs(log_path, exist_ok=True)
    logger = logging.getLogger(name)
    logger.handlers.clear()
    fmt = logging.Formatter(
        "[%(levelname)s|%(filename)s:%(lineno)s] %(asctime)s %(message)s",
        "%Y-%m-%d %H:%M:%S",
    )
    today = datetime.datetime.now().strftime("%Y%m%d")
    i = 0
    while os.path.exists(os.path.join(log_path, f"log-{today}-{i:02d}.log")):
        i += 1
    path = os.path.join(log_path, f"log-{today}-{i:02d}.log")
    fh = logging.FileHandler(path)
    sh = logging.StreamHandler()
    fh.setFormatter(fmt)
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    logger.info("Writing logs at %s", path)
    return logger, path


def make_date_dir(path: str) -> str:
    """Collision-free dated run dir (ref utils.py:35-51)."""
    os.makedirs(path, exist_ok=True)
    today = datetime.datetime.now().strftime("%Y%m%d")
    i = 0
    while os.path.exists(os.path.join(path, f"{today}-{i:02d}")):
        i += 1
    out = os.path.join(path, f"{today}-{i:02d}")
    os.makedirs(out)
    return out
