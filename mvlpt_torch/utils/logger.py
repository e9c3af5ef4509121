"""Run logging: mirrors the reference's log.txt-in-OUTPUT_DIR behavior.

The counterpart of ``mvlpt_tpu/utils/logger.py``. The reference calls
Dassl's ``setup_logger(cfg.OUTPUT_DIR)`` (train.py:199), which tees
stdout into ``<OUTPUT_DIR>/log.txt``; result scrapers
(scripts/read_record.py:50-96) parse that file. The port keeps the same
file name and the same ``results {...}`` print contract.
"""

from __future__ import annotations

import logging
import os
import sys
import time


_LOGGER_NAME = "mvlpt_torch"


def get_logger() -> logging.Logger:
    return logging.getLogger(_LOGGER_NAME)


class _Tee:
    """Duplicate a text stream into a file (stdout tee, like Dassl's Logger)."""

    def __init__(self, stream, fpath):
        self.stream = stream
        self.file = open(fpath, "a")

    def retarget(self, fpath):
        self.file.close()
        self.file = open(fpath, "a")

    def write(self, msg):
        self.stream.write(msg)
        self.file.write(msg)
        self.file.flush()

    def flush(self):
        self.stream.flush()
        self.file.flush()


def setup_logger(output_dir: str | None = None) -> logging.Logger:
    logger = get_logger()
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)
    fmt = logging.Formatter("%(message)s")
    # bind to the raw terminal stream, not a _Tee from a previous call —
    # a tee'd StreamHandler would write every logger line to log.txt
    # twice (once via the tee, once via the FileHandler)
    stream = sys.stdout.stream if isinstance(sys.stdout, _Tee) else sys.stdout
    sh = logging.StreamHandler(stream)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fpath = os.path.join(output_dir, "log.txt")
        if os.path.exists(fpath):
            # Keep old logs around, like Dassl's time-suffixed backups.
            ts = time.strftime("-%Y-%m-%d-%H-%M-%S")
            os.rename(fpath, fpath + ts)
        fh = logging.FileHandler(fpath)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
        # Also tee raw prints (the `results {...}` contract is print-based).
        if isinstance(sys.stdout, _Tee):
            sys.stdout.retarget(fpath)
        else:
            sys.stdout = _Tee(sys.stdout, fpath)
    return logger
