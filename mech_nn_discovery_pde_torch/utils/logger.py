"""Named logger with stdout + per-run file handlers (no import-time side
effects: loggers are created explicitly by the experiment scripts).  Copy of
the JAX package's utils/logger.py."""

from __future__ import annotations

import logging
import os
import sys


def setup(path: str, name: str = "main", log_file: str = "log.txt", stdout: bool = True):
    log = logging.getLogger(name)
    log.setLevel(logging.INFO)
    # avoid duplicate handlers on repeated setup
    for h in list(log.handlers):
        log.removeHandler(h)
        h.close()
    if stdout:
        ch = logging.StreamHandler(sys.stdout)
        ch.setFormatter(logging.Formatter("%(message)s"))
        log.addHandler(ch)
    os.makedirs(path, exist_ok=True)
    fh = logging.FileHandler(os.path.join(path, log_file))
    fh.setFormatter(logging.Formatter("%(asctime)s - %(message)s"))
    log.addHandler(fh)
    return log
