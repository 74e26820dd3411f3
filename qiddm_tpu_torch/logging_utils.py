"""stdout/stderr tee logger (counterpart of ``qiddm_tpu/logging_utils.py``):
the reference's ``Log.py`` (src/mnist_exm.py:19, :325-331), which tees
writes to the terminal and ``./Logs/log-<timestamp>.log``."""

from __future__ import annotations

import os
import sys
import time


class Logger:
    def __init__(self, filename: str, stream=None):
        self.terminal = stream if stream is not None else sys.__stdout__
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        self.log = open(filename, "a", buffering=1)

    def write(self, message):
        self.terminal.write(message)
        self.log.write(message)

    def flush(self):
        self.terminal.flush()
        self.log.flush()

    def isatty(self):
        return False


def initial_log(log_path: str = "./Logs/") -> str:
    """Install tee loggers on stdout and stderr. Each tees the stream that
    is current (a caller's redirection keeps working) and replaces an
    earlier Logger instead of stacking on it."""
    os.makedirs(log_path, exist_ok=True)
    name = os.path.join(
        log_path, "log-" + time.strftime("%Y%m%d-%H%M", time.localtime())
        + ".log")
    for stream in ("stdout", "stderr"):
        current = getattr(sys, stream)
        if isinstance(current, Logger):
            current.log.close()
            current = current.terminal
        setattr(sys, stream, Logger(name, current))
    return name
