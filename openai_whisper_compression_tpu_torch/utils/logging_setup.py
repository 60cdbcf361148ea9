"""Logging configuration: console + shared `whisper_eval.log` file, matching
the reference's setup (`memory_tracker.py:14-18`, `quantization.py:22-26`)."""

from __future__ import annotations

import logging


def setup_logging(log_file: str | None = "whisper_eval.log",
                  level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger("whisper_eval")
    if logger.handlers:  # idempotent
        return logger
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        try:
            fh = logging.FileHandler(log_file)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
        except OSError:
            pass
    return logger
