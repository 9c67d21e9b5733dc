"""Logger factory and a silencing context (the counterpart of
``surface_sampling_tpu/utils/logging.py``)."""

from __future__ import annotations

import logging
from pathlib import Path


def setup_logger(
    name: str,
    log_file: str | Path | None = None,
    level: int = logging.INFO,
) -> logging.Logger:
    """Console (and, with ``log_file``, file) logger with the uniform
    '%H:%M:%S - name | LEVEL: msg' format; earlier handlers of ``name`` are
    dropped."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s - %(name)s | %(levelname)s: %(message)s", "%H:%M:%S")
    console = logging.StreamHandler()
    console.setFormatter(fmt)
    logger.addHandler(console)
    if log_file is not None:
        Path(log_file).parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class SilenceLogger:
    """Context manager muting all logging below CRITICAL."""

    def __enter__(self):
        logging.disable(logging.CRITICAL)
        return self

    def __exit__(self, *exc):
        logging.disable(logging.NOTSET)
        return False
