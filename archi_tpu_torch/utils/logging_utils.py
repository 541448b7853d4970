"""Central logging with verbosity levels.

Copy of ``archi_tpu/utils/logging_utils.py``.

Mirrors the reference's logger setup (``src/utils/logging.py:6-60``): a 0-4
verbosity scale mapped to logging levels (driven by the VERBOSITY env per
service, ``base-compose.yaml:24``), consistent formatting, and module-level
debug suppression for noisy third-party loggers.
"""

from __future__ import annotations

import logging
import os
import sys

VERBOSITY_LEVELS = {
    0: logging.CRITICAL,
    1: logging.ERROR,
    2: logging.WARNING,
    3: logging.INFO,
    4: logging.DEBUG,
}

_NOISY = ("urllib3", "requests", "jax", "absl", "filelock")
_configured = False


def setup_logging(verbosity: int | None = None) -> None:
    global _configured
    if verbosity is None:
        try:
            verbosity = int(os.environ.get("VERBOSITY", "3"))
        except ValueError:
            verbosity = 3
    level = VERBOSITY_LEVELS.get(max(0, min(4, verbosity)), logging.INFO)
    root = logging.getLogger()
    root.setLevel(level)
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s: %(message)s",
            datefmt="%H:%M:%S",
        ))
        root.addHandler(handler)
        _configured = True
    for name in _NOISY:
        logging.getLogger(name).setLevel(max(level, logging.WARNING))


def get_logger(name: str) -> logging.Logger:
    if not _configured:
        setup_logging()
    return logging.getLogger(name)
