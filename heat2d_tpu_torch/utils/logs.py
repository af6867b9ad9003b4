"""The ``--log-level`` flag the port's CLIs share (the JAX CLIs'
``--log-level``): a level for the ``heat2d_tpu_torch`` loggers, with
timestamps, on standard error."""

from __future__ import annotations

import argparse
import logging
from typing import Optional

LOG_LEVELS = ("debug", "info", "warning", "error")


def add_log_level_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--log-level", default=None, choices=LOG_LEVELS,
                        help="log the heat2d_tpu_torch loggers at this "
                             "level")


def configure_logging(level: Optional[str]) -> None:
    """Set the ``heat2d_tpu_torch`` loggers to ``level``; None leaves the
    logging configuration alone."""
    if not level:
        return
    logging.basicConfig(
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    logging.getLogger("heat2d_tpu_torch").setLevel(
        getattr(logging, level.upper()))
