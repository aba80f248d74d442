"""Rank-0-gated logging, the port's copy of ``lrce_tpu/utils/logging.py``.

The port runs one process per card; process 0 gets a real logger and any
other process a no-op object.
"""

from __future__ import annotations

import logging


def setup_logging() -> None:
    logging.basicConfig(level=logging.INFO)


class _NoOp:
    """Swallows every attribute access / call (non-primary processes)."""

    def __getattr__(self, *args):
        def no_op(*a, **k):
            pass

        return no_op


def get_logger(name: str, process_index: int = 0):
    """A real logger on process 0, a no-op object elsewhere."""
    if process_index == 0:
        return logging.getLogger(name)
    return _NoOp()
