"""Structured logging.

The reference leaves bare ``println!`` debug statements in production paths
(reference: stark.rs:412,445,466,499-714, fri.rs:280-309); this framework
routes everything through a standard logger that is silent by default and
configurable via ``STARK_TPU_TORCH_LOG`` (e.g. ``STARK_TPU_TORCH_LOG=debug``).
"""

from __future__ import annotations

import logging
import os

_CONFIGURED = False


def get_logger(name: str = "stark_tpu_torch") -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        level_name = os.environ.get("STARK_TPU_TORCH_LOG", "warning").upper()
        level = getattr(logging, level_name, logging.WARNING)
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(name)s %(levelname)s %(message)s",
                datefmt="%H:%M:%S",
            )
        )
        root = logging.getLogger("stark_tpu_torch")
        root.addHandler(handler)
        root.setLevel(level)
        _CONFIGURED = True
    return logging.getLogger(name)
