"""Logging and wall-clock timing helpers."""

from .logging import get_logger
from .profiling import Timer

__all__ = ["Timer", "get_logger"]
