"""Pluggable per-subsystem logging (reference ``logger/logger.go:25-60``).

Counterpart: ``dragonboat_tpu/logger.py``.  A thin shim over the stdlib
``logging`` module keeping the reference's API shape (``get_logger``,
``set_logger_factory``, per-logger levels).
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

CRITICAL = logging.CRITICAL
ERROR = logging.ERROR
WARNING = logging.WARNING
INFO = logging.INFO
DEBUG = logging.DEBUG

_factory: Optional[Callable[[str], logging.Logger]] = None
_loggers: Dict[str, logging.Logger] = {}


def set_logger_factory(factory: Callable[[str], logging.Logger]) -> None:
    global _factory
    _factory = factory
    _loggers.clear()


def get_logger(pkg_name: str) -> logging.Logger:
    if pkg_name not in _loggers:
        if _factory is not None:
            _loggers[pkg_name] = _factory(pkg_name)
        else:
            _loggers[pkg_name] = logging.getLogger(
                f"dragonboat_tpu_torch.{pkg_name}"
            )
    return _loggers[pkg_name]


def set_package_log_level(pkg_name: str, level: int) -> None:
    get_logger(pkg_name).setLevel(level)
