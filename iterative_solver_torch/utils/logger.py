"""Leveled logger mirroring the reference's itsolv::Logger (Logger.h:40-70); a copy of
iterative_solver_tpu/utils/logger.py."""

from __future__ import annotations

import enum
import sys
from typing import Iterable


class Level(enum.IntEnum):
    NONE = 0
    FATAL = 1
    ERROR = 2
    WARN = 3
    INFO = 4
    DEBUG = 5
    TRACE = 6


class Logger:
    """Message sink with independent error/trace ceilings and a data-dump flag."""

    def __init__(
        self,
        max_trace_level: Level = Level.NONE,
        max_warn_level: Level = Level.ERROR,
        data_dump: bool = False,
        stream=None,
    ):
        self.max_trace_level = Level(max_trace_level)
        self.max_warn_level = Level(max_warn_level)
        self.data_dump = data_dump
        self.stream = stream if stream is not None else sys.stdout

    def msg(self, message: str, level: Level = Level.INFO) -> None:
        level = Level(level)
        if level >= Level.INFO:
            if level <= self.max_trace_level:
                print(message, file=self.stream)
        elif level <= self.max_warn_level:
            print(message, file=self.stream)

    def msg_values(self, message: str, values: Iterable, level: Level = Level.INFO) -> None:
        self.msg(message + " ".join(f"{v:.6g}" if isinstance(v, float) else str(v) for v in values), level)

    def scientific(self, value: float) -> str:
        return f"{value:e}"
