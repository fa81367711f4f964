"""Host utilities of the port: logger, profiler, statistics."""

from .logger import Level, Logger
from .profiler import Profiler, null_profiler
from .statistics import Statistics

__all__ = ["Logger", "Level", "Profiler", "null_profiler", "Statistics"]
