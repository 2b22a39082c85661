"""Host-side helpers of the port: ephemeris, orbit, velocity, misc,
the archive hook, profiling and structured logging."""

from . import archive, ephemeris, misc, orbit, profiling, slog, velocity
from .profiling import Timer, timeit_fn

__all__ = ["ephemeris", "orbit", "velocity", "misc", "archive",
           "profiling", "slog", "Timer", "timeit_fn"]
