"""Console printing and a phase timer (copy of ``visreps_tpu/core/logging.py``,
trimmed to what the eval uses)."""
from __future__ import annotations

import os
import sys
import time

_STYLES = {
    "info": "\033[1;37m",
    "success": "\033[32m",
    "warning": "\033[1;33m",
    "error": "\033[1;31m",
    "highlight": "\033[1;35m",
    "setup": "\033[36m",
}
_RESET = "\033[0m"


def _interactive() -> bool:
    if os.environ.get("SLURM_JOB_ID") is not None:
        return False
    try:
        return sys.stdout.isatty()
    except (AttributeError, ValueError):
        return False


def rprint(msg: str = "", style: str | None = None) -> None:
    if style in _STYLES and _interactive():
        print(f"{_STYLES[style]}{msg}{_RESET}")
    else:
        print(msg)


class Timer:
    """Wall-clock phase timer: ``mark(name)`` returns the seconds since
    the previous mark (or construction)."""

    def __init__(self):
        self._start = time.perf_counter()

    def mark(self, name: str) -> float:
        now = time.perf_counter()
        elapsed = now - self._start
        self._start = now
        return elapsed
