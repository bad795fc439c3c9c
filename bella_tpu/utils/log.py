"""Structured run logging: the printLog macro + omp_get_wtime() phase
spans of the reference (include/common/common.h:40-44 and the timers
sprinkled through src/main.cpp / include/overlap.hpp), as one utility."""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict

_ENABLED = True
PHASE_SECONDS: Dict[str, float] = {}
LAST: Dict[str, object] = {}  # last value logged under each name


def set_enabled(flag: bool) -> None:
    global _ENABLED
    _ENABLED = flag


def log(name: str, value) -> None:
    LAST[name] = value
    if _ENABLED:
        print(f"INFO:\t{name} = {value}", file=sys.stderr, flush=True)


@contextlib.contextmanager
def phase(name: str):
    """Time a pipeline phase; records into PHASE_SECONDS and logs."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + dt
        log(f"{name}Time", f"{dt:.3f} seconds")
