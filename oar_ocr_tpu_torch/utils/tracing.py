"""Per-stage timing and logging.

Copied from ``oar_ocr_tpu/utils/tracing.py:19-61`` (``logger``,
``StageMetrics``, ``METRICS``, ``stage_timer``); the logger is the
port's own, named ``oar_ocr_tpu_torch``. ``METRICS`` accumulates host
wall time per stage; ``tools/port_profile.py`` reads it back.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

logger = logging.getLogger("oar_ocr_tpu_torch")
if os.environ.get("OAR_LOG"):
    logging.basicConfig(level=os.environ["OAR_LOG"].upper())


class StageMetrics:
    """Thread-safe accumulator of per-stage wall times."""

    def __init__(self):
        self._lock = threading.Lock()
        self._times: Dict[str, List[float]] = defaultdict(list)

    def record(self, stage: str, seconds: float) -> None:
        with self._lock:
            self._times[stage].append(seconds)

    def summary(self) -> Dict[str, Tuple[int, float, float]]:
        """stage → (count, total_s, mean_s)."""
        with self._lock:
            return {
                k: (len(v), sum(v), sum(v) / len(v))
                for k, v in self._times.items() if v
            }

    def reset(self) -> None:
        with self._lock:
            self._times.clear()


METRICS = StageMetrics()


@contextlib.contextmanager
def stage_timer(stage: str, **ctx) -> Iterator[None]:
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        METRICS.record(stage, dt)
        if logger.isEnabledFor(logging.DEBUG):
            extra = " ".join(f"{k}={v}" for k, v in ctx.items())
            logger.debug("%s took %.2f ms %s", stage, dt * 1e3, extra)
