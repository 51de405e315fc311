"""Tracing / profiling utilities.

The reference's instrumentation is a pair of cudaProfilerStart/Stop
brackets (libcudasph/sph_simulation.cu:186,312) and a wall-clock print
(example/particles.cpp:102-109). JAX equivalents:

* :func:`trace` — context manager around ``jax.profiler.trace`` writing
  a TensorBoard-loadable trace directory;
* :func:`annotate` — named ``TraceAnnotation`` for phases (sort,
  density, forces, advect) that show up on the device timeline;
* :class:`StepTimer` — wall-clock step timing that ends each lap with a
  device fetch, so a lap never measures only the enqueue.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import jax
import numpy as np


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a device profile into ``logdir`` (TensorBoard format)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Phase annotation context manager (shows on the trace timeline)."""
    return jax.profiler.TraceAnnotation(name)


class StepTimer:
    """Wall-clock timing with enforced device synchronisation.

    Usage::

        timer = StepTimer()
        for _ in range(k):
            state, dt, _ = substep_jit(...)
            timer.lap(dt)          # fetches the scalar -> true sync
        print(timer.summary())
    """

    def __init__(self):
        self._laps: list[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def lap(self, sync_value) -> float:
        """Record one lap, forcing ``sync_value`` to the host."""
        if self._t0 is None:
            self.start()
        np.asarray(sync_value)  # real fetch = real completion
        now = time.perf_counter()
        dt = now - self._t0
        self._laps.append(dt)
        self._t0 = now
        return dt

    @property
    def laps(self) -> list[float]:
        return list(self._laps)

    def summary(self) -> dict:
        if not self._laps:
            return {"count": 0}
        arr = np.asarray(self._laps)
        return {
            "count": int(arr.size),
            "mean_ms": float(arr.mean() * 1000),
            "median_ms": float(np.median(arr) * 1000),
            "p90_ms": float(np.percentile(arr, 90) * 1000),
            "min_ms": float(arr.min() * 1000),
            "max_ms": float(arr.max() * 1000),
        }
