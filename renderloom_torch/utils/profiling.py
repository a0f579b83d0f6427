"""Tracing and step timing.

Port of the JAX package's ``renderloom/utils/profiling.py``:

* :func:`trace` — ``torch.profiler`` (host and, where there is one, the
  CUDA device) over a block of steps, written to ``log_dir`` as a Chrome
  trace (``trace_<n>.json``, open it in Perfetto or ``chrome://tracing``)
  with the kernel-time table beside it (``key_averages_<n>.txt``);
* :func:`annotate` — a named span in that trace
  (``torch.profiler.record_function``), so host stages show up beside
  device work;
* :class:`StepTimer` — an exponential-moving-average step timer.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block and write its trace into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    n = len([f for f in os.listdir(log_dir) if f.startswith("trace_")])
    with profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{n}.json"))
    sort = "cuda_time_total" if len(activities) > 1 else "cpu_time_total"
    with open(os.path.join(log_dir, f"key_averages_{n}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=40))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named span inside an active trace."""
    with torch.profiler.record_function(name):
        yield


class StepTimer:
    """Exponential-moving-average step timer."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema: Optional[float] = None
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        """Call once per step; returns the EMA step seconds."""
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.ema = dt if self.ema is None else \
                (1 - self.alpha) * self.ema + self.alpha * dt
        self._last = now
        return self.ema

    def rate(self, items: int = 1) -> Optional[float]:
        return None if not self.ema else items / self.ema
