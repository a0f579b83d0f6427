"""The traced run's profiler stretch and its reduction to numbers.

:class:`Stretch` profiles a bounded stretch of the window with
``torch.profiler`` (CPU and CUDA activities), times it on the host
clock between two synchronisations, and writes a Chrome trace under
``TMPDIR``, which :func:`reduce_trace` reads back and deletes.

:func:`reduce_trace` gives, from the trace's events alone:

* ``busy_s``: the length of the union of the intervals in which a
  kernel, a copy or a memset ran on the device;
* ``launches``: the runtime's kernel-launch calls (``cudaLaunch*``,
  ``cuLaunch*``) the host made;
* ``kernel_s(names)``: the device time of the kernels whose names hold
  one of ``names``;
* ``device_ops``: device time summed by operation name, largest first;
* ``idle_gaps``: the gaps between busy intervals, each named by what
  the host issued to end it (the outermost operation around the launch
  of the next kernel, and that kernel), summed by name, largest first.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch")


class Stretch:
    """``with Stretch(sync) as s: ...`` profiles the block; afterwards
    ``s.wall_s`` is its host-clock length and ``s.path`` the trace."""

    def __init__(self, sync, tag: str):
        self.sync = sync
        self.path = os.path.join(tempfile.gettempdir(),
                                 f"rlbench_trace_{tag}_{os.getpid()}.json")
        self.wall_s = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.sync()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.sync()
        self.wall_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._prof.export_chrome_trace(self.path)
        return False


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without ``void `` and its argument list."""
    if name.startswith("void "):
        name = name[5:]
    depth, out = 0, []
    for ch in name:          # drop the parenthesised argument list
        if ch == "(" and depth == 0 and out and out[-1] != "<":
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:width]


class TraceSummary:
    """The numbers a Chrome trace holds for the per-layer readers."""

    def __init__(self, events: Sequence[dict], wall_s: float):
        self.wall_s = wall_s
        dev = [e for e in events if e.get("cat") in DEVICE_CATS
               and "dur" in e]
        self.device = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                        e["name"], e.get("args", {}).get("correlation"))
                       for e in dev]
        self.busy_s = union_length((s, t) for s, t, _, _ in self.device) \
            * 1e-6
        runtime = [e for e in events if e.get("cat") == "cuda_runtime"]
        self.launches = sum(e["name"].startswith(LAUNCH_PREFIXES)
                            for e in runtime)
        self._runtime = {e.get("args", {}).get("correlation"): e
                         for e in runtime}
        # every host operation per thread (``_spans``) and the outermost
        # ones (``_top``), by start, the enclosing one first
        self._spans: Dict[object, List[Tuple[float, float, str]]] = \
            defaultdict(list)
        self._top: Dict[object, List[Tuple[float, float, str]]] = \
            defaultdict(list)
        for s, e, n, tid in sorted(
                ((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                  e["name"], e.get("tid")) for e in events
                 if e.get("cat") == "cpu_op"),
                key=lambda x: (x[0], -x[1])):
            self._spans[tid].append((s, e, n))
            top = self._top[tid]
            if not top or s >= top[-1][1]:
                top.append((s, e, n))
        self._starts = {tid: [s for s, _, _ in top]
                        for tid, top in self._top.items()}

    def kernel_s(self, names: Iterable[str]) -> float:
        names = tuple(names)
        return sum(t - s for s, t, n, _ in self.device
                   if any(k in n for k in names)) * 1e-6

    def device_ops(self, top: int = 10) -> List[List]:
        acc: Dict[str, float] = defaultdict(float)
        for s, t, n, _ in self.device:
            acc[short_name(n)] += (t - s) * 1e-6
        return [[k, v] for k, v in sorted(acc.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def _host_op(self, corr) -> str:
        rt = self._runtime.get(corr)
        if rt is None:
            return "no launch"
        ts, tid = float(rt["ts"]), rt.get("tid")
        i = bisect.bisect_right(self._starts.get(tid, []), ts) - 1
        if i >= 0:
            s, e, n = self._top[tid][i]
            if ts <= e:
                return n
        return rt["name"]

    def idle_gaps(self, top: int = 10) -> List[List]:
        acc: Dict[str, float] = defaultdict(float)
        ivs = sorted(self.device)
        end = None
        for s, t, n, corr in ivs:
            if end is not None and s > end:
                acc[f"{self._host_op(corr)} -> {short_name(n, 48)}"] += \
                    (s - end) * 1e-6
            end = t if end is None else max(end, t)
        if ivs:
            span = (end - ivs[0][0]) * 1e-6
            acc["outside the first and last device op"] += max(
                self.wall_s - span, 0.0)
        return [[k, v] for k, v in sorted(acc.items(),
                                          key=lambda kv: -kv[1])[:top]]


def reduce_trace(path: str, wall_s: float) -> TraceSummary:
    """Read the Chrome trace at ``path`` (and delete it)."""
    with open(path) as f:
        events = json.load(f)
    os.remove(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return TraceSummary(events, wall_s)
