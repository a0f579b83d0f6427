"""The profiled stretch's device time split by the program's stages.

The program marks its stages with spans (``renderloom_torch.utils.
profiling.annotate``), which the trace holds as host operations named
after the stage (``cpu_op``), outermost on the thread that ran them or
nested in another span.  :func:`split` reads them from a
:class:`rlbench.trace.TraceSummary` (its host operations per thread,
its runtime calls and its device intervals) and places each device
interval in a stage:

* the interval's correlation id gives the runtime call that launched
  it; the stage is the span of those asked for whose ``[start, end]``
  holds that call's timestamp, on any thread (backward kernels are
  launched from autograd's device thread while the main thread waits
  inside the stage's span); where spans overlap, the one that started
  last wins, so a launch inside a nested stage is the innermost's, and
  the outer stage keeps what its nested stages do not hold;
* **busy**: the length of the stage's device intervals, each counted
  where no earlier interval already covered it, so that busy time
  spread over overlapping streams is counted once;
* **idle**: each gap between busy intervals is charged to the stage of
  the launch that ends it (the rule ``TraceSummary.idle_gaps`` names
  gaps by);
* **launches**: the kernel-launch calls made inside the stage;
* **syncs**: the runtime calls that block the host on the device
  (:data:`SYNC_CALLS`, matched by exact name, so ``cudaMemcpyAsync`` is
  not one) made inside the stage.

Whatever falls in no span is :data:`OUTSIDE`: the stretch's own
synchronisations, the benchmark's input draw, and the stretch's lead and
tail (its host-clock length less the device's first-to-last span).  So
the stages' busy plus the outside busy is ``busy_s``, and their idle
plus the outside idle is ``wall_s − busy_s``.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, Optional, Tuple

from rlbench.trace import LAUNCH_PREFIXES, TraceSummary

SYNC_CALLS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"))
OUTSIDE = "outside"
SERVE = ("pipeline.motion", "pipeline.background", "pipeline.label",
         "pipeline.rollout")
TRAIN = ("gan.prep", "gan.g_forward", "gan.d_step", "gan.g_step")
FIELDS = ("busy_s", "idle_s", "launches", "syncs")


class _Spans:
    """Which named span holds a host timestamp, on any thread."""

    def __init__(self, spans):
        # by start, the enclosing span first where two start together
        self.spans = sorted(spans, key=lambda x: (x[0], -x[1], x[2]))
        self.starts = [s for s, _, _ in self.spans]
        self.reach = []                     # the latest end so far
        for _, e, _ in self.spans:
            self.reach.append(max(e, self.reach[-1]) if self.reach else e)

    def at(self, ts: Optional[float]) -> str:
        if ts is None:
            return OUTSIDE
        i = bisect.bisect_right(self.starts, ts) - 1
        while i >= 0 and self.reach[i] >= ts:
            s, e, name = self.spans[i]
            if ts <= e:
                return name
            i -= 1
        return OUTSIDE


def split(summary: TraceSummary, stages: Iterable[str]
          ) -> Dict[str, Dict[str, float]]:
    """``{stage: {busy_s, idle_s, launches, syncs, spans}}`` for each of
    ``stages`` that has a span in the trace, and :data:`OUTSIDE` (whose
    ``spans`` is 0).  A stage may be nested in another: each launch is
    the innermost asked-for stage's, so the two stages' numbers add up
    to what the outer one reads alone."""
    stages = tuple(stages)
    found = [(s, e, n) for spans in summary._spans.values()
             for s, e, n in spans if n in stages]
    spans = _Spans(found)
    out: Dict[str, Dict[str, float]] = defaultdict(
        lambda: dict.fromkeys(FIELDS + ("spans",), 0))
    out[OUTSIDE]                            # present without a span too
    for _, _, n in found:
        out[n]["spans"] += 1
    for rt in summary._runtime.values():
        name = rt["name"]
        if name.startswith(LAUNCH_PREFIXES):
            out[spans.at(float(rt["ts"]))]["launches"] += 1
        elif name in SYNC_CALLS:
            out[spans.at(float(rt["ts"]))]["syncs"] += 1

    def stage_of(corr) -> str:
        rt = summary._runtime.get(corr)
        return spans.at(None if rt is None else float(rt["ts"]))

    first = end = None
    for s, t, _, corr in sorted(summary.device):
        stage = out[stage_of(corr)]
        if end is None:
            first, end = s, t
            stage["busy_s"] += (t - s) * 1e-6
            continue
        if s > end:
            stage["idle_s"] += (s - end) * 1e-6
        if t > end:
            stage["busy_s"] += (t - max(s, end)) * 1e-6
            end = t
    # the stretch's lead and tail (its host clock against the device's)
    span_s = (end - first) * 1e-6 if end is not None else 0.0
    out[OUTSIDE]["idle_s"] += summary.wall_s - span_s
    return dict(out)


def _stretch_split(ctx: Dict, stages: Tuple[str, ...]
                   ) -> Optional[Dict[str, Dict[str, float]]]:
    """:func:`split` of the traced run's stretch, worked out once per
    run and kept in ``ctx``; None without a trace or units."""
    if ctx["trace"] is None or not ctx["units_stretch"]:
        return None
    memo = ctx.setdefault("stages", {})
    if stages not in memo:
        memo[stages] = split(ctx["trace"], stages)
    return memo[stages]


def per_unit(ctx: Dict, stage: str, stages: Tuple[str, ...], field: str,
             scale: float = 1.0) -> Optional[float]:
    """``field`` of ``stage`` in the traced run's stretch per unit it did,
    times ``scale``; None where the trace has no span of ``stage``."""
    got = (_stretch_split(ctx, stages) or {}).get(stage)
    if got is None:
        return None
    return got[field] * scale / ctx["units_stretch"]


def syncs_per_unit(ctx: Dict, stages: Tuple[str, ...]) -> Optional[float]:
    """Blocking runtime calls inside the program's spans per unit of the
    stretch; None where the trace has no span of ``stages``."""
    got = _stretch_split(ctx, stages) or {}
    inside = [v["syncs"] for k, v in got.items() if k != OUTSIDE]
    if not inside:
        return None
    return sum(inside) / ctx["units_stretch"]
