"""The serving loop: one closed-loop client sends the traffic's requests
to the program's pipeline callable, one at a time, for the window.

Set-up builds the pipeline from the seed's weight trees and runs the
traffic's warm-up requests (the cell's shapes only).  In the window,
request ``i`` is drawn on the device, and its latency runs from its
call until its frames are ready on the card.  A reservoir drawn from
the seed keeps the outputs of ``sample_requests`` requests of the
window; after the window the program is freed and the reference
serves the same inputs again (:mod:`rlbench.check`).

A traced run profiles the first ``trace_requests`` requests of the
window (:class:`rlbench.trace.Stretch`); its model-FLOP utilisation is
taken over the rest of the window.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Dict, Optional

import torch

from rlbench import check, drive, peaks, refrun
from rlbench.seeds import derive
from rlbench.stats import percentile
from rlbench.trace import Stretch, reduce_trace
from rlbench.traffic import frames_per_clip, serve_request
from rlbench.weights import make_trees, motion_stats


def run(cell: Dict, seed: int, seconds: float, trace: bool, device,
        t0: float, program: Optional[Callable] = None) -> Dict:
    """One run of a serving cell.  ``program`` builds what is served
    (default :func:`rlbench.port.serving`; the control and the tests
    put something else in its place)."""
    from rlbench import port
    config, traffic, limits = cell["config"], cell["traffic"], cell["check"]
    data = config["renderer"]["data"]
    size = (data["model_height"], data["model_width"])
    sync = drive.synchronizer(device)
    stats = motion_stats()
    trees = make_trees(refrun.specs(config, "serve"), seed, device)
    fn = (program or port.serving)(config, traffic, trees, stats, device)
    for w in range(traffic["warmup_requests"]):
        fused, _ = fn(*serve_request(traffic, size, seed, f"warmup{w}",
                                     device))
    # the sampled outputs are copied into buffers made here, so each
    # request's own output is freed as a server's would be, and the
    # allocator sees the same requests in every run
    keep = limits["sample_requests"]
    kept = torch.empty((keep,) + tuple(fused.shape), dtype=fused.dtype,
                       device=fused.device)
    del fused
    sync()
    setup_s = time.perf_counter() - t0

    frames = traffic["clips_per_request"] * frames_per_clip(traffic)
    pick = random.Random(derive(seed, "sample"))
    slots: Dict[int, int] = {}          # slot → the request it holds
    latencies = []

    def one(i: int):
        inputs = serve_request(traffic, size, seed, i, device)
        sync()
        tic = time.perf_counter()
        with torch.profiler.record_function("request"):
            fused, _ = fn(*inputs)
        sync()
        latencies.append(time.perf_counter() - tic)
        j = i if i < keep else pick.randrange(i + 1)   # a reservoir
        if j < keep:
            kept[j].copy_(fused)
            slots[j] = i

    i = 0
    stretch = None
    if trace:
        stretch = Stretch(sync, cell["name"])
        with stretch:
            for _ in range(traffic["trace_requests"]):
                one(i)
                i += 1
    after_i = i
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        one(i)
        i += 1
    end = time.perf_counter()
    device_info = drive.device_block(device)
    summary = reduce_trace(stretch.path, stretch.wall_s) if trace else None

    del fn
    drive.free(device)
    reference = refrun.serving(config, traffic, trees, stats, device)
    dtype = config["renderer"]["compute_dtype"]
    gaps, flops, norm_bytes = [], None, None
    for n, (j, idx) in enumerate(sorted(slots.items())):
        fused = kept[j]
        inputs = serve_request(traffic, size, seed, idx, device)
        with torch.inference_mode(), refrun.precision("float32"):
            want, f, b = drive.counted(lambda: reference(*inputs),
                                       peaks.DTYPE_BYTES[dtype],
                                       trace and n == 0)
        if n == 0:
            flops, norm_bytes = f, b
        gaps.append(check.frame_gaps(fused, want))
        del want
    readings = check.serving_readings(
        torch.cat(gaps) if gaps else torch.full((1, 1), float("inf")),
        traffic["rate"], limits.get("frame_tol", float("inf")))
    verdict = check.judge(readings, limits["limits"])
    e2e = {"frames_per_s": (i - after_i) * frames / (end - start),
           "request_p95_ms": percentile(latencies, 95) * 1e3,
           "setup_s": setup_s}
    ctx = None
    if trace:
        ctx = drive.layer_context(
            summary, dtype, after_i * frames,
            (i - after_i) * frames, end - start,
            flops / frames if flops is not None else None,
            norm_bytes / frames if norm_bytes is not None else None)
    return drive.result(cell, trace, e2e, ctx, i, 0, device_info, summary,
                        readings, verdict)
