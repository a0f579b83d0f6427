"""Device busy time (the union of its kernels, copies and memsets) of
Super SloMo's ``background.warp`` stages in float32 serving's profiled
stretch, ms per frame: the time-t flow combination, the four bilinear
warps and the visibility blend, two spans a request
(:mod:`rlbench.stages`, nested in ``pipeline.background``)."""

from rlbench.metrics._background import busy_ms_per_frame


def read(ctx, data):
    return busy_ms_per_frame(ctx, "background.warp")
