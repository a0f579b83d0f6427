"""Device busy time (the union of its kernels, copies and memsets) of the
serving pipeline's ``pipeline.label`` stage in bf16 serving's profiled
stretch, in ms per frame (:mod:`rlbench.stages`)."""

from rlbench.stages import SERVE, per_unit


def read(ctx, data):
    return per_unit(ctx, "pipeline.label", SERVE, "busy_s", 1e3)
