"""Device idle time (the gaps that its launches end) of the serving
pipeline's ``pipeline.background`` stage in bf16 serving's profiled
stretch, in ms per frame (:mod:`rlbench.stages`)."""

from rlbench.stages import SERVE, per_unit


def read(ctx, data):
    return per_unit(ctx, "pipeline.background", SERVE, "idle_s", 1e3)
