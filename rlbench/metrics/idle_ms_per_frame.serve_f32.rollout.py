"""Device idle time (the gaps that its launches end) of the serving
pipeline's ``pipeline.rollout`` stage in float32 serving's profiled
stretch, in ms per frame (:mod:`rlbench.stages`)."""

from rlbench.stages import SERVE, per_unit


def read(ctx, data):
    return per_unit(ctx, "pipeline.rollout", SERVE, "idle_s", 1e3)
