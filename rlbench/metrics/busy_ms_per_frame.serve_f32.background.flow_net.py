"""Device busy time (the union of its kernels, copies and memsets) of
Super SloMo's ``background.flow_net`` stage in float32 serving's profiled
stretch, ms per frame: the flow U-Net's calls (once over every keyframe pair), its input included
(:mod:`rlbench.stages`, nested in ``pipeline.background``)."""

from rlbench.metrics._background import busy_ms_per_frame


def read(ctx, data):
    return busy_ms_per_frame(ctx, "background.flow_net")
