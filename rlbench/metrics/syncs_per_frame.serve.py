"""Runtime calls that block the host on the device (stream, device and
event synchronisations, synchronous copies) inside the serving
pipeline's stage spans, per frame of bf16 serving's profiled stretch
(:mod:`rlbench.stages`)."""

from rlbench.stages import SERVE, syncs_per_unit


def read(ctx, data):
    return syncs_per_unit(ctx, SERVE)
