"""Runtime calls that block the host on the device (stream, device and
event synchronisations, synchronous copies) inside the renderer train
step's stage spans, per window of the training loop's profiled stretch
(:mod:`rlbench.stages`)."""

from rlbench.stages import TRAIN, syncs_per_unit


def read(ctx, data):
    return syncs_per_unit(ctx, TRAIN)
