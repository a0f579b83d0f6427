"""Device busy time (the union of its kernels, copies and memsets) of the
renderer train step's ``gan.prep`` stage in the training loop's profiled
stretch, in ms per window (:mod:`rlbench.stages`)."""

from rlbench.stages import TRAIN, per_unit


def read(ctx, data):
    return per_unit(ctx, "gan.prep", TRAIN, "busy_s", 1e3)
