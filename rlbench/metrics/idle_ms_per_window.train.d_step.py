"""Device idle time (the gaps that its launches end) of the renderer train
step's ``gan.d_step`` stage in the training loop's profiled stretch, in
ms per window (:mod:`rlbench.stages`)."""

from rlbench.stages import TRAIN, per_unit


def read(ctx, data):
    return per_unit(ctx, "gan.d_step", TRAIN, "idle_s", 1e3)
