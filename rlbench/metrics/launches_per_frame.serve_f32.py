"""Kernel-launch calls per output frame in the float32 serving loop's profiled
stretch."""

from rlbench.metrics._layer import launches_per_unit


def read(ctx, data):
    return launches_per_unit(ctx)
