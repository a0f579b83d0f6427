"""Kernel-launch calls per training window in the training loop's
profiled stretch."""

from rlbench.metrics._layer import launches_per_unit


def read(ctx, data):
    return launches_per_unit(ctx)
