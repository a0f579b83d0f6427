"""Model FLOPs utilisation of the bf16 serving loop: the reference's FLOPs per
unit at the cell's shapes times the units done after the profiled
stretch, over that time and the compute dtype's published peak."""

from rlbench.metrics._layer import mfu_pct


def read(ctx, data):
    return mfu_pct(ctx)
