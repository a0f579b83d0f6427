"""Roofline share of the instance norms in the train loop: the least
time of the bytes the reference's norm calls move at the cell's
activation dtype, over the device time of the kernels that this
metric's data file names."""

from rlbench.metrics._layer import roofline_pct


def read(ctx, data):
    return roofline_pct(ctx, data["kernels"], ctx["norm_bytes_per_unit"])
