"""Model-FLOP utilisation of Super SloMo's two U-Nets in float32
serving: their direct-convolution FLOPs a frame (this metric's data
file, written by ``rlbench.builds.slomo.unet_flops`` at the cell's
shapes) times the frames of the profiled stretch, over the device busy
time of the ``background.flow_net`` and ``background.time_net`` spans
there, as a share of the compute dtype's published peak."""

from rlbench.metrics._background import busy_ms_per_frame


def read(ctx, data):
    ms = [busy_ms_per_frame(ctx, s) for s in ("background.flow_net",
                                              "background.time_net")]
    if None in ms or sum(ms) <= 0:
        return None
    rate = data["flops_per_frame"] / (sum(ms) * 1e-3)
    return 100.0 * rate / ctx["peak_flops"]
