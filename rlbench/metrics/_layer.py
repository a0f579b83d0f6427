"""Arithmetic the per-layer readers share.  A reader gets the traced
run's context (``rlbench.drive.layer_context``) and its own data file's
contents, and returns a number or None where it finds nothing to read."""

from __future__ import annotations

from typing import Dict, Optional

from rlbench import peaks


def mfu_pct(ctx: Dict) -> Optional[float]:
    """Model FLOPs of the units completed after the profiled stretch,
    over that time, as a share of the compute dtype's peak."""
    if not ctx.get("flops_per_unit") or not ctx["units_after"]:
        return None
    rate = ctx["flops_per_unit"] * ctx["units_after"] / ctx["seconds_after"]
    return 100.0 * rate / ctx["peak_flops"]


def launches_per_unit(ctx: Dict) -> Optional[float]:
    """Kernel-launch calls in the profiled stretch per unit it did."""
    if ctx["trace"] is None or not ctx["units_stretch"] \
            or not ctx["trace"].launches:
        return None
    return ctx["trace"].launches / ctx["units_stretch"]


def roofline_pct(ctx: Dict, kernels, bytes_per_unit) -> Optional[float]:
    """Least time of the stretch's bytes over the device time of the
    kernels named."""
    if ctx["trace"] is None or not bytes_per_unit:
        return None
    t = ctx["trace"].kernel_s(kernels)
    if t <= 0:
        return None
    least = peaks.bytes_seconds(bytes_per_unit * ctx["units_stretch"])
    return 100.0 * least / t


def idle_pct(ctx: Dict) -> Optional[float]:
    """Share of the profiled stretch in which nothing ran on the device."""
    tr = ctx["trace"]
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.wall_s)
