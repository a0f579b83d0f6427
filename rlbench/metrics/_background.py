"""The stages of Super SloMo's backgrounds, nested in the serving
pipeline's ``pipeline.background`` (``renderloom_torch/models/
superslomo.py``), for the float32 serving loop's readers."""

from __future__ import annotations

from typing import Dict, Optional

from rlbench.stages import SERVE, per_unit

STAGES = ("background.flow_net", "background.time_net", "background.warp")


def busy_ms_per_frame(ctx: Dict, stage: str) -> Optional[float]:
    """Device busy time of ``stage`` in the profiled stretch, ms a frame,
    with the nested stages split out of ``pipeline.background``; None
    where the trace has no span of it (a program without them)."""
    return per_unit(ctx, stage, SERVE + STAGES, "busy_s", 1e3)
