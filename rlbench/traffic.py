"""The general generator of the benchmark's traffic.

A traffic mix is a JSON file of parameters (``traffic/<name>.json``);
its ``kind`` picks the loop that drives the program (``serve`` or
``train``), and everything else is data:

* ``serve``: requests of ``clips_per_request`` clips of ``keyframes``
  keyframes at ``rate`` (L = (K − 1)·rate + 1 output frames a clip),
  sent by ``clients`` closed-loop clients.  A clip's keyframe poses are a
  standing person (:data:`SKELETON`, drawn for a 480×320 frame and
  scaled to the configuration's) moved by a per-clip shift and scale,
  a per-keyframe drift and a per-joint jitter, all in pixels, with a
  confidence per joint; the keyframes are uniform noise in [0, 1]
  (``renderloom_torch/bench.py``'s).
* ``train``: raw windows as ``cli/train_renderer.synthetic_batches``
  draws them: joints uniform over the frame less a 10-pixel border at
  confidence 0.9, images and backgrounds uniform bytes, at the
  configuration's load size, batch and window length.

Request ``i`` (or step ``i``) of a run is drawn on the device from its
own stream ``(seed, "request", i)``: every request of every seed has
the same sizes, and a request can be drawn again after the window to
hand the same inputs to the reference.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from rlbench.seeds import derive

# openpose-like 19 joints of a standing person in a 480×320 frame:
# nose, neck, right shoulder/elbow/wrist, left shoulder/elbow/wrist,
# mid-hip, right hip/knee/ankle, left hip/knee/ankle, left toe, right
# toe, left hand, right hand (the rows of ops/rasterize.POSE_EDGES_19)
SKELETON = (
    (240, 45), (240, 80), (210, 82), (195, 130), (190, 175),
    (270, 82), (285, 130), (290, 175), (240, 170), (222, 170),
    (218, 230), (215, 285), (258, 170), (262, 230), (265, 285),
    (272, 295), (208, 295), (292, 190), (188, 190))
SKELETON_SIZE = (320, 480)          # (height, width) it was drawn for
# the pipeline's joint units: pixels = units · 256 + 256
UNIT_SCALE, UNIT_OFFSET = 256.0, 256.0


def _generator(seed: int, device, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def frames_per_clip(traffic: dict) -> int:
    return (traffic["keyframes"] - 1) * traffic["rate"] + 1


def serve_request(traffic: dict, size: Tuple[int, int], seed: int,
                  index: int, device) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """Request ``index``: ``(motion (N, 19, 2, K), conf (N, 19, 1, K),
    keys (N, K, H, W, 3))`` on ``device``, N clips, float32."""
    N, K = traffic["clips_per_request"], traffic["keyframes"]
    H, W = size
    p = traffic["pose"]
    g = _generator(seed, device, "request", index)
    u = lambda *shape: torch.rand(shape, generator=g, device=device)
    n = lambda *shape: torch.randn(shape, generator=g, device=device)
    base = torch.tensor(SKELETON, dtype=torch.float32, device=device)
    base = (base - torch.tensor([SKELETON_SIZE[1] / 2, SKELETON_SIZE[0] / 2],
                                device=device)) * (H / SKELETON_SIZE[0])
    lo, hi = p["scale"]
    scale = lo + (hi - lo) * u(N, 1, 1, 1)                   # (N, 1, 1, 1)
    shift = (u(N, 1, 1, 2) * 2 - 1) * torch.tensor(p["shift_px"],
                                                  device=device)
    step = (u(N, 1, 1, 2) * 2 - 1) * p["drift_px"]           # per keyframe
    t = torch.arange(K, dtype=torch.float32, device=device)[None, :, None,
                                                            None]
    jitter = n(N, K, 19, 2) * p["jitter_px"]
    centre = torch.tensor([W / 2, H / 2], device=device)
    px = centre + base * scale + shift + step * (t - (K - 1) / 2) + jitter
    motion = ((px - UNIT_OFFSET) / UNIT_SCALE).permute(0, 2, 3, 1)
    clo, chi = p["conf"]
    conf = (clo + (chi - clo) * u(N, 19, 1, K))
    keys = u(N, K, H, W, 3)
    return motion.contiguous(), conf, keys


def train_window(traffic: dict, batch: int, frames: int,
                 size: Tuple[int, int], seed: int, index: int, device
                 ) -> Dict[str, torch.Tensor]:
    """Step ``index``'s raw windows: images and dain (B, F, H0, W0, 3)
    uint8, poses (B, F, 19, 3) float32 (x, y, confidence)."""
    h0, w0 = size
    g = _generator(seed, device, "request", index)
    border = traffic["border_px"]
    u = lambda *shape: torch.rand(shape, generator=g, device=device)
    xy = torch.stack([border + (w0 - 2 * border) * u(batch, frames, 19),
                      border + (h0 - 2 * border) * u(batch, frames, 19)],
                     dim=-1)
    conf = torch.full((batch, frames, 19, 1), traffic["conf"],
                      device=device)
    byte = lambda: torch.randint(0, 255, (batch, frames, h0, w0, 3),
                                 generator=g, device=device,
                                 dtype=torch.uint8)
    return {"images": byte(), "dain": byte(),
            "poses": torch.cat([xy, conf], dim=-1)}
