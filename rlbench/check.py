"""The numbers that decide ``correct``, each held against its limit.

Serving: per output frame of the sampled requests, the mean absolute
gap between the program's frame and the reference's (values in
[0, 1]).  ``frame_gap`` is the worst frame's: one frame altered, or a
clip left out, reads in it whole.  ``bad_frame_share`` is the share of
generated frames whose gap exceeds the cell's ``frame_tol``: in bf16 a
joint that the motion transformer's rounding moves across a pixel
boundary redraws the label and a few frames move far, while a lower
precision moves every frame.

Training: ``loss_gap``, the largest relative gap of the step losses
(``g/total`` and ``d/total``) over the first steps; ``grad_gap``, the
worst parameter leaf's gap of first-moment norms after the first step
(the gradients as the optimizers got them); ``change_gap``, the worst
leaf's gap of the norms of the parameters' change after the first
steps.  Each leaf's gap is taken between the two norms, not as the
norm of the difference, against the reference's norm of that leaf or
of the median leaf, whichever is larger.  Leaves whose reference
gradient is under a thousandth of the median leaf's move under AMSGrad
by round-off alone and are left out of ``change_gap``.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Sequence

import torch

NEGLIGIBLE_GRAD = 1e-3      # of the median leaf's first-moment norm


def frame_gaps(program: torch.Tensor, reference: torch.Tensor
               ) -> torch.Tensor:
    """Each frame's mean |program − reference|, (N, L), of (N, L, H,
    W, C) frames."""
    if program.shape != reference.shape:
        return torch.full(reference.shape[:2], float("inf"))
    gap = (program.float() - reference.float()).abs().mean(dim=(-3, -2, -1))
    return torch.nan_to_num(gap, nan=float("inf")).cpu()


def serving_readings(gaps: torch.Tensor, rate: int,
                     frame_tol: float) -> Dict[str, float]:
    """From the (clips, L) frame gaps of the sampled requests: the
    worst frame's (``frame_gap``), the mean over every frame
    (``mean_frame_gap``), the median generated frame's (every frame but
    the keyframes, ``t % rate == 0``: ``gen_q50_gap``), the worst
    keyframe's (``key_gap``), and the share of generated frames whose
    gap exceeds ``frame_tol`` (``bad_frame_share``)."""
    key = torch.arange(gaps.shape[1]) % rate == 0
    gen = gaps[:, ~key].flatten()
    return {"frame_gap": float(gaps.max()),
            "mean_frame_gap": float(gaps.mean()),
            "gen_q50_gap": float(gen.median()),
            "key_gap": float(gaps[:, key].max()),
            "bad_frame_share": float((gen > frame_tol).float().mean())}


def loss_gap(program: Sequence[Dict[str, float]],
             reference: Sequence[Dict[str, float]],
             keys=("g/total", "d/total")) -> float:
    """Largest relative gap of the losses ``keys`` over the steps."""
    worst = 0.0
    for p, r in zip(program, reference):
        for k in keys:
            gap = abs(p[k] - r[k]) / max(abs(r[k]), 1e-12)
            worst = max(worst, gap if gap == gap else float("inf"))
    return worst


def leaf_norms(flat: torch.Tensor, sizes: Sequence[int],
               squared: bool = False) -> torch.Tensor:
    """Each leaf's L2 norm in a flat buffer of leaves of ``sizes``
    (``squared``: the buffer holds the squares)."""
    parts = torch.split(flat.float(), list(sizes))
    if squared:
        return torch.stack([part.sum() for part in parts]).sqrt()
    return torch.stack([part.norm() for part in parts])


def norm_gap(program: torch.Tensor, reference: torch.Tensor,
             keep: torch.Tensor = None, over: str = "max") -> float:
    """Worst (``over="max"``) or median leaf's |‖p‖ − ‖r‖| / max(‖r‖,
    median ‖r‖)."""
    if keep is not None:
        program, reference = program[keep], reference[keep]
    denom = torch.clamp(reference, min=float(reference.median()))
    gap = torch.nan_to_num((program - reference).abs() / denom,
                           nan=float("inf"))
    return float(gap.max() if over == "max" else gap.median())


def moving(ref_grad_norms: torch.Tensor) -> torch.Tensor:
    """Leaves to keep in the change: reference gradient at least a
    thousandth of the median leaf's."""
    return ref_grad_norms >= NEGLIGIBLE_GRAD * ref_grad_norms.median()


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """``{name: {"value", "limit"}}`` for every limited number; a number
    missing from ``numbers`` reads infinite."""
    return {k: {"value": numbers.get(k, float("inf")), "limit": v}
            for k, v in limits.items()}


def passed(verdict: Dict) -> bool:
    return all(v["value"] <= v["limit"] for v in verdict.values())


def report(verdict: Dict) -> List[str]:
    """The numbers compared beside their limits, as the last lines of
    standard error."""
    lines = [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
             for k, v in verdict.items()]
    for line in lines:
        print(line, file=sys.stderr)
    return lines
