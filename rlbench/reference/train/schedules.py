"""Learning-rate policies.

Port of the JAX package's ``renderloom/train/schedules.py``: epoch-level
policies as ``epoch -> multiplier`` functions, composed into per-update
schedules.  The functions take a Python int or an integer tensor (the
optimizer's update count on the device), so a schedule evaluates
without a host synchronisation.  ``plateau`` is metric-driven and lives
on the host as :class:`ReduceOnPlateau`.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

Count = Union[int, torch.Tensor]


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.tensor(x, dtype=torch.float32)


def lr_multiplier(policy: str, gamma: float = 0.5, step_size: int = 100,
                  warmup: int = 5) -> Callable[[Count], torch.Tensor]:
    """Epoch → float32 LR multiplier for the named policy."""
    if policy == "constant":
        return lambda epoch: torch.ones((), dtype=torch.float32,
                                        device=getattr(epoch, "device",
                                                       None))
    if policy == "lambda":          # Noam-style warmup
        return lambda epoch: torch.minimum(
            (_f32(epoch) + 1.0) ** -0.5,
            (_f32(epoch) + 1.0) * warmup ** -1.5)
    if policy == "step":
        return lambda epoch: torch.pow(
            _f32(gamma).to(getattr(epoch, "device", None)),
            _f32(epoch // step_size))
    if policy == "multistep":
        milestones = (step_size, step_size + step_size // 2,
                      step_size + step_size // 2 + step_size // 4)
        return lambda epoch: torch.pow(
            _f32(gamma).to(getattr(epoch, "device", None)),
            sum(_f32(epoch >= m) for m in milestones))
    raise ValueError(f"unknown lr policy {policy!r}")


class ReduceOnPlateau:
    """Host-side plateau policy (torch ``ReduceLROnPlateau(mode='min',
    factor=0.5, threshold=0.01, patience=5)`` semantics): call
    :meth:`update` with the monitored metric once per epoch and feed
    :attr:`multiplier` to the optimizer."""

    def __init__(self, factor: float = 0.5, patience: int = 5,
                 threshold: float = 0.01, min_mult: float = 1e-4):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_mult = min_mult
        self.multiplier = 1.0
        self.best = float("inf")
        self._bad_epochs = 0

    def update(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = float(metric)
            self._bad_epochs = 0
        else:
            self._bad_epochs += 1
            if self._bad_epochs > self.patience:
                self.multiplier = max(self.multiplier * self.factor,
                                      self.min_mult)
                self._bad_epochs = 0
        return self.multiplier


def step_schedule(base_lr: float, policy: str, steps_per_epoch: int,
                  gamma: float = 0.5, step_size: int = 100,
                  warmup: int = 5) -> Callable[[Count], torch.Tensor]:
    """Per-update schedule ``count -> base_lr · mult(count //
    steps_per_epoch)`` in float32."""
    mult = lr_multiplier(policy, gamma, step_size, warmup)

    def schedule(count: Count) -> torch.Tensor:
        return base_lr * mult(count // steps_per_epoch)

    return schedule
