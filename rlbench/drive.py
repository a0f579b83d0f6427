"""What the serving and training loops share: synchronisation, the
result's ``device`` block, freeing the program before the reference
runs, counting the reference's work, and the per-layer readers."""

from __future__ import annotations

import gc
import importlib.util
import json
import os
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rlbench import check, peaks, trace
from rlbench.spec import HERE


def synchronizer(device) -> Callable[[], None]:
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def device_block(device) -> Dict:
    """The result's ``device``: the card's name, the count, and the peak
    of allocated memory so far."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}


def free(device):
    """Return what the freed program held to the device."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def norm_bytes_counter(act_bytes: int) -> Tuple[Callable, list]:
    """A norm observer and the list whose one entry it adds bytes to:
    the input read and the output written once at the activation dtype,
    γ and β read; where a gradient is wanted, the residuals written and
    read, x and dy read and dx written, and dγ, dβ written."""
    total = [0]

    def observe(x: torch.Tensor, scale, slope):
        n, B, C = x.numel(), x.shape[0], x.shape[-1]
        affine = scale is not None
        b = 2 * n * act_bytes + (2 * C * 4 if affine else 0)
        grad = torch.is_grad_enabled() and (
            x.requires_grad or (affine and scale.requires_grad))
        if grad:
            b += 2 * B * C * 3 * 4 + 3 * n * act_bytes
            b += 2 * C * 4 if affine else 0
        total[0] += b
    return observe, total


class FlopCount(TorchDispatchMode):
    """Sums the FLOPs of every operation that
    ``torch.utils.flop_counter.flop_registry`` prices (convolutions as
    direct convolutions, matrix products), forward and backward.  Unlike
    ``FlopCounterMode`` it tracks no modules, so it runs under inference
    mode and inside ``autograd.grad``."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        price = flop_registry.get(func._overloadpacket)
        if price is None and func is not torch.ops.prim.layout.default:
            # a composite op that inference mode keeps whole (conv2d,
            # matmul): price the ops it is made of
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if price is not None:
            self.total += price(*args, **kwargs, out_val=out)
        return out


def counted(fn: Callable, act_bytes: int, count: bool):
    """``(fn(), model FLOPs, norm bytes)``: with ``count``, the
    reference's FLOPs (:class:`FlopCount`) and its norms' bytes; else
    ``(fn(), None, None)``."""
    if not count:
        return fn(), None, None
    from rlbench.reference.ops.norm import observe_norms
    observe, total = norm_bytes_counter(act_bytes)
    with FlopCount() as fc, observe_norms(observe):
        out = fn()
    return out, fc.total, total[0]


def per_layer(cell: Dict, ctx: Dict) -> Dict:
    """Each of the cell's per-layer metrics from its reader
    ``metrics/<name>.py`` (with ``metrics/<name>.json`` as its data);
    a reader that finds nothing to read gives None and the metric is
    left out."""
    out = {}
    for m in cell["per_layer"]:
        path = os.path.join(HERE, "metrics", m["name"] + ".py")
        spec = importlib.util.spec_from_file_location(
            "rlbench_metric_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        data_path = os.path.join(HERE, "metrics", m["name"] + ".json")
        data = None
        if os.path.exists(data_path):
            with open(data_path) as f:
                data = json.load(f)
        value = mod.read(ctx, data)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def layer_context(summary: Optional[trace.TraceSummary], dtype: str,
                  units_stretch: float, units_after: float,
                  seconds_after: float, flops_per_unit: Optional[float],
                  norm_bytes_per_unit: Optional[float]) -> Dict:
    """What a per-layer reader gets: the stretch's trace, the units
    (frames or windows) done in the stretch and after it, the seconds
    after it, the reference's FLOPs and norm bytes per unit, and the
    compute dtype's peak."""
    return {"trace": summary, "dtype": dtype,
            "units_stretch": units_stretch, "units_after": units_after,
            "seconds_after": seconds_after,
            "flops_per_unit": flops_per_unit,
            "norm_bytes_per_unit": norm_bytes_per_unit,
            "peak_flops": peaks.FLOPS_PER_S[dtype]}


def result(cell: Dict, trace_on: bool, e2e: Dict, layer_ctx: Optional[Dict],
           attempted: int, failed: int, device_info: Dict,
           summary: Optional[trace.TraceSummary], readings: Dict,
           verdict: Dict) -> Dict:
    """The run's result line: ``readings`` holds every number the
    comparison read, ``check`` (the numbers compared and their limits)
    comes last."""
    out = {"correct": check.passed(verdict) and failed == 0,
           "attempted": attempted, "failed": failed}
    if trace_on:
        out["metrics"] = per_layer(cell, layer_ctx)
        device_info = dict(device_info, busy_s=summary.busy_s,
                           window_s=summary.wall_s)
        out["breakdown"] = {"device_ops": summary.device_ops(),
                            "idle_gaps": summary.idle_gaps()}
    else:
        # a metric's name before its first dot names the quantity the
        # loop measured; what follows tells cells' bounds apart
        out["metrics"] = {m["name"]: {"value": e2e[m["name"].split(".")[0]],
                                      "unit": m["unit"]}
                          for m in cell["end_to_end"]}
    out["device"] = device_info
    out["readings"] = readings
    out["check"] = verdict
    return out
