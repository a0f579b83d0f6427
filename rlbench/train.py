"""The training loop: the program's renderer train step on raw windows,
one step after the other, for the window.

Set-up builds one train state from the seed's weight trees and drives
it through the first ``check_steps`` steps, through the same call and
feed as the window (their windows all differ); those steps warm every
shape up and give the readings the reference is held to: each step's
losses, the leaf norms of the gradients the optimizers got in the
first step's two updates, worked out from their moments (``beta1`` is 0
in the shipped configuration), and the leaf norms of the parameters'
change after the last.  The window then goes on from that same state.  After the window
the program is freed and the reference takes the same steps from the
same trees and windows.

A traced run profiles the first ``trace_steps`` steps of the window;
its model-FLOP utilisation is taken over the rest of the window.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

from rlbench import check, drive, peaks, refrun
from rlbench.seeds import derive
from rlbench.trace import Stretch, reduce_trace
from rlbench.traffic import train_window
from rlbench.weights import make_trees

LOSSES = ("g/total", "d/total")


def first_gradients(opt) -> torch.Tensor:
    """The first update's gradient, squared, from the optimizer's
    moments after the first step's two updates: with ``beta1`` 0 the
    first moment is the second gradient g2, and ``nu = (1 − b2)·(g2² +
    b2·g1²)``.  No update applied reads 0; any other count of updates
    than two reads infinite."""
    if opt.b1 != 0:
        raise ValueError(f"the first gradient needs beta1 0, got {opt.b1}")
    count = int(opt.count)
    if count == 0:
        return torch.zeros_like(opt.nu)
    if count != 2:
        return torch.full_like(opt.nu, float("inf"))
    return torch.clamp((opt.nu / (1 - opt.b2) - opt.mu * opt.mu) / opt.b2,
                       min=0.0)


def _readings(state, step: Callable, windows: Callable, n: int) -> Dict:
    """Drive ``state`` through ``n`` steps; the losses of each, the
    leaf norms of the first and the second gradient after the first
    step (its two updates), the change's leaf norms after the last."""
    opts = (state.opt_g, state.opt_d)
    sizes = [[p.numel() for p in o.params] for o in opts]
    start = [o.flat.detach().clone() for o in opts]
    losses: List[Dict[str, float]] = []
    for s in range(n):
        metrics = step(state, windows(s))
        losses.append({k: float(metrics[k]) for k in LOSSES})
        if s == 0:
            grads = [check.leaf_norms(o.mu, z) for o, z in zip(opts, sizes)]
            firsts = [check.leaf_norms(first_gradients(o), z, squared=True)
                      for o, z in zip(opts, sizes)]
    change = [check.leaf_norms(o.flat - f, z)
              for o, f, z in zip(opts, start, sizes)]
    # one list of leaves, G's then D's: the median leaf is the state's;
    # of the first gradients G's (D's first is all but zero at the
    # random start: its hinge terms saturate)
    return {"losses": losses, "grads": torch.cat(grads).cpu(),
            "g_firsts": firsts[0].cpu(), "change": torch.cat(change).cpu()}


def compare(program: Dict, reference: Dict) -> Dict[str, float]:
    keep = check.moving(reference["grads"])
    return {
        "loss_gap": check.loss_gap(program["losses"], reference["losses"],
                                   LOSSES),
        "first_loss_gap": check.loss_gap(program["losses"][:1],
                                         reference["losses"][:1], LOSSES),
        "g_first_grad_gap": check.norm_gap(program["g_firsts"],
                                           reference["g_firsts"]),
        "g_first_grad_median_gap": check.norm_gap(
            program["g_firsts"], reference["g_firsts"], over="median"),
        "grad_median_gap": check.norm_gap(program["grads"],
                                          reference["grads"], over="median"),
        "grad_gap": check.norm_gap(program["grads"], reference["grads"]),
        "change_gap": check.norm_gap(program["change"], reference["change"],
                                     keep),
        "median_change_gap": check.norm_gap(
            program["change"], reference["change"], keep, "median"),
    }


def run(cell: Dict, seed: int, seconds: float, trace: bool, device,
        t0: float, program: Optional[Callable] = None) -> Dict:
    """One run of a training cell.  ``program`` builds the state and
    the step (default :func:`rlbench.port.training`; the control and
    the tests put something else in its place)."""
    from rlbench import port
    config, traffic, limits = cell["config"], cell["traffic"], cell["check"]
    r = config["renderer"]
    B, F = r["batch_size"], r["data"]["max_frames"]
    size = (r["data"]["load_height"], r["data"]["load_width"])
    sync = drive.synchronizer(device)
    windows = lambda s: train_window(traffic, B, F, size, seed, s, device)
    state_seed = derive(seed, "state") % 2 ** 62
    trees = make_trees(refrun.specs(config, "train"), seed, device)
    state, step = (program or port.training)(config, trees, state_seed,
                                             device)
    n_check = limits["check_steps"]
    got = _readings(state, step, windows, n_check)
    sync()
    setup_s = time.perf_counter() - t0

    s = n_check

    def one():
        nonlocal s
        with torch.profiler.record_function("step"):
            step(state, windows(s))
        sync()
        s += 1

    stretch = None
    if trace:
        stretch = Stretch(sync, cell["name"])
        with stretch:
            for _ in range(traffic["trace_steps"]):
                one()
    after_s = s
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        one()
    end = time.perf_counter()
    steps = s - n_check
    device_info = drive.device_block(device)
    summary = reduce_trace(stretch.path, stretch.wall_s) if trace else None

    del state, step
    drive.free(device)
    dtype = r["compute_dtype"]
    ref_state, ref_step = refrun.training(config, trees, state_seed, device)
    with refrun.precision("float32"):
        want, flops, norm_bytes = drive.counted(
            lambda: _readings(ref_state, ref_step, windows, n_check),
            peaks.DTYPE_BYTES[dtype], trace)
    readings = compare(got, want)
    verdict = check.judge(readings, limits["limits"])
    e2e = {"windows_per_s": (s - after_s) * B / (end - start),
           "setup_s": setup_s}
    ctx = None
    if trace:
        per_window = n_check * B
        ctx = drive.layer_context(
            summary, dtype, (after_s - n_check) * B,
            (s - after_s) * B, end - start, flops / per_window,
            norm_bytes / per_window)
    return drive.result(cell, trace, e2e, ctx, steps, 0, device_info,
                        summary, readings, verdict)
