#!/usr/bin/env python3
"""K2 and K2b r3centered (the bf16 instance norm of
``renderloom_torch/csrc/instance_norm.cu``) at every shape of the bf16
main paths, on both of the kernel's paths, on an NVIDIA card.

For each (shape, affine, leaky) of one bf16 standard clip (K2
r3centered), one bf16 training step's forwards with residuals (K2) and
its backwards (K2b), with the number of such calls per clip or step: the
kernel held against its plain twin as ``chip_smoke.py`` phases R and B2
hold it, the plan's path and cluster size, and the device ms of the call
on the path the plan picks and on the grid path (a cooperative launch
of the persistent grid, packed from the grid plan), each behind a spin
kernel, and their sums per clip and per step.  Then two calls at the
cluster-path shapes compared bit for bit, and the wrappers' host us per
call at (1, 4, 4, 32) and (4, 40, 60, 256).  The shapes and counts are
the ones chip_smoke.py phases R and B2 hold the main paths to
(configs/hsm.yaml at 480x320, 7 segments; the training step at batch 4).

With ``--ab OTHER`` it measures instead the wrappers' host time and
device time per call in two checkouts, in turns in one session on one
card: OTHER, this one, this one, OTHER.  Each turn is a fresh process
from its checkout's root, which builds and loads its own kernels and
calls only what both checkouts have (``instance_norm_cuda`` /
``instance_norm_bwd_cuda`` with ``r3centered=True`` and
``chip_smoke.host_us`` / ``device_ms``), at (1, 4, 4, 32) without
affine and (4, 40, 60, 256) and (8, 5, 5, 128) with affine and the
leaky.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 scripts/norm_r3_h100.py [--sweep] [--out build/norm_r3/r3.json]
    python3 scripts/norm_r3_h100.py --ab PARENT_CHECKOUT \
        [--out build/norm_r3/ab.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402
from renderloom_torch.ops import norm_kernel as NK  # noqa: E402

# ((B, H, W, C), affine, leaky, calls): per bf16 standard clip (SERVE),
# per bf16 training step (TRAIN_FWD with residuals, TRAIN_BWD), the
# calls chip_smoke.py phases R and B2 hold the main path to
SERVE, TRAIN_FWD, TRAIN_BWD = (
    [key + (n,) for key, n in calls.items()]
    for calls in (CS.R3_CLIP_CALLS, CS.R3_STEP_FWD_CALLS,
                  CS.R3_STEP_BWD_CALLS))


_cfgs = {}


def _cfg_call(way, p, x, dy, stats, s, b, slope):
    """One launch packed from plan ``p`` (the grid path's, or a cluster
    split of the sweep), whatever the plan of the shape picks."""
    B, H, W, C = x.shape
    fwd = way != "bwd"
    dyf = not fwd and s is not None
    n_sums = 4 if dyf else 2
    key = (way, tuple(x.shape), s is not None, slope, p["path"],
           p["group"], p.get("cluster"))
    hit = _cfgs.get(key)
    if hit is None:
        cfg = NK._pack(p, B, H * W, C, True, True, 0, slope,
                       1e-5 if fwd else 0.0, True, fwd and s is not None,
                       dyf)
        n = (NK._scratch_floats(B, C, p["parts"], False, n_sums)
             if p["path"] == "grid" else 0)
        hit = _cfgs[key] = (cfg, n)
    cfg, n = hit
    lib, stream = NK._library(), NK._stream(x.device.index)
    if n:
        scratch = torch.empty(n, device="cuda")
    elif dyf:
        scratch = NK._workspace(x.device, stream, 4 + B * 2 * C)
    else:
        scratch = None
    ptr = NK._ptr
    if fwd:
        out = torch.empty(x.shape, device="cuda", dtype=torch.float32
                          if s is not None else torch.bfloat16)
        err = lib.rl_instance_norm(
            x.data_ptr(), out.data_ptr(), ptr(s), ptr(b),
            ptr(stats if way == "train" else None), ptr(scratch),
            ctypes.byref(cfg), stream)
        res = (out,)
    else:
        dx = torch.empty_like(x)
        ds = torch.empty_like(s) if s is not None else None
        db = torch.empty_like(b) if b is not None else None
        err = lib.rl_instance_norm_bwd(
            x.data_ptr(), dy.data_ptr(), stats.data_ptr(), ptr(s), ptr(b),
            dx.data_ptr(), ptr(ds), ptr(db), ptr(scratch),
            ctypes.byref(cfg), stream)
        res = (dx, ds, db)
    if err:
        raise RuntimeError(f"{p['path']} launch failed: CUDA error {err}")
    return res


def _grid_plan(way, x, s):
    B, H, W, C = x.shape
    n_sms, bps, smem, _ = NK._device(x.device.index)
    dyf = way == "bwd" and s is not None
    return NK._plan(B, H * W, C, 2, 1 if way != "bwd" else 2, n_sms, bps,
                    smem, dy_itemsize=4 if dyf else None,
                    n_sums=4 if dyf else 2)


def _splits(way, x, s):
    """Every cluster split (G, blocks a cluster) that fits the card."""
    B, H, W, C = x.shape
    n_px = H * W
    _, _, _, csmem = NK._device(x.device.index)
    dyf = way == "bwd" and s is not None
    dsz = 0 if way != "bwd" else (4 if dyf else 2)
    n_sums = 4 if dyf else 2
    threads = NK._cluster_threads(way == "bwd", way != "bwd" and s is not None)
    out = []
    for G in NK._C_GROUPS:
        if C % G:
            continue
        for k in NK._C_CLUSTERS:
            rows = -(-n_px // k)
            if -(-n_px // rows) != k:       # a block without pixels
                continue
            need = NK._cluster_smem(rows, G, dsz > 0, n_sums, k, threads)
            if need > csmem or rows > NK._C_MAX_ROWS:
                continue
            out.append(dict(path="cluster", grid=B * (C // G) * k, group=G,
                            cluster=k, rows_per_block=rows, smem=need,
                            slabs=B * (C // G)))
    return out


def _plan_call(way, x, dy, stats, s, b, slope):
    if way == "bwd":
        return NK.instance_norm_bwd_cuda(x, dy, stats, s, b, slope,
                                         r3centered=True)
    return (NK.instance_norm_cuda(x, s, b, slope, 1e-5,
                                  stats if way == "train" else None,
                                  r3centered=True),)


def _plan_of(way, x, s):
    B, H, W, C = x.shape
    n_sms, bps, smem, csmem = NK._device(x.device.index)
    dyf = way == "bwd" and s is not None
    return NK._plan(B, H * W, C, 2, 2 if way == "bwd" else 1, n_sms, bps,
                    smem, dy_itemsize=4 if dyf else None,
                    n_sums=4 if dyf else 2, cluster_smem=csmem,
                    out_f32=way != "bwd" and s is not None)


SWEEP = False
best_tot = {}


def run(way, cases, seed0):
    rows, tot = [], dict(plan=0.0, grid=0.0, bound=0.0)
    for i, ((B, H, W, C), affine, leaky, n) in enumerate(cases):
        shape = (B, H, W, C)
        slope = CS.LEAKY if leaky else None
        x, dy, s, b = CS._bwd_r3_inputs(shape, affine, seed0 + i)
        stats = torch.empty((B, C, 3), device="cuda")
        NK.instance_norm_cuda(x, s, b, slope, 1e-5, stats, r3centered=True)
        if way == "serve":
            err = CS._r3_check("vs twin", x, s, b, slope)
        elif way == "train":
            err = CS._r3_res_check("vs twin", x, s, b, slope)
        else:
            err = CS._bwd_r3_check("vs twin", x, dy, s, b, slope)
        p = _plan_of(way, x, s)
        args = (way, x, dy, stats, s, b, slope)
        plan = CS.device_ms(lambda: _plan_call(*args), 20)
        sweep = None
        grid = (plan if p["path"] == "grid" else CS.device_ms(
            lambda: _cfg_call(way, _grid_plan(way, x, s), *args[1:]), 20))
        if SWEEP and p["path"] == "cluster":
            times = sorted((CS.device_ms(lambda: _cfg_call(
                way, q, *args[1:]), 20), q["group"], q["cluster"], q["grid"])
                for q in _splits(way, x, s))
            sweep = times
            print(f"      sweep: plan G {p['group']} k {p['cluster']} "
                  f"{plan:.4f}; " + ", ".join(
                      f"G{g} k{k} ({nb}) {t:.4f}" for t, g, k, nb in times[:6]))
            best_tot[way] = best_tot.get(way, 0.0) + n * min(times[0][0],
                                                             plan)
        nel = x.numel()
        if way == "bwd":
            bnd = CS.bound_ms(nel * (2 + dy.element_size() + 2), 20 * nel)[0]
        else:
            bnd = CS.bound_ms(nel * (2 + (4 if affine else 2)), 10 * nel)[0]
        same = None
        if p["path"] == "cluster":
            one, two = _plan_call(*args), _plan_call(*args)
            same = all(torch.equal(u, v) for u, v in zip(one, two)
                       if u is not None)
            if not same:
                raise AssertionError(f"{way} {shape}: two calls differ")
        row = dict(way=way, shape=shape, affine=affine, leaky=leaky,
                   calls=n, path=p["path"], cluster=p.get("cluster", 0),
                   group=p["group"], device_ms=plan, grid_ms=grid,
                   bound_ms=bnd, max_abs_err=err, two_calls_equal=same,
                   sweep=sweep)
        rows.append(row)
        tot["plan"] += n * plan
        tot["grid"] += n * grid
        tot["bound"] += n * bnd
        print(f"   {n:3d}x {shape} affine={affine} leaky={leaky}: "
              f"{p['path']} (cluster {p.get('cluster', 0)}, G "
              f"{p['group']}), device {plan:.4f} ms, grid path "
              f"{grid:.4f} ms, bound {bnd:.4f} ms"
              + ("" if same is None else ", two calls equal"))
    print(f"  {way}: device {tot['plan']:.3f} ms, grid path "
          f"{tot['grid']:.3f} ms, bound {tot['bound']:.3f} ms")
    return rows, tot


def host(way, shape, affine):
    x, dy, s, b = CS._bwd_r3_inputs(shape, affine, 77)
    slope = CS.LEAKY if affine else None
    stats = torch.empty((shape[0], shape[-1], 3), device="cuda")
    NK.instance_norm_cuda(x, s, b, slope, 1e-5, stats, r3centered=True)
    return CS.host_us(lambda: _plan_call(way, x, dy, stats, s, b, slope))


AB_CHILD = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as CS
from renderloom_torch.ops import norm_kernel as NK
out = {}
for shape, affine in (((1, 4, 4, 32), False), ((4, 40, 60, 256), True),
                      ((8, 5, 5, 128), True)):
    x, dy, s, b = CS._bwd_r3_inputs(shape, affine, 5)
    slope = CS.LEAKY if affine else None
    stats = torch.empty((shape[0], shape[-1], 3), device="cuda")
    fwd = lambda: NK.instance_norm_cuda(x, s, b, slope, 1e-5, stats,
                                        r3centered=True)
    bwd = lambda: NK.instance_norm_bwd_cuda(x, dy, stats, s, b, slope,
                                            r3centered=True)
    fwd()
    for name, fn in (("K2", fwd), ("K2b", bwd)):
        out[f"{name} {shape} affine={affine}"] = dict(
            host_us=CS.host_us(fn), device_us=CS.device_ms(fn, 40) * 1e3)
print(json.dumps(out))
"""


def ab(other: str) -> list:
    """The wrappers' host and device time per call in checkout ``other``
    and in this one, in turns (other, this, this, other)."""
    runs = []
    for tag, root in (("a", other), ("b", ROOT), ("b", ROOT), ("a", other)):
        root = os.path.abspath(root)
        res = subprocess.run([sys.executable, "-c", AB_CHILD], cwd=root,
                             capture_output=True, text=True, timeout=900)
        if res.returncode:
            raise RuntimeError(f"{root}: {res.stderr[-4000:]}")
        calls = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append(dict(checkout=tag, root=root, calls=calls))
        for k, v in calls.items():
            print(f"{tag} {k}: host {v['host_us']:.1f} us, device "
                  f"{v['device_us']:.2f} us")
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="the JSON written (default build/norm_r3/r3.json, "
                         "with --ab build/norm_r3/ab.json)")
    ap.add_argument("--sweep", action="store_true",
                    help="also time every cluster split of each cluster-path "
                         "shape")
    ap.add_argument("--ab", metavar="OTHER",
                    help="host and device us per call here and in checkout "
                         "OTHER, in turns")
    args = ap.parse_args()
    global SWEEP
    SWEEP = args.sweep
    if not torch.cuda.is_available():
        print("norm_r3_h100: no CUDA device", file=sys.stderr)
        return 1
    out = args.out or os.path.join(ROOT, "build", "norm_r3",
                                   "ab.json" if args.ab else "r3.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    print(f"card: {CS.card_line()}")
    if args.ab:
        with open(out, "w") as f:
            json.dump(ab(args.ab), f, indent=1)
        return 0
    print(f"geometry {NK._device(0)}")
    res = dict(card=CS.card_line())
    for way, cases, seed in (("serve", SERVE, 700), ("train", TRAIN_FWD, 900),
                             ("bwd", TRAIN_BWD, 800)):
        print(f"{way}:")
        res[way] = run(way, cases, seed)
    if SWEEP:
        print(f"  best split per shape, summed: {best_tot}")
    res["host_us"] = {}
    for way in ("serve", "bwd"):
        for shape, affine in (((1, 4, 4, 32), False),
                              ((4, 40, 60, 256), True)):
            us = host(way, shape, affine)
            res["host_us"][f"{way} {shape} affine={affine}"] = us
            print(f"  host us per call, {way} {shape} affine={affine}: "
                  f"{us:.1f}")
    with open(out, "w") as f:
        json.dump(res, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
