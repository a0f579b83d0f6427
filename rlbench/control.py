"""Readings that set a cell's correctness limits, on the card.

    python -m rlbench.control --workload <cell> --seeds 1,2,3 \\
        --what program,control[,half_batch] --seconds 3

drives the cell's whole run (set-up, a short window at the cell's own
load, the reference and its comparison) once per seed and per kind of
run, in one process, and prints each run's readings as a JSON line:

* ``program``: the program as the benchmark runs it (the lower
  readings);
* ``control``: the reference computed one precision below the
  configuration's in the program's place (the upper readings);
* ``half_batch`` (training cells): the program's step given half of
  each batch, its losses the mean over that half (a fault the
  comparison has to catch).

The benchmark's own runs never run the control.  Lines also go to
``chiprun_out/control_<cell>.jsonl`` under the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from rlbench.run import cache_env, forbidden_modules
from rlbench.spec import ROOT, cell as load_cell


def half_batch(build):
    """``build``'s program with each step given the first half of its
    batch."""
    def wrapped(config, trees, seed, device):
        state, step = build(config, trees, seed, device)

        def halved(st, batch):
            half = batch["images"].shape[0] // 2
            return step(st, {k: v[:half] for k, v in batch.items()})
        return state, halved
    return wrapped


def main(argv=None):
    p = argparse.ArgumentParser(description="correctness readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", default="program,control")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    cache_env(ROOT)
    import torch

    from rlbench import port, refrun, serve, train
    cell = load_cell(args.workload)
    kind = cell["traffic"]["kind"]
    loop = serve if kind == "serve" else train
    mode = refrun.control_mode(cell["config"])
    builders = {
        "program": None,
        "control": (refrun.serving_control(mode) if kind == "serve"
                    else refrun.training_control(mode)),
        "half_batch": half_batch(port.training),
    }
    device = torch.device("cuda", 0)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    log = os.path.join(out_dir, f"control_{args.workload}.jsonl")
    for what in args.what.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            res = loop.run(cell, seed, args.seconds, False, device, t0,
                           program=builders[what])
            line = json.dumps({"cell": args.workload, "what": what,
                               "seed": seed, "readings": res["readings"],
                               "correct": res["correct"],
                               "attempted": res["attempted"],
                               "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            with open(log, "a") as f:
                f.write(line + "\n")
            torch.cuda.empty_cache()
    if forbidden_modules():
        raise SystemExit("loaded " + ", ".join(forbidden_modules()))


if __name__ == "__main__":
    main()
