"""Run one cell of the benchmark once and print its result as the last
line of standard output.

    python -m rlbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``,
``rlbench/`` and the program (``renderloom_torch/``).  The cell's
traffic mix names the loop (``serve`` or ``train``).  With a cell or a
build that is not there, without a CUDA device, with fewer devices than
the cell asks for, without the program beside the benchmark, or when
the run has loaded JAX or the JAX package, it exits with a code other
than 0 and prints no result.  The program's kernel builds and caches go
to fixed directories inside the checkout.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()        # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# top-level module names a run must not load, compared whole: the
# program's own name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "renderloom")
LOOPS = {"serve": "rlbench.serve", "train": "rlbench.train"}


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def cache_env(root: str):
    """Every build and kernel cache at a fixed path in the checkout (the
    port's own nvcc builds go to ``build/renderloom_torch/`` there)."""
    cache = os.path.join(root, "build", "rlbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ.pop("VGG19_NPZ", None)   # the benchmark hands VGG19 in


def fail(msg: str, code: int = 2):
    print(f"rlbench: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        fail(f"--seed {args.seed}: a whole number from 0")

    from rlbench import builds, spec
    try:
        cell = spec.cell(args.workload)
        builds.name_of(cell["config"])
    except LookupError as e:
        fail(e.args[0])
    if not os.path.isdir(os.path.join(spec.ROOT, "renderloom_torch")):
        fail(f"no renderloom_torch beside rlbench in {spec.ROOT}")
    cache_env(spec.ROOT)
    sys.path.insert(0, spec.ROOT)

    import torch
    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if torch.cuda.device_count() < chips:
        fail(f"{torch.cuda.device_count()} CUDA devices; the cell asks "
             f"for {chips}")
    import renderloom_torch
    where = os.path.dirname(os.path.abspath(renderloom_torch.__file__))
    if os.path.dirname(where) != spec.ROOT:
        fail(f"renderloom_torch loaded from {where}, not from the checkout")

    import importlib
    loop = importlib.import_module(LOOPS[cell["traffic"]["kind"]])
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = loop.run(cell, args.seed, args.seconds, bool(args.trace),
                      device, T0)

    found = forbidden_modules()
    if found:
        fail("the run loaded " + ", ".join(found))
    from rlbench.check import report
    report(result["check"])
    print(json.dumps(result))


if __name__ == "__main__":
    main()
