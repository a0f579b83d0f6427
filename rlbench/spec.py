"""Where a cell's pieces are: ``BENCHMARK.json`` at the checkout's root,
and the files under ``rlbench/`` that the harness finds by name."""

from __future__ import annotations

import json
import os
from typing import Any, Dict

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict[str, Any]:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT) -> Dict[str, Any]:
    """The cell ``name`` with everything it names, loaded: ``entry`` (its
    line of ``workloads``), ``config`` (the configuration's file),
    ``traffic`` (``traffic/<mix>.json``), ``check`` (``cells/<name>.json``),
    ``end_to_end`` and ``per_layer`` (the metrics the cell reports)."""
    bench = benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    reports = lambda m: name in m.get("workloads", [name])
    return {
        "name": name,
        "entry": entry,
        "config": load_json(os.path.join(root, configs[entry["config"]]
                                         ["file"])),
        "traffic": load_json(os.path.join(HERE, "traffic",
                                          entry["traffic"] + ".json")),
        "check": load_json(os.path.join(HERE, "cells", name + ".json")),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
        "run_seconds": bench["run_seconds"],
    }
