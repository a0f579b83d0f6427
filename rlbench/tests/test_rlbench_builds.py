"""A configuration's build, found by name (``rlbench/builds/``): the
default is ``hsm``; an unknown name stops a run before its set-up; and
a build planted on the search path, with a tree of its own after
``hsm``'s, runs through the serving loop and is judged like the cells'
own."""

import copy
import importlib
import math
import sys
import time

import numpy as np
import pytest
import torch

from rlbench import builds, port, refrun, run, serve, spec
from rlbench.traffic import serve_request
from rlbench.weights import make_trees, motion_stats

from conftest import tiny_cell

SEED = 2 ** 31 + 41

PLANTED = '''
"""hsm's serving with one tree of its own after hsm's: a 1x1 colour mix
of every output frame, the same on both sides."""
import torch

from rlbench.builds import hsm
from rlbench.weights import tree_spec

program_training = hsm.program_training
reference_training = hsm.reference_training


def specs(config, kind):
    out = hsm.specs(config, kind)
    with torch.device("meta"):
        out["mix"] = tree_spec(torch.nn.Conv2d(3, 3, 1))
    return out


def _mix(frames, trees):
    params = trees["mix"][0]
    k = torch.as_tensor(params["kernel"][0, 0], device=frames.device)
    b = torch.as_tensor(params["bias"], device=frames.device)
    x = frames.float()
    return x + 0.1 * (x @ k) + b


def program_serving(config, traffic, trees, stats, device):
    fn = hsm.program_serving(config, traffic, trees, stats, device)

    def served(*inputs):
        fused, sync = fn(*inputs)
        return _mix(fused, trees), sync
    return served


def reference_serving(config, traffic, trees, stats, device):
    fn = hsm.reference_serving(config, traffic, trees, stats, device)
    return lambda *inputs: _mix(fn(*inputs), trees)
'''


@pytest.fixture
def planted(tmp_path, monkeypatch):
    """``planted`` on the builds' search path for one test."""
    (tmp_path / "planted.py").write_text(PLANTED)
    monkeypatch.setattr(builds, "__path__",
                        list(builds.__path__) + [str(tmp_path)])
    monkeypatch.delitem(sys.modules, "rlbench.builds.planted",
                        raising=False)
    importlib.invalidate_caches()
    yield "planted"
    sys.modules.pop("rlbench.builds.planted", None)


def _leaves(tree, path=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _same_trees(a, b):
    assert a.keys() == b.keys()
    for name in a:
        for part in (0, 1):
            la = dict(_leaves(a[name][part]))
            lb = dict(_leaves(b[name][part]))
            assert la.keys() == lb.keys()
            for k in la:
                np.testing.assert_array_equal(la[k], lb[k],
                                              err_msg=str(k))


def _with_build(cell, name):
    cell = copy.deepcopy(cell)
    cell["config"]["build"] = name
    return cell


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_no_build_key_draws_the_trees_of_hsm(kind, cpu):
    name = ("hsm_standard_f32.single" if kind == "serve"
            else "hsm_standard_f32.train")
    config = tiny_cell(name)["config"]
    assert "build" not in config
    named = _with_build({"config": config}, "hsm")["config"]
    assert builds.load(config) is builds.load(named)
    assert builds.load(config).__name__ == "rlbench.builds.hsm"
    _same_trees(make_trees(refrun.specs(config, kind), SEED, cpu),
                make_trees(refrun.specs(named, kind), SEED, cpu))


def test_no_build_key_serves_as_hsm_on_both_sides(cpu):
    cell = tiny_cell("hsm_standard_f32.single")
    config, traffic = cell["config"], cell["traffic"]
    named = _with_build(cell, "hsm")["config"]
    stats = motion_stats()
    inputs = serve_request(traffic, (64, 96), SEED, 0, cpu)
    got = {}
    for key, c in (("default", config), ("named", named)):
        trees = make_trees(refrun.specs(c, "serve"), SEED, cpu)
        fused, _ = port.serving(c, traffic, trees, stats, cpu)(*inputs)
        with torch.inference_mode(), refrun.precision("float32"):
            want = refrun.serving(c, traffic, trees, stats, cpu)(*inputs)
        got[key] = (fused, want)
    assert torch.equal(got["default"][0], got["named"][0])
    assert torch.equal(got["default"][1], got["named"][1])


def test_an_unknown_build_stops_the_run_before_set_up(monkeypatch,
                                                      capsys):
    name = "hsm_fastpath_bf16.single"
    cell = _with_build(spec.cell(name), "nope")
    monkeypatch.setattr(spec, "cell", lambda *a, **k: cell)
    set_up = []
    monkeypatch.setattr(run, "cache_env", set_up.append)
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", name, "--seed", str(SEED),
                  "--seconds", "1"])
    assert e.value.code not in (0, None)
    assert not set_up
    err = capsys.readouterr().err
    assert f"rlbench: no build 'nope'; have {builds.names()}" in err
    assert "hsm" in builds.names()
    with pytest.raises(LookupError, match="have"):
        builds.load(cell["config"])


def test_an_unknown_cell_stops_the_run(capsys):
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "nope.single", "--seed", str(SEED),
                  "--seconds", "1"])
    assert e.value.code not in (0, None)
    assert "rlbench: no workload 'nope.single'" in capsys.readouterr().err


def _normal_draws(specs):
    """``{(tree, path): global offsets of its normal draws}``, and the
    count of normal draws, as ``make_trees`` orders them."""
    out, pos = {}, 0
    for name, spec_ in specs.items():
        for path, key, shape, kind, _ in spec_:
            if kind == "normal":
                n = math.prod(shape)
                out[(name, tuple(path) + (key,))] = (pos, n)
                pos += n
    return out, pos


def test_a_planted_build_keeps_the_draws_of_hsm(planted, cpu):
    config = tiny_cell("hsm_standard_f32.single")["config"]
    own = _with_build({"config": config}, planted)["config"]
    specs = refrun.specs(own, "serve")
    assert list(specs) == ["gen", "motion", "mix"]
    base = make_trees(refrun.specs(config, "serve"), SEED, cpu)
    got = make_trees(specs, SEED, cpu)
    offsets, n = _normal_draws(refrun.specs(config, "serve"))
    moved = 0
    for name in base:
        for part in (0, 1):
            la = dict(_leaves(base[name][part]))
            lb = dict(_leaves(got[name][part]))
            assert la.keys() == lb.keys()
            for k in la:
                differ = (la[k] != lb[k]).reshape(-1)
                if not differ.any():
                    continue
                # the CPU's torch.randn draws the last 16 values of a
                # call whose length is not a multiple of 16 anew; on the
                # card hsm's draws are a prefix (see the card test)
                start, _ = offsets[(name, k)]
                at = start + np.flatnonzero(differ)
                assert n % 16 and (at >= n - 16).all(), (name, k)
                moved += differ.sum()
    assert moved <= 16
    assert got["mix"][0]["kernel"].shape == (1, 1, 3, 3)


def test_a_planted_build_is_judged_by_the_loop(planted):
    cell = _with_build(tiny_cell("hsm_standard_f32.single"), planted)
    res = serve.run(cell, SEED, 0.5, False, torch.device("cpu"),
                    time.perf_counter())
    assert res["correct"], res["check"]
    assert res["readings"]["frame_gap"] < 1e-4

    def altered(config, traffic, trees, stats, device):
        fn = port.serving(config, traffic, trees, stats, device)

        def broken(*inputs):
            fused, sync = fn(*inputs)
            fused = fused.clone()
            fused[:, 1] = 1.0 - fused[:, 1]     # one frame of each clip
            return fused, sync
        return broken

    res = serve.run(cell, SEED, 0.5, False, torch.device("cpu"),
                    time.perf_counter(), program=altered)
    assert not res["correct"], res["check"]


def test_a_planted_build_keeps_the_draws_of_hsm_on_the_card(planted,
                                                            card):
    """At the published widths each tree of hsm's is drawn bit for bit
    as without the planted tree after it."""
    config = spec.cell("hsm_fastpath_bf16.single")["config"]
    own = _with_build({"config": config}, planted)["config"]
    base = make_trees(refrun.specs(config, "serve"), SEED, card)
    got = make_trees(refrun.specs(own, "serve"), SEED, card)
    assert set(got) == set(base) | {"mix"}
    _same_trees(base, {k: got[k] for k in base})
