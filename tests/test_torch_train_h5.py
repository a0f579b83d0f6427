"""The port's renderer training from a HumanSloMo h5
(``renderloom_torch.cli.train_renderer --h5``) and the pieces it brings
in, against the JAX package where it has them:

* the CLI on a tiny h5 (``_torch_parity.write_hsm_h5``) at 64×96 with
  the smoke config's widths, the curriculum growing the window from 3
  to 4 frames after epoch 2: the windows fed to each step equal JAX's
  ``HsmReader.batches`` under the same seed, bit for bit, across the
  change; ``train/`` records every step (the logging interval set to 1),
  ``eval/`` records after epoch 4, the checkpoint, and a resume;
* without VGG19 weights the CLI refuses unless ``--allow-random-vgg``;
* the VGG19 loaders (``.npz`` and ``.pth`` of a random torchvision state
  dict at the real shapes) against JAX's: the features at 32×32 to 1e-5
  of their largest;
* ``Prefetcher``, ``MetricLogger`` (lines equal to JAX's but for the
  time), ``trace``, and ``MotionDiscriminator`` against flax (1e-5).
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import single_thread, t, write_hsm_h5  # noqa: F401
from renderloom.core.logging import MetricLogger as JLogger
from renderloom.data.hsm import HsmReader as JReader
from renderloom.models import motion_discriminator as JMD
from renderloom.models import perceptual as JPerc
from renderloom_torch import convert
from renderloom_torch.cli import train_renderer
from renderloom_torch.core.checkpoint import read_renderer
from renderloom_torch.core.logging import MetricLogger
from renderloom_torch.data.prefetch import Prefetcher, prefetch
from renderloom_torch.models import motion_discriminator as TMD
from renderloom_torch.models import perceptual as TPerc
from renderloom_torch.utils.profiling import StepTimer, annotate, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = {"clip_a": 4, "clip_b": 5}
TEST = {"test_x": 9}


@pytest.fixture(scope="module")
def hsm(tmp_path_factory):
    root = tmp_path_factory.mktemp("hsm")
    path = str(root / "hsm.h5")
    write_hsm_h5(path, TRAIN, 48, 72, seed=1, phases=("train",))
    import h5py
    with h5py.File(path, "a") as f:               # the test clip's gt_*
        src = str(root / "test.h5")
        write_hsm_h5(src, TEST, 48, 72, seed=2, phases=("gt",))
        with h5py.File(src, "r") as g:
            g.copy("test_x", f)
    with open(os.path.join(ROOT, "configs", "smoke_hsm.yaml")) as f:
        text = f.read()
    cfg = root / "hsm.yaml"
    cfg.write_text(text.replace("  eval_frames: 3", "  eval_frames: 3\n"
                                "  update_frame_step: 2\n"
                                "  train_video_list: [clip_a, clip_b]\n"
                                "  test_video_list: [test_x]"))
    return root, path, str(cfg)


def _args(path, cfg, out, *extra):
    return ["--h5", path, "--config", cfg, "--device", "cpu", "--height",
            "64", "--width", "96", "--seed", "5", "--allow-random-vgg",
            "--out-dir", out, *extra]


def _lines(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_windows_eval_checkpoint_and_resume(hsm, monkeypatch):
    root, path, cfg = hsm
    monkeypatch.setattr(train_renderer, "TRAIN_LOG_EVERY", 1)
    seen = []
    real = train_renderer.make_gan_train_step

    def recording(*a, **kw):
        step = real(*a, **kw)

        def run(state, batch):
            seen.append({k: v.numpy().copy() for k, v in batch.items()})
            return step(state, batch)
        return run

    monkeypatch.setattr(train_renderer, "make_gan_train_step", recording)
    out = str(root / "run")
    res = train_renderer.main(_args(path, cfg, out, "--epochs", "4"))

    # the windows, bit for bit JAX's reader under the same seed
    reader = JReader(path, list(TRAIN), "train", 3)
    rng = np.random.default_rng(5)
    want = []
    for epoch in range(4):
        if 3 + epoch // 2 != reader.max_frames:
            reader.set_max_frames(3 + epoch // 2)
        want += list(reader.batches(rng, 2))
    assert len(seen) == len(want) == 2 + 2 + 1 + 1
    for got, w in zip(seen, want):
        assert sorted(got) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(got[k], w[k].astype(got[k].dtype))
    assert [e["frames"] for e in res["epochs"]] == [3, 3, 4, 4]

    lines = _lines(out)
    train = [r for r in lines if "train/g/total" in r]
    evals = [r for r in lines if any(k.startswith("eval/") for k in r)]
    assert [r["step"] for r in train] == list(range(1, 7))
    assert [r["step"] for r in evals] == [6]
    assert sorted(k for k in evals[0] if k.startswith("eval/")) == sorted(
        f"eval/{a}_{m}" for a in ("DAIN", "OURS")
        for m in ("PSNR", "SSIM", "LPIPS"))
    for r in lines:
        assert all(np.isfinite(v) for v in r.values())
        assert r.get("train/notfinite/g", 0.0) == 0.0
    ckpt = os.path.join(out, "checkpoint.pt")
    params, stats = read_renderer(ckpt)
    assert params.keys() == convert.flax_trees(res["state"].gen)[0].keys()

    # a resume continues from the checkpoint's step
    seen.clear()
    again = train_renderer.main(_args(path, cfg, out, "--epochs", "5",
                                      "--resume"))
    assert again["state"].step > 6 and len(seen) > 0
    steps = [r["step"] for r in _lines(out) if "train/g/total" in r]
    assert steps[:6] == list(range(1, 7)) and steps[6] == 7
    assert steps[-1] == again["state"].step


def test_cli_requires_vgg_weights(hsm, monkeypatch, tmp_path):
    _, path, cfg = hsm
    monkeypatch.delenv("VGG19_NPZ", raising=False)
    monkeypatch.chdir(tmp_path)
    args = [a for a in _args(path, cfg, str(tmp_path / "o"), "--epochs", "1")
            if a != "--allow-random-vgg"]
    monkeypatch.setattr(TPerc, "find_vgg_weights", lambda: None)
    with pytest.raises(RuntimeError, match="--allow-random-vgg"):
        train_renderer.main(args)


def _torchvision_state(seed=0):
    """A random torchvision ``vgg19().features`` state dict at the real
    shapes (lecun-scaled, so features stay O(1))."""
    rng = np.random.default_rng(seed)
    state, ch = {}, 3
    for name, idx in TPerc.TORCHVISION_CONV_IDX.items():
        out = {1: 64, 2: 128, 3: 256, 4: 512, 5: 512}[int(name.split("_")[1])]
        state[f"features.{idx}.weight"] = (rng.normal(size=(out, ch, 3, 3))
                                           / np.sqrt(9 * ch)).astype(
                                               np.float32)
        state[f"features.{idx}.bias"] = (0.1 * rng.normal(size=out)).astype(
            np.float32)
        ch = out
    return state


def test_vgg19_loaders_match_jax(tmp_path):
    state = _torchvision_state()
    npz = str(tmp_path / "vgg.npz")
    np.savez(npz, **state)
    full = str(tmp_path / "vgg19.pth")
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}
               | {"classifier.0.weight": torch.zeros(2, 2)}, full)
    bare = str(tmp_path / "features.pth")
    torch.save({k[len("features."):]: torch.from_numpy(v)
                for k, v in state.items()}, bare)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    jmodel = JPerc.VGG19Features()
    for path in (npz, full, bare):
        jvars = (JPerc.load_torchvision_pth(path) if path.endswith(".pth")
                 else JPerc.load_torchvision_npz(path))
        tvars = (TPerc.load_torchvision_pth(path) if path.endswith(".pth")
                 else TPerc.load_torchvision_npz(path))
        for k, v in jvars["params"].items():
            for leaf in ("kernel", "bias"):
                np.testing.assert_array_equal(tvars["params"][k][leaf],
                                              np.asarray(v[leaf]))
        want = jax.jit(jmodel.apply)(jvars, jnp.asarray(x))
        loss = TPerc.PerceptualLoss(weights_path=path,
                                    require_pretrained=True)
        assert loss.pretrained
        with torch.no_grad():
            got = loss.model(t(x))
        for k, w in want.items():
            w = np.asarray(w)
            np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"{path} {k}")
    short = str(tmp_path / "short.pth")
    torch.save({k: torch.from_numpy(v) for k, v in state.items()
                if not k.startswith("features.34.")}, short)
    with pytest.raises(ValueError, match="15/16"):
        TPerc.load_torchvision_pth(short)


def test_find_vgg_weights_and_require_pretrained(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("VGG19_NPZ", raising=False)
    repo_npz = os.path.join(ROOT, "data", "vgg19_features.npz")
    if not os.path.exists(repo_npz):
        assert TPerc.find_vgg_weights() is None
        with pytest.raises(RuntimeError, match="no pretrained VGG19"):
            TPerc.PerceptualLoss(require_pretrained=True)
    path = str(tmp_path / "v.npz")
    np.savez(path, **_torchvision_state(1))
    monkeypatch.setenv("VGG19_NPZ", path)
    assert TPerc.find_vgg_weights() == JPerc.find_vgg_weights() == path
    os.makedirs(tmp_path / "data")
    os.replace(path, tmp_path / "data" / "vgg19_features.npz")
    monkeypatch.delenv("VGG19_NPZ")
    assert TPerc.find_vgg_weights() == JPerc.find_vgg_weights() == \
        "data/vgg19_features.npz"


def test_prefetcher_order_errors_and_close():
    assert list(prefetch(iter(range(20)), depth=3)) == list(range(20))

    def failing():
        yield 1
        raise KeyError("bad window")

    p = Prefetcher(failing(), depth=2)
    assert next(p) == 1
    with pytest.raises(KeyError, match="bad window"):
        next(p)
    with pytest.raises(StopIteration):
        next(p)

    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    p = Prefetcher(endless(), depth=2)
    assert [next(p) for _ in range(3)] == [0, 1, 2]
    p.close()
    p._thread.join(timeout=5)
    assert not p._thread.is_alive()
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) == n and n <= 3 + 2 + 2


def test_metric_logger_lines_match_jax(tmp_path, capsys):
    scalars = {"g/total": np.float32(1.25), "d/total": 3, "x": 0.1 + 0.2}
    for cls, name in ((MetricLogger, "port"), (JLogger, "jax")):
        log = cls(str(tmp_path / name))
        log.log(7, scalars, prefix="train/")
        log.log(8, {"OURS_PSNR": 30.5}, prefix="eval/")
        log.console(8, scalars, header="epoch 0 ")
    drop = lambda r: {k: v for k, v in r.items() if k != "time"}
    read = lambda n: [json.loads(line) for line in
                      open(tmp_path / n / "metrics.jsonl")]
    got, want = read("port"), read("jax")
    assert [drop(r) for r in got] == [drop(r) for r in want]
    assert [list(r) for r in got] == [list(r) for r in want]
    out = capsys.readouterr().out.splitlines()
    consoles = [line for line in out if line.startswith("[epoch 0 step 8]")]
    assert len(consoles) == 2 and consoles[0] == consoles[1]


def test_trace_writes_a_file(tmp_path):
    with trace(str(tmp_path / "prof")):
        with annotate("host_stage"):
            torch.ones(8).sum()
    files = sorted(os.listdir(tmp_path / "prof"))
    assert files == ["key_averages_0.txt", "trace_0.json"]
    with open(tmp_path / "prof" / "trace_0.json") as f:
        assert "host_stage" in f.read()
    timer = StepTimer()
    assert timer.tick() is None and timer.rate() is None
    timer.tick()
    assert timer.ema is not None and timer.rate(4) > 0


@pytest.mark.parametrize("patch", [False, True])
def test_motion_discriminator_matches_flax(patch):
    x = np.random.default_rng(2).normal(size=(2, 38, 33)).astype(np.float32)
    jm = JMD.MotionDiscriminator(use_patch_gan=patch, use_sigmoid=patch)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm = convert.load_flax_params(
        TMD.MotionDiscriminator(use_patch_gan=patch, use_sigmoid=patch),
        jax.device_get(variables["params"]))
    with torch.no_grad():
        got = tm(t(x)).numpy()
    assert got.shape == want.shape == ((2, 1, 9, 1) if patch
                                       else (2, 1, 1, 1))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(np.abs(want).max(), 1.0))
