"""The PyTorch port's flow and pose CLIs on the CPU at tiny sizes:
``train_flow`` and ``train_pose`` (synthetic data drawn as the JAX CLIs
draw it, a HumanSloMo h5, checkpoint and resume), ``extract_pose``,
``infer_renderer --flow-ckpt`` and, last, the pipeline CLI with
``--pose-ckpt`` and ``--flow-ckpt`` on ``.npz`` weights, whose pose and
background stages must give what the CLIs' functions give on the same
files.  The models' arithmetic is held to JAX by
tests/test_torch_flownet.py and tests/test_torch_posenet.py."""

import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import renderloom_torch.core.config as TC
from _torch_parity import blobs, single_thread, write_hsm_h5  # noqa: F401
from renderloom.cli import train_flow as JTF
from renderloom.cli import train_pose as JTP
from renderloom_torch.cli import (extract_pose, infer_renderer, pipeline,
                                  train_flow, train_pose)
from renderloom_torch.convert import flax_trees, random_init_
from renderloom_torch.models.layers import enable_spectral_norm
from renderloom_torch.models.motion_transformer import init_motion_params
from renderloom_torch.models.renderer import Generator
from renderloom_torch.core import checkpoint
from renderloom_torch.data import openpose
from renderloom_torch.data.amass import stats_paths

H, W, K, RATE = 64, 96, 3, 2
FLOW = {"base_filters": 4, "levels": 2, "batch_size": 2, "max_disp": 4}
POSE = {"base_filters": 8, "blocks": 1, "batch_size": 2}


def _yaml(path, raw) -> str:
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return str(path)


def _pngs(d) -> np.ndarray:
    return np.stack([np.asarray(Image.open(os.path.join(d, f)))
                     for f in sorted(os.listdir(d))])


def test_synthetic_data_is_the_jax_cli_s():
    for port, jax_fn, args in (
            (train_flow.synthetic_triplets, JTF.synthetic_triplets,
             (2, 2, 16, 24)),
            (train_pose.synthetic_batches, JTP.synthetic_batches,
             (2, 2, 16, 24))):
        got = list(port(np.random.default_rng(5), *args))
        want = list(jax_fn(np.random.default_rng(5), *args))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("cli,argv", [
    (train_flow, ["--synthetic", "--out-dir", "."]),
    (train_pose, ["--synthetic", "--out-dir", "."]),
    (extract_pose, ["--ckpt", "p.npz", "--frames", ".", "--poses", "."]),
])
def test_cuda_is_the_default_device(cli, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Tiny configs, the flow UNet and the pose head trained by their
    CLIs for 2 steps (checkpoints and their ``.npz`` copies), motion and
    renderer ``.npz`` weights, keyframes."""
    root = tmp_path_factory.mktemp("flowpose")
    out = {"flow_cfg": _yaml(root / "flow.yaml", FLOW),
           "pose_cfg": _yaml(root / "pose.yaml", POSE)}
    common = ["--synthetic", "--epochs", "1", "--steps-per-epoch", "2",
              "--height", "32", "--width", "48", "--device", "cpu"]
    for name, cli in (("flow", train_flow), ("pose", train_pose)):
        extra = ["--occlude-rate", "0.5"] if name == "pose" else []
        run = cli.main(common + extra + ["--config", out[f"{name}_cfg"],
                                         "--out-dir", str(root / name)])
        assert run["state"].step == 2
        out[f"{name}.pt"] = str(root / name / "checkpoint.pt")
        out[f"{name}.npz"] = str(root / f"{name}.npz")
        checkpoint.write_npz(out[f"{name}.npz"],
                             flax_trees(run["state"].model)[0])
        out[f"{name}_run"] = run

    stats = root / "stats"
    stats.mkdir()
    out["motion_cfg"] = _yaml(root / "motion.yaml", {
        "transformer": {"hidden_dim": 32, "nheads": 4,
                        "dim_feedforward": 64, "enc_layers": 2,
                        "dec_layers": 2, "dropout": 0.0},
        "pos_encode": {"hidden_dim": 32},
        "dataset": {"data_root": str(stats)}})
    for path, arr in zip(
            stats_paths(TC.load_motion_config(out["motion_cfg"]).dataset),
            (np.zeros((19, 2)), np.full((19, 2), 0.02))):
        np.save(path, arr.astype(np.float32))
    out["renderer_cfg"] = _yaml(root / "renderer.yaml", {
        "gen": {"num_filters": 4, "max_num_filters": 16, "num_layers": 6,
                "num_downsamples": 4, "do_checkpoint": False,
                "mask": {"num_filters": 4, "max_num_filters": 16,
                         "num_downsamples": 3, "num_res_blocks": 2},
                "embed": {"num_filters": 4, "max_num_filters": 16,
                          "num_downsamples": 4}},
        "data": {"model_width": W, "model_height": H, "load_width": W,
                 "load_height": H}})
    # seeded port weights (the JAX trees' structure, built without JAX)
    out["motion.npz"] = str(root / "motion.npz")
    checkpoint.write_npz(out["motion.npz"], flax_trees(init_motion_params(
        TC.load_motion_config(out["motion_cfg"]), 2))[0])
    out["renderer.npz"] = str(root / "renderer.npz")
    gen = Generator(TC.load_renderer_config(out["renderer_cfg"]).gen)
    checkpoint.write_npz(out["renderer.npz"], *flax_trees(
        random_init_(enable_spectral_norm(gen), 4)))
    frames = root / "frames"
    frames.mkdir()
    for i, key in enumerate((blobs(K, H, W, seed=3) * 255).astype(np.uint8)):
        Image.fromarray(key).save(frames / f"{i:03d}.png")
    out["frames"], out["root"] = str(frames), root
    return out


def test_resume_continues_from_the_checkpoint(work, tmp_path):
    for name, cli in (("flow", train_flow), ("pose", train_pose)):
        shutil.copytree(work["root"] / name, tmp_path / name)
        run = cli.main(["--synthetic", "--epochs", "2", "--steps-per-epoch",
                        "2", "--height", "32", "--width", "48", "--device",
                        "cpu", "--config", work[f"{name}_cfg"], "--out-dir",
                        str(tmp_path / name), "--resume"])
        assert run["state"].step == 4
        assert [e["epoch"] for e in run["epochs"]] == [1]
        assert torch.load(tmp_path / name / "checkpoint.pt")["step"] == 4


def test_training_from_an_h5(work, tmp_path, monkeypatch):
    h5 = write_hsm_h5(str(tmp_path / "hsm.h5"), {"a": 4, "b": 3}, 40, 60,
                      phases=("train",))
    for name, cli in (("flow", train_flow), ("pose", train_pose)):
        monkeypatch.setattr(cli, "TRAIN_LOG_EVERY", 1)
        run = cli.main(["--h5", h5, "--epochs", "1", "--height", "32",
                        "--width", "48", "--device", "cpu", "--config",
                        work[f"{name}_cfg"], "--out-dir",
                        str(tmp_path / name)])
        # flow: 3 triplets in 2 clips, pose: 7 frames; batches of 2
        assert run["state"].step == {"flow": 1, "pose": 3}[name]
        with open(tmp_path / name / "metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
        assert len(recs) == run["state"].step
        assert all(np.isfinite(v) for r in recs for k, v in r.items()
                   if k.startswith("train/"))


def test_extract_pose_cli_on_both_checkpoint_formats(work, tmp_path):
    for fmt in ("pose.pt", "pose.npz"):
        n = extract_pose.main(["--ckpt", work[fmt], "--config",
                               work["pose_cfg"], "--frames", work["frames"],
                               "--poses", str(tmp_path / fmt), "--height",
                               "32", "--width", "48", "--device", "cpu"])
        assert n == K
    names = sorted(os.listdir(tmp_path / "pose.pt"))
    assert names == [f"{i:03d}_keypoints.json" for i in range(K)]
    for f in names:
        a, b = (json.load(open(tmp_path / d / f)) for d in ("pose.pt",
                                                            "pose.npz"))
        assert a == b
    motion, conf, _ = openpose.read_openpose_dir(str(tmp_path / "pose.pt"))
    assert motion.shape == (19, 2, K) and np.isfinite(motion).all()


def test_infer_renderer_with_the_learned_flow(work, tmp_path):
    clip = tmp_path / "clip"
    (clip / "inputs").mkdir(parents=True)
    for f in os.listdir(work["frames"]):
        Image.open(os.path.join(work["frames"], f)).save(clip / "inputs" / f)
    n = (K - 1) * RATE + 1
    rng = np.random.default_rng(0)
    motion = np.stack([rng.uniform(-0.47, -0.34, (19, n)),
                       rng.uniform(-0.48, -0.4, (19, n))], axis=1)
    openpose.write_openpose_dir(motion, np.full((19, 1, n), 0.9),
                                str(clip / "Predict_motion"))
    infer_renderer.main(["--ckpt", work["renderer.npz"], "--config",
                         work["renderer_cfg"], "--input-dir", str(clip),
                         "--upsample-rate", str(RATE), "--flow-ckpt",
                         work["flow.pt"], "--flow-config", work["flow_cfg"],
                         "--device", "cpu"])
    assert len(os.listdir(clip / "Generated_frames")) == n
    want = tmp_path / "want"
    interp = infer_renderer.load_flow_interp(work["flow.npz"],
                                             work["flow_cfg"], "cpu")
    infer_renderer.synthesize_backgrounds(work["frames"], str(want), RATE,
                                          "cpu", interp)
    np.testing.assert_array_equal(_pngs(clip / "DAIN"), _pngs(want))


def test_pipeline_with_pose_and_flow_checkpoints(work, tmp_path):
    out = tmp_path / "out"
    seconds = pipeline.main([
        "--frames-dir", work["frames"], "--pose-ckpt", work["pose.npz"],
        "--pose-config", work["pose_cfg"], "--motion-ckpt",
        work["motion.npz"], "--motion-config", work["motion_cfg"],
        "--renderer-ckpt", work["renderer.npz"], "--renderer-config",
        work["renderer_cfg"], "--out-dir", str(out), "--rate", str(RATE),
        "--flow-ckpt", work["flow.npz"], "--flow-config", work["flow_cfg"],
        "--device", "cpu"])
    assert sorted(seconds) == ["background", "motion", "pose", "render"]
    # stage 0 is extract_pose at 256x384; stage 2 the learned backgrounds
    extract_pose.main(["--ckpt", work["pose.pt"], "--config",
                       work["pose_cfg"], "--frames", work["frames"],
                       "--poses", str(tmp_path / "poses"), "--device",
                       "cpu"])
    for f in sorted(os.listdir(tmp_path / "poses")):
        assert json.load(open(out / "poses" / f)) == \
            json.load(open(tmp_path / "poses" / f))
    infer_renderer.synthesize_backgrounds(
        work["frames"], str(tmp_path / "dain"), RATE, "cpu",
        infer_renderer.load_flow_interp(work["flow.pt"], work["flow_cfg"],
                                        "cpu"))
    np.testing.assert_array_equal(_pngs(out / "DAIN"),
                                  _pngs(tmp_path / "dain"))
    got = _pngs(out / "Generated_frames")
    assert got.shape == ((K - 1) * RATE + 1, H, W, 3)
    assert len(os.listdir(out / "Predict_motion")) == (K - 1) * RATE + 1
