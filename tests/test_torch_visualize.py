"""The visualization utilities and the registry of the PyTorch port
(``renderloom_torch/utils/visualize.py``: ``print_evaluation``,
``render_skeleton_frames``, ``motion2gif``; ``core/registry.py``)
against the JAX package's.

``render_skeleton_frames`` runs K1's plain twin in the cfhw layout here
(the card runs the kernel, held to the twin bit for bit by
``chip_smoke.py`` phase SK).  Against JAX's ``skeleton_image`` the
uint8 frames differ only where a pixel's colour average (a sum over the
limbs covering it, which the twin adds in limb order and XLA's einsum in
its own) lands on the other side of a level: at 64×64 with the joints in
the frame the reading is 0 of 61,440 values; the test allows one level
on at most 0.1% of them.
"""

import numpy as np
import pytest

import renderloom_torch.data.amass  # noqa: F401 (registers "amass")
import renderloom_torch.data.hsm  # noqa: F401 (registers "hsm")
from chip_smoke import skeleton_motion
from renderloom.utils import visualize as JV
from renderloom_torch.core.registry import (CROP_FUNCS, DATASETS, MODELS,
                                            Registry)
from renderloom_torch.utils import visualize as TV

N = 64


def _pixels(L: int, seed: int) -> np.ndarray:
    """A normalized motion scaled into a 64×64 frame (×20 + 32)."""
    return skeleton_motion(L, seed).astype(np.float64) * 20.0 + 32.0


@pytest.mark.parametrize("L,chunk", [(5, 32), (7, 3)])
def test_skeleton_frames_match_jax(L, chunk, monkeypatch):
    """Chunks of 3 frames give the frames of one launch."""
    monkeypatch.setattr(TV, "SKELETON_CHUNK", chunk)
    pixels = _pixels(L, 1)
    got = TV.render_skeleton_frames(pixels, N, N, "cpu")
    want = JV.render_skeleton_frames(pixels, N, N)
    assert got.shape == want.shape == (L, N, N, 3)
    assert got.dtype == np.uint8 and got.any()
    diff = np.abs(got.astype(int) - want.astype(int))
    share = float((diff > 0).mean())
    print(f"{L} frames: {share:.4%} of values differ, at most "
          f"{diff.max()} level")
    assert diff.max() <= 1 and share <= 1e-3


def test_skeleton_frames_refuse_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TV.render_skeleton_frames(_pixels(2, 0), N, N)


def test_motion2gif_frame_count(tmp_path):
    imageio = pytest.importorskip("imageio.v2")
    motion = skeleton_motion(6, 2)
    path = TV.motion2gif(motion, str(tmp_path / "skel.gif"), N, N,
                         scale=20.0, offset=32.0, device="cpu")
    want = JV.motion2gif(motion, str(tmp_path / "jax.gif"), N, N,
                         scale=20.0, offset=32.0)
    frames = imageio.mimread(path)
    assert len(frames) == len(imageio.mimread(want)) == 6
    assert frames[0].shape[:2] == (N, N)


def test_print_evaluation_matches_jax(tmp_path, capsys):
    results = {"mse": 0.5, "accel": 1.25e-3, "PSNR": 31.0}
    mine, ref = str(tmp_path / "a" / "history.txt"), \
        str(tmp_path / "b" / "history.txt")
    for epoch in (3, 4):
        got = TV.print_evaluation(results, epoch, mine)
        want = JV.print_evaluation(results, epoch, ref)
        assert got == want
    out = capsys.readouterr().out
    assert out.count("evaluation (epoch 3)") == 2
    with open(mine) as f, open(ref) as g:
        assert f.read() == g.read()


def test_registry_behaviour():
    reg = Registry("things")

    @reg.register()
    def alpha():
        return 1

    reg.register("beta")(lambda: 2)
    assert "alpha" in reg and "beta" in reg and "gamma" not in reg
    assert list(reg) == ["alpha", "beta"]
    assert reg.get("alpha") is alpha and reg.get("beta")() == 2
    with pytest.raises(KeyError, match="already registered in 'things'"):
        reg.register("alpha")(lambda: 3)
    with pytest.raises(KeyError, match="'gamma' not found in registry "
                       "'things'; known: alpha, beta"):
        reg.get("gamma")


def test_datasets_registered_as_in_jax():
    from renderloom.core.registry import DATASETS as JD
    from renderloom_torch.data.amass import AmassReader
    from renderloom_torch.data.hsm import HsmReader

    import renderloom.data.amass  # noqa: F401
    import renderloom.data.hsm  # noqa: F401

    assert DATASETS.get("hsm") is HsmReader
    assert DATASETS.get("amass") is AmassReader
    assert sorted(DATASETS) == sorted(JD) == ["amass", "hsm"]
    assert [r.name for r in (DATASETS, MODELS, CROP_FUNCS)] == \
        ["datasets", "models", "crop_funcs"]
