import torch

from rlbench.traffic import frames_per_clip, serve_request, train_window

from conftest import tiny_cell

SEED = 2 ** 31 + 11


def test_serve_request_repeats_for_a_seed(cpu):
    t = tiny_cell("hsm_fastpath_bf16.batch8")["traffic"]
    a = serve_request(t, (64, 96), SEED, 5, cpu)
    b = serve_request(t, (64, 96), SEED, 5, cpu)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = serve_request(t, (64, 96), SEED, 6, cpu)
    assert not torch.equal(a[2], c[2])
    d = serve_request(t, (64, 96), SEED + 1, 5, cpu)
    assert not torch.equal(a[0], d[0])


def test_serve_request_shapes_and_person(cpu):
    t = tiny_cell("hsm_standard_f32.single")["traffic"]
    t["keyframes"] = 8
    motion, conf, keys = serve_request(t, (320, 480), SEED, 0, cpu)
    assert motion.shape == (1, 19, 2, 8) and conf.shape == (1, 19, 1, 8)
    assert keys.shape == (1, 8, 320, 480, 3)
    px = motion * 256 + 256
    assert px[:, :, 0].min() >= 0 and px[:, :, 0].max() < 480
    assert px[:, :, 1].min() >= 0 and px[:, :, 1].max() < 320
    # a person, not joints scattered over the frame
    assert (px[:, :, 1].max() - px[:, :, 1].min()) < 320
    assert frames_per_clip(t) == 29


def test_train_window_repeats_and_differs(cpu):
    t = tiny_cell("hsm_standard_f32.train")["traffic"]
    a = train_window(t, 2, 3, (64, 96), SEED, 0, cpu)
    b = train_window(t, 2, 3, (64, 96), SEED, 0, cpu)
    c = train_window(t, 2, 3, (64, 96), SEED, 1, cpu)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["images"], c["images"])
    assert a["images"].dtype == torch.uint8
    assert a["poses"].shape == (2, 3, 19, 3)
    xy = a["poses"][..., :2]
    assert xy.min() >= 10 and xy[..., 0].max() <= 86
