"""The shift warp as a gather (``renderloom_torch/ops/shiftwarp_kernel.py``)
on the CPU: its plain twins against the shift loop of ``ops/flow.py``
bit for bit (``torch.equal``), the warp alone and fused with the Lucas-
Kanade backgrounds' time blend; the routing in ``backward_warp_shift``
and ``upsample_background``: only float32 card tensors that want no
gradient take the kernels, with ``flow_scale > 1``; both registered
operators; the wrappers' checks.  The CUDA kernels themselves are held
on the card by ``chip_smoke.py`` (phase SW).
"""

import pytest
import torch

from _torch_parity import single_thread  # noqa: F401
from renderloom_torch.models import flownet
from renderloom_torch.ops import flow as flow_ops
from renderloom_torch.ops import shiftwarp_kernel as SK

LK = dict(levels=3, iters=1, flow_scale=4)     # the serving pipeline's


def _loop(img, flow, R):
    """``backward_warp_shift`` as the loop computes it, whatever the
    device."""
    out = flow_ops._shift_resample1d(img, flow[..., 0], 2, R)
    return flow_ops._shift_resample1d(out, flow[..., 1], 1, R)


def _flow(B, H, W, R, seed):
    """Flows that reach past ±R, integers among them, pointing off the
    frame's edges and corners, and rows whose x-flow differs from the
    rows next to them."""
    g = torch.Generator().manual_seed(seed)
    f = torch.randn((B, H, W, 2), generator=g) * (1.5 * R)
    f[:, ::3] = f[:, ::3].round()                       # integer rows
    f[:, 1::2, :, 0] = -f[:, 1::2, :, 0] + 0.25         # alternate rows
    f[:, 0, 0] = torch.tensor([-(R + 3.0), -(R + 0.5)])   # top-left out
    f[:, -1, -1] = torch.tensor([R + 2.0, R + 0.0])       # bottom-right
    f[:, 0, -1] = torch.tensor([float(R), -float(R)])     # exactly ±R
    f[:, -1, 0] = torch.tensor([-0.5, 0.75])
    return f


@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("R", [1, 4, 16])
def test_twin_equals_the_shift_loop(R, C, B):
    g = torch.Generator().manual_seed(R * 10 + C)
    img = torch.rand((B, 9, 13, C), generator=g) * 2 - 1
    flow = _flow(B, 9, 13, R, seed=B)
    got = SK.shift_warp_plain(img, flow, R)
    assert got.shape == img.shape and got.dtype == torch.float32
    assert torch.equal(got, _loop(img, flow, R))


def _keys(K, seed, H=32, W=48):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((K, H, W, 3), generator=g)


def _full_res(frames):
    """The full-resolution flows and errors ``upsample_background``
    hands to the blend at ``LK``, caught at :func:`blend_stream`."""
    seen = {}
    real = flow_ops.blend_stream

    def spy(frames, flows, errs, rate, warp):
        seen.update(flows=flows, errs=errs)
        return real(frames, flows, errs, rate, warp)
    flow_ops.blend_stream = spy
    try:
        want = flow_ops.upsample_background(frames, 4, **LK)
    finally:
        flow_ops.blend_stream = real
    return want, seen["flows"], seen["errs"]


@pytest.mark.parametrize("rate", [2, 3, 4])
@pytest.mark.parametrize("K", [2, 3, 8])
def test_blend_twin_equals_upsample_background(K, rate):
    frames = _keys(K, seed=K)
    _, flows, errs = _full_res(frames)
    # flows as large as the serving clips' reach, some past the bound
    flows = flows * 8.0 + _flow(2 * (K - 1), 32, 48, 16, seed=rate)
    want = flow_ops.blend_stream(
        frames, flows, errs, rate, lambda x, f: _loop(x, f, 16))
    got = SK.shift_warp_blend_plain(frames, flows, errs, rate, 16)
    assert got.shape == ((K - 1) * rate + 1, 32, 48, 3)
    assert torch.equal(got, want)
    assert torch.equal(got[::rate], frames)
    if rate == 4:
        assert torch.equal(
            flow_ops.upsample_background(frames, rate, **LK),
            SK.shift_warp_blend_plain(frames, *_full_res(frames)[1:], rate,
                                      16))


class _Spy:
    """Counts the calls of the two kernels' entry points as ``ops/flow.py``
    sees them and passes them on (to the twins, on the CPU); with
    ``card``, CPU tensors count as the card's."""

    def __init__(self, monkeypatch, card: bool):
        self.calls = {"shift_warp": [], "shift_warp_blend": []}
        for name in self.calls:
            real = getattr(flow_ops, name)

            def spy(*args, _real=real, _name=name):
                self.calls[_name].append(args[-1])      # max_disp
                return _real(*args)
            monkeypatch.setattr(flow_ops, name, spy)
        if card:
            monkeypatch.setattr(flow_ops, "_on_card", lambda x: True)


@pytest.mark.parametrize("case", ["card-f32", "cpu", "card-bf16",
                                  "card-f64", "card-grad"])
def test_warp_routes_only_float32_card_tensors_without_gradient(
        case, monkeypatch):
    dtype = {"card-bf16": torch.bfloat16,
             "card-f64": torch.float64}.get(case, torch.float32)
    g = torch.Generator().manual_seed(3)
    img = torch.rand((2, 9, 13, 3), generator=g).to(dtype)
    flow = _flow(2, 9, 13, 4, seed=4).to(dtype)
    want = _loop(img, flow, 4)
    if case == "card-grad":
        img.requires_grad_(True)
    spy = _Spy(monkeypatch, card=case != "cpu")
    got = flow_ops.backward_warp_shift(img, flow, 4)
    assert spy.calls == {"shift_warp": [4] if case == "card-f32" else [],
                         "shift_warp_blend": []}
    assert torch.equal(got, want)
    if case == "card-grad":
        got.sum().backward()
        assert img.grad is not None


@pytest.mark.parametrize("case", ["card-f32", "cpu", "card-grad",
                                  "flow-scale-1"])
def test_upsample_background_routes_only_the_shift_warp_branch(
        case, monkeypatch):
    frames = _keys(3, seed=5)
    flow = dict(LK, flow_scale=1) if case == "flow-scale-1" else LK
    want = flow_ops.upsample_background(frames, 4, **flow)
    frames.requires_grad_(case == "card-grad")
    spy = _Spy(monkeypatch, card=case != "cpu")
    got = flow_ops.upsample_background(frames, 4, **flow)
    # routed: the quarter-resolution consistency warp (R = 16 / 4) and
    # the fused warps and blend, once each
    routed = case == "card-f32"
    assert spy.calls == {"shift_warp": [4] if routed else [],
                         "shift_warp_blend": [16] if routed else []}
    assert torch.equal(got, want)


def test_learned_time_warp_takes_the_kernel_for_each_warp(monkeypatch):
    g = torch.Generator().manual_seed(6)
    img0, img1 = (torch.rand((2, 16, 24, 3), generator=g) for _ in "ab")
    f01, f10 = (torch.randn((2, 16, 24, 4), generator=g)[..., :2] * 6
                for _ in "ab")                      # strided, as the UNet's
    want = flownet.time_warp(img0, img1, f01, f10, 0.5, max_disp=16)
    spy = _Spy(monkeypatch, card=True)
    got = flownet.time_warp(img0, img1, f01, f10, 0.5, max_disp=16)
    assert spy.calls == {"shift_warp": [16] * 4, "shift_warp_blend": []}
    assert torch.equal(got, want)


def test_export_calls_both_operators(monkeypatch):
    """Under ``torch.export`` a routed call goes through the registered
    operators (what a frozen program of the card's pipeline calls), and
    the program gives the loop's stream."""
    frames = _keys(3, seed=13)
    want = flow_ops.upsample_background(frames, 4, **LK)
    monkeypatch.setattr(flow_ops, "_on_card", lambda x: True)

    class Backgrounds(torch.nn.Module):
        def forward(self, keys):
            return flow_ops.upsample_background(keys, 4, **LK)
    ep = torch.export.export(Backgrounds(), (frames,))
    calls = sorted(str(n.target) for n in ep.graph.nodes
                   if str(n.target).startswith("renderloom"))
    assert calls == ["renderloom.shift_warp.default",
                     "renderloom.shift_warp_blend.default"]
    assert torch.equal(ep.module()(frames), want)


def test_opcheck_shift_warp():
    img = torch.rand(2, 5, 7, 3)
    torch.library.opcheck(torch.ops.renderloom.shift_warp.default,
                          (img, _flow(2, 5, 7, 2, seed=7), 2))


def test_opcheck_shift_warp_blend():
    K = 3
    g = torch.Generator().manual_seed(8)
    frames = torch.rand((K, 6, 8, 3), generator=g)
    flows = _flow(2 * (K - 1), 6, 8, 3, seed=9)
    errs = torch.rand((2 * (K - 1), 6, 8, 1), generator=g)
    torch.library.opcheck(torch.ops.renderloom.shift_warp_blend.default,
                          (frames, flows, errs, 3, 3))


def _misaligned(x):
    """A contiguous copy of ``x`` that starts 4 bytes off 8."""
    buf = torch.empty(x.numel() + 2)
    off = 1 if buf.data_ptr() % 8 == 0 else 0
    view = buf[off:off + x.numel()].view(x.shape).copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 8 == 4
    return view


@pytest.mark.parametrize("case,match", [
    ("cpu", "needs a CUDA tensor"), ("misaligned-flow", "8-byte aligned"),
    ("flow-shape", r"flow must be .* \(2, 5, 7, 2\)"), ("bf16", "float32"),
    ("max-disp-0", "at least 1")])
def test_shift_warp_cuda_checks(case, match):
    """The wrapper refuses what the kernel does not take with a
    ValueError before any launch, on the CPU as on the card; a CPU tensor
    that passes every other check meets only the device's."""
    img = torch.rand(2, 5, 7, 3)
    flow = _flow(2, 5, 7, 2, seed=10)
    R = 0 if case == "max-disp-0" else 2
    if case == "misaligned-flow":
        flow = _misaligned(flow)
    elif case == "flow-shape":
        flow = flow[:, :4].contiguous()
    elif case == "bf16":
        img = img.bfloat16()
    with pytest.raises(ValueError, match=match):
        SK.shift_warp_cuda(img, flow, R)


@pytest.mark.parametrize("case,match", [
    ("cpu", "needs a CUDA tensor"), ("misaligned-flows", "8-byte aligned"),
    ("flows-count", "float32"), ("one-keyframe", "K >= 2"),
    ("strided-frames", "contiguous")])
def test_shift_warp_blend_cuda_checks(case, match):
    K = 3
    g = torch.Generator().manual_seed(11)
    frames = torch.rand((K, 6, 8, 3), generator=g)
    flows = _flow(2 * (K - 1), 6, 8, 3, seed=12)
    errs = torch.rand((2 * (K - 1), 6, 8, 1), generator=g)
    if case == "misaligned-flows":
        flows = _misaligned(flows)
    elif case == "flows-count":
        flows = flows[:K - 1]
    elif case == "one-keyframe":
        frames = frames[:1]
    elif case == "strided-frames":
        frames = frames.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match=match):
        SK.shift_warp_blend_cuda(frames, flows, errs, 4, 16)
