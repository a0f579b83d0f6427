"""The fused nearest ×2 upsample and 3×3 float32 convolution
(``renderloom_torch/ops/upconv_kernel.py``) on the CPU: its plain twin
(the 4-tap per-parity form) against ``upsample2x`` + ``F.conv2d``, the
weight fold, and the routing in ``layers.Conv``: only a float32 3×3
stride-1 call that wants no gradient is fused, every other call keeps
the unfused path bit for bit, the mask net's gradient included.  The
CUDA kernel itself is held on the card by ``chip_smoke.py`` (phase UC).
"""

import pytest
import torch
import torch.nn.functional as F

import renderloom_torch.core.config as TC
from _torch_parity import single_thread  # noqa: F401
from renderloom_torch.models import layers
from renderloom_torch.models.layers import Conv, upsample2x
from renderloom_torch.models.renderer import MaskGenerator
from renderloom_torch.ops import upconv_kernel as UK

# (B, h, w, Cin, Cout): sides of 1 and odd sides, channel counts that are
# no multiple of a tile's BK or BN, one case on each of the three tiles
SHAPES = [(1, 1, 1, 5, 3), (2, 3, 5, 4, 7), (3, 1, 4, 33, 40),
          (2, 5, 3, 36, 65), (1, 4, 6, 8, 129)]


def _inputs(shape, dtype, bias, seed=0):
    B, h, w, cin, cout = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, h, w, cin), generator=g, dtype=dtype)
    wt = torch.randn((cout, cin, 3, 3), generator=g, dtype=dtype)
    b = torch.randn(cout, generator=g, dtype=dtype) if bias else None
    return x, wt / (9 * cin) ** 0.5, b


def _unfused(x, wt, b):
    return F.conv2d(upsample2x(x).permute(0, 3, 1, 2), wt, b, 1,
                    1).permute(0, 2, 3, 1)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("dtype,atol,rtol", [
    (torch.float64, 1e-12, 0.0), (torch.float32, 1e-5, 1e-5)],
    ids=["f64", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_twin_equals_upsample_then_conv(shape, dtype, atol, rtol, bias):
    x, wt, b = _inputs(shape, dtype, bias)
    got = UK.upconv_plain(x, UK.fold_weights(wt), b, shape[-1])
    want = _unfused(x, wt, b)
    assert got.shape == want.shape and got.dtype == dtype
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("cin,cout", [(5, 3), (33, 40), (36, 65)])
def test_fold_places_each_tap(cin, cout):
    """A weight with one nonzero tap (ky, kx) lands on the low-resolution
    tap that output parity (a, b) reaches it through: along an axis,
    parity 0 maps kernel taps (0, 1, 2) to (0, 1, 1) and parity 1 to
    (0, 0, 1); the padding up to the tile stays zero."""
    _, bn, bk = UK.TILES[UK.tile(cout)]
    to_r = ((0, 1, 1), (0, 0, 1))
    for ky in range(3):
        for kx in range(3):
            wt = torch.zeros(cout, cin, 3, 3)
            wt[:, :, ky, kx] = 1.0
            wf = UK.fold_weights(wt)
            assert wf.shape == (4, 4, -(-cin // bk) * bk, -(-cout // bn) * bn)
            want = torch.zeros_like(wf)
            for a in (0, 1):
                for b in (0, 1):
                    want[a * 2 + b, to_r[a][ky] * 2 + to_r[b][kx],
                         :cin, :cout] = 1.0
            assert torch.equal(wf, want), (ky, kx)


class _Spy:
    """Counts the calls of ``layers.upconv`` and passes them on."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = layers.upconv

        def spy(*args):
            self.calls += 1
            return real(*args)
        monkeypatch.setattr(layers, "upconv", spy)


@pytest.mark.parametrize("case", ["fused", "x-grad", "weight-grad", "bf16",
                                  "kernel-1", "stride-2"])
def test_conv_routes_only_float32_3x3_without_gradient(case, monkeypatch):
    k, stride = {"kernel-1": (1, 1), "stride-2": (3, 2)}.get(case, (3, 1))
    conv = Conv(6, 5, k, stride)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) / 8)
        conv.bias.copy_(torch.randn(5, generator=g))
    x = torch.randn((2, 3, 4, 6), generator=g)
    if case == "bf16":
        layers.cast_weights_(layers.set_compute_dtype(conv, torch.bfloat16))
    if case == "x-grad":
        x.requires_grad_(True)
    spy = _Spy(monkeypatch)
    with torch.set_grad_enabled(case in ("x-grad", "weight-grad")):
        got = conv(x, upsample=True)
        want = conv(upsample2x(x))          # the unfused path
    assert spy.calls == (case == "fused")
    if case == "fused":
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        assert torch.equal(got, UK.upconv_plain(
            x, UK.fold_weights(conv.weight), conv.bias, 5))
    else:
        assert torch.equal(got, want)
        assert got.requires_grad == (case in ("x-grad", "weight-grad"))


def test_fold_is_kept_until_the_weight_changes():
    conv = Conv(4, 3)
    with torch.no_grad():
        conv.weight.normal_()
    x = torch.randn(1, 2, 2, 4)
    with torch.no_grad():
        wf = conv._folded(conv.weight, x)
        assert conv._folded(conv.weight, x) is wf
        conv.weight.mul_(2.0)                   # in place: a new version
        wf2 = conv._folded(conv.weight, x)
        assert wf2 is not wf and torch.equal(wf2, 2.0 * wf)
        other = conv.weight.clone()             # another tensor
        assert conv._folded(other, x) is not wf2
        assert torch.equal(conv._folded(other, x), wf2)
    with torch.inference_mode():
        w_inf = conv.weight * 1.0               # keeps no version
        assert conv._folded(w_inf, x) is not conv._folded(w_inf, x)


def _mask_net(seed=2):
    torch.manual_seed(seed)
    m = TC.MaskNetConfig(num_filters=4, max_num_filters=16,
                         num_downsamples=3, num_res_blocks=1)
    net = MaskGenerator(TC.GeneratorConfig(mask=m), 22, 9)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape) * (0.3 if p.dim() > 1 else 0.1))
    label, imgs = torch.rand(2, 16, 24, 22), torch.rand(2, 16, 24, 9)
    return net, label, imgs


def _mask_net_unfused(net, label, imgs):
    """``MaskGenerator.forward`` as it ran before the fused path: each up
    block on ``upsample2x`` of its input."""
    h = torch.cat([net._encode(label, "lbl", False),
                   net._encode(imgs, "img", False)], dim=-1)
    for i in range(net.num_res_blocks):
        h = getattr(net, f"res{i}")(h)
    for i in reversed(range(net.num_downsamples)):
        h = getattr(net, f"up{i}")(upsample2x(h))
    return net.conv_mask(h)


def test_mask_net_gradient_is_unchanged(monkeypatch):
    net, label, imgs = _mask_net()
    spy = _Spy(monkeypatch)
    grads = []
    for forward in (net, lambda *a: _mask_net_unfused(net, *a)):
        net.zero_grad()
        (forward(label, imgs) * torch.linspace(0, 1, 24)[:, None]).sum() \
            .backward()
        grads.append({n: p.grad.clone() for n, p in net.named_parameters()})
    assert spy.calls == 0
    assert grads[0].keys() == grads[1].keys()
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name


def test_mask_net_inference_fuses_each_up_block(monkeypatch):
    net, label, imgs = _mask_net()
    spy = _Spy(monkeypatch)
    with torch.inference_mode():
        got = net(label, imgs)
        want = _mask_net_unfused(net, label, imgs)
    assert spy.calls == net.num_downsamples
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
def test_opcheck_upconv(bias):
    x, wt, b = _inputs((2, 3, 4, 6, 5), torch.float32, bias)
    torch.library.opcheck(torch.ops.renderloom.upconv.default,
                          (x, UK.fold_weights(wt), b, 5))


@pytest.mark.parametrize("offset,match", [(1, "16-byte aligned"),
                                          (0, "needs a CUDA tensor")],
                         ids=["misaligned-wf", "aligned-wf"])
def test_upconv_cuda_checks_wf_alignment(offset, match):
    """The kernel reads wf in 16-byte copies: a contiguous view of the
    fold that starts off 16 bytes is refused with a ValueError before
    any launch (on the CPU as on the card); an aligned one passes the
    checks and meets only the device's."""
    x, wt, b = _inputs((1, 2, 3, 4, 5), torch.float32, True)
    wf = UK.fold_weights(wt)
    buf = torch.empty(wf.numel() + 4)
    view = buf[offset:offset + wf.numel()].view(wf.shape).copy_(wf)
    assert view.is_contiguous()
    assert (view.data_ptr() % 16 == 0) == (offset == 0)
    with pytest.raises(ValueError, match=match):
        UK.upconv_cuda(x, view, b, 5)
