"""The reference's PyTorch checkpoints as the port's flax trees.

Port of the name-mapping half of the JAX package's
``renderloom/data/torch_import.py`` (:288-657).  The reference ships its
inference story as ``torch.save`` files: ``netG_epochNNN.pth`` and
``netD_epochNNN.pth`` (the renderer), ``model_epochNNN.pth`` with
``opt_epochNNN.pth`` (the motion transformer and its AMSGrad moments)
and torchvision's VGG19.  :func:`read_pth` reads them with
``torch.load(weights_only=True)``, which takes both torch formats: the
zip format and the legacy one of torch < 1.6, in which the reference's
published files were written.  The JAX package's own pickle reader is
not needed here.

The ``map_*`` functions turn the flat state dicts into the numpy flax
trees the JAX package builds from them, leaf for leaf (the port's
``convert.load_flax_params`` loads those into its modules):

* :func:`map_motion_params` / :func:`map_motion_opt_state` — the motion
  transformer (fused QKV split into q/k/v, (out, in) → (in, out)) and
  its Adam moments, which torch keys by position in ``parameters()``;
* :func:`vgg19_state_to_npz` — the ``.npz`` that
  ``models/perceptual.load_torchvision_npz`` reads, key for key the
  JAX package's (non-``features.`` biases included, prefixed);
* :func:`map_generator_params` / :func:`map_discriminator_params` —
  netG and netD: spectral convs resolved to their effective kernel
  (``weight_orig`` / σ from the stored ``u``, ``v``; σ stored as 1),
  the reference's dead ``label_embedding`` and top-level ``conv_mask``
  skipped.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List

import numpy as np
import torch

__all__ = [
    "read_pth", "flatten_state_dict", "strip_module_prefix",
    "map_motion_params", "map_motion_opt_state", "vgg19_state_to_npz",
    "map_generator_params", "map_discriminator_params",
]


def read_pth(path: str) -> Any:
    """The object a ``torch.save`` file holds, tensors on the CPU; only
    plain containers and tensors are unpickled."""
    return torch.load(path, map_location="cpu", weights_only=True)


def strip_module_prefix(state: Dict[str, Any]) -> Dict[str, Any]:
    """Drop nn.DataParallel ``module.`` prefixes
    (reference: Human_Motion_Modelling/utils/utils.py:64-68)."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state.items()}


def flatten_state_dict(obj: Any) -> Dict[str, np.ndarray]:
    """A loaded checkpoint as a flat name → numpy array dict: unwraps a
    ``state_dict`` envelope (utils/utils.py:77-79) and ``module.``
    prefixes; entries that are not tensors are dropped."""
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if not isinstance(obj, dict):
        raise ValueError(f"checkpoint is not a state dict: {type(obj)}")
    return strip_module_prefix({str(k): v.detach().cpu().numpy()
                                for k, v in obj.items()
                                if isinstance(v, torch.Tensor)})


# --------------------------------------------------------------------
# motion transformer: reference names -> flax tree
# --------------------------------------------------------------------

def _t(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.T)


def _dense(state, src: str) -> Dict[str, np.ndarray]:
    return {"kernel": _t(state[f"{src}.weight"]),
            "bias": state[f"{src}.bias"].copy()}


def _layernorm(state, src: str) -> Dict[str, np.ndarray]:
    return {"scale": state[f"{src}.weight"].copy(),
            "bias": state[f"{src}.bias"].copy()}


def _attention(state, src: str) -> Dict[str, Any]:
    """torch ``nn.MultiheadAttention``'s fused ``in_proj`` as separate
    q/k/v projections."""
    w = state[f"{src}.in_proj_weight"]           # (3*d, d)
    b = state[f"{src}.in_proj_bias"]             # (3*d,)
    d = w.shape[1]
    if w.shape[0] != 3 * d:
        raise ValueError(f"{src}: bad in_proj {w.shape}")
    blk = {name: {"kernel": _t(w[i * d:(i + 1) * d]),
                  "bias": b[i * d:(i + 1) * d].copy()}
           for i, name in enumerate(("q_proj", "k_proj", "v_proj"))}
    blk["out_proj"] = _dense(state, f"{src}.out_proj")
    return blk


def _layer_count(state, prefix: str) -> int:
    return 1 + max(int(k.split(".")[2]) for k in state
                   if k.startswith(prefix))


def map_motion_params(state: Dict[str, np.ndarray]) -> Dict:
    """``model_epochNNN.pth`` state dict → the motion transformer's
    params.

    Reference schema (Human_Motion_Modelling/models/transformer.py, saved
    at models/trainer.py:208-211): ``input_embed``/``joints_embed``
    Linear, ``encoder.layers.N`` with fused-QKV ``self_attn``,
    ``decoder.layers.N`` with ``self_attn`` and ``multihead_attn``
    (cross), pre-norm LayerNorms, final ``encoder.norm`` /
    ``decoder.norm``.  The flax tree keeps q/k/v separate, (in, out)
    kernels, and calls the cross attention ``cross_attn``."""
    state = strip_module_prefix(state)
    out: Dict[str, Any] = {
        "input_embed": _dense(state, "input_embed"),
        "joints_embed": _dense(state, "joints_embed"),
        "encoder_norm": _layernorm(state, "encoder.norm"),
        "decoder_norm": _layernorm(state, "decoder.norm"),
    }
    ffn = lambda src: {"linear1": _dense(state, f"{src}.linear1"),
                       "linear2": _dense(state, f"{src}.linear2")}
    for i in range(_layer_count(state, "encoder.layers.")):
        src = f"encoder.layers.{i}"
        out[f"enc_{i}"] = {
            "self_attn": _attention(state, f"{src}.self_attn"),
            "ffn": ffn(src),
            "norm1": _layernorm(state, f"{src}.norm1"),
            "norm2": _layernorm(state, f"{src}.norm2")}
    for i in range(_layer_count(state, "decoder.layers.")):
        src = f"decoder.layers.{i}"
        blk = {"self_attn": _attention(state, f"{src}.self_attn"),
               "cross_attn": _attention(state, f"{src}.multihead_attn"),
               "ffn": ffn(src)}
        for n in ("norm1", "norm2", "norm3"):
            blk[n] = _layernorm(state, f"{src}.{n}")
        out[f"dec_{i}"] = blk
    return out


def map_motion_opt_state(opt_obj: Any, model_keys: List[str]):
    """``opt_epochNNN.pth`` Adam moments → flax moment trees.

    The reference saves the motion optimizer as ``{'transformer':
    optimizer.state_dict()}`` (models/trainer.py:100-118,208-225).
    torch keys each parameter's state by its position in
    ``parameters()``, the order of the model state dict's keys (one
    param group, no buffers), so ``model_keys`` (the ordered keys of the
    matching ``model_epochNNN.pth``) names each slot; a slot key may be
    an int or its string.  Each moment then maps through
    :func:`map_motion_params`.

    Returns ``(count, mu, nu, nu_max)``: torch's ``step`` (a tensor in
    recent torch, an int in older), ``exp_avg``, ``exp_avg_sq`` and
    ``max_exp_avg_sq``."""
    if isinstance(opt_obj, dict) and "transformer" in opt_obj:
        opt_obj = opt_obj["transformer"]
    if not (isinstance(opt_obj, dict) and "state" in opt_obj):
        raise ValueError("not a torch optimizer state dict "
                         "(missing 'state')")
    state = opt_obj["state"]
    order = []
    for g in opt_obj.get("param_groups", []):
        order += list(g.get("params", []))
    if not order:
        order = sorted(state)
    keys = list(model_keys)
    if len(order) != len(keys):
        raise ValueError(
            f"optimizer has {len(order)} param slots but the model "
            f"checkpoint has {len(keys)} parameters — not a matching "
            "opt/model pair")

    def slot(pid):
        return state[pid] if pid in state else state[str(pid)]

    def tree_of(kind: str):
        return map_motion_params({keys[i]: np.asarray(slot(pid)[kind])
                                  for i, pid in enumerate(order)})

    counts = [int(np.asarray(s["step"]).item()) for s in state.values()]
    return (max(counts) if counts else 0, tree_of("exp_avg"),
            tree_of("exp_avg_sq"), tree_of("max_exp_avg_sq"))


# --------------------------------------------------------------------
# torchvision VGG19 -> perceptual-loss npz
# --------------------------------------------------------------------

def vgg19_state_to_npz(state: Dict[str, np.ndarray], npz_path: str) -> int:
    """Save a torchvision ``vgg19`` (or bare ``.features``) state dict as
    the ``vgg19_features.npz`` that ``perceptual.load_torchvision_npz``
    reads: every 4-D ``.weight`` and 1-D ``.bias`` under a
    ``features.`` prefix (added where missing, so the classifier's
    biases are kept as ``features.classifier.N.bias``, as the JAX
    package writes them), OIHW kernels as they are.  Returns the number
    of conv layers written."""
    arrays = {}
    n = 0
    for k, v in state.items():
        if not k.startswith("features."):
            k = f"features.{k}"
        if k.endswith(".weight") and v.ndim == 4:
            arrays[k] = v
            n += 1
        elif k.endswith(".bias") and v.ndim == 1:
            arrays[k] = v
    if n == 0:
        raise ValueError("no conv kernels found in VGG state dict")
    os.makedirs(os.path.dirname(npz_path) or ".", exist_ok=True)
    np.savez(npz_path, **arrays)
    return n


# --------------------------------------------------------------------
# renderer netG / netD: reference names -> flax trees
# --------------------------------------------------------------------

def _set(tree: Dict, path, leaf):
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = leaf


def _conv_w(w: np.ndarray) -> np.ndarray:
    """torch OIHW → flax HWIO."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _spectral_effective(state: Dict[str, np.ndarray], src: str):
    """A torch spectral-norm conv's effective weight: torch stores
    ``weight_orig`` and the power-iteration ``weight_u``/``weight_v`` and
    divides by ``σ = uᵀ W v`` at every forward, eval included.  The
    division is baked in (in float64, then float32, as the JAX package
    does); flax's SpectralNorm then re-estimates σ ≈ 1 from the imported
    ``u``."""
    w = state[f"{src}.weight_orig"].astype(np.float64)
    u = state[f"{src}.weight_u"].astype(np.float64)
    v = state[f"{src}.weight_v"].astype(np.float64)
    sigma = float(u @ (w.reshape(w.shape[0], -1) @ v))
    w_eff = (w / sigma).astype(np.float32)
    return _conv_w(w_eff), state[f"{src}.bias"].copy(), \
        u.astype(np.float32)


def _put_sn_conv(params: Dict, stats: Dict, dst_path, state, src):
    """Spectral conv → ``<dst>/conv/{kernel,bias}`` params and
    ``<dst>/sn/{conv/kernel/u, conv/kernel/sigma}`` batch stats (flax's
    SpectralNorm layout)."""
    kernel, bias, u = _spectral_effective(state, src)
    _set(params, list(dst_path) + ["conv", "kernel"], kernel)
    _set(params, list(dst_path) + ["conv", "bias"], bias)
    _set(stats, list(dst_path) + ["sn", "conv/kernel/u"],
         u.reshape(1, -1))
    _set(stats, list(dst_path) + ["sn", "conv/kernel/sigma"],
         np.asarray(1.0, np.float32))


def _put_plain_conv(params: Dict, dst_path, state, src):
    _set(params, list(dst_path) + ["kernel"], _conv_w(state[f"{src}.weight"]))
    _set(params, list(dst_path) + ["bias"], state[f"{src}.bias"].copy())


def _put_instance_norm(params: Dict, dst_path, state, src):
    _set(params, list(dst_path) + ["scale"], state[f"{src}.weight"].copy())
    _set(params, list(dst_path) + ["bias"], state[f"{src}.bias"].copy())


def _indices(state: Dict, prefix: str, pattern: str) -> List[int]:
    """Sorted distinct N where ``prefix + pattern.format(N) + "."``
    starts a key; ``pattern`` holds one ``{}``."""
    rx = re.compile(re.escape(prefix) + pattern.replace("{}", r"(\d+)")
                    + r"\.")
    return sorted({int(m.group(1)) for k in state
                   if (m := rx.match(k)) is not None})


_BLOCKS = (("conv_block_0", "0"), ("conv_block_1", "1"),
           ("conv_block_s", "_s"))


def map_generator_params(state: Dict[str, np.ndarray]):
    """``netG_epochNNN.pth`` → (params_g, stats_g) of the generator.

    Reference schema (``Pose_Guided_Neural_Rendering/models/
    generator.py``): the ``ref_embedding`` LabelEmbedder, the plain
    ``down_first`` conv, ``down_N``/``res_N``/``up_N`` SPADE res blocks
    (``conv_block_{0,1,s}``, each with a SPADE ``norm.mlps.0`` affine
    conv), the ``conv_img`` head, and the MaskGenerator
    ``flow_network_temp`` (encoders ``down_lbl``/``down_img``, CNACN
    blocks ``res_flow``, ``up_flow`` as [Upsample, conv] pairs, the
    1-channel ``conv_mask``).  ``label_embedding`` and the top-level
    ``conv_mask`` are dead in the reference's forward
    (generator.py:196-229) and are skipped."""
    state = strip_module_prefix(state)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    # LabelEmbedder (generator.py:306-410)
    _put_sn_conv(params, stats, ["ref_embed", "conv_first"], state,
                 "ref_embedding.conv_first.layers.conv")
    for i in _indices(state, "ref_embedding.", "down_{}"):
        _put_sn_conv(params, stats, ["ref_embed", f"down_{i}"], state,
                     f"ref_embedding.down_{i}.layers.conv")

    _put_plain_conv(params, ["down_first"], state, "down_first.layers.conv")

    for group in ("down", "res", "up"):
        for i in _indices(state, "", group + "_{}"):
            src = f"{group}_{i}"
            for tag, mine in _BLOCKS:
                if f"{src}.{tag}.layers.conv.weight_orig" not in state:
                    continue
                _put_sn_conv(params, stats, [src, f"conv{mine}"], state,
                             f"{src}.{tag}.layers.conv")
                _put_plain_conv(
                    params, [src, f"spade{mine}", "affine"], state,
                    f"{src}.{tag}.layers.norm.mlps.0.0.layers.conv")

    _put_plain_conv(params, ["conv_img", "conv"], state,
                    "conv_img.layers.conv")

    # MaskGenerator == flow_network_temp (generator.py:415-510)
    mg = "flow_network_temp"
    for ref_name, mine in (("down_lbl", "lbl"), ("down_img", "img")):
        for i in _indices(state, f"{mg}.", ref_name + ".{}"):
            dst = ["mask_net", f"{mine}_in" if i == 0
                   else f"{mine}_down{i - 1}"]
            _put_sn_conv(params, stats, dst + ["conv"], state,
                         f"{mg}.{ref_name}.{i}.layers.conv")
            _put_instance_norm(params, dst + ["norm"], state,
                               f"{mg}.{ref_name}.{i}.layers.norm")
    for i in _indices(state, f"{mg}.", "res_flow.{}"):
        src = f"{mg}.res_flow.{i}"
        for tag, mine in _BLOCKS:
            if f"{src}.{tag}.layers.conv.weight_orig" not in state:
                continue
            dst = ["mask_net", f"res{i}"]
            _put_sn_conv(params, stats, dst + [f"conv{mine}"], state,
                         f"{src}.{tag}.layers.conv")
            _put_instance_norm(params, dst + [f"norm{mine}"], state,
                               f"{src}.{tag}.layers.norm")
    up_idx = _indices(state, f"{mg}.", "up_flow.{}")
    n_up = len(up_idx)
    for k, seq_i in enumerate(up_idx):
        # [Upsample, conv]×n: the k-th conv is decoder level n−1−k
        dst = ["mask_net", f"up{n_up - 1 - k}"]
        _put_sn_conv(params, stats, dst + ["conv"], state,
                     f"{mg}.up_flow.{seq_i}.layers.conv")
        _put_instance_norm(params, dst + ["norm"], state,
                           f"{mg}.up_flow.{seq_i}.layers.norm")
    _put_plain_conv(params, ["mask_net", "conv_mask", "conv", "conv"],
                    state, f"{mg}.conv_mask.0.layers.conv")
    return params, stats


def map_discriminator_params(state: Dict[str, np.ndarray]):
    """``netD_epochNNN.pth`` → (params_d, stats_d) of the discriminator
    set.

    Reference (``models/discriminator.py``): ``net_D`` (two scales),
    ``net_D_face`` and ``net_D_hand``; each scale is ``layer0..K``
    spectral convs with affine instance norms and a last 1-channel
    spectral conv (the highest layer index), here called ``head``."""
    state = strip_module_prefix(state)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for ref_net, my_net in (("net_D", "net_d"), ("net_D_face", "net_d_face"),
                            ("net_D_hand", "net_d_hand")):
        for s in _indices(state, f"{ref_net}.", "discriminator_{}"):
            src_scale = f"{ref_net}.discriminator_{s}"
            layers = _indices(state, f"{src_scale}.", "layer{}")
            if not layers:
                continue
            head = max(layers)
            for li in layers:
                src = f"{src_scale}.layer{li}.0.layers"
                dst = ([my_net, f"scale{s}", "head"] if li == head else
                       [my_net, f"scale{s}", f"layer{li}", "conv"])
                _put_sn_conv(params, stats, dst, state, f"{src}.conv")
                if f"{src}.norm.weight" in state and li != head:
                    _put_instance_norm(
                        params, [my_net, f"scale{s}", f"layer{li}", "norm"],
                        state, f"{src}.norm")
    return params, stats
