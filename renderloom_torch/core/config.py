"""Typed configuration: the motion and renderer dataclasses and their
yaml loaders.

A copy of the serving part of the JAX package's
``renderloom/core/config.py``, kept here so the port never imports the
JAX package: the model architectures, the renderer's data sizes and
thresholds, and ``compute_dtype``.  The training sections (datasets,
optimizers, discriminators, losses) are not copied yet; the loaders
skip their keys.  Defaults equal the reference's shipped configs
(``Human_Motion_Modelling/configs/config.yaml``,
``Pose_Guided_Neural_Rendering/configs/HSM.yaml``); yaml files in
either the nested layout or the reference's flat key layout load
through :func:`load_motion_config` / :func:`load_renderer_config`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping

import yaml


def _update_dataclass(obj, data: Mapping[str, Any]):
    """Return a copy of dataclass ``obj`` updated with keys from ``data``.

    Unknown keys are ignored; nested dataclass fields are updated
    recursively from nested mappings.
    """
    updates = {}
    names = {f.name: f for f in dataclasses.fields(obj)}
    for key, value in data.items():
        if key not in names:
            continue
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, Mapping):
            updates[key] = _update_dataclass(current, value)
        else:
            updates[key] = value
    return dataclasses.replace(obj, **updates)


# ---------------------------------------------------------------------------
# Motion stage (Human_Motion_Modelling)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TransformerConfig:
    """DETR-style motion transformer (``configs/config.yaml:78-89``)."""

    input_joints: int = 38          # 19 joints x 2D
    hidden_dim: int = 128
    dropout: float = 0.1
    nheads: int = 8
    dim_feedforward: int = 256
    enc_layers: int = 6
    dec_layers: int = 6
    activation: str = "leaky_relu"
    pre_norm: bool = True
    intermediate: bool = False
    two_stage: bool = True


@dataclass(frozen=True)
class PosEncodeConfig:
    """Positional encoding config (``configs/config.yaml:92-94``)."""

    hidden_dim: int = 128
    position_embedding: str = "v2"  # 'v2' sine | 'v3' learned
    max_learned_positions: int = 160


@dataclass(frozen=True)
class MotionConfig:
    """Full motion-stage configuration."""

    transformer: TransformerConfig = field(default_factory=TransformerConfig)
    pos_encode: PosEncodeConfig = field(default_factory=PosEncodeConfig)
    compute_dtype: str = "float32"


# ---------------------------------------------------------------------------
# Renderer stage (Pose_Guided_Neural_Rendering)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EmbedConfig:
    """Conditional label embedder (``configs/HSM.yaml:60-67``)."""

    use_embed: bool = True
    arch: str = "encoder"
    num_filters: int = 64
    max_num_filters: int = 512
    num_downsamples: int = 4
    kernel_size: int = 3
    weight_norm_type: str = "spectral"


@dataclass(frozen=True)
class MaskNetConfig:
    """Blend-mask network (``configs/HSM.yaml:51-59``)."""

    num_filters: int = 32
    max_num_filters: int = 512
    num_downsamples: int = 3
    num_res_blocks: int = 4
    kernel_size: int = 3
    activation_norm_type: str = "instance"
    weight_norm_type: str = "spectral"


@dataclass(frozen=True)
class GeneratorConfig:
    """SPADE generator (``configs/HSM.yaml:35-67``)."""

    num_frames_G: int = 2
    input_image_nc: int = 3
    input_label_nc: int = 22        # 3ch skeleton + 19ch heatmaps
    num_filters: int = 16
    max_num_filters: int = 512
    num_layers: int = 6
    num_downsamples: int = 4
    kernel_size: int = 3
    activation_norm_type: str = "spatially_adaptive"
    spade_kernel_size: int = 1
    weight_norm_type: str = "spectral"
    do_checkpoint: bool = True
    mask: MaskNetConfig = field(default_factory=MaskNetConfig)
    embed: EmbedConfig = field(default_factory=EmbedConfig)


@dataclass(frozen=True)
class RendererDataConfig:
    """HumanSloMo data settings that serving reads
    (``configs/HSM.yaml:151-193``)."""

    gauss_sigma: float = 5.0
    skeleton_thres: float = 0.001
    foot_thres: float = 0.001
    load_width: int = 480
    load_height: int = 320
    model_width: int = 480
    model_height: int = 320


@dataclass(frozen=True)
class RendererConfig:
    """Full renderer-stage configuration."""

    gen: GeneratorConfig = field(default_factory=GeneratorConfig)
    data: RendererDataConfig = field(default_factory=RendererDataConfig)
    compute_dtype: str = "float32"


# ---------------------------------------------------------------------------
# YAML loading — accepts both the nested layout and the reference's flat
# key layout.
# ---------------------------------------------------------------------------


def load_yaml(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def motion_config_from_dict(raw: Mapping[str, Any]) -> MotionConfig:
    return _update_dataclass(MotionConfig(), raw)


def renderer_config_from_dict(raw: Mapping[str, Any]) -> RendererConfig:
    cfg = _update_dataclass(RendererConfig(), raw)
    # the reference's flat layout keeps the data keys at the top level
    cfg = dataclasses.replace(cfg, data=_update_dataclass(cfg.data, raw))
    norm_params = (raw.get("gen") or {}).get("activation_norm_params") or {}
    kernel = norm_params.get("kernel_size")
    if kernel is not None:
        cfg = dataclasses.replace(cfg, gen=dataclasses.replace(
            cfg.gen, spade_kernel_size=kernel))
    return cfg


def load_motion_config(path: str) -> MotionConfig:
    return motion_config_from_dict(load_yaml(path))


def load_renderer_config(path: str) -> RendererConfig:
    return renderer_config_from_dict(load_yaml(path))
