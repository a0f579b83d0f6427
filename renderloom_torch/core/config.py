"""Typed configuration: the motion, renderer, flow and pose dataclasses
and their yaml loaders.

A copy of the renderer, motion, flow and pose parts of the JAX
package's ``renderloom/core/config.py``, kept here so the port never
imports the JAX package: the model architectures, the renderer's data
settings, discriminators, optimizer, loss weights and
``compute_dtype``, the motion stage's ``dataset`` section
(:class:`MotionDatasetConfig`: the AMASS synthesis, projection,
statistics-file and openpose settings), its optimizer
(:class:`MotionOptimConfig`), loss weights and training schedule, and
the learned flow interpolator (:class:`FlowConfig`), pose head
(:class:`PoseNetConfig`) and Super SloMo background interpolator
(:class:`SloMoConfig`, which the JAX package lacks).  Defaults equal the
reference's shipped configs
(``Human_Motion_Modelling/configs/config.yaml``,
``Pose_Guided_Neural_Rendering/configs/HSM.yaml``); yaml files in
either the nested layout or the reference's flat key layout load
through :func:`load_motion_config` / :func:`load_renderer_config`
(:func:`load_flow_config`, :func:`load_pose_config`: flat keys).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence, Tuple

import torch
import yaml

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(compute_dtype: str) -> torch.dtype:
    """The torch dtype of a config's ``compute_dtype``."""
    if compute_dtype not in _DTYPES:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
    return _DTYPES[compute_dtype]


def _update_dataclass(obj, data: Mapping[str, Any]):
    """Return a copy of dataclass ``obj`` updated with keys from ``data``.

    Unknown keys are ignored; nested dataclass fields are updated
    recursively from nested mappings, and sequences given for tuple
    fields are stored as tuples.
    """
    updates = {}
    names = {f.name: f for f in dataclasses.fields(obj)}
    for key, value in data.items():
        if key not in names:
            continue
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, Mapping):
            updates[key] = _update_dataclass(current, value)
        elif isinstance(current, tuple) and isinstance(value, Sequence):
            updates[key] = tuple(value)
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
class MotionDatasetConfig:
    """AMASS synthesis parameters (``configs/config.yaml:36-68``)."""

    h5_file: str = "AMASS/AMASS_3D_joints.h5"
    data_root: str = "data"
    train_split: tuple = (
        "CMU", "MPI_Limits", "TotalCapture", "Eyes_Japan_Dataset", "KIT",
        "DFaust_67", "BMLhandball", "BMLmovi", "EKUT", "TCD_handMocap",
        "BioMotionLab_NTroje", "ACCAD",
    )
    test_split: tuple = (
        "Transitions_mocap", "SSM_synced", "HumanEva", "MPI_HDM05", "SFU",
        "MPI_mosh",
    )
    return_type: str = "network"    # 'network' (2D) | '3D'

    # noise augmentation (configs/config.yaml:46-51)
    train_noise: bool = True
    noise_weight: float = 0.5
    noise_rate: int = 15
    joint_drop_rate: int = 15
    flip_rate: int = 8

    # camera / projection (configs/config.yaml:54-61)
    rotation_aug: bool = True
    rotation_axes: tuple = (0.2, 0.0, 1.0)
    camera_project: str = "perspective"
    focal: float = 4.0
    depth: float = 4.0
    projection_noise: bool = True
    frame_boarder: float = 10.0

    # clip sampling (configs/config.yaml:64-68)
    max_seq_length: int = 321       # = train_sample_rate * N + 1
    train_sample_rate: int = 8
    train_sample_size: int = 50
    test_sample_rate: int = 16

    evaluate_noise: bool = True
    openpose_scale: float = 512.0
    openpose_offset: float = 256.0


@dataclass(frozen=True)
class MotionOptimConfig:
    """Motion optimizer settings (``configs/config.yaml:12-20``).
    ``weight_decay`` is read but, as in the JAX package, not applied."""

    nr_epochs: int = 1000
    lr: float = 1e-4
    beta1: float = 0.5
    beta2: float = 0.999
    weight_decay: float = 5e-4
    lr_policy: str = "step"         # constant|lambda|step|multistep
    gamma: float = 0.5
    step_size: int = 100
    warmup: int = 5
    grad_clip: float = 1.0


@dataclass(frozen=True)
class MotionConfig:
    """Full motion-stage configuration."""

    transformer: TransformerConfig = field(default_factory=TransformerConfig)
    pos_encode: PosEncodeConfig = field(default_factory=PosEncodeConfig)
    dataset: MotionDatasetConfig = field(default_factory=MotionDatasetConfig)
    optim: MotionOptimConfig = field(default_factory=MotionOptimConfig)

    # loss weights (configs/config.yaml:111-112)
    w_codition: float = 2.0
    w_2d: float = 5.0

    use_dis: bool = False
    w_gan: float = 0.0

    eval_step: int = 5
    save_step: int = 50

    batch_size: int = 16
    seed: int = 0
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
class PatchDiscConfig:
    """One multi-scale patch discriminator (``configs/HSM.yaml:78-105``)."""

    num_filters: int = 32
    max_num_filters: int = 512
    num_discriminators: int = 2
    num_layers: int = 4
    kernel_size: int = 4
    weight_norm_type: str = "spectral"
    activation_norm_type: str = "instance"


@dataclass(frozen=True)
class DiscriminatorConfig:
    """Full discriminator stack (``configs/HSM.yaml:72-105``)."""

    input_image_nc: int = 3
    input_label_nc: int = 22
    num_frames_D: int = 2
    image: PatchDiscConfig = field(default_factory=PatchDiscConfig)
    face: PatchDiscConfig = field(default_factory=lambda: PatchDiscConfig(
        num_discriminators=1, num_layers=3))
    hand: PatchDiscConfig = field(default_factory=lambda: PatchDiscConfig(
        num_discriminators=1, num_layers=3))
    use_face: bool = True
    use_hand: bool = True


@dataclass(frozen=True)
class GanLossWeights:
    """Per-output GAN loss weights (``configs/HSM.yaml:114-118``)."""

    fuse: float = 0.0
    raw: float = 1.0
    face: float = 0.1
    hand: float = 0.1


@dataclass(frozen=True)
class PerceptualConfig:
    """VGG19 perceptual loss (``configs/HSM.yaml:124-140``)."""

    weight: float = 10.0
    model: str = "vgg19"
    layers: tuple = ("relu_1_1", "relu_2_1", "relu_3_1", "relu_4_1",
                     "relu_5_1")
    weights: tuple = (0.03125, 0.0625, 0.125, 0.25, 1.0)
    criterion: str = "l1"
    num_scales: int = 1


@dataclass(frozen=True)
class RendererDataConfig:
    """HumanSloMo data settings (``configs/HSM.yaml:151-193``)."""

    h5_file: str = "HumanSlomo.h5"
    train_video_list: tuple = ()
    test_video_list: tuple = ("test_001", "test_006", "test_011", "test_016",
                              "test_021", "test_026")
    max_frames: int = 4
    update_frame_step: int = 10
    random_drop_prob: float = 0.02
    random_blur_rate: float = 0.06
    gauss_sigma: float = 5.0
    skeleton_thres: float = 0.001
    foot_thres: float = 0.001
    load_width: int = 480
    load_height: int = 320
    model_width: int = 480
    model_height: int = 320
    eval_frames: int = 40
    num_joints: int = 19


@dataclass(frozen=True)
class RendererOptimConfig:
    """TTUR Adam settings (``configs/HSM.yaml:9-17``)."""

    nr_epochs: int = 200
    lr: float = 1e-4
    lr_d: float = 4e-4
    beta1: float = 0.0
    beta2: float = 0.999
    weight_decay: float = 5e-4
    lr_policy: str = "step"
    gamma: float = 0.5
    step_size: int = 20


@dataclass(frozen=True)
class RendererConfig:
    """Full renderer-stage configuration.  ``ssim_w`` and ``grad_w``
    weight optional fg-masked SSIM and image-gradient terms of the G
    loss; 0 is the reference's objective."""

    gen: GeneratorConfig = field(default_factory=GeneratorConfig)
    dis: DiscriminatorConfig = field(default_factory=DiscriminatorConfig)
    data: RendererDataConfig = field(default_factory=RendererDataConfig)
    optim: RendererOptimConfig = field(default_factory=RendererOptimConfig)

    gan_mode: str = "hinge"
    gan: GanLossWeights = field(default_factory=GanLossWeights)
    fm_w: float = 1.0
    perceptual: PerceptualConfig = field(default_factory=PerceptualConfig)
    l1_w: float = 30.0
    mask_w: float = 5.0
    ssim_w: float = 0.0
    grad_w: float = 0.0

    batch_size: int = 4
    seed: int = 0
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class FlowConfig:
    """Learned flow-interpolator settings (the trainable DAIN
    replacement, :mod:`renderloom_torch.models.flownet`)."""

    base_filters: int = 24
    levels: int = 4
    lr: float = 2e-4
    grad_clip: float = 1.0
    w_photo: float = 0.5
    w_smooth: float = 0.05
    nr_epochs: int = 50
    batch_size: int = 8
    compute_dtype: str = "float32"
    # Per-axis displacement bound (full-resolution px) of the separable
    # inference warp (ops/flow.py:backward_warp_shift; cost linear in
    # it).  Training always uses the unbounded gather warp, so this only
    # bounds inference.
    max_disp: int = 16


@dataclass(frozen=True)
class SloMoConfig:
    """Super SloMo, the serving pipeline's learned background backend
    (:mod:`renderloom_torch.models.superslomo`), at its published widths
    (arXiv:1712.00080 §3, Fig. 3): per level of both U-Nets the
    channels and the kernel size, the leaky ReLU's slope, and the
    per-channel mean taken off the keyframes going in (the public
    implementation's)."""

    widths: Tuple[int, ...] = (32, 64, 128, 256, 512, 512)
    kernels: Tuple[int, ...] = (7, 5, 3, 3, 3, 3)
    leaky_slope: float = 0.1
    mean: Tuple[float, ...] = (0.429, 0.431, 0.397)
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class PoseNetConfig:
    """The 2-D pose head (:mod:`renderloom_torch.models.posenet`)."""

    base_filters: int = 32
    blocks: int = 4
    sigma: float = 6.0          # target gaussian σ in image pixels
    conf_thres: float = 0.05
    fg_weight: float = 20.0     # extra MSE weight on gaussian peaks
    w_coord: float = 1.0
    lr: float = 1e-3
    grad_clip: float = 1.0
    nr_epochs: int = 50
    batch_size: int = 16
    compute_dtype: str = "float32"
    # random-erase occlusion augmentation: each image gets
    # ``occlude_count`` rectangles, each applied with probability
    # ``occlude_rate``, up to ``occlude_frac`` of the image side, filled
    # with a random flat colour
    occlude_rate: float = 0.0
    occlude_count: int = 2
    occlude_frac: float = 0.3


# ---------------------------------------------------------------------------
# YAML loading — accepts both the nested layout and the reference's flat
# key layout.
# ---------------------------------------------------------------------------


def load_yaml(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def motion_config_from_dict(raw: Mapping[str, Any]) -> MotionConfig:
    cfg = _update_dataclass(MotionConfig(), raw)
    # the reference's flat layout keeps the dataset and optimizer keys at
    # the top level; nested ``dataset:`` and ``optim:`` sections win over
    # them
    sections = {}
    for name, default in (("dataset", MotionDatasetConfig()),
                          ("optim", MotionOptimConfig())):
        section = _update_dataclass(default, raw)
        if isinstance(raw.get(name), Mapping):
            section = _update_dataclass(section, raw[name])
        sections[name] = section
    return dataclasses.replace(cfg, **sections)


def renderer_config_from_dict(raw: Mapping[str, Any]) -> RendererConfig:
    cfg = _update_dataclass(RendererConfig(), raw)
    # the reference's flat layout keeps the data and optimizer keys at
    # the top level
    cfg = dataclasses.replace(cfg, data=_update_dataclass(cfg.data, raw),
                              optim=_update_dataclass(cfg.optim, raw))
    gan_raw = raw.get("gan")
    if isinstance(gan_raw, Mapping):
        cfg = dataclasses.replace(
            cfg, gan=_update_dataclass(GanLossWeights(), gan_raw))
    dis_raw = raw.get("dis") or {}
    if dis_raw:
        add = dis_raw.get("additional_discriminators") or {}
        dis = cfg.dis
        for name in ("face", "hand"):
            if name in add:
                dis = dataclasses.replace(dis, **{name: _update_dataclass(
                    getattr(dis, name), add[name])})
        cfg = dataclasses.replace(cfg, dis=dis)
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


def load_flow_config(path: str) -> FlowConfig:
    return _update_dataclass(FlowConfig(), load_yaml(path))


def load_pose_config(path: str) -> PoseNetConfig:
    return _update_dataclass(PoseNetConfig(), load_yaml(path))


def slomo_config_from_dict(raw: Mapping[str, Any]) -> SloMoConfig:
    """A :class:`SloMoConfig` from a mapping (a configuration file's
    ``slomo`` section); six widths and six kernels, or a ValueError."""
    cfg = _update_dataclass(SloMoConfig(), raw)
    if len(cfg.widths) != 6 or len(cfg.kernels) != 6 or len(cfg.mean) != 3:
        raise ValueError("slomo: six widths, six kernels and a mean of "
                         f"three channels, not {cfg}")
    return cfg
