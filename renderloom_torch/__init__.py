"""renderloom_torch — the PyTorch/CUDA port of renderloom for one NVIDIA H100.

The JAX package ``renderloom`` stays the reference; this package mirrors
its module names (``renderloom_torch/models/layers.py`` is the port of
``renderloom/models/layers.py``, and so on) and imports nothing from it.
Plain tensor code is PyTorch; the TPU kernels of the serving and
training paths are hand-written CUDA kernels under ``csrc/``, built with
``nvcc`` at first use (``ops/_build.py``):

* ``ops/rasterize_kernel.py`` — the pose label rasterizer, deterministic
  and train-mode tables (replaces ``renderloom/ops/rasterize_pallas.py``);
* ``ops/norm_kernel.py`` — the instance norm (shifted, parity, and the
  bf16 ``r3centered`` contract) and its backward, joined by an
  ``autograd.Function`` (replaces ``renderloom/ops/norm_pallas.py``, the
  custom VJP and the bf16 dispatch of ``renderloom/models/layers.py``).

Each kernel wrapper runs its plain PyTorch twin for a CPU tensor and the
kernel for a CUDA tensor.  The serving entry point is
:func:`renderloom_torch.eval.pipeline.build_pipeline` (and the CLIs
``renderloom_torch.cli.{pipeline,infer_motion,infer_renderer}``);
training is :func:`renderloom_torch.train.gan.make_gan_train_step` and
:func:`renderloom_torch.train.motion.make_train_step`, driven from their
data by ``python -m renderloom_torch.cli.train_renderer --h5 ...`` and
``python -m renderloom_torch.cli.train_motion --h5 ...``.
"""

__version__ = "0.1.0"
