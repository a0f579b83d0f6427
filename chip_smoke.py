#!/usr/bin/env python3
"""Drive the PyTorch port (``renderloom_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs a
CUDA device and the CUDA toolkit (``nvcc``); it builds the kernels from
``renderloom_torch/csrc`` into ``build/renderloom_torch/`` and then:

1. prints the card, its power limit, and the torch/CUDA versions,
   builds every kernel (build time, registers and spills printed), and
   counts K1's operations per term in its machine code
   (``k1_ops_from_sass``); then probes the file layer's host packages
   (PIL, h5py, imageio), ``g++`` and the port's native image decoder
   (``phase_probe``), which decide what phases V and Q run;
2. holds the instance-norm kernel (K2) against its plain twin at the
   generator's full-width shapes, and times kernel, twin and
   ``F.instance_norm``; checks that two calls at the largest shape give
   the same bits, holds a streaming shape (one slab larger than the
   grid's shared memory) against the twin, and prints the wrapper's host
   time per call at a tiny shape;
3. holds the rasterizer kernel (K1) against its plain twin bit for bit
   at 29 frames of 320×480, f32 and bf16 labels, masks on and off; checks
   one launch per call; times kernel and twin; prints the share of (tile,
   term) pairs that the cull rule keeps and the bound on these tables
   (``raster_bound``); the same on a compact person (``_person_poses``);
4. runs the serving pipeline at full width (configs/hsm.yaml +
   configs/motion.yaml, 480×320, rate 4, 8 keyframes, one clip, seeded
   random weights): checks its output and that both kernels were
   launched, holds K2 against its twin at every shape the run gave it,
   and times the pipeline (frames/s, per-stage times, a profile);
5. holds the card's pipeline against the port's CPU pipeline at 64×96,
   rate 2, 3 keyframes, tiny widths, with identical weights, for the
   standard and the parity-layout configuration;

then the parity-layout serving configuration (``build_pipeline(...,
fastpath=True)``: the parity-layout generator, the label packed and in
bf16):

P. holds K1's packed and cfhw layouts against their twins, bit for bit,
   at 29 frames of 320×480 (f32 and bf16 labels, masks on and off, one
   train-table case), and times them as phase 3 does, the packed bf16
   call also on a compact person; then holds every layout, label type
   and mask option bit for bit on the cull rule's adversarial tables
   (``adversarial_tables``) at 320×480, 318×478 and 45×61 and on the
   seed-0 poses and the person at the ragged sizes; and holds and times
   K1 on the tables that phases 4 and F rasterized;
F. runs the fastpath pipeline at full width on the same weights as
   phase 4: checks K1 launched once in the packed layout and the K2 and
   K2-parity launches against the counts derived from the module
   structure, the output, and the keyframes; prints its frames/s, stage
   times, a profile with the cuDNN algorithms of the mask net's up-path
   convolutions on both sides, and the generator's parts (embedder,
   trunk, mask net) timed in both layouts;
N. holds K2 parity against its twin at every parity shape the fastpath
   run gave it (recorded by a call hook), one bf16 shape and one
   mean-4096 input, and times kernel, twin and the library composition
   depth_to_space → ``F.instance_norm`` → space_to_depth; determinism,
   a streaming shape and the host time as in phase 2;
S. holds the card's fastpath pipeline with an f32 label against the
   card's standard pipeline on the same weights at full width;

then bf16 compute (both configs' ``compute_dtype: bfloat16``; with the
fastpath it is the JAX TPU serving configuration that ``bench.py``
times):

H. runs both serving configurations in bf16 at full width on phase 4's
   weights: checks K1, K2 shifted, K2 parity and K2 r3centered launches
   against the counts derived from the module structure (the standard
   clip launches only r3centered norms), the output and the keyframes;
   prints frames/s, stage times and the idle share beside the float32
   numbers of phases 4 and F, the largest |bf16 − f32| of the fused
   frames, a witness of where that gap comes from (the first generator
   step in bf16, and in float32 on bf16-rounded inputs and weights,
   each against float32, part by part; the clip with only the motion
   transformer, or only the renderer, in bf16), and the cuDNN kernels
   of the (7, 256, 80, 120) → 128 3×3 convolution in float32 and in
   bf16;
UC. holds the fused nearest ×2 upsample and 3×3 float32 convolution
   (``csrc/upconv.cu``) against its twin (1e-5 + 1e-5·|ref|) and
   against float64 upsample-then-conv (its error no larger than cuDNN's
   float32 path's) at the mask net's up2, up1 and up0 shapes and a
   ragged one, two calls bit for bit, one launch a call; times kernel,
   cuDNN's upsample-then-conv and twin in turns beside the bound in 4
   and in 9 taps, and fails where the kernel is slower than cuDNN at
   up2, up1 or up0, or at up2 takes over 0.8 ms or under 33% of its
   4-tap bound; lists every ``F.conv2d`` call of one float32 standard
   clip with cuDNN's kernels and ms (``upconv_convs.txt``).  Every
   phase that counts K1 and K2 launches counts the kernel's too and
   holds them against the module structure: 3 a float32 standard
   generator step in inference (9 a clip at rate 4), none in bf16, on
   the fastpath or in a training step;
SW. holds the shift warp as a gather and fused with the LK time blend
   (``csrc/shiftwarp.cu``) against its twins and the card's shift loop
   with ``torch.equal``: the whole ``upsample_background(**FLOW)`` of
   phase 4's keyframes and of three seeded drifting clips (flows past
   the bound), every warp they make ((14, 80, 120, 3) at R 4, (21, 320,
   480, 3) at R 16), the fused stream, and rates 2, 3 and 5 at 96x64;
   one launch a call, two calls bit for bit; times kernel, twin and loop
   beside the bytes bound, and the whole background a clip with the
   kernels and by the loop.  Every phase that counts serving launches
   holds the two kernels' too: one of each an LK clip at ``FLOW`` (the
   in-memory pipeline in every configuration, the artifact, the
   planner's N clips), four per doubling of the learned backgrounds
   (L, V2), none where the CLIs' full-resolution flow, the h5 or the
   prepared clips give the backgrounds or in training;
R. holds K2's r3centered mode against its twin at every shape the bf16
   standard run gave it (recorded by a call hook) to one bf16 ulp of n
   (× |γ|), with at most 0.01% of elements not bit-equal; prints each
   shape's path (cluster or grid) and cluster size, and checks that the
   profile shows that path's kernel; checks determinism (at the largest
   grid-path shape and at two cluster-path shapes, residuals included),
   the library composition, and a mean-256/std-1 input against the
   contract in float64; times kernel, twin and the library composition
   (``F.instance_norm`` in float32 → bf16 → affine); prints the host
   time per call at (1, 4, 4, 32) and (4, 40, 60, 256);
N2. holds K2 parity against its twin at every parity shape the bf16
   fastpath run gave it (bf16, and float32 in the mask net), and times
   it as phase N does;
E. holds the card's bf16 pipeline against the port's CPU bf16 pipeline
   at 64×96 in both configurations;
O. holds ``make_rollout`` and ``segment_rollout_chunked`` (2 segments
   a chunk) against ``make_segment_rollout`` (1e-3) on phase 4's
   29-frame clip, and the first segment chunk and ``rollout_chunked``
   (8 frames a chunk) against the unchunked rollouts of the same frames
   bit for bit;

then serving from files and evaluation:

V. writes phase 4's weights as the port's ``torch.save`` checkpoints and
   its keyframes and keyframe poses as PNGs and openpose JSONs, and runs
   the pipeline CLI (``renderloom_torch.cli.pipeline``) on them at full
   width in float32 and with both configs in bf16 (where PIL is missing:
   ``render_folder``'s array core on the same arrays, on a printed
   line): checks the frame and JSON counts, the keyframes, K1 (once per
   render chunk, masks off, held bit for bit on the run's tables) and
   K2 / K2 r3centered launches against the derived counts, and the
   motion stage against ``MotionInterpolator._run``; prints each stage's
   seconds and the files-in/frames-out rate; holds the card's CLI
   against the CPU's at 64x96 in PNG levels, with a planted control;
Q. runs ``evaluate_h5`` at full width (hsm.yaml, 81- and 80-frame clips:
   the segment and the sequential rollout) with LPIPS, in float32 and
   in bf16, through a real ``HsmReader`` where h5py and PIL import, else
   an in-memory reader: checks K1 (once per clip, masks on) and K2 / K2
   r3centered launches against the derived counts, finite metrics and
   ``DAIN_*`` identical in both runs, holds K1 and K2 at the run's
   shapes against their twins, prints seconds per clip by stage, frames
   evaluated per second and peak memory; holds the card against the
   CPU at 64x96 with a planted control;

then the training slice:

A. holds K1 on train-mode tables (random σ, keep and part flags from a
   seeded CPU generator) against its twin at 16 frames of 320×480 with
   masks, bit for bit, and times it as phase 3 does, on the spread
   poses and on a compact person;
C. trains at full width (configs/hsm.yaml, batch 4 × 4-frame raw
   windows at 480×320, float32, spectral norm, the fuse/raw/face/hand
   discriminators, the VGG19 term on random weights): one warm-up step
   that records every instance-norm call, then 3 timed steps; checks
   finite metrics, no skipped update, moved G/D parameters and ``u``
   vectors, and K1/K2/K2b launch counts against the counts derived from
   the module structure; prints ``gan_train_windows_per_sec``, the
   per-stage times and peak memory, and profiles one step;
B. holds the instance-norm backward K2b against its twin at every shape
   the warm-up step gave it (and K2's training forward, residuals
   included), plus small shapes through the ``autograd.Function``
   against a float64 gradient, and times kernel, twin and
   ``F.instance_norm``'s backward; determinism, a streaming shape and the
   host time as in phase 2;
D. holds one card training step against the same step on the CPU at
   64×96, B = 2, L = 3, tiny widths, identical weights and shared draws:
   every metric and the first frame's G and D gradients;

then bf16 training (``compute_dtype: bfloat16``, the configuration
``bench.py:bench_gan_train`` times on the accelerator):

T. phase C's step in bf16 with ``do_checkpoint`` on and off: the same
   checks (every norm launched in its r3centered mode, forward and
   backward, as derived from the module structure) and the same
   numbers, printed beside phase C's float32 ones of this run;
B2. holds K2b's r3centered mode (dx to one bf16 ulp with at most 0.05%
   of elements not bit-equal, dγ and dβ as phase B) and K2's r3centered
   mode with residuals against their twins at every shape phase T's
   warm-up gave them, with each shape's path and cluster size as phase
   R; determinism (at the largest shape and at two cluster-path shapes,
   where dγ and dβ must also equal the slabs' sums added in batch
   order), a mean-256 input against the contract in float64, one launch
   per call; times kernel, twin and the library composition (autograd
   through ``F.instance_norm`` in float32 → bf16 → affine → leaky);
   prints the host time per call as phase R;
D2. holds one card bf16 step against the CPU bf16 step at 64×96 by
   mean errors (metrics, and the first frame's gradients per parameter
   over their float32 largest), with the card against the CPU float32
   step as a control that must read beyond each limit;

then training from data (the JAX package's two training CLIs):

W. runs the renderer CLI's epoch loop (``train_renderer.train``) at full
   width (hsm.yaml, batch 4, 480×320, four discriminators, VGG19 loaded
   from a ``.pth`` of seeded random values at the real shapes through
   ``VGG19_NPZ``) for 4 epochs over two 7-frame train clips, the window
   growing from 4 to 5 frames after epoch 2 (``update_frame_step`` 2),
   then ``evaluate_h5`` on a 9-frame test clip with LPIPS, in float32
   and in bf16, through a real ``HsmReader`` where h5py and PIL import,
   else an in-memory one: checks the ``train/`` and ``eval/`` records
   (finite, no skipped update), the checkpoint read back by
   ``read_renderer`` and (float32) a ``--resume`` that continues from
   its step, K1 (once a step with masks at 16 then 20 frames, then once
   for the evaluation) and K2/K2b (or their r3centered modes) against
   the counts derived from the module structure, and holds K1 at the
   20-frame and evaluation tables and K2/K2b at every recorded shape
   against their twins; prints windows/s per epoch, the share of the
   loop spent waiting on the prefetcher and the evaluation's seconds;
M. trains the motion transformer at full width (motion.yaml: B 16,
   L 321, hidden 128, 6+6 layers, dropout 0.1) in float32 and bf16 on
   ``bench_motion_train``'s inputs (3 warm-up, 20 timed steps): finite
   metrics, moved parameters, no skipped update; prints
   ``motion_train_seqs_per_sec``, peak memory and the idle share of a
   profiled step; then runs the motion CLI's loop
   (``train_motion.train``) over an in-memory AMASS split (short clips
   padded, long ones cropped; statistics by ``compute_stats``) with one
   ``MotionEvaluator`` pass, and prints its metrics and seconds;
M2. holds the card's motion step against the CPU's at hidden 32, 2+2
   layers, L 33, B 2, dropout 0, with identical weights and draws: in
   float32 the losses, ``grad_norm`` and parameters after 3 steps; in
   bf16 by mean error, with the card bf16 step against the CPU float32
   step as a control that must read beyond each limit;

then the learned flow UNet and the pose head (after phase Q):

L. trains the flow UNet (FlowConfig(): base 24, 4 levels) through its
   CLI (``train_flow.main --synthetic``) at 384x256, batch 8, in float32
   and bf16: finite losses, no skipped update, the checkpoint; prints
   the CLI's steps/s, the step's alone, peak memory and the losses; runs
   the learned ``upsample_background`` (two doublings, rate 4) on phase
   4's 8 keyframes from the float32 checkpoint (shape, finite, keyframes
   exact) and prints its ms beside LK's (the CLIs' full-resolution flow
   and the in-memory pipeline's flow_scale 4); holds card against CPU
   at 64x96 (``_flow_cpu_match``: flows, ``time_warp``, one train step,
   bf16 flows with a float32 control);
K. trains the pose head (PoseNetConfig(): base 32, 4 blocks) through
   ``train_pose.main --synthetic --occlude-rate 0.5`` at 384x256, batch
   16, as L; runs ``extract_pose.extract_folder`` over phase 4's
   keyframes as PNGs at 384x256, batch 8 (the JSONs read back by
   ``data/openpose.py``); holds card against CPU at 64x96 (logits,
   keypoints, one train step on shared occlusion draws);
V2. runs the pipeline CLI at full width with ``--pose-ckpt`` and
   ``--flow-ckpt`` (K's and L's float32 checkpoints) on phase 4's
   weights: K1 and K2 launched exactly as in phase V's LK run, K1 held
   bit for bit on the run's tables, the frame, pose and background
   counts, the keyframes; prints each stage's seconds and frames/s
   beside V's;

then the frozen serving artifact and the batch planner (after phase O):

X. exports phase 4's float32 standard pipeline and phase H's bf16
   fastpath with ``torch.export`` (``renderloom_torch.eval.export``; K1
   and K2 as the registered operators ``renderloom::rasterize`` and
   ``renderloom::instance_norm``), saves each, and loads and serves it in
   a fresh process that imports none of the port's models, configs or
   checkpoints: checks the loaded program launches K1 and K2 (each mode)
   as often as the live run did, holds its frames to the live ones
   (float32 1e-3; bf16 phase E's mean limit with its control) and prints
   whether they are bit-equal, the artifact's MB, export, save and load
   seconds, frozen against live frames/s, and the host µs of a norm call
   through the wrapper, the operator and the eager dispatch;
Y. runs the bf16 fastpath at N = 1, 2, 4, 8 clips: ms per batch, peak
   memory and launches per N, and ``utils.serving.plan_chunks``' plans
   and planned frames/s for n = 1..16;

and the train steps' reproducibility (after phase M2):

G. runs the full-width float32 GAN step (phase C's configuration) twice
   from one state per setting: at learning rate 0 the largest |dg| of
   each network by default, under ``torch.use_deterministic_algorithms
   (True, warn_only=True)`` with ``cudnn.deterministic`` and
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, and under those settings with the
   discriminators' resize as torch's antialiased ``F.interpolate``,
   printing the operators torch names as having no deterministic CUDA
   implementation; the windows/s by default, with that resize and with
   ``cudnn.deterministic``, in turns; two runs of 2 steps at the
   learning rate by default and with ``cudnn.deterministic``; and the
   flow and pose steps at 384x256 twice each, by default and with
   ``cudnn.deterministic``, in turns; the card's matmul resize against
   ``F.interpolate`` at the GAN step's resize shapes.  It fails unless
   the deterministic settings make all three steps repeat bit for bit
   with no operator named;

and data parallelism (after phase G):

Z. the motion step (motion.yaml, dropout 0) and the GAN step (hsm.yaml,
   float32, global batch 4) at world 2 — two spawned processes over gloo,
   both on the card — against world 1 on the same global batches: the
   motion step as tests/test_torch_parallel.py holds both (``dp_hold``:
   metrics 1e-6 relative, parameters 1e-6 but for the near-zero-gradient
   elements), the GAN step, whose backward on the card is not
   reproducible to the bit (cuDNN's backward algorithms, phase G), at
   learning rate 0 (``dp_hold_gradients``:
   every metric 1e-6 relative, the averaged gradients 3e-3 of their
   largest), each rank launching K1, K2 and K2b as world 1 does; their
   seqs/s and windows/s; the motion CLI under ``torchrun
   --nproc_per_node=1`` on NCCL; and ``python -m renderloom_torch.bench``
   once per metric, its JSON lines printed;

then the perceptual backbones, data-parallel serving and the layer
variants (after phase Z):

U. phase C's float32 GAN step, 2 steps on each alternate perceptual
   backbone (``make_perceptual(..., network=...)``: VGG16, AlexNet,
   ResNet-50, Inception-v3, robust ResNet-50, VGG-Face; seeded random
   weights; one G/D state stepped through all): K1, K2 and K2b launched
   as in phase C, the first step's K2 and K2b calls held against their
   twins on the step's own tensors (the first call of each shape),
   finite metrics and no skipped update; windows/s of the second step,
   peak memory, the perceptual term's forward and backward ms per step;
   each backbone's taps card against CPU at 64×96 (Inception 96×128);
J. data-parallel serving: 4 clips of phase 4's configuration (float32,
   the standard generator) over two spawned ranks on the card (gloo):
   each rank's generator replicated from rank 0's, its 2 clips
   prepared (K1) and rolled out (K2), the frames and masks gathered in
   clip order and held against world 1 on the same clips (1e-3); each
   rank's K1 and K2 launches beside world 1's;
I. every layer variant of ``models/layers.py`` (``NonLocalBlock``,
   ``PartialConv``, ``hyper_conv2d``, ``weight_demodulated_conv2d``,
   ``LayerNorm2d``, ``HyperSpade``, ``PartialConvBlock``,
   ``PartialResBlock``, ``PartialConv3d``) forward and backward on the
   card against the CPU at B 4, 80×120, C 256 (``PartialConv3d`` at
   (2, 8, 40, 60, 64)), with the K2 and K2b launches of those with
   instance norms;

then the last modules of the JAX package (after phase I):

CI. checkpoint import from the reference: writes the reference's files
   (``write_reference_checkpoints``: netG and netD at hsm.yaml's widths
   with spectral ``weight_orig``/``weight_u``/``weight_v``, a
   ``module.`` prefix and the dead keys; ``model_epoch399.pth`` at
   motion.yaml's with its ``opt_epoch399.pth`` AMSGrad moments; a
   torchvision VGG19 with its classifier), seeded, in torch's legacy
   format, and imports each with ``cli/import_checkpoint`` (seconds
   printed); then (a) runs the pipeline CLI on phase 4's clip (as phase
   V writes it) from the imported files and from ``.npz`` files of the
   trees the ``map_*`` functions return: frames, backgrounds and
   Predict_motion bit for bit, K1 1 and K2 162 per clip; (b)
   ``train_motion --resume`` from the imported checkpoint: its AMSGrad
   count and moments bit for bit the ``.pth``'s, then 2 steps; (c)
   ``train_renderer --synthetic --resume`` from the imported G and D
   with ``VGG19_NPZ`` the imported ``.npz``, 2 steps at phase C's batch,
   K1, K2 and K2b against the counts derived from the module structure;
SK. ``render_skeleton_frames`` on a motion of motion.yaml's
   ``max_seq_length`` (321) frames at 512×512: K1 in its cfhw layout,
   one launch per chunk of 32 frames, each chunk bit for bit its twin;
   call and device ms of a full and the last chunk beside the bound and
   the twin; the uint8 frames of the first and the last chunk equal the
   CPU's;
BW. ``build_dataset warp`` in both modes on an 8-frame 768×512 clip of
   PNGs against the same command with ``--device cpu``, in PNG levels
   with a planted control, and the seconds per clip;
TP. ``parallel.shard_params_tp`` on the serving generator at full
   width, one forward at B = 2 on two spawned ranks on the card (gloo)
   against world 1 (``tp_run``): the output, each rank's parameter
   bytes, K2 launches per rank;

and last prints the ``{"kernels": [...]}`` line, the card line, and the
``{"ok": true, "device": {...}}`` line.

Each kernel time is given twice: **call ms** (CUDA events over
back-to-back calls: the device time, or the host's time per call
wherever the host is the slower) and **device ms** (CUDA events over
calls queued behind a spin kernel, so the host is out of it; the
profiler's per-call kernel records proved unreliable after a large
profile).  The norm phases also check in a profile that each K2,
K2-parity and K2b call makes one launch and runs no other kernel.

Any failed check raises, so the script exits non-zero.  Long outputs
(compiler reports, the profile tables, ``profile_fastpath.txt``) go to
``build/chip_smoke/``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12               # H100 SXM, fp32 outside the tensor cores
LEAKY = 0.2


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def card_state() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call of ``fn()``: ``iters`` calls queued behind a
    ~10 ms spin kernel, so the host has enqueued them all before the
    first runs, timed by CUDA events; the host's share that ``cuda_ms``
    includes is left out (the gaps between kernels on the device stay).
    Raises if the host took nearly as long to enqueue as the spin."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)          # ~10 ms at the H100's 1.98 GHz
    tic = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host = (time.perf_counter() - tic) * 1e3
    torch.cuda.synchronize()
    if host >= 8.0:
        raise AssertionError(f"device_ms: enqueueing took {host:.2f} ms, "
                             f"about as long as the spin kernel")
    return start.elapsed_time(end) / iters


def launches_per_call(fn, iters: int = 3):
    """(launches per call, kernel names) of ``fn()`` from
    ``torch.profiler``: the runtime's launch calls (the CPU side, which
    the profiler keeps), and the names of the kernels the device ran,
    where the profiler kept their records (it may drop them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = prof.events()
    n = sum(e.device_type == DeviceType.CPU
            and e.name.startswith(("cudaLaunch", "cuLaunch", "cudaMemset",
                                   "cudaMemcpy")) for e in evs)
    names = sorted({e.name for e in evs if e.device_type == DeviceType.CUDA
                    and not e.name.startswith(("Activity Buffer",
                                               "Buffer Flush"))})
    return n / iters, names


def one_kernel(what: str, fn, want: str):
    """Raise unless each call of ``fn()`` makes one launch (the runtime's
    launch calls in the profile) and the device runs no kernel but
    ``want`` (where the profile kept the kernel records)."""
    per_call, names = launches_per_call(fn)
    if per_call != 1 or any(want not in n for n in names):
        raise AssertionError(f"{what}: {per_call} launches per call, "
                             f"kernels {names}; expected one {want}")


def host_us(fn, n: int = 200) -> float:
    """Host time per call of ``fn()`` in µs: ``n`` calls enqueued back to
    back (fewer than the launch queue holds), timed before the
    synchronise."""
    fn()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - tic) / n * 1e6
    torch.cuda.synchronize()
    return us


def bound_ms(n_bytes: float, n_flops: float):
    """Least time for the work: bytes over HBM rate, fp32 operations
    over the fp32 peak, whichever is longer."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def compare(name: str, got: torch.Tensor, want: torch.Tensor, atol: float,
            rtol: float = 0.0) -> float:
    """Max |got − want|; raises where it exceeds atol + rtol·|want|."""
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    excess = (diff - atol - rtol * want.float().abs()).max().item()
    tol = f"{atol:.0e}" + (f" + {rtol:.0e}·|ref|" if rtol else "")
    ok = excess <= 0 and np.isfinite(err)
    print(f"  {name}: max_abs_err {err:.3e} (tol {tol}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: error {err} over tolerance {tol}")
    return err


def _write(name: str, text: str):
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, name), "w") as f:
        f.write(text)


# ---------------------------------------------------------------------------
# 1. card and build
# ---------------------------------------------------------------------------


def phase_build():
    from renderloom_torch.ops import _build

    print(f"card: {card_line()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    tic = time.perf_counter()
    logs = _build.build()
    print(f"built {_build.sources()} in {time.perf_counter() - tic:.1f} s "
          f"({len(logs)} compiled, the rest cached)")
    for name, log in logs.items():
        _write(f"ptxas_{name}.txt", log)
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = _kernel_tag(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                print(f"  {name} {entry}: {line.strip()}")
    # the rasterizer's machine code, whose loops raster_bound counts
    sass = subprocess.run(
        [os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"), "-sass",
         str(_build.library_path("rasterize"))],
        capture_output=True, text=True, timeout=120)
    _write("sass_rasterize.txt", sass.stdout + sass.stderr)
    K1_OPS.update(k1_ops_from_sass(sass.stdout))
    print(f"  K1 fp32 operations per pixel and kept term (SASS): {K1_OPS}")


def _kernel_tag(mangled: str) -> str:
    """A short name for a mangled kernel: raster_kernel<f32|bf16, layout>
    for the rasterizer's instantiations."""
    import re

    m = re.search(r"raster_kernelI(f|13__nv_bfloat16)Li(\d)E", mangled)
    if m is None:
        name = re.search(r"\d+([a-z_]*kernel)(.*)", mangled)
        return mangled[:60] if name is None else name[1] + name[2][:24]
    return (f"raster_kernel<{'f32' if m[1] == 'f' else 'bf16'}, "
            f"{('nhwc', 'packed', 'cfhw')[int(m[2])]}>")


# ---------------------------------------------------------------------------
# 2. K2 instance norm
# ---------------------------------------------------------------------------

# (shape, dtype, affine, leaky): the generator's full-width shapes at 7
# segments.  Tolerance, as atol + rtol·|ref|: f32 1e-5 + 1e-5·|ref| (1e-4
# at C=512) — moments summed over up to 153600 pixels in another order
# than the twin's differ by ~1e-6 relative, so the error grows with the
# output's size, which the affine stretches past 10; bf16 8e-3 +
# 8e-3·|ref|, one bf16 ulp, since fp32 values a few ulp apart can round
# to neighbouring bf16 values.
K2_CASES = [
    ((7, 320, 480, 16), torch.float32, False, False),
    ((7, 320, 480, 32), torch.float32, True, True),
    ((7, 40, 60, 256), torch.float32, True, False),
    ((7, 20, 30, 512), torch.float32, True, True),
    ((7, 160, 240, 64), torch.bfloat16, True, True),
]


def _k2_tol(shape, dtype):
    if dtype == torch.bfloat16:
        return 8e-3, 8e-3
    tol = 1e-4 if shape[-1] >= 512 else 1e-5
    return tol, tol


def _norm_inputs(shape, dtype, affine, seed, loc=0.0, scale=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (loc + scale * torch.randn(shape, device="cuda", generator=g)
         ).to(dtype)
    s = b = None
    if affine:
        s = 1.0 + 0.5 * torch.randn(shape[-1], device="cuda", generator=g)
        b = torch.randn(shape[-1], device="cuda", generator=g)
    return x, s, b


def _norm_check(name, x, s, b, slope):
    from renderloom_torch.ops import norm_kernel as NK

    atol, rtol = _k2_tol(tuple(x.shape), x.dtype)
    return compare(name, NK.instance_norm_cuda(x, s, b, slope),
                   NK.instance_norm_plain(x, s, b, slope), atol, rtol)


def _norm_times(x, s, b, slope, iters=20):
    """(call, device, twin, F.instance_norm, bound) ms of one call, and
    what bounds it; raises unless the call is one kernel."""
    from renderloom_torch.ops import norm_kernel as NK

    n = x.numel()
    f = lambda: NK.instance_norm_cuda(x, s, b, slope)
    ms, dev = cuda_ms(f, iters), device_ms(f)
    one_kernel(f"K2 {tuple(x.shape)}", f, "norm_fwd_kernel")
    plain = cuda_ms(lambda: NK.instance_norm_plain(x, s, b, slope),
                    max(2, iters // 4), 1)
    xn = x.permute(0, 3, 1, 2)              # NCHW view, channels_last
    lib = cuda_ms(lambda: F.instance_norm(xn, weight=s, bias=b, eps=1e-5),
                  iters)
    # each input read once, each output written once; ~10 fp32
    # operations per element (shifted moments 4, apply 4, affine and
    # leaky 2)
    bnd, by = bound_ms(2 * n * x.element_size(), 10 * n)
    return ms, dev, plain, lib, bnd, by


def _times_line(ms, dev, plain, lib, bnd, by,
                lib_name="F.instance_norm") -> str:
    return (f"    call {ms:.4f} ms, device {dev:.4f} ms ({100 * bnd / dev:.1f}"
            f"% of bound), twin {plain:.4f} ms, {lib_name} {lib:.4f} ms, "
            f"bound {bnd:.4f} ms ({by})")


# past the grid's shared memory (about 26 MB on an H100): the plan
# streams what does not fit and reads it again
STREAM_SHAPE = (1, 1080, 1920, 32)


def _plan_of(x, n_inputs, parity=False) -> dict:
    from renderloom_torch.ops import norm_kernel as NK

    B, H, W, C = x.shape
    return NK._plan(B, H * W, C, x.element_size(), n_inputs,
                    *NK._device(x.device.index)[:3], parity=parity)


def phase_norm():
    from renderloom_torch.ops import norm_kernel as NK

    print("K2 instance norm, kernel vs plain twin:")
    for i, (shape, dtype, affine, leaky) in enumerate(K2_CASES):
        x, s, b = _norm_inputs(shape, dtype, affine, seed=i)
        slope = LEAKY if leaky else None
        _norm_check(f"{shape} {str(dtype)[6:]} affine={affine} "
                    f"leaky={leaky}", x, s, b, slope)
        print(_times_line(*_norm_times(x, s, b, slope))
              + f"; plan {_plan_of(x, 1)}")
    # the reference's fp32 contract: mean 4096, std 1e-2 keeps its variance
    x, _, _ = _norm_inputs((7, 40, 60, 256), torch.float32, False, 9,
                           loc=4096.0, scale=1e-2)
    _norm_check("(7, 40, 60, 256) float32 mean 4096 std 1e-2", x, None,
                None, None)
    x64 = x.double()
    ref = (x64 - x64.mean((1, 2), keepdim=True)) / torch.sqrt(
        x64.var((1, 2), unbiased=False, keepdim=True) + 1e-5)
    compare("  the same against the float64 reference",
            NK.instance_norm_cuda(x).double(), ref, 2e-3)
    # two calls at the largest shape give the same bits
    x, s, b = _norm_inputs((7, 320, 480, 32), torch.float32, True, 1)
    st1, st2 = (torch.empty((7, 32, 3), device="cuda") for _ in range(2))
    y1 = NK.instance_norm_cuda(x, s, b, LEAKY, 1e-5, st1)
    y2 = NK.instance_norm_cuda(x, s, b, LEAKY, 1e-5, st2)
    if not (torch.equal(y1, y2) and torch.equal(st1, st2)):
        raise AssertionError("K2: two calls differ")
    print("  determinism: two calls at (7, 320, 480, 32) equal bit for bit "
          "(output and residuals) ok")
    # a shape whose slab exceeds the grid's shared memory
    x, s, b = _norm_inputs(STREAM_SHAPE, torch.float32, True, 11)
    plan = _plan_of(x, 1)
    if not plan["streaming"]:
        raise AssertionError(f"{STREAM_SHAPE} does not stream: {plan}")
    _norm_check(f"streaming {STREAM_SHAPE} float32 affine=True leaky=True "
                f"(plan {plan})", x, s, b, LEAKY)
    x, _, _ = _norm_inputs((1, 4, 4, 32), torch.float32, False, 12)
    print(f"  host time per call at (1, 4, 4, 32): "
          f"{host_us(lambda: NK.instance_norm_cuda(x)):.1f} us")


# ---------------------------------------------------------------------------
# 3. K1 rasterizer
# ---------------------------------------------------------------------------

F_RASTER, H_FULL, W_FULL = 29, 320, 480


def _poses(F_: int, H: int, W: int, seed: int, device="cuda"):
    """Joints spread over the frame (and a few pixels past its edges),
    about a fifth of them below the confidence threshold."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform([-8, -8], [W + 8, H + 8], (F_, 19, 2))
    conf = np.where(rng.uniform(size=(F_, 19)) > 0.2, 0.9, 0.0)
    return (torch.tensor(coords, dtype=torch.float32, device=device),
            torch.tensor(conf, dtype=torch.float32, device=device))


# a standing person in a unit box (x right, y down), in the joint order of
# renderloom_torch.ops.rasterize.POSE_EDGES_19: nose, neck, right arm
# (shoulder, elbow, wrist), left arm, mid hip, right leg (hip, knee,
# ankle), left leg, left foot, right foot, left hand, right hand
_PERSON = np.array([
    [0.50, 0.06], [0.50, 0.19], [0.29, 0.20], [0.21, 0.38], [0.17, 0.54],
    [0.71, 0.20], [0.79, 0.38], [0.83, 0.54], [0.50, 0.50], [0.38, 0.50],
    [0.36, 0.73], [0.35, 0.95], [0.62, 0.50], [0.64, 0.73], [0.65, 0.95],
    [0.71, 0.98], [0.29, 0.98], [0.85, 0.58], [0.15, 0.58]])


def _person_poses(F_: int, H: int, W: int, seed: int, device="cuda"):
    """One standing person a quarter of the frame wide and three quarters
    high (120×240 at 320×480), anywhere in the frame in each frame, each
    joint moved by up to 6 px, one in twenty below the confidence
    threshold: the compact figure that serving poses are, where the
    spread ``_poses`` keep fewer (tile, term) pairs."""
    rng = np.random.default_rng(seed)
    box = np.array([W / 4, 3 * H / 4])
    origin = rng.uniform([0, 0], [W, H] - box, (F_, 1, 2))
    coords = (origin + _PERSON * box
              + rng.uniform(-6, 6, (F_, 19, 2)))
    conf = np.where(rng.uniform(size=(F_, 19)) > 0.05, 0.9, 0.0)
    return (torch.tensor(coords, dtype=torch.float32, device=device),
            torch.tensor(conf, dtype=torch.float32, device=device))


def adversarial_tables(H: int, W: int, device="cuda"):
    """K1 tables (joints, skel, caps) of 3 frames that sit on the edges of
    the kernel's cull rule (``rasterize_kernel.tile_terms``), for tiles of
    16x16 and 8x32 pixels (corners at x multiples of 32, y of 16):

    frame 0: each joint at a tile corner with d^2 * inv from 100 to 120
      there (exp underflows past 103.97; the rule skips past 110); skeleton
      capsules whose segment (brush 4) or end dot (radius 8) passes 0.5 px
      inside or outside a tile edge; mask disks and capsules tangent to a
      tile edge at their radius +- 0.5 px;
    frame 1: zero-length skeleton and mask segments, a NaN coordinate on
      an invalid joint (its heatmap is NaN everywhere, in the plain
      version too), an invalid joint with inv < 0 (exp overflows: NaN far
      from it), a joint with inv = 0, one far outside the frame;
    frame 2: every term invalid; the last skeleton capsule's colour is
      infinite (0 * inf: its channels are NaN everywhere).
    """
    rng = np.random.default_rng(11)
    corners = [(x, y) for y in range(16, H, 16) for x in range(32, W, 32)]
    offs = [(1, 0), (0, 1), (3, 4), (5, 12), (7, 1), (2, 9), (8, 6)]
    targets = [100.0, 103.0, 103.9, 104.0, 104.5, 105.0, 108.0, 109.9,
               110.0, 110.1, 112.0, 115.0, 120.0]
    joints = np.zeros((3, 19, 4), np.float32)
    skel = np.zeros((3, 18, 8), np.float32)
    caps = np.zeros((3, 39, 7), np.float32)
    colors = np.array([[153, 0, 51], [0, 153, 0], [0, 0, 208]],
                      np.float32) / 255.0
    radii = np.array([30.0] + [15.0] * 18 + [15.0] * 17 + [20.0] * 3,
                     np.float32)
    for j in range(19):
        cx, cy = corners[j % len(corners)]
        dx, dy = offs[j % len(offs)]
        d2 = np.float32(dx * dx + dy * dy)
        inv = np.float32(targets[j % len(targets)]) / d2
        joints[0, j] = (cx - dx, cy - dy, inv, 1.0)
    for e in range(18):
        cx, cy = corners[(3 * e) % len(corners)]
        off = (3.5, 4.5, 7.5, 8.5)[e % 4]
        if e % 4 < 2:       # the segment's side, 4 +- 0.5 from the edge
            a, b = (cx - 10.0, cy - off), (cx + 10.0, cy - off)
        else:               # the end dot, 8 +- 0.5 from the edge
            a, b = (cx + 5.0, cy - off), (cx + 5.0, cy - off - 20.0)
        if e % 8 >= 4:      # the same against a vertical edge
            a, b = (a[1] - cy + cx, a[0] - cx + cy), (b[1] - cy + cx,
                                                      b[0] - cx + cy)
        skel[0, e] = (*a, *b, 1.0, *colors[e % 3])
    for k in range(39):
        cx, cy = corners[(5 * k + 1) % len(corners)]
        off = radii[k] + (0.5 if k % 2 else -0.5)
        a = (cx + 3.0, cy - off)
        b = a if k < 19 else (a[0] + 12.0, a[1])
        caps[0, k] = (*a, *b, radii[k], 1.0, float(k % 3 == 0))
    # frame 1: degenerate terms
    pts = rng.uniform([0, 0], [W, H], (19, 2)).astype(np.float32)
    joints[1, :, :2] = np.floor(pts)
    joints[1, :, 2] = 0.02
    joints[1, :, 3] = 1.0
    joints[1, 0] = (np.nan, 5.0, 0.02, 0.0)      # NaN on an invalid joint
    joints[1, 1, 2] = 0.0                        # inv = 0: 1 everywhere
    joints[1, 3, 2:] = (-1.0, 0.0)               # inv < 0, invalid
    joints[1, 2, :2] = (1e7, -3e6)               # far outside the frame
    for e in range(18):                          # zero-length segments
        skel[1, e] = (*pts[e], *pts[e], 1.0, *colors[e % 3])
    for k in range(39):
        p = np.floor(pts[k % 19])
        caps[1, k] = (*p, *p, radii[k], 1.0, float(k % 2))
    caps[1, 0] = (np.nan, np.nan, np.nan, np.nan, 30.0, 0.0, 0.0)
    # frame 2: everything invalid
    joints[2, :, :2] = rng.uniform([0, 0], [W, H], (19, 2))
    joints[2, :, 2] = 0.02
    skel[2, :, :4] = rng.uniform(0, min(H, W), (18, 4))
    skel[2, :, 5:] = colors[np.arange(18) % 3]
    skel[2, 17, 5] = np.inf
    caps[2, :, :4] = np.floor(rng.uniform(0, min(H, W), (39, 4)))
    caps[2, :, 4] = radii
    return tuple(torch.tensor(t, device=device) for t in (joints, skel, caps))


def kept_share(keep: dict) -> float:
    """Share of (tile, term) pairs kept in ``rasterize_kernel.tile_terms``'
    output ``keep``."""
    return (sum(int(k.sum()) for k in keep.values())
            / sum(k.numel() for k in keep.values()))


# fp32 operations of a SASS opcode (by its stem), FFMA counted as 2
_FP32_COST = {"FADD": 1, "FMUL": 1, "FFMA": 2, "FSETP": 1, "FMNMX": 1,
              "FCHK": 1, "MUFU": 1}


def k1_ops_from_sass(text: str) -> dict:
    """K1's fp32 operations per pixel and kept term, counted in the machine
    code of raster_kernel<f32, nhwc> (``cuobjdump -sass`` of the build,
    as phase 1 dumps it): a skeleton and a mask capsule are one pass of
    the first and second loop that holds the IEEE division's slow-path
    call, in that order; a gaussian is the mean span between two of the
    19 unrolled ``expf`` (``MUFU.EX2``); ``divide`` is the straight code
    after the skeleton loop up to the next shared load (the three colour
    divisions and the label's assembly, run where a tile keeps a skeleton
    capsule).  ``pixel`` (the pixel's coordinates) is fixed at 3.  Raises
    where the code has not that shape: the kernel changed, and so must
    this count."""
    import re

    body = next((b for b in re.split(r"^\s*Function : ", text, flags=re.M)
                 if re.match(r"\S*raster_kernelIfLi0E", b)), None)
    if body is None:
        raise AssertionError("no raster_kernel<f32, nhwc> in the SASS")
    ins = [(int(m[1], 16), m[2]) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+([^;\n]*);", body)]
    at = {a: i for i, (a, _) in enumerate(ins)}
    opc = [re.sub(r"^@!?U?P\w+\s+", "", t).split()[0] for _, t in ins]
    ops = lambda lo, hi: sum(_FP32_COST.get(o.split(".")[0], 0)
                             for o in opc[lo:hi])
    loops = []
    for i, (a, t) in enumerate(ins):
        m = re.match(r"@!?P\w+\s+BRA\s+(0x[0-9a-f]+)", t)
        if m and int(m[1], 16) < a:
            lo = at[int(m[1], 16)]
            if any(o.startswith("CALL") for o in opc[lo:i]):
                loops.append((lo, i + 1))
    ex = [i for i, o in enumerate(opc) if o == "MUFU.EX2"]
    if len(loops) != 2 or len(ex) != 19:
        raise AssertionError(f"raster_kernel<f32, nhwc>: {len(loops)} loops "
                             f"with a division (want 2), {len(ex)} expf "
                             f"(want 19); recount K1's operations")
    (s0, s1), (c0, c1) = loops
    end = next((i for i in range(s1, len(opc)) if opc[i].startswith("LDS")),
               len(opc))
    return {"joints": ops(ex[0], ex[-1]) / (len(ex) - 1),
            "skel": ops(s0, s1), "caps": ops(c0, c1), "pixel": 3,
            "divide": ops(s1, end)}


# K1's fp32 operations per pixel and kept term, from phase 1's SASS
# (k1_ops_from_sass; on an NVIDIA H100 80GB HBM3 with CUDA 12: gaussian
# 18, skeleton capsule 45, mask capsule 31, divide 43).  The stores count
# as bytes.
K1_OPS = {}


def raster_bound(tables, H, W, label_bytes, emit_masks, layout,
                 brush=4.0):
    """(bound ms, its side, kept share, operations' ms) of one K1 call
    on these tables:
    the label (and masks) written once, against the operations of the
    (pixel, term) pairs that the cull rule keeps on these tables, plus
    each pixel's own; the longer of the two."""
    from renderloom_torch.ops import rasterize_kernel as RK

    if not K1_OPS:
        raise AssertionError("K1_OPS is counted from the SASS in phase 1")
    keep = RK.tile_terms(*tables, H, W, emit_masks=emit_masks,
                         layout=layout, brush=brush)
    th, tw = RK.TILES[layout]
    dev = tables[0].device
    rows = torch.clamp(H - torch.arange(0, H, th, device=dev), max=th)
    cols = torch.clamp(W - torch.arange(0, W, tw, device=dev), max=tw)
    px = (rows[:, None] * cols[None, :]).double()        # pixels per tile
    n_px = tables[0].shape[0] * H * W
    ops = (n_px * K1_OPS["pixel"] + K1_OPS["divide"] * float(
        (keep["skel"].any(-1).double() * px).sum()) + sum(
        K1_OPS[k] * float((v.sum(-1).double() * px).sum())
        for k, v in keep.items()))
    n_bytes = n_px * 22 * label_bytes + (8 * n_px if emit_masks else 0)
    return (*bound_ms(n_bytes, ops), kept_share(keep),
            ops / FP32_FLOPS * 1e3)


def same_bits(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Raise unless ``got`` equals ``want`` bit for bit, NaN exactly where
    ``want`` is NaN (the card's bf16 NaN has other bits than torch's
    conversion gives); returns max |got - want| elsewhere (0.0)."""
    g, w = got.float(), want.float()        # exact, signed zeros kept
    nan = torch.isnan(w)
    ok = (g.shape == w.shape and torch.equal(nan, torch.isnan(g))
          and torch.equal(g[~nan].view(torch.int32),
                          w[~nan].view(torch.int32)))
    err = (g[~nan] - w[~nan]).abs().max().item() if (~nan).any() else 0.0
    print(f"  {name}: bit for bit {'ok' if ok else 'FAIL'}"
          + (f" ({int(nan.sum())} NaN in both)" if nan.any() else ""))
    if not ok:
        raise AssertionError(f"{name}: not bit for bit, max |err| {err}")
    return err


def _k1_check(tag, tables, H, W, dtype, masks, layout, brush=4.0):
    """K1 against its twin, every output bit for bit; returns the error
    and the kernel's output."""
    from renderloom_torch.ops import rasterize_kernel as RK

    args = (*tables, H, W, dtype, masks, brush)
    got = RK.rasterize_tables_cuda(*args, layout=layout)
    want = RK.rasterize_tables_plain(*args, layout=layout)
    torch.cuda.synchronize()
    err = max(same_bits(f"{tag} {k}", got[k], want[k]) for k in want)
    return err, got


def _k1_times(tag, tables, H, W, dtype, masks, layout, brush=4.0):
    """One launch per call (profile), call/device/twin ms, the bound on
    these tables and the kept share."""
    from renderloom_torch.ops import rasterize_kernel as RK

    args = (*tables, H, W, dtype, masks, brush)
    f = lambda: RK.rasterize_tables_cuda(*args, layout=layout)
    one_kernel(f"K1 {tag}", f, "raster_kernel")
    ms, dev = cuda_ms(f), device_ms(f)
    plain = cuda_ms(lambda: RK.rasterize_tables_plain(*args, layout=layout),
                    3, 1)
    bnd, by, share, ops_ms = raster_bound(
        tables, H, W, torch.finfo(dtype).bits // 8, masks, layout, brush)
    print(f"    call {ms:.4f} ms, device {dev:.4f} ms ({bnd / dev:.1%} of "
          f"bound), twin {plain:.4f} ms, bound {bnd:.4f} ms ({by}; "
          f"operations {ops_ms:.4f} ms), kept {share:.2%} of (tile, term) "
          f"pairs, 1 launch per call")
    return dict(max_abs_err=0.0, ms=ms, device_ms=dev, plain_ms=plain,
                bound_ms=bnd, bound_by=by, library_ms=None, kept_share=share)


def phase_raster():
    print(f"K1 rasterizer, kernel vs plain twin bit for bit "
          f"({F_RASTER} frames, {H_FULL}x{W_FULL}, nhwc):")
    from renderloom_torch.ops import rasterize_kernel as RK

    coords, conf = _poses(F_RASTER, H_FULL, W_FULL, seed=0)
    tables = [t.contiguous() for t in
              RK.build_tables(coords, conf, H_FULL, W_FULL)]
    result = None
    for dtype in (torch.float32, torch.bfloat16):
        for masks in (False, True):
            tag = f"nhwc {str(dtype)[6:]} masks={masks}"
            err, _ = _k1_check(tag, tables, H_FULL, W_FULL, dtype, masks,
                               "nhwc")
            times = _k1_times(tag, tables, H_FULL, W_FULL, dtype, masks,
                              "nhwc")
            if dtype == torch.float32 and not masks:
                result = dict(times, max_abs_err=err)
    print("  a compact person (_person_poses, seed 0):")
    coords, conf = _person_poses(F_RASTER, H_FULL, W_FULL, seed=0)
    ptables = [t.contiguous() for t in
               RK.build_tables(coords, conf, H_FULL, W_FULL)]
    for dtype in (torch.bfloat16, torch.float32):
        for masks in (True, False):
            err, _ = _k1_check(f"person nhwc {str(dtype)[6:]} masks={masks}",
                               ptables, H_FULL, W_FULL, dtype, masks, "nhwc")
    result["person"] = dict(_k1_times(
        "person nhwc float32 masks=False", ptables, H_FULL, W_FULL,
        torch.float32, False, "nhwc"), max_abs_err=err)
    return result


# ---------------------------------------------------------------------------
# 4. full-width pipeline
# ---------------------------------------------------------------------------


def _bench_inputs(K, H, W, device):
    """bench.py:bench_e2e's inputs, from numpy seed 0."""
    rng = np.random.default_rng(0)
    motion = rng.uniform(-0.4, 0.4, (19, 2, K))
    conf = np.full((19, 1, K), 0.9)
    keys = rng.uniform(0, 1, (K, H, W, 3))
    as_t = lambda a: torch.tensor(a[None], dtype=torch.float32,
                                  device=device)
    return as_t(motion), as_t(conf), as_t(keys)


def _count_norms(module) -> int:
    """Instance-norm launches per call of ``module``: one per
    InstanceNorm module and one per SPADE."""
    from renderloom_torch.models.layers import InstanceNorm, Spade

    return sum(isinstance(m, (InstanceNorm, Spade))
               for m in module.modules())


def _count_upconvs(module) -> int:
    """``csrc/upconv.cu`` launches per float32 inference call of
    ``module``: one per up block of each standard mask net."""
    from renderloom_torch.models.renderer import MaskGenerator

    return sum(m.num_downsamples for m in module.modules()
               if isinstance(m, MaskGenerator))


def _norm_kind_recorder(seen: Counter):
    """Swap ``norm_kernel.instance_norm`` (which both generators' modules
    call) for a recorder of each call's (shape, dtype, affine, slope,
    kind), kind being the contract the dispatch takes: "parity",
    "r3centered" (a bf16 x in the standard layout) or "shifted"; returns
    the function that puts it back."""
    from renderloom_torch.models import fastpath as PF
    from renderloom_torch.models import layers as TL

    inner = TL.instance_norm

    def rec(x, scale=None, bias=None, slope=None, eps=1e-5, parity=False):
        kind = ("parity" if parity else "r3centered"
                if x.dtype == torch.bfloat16 else "shifted")
        seen[(tuple(x.shape), x.dtype, scale is not None, slope, kind)] += 1
        return inner(x, scale, bias, slope, eps, parity=parity)
    TL.instance_norm = PF.instance_norm = rec

    def restore():
        TL.instance_norm = PF.instance_norm = inner
    return restore


# launch-count key of each contract
KIND_KEYS = {"shifted": "instance_norm", "parity": "instance_norm_parity",
             "r3centered": "instance_norm_r3"}


def _by_kind(seen: Counter) -> Counter:
    """Recorded norm calls summed by launch-count key."""
    out = Counter()
    for key, n in seen.items():
        out[KIND_KEYS[key[4]]] += n
    return out


def _stage_times(fn_parts, motion, conf, keys, rate, K, **prep_kwargs):
    """Host-clock time of each pipeline stage, synchronised between
    stages (the pipeline's own calls, in its order), and the prepared
    clip the rollout ran on; ``prep_kwargs`` are the pipeline's label
    options (``label_dtype``, ``packed_label``)."""
    from renderloom_torch.data.hsm import prepare_batch
    from renderloom_torch.eval.motion_infer import bucket_length
    from renderloom_torch.eval.pipeline import (FLOW,
                                                assemble_keyframe_stream)
    from renderloom_torch.ops.flow import upsample_background

    interp, rollout, data_cfg = fn_parts
    L = (K - 1) * rate + 1
    times = {}

    def timed(name, f):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        out = f()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - tic) * 1e3
        return out

    with torch.inference_mode():
        pred, _, dconf = timed("motion", lambda: interp._run(
            motion, conf, rate, int(np.log2(rate)), bucket_length(L, rate)))
        backs = timed("flow", lambda: torch.stack([
            upsample_background(k, rate, **FLOW) for k in keys]))

        def prep():
            poses = torch.cat([pred[..., :L] * 256 + 256, dconf], dim=2)
            return prepare_batch(
                {"images": assemble_keyframe_stream(keys * 255.0, rate),
                 "dain": backs * 255.0,
                 "poses": poses.permute(0, 3, 1, 2).float()}, data_cfg,
                want_masks=False, **prep_kwargs)

        p = timed("prepare (raster)", prep)
        batch = {"label": p["label"], "back": p["back"], "key_img": p["image"]}
        timed("rollout", lambda: rollout(batch))
    return times, batch


def _profile(fn, args, stages=()) -> str:
    """One profiled run: device time by kernel, and the kernels' busy
    share of the run's wall time (CUPTI's own buffer activity left
    out).  With ``stages`` (span names the program marks, e.g.
    ``rlbench.stages.TRAIN``) the run's Chrome trace reduced through
    ``rlbench.stages.split`` follows those two lines: device busy and
    idle ms, launches, syncs and spans per stage and outside them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        tic = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - tic) * 1e3
    dev = lambda e: (getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0) or 0) / 1e3
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev(e) > 0
                   and not e.key.startswith(("Activity Buffer",
                                             "Buffer Flush"))),
                  key=dev, reverse=True)
    busy = sum(dev(e) for e in rows)
    # the device's busy time: the union of the kernels' intervals, over
    # the span from the first kernel's start to the last one's end
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.name.startswith(("Activity Buffer",
                                              "Buffer Flush")))
    union, reach = 0.0, float("-inf")
    for start, end in spans:
        if end > reach:
            union += end - max(start, reach)
            reach = end
    span = (reach - spans[0][0]) / 1e3 if spans else 0.0
    union /= 1e3
    lines = [f"profiled run: wall {wall:.2f} ms, kernels {busy:.2f} ms "
             f"({100 * busy / wall:.1f}% of wall), {len(rows)} kernels",
             f"device busy (union of kernel intervals) {union:.2f} ms of a "
             f"{span:.2f} ms span from first kernel to last: idle share "
             f"{100 * (1 - union / max(span, 1e-9)):.1f}%"]
    if stages:
        lines.append("stages: device ms busy, idle; launches, syncs, spans")
        for name, v in _stage_split(prof, wall / 1e3, stages).items():
            lines.append(f"  {name:>14} {v['busy_s'] * 1e3:9.2f} "
                         f"{v['idle_s'] * 1e3:9.2f} {v['launches']:7d} "
                         f"{v['syncs']:4d} {v['spans']:3d}")
    for e in rows[:25]:
        lines.append(f"  {dev(e):10.3f} ms  {e.count:6d}x  {e.key[:110]}")
    # which convolutions the device time goes to, by input shapes
    total = lambda e: (getattr(e, "device_time_total", None)
                       or getattr(e, "cuda_time_total", 0) or 0) / 1e3
    convs = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                    if e.key == "aten::cudnn_convolution"),
                   key=total, reverse=True)
    lines.append("convolutions by device time (input, weight shapes):")
    for e in convs[:20]:
        lines.append(f"  {total(e):10.3f} ms  {e.count:4d}x  "
                     f"{e.input_shapes[:2]}")
    return "\n".join(lines)


def _stage_split(prof, wall_s: float, stages) -> dict:
    """``prof``'s Chrome trace through ``rlbench.stages.split``."""
    import tempfile

    from rlbench.stages import split
    from rlbench.trace import reduce_trace

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    prof.export_chrome_trace(path)
    return split(reduce_trace(path, wall_s), stages)


def derived_fast_launches(cfg, packed_levels: int, bf16: bool = False
                          ) -> dict:
    """K2 (shifted), K2-parity and K2-r3centered launches of one
    parity-layout generator call (``GeneratorConfig`` ``cfg``), from the
    structure of ``models/fastpath.py``: in the mask net each encoder's
    in-conv and all downs but the last, and every up, are parity norms,
    the last downs and the residual blocks' norms standard; in the trunk
    the SPADE norms (two, and a third for a shortcut) of each block at a
    level below ``packed_levels`` are parity norms, the others standard.
    In float32 every standard norm is shifted.  In bf16 (``bf16``) a
    standard norm of a bf16 tensor is r3centered: the trunk's and the
    encoders' last downs; the last downs return float32, so the mask
    net's residual blocks convolve and normalize (shifted) in float32."""
    m = cfg.mask
    n_down = cfg.num_downsamples
    n_res = int(-(-(cfg.num_layers - n_down) // 2) * 2)
    f = lambda i: min(cfg.max_num_filters, cfg.num_filters * 2 ** i)
    mf = lambda i: min(m.max_num_filters, m.num_filters * 2 ** i)
    spade = lambda i_ch, o_ch: 2 + (i_ch != o_ch)
    parity = 3 * m.num_downsamples
    last_downs, res = 2, 0
    ch = 2 * mf(m.num_downsamples)
    for _ in range(m.num_res_blocks):
        res += 2 + (ch != mf(m.num_downsamples))
        ch = mf(m.num_downsamples)
    trunk = n_res * spade(f(n_down + 1), f(n_down + 1))
    for i in range(n_down + 1):
        n = spade(f(i), f(i + 1)) + spade(f(i + 1), f(i))
        if i < max(1, min(packed_levels, n_down)):
            parity += n
        else:
            trunk += n
    if bf16:
        return {"instance_norm": res, "instance_norm_parity": parity,
                "instance_norm_r3": last_downs + trunk}
    return {"instance_norm": last_downs + res + trunk,
            "instance_norm_parity": parity, "instance_norm_r3": 0}


def _lk_warps(clips: int) -> dict:
    """``csrc/shiftwarp.cu`` launches of ``clips`` LK clips at the serving
    pipeline's ``FLOW`` (float32 keyframes on the card): the quarter-
    resolution consistency warp and the fused warps and blend, once each
    a clip."""
    return {"shift_warp": clips, "shift_warp_blend": clips}


def _time_warps(rate: int) -> dict:
    """``csrc/shiftwarp.cu`` launches of the learned backgrounds of one
    clip at ``rate``: ``time_warp``'s four warps (w0, w1, c1, c0) in each
    of the log2(rate) doublings."""
    return {"shift_warp": 4 * int(np.log2(rate)), "shift_warp_blend": 0}


def _warp_launches() -> dict:
    from renderloom_torch.ops import shiftwarp_kernel as SK

    return {"shift_warp": SK.shift_warp_cuda.launches,
            "shift_warp_blend": SK.shift_warp_blend_cuda.launches}


def _serve_launches() -> dict:
    """Launch counts of a serving run, K1 by layout, K2 by kind, the
    fused up convolution and the shift warps."""
    from renderloom_torch.ops import norm_kernel as NK
    from renderloom_torch.ops import rasterize_kernel as RK
    from renderloom_torch.ops import upconv_kernel as UK

    by = RK.rasterize_tables_cuda.layout_launches
    return {"rasterize": by["nhwc"], "rasterize_packed": by["packed"],
            "instance_norm": NK.instance_norm_cuda.launches,
            "instance_norm_parity": NK.instance_norm_cuda.parity_launches,
            "instance_norm_r3": NK.instance_norm_cuda.r3_launches,
            "upconv": UK.upconv_cuda.launches, **_warp_launches()}


def _sum_shapes(kernel, per, shapes, inputs, check, times,
                lib_name="F.instance_norm") -> dict:
    """Hold a norm kernel against its twin at each (key, calls) of
    ``shapes`` and sum call, device, twin, library and bound ms over the
    calls.  ``inputs(i, key)`` gives the call's arguments, ``check`` the
    max |err| and ``times`` :func:`_norm_times`'s tuple; the first key is
    the largest call."""
    tot = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0,
               bound_ms=0.0)
    err, bound_by, largest = 0.0, Counter(), None
    for i, (key, n) in enumerate(shapes):
        args = inputs(i, key)
        print(f"   {n:3d}x {key}:")
        err = max(err, check(*args))
        ms, dev, plain, lib, bnd, by = times(*args)
        print(_times_line(ms, dev, plain, lib, bnd, by, lib_name))
        if largest is None:
            largest = dict(shape=str(key), ms=ms, device_ms=dev,
                           plain_ms=plain, library_ms=lib, bound_ms=bnd,
                           bound_by=by, calls=n)
        bound_by[by] += n * bnd
        for k, v in zip(tot, (ms, dev, plain, lib, bnd)):
            tot[k] += n * v
    print(f"  {kernel} per {per}: call {tot['ms']:.3f} ms, device "
          f"{tot['device_ms']:.3f} ms ({100 * tot['bound_ms'] / tot['device_ms']:.1f}"
          f"% of bound), twin {tot['plain_ms']:.3f} ms, {lib_name} "
          f"{tot['library_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms")
    # bound_by: what bounds the shapes that carry most of the summed bound
    return dict(max_abs_err=err, bound_by=bound_by.most_common(1)[0][0],
                **tot, largest=largest)


def phase_pipeline():
    from renderloom_torch.core.config import (load_motion_config,
                                              load_renderer_config)
    from renderloom_torch.eval.motion_infer import MotionInterpolator
    from renderloom_torch.eval.pipeline import build_pipeline
    from renderloom_torch.train.gan import make_segment_rollout

    mcfg = load_motion_config(os.path.join(ROOT, "configs", "motion.yaml"))
    rcfg = load_renderer_config(os.path.join(ROOT, "configs", "hsm.yaml"))
    H, W = rcfg.data.model_height, rcfg.data.model_width
    rate, K = 4, 8
    L = (K - 1) * rate + 1
    print(f"pipeline: {W}x{H}, rate {rate}, {K} keyframes, 1 clip "
          f"(L = {L}), hsm.yaml + motion.yaml widths, random weights")
    tic = time.perf_counter()
    fn, m_model, gen = build_pipeline(mcfg, rcfg, rate, K, device="cuda")
    print(f"  built models in {time.perf_counter() - tic:.1f} s")
    motion, conf, keys = _bench_inputs(K, H, W, "cuda")

    # warm-up, recording the input of every instance norm of the run
    seen, raster_calls = Counter(), []
    restore_norms = _norm_kind_recorder(seen)
    restore = _raster_recorder(raster_calls)
    try:
        fn(motion, conf, keys)
        torch.cuda.synchronize()
    finally:
        restore()
        restore_norms()

    # the counted run
    _reset_launches()
    torch.cuda.synchronize()
    fused, sync = fn(motion, conf, keys)
    torch.cuda.synchronize()
    launches = _serve_launches()
    want_norms = _count_norms(gen) * (rate - 1)
    want_up = _count_upconvs(gen) * (rate - 1)
    print(f"  launches in one run: {launches} (K2 expected {want_norms} = "
          f"{_count_norms(gen)} per generator step x {rate - 1} steps, "
          f"upconv {want_up} = {_count_upconvs(gen)} x {rate - 1}, "
          f"shift warps {_lk_warps(1)})")
    if launches != {"rasterize": 1, "rasterize_packed": 0,
                    "instance_norm": want_norms, "instance_norm_parity": 0,
                    "instance_norm_r3": 0, "upconv": want_up,
                    **_lk_warps(1)}:
        raise AssertionError(f"kernel launches {launches}")
    if sum(seen.values()) != want_norms:
        raise AssertionError(f"recorded {sum(seen.values())} norms")

    if tuple(fused.shape) != (1, L, H, W, 3):
        raise AssertionError(f"fused shape {tuple(fused.shape)}")
    if not bool(torch.isfinite(fused).all()):
        raise AssertionError("non-finite output")
    key_unit = (keys * 255.0).float() / 127.5 - 1.0
    if not torch.equal(fused[:, ::rate], key_unit):
        raise AssertionError("keyframes did not pass through exactly")
    print(f"  output {tuple(fused.shape)} finite, keyframes exact, "
          f"checksum {float(sync):.6e}, range [{fused.min().item():.3f}, "
          f"{fused.max().item():.3f}]")

    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        fn(motion, conf, keys)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - tic)
    fps = len(runs) * L / sum(runs)
    print(f"  e2e_interp_frames_per_sec {fps:.3f} (runs of "
          + ", ".join(f"{r * 1e3:.1f}" for r in runs) + " ms per clip; "
          f"SM clock, power, temperature right after: {card_state()})")

    interp = MotionInterpolator(m_model, np.zeros((19, 2), np.float32),
                                np.ones((19, 2), np.float32), "cuda")
    stages, clip = _stage_times((interp, make_segment_rollout(gen, rate),
                                 rcfg.data), motion, conf, keys, rate, K)
    print("  stages (ms, synchronised): " + ", ".join(
        f"{k} {v:.2f}" for k, v in stages.items()))
    serve = dict(mcfg=mcfg, rcfg=rcfg, rate=rate, K=K, gen=gen,
                 interp=interp, fn=fn, inputs=(motion, conf, keys),
                 fps=fps, stages=stages, raster_calls=raster_calls,
                 fused=fused, clip=clip)
    prof = _profile(fn, (motion, conf, keys))
    _write("profile.txt", prof)
    serve["prof"] = prof
    print("  " + "\n  ".join(prof.splitlines()))

    # K2 at every shape the run gave it: hold against the twin, and sum
    # call, device, twin, library and bound times over the run's launches
    print(f"  K2 at the run's {len(seen)} distinct shapes:")
    norm_entry = _sum_shapes(
        "K2", "clip", sorted(seen.items(), key=lambda kv: -np.prod(kv[0][0])),
        lambda i, key: _norm_inputs(*key[:3], seed=100 + i) + (key[3],),
        lambda x, s, b, slope: _norm_check("vs twin", x, s, b, slope),
        lambda x, s, b, slope: _norm_times(x, s, b, slope, iters=10))
    norm_entry["shape"] = (f"{want_norms} launches over {len(seen)} shapes, "
                           f"B=7, C 16-512, summed per clip")
    return launches, fps, norm_entry, serve


# ---------------------------------------------------------------------------
# F. the fastpath pipeline at full width
# ---------------------------------------------------------------------------


def _dev_ms(e) -> float:
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0) or 0) / 1e3


def _conv_kernels(x_nhwc_shape, weight: torch.Tensor,
                  benchmark: bool = False, stride: int = 1, padding=None,
                  groups: int = 1, nhwc: bool = True):
    """(kernel names with device ms of one profiled call, CUDA-event ms of
    one call) of the NHWC conv the port runs: ``F.conv2d`` on the NCHW
    view of an NHWC tensor in the weight's dtype, symmetric padding
    (``padding``, default ``(k − 1) // 2``; ``nhwc=False``: a contiguous
    NCHW tensor of the same sizes).  ``benchmark``: with
    ``torch.backends.cudnn.benchmark`` on for this call only (the port
    leaves it off)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    weight = weight.detach()
    x = torch.randn(x_nhwc_shape, device="cuda",
                    dtype=weight.dtype).permute(0, 3, 1, 2)
    if not nhwc:
        x = x.contiguous()
    pad = (weight.shape[-1] - 1) // 2 if padding is None else padding
    f = lambda: F.conv2d(x, weight, None, stride, pad, 1, groups)
    before = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = benchmark
    try:
        ms = cuda_ms(f, iters=5, warmup=2)
        torch.cuda.synchronize()
        # CPU activity too, as _profile: with CUDA alone some runs lost
        # the convolution's own kernel record; three calls, as the
        # records of a single short call were lost too
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                f()
            torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.benchmark = before
    names = [f"{e.key[:90]} {_dev_ms(e) / max(e.count, 1) * 3:.3f} ms"
             for e in sorted(prof.key_averages(), key=_dev_ms, reverse=True)
             if e.device_type == DeviceType.CUDA
             and not e.key.startswith(("Activity Buffer", "Buffer Flush"))]
    return names[:3], ms


def _conv_report(gen, fast_gen, B, H, W) -> list:
    """The cuDNN kernels of the mask net's up-path convolutions on both
    sides, and the trunk's 3×3 convolutions at the packed levels against
    their s2d forms (per call, CUDA events)."""
    from renderloom_torch.models.fastpath import w_s1_s2d

    lines = ["mask net up path, standard (upsample then 3x3) vs fastpath "
             "(3x3 at low resolution, 4x output channels, depth_to_space):"]
    mask_w = fast_gen.weights()["mask"]
    for i in reversed(range(gen.mask_net.num_downsamples)):
        w_std = gen.mask_net.get_submodule(f"up{i}").conv.conv.weight
        w_fast = mask_w[f"up{i}"]["k"]
        for side, shape, w in (
                ("standard", (B, H >> i, W >> i, w_std.shape[1]), w_std),
                ("fastpath", (B, H >> (i + 1), W >> (i + 1), w_fast.shape[1]),
                 w_fast)):
            for bench in (False, True):
                names, ms = _conv_kernels(shape, w, benchmark=bench)
                lines.append(f"  up{i} {side} {shape} -> {w.shape[0]}"
                             f"{' cudnn.benchmark' if bench else ''}: "
                             f"{ms:.3f} ms; kernels: " + "; ".join(names))
    lines.append("trunk 3x3 convolutions at the packed levels, standard vs "
                 "s2d (4x channels, 4/9-dense kernel), ms per call (and the "
                 "s2d one with cudnn.benchmark for this call):")
    tot = [0.0, 0.0, 0.0]
    convs = [("down_first", gen.down_first.weight, 0)]
    for i in range(fast_gen.packed_levels):
        for blk in (f"down_{i}", f"up_{i}"):
            b = gen.get_submodule(blk)
            convs += [(f"{blk}.conv0", b.conv0.conv.weight, i),
                      (f"{blk}.conv1", b.conv1.conv.weight, i)]
    convs.append(("conv_img", gen.conv_img.conv.weight, 0))
    for name, w, lvl in convs:
        ws = w_s1_s2d(w.detach())
        _, ms_std = _conv_kernels((B, H >> lvl, W >> lvl, w.shape[1]), w)
        shape = (B, H >> (lvl + 1), W >> (lvl + 1), ws.shape[1])
        names, ms_s2d = _conv_kernels(shape, ws)
        _, ms_bench = _conv_kernels(shape, ws, benchmark=True)
        for k, v in enumerate((ms_std, ms_s2d, ms_bench)):
            tot[k] += v
        lines.append(f"  {name} level {lvl} {w.shape[1]}->{w.shape[0]}: "
                     f"standard {ms_std:.3f}, s2d {ms_s2d:.3f} (benchmark "
                     f"{ms_bench:.3f}); s2d kernel "
                     f"{names[0] if names else '(no kernel record)'}")
    lines.append(f"  sum over one generator step: standard {tot[0]:.3f} ms, "
                 f"s2d {tot[1]:.3f} ms (benchmark {tot[2]:.3f})")
    return lines


def _generator_parts(gen, fast_gen, cfg, B, H, W) -> list:
    """Device time of one generator step's parts at the rollout batch, in
    both layouts."""
    from renderloom_torch.models import fastpath as PF

    g = torch.Generator(device="cuda").manual_seed(3)
    r = lambda *shape: torch.rand(shape, device="cuda", generator=g) * 2 - 1
    label, warped, prev = r(B, H, W, 22), r(B, H, W, 3), r(B, H, W, 3)
    packed = PF.space_to_depth(label)
    x = torch.cat([warped, prev], dim=-1)
    imgs = torch.cat([prev, warped, r(B, H, W, 3)], dim=-1)
    tp, n_e = fast_gen.weights(), cfg.embed.num_downsamples
    cond, cond_p = PF.embed_apply_fast(tp["embed"], x, n_e)
    with torch.inference_mode():
        cond_std = gen.ref_embed(x)
        std = {"embedder": cuda_ms(lambda: gen.ref_embed(x), 5, 1),
               "trunk": cuda_ms(lambda: gen.trunk(label, cond_std), 5, 1),
               "mask net": cuda_ms(lambda: gen.mask_net(label, imgs), 5, 1),
               "step": cuda_ms(lambda: gen(label, label, warped, prev), 5, 1)}
        fast = {"embedder": cuda_ms(lambda: PF.embed_apply_fast(
                    tp["embed"], x, n_e), 5, 1),
                "trunk": cuda_ms(lambda: PF.trunk_apply_fast(
                    tp["trunk"], packed, cond, cond_p, cfg,
                    fast_gen.packed_levels), 5, 1),
                "mask net": cuda_ms(lambda: PF.mask_apply_fast(
                    tp["mask"], packed, imgs, cfg.mask.num_downsamples,
                    cfg.mask.num_res_blocks), 5, 1),
                "step": cuda_ms(lambda: fast_gen(packed, packed, warped,
                                                 prev), 5, 1)}
    return [f"generator step parts at B={B} (ms, CUDA events):"] + [
        f"  {side}: " + ", ".join(f"{k} {v:.3f}" for k, v in d.items())
        for side, d in (("standard", std), ("fastpath", fast))]


def phase_fastpath(serve):
    from renderloom_torch.eval.motion_infer import MotionInterpolator
    from renderloom_torch.eval.pipeline import build_pipeline
    from renderloom_torch.models import fastpath as PF
    from renderloom_torch.train.gan import make_segment_rollout

    mcfg, rcfg, rate, K = (serve[k] for k in ("mcfg", "rcfg", "rate", "K"))
    H, W = rcfg.data.model_height, rcfg.data.model_width
    L = (K - 1) * rate + 1
    motion, conf, keys = serve["inputs"]
    print(f"F. fastpath pipeline (build_pipeline(..., fastpath=True): "
          f"parity-layout generator, packed bf16 label): {W}x{H}, rate "
          f"{rate}, {K} keyframes, the weights of phase 4")
    tic = time.perf_counter()
    fn, m_model, gen = build_pipeline(mcfg, rcfg, rate, K, device="cuda",
                                      fastpath=True)
    if not isinstance(gen, PF.FastInferenceGen):
        raise AssertionError(f"fastpath built a {type(gen).__name__}")
    print(f"  built models and transformed weights in "
          f"{time.perf_counter() - tic:.1f} s")

    seen, raster_calls = Counter(), []
    restore = _norm_kind_recorder(seen)
    restore_raster = _raster_recorder(raster_calls)
    try:
        fn(motion, conf, keys)
        torch.cuda.synchronize()
    finally:
        restore()
        restore_raster()

    _reset_launches()
    torch.cuda.synchronize()
    fused, sync = fn(motion, conf, keys)
    torch.cuda.synchronize()
    launches = _serve_launches()
    per = derived_fast_launches(rcfg.gen, gen.packed_levels)
    want = {"rasterize": 0, "rasterize_packed": 1, "upconv": 0,
            **_lk_warps(1), **{k: v * (rate - 1) for k, v in per.items()}}
    print(f"  launches in one run: {launches}; derived {want} ({per} per "
          f"generator step x {rate - 1} steps)")
    if launches != want:
        raise AssertionError(f"fastpath kernel launches {launches}")
    recorded = _by_kind(seen)
    if any(recorded[k] != want[k] for k in per):
        raise AssertionError(f"recorded norm calls {dict(recorded)}")
    if tuple(fused.shape) != (1, L, H, W, 3):
        raise AssertionError(f"fused shape {tuple(fused.shape)}")
    if not bool(torch.isfinite(fused).all()):
        raise AssertionError("non-finite output")
    key_unit = (keys * 255.0).float() / 127.5 - 1.0
    if not torch.equal(fused[:, ::rate], key_unit):
        raise AssertionError("keyframes did not pass through exactly")
    print(f"  output {tuple(fused.shape)} finite, keyframes exact, "
          f"checksum {float(sync):.6e}")

    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        fn(motion, conf, keys)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - tic)
    fps = len(runs) * L / sum(runs)
    print(f"  fastpath e2e_interp_frames_per_sec {fps:.3f} (runs of "
          + ", ".join(f"{r * 1e3:.1f}" for r in runs) + " ms per clip; "
          f"standard path {serve['fps']:.3f} in phase 4; SM clock, power, "
          f"temperature right after: {card_state()})")
    interp = MotionInterpolator(m_model, np.zeros((19, 2), np.float32),
                                np.ones((19, 2), np.float32), "cuda")
    stages, _ = _stage_times((interp, make_segment_rollout(gen, rate),
                              rcfg.data), motion, conf, keys, rate, K,
                             label_dtype=torch.bfloat16, packed_label=True)
    print("  stages (ms, synchronised): " + ", ".join(
        f"{k} {v:.2f}" for k, v in stages.items()) + "; standard path: "
        + ", ".join(f"{k} {v:.2f}" for k, v in serve["stages"].items()))
    prof = _profile(fn, (motion, conf, keys))
    extra = (_conv_report(serve["gen"], gen, K - 1, H, W)
             + _generator_parts(serve["gen"], gen, rcfg.gen, K - 1, H, W))
    _write("profile_fastpath.txt", prof + "\n" + "\n".join(extra) + "\n")
    print("  " + "\n  ".join(prof.splitlines()[:16]))
    print("  " + "\n  ".join(extra))
    return dict(launches=launches, fps=fps, stages=stages, seen=seen,
                gen=gen, raster_calls=raster_calls, fused=fused, prof=prof,
                fn=fn)


# ---------------------------------------------------------------------------
# N. K2 parity
# ---------------------------------------------------------------------------


def _parity_library(x, s, b, slope):
    """The library composition for the parity norm: depth_to_space →
    ``F.instance_norm`` (the first C of the tiled affine) → leaky →
    space_to_depth."""
    from renderloom_torch.models.fastpath import depth_to_space, space_to_depth

    C = x.shape[-1] // 4
    y = F.instance_norm(depth_to_space(x).permute(0, 3, 1, 2),
                        weight=None if s is None else s[:C],
                        bias=None if b is None else b[:C], eps=1e-5)
    if slope is not None:
        y = F.leaky_relu(y, slope)
    return space_to_depth(y.permute(0, 2, 3, 1))


def _parity_check(name, x, s, b, slope):
    from renderloom_torch.ops import norm_kernel as NK

    atol, rtol = _k2_tol(tuple(x.shape), x.dtype)
    return compare(name, NK.instance_norm_cuda(x, s, b, slope, parity=True),
                   NK.instance_norm_plain(x, s, b, slope, parity=True),
                   atol, rtol)


def _parity_times(x, s, b, slope, iters=10):
    """(call, device, twin, library composition, bound) ms of one call,
    and what bounds it; raises unless the call is one kernel."""
    from renderloom_torch.ops import norm_kernel as NK

    n = x.numel()
    f = lambda: NK.instance_norm_cuda(x, s, b, slope, parity=True)
    ms, dev = cuda_ms(f, iters), device_ms(f)
    one_kernel(f"K2 parity {tuple(x.shape)}", f, "norm_fwd_kernel")
    plain = cuda_ms(lambda: NK.instance_norm_plain(x, s, b, slope,
                                                   parity=True),
                    max(2, iters // 4), 1)
    lib = cuda_ms(lambda: _parity_library(x, s, b, slope), iters)
    # x read once, the output written once; ~10 fp32 operations per
    # element, as the standard norm
    bnd, by = bound_ms(2 * n * x.element_size(), 10 * n)
    return ms, dev, plain, lib, bnd, by


def phase_norm_parity(fast):
    from renderloom_torch.models.fastpath import depth_to_space, space_to_depth
    from renderloom_torch.ops import norm_kernel as NK

    shapes = sorted(((k, n) for k, n in fast["seen"].items()
                     if k[4] == "parity"),
                    key=lambda kv: -np.prod(kv[0][0]))
    print(f"N. K2 parity, kernel vs plain twin, at the fastpath run's "
          f"{len(shapes)} parity shapes:")
    entry = _sum_shapes(
        "K2 parity", "clip", shapes,
        lambda i, key: _norm_inputs(*key[:3], seed=500 + i) + (key[3],),
        lambda x, s, b, slope: _parity_check("vs twin", x, s, b, slope),
        _parity_times, "library composition")
    x, s, b = _norm_inputs((7, 160, 240, 128), torch.bfloat16, True, 590)
    _parity_check("(7, 160, 240, 128) bfloat16 affine=True leaky=True", x, s,
                  b, LEAKY)
    # the shifted fp32 contract: mean 4096, std 1e-2 keeps its variance
    x, _, _ = _norm_inputs((7, 80, 120, 256), torch.float32, False, 591,
                           loc=4096.0, scale=1e-2)
    _parity_check("(7, 80, 120, 256) float32 mean 4096 std 1e-2", x, None,
                  None, None)
    x64 = depth_to_space(x).double()
    ref = space_to_depth((x64 - x64.mean((1, 2), keepdim=True)) / torch.sqrt(
        x64.var((1, 2), unbiased=False, keepdim=True) + 1e-5))
    compare("  the same against the float64 full-resolution norm",
            NK.instance_norm_cuda(x, parity=True).double(), ref, 2e-3)
    # the library composition computes the same function for a tiled affine
    x, s, b = _norm_inputs((7, 160, 240, 128), torch.float32, True, 592)
    s, b = s[:32].repeat(4), b[:32].repeat(4)
    compare("  library composition vs kernel (tiled affine)",
            _parity_library(x, s, b, LEAKY),
            NK.instance_norm_cuda(x, s, b, LEAKY, parity=True), 1e-4, 1e-4)
    # two calls at the largest shape give the same bits
    x, s, b = _norm_inputs((7, 160, 240, 128), torch.float32, True, 593)
    if not torch.equal(NK.instance_norm_cuda(x, s, b, LEAKY, parity=True),
                       NK.instance_norm_cuda(x, s, b, LEAKY, parity=True)):
        raise AssertionError("K2 parity: two calls differ")
    print("  determinism: two calls at (7, 160, 240, 128) equal bit for bit "
          "ok")
    # the parity norm keeps a whole batch element per slab: this one
    # exceeds the grid's shared memory
    x, s, b = _norm_inputs((1, 540, 960, 128), torch.float32, True, 594)
    plan = _plan_of(x, 1, parity=True)
    if not plan["streaming"]:
        raise AssertionError(f"(1, 540, 960, 128) does not stream: {plan}")
    _parity_check(f"streaming (1, 540, 960, 128) float32 affine=True "
                  f"leaky=True (plan {plan})", x, s, b, LEAKY)
    x, _, _ = _norm_inputs((1, 4, 4, 32), torch.float32, False, 595)
    print(f"  host time per call at (1, 4, 4, 32): "
          f"{host_us(lambda: NK.instance_norm_cuda(x, parity=True)):.1f} us")
    n_calls = sum(n for _, n in shapes)
    return dict(**entry,
                library="depth_to_space -> F.instance_norm -> leaky -> "
                        "space_to_depth (a composition; no single call)",
                shape=f"{n_calls} launches over {len(shapes)} shapes, B=7, "
                      f"4C 64-512, summed per clip")


def phase_norm_parity_bf16(bf16):
    """K2 parity at every parity shape of the bf16 fastpath run: bf16
    (the Pallas contract's bf16 store) and, in the mask net's float32
    part, float32.  The plan follows the element size, so each is held
    against the twin and timed in its own right."""
    shapes = sorted(((k, n) for k, n in bf16["fastpath"]["seen"].items()
                     if k[4] == "parity"),
                    key=lambda kv: -np.prod(kv[0][0]))
    print(f"N2. K2 parity, kernel vs plain twin, at the bf16 fastpath "
          f"run's {len(shapes)} parity shapes:")
    entry = _sum_shapes(
        "K2 parity bf16", "bf16 fastpath clip", shapes,
        lambda i, key: _norm_inputs(*key[:3], seed=550 + i) + (key[3],),
        lambda x, s, b, slope: _parity_check("vs twin", x, s, b, slope),
        _parity_times, "library composition")
    n_calls = sum(n for _, n in shapes)
    n_bf16 = sum(n for k, n in shapes if k[1] == torch.bfloat16)
    return dict(**entry, shape=f"{n_calls} launches over {len(shapes)} "
                               f"shapes ({n_bf16} bf16, the rest float32 "
                               f"in the mask net), B=7, summed per bf16 "
                               f"fastpath clip")


# ---------------------------------------------------------------------------
# S. fastpath vs standard pipeline on the card
# ---------------------------------------------------------------------------

# The fastpath (f32 label) against the standard pipeline on the same
# weights at full width: the same function in float32.  Which side
# departs from it is read on the first generator step of both rollouts,
# on their own inputs (B = 7), against the standard generator in
# float64.  Measured on an NVIDIA H100 80GB HBM3 (700 W), max |err| of
# the fused frame: standard 3.12e-3, the same with cuDNN off (3.19e-3),
# fastpath 3.27e-4.  The standard side carries the error, and not through
# cuDNN: K2 shifts its moments by pixel (0, 0), which on the label's
# channels (the zero-padded corner of a near-constant map) lies up to 21
# (median 10) standard deviations from the mean, so m2 - m1^2 cancels up
# to 9 bits; the parity norm shifts by the mean of packed row 0, at most
# 7 away (PERF.md; printed below on each run).  Each side is
# held to float64 at about three times its reading, and the pipelines'
# gap (4.53e-3 after three steps, the same in every run) at about twice.
FAST_VS_STD_TOL = 1e-2
STEP_F64_TOL = {"standard": 1e-2, "fastpath": 1e-3}


def _first_call(module):
    """Record the positional inputs and the output of ``module``'s first
    call; returns (record, remove)."""
    rec = {}

    def hook(_, args, out):
        if not rec:
            rec["args"], rec["out"] = args, out
    return rec, module.register_forward_hook(hook).remove


def phase_fast_vs_standard(serve, fast):
    import copy

    from renderloom_torch.eval.pipeline import make_pipeline_fn
    from renderloom_torch.models.fastpath import depth_to_space, space_to_depth
    from renderloom_torch.models.renderer import composite
    from renderloom_torch.ops import norm_kernel as NK
    from renderloom_torch.train.gan import make_segment_rollout

    rcfg, rate, K = serve["rcfg"], serve["rate"], serve["K"]
    fn = make_pipeline_fn(serve["interp"],
                          make_segment_rollout(fast["gen"], rate), rcfg.data,
                          rate, K, packed_label=True, label_bf16=False)
    std_step, rm_std = _first_call(serve["gen"])
    fast_step, rm_fast = _first_call(fast["gen"])
    try:
        want, _ = serve["fn"](*serve["inputs"])
        got, _ = fn(*serve["inputs"])
    finally:
        rm_std()
        rm_fast()
    diff = (got - want).abs()
    print("S. card fastpath pipeline (packed f32 label) vs card standard "
          "pipeline, full width, same weights: mean |diff| "
          f"{diff.mean().item():.3e}, share above 1e-3 "
          f"{(diff > 1e-3).float().mean().item():.3e}, max per frame "
          + " ".join(f"{v:.1e}" for v in diff.amax((0, 2, 3, 4)).tolist()))
    compare("fused frames", got, want, FAST_VS_STD_TOL)

    # the first generator step of both rollouts (B = 7 segments, the
    # rollouts' own inputs and outputs) against the standard generator in
    # float64 on the CPU (twin norms); the standard generator once more
    # on the card with cuDNN off (PyTorch's own GEMM convolutions, TF32
    # off) tells whether cuDNN's algorithms carry the error
    args = std_step["args"]
    in_gap = max((a - b).abs().max().item() for a, b in zip(
        fast_step["args"], (space_to_depth(args[0]),
                            space_to_depth(args[1])) + tuple(args[2:])))
    outs = {"standard": std_step["out"], "fastpath": fast_step["out"]}
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=False):
        outs["standard, cuDNN off"] = serve["gen"](*args)
    ref_gen = copy.deepcopy(serve["gen"]).cpu().double()
    cpu64 = [a.cpu().double() for a in args]
    with torch.inference_mode():
        img, mask = ref_gen(*cpu64)
    ref = (img, mask, composite(img, mask, cpu64[2]))
    errs = {}
    for side, (img, mask) in outs.items():
        got3 = (img, mask, composite(img, mask, args[2]))
        errs[side] = [(o.cpu().double() - w).abs().max().item()
                      for o, w in zip(got3, ref)]
    print(f"  first generator step of both rollouts (B={args[0].shape[0]}, "
          f"inputs equal to {in_gap:.1e}) against the CPU float64 standard "
          "generator, max |err| of (img, mask, fused): " + ", ".join(
              f"{k} (" + ", ".join(f"{e:.2e}" for e in v) + ")"
              for k, v in errs.items()))
    # where the standard side departs: its first norm (down_0.spade0),
    # on down_first's output, a near-constant map of the sparse label
    with torch.inference_mode():
        x = serve["gen"].down_first(args[0])
        x64 = x.double()
        mean = x64.mean((1, 2))
        sd = x64.std((1, 2), unbiased=False)
        sigmas = lambda s: ((mean - s) / sd).abs()
        corner, rows = sigmas(x64[:, 0, 0]), sigmas(x64[:, :2].mean((1, 2)))
        ref = NK.instance_norm_plain(x64)
        e_std = (NK.instance_norm(x).double() - ref).abs().max().item()
        e_par = (depth_to_space(NK.instance_norm(space_to_depth(x),
                                                 parity=True)).double()
                 - ref).abs().max().item()
    print(f"  its first norm, on down_first's output {tuple(x.shape)}: the "
          f"shift pixel (0, 0) lies {corner.max().item():.1f} (median "
          f"{corner.median().item():.1f}) standard deviations from the "
          f"channel mean, the parity shift (the mean of rows 0-1) "
          f"{rows.max().item():.1f}; max |err| against float64 of K2 "
          f"{e_std:.2e}, of K2 parity {e_par:.2e} (max |ref| "
          f"{ref.abs().max().item():.1f})")
    for side, tol in STEP_F64_TOL.items():
        if max(errs[side]) > tol:
            raise AssertionError(f"{side} step error {max(errs[side])} "
                                 f"beyond {tol}")
    print("  each side's step within its float64 tolerance "
          + ", ".join(f"{k} {v:g}" for k, v in STEP_F64_TOL.items()) + " ok")


# ---------------------------------------------------------------------------
# H. bf16 serving at full width
# ---------------------------------------------------------------------------


def _bf16(cfg):
    import dataclasses

    return dataclasses.replace(cfg, compute_dtype="bfloat16")


# the FFT-algorithm shape of PERF.md section 5: the standard mask net's
# up2 at B = 7, (7, 256, 80, 120) -> 128, 3x3
FFT_SHAPE = (7, 80, 120, 256)


def fft_conv_report() -> list:
    """The cuDNN kernels and time of the FFT_SHAPE convolution in float32
    (TF32 off, as the port runs it) and in bf16, with and without
    ``cudnn.benchmark``.  Run before any large profile: after one,
    ``torch.profiler`` drops the records of short kernels."""
    from renderloom_torch.train.gan import set_float32_precision

    set_float32_precision()
    g = torch.Generator(device="cuda").manual_seed(7)
    w = torch.randn((128, 256, 3, 3), device="cuda", generator=g) / 48.0
    lines = [f"the convolution {FFT_SHAPE} -> 128, 3x3 (the standard mask "
             f"net's up2 at B=7), ms per call and its kernels:"]
    for dtype in (torch.float32, torch.bfloat16):
        for bench in (False, True):
            names, ms = _conv_kernels(FFT_SHAPE, w.to(dtype),
                                      benchmark=bench)
            lines.append(f"  {str(dtype)[6:]}"
                         f"{' cudnn.benchmark' if bench else ''}: "
                         f"{ms:.3f} ms; " + ("; ".join(names)
                                            or "(no kernel record)"))
    return lines


def _child_outputs(gen, args) -> dict:
    """``gen(*args)`` with the output of each direct child module that
    returns a tensor (its last call), in call order."""
    outs, removes = {}, []
    for name, child in gen.named_children():
        def hook(_, __, out, name=name):
            if isinstance(out, torch.Tensor):
                outs.pop(name, None)
                outs[name] = out.float()
        removes.append(child.register_forward_hook(hook).remove)
    try:
        with torch.inference_mode():
            img, mask = gen(*args)
    finally:
        for r in removes:
            r()
    return dict(outs, img=img.float(), mask=mask.float())


def _bf16_witness(serve, gen16):
    """Whether the full-width |bf16 - f32| is the function's own: the
    first generator step of phase 4's rollout (B = 7, its own inputs) in
    bf16, and in float32 on inputs and convolution weights rounded to
    bf16 (the data the bf16 model starts from, every later rounding
    left out), each against the float32 step; the relative RMS gap of
    each of the generator's parts on the way; then the whole clip with
    only the motion transformer, or only the renderer, in bf16."""
    import copy

    from renderloom_torch.models.layers import Conv

    step, rm = _first_call(serve["gen"])
    try:
        serve["fn"](*serve["inputs"])
    finally:
        rm()
    args = step["args"]
    rounded = copy.deepcopy(serve["gen"])
    with torch.no_grad():
        for m in rounded.modules():
            if isinstance(m, Conv):
                for p in (m.weight, m.bias):
                    if p is not None:
                        p.copy_(p.bfloat16().float())
    ref = _child_outputs(serve["gen"], args)
    runs = {"bf16": _child_outputs(gen16, args),
            "f32 on bf16-rounded inputs and weights": _child_outputs(
                rounded, [a.bfloat16().float() for a in args])}
    print(f"  witness, the first generator step (B={args[0].shape[0]}) "
          f"against float32, on the float32 clip's inputs:")
    for name, outs in runs.items():
        d = (outs["img"] - ref["img"]).abs()
        flips = ((outs["img"] * ref["img"] < 0)
                 & (ref["img"].abs() > 0.5)).float().mean().item()
        gaps = ", ".join(
            f"{k} {((v - ref[k]).norm() / ref[k].norm()).item():.1e}"
            for k, v in outs.items())
        print(f"    {name}: img max |diff| {d.max().item():.4e}, mean "
              f"{d.mean().item():.4e}, sign flips beyond |0.5| "
              f"{100 * flips:.4f}% of elements; relative RMS gap by part: "
              f"{gaps}")
    # the whole clip with one stage in bf16: the motion transformer's
    # joints decide where the raster draws each limb
    from renderloom_torch.eval.pipeline import build_pipeline

    mcfg, rcfg = serve["mcfg"], serve["rcfg"]
    for name, m, r in (("bf16 motion, float32 renderer", _bf16(mcfg), rcfg),
                       ("float32 motion, bf16 renderer", mcfg,
                        _bf16(rcfg))):
        fn, _, _ = build_pipeline(m, r, serve["rate"], serve["K"],
                                  device="cuda")
        d = (fn(*serve["inputs"])[0] - serve["fused"]).abs()
        print(f"    the clip with {name}: fused frames max |diff| from "
              f"float32 {d.max().item():.4e}, mean {d.mean().item():.4e}")


def phase_bf16(serve, fast, conv_lines):
    """Both serving configurations with bf16 compute (the configs'
    ``compute_dtype``) on phase 4's weights and inputs, each beside its
    float32 numbers from phases 4 and F."""
    from renderloom_torch.eval.motion_infer import MotionInterpolator
    from renderloom_torch.eval.pipeline import build_pipeline
    from renderloom_torch.models import fastpath as PF
    from renderloom_torch.train.gan import make_segment_rollout

    mcfg, rcfg = _bf16(serve["mcfg"]), _bf16(serve["rcfg"])
    rate, K = serve["rate"], serve["K"]
    H, W = rcfg.data.model_height, rcfg.data.model_width
    L = (K - 1) * rate + 1
    motion, conf, keys = serve["inputs"]
    print(f"H. bf16 serving (motion.yaml and hsm.yaml with compute_dtype "
          f"bfloat16): {W}x{H}, rate {rate}, {K} keyframes, the weights "
          f"of phase 4")
    out = {}
    for name, fastpath, f32 in (("standard", False, serve),
                                ("fastpath", True, fast)):
        fn, m_model, gen = build_pipeline(mcfg, rcfg, rate, K,
                                          device="cuda", fastpath=fastpath)
        if isinstance(gen, PF.FastInferenceGen) != fastpath or \
                gen.dtype != torch.bfloat16:
            raise AssertionError(f"{name}: built {type(gen).__name__} "
                                 f"in {gen.dtype}")
        seen = Counter()
        restore = _norm_kind_recorder(seen)
        try:
            fn(motion, conf, keys)
            torch.cuda.synchronize()
        finally:
            restore()

        # the counted run
        _reset_launches()
        torch.cuda.synchronize()
        fused, sync = fn(motion, conf, keys)
        torch.cuda.synchronize()
        launches = _serve_launches()
        if fastpath:
            per = derived_fast_launches(rcfg.gen, gen.packed_levels,
                                        bf16=True)
        else:
            per = {"instance_norm": 0, "instance_norm_parity": 0,
                   "instance_norm_r3": _count_norms(gen)}
        want = {"rasterize": 0 if fastpath else 1,
                "rasterize_packed": 1 if fastpath else 0, "upconv": 0,
                **_lk_warps(1),
                **{k: v * (rate - 1) for k, v in per.items()}}
        print(f"  {name}: launches in one run {launches}; derived {want} "
              f"({per} per generator step x {rate - 1} steps)")
        if launches != want:
            raise AssertionError(f"bf16 {name} kernel launches {launches}")
        kinds = _by_kind(seen)
        if any(kinds[k] != want[k] for k in per):
            raise AssertionError(f"recorded norm calls {dict(kinds)}")
        if tuple(fused.shape) != (1, L, H, W, 3) or fused.dtype != \
                torch.float32:
            raise AssertionError(f"fused {tuple(fused.shape)} {fused.dtype}")
        if not bool(torch.isfinite(fused).all()):
            raise AssertionError("non-finite output")
        key_unit = (keys * 255.0).float() / 127.5 - 1.0
        if not torch.equal(fused[:, ::rate], key_unit):
            raise AssertionError("keyframes did not pass through exactly")
        gap = (fused - f32["fused"]).abs()
        print(f"    output {tuple(fused.shape)} finite, keyframes exact, "
              f"checksum {float(sync):.6e}; largest |bf16 - f32| of the "
              f"fused frames {gap.max().item():.4e} (mean "
              f"{gap.mean().item():.4e}; reported, not held)")

        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            fn(motion, conf, keys)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - tic)
        fps = len(runs) * L / sum(runs)
        print(f"    bf16 {name} e2e_interp_frames_per_sec {fps:.3f} (runs "
              "of " + ", ".join(f"{r * 1e3:.1f}" for r in runs)
              + f" ms per clip); float32 {f32['fps']:.3f} in this run; SM "
              f"clock, power, temperature right after: {card_state()}")
        interp = MotionInterpolator(m_model, np.zeros((19, 2), np.float32),
                                    np.ones((19, 2), np.float32), "cuda")
        prep = (dict(label_dtype=torch.bfloat16, packed_label=True)
                if fastpath else {})
        stages, _ = _stage_times((interp, make_segment_rollout(gen, rate),
                                  rcfg.data), motion, conf, keys, rate, K,
                                 **prep)
        print("    stages (ms, synchronised), bf16: " + ", ".join(
            f"{k} {v:.2f}" for k, v in stages.items()) + "; float32: "
            + ", ".join(f"{k} {v:.2f}" for k, v in f32["stages"].items()))
        prof = _profile(fn, (motion, conf, keys))
        _write(f"profile_bf16_{name}.txt", prof)
        idle = [ln for ln in prof.splitlines() if "idle share" in ln][0]
        idle32 = [ln for ln in f32["prof"].splitlines()
                  if "idle share" in ln][0]
        print(f"    bf16 {idle.split(': ')[-1]} idle (float32 "
              f"{idle32.split(': ')[-1]}); " + prof.splitlines()[0])
        print("    " + "\n    ".join(prof.splitlines()[2:10]))
        out[name] = dict(launches=launches, fps=fps, stages=stages,
                         seen=seen, fused=fused, gen=gen, fn=fn,
                         m_model=m_model)

    _bf16_witness(serve, out["standard"]["gen"])

    # which cuDNN algorithm the float32 FFT shape gets in bf16 (taken
    # after phase 1, before the first large profile)
    if tuple(serve["gen"].mask_net.up2.conv.conv.weight.shape) != \
            (128, 256, 3, 3):
        raise AssertionError("the mask net's up2 is not the FFT shape")
    print("  " + "\n  ".join(conv_lines))
    return out


# ---------------------------------------------------------------------------
# UC. the fused nearest x2 upsample and 3x3 float32 convolution
# ---------------------------------------------------------------------------

# (name, (B, h, w, Cin), Cout): the standard mask net's up2, up1 and up0 at
# the rollout's B = 7 (the input before its upsample), and a ragged shape
# (odd sides, Cin not a multiple of 4: the kernel's 4-byte copies; Cout
# no tile's width).  Tolerance against the twin: 1e-5 + 1e-5·|ref|, the
# two summing the same 4·Cin products (outputs of order 1) in other
# orders.
UPCONV_CASES = [("up2", (7, 40, 60, 256), 128),
                ("up1", (7, 80, 120, 128), 64),
                ("up0", (7, 160, 240, 64), 32),
                ("ragged", (3, 13, 21, 30), 45)]


def _upconv_inputs(shape, cout: int, seed: int):
    """x, a 3x3 weight at the random init's scale (1/√fan-in) and a bias,
    on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, device="cuda", generator=g)
    w = torch.randn((cout, shape[-1], 3, 3), device="cuda",
                    generator=g) / float(np.sqrt(9 * shape[-1]))
    b = torch.randn(cout, device="cuda", generator=g) / 10
    return x, w, b


def _upsample_conv(x, w, b):
    """The unfused path: ``upsample2x``, then ``F.conv2d`` on the NCHW view
    (cuDNN; TF32 off), NHWC out."""
    from renderloom_torch.models.layers import upsample2x

    return F.conv2d(upsample2x(x).permute(0, 3, 1, 2), w, b, 1,
                    1).permute(0, 2, 3, 1)


def upconv_ops(shape, cout: int):
    """fp32 operations of one call, 2 a multiply-add: the kernel's 4 taps
    an output at (B, 2h, 2w), and the unfused convolution's 9 (what
    ``mfu_pct`` counts)."""
    B, h, w, cin = shape
    return (2 * B * h * w * 4 * 4 * cin * cout,
            2 * B * 4 * h * w * 9 * cin * cout)


def _upconv_case(name, shape, cout, seed) -> dict:
    """Hold the kernel at one shape (twin, float64, bits, one launch) and
    time kernel, cuDNN's upsample-then-conv and twin, in turns."""
    from renderloom_torch.ops import upconv_kernel as UK

    x, w, b = _upconv_inputs(shape, cout, seed)
    wf = UK.fold_weights(w)
    kern = lambda: UK.upconv_cuda(x, wf, b, cout)
    lib = lambda: _upsample_conv(x, w, b)
    twin = lambda: UK.upconv_plain(x, wf, b, cout)
    got = kern()
    torch.cuda.synchronize()
    err = compare(f"{name} {shape} -> {cout} kernel vs twin", got, twin(),
                  1e-5, 1e-5)
    same_bits(f"{name} second call", kern(), got)
    one_kernel(f"upconv {name}", kern, "upconv_kernel")
    # against float64 upsample-then-conv, on the first clip: the
    # kernel's error no larger than cuDNN's float32 path's
    ref = _upsample_conv(x[:1].double(), w.double(), b.double())
    gap = lambda y: (y[:1].double() - ref).abs()
    k64, l64 = gap(got), gap(lib())
    print(f"  {name} against float64 upsample-then-conv: kernel max "
          f"{k64.max().item():.3e} mean {k64.mean().item():.3e}, cuDNN "
          f"float32 max {l64.max().item():.3e} mean "
          f"{l64.mean().item():.3e}")
    if k64.max().item() > l64.max().item():
        raise AssertionError(f"{name}: the kernel's float32 error exceeds "
                             "cuDNN's")
    del ref, k64, l64, got
    slow = 3 if name == "up2" else 10       # cuDNN's FFT: ~0.1 s a call
    ms = [cuda_ms(kern), cuda_ms(lib, iters=slow, warmup=1),
          cuda_ms(lib, iters=slow, warmup=1), cuda_ms(kern)]
    dev = device_ms(kern)
    ops4, ops9 = upconv_ops(shape, cout)
    B, h, w_, cin = shape
    n_bytes = 4 * (B * h * w_ * cin + 4 * B * h * w_ * cout + wf.numel())
    bnd4, by4 = bound_ms(n_bytes, ops4)
    bnd9, _ = bound_ms(n_bytes, ops9)
    row = dict(shape=f"({B},{h},{w_},{cin}) -> {cout}", max_abs_err=err,
               ms=min(ms[0], ms[3]), device_ms=dev, bound_ms=bnd4,
               bound_by=by4, bound_ms_9tap=bnd9, plain_ms=cuda_ms(twin, 3),
               library_ms=min(ms[1], ms[2]))
    print(f"  {name}: call {ms[0]:.4f} / {ms[3]:.4f} ms, device {dev:.4f} "
          f"ms ({100 * bnd4 / dev:.1f}% of the 4-tap bound {bnd4:.4f} ms, "
          f"{by4}; 9-tap {bnd9:.4f}); cuDNN upsample-then-conv "
          f"{ms[1]:.4f} / {ms[2]:.4f} ms; twin {row['plain_ms']:.4f} ms")
    return row


def _record_convs(fn, args) -> dict:
    """Every ``F.conv2d`` call of ``fn(*args)``: {(x NHWC sizes, NHWC or
    not, weight sizes, dtype, stride, padding, groups): [calls, weight]}."""
    seen = {}
    conv2d = F.conv2d

    def rec(x, weight, bias=None, stride=1, padding=0, dilation=1,
            groups=1):
        key = (tuple(x.permute(0, 2, 3, 1).shape),
               not x.is_contiguous(), tuple(weight.shape), weight.dtype,
               stride, padding, groups)
        seen.setdefault(key, [0, weight.detach()])[0] += 1
        return conv2d(x, weight, bias, stride, padding, dilation, groups)
    F.conv2d = rec
    try:
        fn(*args)
        torch.cuda.synchronize()
    finally:
        F.conv2d = conv2d
    return seen


def phase_upconv(serve) -> dict:
    """UC: the kernel against its twin and float64 at the mask net's up
    shapes and a ragged one, its bits, its times against cuDNN's
    upsample-then-conv, and every float32 convolution of one standard
    clip with cuDNN's kernels.  Its launches are counted and held
    against the module structure on every path, with K1's and K2's
    (``_serve_launches``, ``_train_launches``, ``_kernel_launches``)."""
    from renderloom_torch.train.gan import set_float32_precision

    set_float32_precision()
    print("UC. csrc/upconv.cu: nearest x2 upsample and 3x3 float32 "
          "convolution in one kernel, against its twin, float64 and "
          "cuDNN's upsample-then-conv (NVIDIA H100, CUDA events)")
    rows = {name: _upconv_case(name, shape, cout, 300 + i)
            for i, (name, shape, cout) in enumerate(UPCONV_CASES)}
    # the kernel no slower than cuDNN's upsample-then-conv at each up
    # shape; at up2 at most 0.8 ms a call, at least 33% of its bound
    for name in ("up2", "up1", "up0"):
        r = rows[name]
        print(f"  {name}: kernel {r['ms']:.4f} ms against cuDNN "
              f"{r['library_ms']:.4f}")
        if r["ms"] > r["library_ms"]:
            raise AssertionError(f"{name}: the kernel ({r['ms']:.4f} ms) "
                                 f"is slower than cuDNN "
                                 f"({r['library_ms']:.4f} ms)")
    r = rows["up2"]
    share = 100 * r["bound_ms"] / r["device_ms"]
    print(f"  up2: {r['ms']:.4f} ms a call (at most 0.8), {share:.1f}% of "
          f"the 4-tap bound (at least 33)")
    if r["ms"] > 0.8 or share < 33:
        raise AssertionError(f"up2: {r['ms']:.4f} ms, {share:.1f}% of the "
                             "bound")

    # every float32 convolution of one standard clip: cuDNN's kernels
    seen = _record_convs(serve["fn"], serve["inputs"])
    lines = [f"the {sum(v[0] for v in seen.values())} F.conv2d calls of one "
             f"float32 standard clip ({len(seen)} kinds; the mask net's up "
             f"convolutions run csrc/upconv.cu), ms a call and cuDNN's "
             f"kernels:"]
    total = 0.0
    for (shape, nhwc, wshape, dtype, stride, pad, groups), (n, w) in sorted(
            seen.items(), key=lambda kv: -np.prod(kv[0][0])):
        names, ms = _conv_kernels(shape, w, stride=stride, padding=pad,
                                  groups=groups, nhwc=nhwc)
        total += n * ms
        lines.append(f"  {n} x {shape} {'nhwc' if nhwc else 'nchw'} "
                     f"{wshape} s{stride} p{pad} g{groups} "
                     f"{str(dtype)[6:]}: {ms:.3f} ms; " + "; ".join(names))
    lines.append(f"  sum {total:.3f} ms a clip (calls x ms)")
    _write("upconv_convs.txt", "\n".join(lines))
    print("  " + "\n  ".join(lines))
    return rows


# ---------------------------------------------------------------------------
# SW. the shift warp as a gather, alone and fused with the LK blend
# ---------------------------------------------------------------------------

SW_RATES = (2, 3, 5)     # beside the serving rate, at 96x64, 3 keyframes


def _sw_keys(K: int, H: int, W: int, seed: int) -> torch.Tensor:
    """K keyframes (K, H, W, 3) in [0, 1] on the card: a smooth texture
    drifting a seeded 3-20 px a keyframe along each axis, and a little
    noise, so that the flows reach past the warp's bound."""
    g = torch.Generator().manual_seed(seed)
    v = (3 + 17 * torch.rand(2, generator=g)) * torch.sign(
        torch.rand(2, generator=g) - 0.5)
    ys = torch.arange(H, dtype=torch.float32)[:, None]
    xs = torch.arange(W, dtype=torch.float32)[None, :]
    frames = torch.stack([torch.stack([
        0.5 + 0.3 * torch.sin((xs - v[0] * k) / 9 + c)
        * torch.cos((ys - v[1] * k) / 13 - c) for c in range(3)], -1)
        for k in range(K)])
    noise = 0.03 * torch.rand(frames.shape, generator=g)
    return (frames + noise).clamp(0, 1).to("cuda")


def _lk_by_loop(keys, rate: int, flow_kw: dict):
    """``upsample_background(keys, rate, **flow_kw)`` on the card by the
    shift loop (the kernels' route switched off), with (img, flow, R,
    out) of every warp it made and the full-resolution flows and errors
    it blended."""
    from renderloom_torch.ops import flow as FO

    warps, full = [], {}
    saved = FO._on_card, FO.backward_warp_shift, FO.blend_stream

    def rec_warp(img, flow, max_disp=16):
        out = saved[1](img, flow, max_disp)
        warps.append((img, flow, max_disp, out))
        return out

    def rec_blend(frames, flows, errs, rate, warp):
        full.update(flows=flows, errs=errs)
        return saved[2](frames, flows, errs, rate, warp)
    FO._on_card, FO.backward_warp_shift, FO.blend_stream = (
        lambda x: False), rec_warp, rec_blend
    try:
        stream = FO.upsample_background(keys, rate, **flow_kw)
        torch.cuda.synchronize()
    finally:
        FO._on_card, FO.backward_warp_shift, FO.blend_stream = saved
    return stream, warps, full


def _sw_equal(name: str, got: torch.Tensor, want: torch.Tensor):
    """Raise unless ``torch.equal(got, want)`` (signed zeros aside, bit
    for bit)."""
    ok = tuple(got.shape) == tuple(want.shape) and torch.equal(got, want)
    print(f"  {name}: torch.equal {'ok' if ok else 'FAIL'}")
    if not ok:
        diff = ((got - want).abs() if got.shape == want.shape
                else torch.tensor(float("nan")))
        raise AssertionError(f"{name}: not equal, max |err| "
                             f"{diff.max().item()} at "
                             f"{int((diff != 0).sum())} values")


def _sw_times(name: str, kern, twin, loop, n_bytes: float) -> dict:
    """Call and device ms of ``kern`` beside the bytes bound, its twin
    and the shift loop (in turns with the kernel)."""
    ms = [cuda_ms(kern), cuda_ms(loop, iters=5, warmup=1), cuda_ms(kern)]
    dev = device_ms(kern)
    bnd, by = bound_ms(n_bytes, 0)
    row = dict(ms=min(ms[0], ms[2]), device_ms=dev, bound_ms=bnd,
               bound_by=by, plain_ms=cuda_ms(twin, 5, 1), library_ms=ms[1])
    print(f"  {name}: call {ms[0]:.4f} / {ms[2]:.4f} ms, device {dev:.4f} "
          f"ms ({100 * bnd / dev:.1f}% of the bytes bound {bnd:.4f} ms); "
          f"twin {row['plain_ms']:.4f} ms; the shift loop {ms[1]:.4f} ms")
    return row


@torch.inference_mode()
def phase_shiftwarp(serve) -> dict:
    """SW: both kernels of ``csrc/shiftwarp.cu`` against their twins and
    the card's shift loop with ``torch.equal``: the whole LK backgrounds
    (``eval.pipeline.FLOW``) of phase 4's keyframes and three seeded
    drifting clips at the serving shapes, every warp they make, other
    rates; one launch a call, two calls bit for bit; times beside the
    bytes bound, the twin and the loop."""
    from renderloom_torch.eval.pipeline import FLOW
    from renderloom_torch.ops import flow as FO
    from renderloom_torch.ops import shiftwarp_kernel as SK

    rate, K = serve["rate"], serve["K"]
    H, W = serve["rcfg"].data.model_height, serve["rcfg"].data.model_width
    L = (K - 1) * rate + 1
    print(f"SW. csrc/shiftwarp.cu: the clipped shift warp as a gather "
          f"(rl_shift_warp) and fused with the LK time blend "
          f"(rl_shift_warp_blend), against the twins and the card's shift "
          f"loop: upsample_background(**{FLOW}), {K} keyframes at {W}x{H}, "
          f"rate {rate}")
    clips = [("phase 4's keyframes", serve["inputs"][2][0])] + [
        (f"drifting clip {s}", _sw_keys(K, H, W, s)) for s in (1, 2, 3)]
    first = None
    for name, keys in clips:
        want, warps, full = _lk_by_loop(keys, rate, FLOW)
        _reset_launches()
        got = FO.upsample_background(keys, rate, **FLOW)
        torch.cuda.synchronize()
        if _warp_launches() != _lk_warps(1):
            raise AssertionError(f"SW {name}: launches {_warp_launches()}")
        flows, errs = full["flows"].contiguous(), full["errs"].contiguous()
        print(f"  {name}: |flow| up to {flows.abs().max().item():.1f} px, "
              f"{(flows.abs() > 16).float().mean().item():.2%} of "
              f"components past 16; one launch of each kernel")
        _sw_equal("upsample_background, kernels vs the loop", got, want)
        for img, flow, R, out in warps:
            img, flow = img.contiguous(), flow.contiguous()
            tag = f"{tuple(img.shape)} R {R}"
            _sw_equal(f"rl_shift_warp {tag} vs the loop",
                      SK.shift_warp_cuda(img, flow, R), out)
            _sw_equal(f"twin {tag} vs the loop",
                      SK.shift_warp_plain(img, flow, R), out)
        _sw_equal("rl_shift_warp_blend vs the loop's stream",
                  SK.shift_warp_blend_cuda(keys, flows, errs, rate, 16), want)
        _sw_equal("its twin vs the loop's stream", SK.shift_warp_blend_plain(
            keys, flows, errs, rate, 16), want)
        first = first or (keys, warps, flows, errs)
        del want, got
    small = _sw_keys(3, 64, 96, 7)
    for r in SW_RATES:
        want, _, _ = _lk_by_loop(small, r, FLOW)
        _sw_equal(f"rate {r}, 3 keyframes at 96x64: kernels vs the loop",
                  FO.upsample_background(small, r, **FLOW), want)

    keys, warps, flows, errs = first
    blend = lambda: SK.shift_warp_blend_cuda(keys, flows, errs, rate, 16)
    one_kernel("rl_shift_warp_blend", blend, "blend_kernel")
    same_bits("rl_shift_warp_blend second call", blend(), blend())
    rows = {}
    for tag, (img, flow, R, _) in (("warp_consistency", warps[0]),
                                   ("warp_full", warps[1])):
        img, flow = img.contiguous(), flow.contiguous()
        kern = lambda: SK.shift_warp_cuda(img, flow, R)
        one_kernel(f"rl_shift_warp {tuple(img.shape)}", kern, "warp_kernel")
        same_bits(f"rl_shift_warp {tuple(img.shape)} second call", kern(),
                  kern())
        rows[tag] = dict(shape=f"{tuple(img.shape)} f32, R {R}", **_sw_times(
            f"rl_shift_warp {tuple(img.shape)} R {R}", kern,
            lambda: SK.shift_warp_plain(img, flow, R),
            lambda: FO._shift_resample1d(FO._shift_resample1d(
                img, flow[..., 0], 2, R), flow[..., 1], 1, R),
            4 * (2 * img.numel() + flow.numel())))
    rows["blend"] = dict(
        shape=f"{K} keyframes {tuple(keys.shape[1:])} -> ({L}, {H}, {W}, 3) "
              f"f32, rate {rate}, R 16",
        **_sw_times("rl_shift_warp_blend", blend,
                    lambda: SK.shift_warp_blend_plain(keys, flows, errs, rate,
                                                      16),
                    lambda: FO.blend_stream(
                        keys, flows, errs, rate,
                        lambda x, f: FO._shift_resample1d(FO._shift_resample1d(
                            x, f[..., 0], 2, 16), f[..., 1], 1, 16)),
                    4 * (keys.numel() + flows.numel() + errs.numel()
                         + L * H * W * 3)))
    on_card = FO._on_card

    def by_loop():
        FO._on_card = lambda x: False
        try:
            return FO.upsample_background(keys, rate, **FLOW)
        finally:
            FO._on_card = on_card
    whole = {"kernels": cuda_ms(lambda: FO.upsample_background(
        keys, rate, **FLOW), 10, 2), "loop": cuda_ms(by_loop, 5, 1)}
    print(f"  upsample_background(**FLOW) a clip: {whole['kernels']:.3f} ms "
          f"with the kernels, {whole['loop']:.3f} ms by the shift loop "
          f"({card_line()})")
    return dict(rows=rows, whole_ms=whole)


# ---------------------------------------------------------------------------
# R. K2 r3centered
# ---------------------------------------------------------------------------

# Tolerance: one bf16 ulp of the normalized value n, times |gamma| at
# affine call sites, plus 1e-6, elementwise as 2^-7 |n| |gamma| + 1e-6:
# the sums run in another order than the twin's, which moves n by a few
# float32 ulp and can round it to the neighbouring bf16 value.  At mean
# 256 and std 1 (|mean| / std = 2^8, where bf16 itself steps by 2) the
# unshifted fp32 moments of the contract lose var to the rounding of
# m2 ~ 65537 (ulp 2^-7) and of m1^2, so any two summation orders differ
# by more than that ulp; there each side is held against the contract
# evaluated in float64 (moments in float64, then n rounded to bf16), the
# kernel to at most 1.5x the twin's error plus one ulp.


# Beyond the ulp, the share of elements that are not bit-equal: where
# the kernel and its twin differ only in their sums' order, n rounds to
# another bf16 value in at most 0.0016% of elements at the bf16 clip's
# shapes (NVIDIA H100 80GB HBM3, 700 W); a kernel that skipped the
# rounding of n before the affine, or rounded the affine's float32
# output, would differ at nearly every element of an affine call site
# while staying within the ulp.
R3_NOT_EQUAL_MAX = 1e-4


def _r3_tol(x, s):
    from renderloom_torch.ops import norm_kernel as NK

    n = NK.instance_norm_plain(x, r3centered=True).float()
    return 2.0 ** -7 * n.abs() * (1.0 if s is None else s.abs()) + 1e-6


def _r3_check(name, x, s, b, slope):
    """Max |kernel - twin|; raises beyond _r3_tol or on a wrong dtype."""
    from renderloom_torch.ops import norm_kernel as NK

    got = NK.instance_norm_cuda(x, s, b, slope, r3centered=True)
    want = NK.instance_norm_plain(x, s, b, slope, r3centered=True)
    if got.dtype != want.dtype or got.dtype != (
            torch.bfloat16 if s is None else torch.float32):
        raise AssertionError(f"{name}: output {got.dtype}, twin {want.dtype}")
    diff = (got.float() - want.float()).abs()
    over = (diff > _r3_tol(x, s)).float().mean().item()
    err = diff.max().item()
    neq = (got != want).float().mean().item()
    print(f"  {name}: max_abs_err {err:.3e} (tol one bf16 ulp of n x "
          f"|gamma| + 1e-6), not bit-equal {100 * neq:.4f}% "
          f"{'ok' if over == 0 else 'FAIL'}")
    if over:
        raise AssertionError(f"{name}: {100 * over:.4f}% beyond one ulp")
    if neq > R3_NOT_EQUAL_MAX:
        raise AssertionError(f"{name}: {100 * neq:.4f}% not bit-equal")
    return err


def _r3_library(x, s, b, slope):
    """The library composition: ``F.instance_norm`` in float32 on the
    NCHW view, rounded to bf16, then the float32 affine and leaky."""
    y = F.instance_norm(x.permute(0, 3, 1, 2).float(), eps=1e-5).to(
        torch.bfloat16)
    if s is not None:
        y = y.float() * s[:, None, None] + b[:, None, None]
    if slope is not None:
        y = F.leaky_relu(y, slope)
    return y.permute(0, 2, 3, 1)


def _r3_times(x, s, b, slope, iters=10, residuals=False):
    """(call, device, twin, library composition, bound) ms of one call
    (with ``residuals``, the training call, which also writes them), and
    what bounds it; raises unless the call is one kernel."""
    from renderloom_torch.ops import norm_kernel as NK

    n = x.numel()
    stats = (torch.empty((x.shape[0], x.shape[-1], 3), device="cuda")
             if residuals else None)
    f = lambda: NK.instance_norm_cuda(x, s, b, slope, 1e-5, stats,
                                      r3centered=True)
    p = r3_plan(tuple(x.shape), False, s is not None)
    print(_path_line(p))
    ms, dev = cuda_ms(f, iters), device_ms(f, 2 * iters)
    one_kernel(f"K2 r3centered {tuple(x.shape)}", f, _r3_kernel(p, False))
    plain = cuda_ms(lambda: NK._plain_r3_forward(x, s, b, slope, 1e-5),
                    max(2, iters // 4), 1)
    lib = cuda_ms(lambda: _r3_library(x, s, b, slope), iters)
    # bf16 x read once, the output written once (bf16, or float32 at an
    # affine call site); ~10 fp32 operations per element
    bnd, by = bound_ms(n * (2 + (4 if s is not None else 2)), 10 * n)
    return ms, dev, plain, lib, bnd, by


def _r3_f64(x, s, b, slope):
    """The r3centered contract with float64 moments: n rounded to bf16,
    the affine and the leaky in float64."""
    x64 = x.double()
    m1 = x64.mean((1, 2), keepdim=True)
    var = x64.var((1, 2), unbiased=False, keepdim=True)
    y = ((x64 - m1) / torch.sqrt(var + 1e-5)).to(torch.bfloat16).double()
    if s is not None:
        y = y * s.double() + b.double()
    if slope is not None:
        y = torch.where(y >= 0, y, y * slope)
    return y


def r3_plan(shape, bwd: bool, affine: bool) -> dict:
    """The plan of a K2 (``bwd`` False) or K2b r3centered call on the
    card: the cluster path where a slab fits in one cluster, else the
    grid path (``norm_kernel._plan``)."""
    from renderloom_torch.ops import norm_kernel as NK

    B, H, W, C = shape
    n_sms, bps, smem, csmem = NK._device(0)
    dyf = bwd and affine
    return NK._plan(B, H * W, C, 2, 2 if bwd else 1, n_sms, bps, smem,
                    dy_itemsize=4 if dyf else None, n_sums=4 if dyf else 2,
                    cluster_smem=csmem, out_f32=affine and not bwd)


def _path_line(p: dict) -> str:
    if p["path"] == "cluster":
        return (f"    path: cluster, {p['cluster']} blocks of "
                f"{p['rows_per_block']} px x {p['group']} channels a slab "
                f"({p['grid']} blocks of {p['threads']} threads, "
                f"{p['smem']} B of shared memory each)")
    return (f"    path: grid, {p['grid']} blocks ({p['slabs_per_chunk']} "
            f"slabs x {p['parts']} parts a chunk, {p['n_chunks']} chunks)")


def _hold_r3_calls(what: str, seen: Counter, want: dict):
    """Raise unless the recorded calls ``seen`` (keys: shape, then affine
    and the leaky's slope at ``seen``'s own places) are ``want``."""
    got = Counter()
    for key, n in seen.items():
        shape, affine, slope = key
        got[(shape, affine, slope is not None)] += n
    if dict(got) != want:
        raise AssertionError(f"{what}: the main path's r3centered calls "
                             f"{dict(got)} are not {want}")


def _r3_kernel(p: dict, bwd: bool) -> str:
    """The kernel a plan launches (what the profile must show)."""
    if p["path"] == "cluster":
        return "cluster_bwd" if bwd else "cluster_fwd"
    return "norm_bwd_kernel" if bwd else "norm_fwd_kernel"


# The bf16 main paths' r3centered calls, (shape, affine, leaky): count,
# per bf16 standard clip (phase H's run, 162 calls) and per bf16 training
# step (phase T's, do_checkpoint on): 380 forwards with residuals and 276
# backwards.  Phases R and B2 fail unless the main path made exactly
# these calls; tests/test_torch_norm.py plans them and
# scripts/norm_r3_h100.py times them.
R3_CLIP_CALLS = {
    ((7, 320, 480, 32), False, False): 6,
    ((7, 320, 480, 32), True, True): 9,
    ((7, 320, 480, 16), False, False): 12,
    ((7, 160, 240, 64), False, False): 6,
    ((7, 160, 240, 64), True, True): 9,
    ((7, 160, 240, 32), False, False): 12,
    ((7, 80, 120, 128), False, False): 6,
    ((7, 80, 120, 128), True, True): 9,
    ((7, 80, 120, 64), False, False): 12,
    ((7, 40, 60, 256), False, False): 6,
    ((7, 40, 60, 256), True, True): 18,
    ((7, 40, 60, 256), True, False): 15,
    ((7, 40, 60, 128), False, False): 12,
    ((7, 20, 30, 512), False, False): 18,
    ((7, 20, 30, 256), False, False): 12}
R3_STEP_FWD_CALLS = {
    ((4, 320, 480, 32), False, False): 6,
    ((4, 320, 480, 32), True, True): 6,
    ((4, 320, 480, 16), False, False): 14,
    ((4, 160, 240, 64), False, False): 6,
    ((4, 160, 240, 64), True, True): 6,
    ((4, 160, 240, 32), False, False): 14,
    ((4, 80, 120, 128), False, False): 6,
    ((4, 80, 120, 128), True, True): 6,
    ((4, 160, 240, 32), True, True): 16,
    ((4, 80, 120, 64), False, False): 14,
    ((4, 40, 60, 256), False, False): 6,
    ((4, 40, 60, 256), True, True): 12,
    ((4, 40, 60, 256), True, False): 10,
    ((4, 80, 120, 64), True, True): 16,
    ((4, 40, 60, 128), False, False): 14,
    ((4, 20, 30, 512), False, False): 22,
    ((4, 40, 60, 128), True, True): 16,
    ((4, 80, 120, 32), True, True): 16,
    ((4, 19, 29, 512), True, True): 16,
    ((4, 20, 30, 256), False, False): 14,
    ((4, 20, 30, 256), True, True): 16,
    ((4, 40, 60, 64), True, True): 16,
    ((4, 20, 30, 128), True, True): 16,
    ((4, 9, 14, 512), True, True): 16,
    ((4, 40, 40, 32), True, True): 8,
    ((4, 10, 15, 256), True, True): 16,
    ((4, 20, 20, 64), True, True): 8,
    ((8, 20, 20, 32), True, True): 8,
    ((4, 9, 9, 256), True, True): 8,
    ((4, 10, 10, 128), True, True): 8,
    ((8, 10, 10, 64), True, True): 8,
    ((8, 4, 4, 256), True, True): 8,
    ((8, 5, 5, 128), True, True): 8}
R3_STEP_BWD_CALLS = {
    ((4, 320, 480, 32), True, True): 6,
    ((4, 320, 480, 32), False, False): 4,
    ((4, 160, 240, 64), True, True): 6,
    ((4, 320, 480, 16), False, False): 8,
    ((4, 160, 240, 64), False, False): 4,
    ((4, 160, 240, 32), True, True): 12,
    ((4, 80, 120, 128), True, True): 6,
    ((4, 160, 240, 32), False, False): 8,
    ((4, 80, 120, 128), False, False): 4,
    ((4, 80, 120, 64), True, True): 12,
    ((4, 40, 60, 256), True, False): 10,
    ((4, 40, 60, 256), True, True): 12,
    ((4, 80, 120, 64), False, False): 8,
    ((4, 40, 60, 256), False, False): 4,
    ((4, 80, 120, 32), True, True): 12,
    ((4, 40, 60, 128), True, True): 12,
    ((4, 40, 60, 128), False, False): 8,
    ((4, 20, 30, 512), False, False): 12,
    ((4, 19, 29, 512), True, True): 12,
    ((4, 40, 60, 64), True, True): 12,
    ((4, 20, 30, 256), True, True): 12,
    ((4, 20, 30, 256), False, False): 8,
    ((4, 20, 30, 128), True, True): 12,
    ((4, 9, 14, 512), True, True): 12,
    ((4, 40, 40, 32), True, True): 6,
    ((4, 10, 15, 256), True, True): 12,
    ((8, 20, 20, 32), True, True): 6,
    ((4, 20, 20, 64), True, True): 6,
    ((4, 9, 9, 256), True, True): 6,
    ((8, 10, 10, 64), True, True): 6,
    ((4, 10, 10, 128), True, True): 6,
    ((8, 4, 4, 256), True, True): 6,
    ((8, 5, 5, 128), True, True): 6}


# (shape, affine) where phases R and B2 compare two calls bit for bit on
# the cluster path (beside the grid path's largest shapes) and read the
# wrappers' host time per call
R3_CLUSTER_SHAPES = [((4, 40, 60, 256), True), ((8, 5, 5, 128), True)]
R3_HOST_SHAPES = [((1, 4, 4, 32), False), ((4, 40, 60, 256), True)]


def phase_norm_r3(bf16):
    from renderloom_torch.ops import norm_kernel as NK

    shapes = sorted(((k[:4], n) for k, n in bf16["standard"]["seen"].items()),
                    key=lambda kv: -np.prod(kv[0][0]))
    _hold_r3_calls("K2 r3centered per clip",
                   Counter({(k[0], k[2], k[3]): n for k, n in shapes}),
                   R3_CLIP_CALLS)
    print(f"R. K2 r3centered, kernel vs plain twin, at the bf16 standard "
          f"run's {len(shapes)} shapes:")
    entry = _sum_shapes(
        "K2 r3centered", "clip", shapes,
        lambda i, key: _norm_inputs(*key[:3], seed=700 + i) + (key[3],),
        lambda x, s, b, slope: _r3_check("vs twin", x, s, b, slope),
        _r3_times, "library composition")
    fast_shapes = {k[:4] for k in bf16["fastpath"]["seen"]
                   if k[4] == "r3centered"}
    for i, key in enumerate(sorted(fast_shapes - {k for k, _ in shapes})):
        x, s, b = _norm_inputs(*key[:3], seed=750 + i)
        _r3_check(f"fastpath-only {key}", x, s, b, key[3])
    # the library composition computes the same function (to the ulp)
    x, s, b = _norm_inputs((7, 160, 240, 64), torch.bfloat16, True, 790)
    lib = _r3_library(x, s, b, LEAKY)
    diff = (lib - NK.instance_norm_cuda(x, s, b, LEAKY,
                                        r3centered=True)).abs()
    if not bool((diff <= _r3_tol(x, s)).all()):
        raise AssertionError("library composition vs kernel beyond one ulp")
    print(f"  library composition vs kernel (affine + leaky): max "
          f"{diff.max().item():.3e}, within one ulp ok")
    # two calls give the same bits
    if not torch.equal(NK.instance_norm_cuda(x, s, b, LEAKY, r3centered=True),
                       NK.instance_norm_cuda(x, s, b, LEAKY,
                                             r3centered=True)):
        raise AssertionError("K2 r3centered: two calls differ")
    print("  determinism: two calls at (7, 160, 240, 64) equal bit for bit ok")
    for i, (shape, affine) in enumerate(R3_CLUSTER_SHAPES):
        x, s, b = _norm_inputs(shape, torch.bfloat16, affine, 793 + i)
        p = r3_plan(shape, False, affine)
        st1, st2 = (torch.empty((shape[0], shape[-1], 3), device="cuda")
                    for _ in range(2))
        y1 = NK.instance_norm_cuda(x, s, b, LEAKY, 1e-5, st1, r3centered=True)
        y2 = NK.instance_norm_cuda(x, s, b, LEAKY, 1e-5, st2, r3centered=True)
        if p["path"] != "cluster" or not (torch.equal(y1, y2)
                                          and torch.equal(st1, st2)):
            raise AssertionError(f"K2 r3centered {shape}: two calls differ "
                                 f"or not on the cluster path ({p})")
        print(f"  determinism: two calls at {shape} (cluster path, "
              f"{p['cluster']} blocks a cluster) equal bit for bit (output "
              f"and residuals) ok")
    # mean 256, std 1: the edge of the unshifted contract
    x, s, b = _norm_inputs((7, 40, 60, 256), torch.bfloat16, True, 791,
                           loc=256.0)
    got = NK.instance_norm_cuda(x, s, b, LEAKY, r3centered=True)
    twin = NK.instance_norm_plain(x, s, b, LEAKY, r3centered=True)
    ref = _r3_f64(x, s, b, LEAKY)
    diff = (got - twin).abs()
    e_k = (got.double() - ref).abs().max().item()
    e_t = (twin.double() - ref).abs().max().item()
    ulp = _r3_tol(x, s).max().item()
    print(f"  (7, 40, 60, 256) bfloat16 mean 256 std 1, affine + leaky: "
          f"kernel vs twin max {diff.max().item():.3e}, not bit-equal "
          f"{100 * (diff > 0).float().mean().item():.2f}%, beyond one ulp "
          f"{100 * (diff > _r3_tol(x, s)).float().mean().item():.2f}%; "
          f"against the contract in float64: kernel {e_k:.3e}, twin "
          f"{e_t:.3e} (held: kernel <= 1.5 x twin + {ulp:.2e})")
    if not e_k <= 1.5 * e_t + ulp:
        raise AssertionError(f"r3centered at mean 256: kernel {e_k}, twin "
                             f"{e_t}")
    host = {}
    for shape, affine in R3_HOST_SHAPES:
        x, s, b = _norm_inputs(shape, torch.bfloat16, affine, 792)
        slope = LEAKY if affine else None
        host[str(shape)] = host_us(lambda: NK.instance_norm_cuda(
            x, s, b, slope, r3centered=True))
        print(f"  host time per call at {shape} (affine={affine}): "
              f"{host[str(shape)]:.1f} us")
    n_calls = sum(n for _, n in shapes)
    paths = Counter(r3_plan(k[0], False, k[2])["path"] for k, n in shapes
                    for _ in range(n))
    print(f"  paths per clip: {dict(paths)}")
    return dict(**entry, host_us=host, paths=dict(paths),
                library="F.instance_norm (float32) -> bf16 -> float32 "
                        "affine -> leaky (a composition; no single call)",
                shape=f"{n_calls} launches over {len(shapes)} shapes, B=7, "
                      f"C 16-512, bf16 in, bf16 or float32 out, summed "
                      f"per bf16 standard clip")


# ---------------------------------------------------------------------------
# E. card bf16 pipeline vs CPU bf16 pipeline
# ---------------------------------------------------------------------------


def _tiny_serving_case():
    """phase 5's 64x96 case: tiny-width configs, motion statistics that
    keep the joints in the frame, and seeded inputs."""
    from renderloom_torch.core import config as C

    H, W, rate, K = 64, 96, 2, 3
    mcfg = C.MotionConfig(
        transformer=C.TransformerConfig(hidden_dim=32, nheads=4,
                                        dim_feedforward=64, enc_layers=2,
                                        dec_layers=2, dropout=0.0),
        pos_encode=C.PosEncodeConfig(hidden_dim=32))
    rcfg = C.RendererConfig(
        gen=C.GeneratorConfig(
            num_filters=4, max_num_filters=16, num_layers=6,
            num_downsamples=4, do_checkpoint=False,
            mask=C.MaskNetConfig(num_filters=4, max_num_filters=16,
                                 num_downsamples=3, num_res_blocks=1),
            embed=C.EmbedConfig(num_filters=4, max_num_filters=16,
                                num_downsamples=4)),
        data=C.RendererDataConfig(model_width=W, model_height=H,
                                  load_width=W, load_height=H))
    mean = np.zeros((19, 2), np.float32)
    mean[-1] = (-0.8, -0.85)
    std = np.full((19, 2), 0.02, np.float32)
    rng = np.random.default_rng(1)
    motion = np.stack([rng.uniform(-0.9, -0.7, (1, 19, K)),
                       rng.uniform(-0.9, -0.8, (1, 19, K))], axis=2)
    conf = np.full((1, 19, 1, K), 0.9)
    keys = rng.uniform(0, 1, (1, K, H, W, 3))
    return (mcfg, rcfg, rate, K, dict(mean=mean, std=std),
            (motion, conf, keys))


def _serve_tiny(mcfg, rcfg, rate, K, stats, inputs, device, fastpath):
    from renderloom_torch.eval.pipeline import build_pipeline

    fn, _, _ = build_pipeline(mcfg, rcfg, rate, K, device=device,
                              fastpath=fastpath, **stats)
    as_t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    return fn(*map(as_t, inputs))[0].cpu()


# bf16 on two devices: the same function rounded at other places (cuDNN
# and the kernels sum in other orders than the CPU), and the tiny
# random-weight network amplifies the rounding (tests/test_torch_bf16.py:
# the JAX bf16 image itself lies tenths from its float32 one).  The
# card is held on the generated frames (keyframes pass through exactly
# and are checked in phase H): their mean |card - CPU bf16| within
# BF16_MEAN_TOL, and their largest error against the CPU float32
# pipeline at most 1.5x the CPU bf16 pipeline's own + 1e-3.  The limit
# lies between the sound reading and a control that departs from the
# CPU's bf16 function by bf16's own size, the card's frames against the
# CPU float32 pipeline's: on an NVIDIA H100 80GB HBM3 at 700 W, sound
# 3.54e-3 (standard) and 3.34e-3 (fastpath), control 1.55e-2 and
# 1.54e-2.  The control is printed each run and must lie beyond the
# limit.
BF16_MEAN_TOL = 7e-3


def phase_bf16_cpu_match():
    mcfg, rcfg, rate, K, stats, inputs = _tiny_serving_case()
    print(f"E. card bf16 pipeline vs CPU bf16 pipeline (64x96, rate {rate}, "
          f"{K} keyframes, tiny widths, same weights), generated frames:")
    for fastpath in (False, True):
        run = lambda m, r, dev: _serve_tiny(m, r, rate, K, stats, inputs,
                                            dev, fastpath)[:, 1::rate]
        cpu32 = run(mcfg, rcfg, "cpu")
        cpu, card = (run(_bf16(mcfg), _bf16(rcfg), dev)
                     for dev in ("cpu", "cuda"))
        name = "fastpath" if fastpath else "standard"
        mean = (card - cpu).abs().mean().item()
        control = (card - cpu32).abs().mean().item()
        err, own = ((a - cpu32).abs().max().item() for a in (card, cpu))
        print(f"  {name}: max |card - CPU| "
              f"{(card - cpu).abs().max().item():.3e}, mean {mean:.3e} "
              f"(tol {BF16_MEAN_TOL:.0e}; the control, mean |card - CPU "
              f"float32|, {control:.3e}); against CPU float32 card "
              f"{err:.3e}, CPU bf16 {own:.3e} (tol 1.5x + 1e-3)")
        if not (mean <= BF16_MEAN_TOL < control
                and err <= 1.5 * own + 1e-3):
            raise AssertionError(f"bf16 {name}: card vs CPU out of bounds")
    print("  ok")


# ---------------------------------------------------------------------------
# O. the other rollouts on the card
# ---------------------------------------------------------------------------

# make_rollout against make_segment_rollout: 1e-3.  segment chunks
# against the whole clip: each chunk is the segment rollout of its own
# sub-clip, which the first chunk checks bit for bit; against the whole
# clip the kernels see another batch (B = 2 segments, 1 in the last
# chunk, not 7), and K2's
# plan (its sums' order) and cuDNN's algorithms follow the batch, so the
# frames differ by rounding amplified through three steps: on an NVIDIA
# H100 80GB HBM3 at 700 W 2.96e-4 with the last chunk padded to 2
# segments, 5.54e-4 with it run at its own length (1 segment), past the
# 1e-5 this check was first given; it is held to the batch-composition
# tolerance of the sequential check, 1e-3.
SEQ_VS_SEG_TOL = 1e-3


def phase_rollouts(serve):
    """``make_rollout`` and its chunked form against
    ``make_segment_rollout`` and ``segment_rollout_chunked`` on phase 4's
    prepared 29-frame clip, float32, the standard generator."""
    from renderloom_torch.train.gan import (make_rollout,
                                            make_segment_rollout,
                                            rollout_chunked,
                                            segment_rollout_chunked)

    gen, rate, clip = serve["gen"], serve["rate"], serve["clip"]
    L = clip["label"].shape[1]
    is_key = torch.arange(L) % rate == 0
    seq, seg = make_rollout(gen), make_segment_rollout(gen, rate)
    first = {k: v[:, :2 * rate + 1] for k, v in clip.items()}
    with torch.inference_mode():
        want = seg(clip)
        outs = {"sequential": seq({**clip, "is_key": is_key}),
                "segment, chunks of 2 segments": segment_rollout_chunked(
                    seg, clip, rate, seg_chunk=2),
                "first chunk alone": seg(first)}
        outs["sequential, chunks of 8"] = rollout_chunked(
            seq, {**clip, "is_key": is_key}, chunk=8)
    torch.cuda.synchronize()
    print(f"O. rollouts on phase 4's {L}-frame clip (float32, standard "
          f"generator):")
    for i, part in enumerate(("fused", "masks")):
        compare(f"sequential vs segment, {part}", outs["sequential"][i],
                want[i], SEQ_VS_SEG_TOL)
        compare(f"segment, chunks of 2 segments vs unchunked, {part}",
                outs["segment, chunks of 2 segments"][i], want[i],
                SEQ_VS_SEG_TOL)
        compare(f"its first chunk vs the segment rollout of frames "
                f"0-{2 * rate}, {part} (bit for bit)",
                outs["segment, chunks of 2 segments"][i][:, :2 * rate + 1],
                outs["first chunk alone"][i], 0.0)
        compare(f"sequential, chunks of 8 vs unchunked, {part} (bit for "
                f"bit)", outs["sequential, chunks of 8"][i],
                outs["sequential"][i], 0.0)


# ---------------------------------------------------------------------------
# P. K1 packed and cfhw layouts
# ---------------------------------------------------------------------------


def phase_raster_layouts(serve, fast):
    from renderloom_torch.ops import rasterize_kernel as RK

    print(f"P. K1 packed and cfhw layouts, kernel vs plain twin bit for bit "
          f"({F_RASTER} frames, {H_FULL}x{W_FULL}):")
    coords, conf = _poses(F_RASTER, H_FULL, W_FULL, seed=0)
    tables = [t.contiguous() for t in
              RK.build_tables(coords, conf, H_FULL, W_FULL)]
    f32, bf16 = torch.float32, torch.bfloat16
    results = {}
    for layout, dtype, masks in (("packed", bf16, False),
                                 ("packed", f32, False),
                                 ("packed", f32, True), ("packed", bf16, True),
                                 ("cfhw", f32, True), ("cfhw", bf16, True)):
        tag = f"{layout} {str(dtype)[6:]} masks={masks}"
        err, _ = _k1_check(tag, tables, H_FULL, W_FULL, dtype, masks,
                           layout)
        results[(layout, dtype, masks)] = dict(
            _k1_times(tag, tables, H_FULL, W_FULL, dtype, masks, layout),
            max_abs_err=err)
    coords, conf = _person_poses(F_RASTER, H_FULL, W_FULL, seed=0)
    ptables = [t.contiguous() for t in
               RK.build_tables(coords, conf, H_FULL, W_FULL)]
    err, _ = _k1_check("person packed bfloat16 masks=False", ptables, H_FULL,
                       W_FULL, bf16, False, "packed")
    results["person"] = dict(_k1_times(
        "person packed bfloat16 masks=False", ptables, H_FULL, W_FULL, bf16,
        False, "packed"), max_abs_err=err)
    draws = RK.draw_train_tables(torch.Generator().manual_seed(1), F_RASTER,
                                 5.0, 0.02, 0.06)
    draws = {k: v.cuda() for k, v in draws.items()}
    ttables = [t.contiguous() for t in RK.build_tables(
        coords, conf, H_FULL, W_FULL, draws=draws)]
    _, got = _k1_check("train tables packed f32 masks", ttables, H_FULL,
                       W_FULL, f32, True, "packed")
    if not bool(got["part_mask"].any()):
        raise AssertionError("no part limb reached the part mask")

    # the cull rule's edges (chip_smoke.adversarial_tables) at full width
    # and at ragged sizes, and the seed-0 poses and the person at the
    # ragged sizes: every layout, label type and mask option
    print("  adversarial tables and ragged sizes, bit for bit:")
    for H, W in ((H_FULL, W_FULL), (318, 478), (45, 61)):
        sets = [("adversarial", adversarial_tables(H, W))]
        if H != H_FULL:
            for name, recipe in (("poses", _poses), ("person", _person_poses)):
                c, cf = recipe(F_RASTER, H, W, seed=0)
                sets.append((name, [t.contiguous() for t in
                                    RK.build_tables(c, cf, H, W)]))
        for name, tabs in sets:
            for layout in RK.LAYOUTS:
                h, w = (H - H % 2, W - W % 2) if layout == "packed" else (H, W)
                for dtype in (f32, bf16):
                    for masks in ((True,) if layout == "cfhw"
                                  else (False, True)):
                        _k1_check(f"{name} {h}x{w} {layout} "
                                  f"{str(dtype)[6:]} masks={masks}", tabs, h,
                                  w, dtype, masks, layout)

    # K1 on the tables the two serving pipelines rasterized (phases 4, F)
    print("  K1 on the serving pipelines' own tables:")
    for what, calls in (("standard", serve["raster_calls"]),
                        ("fastpath", fast["raster_calls"])):
        if len(calls) != 1:
            raise AssertionError(f"{what}: {len(calls)} K1 calls recorded")
        args, kw = calls[0]
        tabs, (H, W, dtype, masks) = args[:3], args[3:7]
        tag = f"{what} pipeline {kw['layout']} {str(dtype)[6:]}"
        err, _ = _k1_check(tag, tabs, H, W, dtype, masks, kw["layout"])
        results[what] = dict(_k1_times(tag, tabs, H, W, dtype, masks,
                                       kw["layout"]), max_abs_err=err)
    return results


def _raster_recorder(calls: list):
    """Record every K1 call's arguments (tables cloned) while still
    launching it; returns the function that undoes the recording."""
    from renderloom_torch.ops import rasterize_kernel as RK

    orig = RK.rasterize_tables_cuda

    def rec(joints, skel, caps, height, width, out_dtype=torch.float32,
            emit_masks=False, brush=None, layout="nhwc"):
        kw = {} if brush is None else {"brush": brush}
        calls.append(((joints.clone(), skel.clone(), caps.clone(), height,
                       width, out_dtype, emit_masks), {"layout": layout,
                                                       **kw}))
        return orig(joints, skel, caps, height, width, out_dtype, emit_masks,
                    layout=layout, **kw)

    rec.layout_launches = orig.layout_launches
    RK.rasterize_tables_cuda = rec

    def restore():
        RK.rasterize_tables_cuda = orig
    return restore


# ---------------------------------------------------------------------------
# 5. card pipeline vs CPU pipeline
# ---------------------------------------------------------------------------


def phase_cpu_match():
    mcfg, rcfg, rate, K, stats, inputs = _tiny_serving_case()
    print(f"card pipeline vs CPU pipeline (64x96, rate {rate}, {K} "
          f"keyframes, tiny widths, same weights):")
    for fastpath in (False, True):
        cpu, card = (_serve_tiny(mcfg, rcfg, rate, K, stats, inputs, dev,
                                 fastpath) for dev in ("cpu", "cuda"))
        compare(f"fused frames, {'fastpath' if fastpath else 'standard'}",
                card, cpu, 1e-3)


# ---------------------------------------------------------------------------
# A. K1 on train-mode tables
# ---------------------------------------------------------------------------

F_TRAIN = 16        # batch 4 × 4-frame windows


def phase_raster_train():
    from renderloom_torch.ops import rasterize_kernel as RK

    print(f"A. K1 on train tables, kernel vs plain twin ({F_TRAIN} frames, "
          f"{H_FULL}x{W_FULL}, f32 label + masks):")
    coords, conf = _poses(F_TRAIN, H_FULL, W_FULL, seed=1)
    draws = RK.draw_train_tables(torch.Generator().manual_seed(0), F_TRAIN,
                                 5.0, 0.02, 0.06)
    draws = {k: v.cuda() for k, v in draws.items()}
    tables = [t.contiguous() for t in
              RK.build_tables(coords, conf, H_FULL, W_FULL, draws=draws)]
    print(f"  draws: sigma in {sorted(draws['sigma'].unique().tolist())}, "
          f"{int((~draws['keep_j']).sum())} joints and "
          f"{int((~draws['keep_e']).sum())} limbs dropped, "
          f"{int(draws['part'].sum())} part limbs")
    err, got = _k1_check("train nhwc f32 masks", tables, H_FULL, W_FULL,
                         torch.float32, True, "nhwc")
    if not bool(got["part_mask"].any()):
        raise AssertionError("no part limb reached the part mask")
    times = _k1_times("train nhwc f32 masks", tables, H_FULL, W_FULL,
                      torch.float32, True, "nhwc")
    coords, conf = _person_poses(F_TRAIN, H_FULL, W_FULL, seed=1)
    ptables = [t.contiguous() for t in
               RK.build_tables(coords, conf, H_FULL, W_FULL, draws=draws)]
    perr, _ = _k1_check("person train nhwc f32 masks", ptables, H_FULL,
                        W_FULL, torch.float32, True, "nhwc")
    person = dict(_k1_times("person train nhwc f32 masks", ptables, H_FULL,
                            W_FULL, torch.float32, True, "nhwc"),
                  max_abs_err=perr)
    return dict(times, max_abs_err=err, person=person,
                shape=f"{F_TRAIN}x{H_FULL}x{W_FULL}x22 f32 label + masks, "
                      f"train tables")


# ---------------------------------------------------------------------------
# C. full-width training
# ---------------------------------------------------------------------------


def _norm_call_recorder(fwd: Counter, bwd: Counter, on_fwd=None,
                        on_bwd=None):
    """Swap the K2 / K2b wrappers for recorders of each call's (shape,
    affine, slope, r3centered), which also hand each call's arguments
    and result to ``on_fwd`` / ``on_bwd`` where given; returns the
    function that puts them back."""
    from renderloom_torch.ops import norm_kernel as NK

    f0, b0 = NK.instance_norm_cuda, NK.instance_norm_bwd_cuda

    def fwd_rec(x, scale=None, bias=None, slope=None, eps=1e-5, stats=None,
                parity=False, r3centered=False):
        fwd[(tuple(x.shape), scale is not None, slope, r3centered)] += 1
        out = f0(x, scale, bias, slope, eps, stats, parity, r3centered)
        if on_fwd is not None:
            on_fwd(x, scale, bias, slope, eps, stats, parity, r3centered,
                   out)
        return out

    def bwd_rec(x, dy, stats, scale=None, bias=None, slope=None,
                r3centered=False):
        bwd[(tuple(x.shape), scale is not None, slope, r3centered)] += 1
        out = b0(x, dy, stats, scale, bias, slope, r3centered)
        if on_bwd is not None:
            on_bwd(x, dy, stats, scale, bias, slope, r3centered, out)
        return out

    # the wrappers count their launches on the function their module
    # name points at, so the recorders carry the counts meanwhile
    counts = {f0: ("launches", "parity_launches", "r3_launches"),
              b0: ("launches", "r3_launches")}
    for (w0, names), rec in zip(counts.items(), (fwd_rec, bwd_rec)):
        for n in names:
            setattr(rec, n, getattr(w0, n))
    NK.instance_norm_cuda, NK.instance_norm_bwd_cuda = fwd_rec, bwd_rec

    def restore():
        for (w0, names), rec in zip(counts.items(), (fwd_rec, bwd_rec)):
            for n in names:
                setattr(w0, n, getattr(rec, n))
        NK.instance_norm_cuda, NK.instance_norm_bwd_cuda = f0, b0
    return restore


def derived_train_launches(cfg, gen, dis, frames: int) -> dict:
    """K1, K2 and K2b launches of one train step from the module
    structure.  Per trained frame: the G forward runs every G norm once,
    and with do_checkpoint the backward recomputes the two SPADE norms
    of each SpadeResBlock branch; the D step runs the discriminator set
    (net_d 4×, the face and hand nets 2× each) and backpropagates all of
    it; the G loss runs the set again and backpropagates only its fake
    half (net_d 2×, face and hand 1× each) into G.  In float32 every
    norm is the shifted one; in bf16 every norm's input is a bf16
    convolution output (or a bf16 sum, pool or upsample of one), so
    every norm is r3centered, forward and backward."""
    from renderloom_torch.models.layers import SpadeResBlock

    n_g = _count_norms(gen)
    remat = 2 * sum(isinstance(m, SpadeResBlock) and m.remat
                    for m in gen.modules())
    nets = [(dis.net_d, 2)]
    if cfg.dis.use_face:
        nets.append((dis.net_d_face, 1))
    if cfg.dis.use_hand:
        nets.append((dis.net_d_hand, 1))
    half = sum(_count_norms(net) * k for net, k in nets)
    fwd, bwd = frames * (n_g + remat + 4 * half), frames * (n_g + 3 * half)
    r3 = cfg.compute_dtype == "bfloat16"
    return {"rasterize": 1,
            "instance_norm": 0 if r3 else fwd,
            "instance_norm_r3": fwd if r3 else 0,
            "instance_norm_bwd": 0 if r3 else bwd,
            "instance_norm_bwd_r3": bwd if r3 else 0,
            "upconv": 0, **_lk_warps(0)}


def _train_launches() -> dict:
    from renderloom_torch.ops import norm_kernel as NK
    from renderloom_torch.ops import rasterize_kernel as RK
    from renderloom_torch.ops import upconv_kernel as UK

    raster = RK.rasterize_tables_cuda.layout_launches
    return {"rasterize": sum(raster.values()),
            "instance_norm": NK.instance_norm_cuda.launches,
            "instance_norm_r3": NK.instance_norm_cuda.r3_launches,
            "instance_norm_bwd": NK.instance_norm_bwd_cuda.launches,
            "instance_norm_bwd_r3": NK.instance_norm_bwd_cuda.r3_launches,
            "upconv": UK.upconv_cuda.launches, **_warp_launches()}


def _reset_launches():
    """Every kernel wrapper's launch counts to 0."""
    from renderloom_torch.ops import norm_kernel as NK
    from renderloom_torch.ops import rasterize_kernel as RK
    from renderloom_torch.ops import shiftwarp_kernel as SK
    from renderloom_torch.ops import upconv_kernel as UK

    RK.rasterize_tables_cuda.layout_launches = dict.fromkeys(RK.LAYOUTS, 0)
    NK.instance_norm_cuda.launches = 0
    NK.instance_norm_cuda.parity_launches = 0
    NK.instance_norm_cuda.r3_launches = 0
    NK.instance_norm_bwd_cuda.launches = 0
    NK.instance_norm_bwd_cuda.r3_launches = 0
    UK.upconv_cuda.launches = 0
    SK.shift_warp_cuda.launches = SK.shift_warp_blend_cuda.launches = 0


def _snapshot(state):
    return {"G": state.opt_g.flat.clone(), "D": state.opt_d.flat.clone(),
            "u": torch.cat([b.reshape(-1) for n, b in
                            list(state.gen.named_buffers())
                            + list(state.dis.named_buffers())
                            if n.endswith("sn_u")])}


def _train_cfg(compute_dtype="float32", do_checkpoint=None):
    """configs/hsm.yaml, in ``compute_dtype``, with ``do_checkpoint`` if
    given (the yaml's: on)."""
    import dataclasses

    from renderloom_torch.core.config import load_renderer_config

    cfg = load_renderer_config(os.path.join(ROOT, "configs", "hsm.yaml"))
    gen = cfg.gen if do_checkpoint is None else dataclasses.replace(
        cfg.gen, do_checkpoint=do_checkpoint)
    return dataclasses.replace(cfg, compute_dtype=compute_dtype, gen=gen)


def _idle_share(profile_text: str) -> float:
    """The idle share (%) that :func:`_profile` printed."""
    import re

    return float(re.search(r"idle share ([0-9.]+)%", profile_text).group(1))


def phase_train(cfg=None, tag="C", profile_name="train_profile.txt"):
    from renderloom_torch.cli.train_renderer import synthetic_batches
    from renderloom_torch.train.gan import (create_gan_state,
                                            make_gan_train_step,
                                            make_perceptual)

    cfg = cfg or _train_cfg()
    d = cfg.data
    B, L, H, W = cfg.batch_size, d.max_frames, d.model_height, d.model_width
    print(f"{tag}. training at full width: {W}x{H}, batch {B} x {L}-frame "
          f"raw windows, {cfg.compute_dtype}, do_checkpoint="
          f"{cfg.gen.do_checkpoint}, hsm.yaml widths, random weights")
    tic = time.perf_counter()
    state = create_gan_state(cfg, "cuda", seed=0)
    vgg = make_perceptual(cfg, "cuda", seed=0)
    n_g = sum(p.numel() for p in state.gen.parameters())
    n_d = sum(p.numel() for p in state.dis.parameters())
    print(f"  built G ({n_g:,} params), D ({n_d:,}), VGG19 in "
          f"{time.perf_counter() - tic:.1f} s")
    step = make_gan_train_step(cfg, vgg, data_cfg=d)
    rng = np.random.default_rng(0)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in raw.items()}
               for raw in synthetic_batches(rng, 5, B, L, d.load_height,
                                            d.load_width)]
    before = _snapshot(state)

    # warm-up, recording every K2 / K2b call
    fwd, bwd = Counter(), Counter()
    restore = _norm_call_recorder(fwd, bwd)
    try:
        metrics = step(state, batches[0])
        torch.cuda.synchronize()
    finally:
        restore()

    want = derived_train_launches(cfg, state.gen, state.dis, L - 2)
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    runs = []
    for i in range(3):
        tic = time.perf_counter()
        metrics = step(state, batches[1 + i])
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - tic)
    launches = _train_launches()
    peak = torch.cuda.max_memory_allocated()
    print(f"  launches in 3 steps: {launches}; derived "
          f"{ {k: 3 * v for k, v in want.items()} } "
          f"(per step {want}; the warm-up recorded {sum(fwd.values())} K2 "
          f"and {sum(bwd.values())} K2b calls)")
    if launches != {k: 3 * v for k, v in want.items()}:
        raise AssertionError(f"kernel launches {launches}")
    if (sum(fwd.values()), sum(bwd.values())) != (
            want["instance_norm"] + want["instance_norm_r3"],
            want["instance_norm_bwd"] + want["instance_norm_bwd_r3"]):
        raise AssertionError("recorded norm calls differ from the derived "
                             "counts")
    vals = {k: float(v) for k, v in metrics.items()}
    print("  metrics of the last step: " + ", ".join(
        f"{k} {v:.5g}" for k, v in sorted(vals.items())))
    if not all(np.isfinite(v) for v in vals.values()):
        raise AssertionError(f"non-finite metrics {vals}")
    if vals["notfinite/g"] or vals["notfinite/d"]:
        raise AssertionError("an update was skipped as non-finite")
    after = _snapshot(state)
    for k in before:
        moved = (after[k] != before[k]).float().mean().item()
        print(f"  {k}: {100 * moved:.2f}% of the values moved")
        if moved == 0:
            raise AssertionError(f"{k} did not move")
    wps = len(runs) * B / sum(runs)
    print(f"  gan_train_windows_per_sec {wps:.4f} (steps of "
          + ", ".join(f"{r * 1e3:.1f}" for r in runs) + " ms; peak memory "
          f"{peak / 2 ** 30:.2f} GiB; SM clock, power, temperature right "
          f"after: {card_state()})")

    from rlbench.stages import TRAIN

    # the step's stages (g_forward, d_step, g_step over its L − 2 frames)
    prof = _profile(step, (state, batches[4]), TRAIN)
    _write(profile_name, prof)
    print("  " + "\n  ".join(prof.splitlines()[:14]))
    return dict(launches=launches, fwd=fwd, bwd=bwd, wps=wps,
                peak_gib=peak / 2 ** 30,
                step_ms=[r * 1e3 for r in runs], idle=_idle_share(prof),
                per_step=want)


# ---------------------------------------------------------------------------
# B. K2b instance-norm backward
# ---------------------------------------------------------------------------

# dx: 1e-5 + 1e-5·|ref|, as K2's forward.  dγ, dβ: sums over up to
# B·H·W = 614,400 terms of both signs, taken in another order than the
# twin's; the rounding of such a sum is bounded by the sum of the terms'
# magnitudes times a small multiple of float32's epsilon, so each
# channel is held to 1e-5 · Σ|term| (about 80 ulp of the magnitude sum).
DPARAM_TOL = 1e-5


def _bwd_inputs(shape, affine, seed):
    x, s, b = _norm_inputs(shape, torch.float32, affine, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    dy = torch.randn(shape, device="cuda", generator=g)
    return x, dy, s, b


def _dparam_check(name, got, want, mags):
    """dγ and dβ (``got``, ``want``) against the twin's, each channel to
    DPARAM_TOL of the sum of its terms' magnitudes ``mags``."""
    for k, (g_, w_, mag) in enumerate(zip(got, want, mags)):
        ratio = ((g_ - w_).abs() / mag).max().item()
        ok = ratio <= DPARAM_TOL
        print(f"  {name} d{'gamma' if k == 0 else 'beta'}: max "
              f"|err|/sum|term| {ratio:.2e} (tol {DPARAM_TOL:.0e}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: dparam error ratio {ratio}")


def _bwd_check(name, x, dy, s, b, slope):
    from renderloom_torch.ops import norm_kernel as NK

    B, C = x.shape[0], x.shape[-1]
    stats = torch.empty((B, C, 3), device="cuda")
    NK.instance_norm_cuda(x, s, b, slope, 1e-5, stats)
    _, want_stats = NK._plain_forward(x, s, b, slope, 1e-5)
    compare(f"{name} residuals", stats, want_stats, 1e-5, 1e-5)
    got = NK.instance_norm_bwd_cuda(x, dy, stats, s, b, slope)
    want = NK.instance_norm_bwd_plain(x, dy, stats, s, b, slope)
    err = compare(f"{name} dx", got[0], want[0], 1e-5, 1e-5)
    if s is not None:
        xhat = ((x - stats[:, None, None, :, 0]) - stats[:, None, None, :, 1]
                ) * stats[:, None, None, :, 2]
        z = xhat * s + b
        dz = torch.where(z >= 0, dy, dy * slope) if slope is not None else dy
        _dparam_check(name, got[1:], want[1:],
                      ((dz * xhat).abs().sum((0, 1, 2)),
                       dz.abs().sum((0, 1, 2))))
    return err


def _bwd_times(x, dy, s, b, slope, iters=10):
    """(call, device, twin, library, bound) ms of one backward call, and
    what bounds it; raises unless the call is one kernel."""
    from renderloom_torch.ops import norm_kernel as NK

    B, C = x.shape[0], x.shape[-1]
    stats = torch.empty((B, C, 3), device="cuda")
    NK.instance_norm_cuda(x, s, b, slope, 1e-5, stats)
    f = lambda: NK.instance_norm_bwd_cuda(x, dy, stats, s, b, slope)
    ms, dev = cuda_ms(f, iters), device_ms(f)
    one_kernel(f"K2b {tuple(x.shape)}", f, "norm_bwd_kernel")
    plain = cuda_ms(lambda: NK.instance_norm_bwd_plain(x, dy, stats, s, b,
                                                       slope),
                    max(2, iters // 4), 1)
    xn = x.permute(0, 3, 1, 2).detach().requires_grad_()
    dyn = dy.permute(0, 3, 1, 2)
    w = s.detach().requires_grad_() if s is not None else None

    def lib_fwd():
        return F.instance_norm(xn, weight=w, bias=b, eps=1e-5)

    def lib_fwd_bwd():
        torch.autograd.backward(lib_fwd(), dyn)
    fb = cuda_ms(lib_fwd_bwd, iters)
    fo = cuda_ms(lib_fwd, iters)
    n = x.numel()
    # x and dy read once, dx written once; ~14 fp32 operations per
    # element (x̂ 3, leaky 3, two sums 3, dx 5)
    bnd, by = bound_ms(3 * n * 4, 14 * n)
    return ms, dev, plain, max(fb - fo, 0.0), bnd, by


def phase_norm_bwd(train):
    from renderloom_torch.ops import norm_kernel as NK

    print(f"B. K2b instance-norm backward, kernel vs plain twin, at the "
          f"{len(train['bwd'])} shapes of one full-width training step:")
    bwd_entry = _sum_shapes(
        "K2b", "step",
        sorted(train["bwd"].items(), key=lambda kv: -np.prod(kv[0][0])),
        lambda i, key: _bwd_inputs(key[0], key[1], 200 + i) + (key[2],),
        lambda x, dy, s, b, slope: _bwd_check("vs twin", x, dy, s, b, slope),
        _bwd_times, "F.instance_norm backward")
    bwd_entry["shape"] = (f"{sum(train['bwd'].values())} calls over "
                          f"{len(train['bwd'])} shapes, summed per step")
    # two calls at the largest shape give the same bits
    x, dy, s, b = _bwd_inputs((4, 320, 480, 32), True, 250)
    stats = torch.empty((4, 32, 3), device="cuda")
    NK.instance_norm_cuda(x, s, b, LEAKY, 1e-5, stats)
    one, two = (NK.instance_norm_bwd_cuda(x, dy, stats, s, b, LEAKY)
                for _ in range(2))
    if not all(torch.equal(u, v) for u, v in zip(one, two)):
        raise AssertionError("K2b: two calls differ")
    print("  determinism: two calls at (4, 320, 480, 32) equal bit for bit "
          "(dx, dgamma, dbeta) ok")
    x, dy, s, b = _bwd_inputs(STREAM_SHAPE, True, 251)
    plan = _plan_of(x, 2)
    if not plan["streaming"]:
        raise AssertionError(f"{STREAM_SHAPE} does not stream: {plan}")
    _bwd_check(f"streaming {STREAM_SHAPE} affine=True leaky=True (plan "
               f"{plan})", x, dy, s, b, LEAKY)
    x, dy, s, b = _bwd_inputs((1, 4, 4, 32), False, 252)
    stats = torch.empty((1, 32, 3), device="cuda")
    NK.instance_norm_cuda(x, None, None, None, 1e-5, stats)
    print(f"  host time per call at (1, 4, 4, 32): "
          f"{host_us(lambda: NK.instance_norm_bwd_cuda(x, dy, stats)):.1f} us")

    # small shapes through the autograd.Function against float64
    print("  through InstanceNormFunction vs the twin's float64 gradient "
          "(tol 1e-4):")
    for shape, affine, slope in [((2, 5, 7, 3), False, None),
                                 ((2, 5, 7, 3), True, LEAKY),
                                 ((1, 4, 6, 40), True, None)]:
        x, dy, s, b = _bwd_inputs(shape, affine, 300)
        xs = [x.requires_grad_()] + ([s.requires_grad_(),
                                      b.requires_grad_()] if affine else [])
        y = NK.instance_norm(x, s, b, slope)
        if type(y.grad_fn).__name__ != "InstanceNormFunctionBackward":
            raise AssertionError("the norm on the card recorded no gradient")
        got = torch.autograd.grad(y, xs, dy)
        x64 = [v.detach().double().requires_grad_() for v in xs]
        y64 = NK.instance_norm_plain(x64[0], *(x64[1:] if affine else
                                               (None, None)), slope)
        want = torch.autograd.grad(y64, x64, dy.double())
        for name, g_, w_ in zip(("dx", "dgamma", "dbeta"), got, want):
            compare(f"{shape} affine={affine} {name}", g_, w_, 1e-4)

    # the forward's training variant at the step's forward shapes
    print(f"  K2 forward at the step's {len(train['fwd'])} shapes (kernel "
          f"vs twin, residuals included):")
    fwd_entry = _sum_shapes(
        "K2", "step",
        sorted(train["fwd"].items(), key=lambda kv: -np.prod(kv[0][0])),
        lambda i, key: _norm_inputs(key[0], torch.float32, key[1],
                                    seed=400 + i) + (key[2],),
        lambda x, s, b, slope: _norm_check("vs twin", x, s, b, slope),
        lambda x, s, b, slope: _norm_times(x, s, b, slope, iters=10))
    fwd_entry["shape"] = (f"{sum(train['fwd'].values())} calls over "
                          f"{len(train['fwd'])} shapes, summed per step")
    return fwd_entry, bwd_entry


# ---------------------------------------------------------------------------
# D. card training step vs CPU training step
# ---------------------------------------------------------------------------

# metrics 1e-3 relative (the tolerance of the g/* metrics against JAX,
# tests/test_torch_train_step.py: they read the updated D, whose
# sign-like AMSGrad step turns rounding-level gradient differences into
# ±lr).  Gradients of the first frame per parameter, each against its own
# largest |g| (convolutions sum in another order on each device): G 3e-3
# and D 1e-4, about 5× and 12× the worst parameter measured on the H100
# (G 5.4e-4, in the mask net's first norm; D 8.3e-6; each the same to 1%
# over three runs).  A parameter whose gradient is below 1e-4 of its
# network's largest holds only rounding noise (a conv bias ahead of an
# instance norm: 4e-7 of the largest at most, where the smallest of the
# others is 1.5e-3) and is held to that floor instead
TRAIN_MATCH_RTOL = 1e-3
TRAIN_GRAD_RTOL = {"g": 3e-3, "d": 1e-4}
TRAIN_GRAD_FLOOR = 1e-4


def _tiny_train_cfg(compute_dtype="float32"):
    """The 64×96, B = 2, L = 3 tiny-width training config of phases D
    and D2."""
    from renderloom_torch.core import config as C

    H, W, B, L = 64, 96, 2, 3
    # one layer fewer for the 8×8 hand crops, whose last norm would see a
    # 1×1 map, return its bias and pass the hand net no gradient
    tiny = lambda n, layers=2: C.PatchDiscConfig(
        num_filters=4, max_num_filters=16, num_discriminators=n,
        num_layers=layers)
    cfg = C.RendererConfig(
        gen=C.GeneratorConfig(
            num_filters=4, max_num_filters=16, num_layers=6,
            num_downsamples=4, do_checkpoint=True,
            mask=C.MaskNetConfig(num_filters=4, max_num_filters=16,
                                 num_downsamples=3, num_res_blocks=2),
            embed=C.EmbedConfig(num_filters=4, max_num_filters=16,
                                num_downsamples=4)),
        dis=C.DiscriminatorConfig(image=tiny(2), face=tiny(1),
                                  hand=tiny(1, layers=1)),
        data=C.RendererDataConfig(model_width=W, model_height=H,
                                  load_width=W, load_height=H,
                                  max_frames=L),
        batch_size=B, compute_dtype=compute_dtype)
    return cfg


def _tiny_step(cfg, device):
    """One train step of ``cfg`` on ``device`` from seed-5 weights and a
    seed-3 raw window: its metrics, and each network's first-frame
    gradients by parameter name (on the CPU)."""
    from renderloom_torch.cli.train_renderer import synthetic_batches
    from renderloom_torch.train.gan import (create_gan_state,
                                            make_gan_train_step,
                                            make_perceptual)

    d = cfg.data
    raw = next(synthetic_batches(np.random.default_rng(3), 1,
                                 cfg.batch_size, d.max_frames,
                                 d.model_height, d.model_width))
    state = create_gan_state(cfg, device, seed=5)
    grads = {}
    for net, module in (("g", state.gen), ("d", state.dis)):
        opt = getattr(state, f"opt_{net}")
        names = [n for n, _ in module.named_parameters()]

        def step(gs, opt=opt, net=net, names=names):
            grads.setdefault(net, {n: g.detach().cpu()
                                   for n, g in zip(names, gs)})
            return type(opt).step(opt, gs)
        opt.step = step
    fn = make_gan_train_step(cfg, make_perceptual(cfg, device, seed=5),
                             data_cfg=d)
    metrics = fn(state, {k: torch.from_numpy(v).to(device)
                         for k, v in raw.items()})
    return {k: float(v) for k, v in metrics.items()}, grads


def phase_train_cpu_match():
    cfg = _tiny_train_cfg()
    H, W = cfg.data.model_height, cfg.data.model_width
    B, L = cfg.batch_size, cfg.data.max_frames
    (m_cpu, g_cpu), (m_gpu, g_gpu) = (_tiny_step(cfg, dev)
                                      for dev in ("cpu", "cuda"))
    print(f"D. card training step vs CPU training step ({W}x{H}, B {B}, "
          f"L {L}, tiny widths, same weights and draws):")
    worst = 0.0
    for k in sorted(m_cpu):
        rel = abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-6)
        worst = max(worst, rel)
        if rel > TRAIN_MATCH_RTOL:
            raise AssertionError(f"metric {k}: card {m_gpu[k]} vs CPU "
                                 f"{m_cpu[k]}")
    print(f"  {len(m_cpu)} metrics: max relative difference {worst:.2e} "
          f"(tol {TRAIN_MATCH_RTOL:.0e}) ok")
    for net in ("g", "d"):
        want, got = g_cpu[net], g_gpu[net]
        tol = TRAIN_GRAD_RTOL[net]
        top = max(g.abs().max().item() for g in want.values())
        floor = TRAIN_GRAD_FLOOR * top
        errs, noisy = [], []
        for n, g in want.items():
            scale = g.abs().max().item()
            if scale < floor:
                noisy.append(n)
                if got[n].abs().max().item() >= floor:
                    raise AssertionError(f"{n}: card gradient "
                                         f"{got[n].abs().max().item():.3e} "
                                         f"where the CPU's is noise")
            else:
                errs.append(((got[n] - g).abs().max().item() / scale, n))
        errs.sort(reverse=True)
        _write(f"train_grad_match_{net}.txt", "".join(
            f"{n} max|g|/top {want[n].abs().max().item() / top:.3e} "
            f"error {e:.3e}\n" for e, n in errs))
        print(f"  first-frame {net.upper()} gradients of {len(errs)} "
              f"parameters (max |g| {top:.3e}), worst errors against each "
              f"one's max |g|: "
              + ", ".join(f"{n} {e:.2e}" for e, n in errs[:3])
              + f"; {len(noisy)} noise-level biases below {floor:.1e}")
        bad = [(n, e) for e, n in errs if e > tol]
        if bad:
            raise AssertionError(f"{net.upper()} gradients beyond {tol:.0e} "
                                 f"of their own max |g|: {bad[:5]}")
        print(f"  {net.upper()} gradients ok (tol {tol:.0e})")


# ---------------------------------------------------------------------------
# T. bf16 training at full width
# ---------------------------------------------------------------------------


def phase_train_bf16(train):
    """Phase C's step in bf16 compute, with do_checkpoint on (as phase C)
    and off (the setting ``bench.py:bench_gan_train`` times), each beside
    phase C's float32 numbers of this run."""
    runs = {}
    for ckpt in (True, False):
        tag = "T" if ckpt else "T'"
        runs[ckpt] = phase_train(
            _train_cfg("bfloat16", ckpt), tag,
            f"train_profile_bf16{'' if ckpt else '_nockpt'}.txt")
    print("T. gan_train_windows_per_sec, this run: float32 (do_checkpoint "
          f"on) {train['wps']:.4f}, bf16 do_checkpoint on "
          f"{runs[True]['wps']:.4f}, off {runs[False]['wps']:.4f}; peak "
          f"memory {train['peak_gib']:.2f}, {runs[True]['peak_gib']:.2f}, "
          f"{runs[False]['peak_gib']:.2f} GiB; idle share of a profiled "
          f"step {train['idle']:.1f}%, {runs[True]['idle']:.1f}%, "
          f"{runs[False]['idle']:.1f}%")
    return runs


# ---------------------------------------------------------------------------
# B2. K2b r3centered and K2 r3centered with residuals
# ---------------------------------------------------------------------------

# dx: one bf16 ulp of the larger of kernel and twin, plus 1e-6 of the
# call's largest |dx| (where g − E[g] − x̂·E[g·x̂] cancels, float32
# rounding of its terms is all that is left), elementwise, and at most
# R3_BWD_NOT_EQUAL_MAX of elements not bit-equal: the kernel and its
# twin differ only in their sums' order, which moves dx by a few float32
# ulp and rounds it to the neighbouring bf16 value rarely.  Phase R's
# 0.01% was the starting cap; at the bf16 step's 33 shapes on an NVIDIA
# H100 80GB HBM3 at 700 W the readings were 0–0.0039%, and 0.0156% (4
# of 25,600 elements) at (8, 5, 5, 128), where E[g] and E[g·x̂] are
# means of 25 pixels, so the cap is 0.05%, about 3x the largest reading;
# a kernel that skipped a rounding of the contract moves about 29% (g
# not rounded) or all (dx in float32) of them.  dγ and dβ as phase B
# (DPARAM_TOL of the sum of the terms' magnitudes).
R3_BWD_NOT_EQUAL_MAX = 5e-4


def _bwd_r3_inputs(shape, affine, seed, loc=0.0):
    """bf16 x, a cotangent in the forward's output dtype (float32 with
    affine), γ and β."""
    x, s, b = _norm_inputs(shape, torch.bfloat16, affine, seed, loc=loc)
    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    dy = torch.randn(shape, device="cuda", generator=g).to(
        torch.float32 if affine else torch.bfloat16)
    return x, dy, s, b


def _r3_res_check(name, x, s, b, slope):
    """K2 r3centered with residuals: its output as phase R holds it, s = 0
    exactly, (m1, inv) within 1e-5 relative of the twin's, and the
    residuals exactly those the forward used (the output recomputed
    from them equals the kernel's bit for bit)."""
    from renderloom_torch.ops import norm_kernel as NK

    B, C = x.shape[0], x.shape[-1]
    stats = torch.empty((B, C, 3), device="cuda")
    got = NK.instance_norm_cuda(x, s, b, slope, 1e-5, stats, r3centered=True)
    err = _r3_check(name, x, s, b, slope)
    _, want = NK._plain_r3_forward(x, s, b, slope, 1e-5)
    # m1 in units of the std (it may lie near 0), inv relative
    rel = torch.stack([(stats[..., 1] - want[..., 1]) * want[..., 2],
                       stats[..., 2] / want[..., 2] - 1]).abs()
    m1, inv = (v[:, None, None, :] for v in stats[..., 1:].unbind(-1))
    y = ((x.float() - m1) * inv).to(torch.bfloat16)
    if s is not None:
        y = y.float() * s
        y = y + b
    if slope is not None:
        y = torch.where(y >= 0, y, y * slope)
    same = torch.equal(y, got)
    ok = bool((stats[..., 0] == 0).all()) and rel.max().item() <= 1e-5 \
        and same
    print(f"  {name} residuals: s = 0, m1 (x inv) and inv max rel "
          f"{rel.max().item():.2e} (tol 1e-5), output from them bit for bit "
          f"{same} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: residuals")
    return err


def _bwd_r3_check(name, x, dy, s, b, slope):
    """K2b r3centered against its twin on the residuals K2 r3centered
    wrote: dx to one ulp and the not-bit-equal cap, dγ and dβ as phase
    B."""
    from renderloom_torch.ops import norm_kernel as NK

    B, C = x.shape[0], x.shape[-1]
    stats = torch.empty((B, C, 3), device="cuda")
    NK.instance_norm_cuda(x, s, b, slope, 1e-5, stats, r3centered=True)
    got = NK.instance_norm_bwd_cuda(x, dy, stats, s, b, slope,
                                    r3centered=True)
    want = NK.instance_norm_bwd_plain(x, dy, stats, s, b, slope,
                                      r3centered=True)
    if got[0].dtype != torch.bfloat16:
        raise AssertionError(f"{name}: dx {got[0].dtype}")
    g, w = got[0].float(), want[0].float()
    diff = (g - w).abs()
    tol = 2.0 ** -7 * torch.maximum(g.abs(), w.abs()) + 1e-6 * w.abs().max()
    over = (diff > tol).float().mean().item()
    neq = (diff > 0).float().mean().item()
    err = diff.max().item()
    print(f"  {name} dx: max_abs_err {err:.3e} (tol one bf16 ulp + 1e-6 of "
          f"max |dx|), not bit-equal {100 * neq:.4f}% "
          f"{'ok' if not over and neq <= R3_BWD_NOT_EQUAL_MAX else 'FAIL'}")
    if over or neq > R3_BWD_NOT_EQUAL_MAX:
        raise AssertionError(f"{name}: {100 * over:.4f}% beyond one ulp, "
                             f"{100 * neq:.4f}% not bit-equal")
    if s is not None:
        m1, inv = (v[:, None, None, :] for v in stats[..., 1:].unbind(-1))
        n = ((x.float() - m1) * inv).to(torch.bfloat16).float()
        z = n * s + b
        dz = torch.where(z >= 0, dy, dy * slope) if slope is not None else dy
        _dparam_check(name, got[1:], want[1:],
                      ((dz * n).abs().sum((0, 1, 2)),
                       dz.abs().sum((0, 1, 2))))
    return err


def _bwd_r3_library(x, dy, s, b, slope):
    """Autograd through the library composition: ``F.instance_norm`` in
    float32 → bf16 → float32 affine → leaky, dx in bf16 and dγ, dβ."""
    xn = x.permute(0, 3, 1, 2).detach().requires_grad_()
    w = bb = None
    if s is not None:
        w, bb = s.detach().requires_grad_(), b.detach().requires_grad_()
    dyn = dy.permute(0, 3, 1, 2)

    def fwd():
        y = F.instance_norm(xn.float(), eps=1e-5).to(torch.bfloat16)
        if w is not None:
            y = y.float() * w[:, None, None] + bb[:, None, None]
        return F.leaky_relu(y, slope) if slope is not None else y

    def fwd_bwd():
        torch.autograd.backward(fwd(), dyn)
    return fwd, fwd_bwd


def _bwd_r3_times(x, dy, s, b, slope, iters=5):
    """(call, device, twin, library, bound) ms of one K2b r3centered
    call, and what bounds it; raises unless the call is one kernel."""
    from renderloom_torch.ops import norm_kernel as NK

    B, C = x.shape[0], x.shape[-1]
    stats = torch.empty((B, C, 3), device="cuda")
    NK.instance_norm_cuda(x, s, b, slope, 1e-5, stats, r3centered=True)
    f = lambda: NK.instance_norm_bwd_cuda(x, dy, stats, s, b, slope,
                                          r3centered=True)
    p = r3_plan(tuple(x.shape), True, s is not None)
    print(_path_line(p))
    ms, dev = cuda_ms(f, iters), device_ms(f, 2 * iters)
    one_kernel(f"K2b r3centered {tuple(x.shape)}", f, _r3_kernel(p, True))
    plain = cuda_ms(lambda: NK.instance_norm_bwd_plain(
        x, dy, stats, s, b, slope, r3centered=True), 2, 1)
    fwd, fwd_bwd = _bwd_r3_library(x, dy, s, b, slope)
    lib = max(cuda_ms(fwd_bwd, iters) - cuda_ms(fwd, iters), 0.0)
    n = x.numel()
    # x (bf16) and dy (float32 with affine, else bf16) read once, dx
    # (bf16) written once; ~20 fp32 operations per element (x̂ 3, n and
    # the leaky 4, g 2, four sums 6, dx 5)
    bnd, by = bound_ms(n * (2 + dy.element_size() + 2), 20 * n)
    return ms, dev, plain, lib, bnd, by


def _bwd_r3_f64(x, dy, s, b, slope):
    """The r3centered gradient's contract with float64 moments: n and g
    rounded to bf16 as the contract rounds them, the rest in float64; dx
    before its rounding to bf16."""
    x64 = x.double()
    m1 = x64.mean((1, 2), keepdim=True)
    inv = 1.0 / torch.sqrt(x64.var((1, 2), unbiased=False, keepdim=True)
                           + 1e-5)
    xhat = (x64 - m1) * inv
    n = xhat.to(torch.bfloat16).double()
    z = n * s.double() + b.double()
    dz = dy.double()
    dz = torch.where(z >= 0, dz, dz * slope)
    g = (dz * s.double()).to(torch.bfloat16).double()
    return inv * (g - g.mean((1, 2), keepdim=True)
                  - xhat * (g * xhat).mean((1, 2), keepdim=True))


def phase_norm_bwd_r3(train16):
    from renderloom_torch.ops import norm_kernel as NK

    bwd = train16[True]["bwd"]
    print(f"B2. K2b r3centered, kernel vs plain twin, at the {len(bwd)} "
          f"shapes of one full-width bf16 training step (phase T):")
    for what, seen, want in (
            ("K2b r3centered per step", bwd, R3_STEP_BWD_CALLS),
            ("K2 r3centered per step", train16[True]["fwd"],
             R3_STEP_FWD_CALLS)):
        _hold_r3_calls(what, Counter({k[:3]: n for k, n in seen.items()}),
                       want)
    by_size = lambda d: sorted(d.items(), key=lambda kv: -np.prod(kv[0][0]))
    bwd_entry = _sum_shapes(
        "K2b r3centered", "step", by_size(bwd),
        lambda i, key: _bwd_r3_inputs(key[0], key[1], 800 + i) + (key[2],),
        lambda x, dy, s, b, slope: _bwd_r3_check("vs twin", x, dy, s, b,
                                                 slope),
        _bwd_r3_times, "library composition backward")
    bwd_entry["shape"] = (f"{sum(bwd.values())} calls over {len(bwd)} "
                          f"shapes, summed per bf16 step (do_checkpoint on)")
    # two calls at the largest shape give the same bits
    x, dy, s, b = _bwd_r3_inputs((4, 320, 480, 32), True, 850)
    stats = torch.empty((4, 32, 3), device="cuda")
    NK.instance_norm_cuda(x, s, b, LEAKY, 1e-5, stats, r3centered=True)
    one, two = (NK.instance_norm_bwd_cuda(x, dy, stats, s, b, LEAKY,
                                          r3centered=True)
                for _ in range(2))
    if not all(torch.equal(u, v) for u, v in zip(one, two)):
        raise AssertionError("K2b r3centered: two calls differ")
    print("  determinism: two calls at (4, 320, 480, 32) equal bit for bit "
          "(dx, dgamma, dbeta) ok")
    for i, (shape, affine) in enumerate(R3_CLUSTER_SHAPES):
        x, dy, s, b = _bwd_r3_inputs(shape, affine, 853 + i)
        p = r3_plan(shape, True, affine)
        stats = torch.empty((shape[0], shape[-1], 3), device="cuda")
        NK.instance_norm_cuda(x, s, b, LEAKY, 1e-5, stats, r3centered=True)
        one, two = (NK.instance_norm_bwd_cuda(x, dy, stats, s, b, LEAKY,
                                              r3centered=True)
                    for _ in range(2))
        if p["path"] != "cluster" or not all(
                torch.equal(u, v) for u, v in zip(one, two)):
            raise AssertionError(f"K2b r3centered {shape}: two calls differ "
                                 f"or not on the cluster path ({p})")
        # dgamma and dbeta: the slabs' sums, left in the workspace's
        # table, added in batch order
        B, C = shape[0], shape[-1]
        table = NK._work[(0, NK._stream(0))][4:4 + B * 2 * C].view(B, 2, C)
        dbeta, dgamma = NK.batch_order_sums(table)
        if not (torch.equal(dbeta, two[2]) and torch.equal(dgamma, two[1])):
            raise AssertionError(f"K2b r3centered {shape}: dgamma/dbeta are "
                                 f"not the batch-order sums of the slabs")
        print(f"  determinism: two calls at {shape} (cluster path, "
              f"{p['cluster']} blocks a cluster) equal bit for bit (dx, "
              f"dgamma, dbeta); dgamma and dbeta bit for bit the slabs' sums "
              f"added in batch order ok")
    # mean 256, std 1: the edge of the unshifted contract (phase R)
    x, dy, s, b = _bwd_r3_inputs((4, 40, 60, 256), True, 851, loc=256.0)
    stats = torch.empty((4, 256, 3), device="cuda")
    NK.instance_norm_cuda(x, s, b, LEAKY, 1e-5, stats, r3centered=True)
    got = NK.instance_norm_bwd_cuda(x, dy, stats, s, b, LEAKY,
                                    r3centered=True)[0]
    _, tstats = NK._plain_r3_forward(x, s, b, LEAKY, 1e-5)
    twin = NK.instance_norm_bwd_plain(x, dy, tstats, s, b, LEAKY,
                                      r3centered=True)[0]
    ref = _bwd_r3_f64(x, dy, s, b, LEAKY)
    e_k = (got.double() - ref).abs().max().item()
    e_t = (twin.double() - ref).abs().max().item()
    ulp = 2.0 ** -7 * ref.abs().max().item()
    print(f"  (4, 40, 60, 256) bfloat16 mean 256 std 1, affine + leaky: dx "
          f"against the contract in float64: kernel {e_k:.3e}, twin "
          f"{e_t:.3e} (held: kernel <= 1.5 x twin + {ulp:.2e})")
    if not e_k <= 1.5 * e_t + ulp:
        raise AssertionError(f"K2b r3centered at mean 256: kernel {e_k}, "
                             f"twin {e_t}")
    host = {}
    for shape, affine in R3_HOST_SHAPES:
        x, dy, s, b = _bwd_r3_inputs(shape, affine, 852)
        slope = LEAKY if affine else None
        stats = torch.empty((shape[0], shape[-1], 3), device="cuda")
        NK.instance_norm_cuda(x, s, b, slope, 1e-5, stats, r3centered=True)
        host[str(shape)] = host_us(lambda: NK.instance_norm_bwd_cuda(
            x, dy, stats, s, b, slope, r3centered=True))
        print(f"  host time per call at {shape} (affine={affine}): "
              f"{host[str(shape)]:.1f} us")
    bwd_entry["host_us"] = host
    bwd_entry["paths"] = dict(Counter(
        r3_plan(k[0], True, k[1])["path"] for k, n in bwd.items()
        for _ in range(n)))
    print(f"  K2b r3centered paths per step: {bwd_entry['paths']}")

    fwd = train16[True]["fwd"]
    print(f"  K2 r3centered with residuals at the step's {len(fwd)} forward "
          f"shapes (kernel vs twin):")
    fwd_entry = _sum_shapes(
        "K2 r3centered (training)", "step", by_size(fwd),
        lambda i, key: _norm_inputs(key[0], torch.bfloat16, key[1],
                                    seed=900 + i) + (key[2],),
        lambda x, s, b, slope: _r3_res_check("vs twin", x, s, b, slope),
        lambda x, s, b, slope: _r3_times(x, s, b, slope, 5, True),
        "library composition")
    fwd_entry["shape"] = (f"{sum(fwd.values())} calls over {len(fwd)} "
                          f"shapes, summed per bf16 step (do_checkpoint on)")
    fwd_entry["paths"] = dict(Counter(
        r3_plan(k[0], False, k[1])["path"] for k, n in fwd.items()
        for _ in range(n)))
    print(f"  K2 r3centered (training) paths per step: {fwd_entry['paths']}")
    return fwd_entry, bwd_entry


# ---------------------------------------------------------------------------
# D2. card bf16 training step vs CPU bf16 training step
# ---------------------------------------------------------------------------

# bf16 on two devices rounds at other places (cuDNN, the kernels' sums),
# and the random-weight networks amplify it (tests/test_torch_train_step.py:
# JAX's own bf16 step lies a median 0.26 of each G parameter's largest
# gradient from its float32 step).  So the card is held by mean errors,
# each normalized as the CPU tests normalize them: the metrics by the CPU
# float32 step's (mean over the metrics of |card − CPU bf16| / |CPU f32|),
# the gradients of the first frame leaf by leaf by the CPU float32
# gradient's largest |g| (mean over all elements of the leaves whose
# float32 gradient is above 1e-4 of the network's largest).  Each limit
# lies between the sound reading and a control, the card's bf16 step
# against the CPU float32 step, which is printed each run and must lie
# beyond it.  Readings on an NVIDIA H100 80GB HBM3 at 700 W: metrics
# 3.59e-4 (control 4.97e-3), G 1.91e-2 (3.23e-2), D 1.12e-2 (4.48e-2);
# the limits lie 1.3–2.8x above the readings and 1.3–5x below the
# controls.
TRAIN16_MEAN_TOL = {"metrics": 1e-3, "g": 2.5e-2, "d": 2e-2}


def _grad_mean_err(got, want, ref) -> float:
    """Mean |got − want| over the leaves whose ``ref`` gradient is above
    1e-4 of the network's largest, each leaf over its own largest
    |ref|."""
    top = max(g.abs().max().item() for g in ref.values())
    errs = [((got[n] - want[n]).abs() / ref[n].abs().max()).reshape(-1)
            for n in ref if ref[n].abs().max().item() >= 1e-4 * top]
    return torch.cat(errs).mean().item()


def phase_train_bf16_cpu_match():
    cfg32, cfg16 = _tiny_train_cfg(), _tiny_train_cfg("bfloat16")
    H, W = cfg16.data.model_height, cfg16.data.model_width
    (m32, g32), (m16, g16), (mgpu, ggpu) = (
        _tiny_step(cfg32, "cpu"), _tiny_step(cfg16, "cpu"),
        _tiny_step(cfg16, "cuda"))
    print(f"D2. card bf16 training step vs CPU bf16 training step ({W}x{H}, "
          f"B {cfg16.batch_size}, L {cfg16.data.max_frames}, tiny widths, "
          f"same weights and draws):")
    keys = [k for k in m32 if not k.startswith("notfinite")]
    rel = lambda m, k: abs(m[k] - m16[k]) / max(abs(m32[k]), 1e-6)
    if any(mgpu[k] for k in m32 if k.startswith("notfinite")):
        raise AssertionError("an update was skipped as non-finite")
    readings = {
        "metrics": (np.mean([rel(mgpu, k) for k in keys]),
                    np.mean([abs(mgpu[k] - m32[k]) / max(abs(m32[k]), 1e-6)
                             for k in keys]))}
    for net in ("g", "d"):
        readings[net] = (_grad_mean_err(ggpu[net], g16[net], g32[net]),
                         _grad_mean_err(ggpu[net], g32[net], g32[net]))
    bad = []
    for what, (sound, control) in readings.items():
        tol = TRAIN16_MEAN_TOL[what]
        ok = sound <= tol < control
        print(f"  {what}: mean error card vs CPU bf16 {sound:.4e} (limit "
              f"{tol:.1e}); control, card vs CPU float32 {control:.4e} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(what)
    if bad:
        raise AssertionError(f"D2: {bad} beyond the limit, or the control "
                             f"within it")


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# W. renderer training from HumanSloMo windows through the CLI's loop
# ---------------------------------------------------------------------------

# two train clips of 7 frames: 8 windows of 4 frames (2 steps of B = 4),
# then 6 windows of 5 frames (1 step); a 9-frame test clip (eval_frames 4)
W_TRAIN = {"train_a": 7, "train_b": 7}
W_TEST = {"test_a": 9}
W_EPOCHS = 4


def _array_hsm_reader(clips: dict, video_list, phase: str = "train",
                      max_frames: int = 4):
    """``HsmReader`` over clips held in memory (``image``, ``dain`` —
    one row fewer in the train phase, row i − 1 being frame i's, as in
    the h5 — and ``pose``): the reader where ``h5py`` is missing, its
    windows those ``HsmReader`` reads from the same clips in an h5."""
    from renderloom_torch.data.hsm import HsmReader

    class ArrayHsmReader(HsmReader):
        def __init__(self, clips, video_list, phase="train", max_frames=4):
            # ``set_max_frames`` passes ``h5_path`` back in: the clips
            self.h5_path = clips
            self.phase, self.max_frames = phase, max_frames
            self.video_list = list(video_list)
            self.n_frames, self.samples = {}, []
            for vid in self.video_list:
                if vid in clips:
                    n = len(clips[vid]["image"])
                    self.n_frames[vid] = n
                    self.samples += [(vid, s) for s in
                                     range(max(n - max_frames + 1, 0))]
            self._file = None

        def read_window(self, vid, start):
            c = self.h5_path[vid]
            end = start + self.max_frames
            dain = np.zeros_like(c["image"][start:end])
            for j, i in enumerate(range(start, end)):
                if i > 0:
                    dain[j] = c["dain"][i - 1]
            return {"images": c["image"][start:end], "dain": dain,
                    "poses": c["pose"][start:end].astype(np.float32)}

        def read_test_frame(self, vid, index):
            c = self.h5_path[vid]
            return {"image": c["image"][index], "dain": c["dain"][index],
                    "pose": c["pose"][index]}

    return ArrayHsmReader(clips, video_list, phase, max_frames)


def _train_h5_of(path: str, clips: dict) -> str:
    """Train clips as a HumanSloMo h5 (``train_images``, ``train_dain``
    with one row fewer, ``train_poses``)."""
    import io

    import h5py
    from PIL import Image

    def png(img):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        return np.frombuffer(buf.getvalue(), np.uint8)

    with h5py.File(path, "w") as f:
        for name, c in clips.items():
            grp = f.create_group(name)
            for key in ("images", "dain"):
                rows = c["image" if key == "images" else "dain"]
                ds = grp.create_dataset(f"train_{key}", (len(rows),),
                                        dtype=h5py.vlen_dtype(np.uint8))
                for i, img in enumerate(rows):
                    ds[i] = png(img)
            grp.create_dataset("train_poses",
                               data=c["pose"].astype(np.float64))
    return path


def _vgg19_pth(path: str) -> str:
    """A torchvision ``vgg19().features`` state dict of seeded random
    values at the real shapes (lecun-scaled), saved as a ``.pth``."""
    from renderloom_torch.models.perceptual import TORCHVISION_CONV_IDX

    g = torch.Generator().manual_seed(19)
    state, ch = {}, 3
    for name, idx in TORCHVISION_CONV_IDX.items():
        out = (64, 128, 256, 512, 512)[int(name.split("_")[1]) - 1]
        state[f"features.{idx}.weight"] = torch.randn(
            out, ch, 3, 3, generator=g) / (9 * ch) ** 0.5
        state[f"features.{idx}.bias"] = 0.1 * torch.randn(out, generator=g)
        ch = out
    torch.save(state, path)
    return path


def _jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def _hold_step_norms(tag, fwd: Counter, bwd: Counter, bf16: bool) -> float:
    """K2 (with residuals) and K2b, or their r3centered modes, against
    their twins at every (shape, affine, slope) a training run recorded;
    the largest error."""
    err = 0.0
    for i, key in enumerate(sorted(fwd, key=lambda k: -np.prod(k[0]))):
        dtype = torch.bfloat16 if bf16 else torch.float32
        x, s, b = _norm_inputs(key[0], dtype, key[1], seed=1000 + i)
        check = _r3_res_check if bf16 else _norm_check
        err = max(err, check(f"{tag} K2 {key[:3]}", x, s, b, key[2]))
    for i, key in enumerate(sorted(bwd, key=lambda k: -np.prod(k[0]))):
        inputs = _bwd_r3_inputs if bf16 else _bwd_inputs
        x, dy, s, b = inputs(key[0], key[1], 1100 + i)
        check = _bwd_r3_check if bf16 else _bwd_check
        err = max(err, check(f"{tag} K2b {key[:3]}", x, dy, s, b, key[2]))
    return err


def phase_train_h5(probe):
    """The renderer CLI's epoch loop (``train_renderer.train``) at full
    width over HumanSloMo windows, in float32 and bf16."""
    import dataclasses

    from renderloom_torch.cli import train_renderer as TR
    from renderloom_torch.convert import flax_trees
    from renderloom_torch.core.checkpoint import read_renderer
    from renderloom_torch.train.gan import make_inference_generator

    real = _skip_line("W", "h5 file", [m for m in ("h5py", "PIL")
                                       if not probe[m]])
    work = os.path.join(ROOT, "build", "chip_smoke_w")
    os.makedirs(work, exist_ok=True)
    base = _train_cfg()
    H, W = base.data.model_height, base.data.model_width
    B = base.batch_size
    print(f"W. renderer training through the CLI's loop: hsm.yaml at "
          f"{W}x{H}, batch {B}, {W_EPOCHS} epochs over {W_TRAIN} "
          f"(update_frame_step 2: 4-frame windows, then 5), evaluate_h5 "
          f"on {W_TEST} with LPIPS after epoch 4, VGG19 from a .pth of "
          f"random values at the real shapes; reader: "
          + ("HsmReader over an h5 written here" if real else
             "in-memory HsmReader (read_window, read_test_frame)"))
    train_clips = {k: dict(v, dain=v["dain"][1:]) for k, v in _eval_clips(
        W_TRAIN, H, W, seed=40).items()}
    test_clips = _eval_clips(W_TEST, H, W, seed=41)
    if real:
        from renderloom_torch.data.hsm import HsmReader

        path = _train_h5_of(os.path.join(work, "train.h5"), train_clips)
        test_path = _h5_of(os.path.join(work, "test.h5"), test_clips)
        readers = lambda: (HsmReader(path, list(W_TRAIN), "train", 4),
                           HsmReader(test_path, list(W_TEST), "test", 4))
    else:
        readers = lambda: (_array_hsm_reader(train_clips, list(W_TRAIN)),
                           _array_hsm_reader(test_clips, list(W_TEST),
                                             "test"))
    vgg = _vgg19_pth(os.path.join(work, "vgg19_random.pth"))
    saved = (os.environ.get("VGG19_NPZ"), TR.TRAIN_LOG_EVERY)
    os.environ["VGG19_NPZ"] = vgg
    TR.TRAIN_LOG_EVERY = 1
    out = {}
    try:
        for tag, dtype in (("train_h5", "float32"),
                           ("train_h5_bf16", "bfloat16")):
            cfg = dataclasses.replace(base, compute_dtype=dtype,
                                      data=dataclasses.replace(
                base.data, update_frame_step=2, eval_frames=4,
                train_video_list=tuple(W_TRAIN),
                test_video_list=tuple(W_TEST)))
            cfg_path = _yaml_cfg(os.path.join(work, f"{tag}.yaml"), cfg)
            run_dir = os.path.join(work, tag)
            if os.path.isdir(run_dir):
                import shutil
                shutil.rmtree(run_dir)
            argv = ["--config", cfg_path, "--device", DEVICE, "--seed", "0",
                    "--out-dir", run_dir]
            _reset_launches()
            calls, fwd, bwd = [], Counter(), Counter()
            restore_k1 = _raster_recorder(calls)
            restore_norms = _norm_call_recorder(fwd, bwd)
            tic = time.perf_counter()
            try:
                res = TR.train(TR.parse_args(argv + ["--epochs",
                                                     str(W_EPOCHS)]),
                               *readers())
                torch.cuda.synchronize()
            finally:
                restore_norms()
                restore_k1()
            total = time.perf_counter() - tic
            launches = _train_launches()
            state, hist = res["state"], res["epochs"]
            # derived: each step's counts at its window length, plus the
            # evaluation's K1 (deterministic tables, masks) and one
            # generator step (the 4 segments of the 9-frame clip at once)
            want = Counter()
            for e in hist:
                per = derived_train_launches(cfg, state.gen, state.dis,
                                             e["frames"] - 2)
                for k, v in per.items():
                    want[k] += e["steps"] * v
            per_eval = _count_norms(make_inference_generator(cfg))
            want["rasterize"] += 1
            want["instance_norm_r3" if dtype == "bfloat16"
                 else "instance_norm"] += per_eval
            if dtype != "bfloat16":         # float32 inference: fused
                want["upconv"] += _count_upconvs(
                    make_inference_generator(cfg))
            want = {k: want[k] for k in launches}
            frames = [c[0][0].shape[0] for c in calls]
            masks = {c[0][6] for c in calls}
            steps = [e["steps"] for e in hist]
            print(f"  {tag}: launches {launches}; derived {want}; K1 frames "
                  f"per call {frames} (masks {sorted(masks)})")
            want_frames = ([B * 4] * (steps[0] + steps[1])
                           + [B * 5] * (steps[2] + steps[3])
                           + [W_TEST["test_a"]])
            if launches != want or frames != want_frames or masks != {True}:
                raise AssertionError(f"{tag}: kernel launches {launches}, "
                                     f"K1 frames {frames}")
            lines = _jsonl(os.path.join(run_dir, "metrics.jsonl"))
            train_rec = [r for r in lines if "train/g/total" in r]
            eval_rec = [r for r in lines if "eval/OURS_PSNR" in r]
            if [r["step"] for r in train_rec] != list(
                    range(1, sum(steps) + 1)) or len(eval_rec) != 1:
                raise AssertionError(f"{tag}: metrics.jsonl records "
                                     f"{[r['step'] for r in lines]}")
            for r in lines:
                if not all(np.isfinite(v) for v in r.values()) or r.get(
                        "train/notfinite/g", 0) or r.get(
                        "train/notfinite/d", 0):
                    raise AssertionError(f"{tag}: record {r}")
            print("    last train record: " + ", ".join(
                f"{k[6:]} {v:.4g}" for k, v in train_rec[-1].items()
                if k.startswith("train/")))
            print("    eval record: " + ", ".join(
                f"{k[5:]} {v:.5f}" for k, v in eval_rec[0].items()
                if k.startswith("eval/")))
            for e in hist:
                wps = e["steps"] * B / e["seconds"]
                print(f"    epoch {e['epoch']}: {e['frames']}-frame windows, "
                      f"{e['steps']} steps in {e['seconds']:.3f} s, "
                      f"{wps:.3f} windows/s, waiting on the prefetcher "
                      f"{100 * e['wait_seconds'] / e['seconds']:.2f}% of "
                      f"the loop" + (f"; evaluate_h5 "
                                     f"{e['eval_seconds']:.3f} s"
                                     if "eval_seconds" in e else ""))
            # the checkpoint reads back as the generator's trees
            params, _ = read_renderer(os.path.join(run_dir, "checkpoint.pt"))
            mine = flax_trees(state.gen)[0]
            if params.keys() != mine.keys() or not np.array_equal(
                    params["conv_img"]["conv"]["kernel"],
                    mine["conv_img"]["conv"]["kernel"]):
                raise AssertionError(f"{tag}: checkpoint does not read back")
            # the kernels at the shapes this run gave them
            err = 0.0
            for i, c in enumerate(calls):
                if frames[i] in (B * 5, W_TEST["test_a"]) and (
                        i == 0 or frames[i - 1] != frames[i]):
                    err = max(err, _k1_check(
                        f"{tag} K1 {frames[i]} frames", c[0][:3], H, W,
                        c[0][5], c[0][6], c[1]["layout"])[0])
            err = max(err, _hold_step_norms(tag, fwd, bwd,
                                            dtype == "bfloat16"))
            out[tag] = dict(launches=launches, seconds=total, epochs=hist,
                            steps=sum(steps), max_abs_err=err)
            if dtype == "float32":
                before = state.step
                again = TR.train(TR.parse_args(
                    argv + ["--epochs", str(W_EPOCHS), "--resume"]),
                    *readers())
                new = [r["step"] for r in _jsonl(os.path.join(
                    run_dir, "metrics.jsonl")) if "train/g/total" in r]
                print(f"    --resume: continued from step {before} to "
                      f"{again['state'].step} (epochs "
                      f"{[e['epoch'] for e in again['epochs']]})")
                if new[len(train_rec)] != before + 1 or \
                        again["state"].step <= before:
                    raise AssertionError("resume did not continue")
            print(f"    {tag}: {total:.1f} s for the run")
    finally:
        if saved[0] is None:
            os.environ.pop("VGG19_NPZ", None)
        else:
            os.environ["VGG19_NPZ"] = saved[0]
        TR.TRAIN_LOG_EVERY = saved[1]
    print(f"  ({card_line()})")
    return out


# ---------------------------------------------------------------------------
# M. motion training at full width
# ---------------------------------------------------------------------------

M_WARMUP, M_STEPS = 3, 20          # bench.py:bench_motion_train's


def _amass_reader(motions: dict, splits):
    """``AmassReader`` over (T, 52, 3) joint arrays held in memory,
    ``{group: {motion: array}}``: the reader where ``h5py`` is
    missing."""
    from renderloom_torch.data.amass import AmassReader

    class ArrayAmassReader(AmassReader):
        def __init__(self, motions, splits):
            self.h5_path, self.splits = None, tuple(splits)
            self.motions = motions
            self.samples = [(g, m) for g in splits if g in motions
                            for m in motions[g]]
            self._file = None

        def read_motion(self, dataset_key, motion_key):
            data = self.motions[dataset_key][motion_key]
            return np.ascontiguousarray(data.transpose(1, 2, 0),
                                        dtype=np.float32)

    return ArrayAmassReader(motions, splits)


def _amass_motions(groups: dict, seed: int) -> dict:
    """Smooth random (T, 52, 3) joint paths around a standing body."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, lengths in groups.items():
        out[name] = {}
        for i, T in enumerate(lengths):
            base = rng.normal(0, 0.3, (1, 52, 3))
            base[:, [1, 16], 0] -= 0.3
            base[:, [2, 17], 0] += 0.3
            t = np.linspace(0, 4 * np.pi, T)[:, None, None]
            out[name][f"m{i}"] = base + 0.1 * np.sin(
                t + rng.uniform(0, 6, (1, 52, 3)))
    return out


def phase_motion_train():
    import dataclasses

    from renderloom_torch.cli import train_motion as TMC
    from renderloom_torch.core.checkpoint import read_params
    from renderloom_torch.core.config import load_motion_config
    from renderloom_torch.train.motion import (create_motion_state,
                                               make_train_step)

    cfg0 = load_motion_config(os.path.join(ROOT, "configs", "motion.yaml"))
    B, L = cfg0.batch_size, cfg0.dataset.max_seq_length
    t = cfg0.transformer
    print(f"M. motion training at full width (motion.yaml: B {B}, L {L}, "
          f"hidden {t.hidden_dim}, {t.enc_layers}+{t.dec_layers} layers, "
          f"dropout {t.dropout}), bench_motion_train's inputs: "
          f"{M_WARMUP} warm-up and {M_STEPS} timed steps")
    rng = np.random.default_rng(0)
    batch = {"motion3d": torch.from_numpy(rng.normal(
                 0, 0.3, (B, 52, 3, L)).astype(np.float32)).to(DEVICE),
             "pad_mask": torch.zeros((B, L), dtype=torch.bool).to(DEVICE)}
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(cfg0, compute_dtype=dtype)
        state = create_motion_state(cfg, DEVICE, seed=0)
        step = make_train_step(cfg, np.zeros((19, 2), np.float32),
                               np.ones((19, 2), np.float32))
        before = state.opt.flat.clone()
        for _ in range(M_WARMUP):
            metrics = step(state, batch)
        float(metrics["loss/total"])
        torch.cuda.reset_peak_memory_stats()
        tic = time.perf_counter()
        for _ in range(M_STEPS):
            metrics = step(state, batch)
        float(metrics["loss/total"])
        wall = time.perf_counter() - tic
        sps = M_STEPS * B / wall
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        vals = {k: float(v) for k, v in metrics.items()}
        moved = (state.opt.flat != before).float().mean().item()
        prof = _profile(step, (state, batch))
        _write(f"motion_profile_{dtype}.txt", prof)
        idle = _idle_share(prof)
        print(f"  {dtype}: motion_train_seqs_per_sec {sps:.2f} ({M_STEPS} "
              f"steps in {wall * 1e3:.1f} ms, {wall / M_STEPS * 1e3:.2f} ms "
              f"a step); peak memory {peak:.3f} GiB; idle share of a "
              f"profiled step {idle:.1f}%; {100 * moved:.2f}% of the "
              f"parameters moved; last metrics " + ", ".join(
                  f"{k} {v:.5g}" for k, v in vals.items()))
        print("    " + "\n    ".join(prof.splitlines()[:8]))
        if not all(np.isfinite(v) for v in vals.values()) or \
                vals["notfinite"] or moved == 0:
            raise AssertionError(f"motion {dtype}: metrics {vals}, moved "
                                 f"{moved}")
        out[dtype] = dict(seqs_per_sec=sps, peak_gib=peak, idle=idle,
                          step_ms=wall / M_STEPS * 1e3)
    print(f"  ({card_line()})")

    # the CLI's loop over an in-memory AMASS split: short clips padded,
    # long ones cropped; statistics computed; one evaluation
    work = os.path.join(ROOT, "build", "chip_smoke_m")
    if os.path.isdir(work):
        import shutil
        shutil.rmtree(work)
    lengths = [120, 200, 321, 400, 650, 90, 333, 500] * 4
    motions = _amass_motions({"CMU": lengths, "HumanEva": (150, 400, 321,
                                                           260, 77, 500,
                                                           180, 340)},
                             seed=7)
    cfg = dataclasses.replace(cfg0, eval_step=1, dataset=dataclasses.replace(
        cfg0.dataset, data_root=os.path.join(work, "data")))
    cfg_path = _yaml_cfg(os.path.join(ROOT, "build",
                                      "chip_smoke_motion.yaml"), cfg)
    saved = TMC.TRAIN_LOG_EVERY
    TMC.TRAIN_LOG_EVERY = 1
    tic = time.perf_counter()
    try:
        res = TMC.train(TMC.parse_args(
            ["--config", cfg_path, "--device", DEVICE, "--epochs", "1",
             "--out-dir", os.path.join(work, "run")]),
            _amass_reader(motions, cfg.dataset.train_split),
            _amass_reader(motions, cfg.dataset.test_split))
        torch.cuda.synchronize()
    finally:
        TMC.TRAIN_LOG_EVERY = saved
    total = time.perf_counter() - tic
    (epoch,) = res["epochs"]
    lines = _jsonl(os.path.join(work, "run", "metrics.jsonl"))
    ev = [r for r in lines if "eval/mse_global" in r]
    tr = [r for r in lines if "train/loss/total" in r]
    print(f"  CLI loop, float32: {len(lengths)} train clips "
          f"({sum(n < L for n in lengths)} padded), 8 test clips: "
          f"{epoch['steps']} steps in {epoch['seconds']:.3f} s (waiting "
          f"{100 * epoch['wait_seconds'] / epoch['seconds']:.2f}%), "
          f"evaluation {epoch['eval_seconds']:.3f} s, the whole run with "
          f"compute_stats {total:.2f} s")
    print("    eval: " + ", ".join(f"{k[5:]} {v:.6g}" for k, v in
                                   ev[0].items() if k.startswith("eval/")))
    params = read_params(os.path.join(work, "run", "checkpoint.pt"))
    if len(ev) != 1 or len(tr) != epoch["steps"] or not all(
            np.isfinite(v) for r in lines for v in r.values()) or \
            set(params) != {n.split(".")[0] for n, _ in
                            res["state"].model.named_parameters()}:
        raise AssertionError(f"motion CLI loop: records {lines}")
    out["cli"] = dict(seconds=total, eval_seconds=epoch["eval_seconds"],
                      eval=ev[0])
    return out


# ---------------------------------------------------------------------------
# M2. card motion step vs CPU motion step
# ---------------------------------------------------------------------------

# float32: the losses and grad_norm of 3 steps to 1e-5 relative, the
# parameters after them to 1e-6 but for elements AMSGrad moves by up to
# lr either way (a clipped gradient near its eps; the k-projection
# biases, whose gradient is rounding noise: tests/test_torch_motion_
# train.py), whose share is held under 1% and their error under 2·lr.
# bf16: mean relative error of the metrics and of the first step's
# gradients (each over its leaf's float32 largest) against the CPU bf16
# step, with the card bf16 step against the CPU float32 step as the
# control that must read beyond each limit (as D2).  Reading on an
# NVIDIA H100 80GB HBM3 at 700 W: 0 and 2.9e-9 (at these widths the
# bf16 products round the same on both devices), the control 1.5e-3 and
# 1.3e-3; the limits leave a card that rounds otherwise room, a tenth of
# the control's reading.
MOTION_MATCH_RTOL = 1e-5
MOTION16_MEAN_TOL = {"metrics": 1e-4, "grads": 1e-4}


def _tiny_motion_case():
    from renderloom_torch.convert import flax_trees
    from renderloom_torch.core import config as C
    from renderloom_torch.ops import pose as P
    from renderloom_torch.train.motion import create_motion_state

    cfg = C.MotionConfig(
        transformer=C.TransformerConfig(hidden_dim=32, nheads=4,
                                        dim_feedforward=64, enc_layers=2,
                                        dec_layers=2, dropout=0.0),
        pos_encode=C.PosEncodeConfig(hidden_dim=32),
        dataset=C.MotionDatasetConfig(max_seq_length=33, train_sample_rate=8,
                                      train_sample_size=8, noise_rate=2,
                                      joint_drop_rate=2, flip_rate=1))
    params = flax_trees(create_motion_state(cfg, "cpu", seed=9).model)[0]
    motions = _amass_motions({"x": (33, 33)}, seed=8)["x"]
    raw = {"motion3d": torch.from_numpy(np.stack(
               [m.transpose(1, 2, 0) for m in motions.values()]).astype(
                   np.float32)),
           "pad_mask": torch.zeros((2, 33), dtype=torch.bool)}
    raw["pad_mask"][1, 25:] = True
    g = torch.Generator().manual_seed(10)
    draws = [P.draw_synthesis(g, 2, 33, P.synthesis_params(cfg.dataset))
             for _ in range(3)]
    rng = np.random.default_rng(11)
    stats = (rng.normal(scale=0.1, size=(19, 2)).astype(np.float32),
             rng.uniform(0.2, 1.0, (19, 2)).astype(np.float32))
    return cfg, params, raw, draws, stats


def _tiny_motion_run(case, device, dtype="float32"):
    import dataclasses

    from renderloom_torch.convert import flax_trees
    from renderloom_torch.train.motion import (create_motion_state,
                                               make_train_step)

    cfg, params, raw, draws, (mean, std) = case
    cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    state = create_motion_state(cfg, device, params=params)
    step = make_train_step(cfg, mean, std)
    names = [n for n, _ in state.model.named_parameters()]
    grads = {}

    def record(gs, opt=state.opt):
        if not grads:
            grads.update({n: g.detach().float().cpu()
                          for n, g in zip(names, gs)})
        return type(opt).step(opt, gs)

    state.opt.step = record
    batch = {k: v.to(device) for k, v in raw.items()}
    metrics = [{k: float(v) for k, v in step(state, batch, d).items()}
               for d in draws]
    return metrics, grads, flax_trees(state.model)[0], state.opt


def _flat_leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def phase_motion_cpu_match():
    case = _tiny_motion_case()
    cfg = case[0]
    lr = cfg.optim.lr
    print("M2. card motion step vs CPU motion step (hidden 32, 2+2 layers, "
          "L 33, B 2, dropout 0, same weights and draws):")
    m_cpu, g_cpu, p_cpu, _ = _tiny_motion_run(case, "cpu")
    m_gpu, g_gpu, p_gpu, _ = _tiny_motion_run(case, DEVICE)
    err = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(m_gpu, m_cpu)
              for k in b if k != "notfinite")
    big, worst, n = 0, 0.0, 0
    for (k, a), (_, b) in zip(_flat_leaves(p_gpu), _flat_leaves(p_cpu)):
        d = np.abs(a - b)
        big += int((d > 1e-6).sum())
        n += d.size
        worst = max(worst, float(d.max()))
    print(f"  float32, 3 steps: losses and grad_norm largest relative error "
          f"{err:.3e} (tol {MOTION_MATCH_RTOL:.0e}); parameters: "
          f"{big}/{n} elements beyond 1e-6, the largest {worst:.3e} (held: "
          f"share < 1%, largest <= 2 lr = {2 * lr:.1e})")
    if not (err <= MOTION_MATCH_RTOL and big < 0.01 * n
            and worst <= 2 * lr):
        raise AssertionError("M2 float32: card vs CPU out of bounds")

    m16c, g16c, _, _ = _tiny_motion_run(case, "cpu", "bfloat16")
    m16g, g16g, _, opt = _tiny_motion_run(case, DEVICE, "bfloat16")
    if opt.flat.dtype != torch.float32 or m16g[0]["notfinite"]:
        raise AssertionError("M2 bf16: parameters or update")
    keys = [k for k in m_cpu[0] if k != "notfinite"]
    mrel = lambda a, b: np.mean([abs(a[k] - b[k]) / abs(m_cpu[0][k])
                                 for k in keys])
    top = {k: v.abs().max().item() for k, v in g_cpu.items()}
    gerr = lambda a, b: np.mean(np.concatenate([
        ((a[k] - b[k]).abs() / top[k]).flatten().numpy()
        for k in a if top[k] > 0 and not k.endswith("k_proj.bias")]))
    readings = {"metrics": (mrel(m16g[0], m16c[0]), mrel(m16g[0], m_cpu[0])),
                "grads": (gerr(g16g, g16c), gerr(g16g, g_cpu))}
    bad = []
    for what, (sound, control) in readings.items():
        tol = MOTION16_MEAN_TOL[what]
        ok = sound <= tol < control
        print(f"  bf16 {what}: mean error card vs CPU bf16 {sound:.4e} "
              f"(limit {tol:.1e}); control, card bf16 vs CPU float32 "
              f"{control:.4e} {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(what)
    if bad:
        raise AssertionError(f"M2: {bad} beyond the limit, or the control "
                             f"within it")
    return dict(rel_err=err, params_beyond=big, bf16=readings)


# ---------------------------------------------------------------------------
# probe: the host packages of the file layer
# ---------------------------------------------------------------------------

HOST_PACKAGES = ("PIL", "h5py", "imageio")
# the device the file phases (V, Q) drive; a rehearsal on the CPU sets
# it to "cpu" with counting fakes in place of the kernel wrappers
DEVICE = "cuda"


def phase_probe() -> dict:
    """Which of the file layer's host packages import, whether ``g++`` is
    on PATH, and which image decoder runs: the port's C++ decoder where
    it builds (``g++`` and the libpng/libjpeg headers), else PIL.  Each
    file phase decides what it runs from this, never by catching a
    failure."""
    import importlib.util
    import shutil

    from renderloom_torch import native

    have = {m: importlib.util.find_spec(m) is not None
            for m in HOST_PACKAGES}
    gxx = shutil.which("g++")
    decoder = native.native_available()
    print("probe: " + ", ".join(f"{m} {'imports' if ok else 'missing'}"
                                for m, ok in have.items())
          + f"; g++ {gxx or 'missing'}; native decoder "
          + ("built" if decoder else "not built (PIL decodes)"))
    return dict(have, gxx=bool(gxx), native_decoder=decoder)


def _skip_line(phase: str, part: str, missing) -> bool:
    """Print the line of a part that a missing host package keeps from
    running; True where it runs."""
    if missing:
        print(f"phase {phase} {part}: not run, {', '.join(missing)} "
              f"missing")
    return not missing


# ---------------------------------------------------------------------------
# V. serving from files
# ---------------------------------------------------------------------------

# The CLI's Predict_motion joints against the library motion stage
# (MotionInterpolator._run on the same keyframes and weights, as phase 4
# runs it), in pixels (openpose_scale 512).  The keyframe joints reach
# the CLI through JSON unchanged (x·512 + 256 is exact in float64 for a
# float32 x), so the two runs are the same computation on the same card
# but for the hand rows, read back as the mean of 21 copies.  Reading on
# an NVIDIA H100 80GB HBM3 at 700 W: 0 px in float32 and in bf16; the
# limit is the CPU tests' (tests/test_torch_infer_cli.py).
MOTION_PX_TOL = 1e-3
# The card's pipeline CLI against the CPU's at 64x96 (tiny widths, same
# checkpoints and files), in PNG levels: the largest |card - CPU| and the
# share of values not equal.  Card and CPU differ by float32 rounding
# (cuDNN and the kernels sum in other orders; phase 5 holds the frames
# to 1e-3, a quarter of a level), which moves a value that lies near a
# level boundary to the next level, in the LK backgrounds and in the
# generated frames (2 of the 5; the keyframes pass through).  Reading on
# an NVIDIA H100 80GB HBM3 at 700 W: 1 level, 4.00% of values (the
# backgrounds 1 level, 0.03%); the limits are one level more and twice
# the share.  The planted control (the card's frames rendered on the
# background at t-1) reads 201 levels, 43.4%, and must lie beyond both.
FILES_MAX_LEVELS = 2
FILES_SHARE_TOL = 0.08


def _png_dir(path) -> np.ndarray:
    from PIL import Image

    return np.stack([np.asarray(Image.open(os.path.join(path, f)))
                     for f in sorted(os.listdir(path))])


def _yaml_cfg(path: str, cfg) -> str:
    """Write a motion or renderer config as yaml in the nested layout;
    raises unless the port's loader reads it back equal."""
    import dataclasses

    import yaml

    from renderloom_torch.core import config as C

    with open(path, "w") as f:
        yaml.safe_dump(json.loads(json.dumps(dataclasses.asdict(cfg))), f)
    load = (C.load_motion_config if isinstance(cfg, C.MotionConfig)
            else C.load_renderer_config)
    if load(path) != cfg:
        raise AssertionError(f"{path} does not load as the config written")
    return path


def _serve_files_inputs(work, keys_u8, motion, conf, mcfg):
    """Keyframe PNGs and their BODY25 openpose JSONs (the normalized
    motion denormalized by the config's openpose scale and offset)."""
    from PIL import Image

    from renderloom_torch.data.openpose import write_openpose_dir

    frames = os.path.join(work, "frames")
    os.makedirs(frames)
    for i, key in enumerate(keys_u8):
        Image.fromarray(key).save(os.path.join(frames, f"{i:03d}.png"))
    poses = os.path.join(work, "poses")
    d = mcfg.dataset
    write_openpose_dir(motion, conf, poses, d.openpose_scale,
                       d.openpose_offset)
    return frames, poses


def _serve_by_files(work, inputs, ckpts, cfg_paths, mcfg, rate, device):
    """``renderloom_torch.cli.pipeline.main`` on the files; returns the
    frames, the Predict_motion joints (normalized), the DAIN backgrounds
    and pixel poses it rendered from, the file counts and the stage
    seconds."""
    import shutil

    from renderloom_torch.cli import pipeline as pipeline_cli
    from renderloom_torch.data.openpose import read_openpose_dir

    out = os.path.join(work, f"out_{device}")
    shutil.rmtree(out, ignore_errors=True)
    seconds = pipeline_cli.main([
        "--frames-dir", inputs[0], "--pose-dir", inputs[1],
        "--motion-ckpt", ckpts[0], "--renderer-ckpt", ckpts[1],
        "--motion-config", cfg_paths[0], "--renderer-config", cfg_paths[1],
        "--out-dir", out, "--rate", str(rate), "--device", device])
    d = mcfg.dataset
    pm = os.path.join(out, "Predict_motion")
    pred = read_openpose_dir(pm, d.openpose_scale, d.openpose_offset)[0]
    px, pconf, _ = read_openpose_dir(pm, 1.0, 0.0)
    return dict(frames=_png_dir(os.path.join(out, "Generated_frames")),
                pred=pred, dain=_png_dir(os.path.join(out, "DAIN")),
                poses=np.concatenate([px, pconf], 1).transpose(2, 0, 1),
                n_frames=len(os.listdir(os.path.join(out,
                                                     "Generated_frames"))),
                n_json=len(os.listdir(pm)), seconds=seconds)


def _serve_by_arrays(keys_u8, motion, conf, m_params, g_trees, mcfg, rcfg,
                     rate, device):
    """The CLI's stages on arrays, where PIL is missing: the motion stage
    (``interpolate_motion``, zero/one statistics as the CLI finds no
    cached ones), the LK backgrounds at the CLI's settings quantized as
    its PNGs are, and ``render_folder``'s array core."""
    from renderloom_torch.eval.motion_infer import make_interpolator
    from renderloom_torch.eval.render_eval import render_frames
    from renderloom_torch.ops.flow import upsample_background
    from renderloom_torch.train.gan import make_inference_pair

    tic = time.perf_counter()
    interp = make_interpolator(mcfg, m_params, None, None, device)
    pred, _, dconf = interp.interpolate_motion(motion, conf, rate)
    with torch.inference_mode():
        dense = upsample_background(torch.from_numpy(
            keys_u8.astype(np.float32) / 255.0).to(device), rate)
        dain = (dense.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
    d = mcfg.dataset
    poses = np.concatenate([pred * d.openpose_scale + d.openpose_offset,
                            dconf], axis=1).transpose(2, 0, 1)
    gen = make_inference_pair(rcfg, *g_trees, device)
    frames = np.concatenate([f for _, f in render_frames(
        gen, rcfg, keys_u8, dain, poses, rate, device)])
    return dict(frames=frames, pred=pred, dain=dain, poses=poses,
                seconds={"arrays": time.perf_counter() - tic})


def _levels(got: np.ndarray, want: np.ndarray):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return int(diff.max()), float((diff > 0).mean())


def phase_serve_files(serve, bf16, probe):
    """The pipeline CLI at full width on phase 4's weights written as the
    port's checkpoints, in float32 and with both configs in bf16."""
    import shutil

    from renderloom_torch.convert import flax_trees
    from renderloom_torch.eval.motion_infer import (bucket_length,
                                                    make_interpolator)
    from renderloom_torch.models.layers import InstanceNorm, Spade

    mcfg, rcfg, rate, K = (serve[k] for k in ("mcfg", "rcfg", "rate", "K"))
    H, W = rcfg.data.model_height, rcfg.data.model_width
    L = (K - 1) * rate + 1
    files = _skip_line("V", "files", [m for m in ("PIL",) if not probe[m]])
    print(f"V. serving from files: {W}x{H}, rate {rate}, {K} keyframes "
          f"(L = {L}), motion.yaml + hsm.yaml, phase 4's weights as "
          f"torch.save checkpoints; "
          + ("pipeline CLI (renderloom_torch.cli.pipeline)" if files else
             "render_folder's array core (no PIL)"))
    work = os.path.join(ROOT, "build", "chip_smoke_files")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    m_model, gen = serve["interp"].model, serve["gen"]
    ckpts = (os.path.join(work, "motion.pt"),
             os.path.join(work, "renderer.pt"))
    torch.save(m_model.state_dict(), ckpts[0])
    torch.save({"step": 0, "gen": gen.state_dict()}, ckpts[1])
    m_params, g_trees = flax_trees(m_model)[0], flax_trees(gen)
    motion_t, conf_t, keys_t = serve["inputs"]
    keys_u8 = (keys_t[0] * 255).round().to(torch.uint8).cpu().numpy()
    motion = motion_t[0].double().cpu().numpy()
    conf = conf_t[0].double().cpu().numpy()
    if files:
        inputs = _serve_files_inputs(work, keys_u8, motion, conf, mcfg)
    # K2 launches per generator step, from the module structure: one per
    # InstanceNorm and per SPADE; render chunks of render_frames'
    # max(min(16, S), 64 // rate) segments (one chunk of the 7 here)
    per_step = sum(isinstance(m, (InstanceNorm, Spade))
                   for m in gen.modules())
    S = (L - 1) // rate
    chunks = -(-S // max(min(16, S), 64 // rate))

    out = {}
    for tag, m_cfg, r_cfg in (("serve_files", mcfg, rcfg),
                              ("serve_files_bf16", _bf16(mcfg),
                               _bf16(rcfg))):
        in_bf16 = tag.endswith("bf16")
        cfg_paths = (
            _yaml_cfg(os.path.join(work, f"{tag}_motion.yaml"), m_cfg),
            _yaml_cfg(os.path.join(work, f"{tag}_renderer.yaml"), r_cfg))
        run = ((lambda: _serve_by_files(work, inputs, ckpts, cfg_paths,
                                        m_cfg, rate, DEVICE))
               if files else
               (lambda: _serve_by_arrays(keys_u8, motion, conf, m_params,
                                         g_trees, m_cfg, r_cfg, rate,
                                         DEVICE)))
        if not in_bf16:
            run()                       # warm-up (first file I/O, imports)
        _reset_launches()
        calls = []
        restore = _raster_recorder(calls)
        try:
            res = run()
            torch.cuda.synchronize()
        finally:
            restore()
        launches = _serve_launches()
        norm = chunks * (rate - 1) * per_step
        want = {"rasterize": chunks, "rasterize_packed": 0,
                "instance_norm": 0 if in_bf16 else norm,
                "instance_norm_parity": 0,
                "instance_norm_r3": norm if in_bf16 else 0,
                "upconv": 0 if in_bf16 else chunks * (rate - 1)
                * _count_upconvs(serve["gen"]),
                **_lk_warps(0)}         # the CLIs' LK: flow_scale 1
        print(f"  {tag}: launches {launches}; derived {want} ({chunks} "
              f"render chunk, {per_step} norms per generator step x "
              f"{rate - 1} steps); K1 masks "
              f"{sorted({c[0][6] for c in calls})}")
        if launches != want or any(c[0][6] for c in calls):
            raise AssertionError(f"{tag}: kernel launches {launches}")
        frames = res["frames"]
        if frames.shape != (L, H, W, 3) or frames.dtype != np.uint8:
            raise AssertionError(f"{tag}: frames {frames.shape}")
        if files and (res["n_frames"], res["n_json"]) != (L, L):
            raise AssertionError(f"{tag}: {res['n_frames']} frames, "
                                 f"{res['n_json']} Predict_motion JSONs")
        key_err = _levels(frames[::rate], keys_u8)[0]
        lib = make_interpolator(m_cfg, m_params, None, None, DEVICE)
        with torch.inference_mode():
            pred = lib._run(motion_t, conf_t, rate, int(np.log2(rate)),
                            bucket_length(L, rate))[0][0, ..., :L]
        px = np.abs(res["pred"] - pred.double().cpu().numpy()).max() \
            * mcfg.dataset.openpose_scale
        print(f"    {L} frames" + (f", {res['n_json']} Predict_motion "
                                   f"JSONs" if files else "")
              + f"; keyframes within {key_err} level of the input; "
              f"Predict_motion vs the library motion stage: max {px:.3e} "
              f"px (tol {MOTION_PX_TOL})")
        if key_err > 1 or not px <= MOTION_PX_TOL:
            raise AssertionError(f"{tag}: keyframes {key_err} levels, "
                                 f"motion {px} px")
        total = sum(res["seconds"].values())
        mem_fps = (bf16["standard"]["fps"] if in_bf16 else serve["fps"])
        print("    seconds: " + ", ".join(
            f"{k} {v:.3f}" for k, v in res["seconds"].items())
            + f"; files-in/frames-out {L / total:.3f} frames/s beside the "
            f"in-memory pipeline's {mem_fps:.3f} of this run ({card_line()})")
        if calls:
            _k1_check(f"{tag} K1 on the run's tables", calls[0][0][:3], H,
                      W, torch.float32, False, "nhwc")
        out[tag] = dict(launches=launches, seconds=res["seconds"],
                        fps=L / total)

    _serve_files_cpu_match(work, files)
    return out


def _serve_files_cpu_match(work, files):
    """The card's serving CLI (or its array core) against the CPU's at
    64x96, rate 2, 3 keyframes, tiny widths, identical checkpoints."""
    import dataclasses

    from renderloom_torch.convert import flax_trees
    from renderloom_torch.data.amass import stats_paths
    from renderloom_torch.eval.motion_infer import make_interpolator
    from renderloom_torch.eval.render_eval import render_frames
    from renderloom_torch.train.gan import make_inference_pair

    mcfg, rcfg, rate, K, stats, (motion, conf, keys) = _tiny_serving_case()
    tiny = os.path.join(work, "tiny")
    os.makedirs(os.path.join(tiny, "stats"))
    mcfg = dataclasses.replace(mcfg, dataset=dataclasses.replace(
        mcfg.dataset, data_root=os.path.join(tiny, "stats")))
    for path, arr in zip(stats_paths(mcfg.dataset),
                         (stats["mean"], stats["std"])):
        np.save(path, arr)
    interp = make_interpolator(mcfg, None, None, None, "cpu")
    gen = make_inference_pair(rcfg, None, None, "cpu")
    ckpts = (os.path.join(tiny, "motion.pt"),
             os.path.join(tiny, "renderer.pt"))
    torch.save(interp.model.state_dict(), ckpts[0])
    torch.save({"step": 0, "gen": gen.state_dict()}, ckpts[1])
    keys_u8 = (keys[0] * 255).round().astype(np.uint8)
    runs = {}
    if files:
        inputs = _serve_files_inputs(tiny, keys_u8, motion[0], conf[0], mcfg)
        cfg_paths = (_yaml_cfg(os.path.join(tiny, "motion.yaml"), mcfg),
                     _yaml_cfg(os.path.join(tiny, "renderer.yaml"), rcfg))
        for dev in ("cpu", DEVICE):
            runs[dev] = _serve_by_files(tiny, inputs, ckpts, cfg_paths, mcfg,
                                        rate, dev)
    else:
        m_params, g_trees = flax_trees(interp.model)[0], flax_trees(gen)
        for dev in ("cpu", DEVICE):
            runs[dev] = _serve_by_arrays(keys_u8, motion[0], conf[0],
                                         m_params, g_trees, mcfg, rcfg, rate,
                                         dev)
    card, cpu = runs[DEVICE], runs["cpu"]
    worst, share = _levels(card["frames"], cpu["frames"])
    back = _levels(card["dain"], cpu["dain"])
    # planted control: the card's frames on the background at t-1
    shifted = np.concatenate([card["dain"][:1], card["dain"][:-1]])
    card_gen = make_inference_pair(rcfg, *flax_trees(gen), DEVICE)
    control = np.concatenate([f for _, f in render_frames(
        card_gen, rcfg, keys_u8, shifted, card["poses"], rate, DEVICE)])
    c_worst, c_share = _levels(control, cpu["frames"])
    print(f"  card vs CPU {'pipeline CLI' if files else 'array core'} "
          f"(64x96, rate {rate}, {K} keyframes, tiny widths, same "
          f"checkpoints): frames max {worst} levels, {100 * share:.4f}% of "
          f"values not equal (limits {FILES_MAX_LEVELS}, "
          f"{100 * FILES_SHARE_TOL:.2f}%); LK backgrounds max {back[0]} "
          f"levels, {100 * back[1]:.4f}%; control (background at t-1) "
          f"{c_worst} levels, {100 * c_share:.4f}%")
    if worst > FILES_MAX_LEVELS or share > FILES_SHARE_TOL:
        raise AssertionError("card vs CPU serving out of bounds")
    if c_worst <= FILES_MAX_LEVELS or c_share <= FILES_SHARE_TOL:
        raise AssertionError("the planted control lies within the limits")


# ---------------------------------------------------------------------------
# Q. evaluation over HumanSloMo test clips
# ---------------------------------------------------------------------------

# The card's evaluate_h5 against the CPU's at 64x96 (tiny widths, the
# same generator and VGG19 weights): every metric to EVAL_RTOL relative
# in float32, as the CPU tests hold the port to JAX (reading on an NVIDIA
# H100 80GB HBM3 at 700 W: 7.3e-6).  In bf16 every metric within
# EVAL_BF16_RTOL relative, set from the reading (1.15e-3).  The metrics
# average thousands of pixels, so they cannot tell a bf16 clip from a
# float32 one (on the CPU the port's bf16 metrics lie as far from JAX
# bf16 as JAX float32 does; on the card, bf16 against the CPU's float32
# reads 6.6e-4, below the bf16 reading), and that float32 control is
# printed, not held.  Each limit has a planted control that must lie
# beyond it: the same evaluation with every background taken at t-1
# (1.56 relative).
EVAL_RTOL = 1e-4
EVAL_BF16_RTOL = 2e-3
EVAL_KEYS = ("DAIN_PSNR", "DAIN_SSIM", "OURS_PSNR", "OURS_SSIM",
             "DAIN_LPIPS", "OURS_LPIPS")


class _ArrayReader:
    """The three members of ``HsmReader`` that ``evaluate_h5`` reads
    (``video_list``, ``n_frames``, ``read_test_frame``) over clips held in
    memory: the reader where ``h5py`` is missing."""

    def __init__(self, clips: dict):
        self.clips = clips
        self.video_list = list(clips)
        self.n_frames = {k: len(v["image"]) for k, v in clips.items()}

    def read_test_frame(self, vid, index):
        c = self.clips[vid]
        return {"image": c["image"][index], "dain": c["dain"][index],
                "pose": c["pose"][index]}


def _eval_clips(lengths: dict, H: int, W: int, seed: int,
                shift_back: bool = False) -> dict:
    """Test clips of ``_person_poses``: a textured frame with a bright
    figure at the person, its DAIN frame the same with noise (taken from
    frame t-1 with ``shift_back``, the planted fault)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = (96 + 48 * np.sin(xx / 7) * np.cos(yy / 11))[..., None]
    clips = {}
    for i, (name, n) in enumerate(lengths.items()):
        coords, conf = _person_poses(n, H, W, seed + i, device="cpu")
        coords, conf = coords.numpy(), conf.numpy()
        images = np.empty((n, H, W, 3), np.uint8)
        for t in range(n):
            cx, cy = coords[t].mean(axis=0)
            blob = np.exp(-((xx - cx) ** 2 / (W / 8) ** 2
                            + (yy - cy) ** 2 / (H / 4) ** 2))[..., None]
            images[t] = np.clip(base + 120 * blob * rng.uniform(
                0.6, 1.0, 3), 0, 255).astype(np.uint8)
        dain = np.clip(images.astype(np.int16) + rng.integers(
            -16, 17, images.shape), 0, 255).astype(np.uint8)
        if shift_back:
            dain = np.concatenate([dain[:1], dain[:-1]])
        clips[name] = dict(image=images, dain=dain, pose=np.concatenate(
            [coords, conf[..., None]], axis=-1).astype(np.float32))
    return clips


def _h5_of(path: str, clips: dict) -> str:
    """The clips as a HumanSloMo h5 (``gt_images``/``gt_dain`` PNG rows,
    ``gt_poses``), for the real reader."""
    import io

    import h5py
    from PIL import Image

    def png(img):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        return np.frombuffer(buf.getvalue(), np.uint8)

    with h5py.File(path, "w") as f:
        for name, c in clips.items():
            grp = f.create_group(name)
            for key in ("image", "dain"):
                ds = grp.create_dataset(f"gt_{key}s" if key == "image"
                                        else "gt_dain", (len(c[key]),),
                                        dtype=h5py.vlen_dtype(np.uint8))
                for i, img in enumerate(c[key]):
                    ds[i] = png(img)
            grp.create_dataset("gt_poses", data=c["pose"].astype(np.float64))
    return path


def _eval_readers(clips: dict, real: bool, path: str):
    """A function of clip names → a reader over those clips: the real
    ``HsmReader`` over an h5 of the clips written once to ``path``, or
    the in-memory one."""
    from renderloom_torch.data.hsm import HsmReader

    if real:
        _h5_of(path, clips)
        return lambda names: HsmReader(path, list(names), "test")
    return lambda names: _ArrayReader({k: clips[k] for k in names})


def _eval_timers(seconds: Counter, reader, vgg):
    """Time ``evaluate_h5``'s stages by wrapping what it calls (each call
    synchronised): reading, preparation, rollout, metrics, LPIPS.
    Returns the function that unwraps them."""
    from renderloom_torch.eval import render_eval as TE

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name] += time.perf_counter() - tic
            return out
        return run

    names = {"prepare_batch": "preparation",
             "segment_rollout_chunked": "rollout",
             "rollout_chunked": "rollout", "masked_metrics": "metrics"}
    saved = {n: getattr(TE, n) for n in names}
    for n, stage in names.items():
        setattr(TE, n, timed(stage, saved[n]))
    reader.read_test_frame = timed("reading", reader.read_test_frame)
    vgg.lpips = timed("LPIPS", vgg.lpips)

    def restore():
        for n, fn in saved.items():
            setattr(TE, n, fn)
        del reader.read_test_frame, vgg.lpips
    return restore


def phase_eval(serve, probe):
    """``evaluate_h5`` at full width (hsm.yaml, eval_frames 40: 81 frames
    a clip) on phase 4's generator weights, LPIPS on seeded random VGG19
    weights, in float32 and in bf16."""
    from renderloom_torch.convert import flax_trees
    from renderloom_torch.eval.render_eval import evaluate_h5
    from renderloom_torch.train.gan import (make_inference_generator,
                                            make_perceptual)

    rcfg = serve["rcfg"]
    H, W = rcfg.data.model_height, rcfg.data.model_width
    n_keys = rcfg.data.eval_frames
    # 81 frames: (81 - 1) % 2 == 0, the segment rollout; 80: sequential
    lengths = {"eval_seg": 2 * n_keys + 1, "eval_seq": 2 * n_keys}
    real = _skip_line("Q", "h5 file", [m for m in ("h5py", "PIL")
                                       if not probe[m]])
    video = _skip_line("Q", "grid video", [] if probe["imageio"]
                       else ["imageio"])
    print(f"Q. evaluate_h5: {W}x{H}, clips of {lengths} frames "
          f"(_person_poses), chunk 64 (32 segments, the generator at "
          f"B = 32), LPIPS on random VGG19 weights; reader: "
          + ("HsmReader over an h5 written here" if real else
             "in-memory (video_list, n_frames, read_test_frame)"))
    tic = time.perf_counter()
    clips = _eval_clips(lengths, H, W, seed=20)
    make_reader = _eval_readers(clips, real, os.path.join(
        ROOT, "build", "chip_smoke_eval.h5"))
    print(f"  made the clips in {time.perf_counter() - tic:.1f} s")
    g_trees = flax_trees(serve["gen"])
    vgg = make_perceptual(rcfg, DEVICE, seed=0)     # float32 in both runs
    per_step = _count_norms(make_inference_generator(rcfg))
    up_step = _count_upconvs(make_inference_generator(rcfg))
    S = lengths["eval_seg"] // 2
    steps = -(-S // 32) + lengths["eval_seq"] // 2
    out = {}
    for tag, cfg in (("eval_h5", rcfg), ("eval_h5_bf16", _bf16(rcfg))):
        in_bf16 = tag.endswith("bf16")
        _reset_launches()
        calls, seen = [], Counter()
        restore_norms = _norm_kind_recorder(seen)
        restore = _raster_recorder(calls)
        try:
            res = evaluate_h5(*g_trees, cfg, make_reader(lengths),
                              perceptual=vgg, device=DEVICE,
                              video_dir=OUT_DIR if video and not in_bf16
                              else None)
        finally:
            restore()
            restore_norms()
        launches = _serve_launches()
        norm = steps * per_step
        want = {"rasterize": len(lengths), "rasterize_packed": 0,
                "instance_norm": 0 if in_bf16 else norm,
                "instance_norm_parity": 0,
                "instance_norm_r3": norm if in_bf16 else 0,
                "upconv": 0 if in_bf16 else steps * up_step,
                **_lk_warps(0)}         # backgrounds from the h5
        print(f"  {tag}: launches {launches}; derived {want} (K1 once a "
              f"clip with masks; {per_step} norms per generator step x "
              f"{steps} steps: {-(-S // 32)} segment chunks of up to 32 "
              f"and {lengths['eval_seq'] // 2} sequential frames); K1 "
              f"masks {sorted({c[0][6] for c in calls})}")
        if launches != want or not all(c[0][6] for c in calls):
            raise AssertionError(f"{tag}: kernel launches {launches}")
        print("    " + ", ".join(f"{k} {res[k]:.6f}" for k in EVAL_KEYS))
        if sorted(res) != sorted(EVAL_KEYS) or not all(
                np.isfinite(v) for v in res.values()):
            raise AssertionError(f"{tag}: metrics {res}")
        # the kernels at the shapes this run gave them, against their twins
        for i, c in enumerate(calls):
            _k1_check(f"{tag} K1 clip {i}", c[0][:3], H, W, torch.float32,
                      True, "nhwc")
        err = 0.0
        for i, key in enumerate(sorted(seen, key=str)):
            x, s, b = _norm_inputs(*key[:3], seed=300 + i)
            check = _r3_check if key[4] == "r3centered" else _norm_check
            err = max(err, check(f"{tag} {key[:4]}", x, s, b, key[3]))
        # seconds per clip by stage, and the peak memory of the clip whose
        # segments run at B = 32
        per_clip = {}
        for name in lengths:
            seconds = Counter()
            reader = make_reader([name])
            restore = _eval_timers(seconds, reader, vgg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tic = time.perf_counter()
            try:
                evaluate_h5(*g_trees, cfg, reader, perceptual=vgg,
                            device=DEVICE)
                torch.cuda.synchronize()
            finally:
                restore()
            total = time.perf_counter() - tic
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            gen_frames = lengths[name] // 2
            print(f"    {name}: {total:.3f} s ("
                  + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
                  + f"), {gen_frames / total:.2f} generated frames "
                  f"evaluated/s, peak memory {peak:.2f} GiB")
            per_clip[name] = dict(seconds=total, stages=dict(seconds),
                                  frames_per_s=gen_frames / total,
                                  peak_gib=peak)
        out[tag] = dict(launches=launches, metrics=res, per_clip=per_clip,
                        norm_err=err)
    dain = {k: (out["eval_h5"]["metrics"][k],
                out["eval_h5_bf16"]["metrics"][k])
            for k in EVAL_KEYS if k.startswith("DAIN")}
    print(f"  DAIN_* float32 vs bf16 (must be identical): {dain}")
    if any(a != b for a, b in dain.values()):
        raise AssertionError("DAIN metrics differ between float32 and bf16")
    print(f"  ({card_line()})")
    _eval_cpu_match(real)
    return out


def _eval_cpu_match(real: bool):
    """The card's evaluate_h5 against the CPU's at 64x96, tiny widths,
    identical weights, in float32 and in bf16."""
    from renderloom_torch.eval.render_eval import evaluate_h5
    from renderloom_torch.train.gan import make_perceptual

    _, rcfg, _, _, _, _ = _tiny_serving_case()
    H, W = rcfg.data.model_height, rcfg.data.model_width
    lengths = {"tiny_seg": 7, "tiny_seq": 6}
    readers = {shift: _eval_readers(
        _eval_clips(lengths, H, W, seed=30, shift_back=shift), real,
        os.path.join(ROOT, "build", f"chip_smoke_eval_tiny_{shift}.h5"))
        for shift in (False, True)}

    def run(cfg, device, shift_back=False):
        return evaluate_h5(None, None, cfg, readers[shift_back](lengths),
                           max_keyframes=3, perceptual=make_perceptual(
                               rcfg, device, seed=0), device=device)

    def rel(a, b):
        return max(abs(a[k] - b[k]) / abs(b[k]) for k in EVAL_KEYS)

    cpu32 = run(rcfg, "cpu")
    for name, cfg, tol in (("float32", rcfg, EVAL_RTOL),
                           ("bf16", _bf16(rcfg), EVAL_BF16_RTOL)):
        card, cpu = run(cfg, DEVICE), run(cfg, "cpu")
        control = run(cfg, DEVICE, shift_back=True)
        err, c_err = rel(card, cpu), rel(control, cpu)
        extra = (f"; float32 control, card bf16 vs CPU float32, "
                 f"{rel(card, cpu32):.3e} (printed, not held)"
                 if name == "bf16" else "")
        print(f"  card vs CPU evaluate_h5 {name} (64x96, tiny widths, same "
              f"weights): largest relative metric error {err:.3e} (tol "
              f"{tol:.0e}); planted control (backgrounds at t-1) "
              f"{c_err:.3e}{extra}")
        if not (err <= tol < c_err):
            raise AssertionError(f"evaluate_h5 {name}: card vs CPU out of "
                                 f"bounds, or the control within them")


# ---------------------------------------------------------------------------
# X. the frozen serving artifact (torch.export)
# ---------------------------------------------------------------------------

# The loaded program in a fresh process: it imports the loader (which
# registers the two operators) and nothing of the port's models, configs
# or checkpoints, serves the clip once to warm up, once counted, and
# three times timed; writes the counted run's frames.
_FROZEN_CHILD = r"""
import json, sys, time
import torch
sys.path.insert(0, sys.argv[1])
from renderloom_torch.eval.export import load_exported
from renderloom_torch.ops import norm_kernel as NK, rasterize_kernel as RK
from renderloom_torch.ops import shiftwarp_kernel as SK
from renderloom_torch.ops import upconv_kernel as UK
tic = time.perf_counter()
serve, meta = load_exported(sys.argv[2])
load_s = time.perf_counter() - tic
motion, conf, keys = torch.load(sys.argv[3])
serve(motion, conf, keys)
torch.cuda.synchronize()
RK.rasterize_tables_cuda.layout_launches = dict.fromkeys(RK.LAYOUTS, 0)
NK.instance_norm_cuda.launches = NK.instance_norm_cuda.parity_launches = 0
NK.instance_norm_cuda.r3_launches = UK.upconv_cuda.launches = 0
SK.shift_warp_cuda.launches = SK.shift_warp_blend_cuda.launches = 0
fused, sync = serve(motion, conf, keys)
torch.cuda.synchronize()
by = RK.rasterize_tables_cuda.layout_launches
launches = {"rasterize": by["nhwc"], "rasterize_packed": by["packed"],
            "instance_norm": NK.instance_norm_cuda.launches,
            "instance_norm_parity": NK.instance_norm_cuda.parity_launches,
            "instance_norm_r3": NK.instance_norm_cuda.r3_launches,
            "upconv": UK.upconv_cuda.launches,
            "shift_warp": SK.shift_warp_cuda.launches,
            "shift_warp_blend": SK.shift_warp_blend_cuda.launches}
runs = []
for _ in range(3):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve(motion, conf, keys)
    torch.cuda.synchronize()
    runs.append(time.perf_counter() - t0)
torch.save(fused.cpu(), sys.argv[4])
port = sorted(m for m in sys.modules if m.startswith("renderloom_torch"))
print(json.dumps({"launches": launches, "runs": runs, "load_s": load_s,
                  "modules": port, "sync": float(sync),
                  "meta_device": meta["device"]}))
"""

# the artifacts and the child's inputs and frames (hundreds of MB; removed
# after use, and not under OUT_DIR, which the chip call brings back)
X_DIR = os.path.join(ROOT, "build", "chip_smoke_export")

# modules the loader must not import (the JAX loader touches no model
# code, configs or checkpoints)
FROZEN_FORBIDDEN = ("renderloom_torch.models", "renderloom_torch.core",
                    "renderloom_torch.eval.pipeline", "renderloom_torch.train",
                    "renderloom_torch.data", "renderloom_torch.convert")


def _op_host_us() -> dict:
    """Host µs per norm call at a tiny shape, the least of five turns:
    the wrapper, the registered operator, and ``instance_norm``'s eager
    dispatch (which calls the wrapper)."""
    from renderloom_torch.ops import norm_kernel as NK

    x = torch.randn(1, 8, 8, 32, device="cuda")
    s, b = torch.ones(32, device="cuda"), torch.zeros(32, device="cuda")
    op = torch.ops.renderloom.instance_norm
    calls = {"wrapper": lambda: NK.instance_norm_cuda(x, s, b, LEAKY),
             "operator": lambda: op(x, s, b, LEAKY, 1e-5, False, False),
             "instance_norm": lambda: NK.instance_norm(x, s, b, LEAKY)}
    us = {k: [] for k in calls}
    with torch.inference_mode():
        for _ in range(5):                  # in turns; the least of each
            for k, fn in calls.items():
                us[k].append(host_us(fn))
    return {k: min(v) for k, v in us.items()}


def _frozen(name, fn, m_model, gen, inputs, rate, K, H, W):
    """Export ``fn`` with its modules, save it, and serve it from a fresh
    process; returns the child's report with the artifact's bytes and
    the export's and save's seconds, and the frozen frames."""
    from renderloom_torch.eval.export import export_pipeline, save_exported

    tic = time.perf_counter()
    ep, meta = export_pipeline(fn, m_model, gen, 1, K, H, W, rate, "cuda")
    export_s = time.perf_counter() - tic
    os.makedirs(X_DIR, exist_ok=True)
    path = os.path.join(X_DIR, f"pipeline_{name}.pt2")
    tic = time.perf_counter()
    nbytes = save_exported(path, ep, meta)
    save_s = time.perf_counter() - tic
    del ep
    n_weights = sum(p.numel() * p.element_size()
                    for mod in (m_model, gen)
                    for p in [*mod.parameters(), *mod.buffers()])
    in_path = os.path.join(X_DIR, f"{name}_inputs.pt")
    out_path = os.path.join(X_DIR, f"{name}_fused.pt")
    torch.save(tuple(t.cpu() for t in inputs), in_path)
    proc = subprocess.run([sys.executable, "-c", _FROZEN_CHILD, ROOT, path,
                           in_path, out_path], capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"frozen {name} child failed:\n"
                             f"{proc.stderr[-4000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    bad = [m for m in report["modules"] if m.startswith(FROZEN_FORBIDDEN)]
    if bad:
        raise AssertionError(f"the loader imported {bad}")
    report.update(bytes=nbytes, weight_bytes=n_weights, export_s=export_s,
                  save_s=save_s)
    frozen = torch.load(out_path)
    for f in (path, in_path, out_path):
        os.remove(f)
    return report, frozen


def _live_fps(fn, inputs, L) -> float:
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        fn(*inputs)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - tic)
    return len(runs) * L / sum(runs)


def phase_export(serve, launches, bf16):
    """The standard float32 pipeline (phase 4's, which launched
    ``launches``) and the bf16 fastpath (phase H's) exported, saved,
    loaded in a fresh process and served."""
    rate, K = serve["rate"], serve["K"]
    H, W = serve["rcfg"].data.model_height, serve["rcfg"].data.model_width
    L = (K - 1) * rate + 1
    inputs = serve["inputs"]
    print(f"X. the frozen serving artifact (torch.export): {W}x{H}, rate "
          f"{rate}, {K} keyframes, 1 clip; standard float32 and bf16 "
          "fastpath, each loaded and served by a fresh process")
    us = _op_host_us()
    print("  host us per norm call at (1, 8, 8, 32): " + ", ".join(
        f"{k} {v:.2f}" for k, v in us.items()) + " (eager serving calls "
        "the wrapper; a frozen program the operator)")
    out = {"host_us": us}
    f32 = dict(fn=serve["fn"], m_model=serve["interp"].model,
               gen=serve["gen"], launches=launches,
               fused=serve["fused"])
    for name, live in (("standard_f32", f32),
                       ("fastpath_bf16", bf16["fastpath"])):
        live_before = _live_fps(live["fn"], inputs, L)
        report, frozen = _frozen(name, live["fn"], live["m_model"],
                                 live["gen"], inputs, rate, K, H, W)
        live_fps = _live_fps(live["fn"], inputs, L)
        fps = len(report["runs"]) * L / sum(report["runs"])
        print(f"  {name}: artifact {report['bytes'] / 1e6:.1f} MB "
              f"(weights {report['weight_bytes'] / 1e6:.1f} MB), export "
              f"{report['export_s']:.1f} s, save {report['save_s']:.1f} s, "
              f"load {report['load_s']:.1f} s; frozen "
              f"{fps:.3f} frames/s against live {live_before:.3f} before "
              f"and {live_fps:.3f} after it, in this run")
        print(f"    launches: frozen {report['launches']}, live "
              f"{live['launches']}")
        if report["launches"] != live["launches"]:
            raise AssertionError(f"{name}: the frozen program's launches "
                                 f"{report['launches']} differ from the "
                                 f"live pipeline's {live['launches']}")
        want = live["fused"].cpu()
        if tuple(frozen.shape) != tuple(want.shape) or \
                not bool(torch.isfinite(frozen).all()):
            raise AssertionError(f"{name}: frozen {tuple(frozen.shape)}")
        same = torch.equal(frozen, want)
        if name == "standard_f32":
            err = compare("    frozen vs live, float32", frozen, want,
                          atol=1e-3)
        else:
            # phase E's hold of a bf16 pipeline on its generated frames,
            # the control the float32 pipeline's frames
            gen_f, gen_l = frozen[:, 1::rate], want[:, 1::rate]
            gen_c = f32["fused"].cpu()[:, 1::rate]
            err = (gen_f - gen_l).abs().mean().item()
            control = (gen_f - gen_c).abs().mean().item()
            print(f"    frozen vs live, bf16: mean {err:.3e} over the "
                  f"generated frames (tol {BF16_MEAN_TOL:.0e}; the "
                  f"control, frozen vs the float32 live, {control:.3e}); "
                  f"max {(gen_f - gen_l).abs().max().item():.3e}")
            if not err <= BF16_MEAN_TOL < control:
                raise AssertionError(f"{name}: frozen vs live out of bounds")
        if not torch.equal(frozen[:, ::rate], want[:, ::rate]):
            raise AssertionError(f"{name}: keyframes differ")
        print(f"    bit-equal to the live frames: {same}")
        out[name] = dict(report, fps=fps, live_fps=live_fps,
                         live_fps_before=live_before,
                         max_abs_err=err, bit_equal=same)
    return out


# ---------------------------------------------------------------------------
# Y. the batch planner's profile
# ---------------------------------------------------------------------------

PLAN_SIZES = (1, 2, 4, 8)       # tests/test_serving_plan.py's table sizes


# Each clip of an N-clip batch (the same clip N times) is held against
# the 1-clip run.  The motion transformer in bf16 takes other cuBLAS
# kernels at 8 clips than at 1, and its rounding, amplified by the random
# weights, moves the joints up to 16 px (mean 1.67 px; 1.0e-3 px in
# float32), which a mean limit on the frames cannot tell from a fault
# (NVIDIA H100 80GB HBM3, 700 W).  So the generator's batch is held on
# the 1-clip run's poses, fed to every clip: keyframes bit for bit, the
# generated frames' mean |err| within BF16_MEAN_TOL (phase E's), the
# float32 pipeline's frames the control beyond it (cuDNN and the kernels
# see batch 7·N and may sum in another order).  The batch as served
# (its own poses) must lie closer to the 1-clip frames than bf16 lies
# from float32 (that control).  The batching of every stage is held in
# float32 at the largest N (phase F's fastpath: the same code in float32,
# frames within the pipeline's 1e-3), and the kernels against their
# twins there: K1 packed on the batch's own tables (bit for bit), K2 in
# each mode at its largest shape of that batch on seeded inputs (phases
# 2, N and R's tolerances).
def _planner_holds(n, fn, inputs, fused, poses, ref, f32, rate) -> dict:
    """Hold the N-clip run ``fused`` (with its ``poses``) and a run fed
    the 1-clip poses against the 1-clip run ``ref`` (frames, poses);
    control: the float32 pipeline's frames ``f32``."""
    if tuple(fused.shape) != (n,) + tuple(ref["frames"].shape[1:]) or \
            not bool(torch.isfinite(fused).all()):
        raise AssertionError(f"N={n}: frames {tuple(fused.shape)} or not "
                             "finite")
    one = ref["frames"][0, 1::rate]

    def gap(frames):
        for c in range(n):
            if not torch.equal(frames[c, ::rate], ref["frames"][0, ::rate]):
                raise AssertionError(f"N={n} clip {c}: keyframes differ")
        return max((frames[c, 1::rate] - one).abs().mean().item()
                   for c in range(n))

    control = min((fused[c, 1::rate] - f32[0, 1::rate]).abs().mean().item()
                  for c in range(n))
    served = gap(fused)
    px = max((poses[c] - ref["poses"][0]).abs().max().item()
             for c in range(n))
    fed = 0.0
    if n > 1:
        restore = _stage_recorder({}, poses=ref["poses"].repeat(
            n, *([1] * (ref["poses"].dim() - 1))))
        try:
            fed_frames = fn(*inputs)[0].cpu()
        finally:
            restore()
        fed = gap(fed_frames)
    print(f"    each of {n} clips vs N=1, mean over the generated frames: "
          f"fed the 1-clip poses {fed:.3e} (tol {BF16_MEAN_TOL:.0e}); as "
          f"served {served:.3e}, its poses within {px:.3e} px; the "
          f"control, vs the float32 pipeline, {control:.3e}")
    if not (fed <= BF16_MEAN_TOL < control and served < control):
        raise AssertionError(f"N={n}: batched frames out of bounds")
    return dict(fed=fed, served=served, poses_px=px, control=control)


def _stage_recorder(box: dict, poses=None,
                    stages=("poses", "backs", "label")):
    """Swap the pipeline's ``prepare_batch`` for a recorder of its stage
    inputs and outputs (on the card): the upsampled poses (motion
    stage), the backgrounds (flow) and the label (K1), those of
    ``stages``; with ``poses``, the rendering stages get those in place
    of the motion stage's.
    Returns the function that puts it back."""
    import renderloom_torch.eval.pipeline as P

    inner = P.prepare_batch

    def rec(batch, *args, **kwargs):
        if poses is not None:
            batch = {**batch, "poses": poses}
        out = inner(batch, *args, **kwargs)
        got = dict(poses=batch["poses"], backs=batch["dain"],
                   label=out["label"])
        box.update({k: got[k].float() for k in stages})
        return out
    P.prepare_batch = rec

    def restore():
        P.prepare_batch = inner
    return restore


def batch_stage_gaps(fn, inputs, n: int, rate: int) -> dict:
    """``fn`` at 1 clip and at ``n`` copies of it: for each stage (poses,
    backgrounds, label, the generated frames) the largest max and mean
    |clip - the 1-clip run| over the clips, and whether the clips are
    bit-equal to it."""
    runs = []
    for k in (1, n):
        box = {}
        restore = _stage_recorder(box)
        try:
            box["frames"] = fn(*[t.repeat(k, *([1] * (t.dim() - 1)))
                                 for t in inputs])[0][:, 1::rate].float()
        finally:
            restore()
        runs.append(box)
    gaps = {}
    for stage, one in runs[0].items():
        many = runs[1][stage]
        d = [(many[c] - one[0]).abs() for c in range(n)]
        gaps[stage] = dict(max=max(x.max().item() for x in d),
                           mean=max(x.mean().item() for x in d),
                           equal=all(torch.equal(many[c], one[0])
                                     for c in range(n)))
    return gaps


def _planner_kernels(seen: Counter, calls: list) -> dict:
    """K1 packed on the largest batch's tables and K2 in each mode at its
    largest shape of that batch, each against its twin."""
    if len(calls) != 1:
        raise AssertionError(f"{len(calls)} K1 calls recorded")
    args, kw = calls[0]
    tabs, (H, W, dtype, masks) = args[:3], args[3:7]
    err, _ = _k1_check(f"K1 {kw['layout']} {str(dtype)[6:]} over "
                       f"{tabs[0].shape[0]} frames", tabs, H, W, dtype, masks,
                       kw["layout"])
    out = {"rasterize_packed": err}
    checks = {"shifted": _norm_check, "parity": _parity_check,
              "r3centered": _r3_check}
    for kind, check in checks.items():
        key = max((k for k in seen if k[4] == kind),
                  key=lambda k: np.prod(k[0]))
        x, s, b = _norm_inputs(*key[:3], seed=870)
        out[KIND_KEYS[kind]] = check(f"K2 {kind} {key[0]} {str(key[1])[6:]}"
                                     f" affine={key[2]}", x, s, b, key[3])
        del x
    return out


def phase_planner(serve, fast, bf16):
    """The bf16 fastpath pipeline (phase H's) at N clips of phase 4's
    inputs: ms per batch, peak memory and launches per N, each clip held
    against N = 1, the batch in float32 (phase F's pipeline) and the
    kernels against their twins at the largest N, then ``plan_chunks``'
    plans for n = 1..16."""
    from renderloom_torch.utils.serving import plan_chunks, planned_ms

    fn = bf16["fastpath"]["fn"]
    rate, K = serve["rate"], serve["K"]
    L = (K - 1) * rate + 1
    f32 = serve["fused"].cpu()
    print(f"Y. batch planner: bf16 fastpath at N in {PLAN_SIZES} clips")
    times, table, ref, largest = {}, {}, None, None
    for n in PLAN_SIZES:
        inputs = [t.repeat(n, *([1] * (t.dim() - 1)))
                  for t in serve["inputs"]]
        seen, calls, box = Counter(), [], {}
        try:
            fn(*inputs)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            restore = (_norm_kind_recorder(seen), _raster_recorder(calls),
                       _stage_recorder(box, stages=("poses",)))
            try:
                fused = fn(*inputs)[0]
                torch.cuda.synchronize()
            finally:
                for undo in restore:
                    undo()
            launches = _serve_launches()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            fused = fused.cpu()
            runs = []
            for _ in range(3):
                torch.cuda.synchronize()
                tic = time.perf_counter()
                fn(*inputs)
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - tic) * 1e3)
        except torch.cuda.OutOfMemoryError:
            print(f"  N={n}: out of memory; profiled up to N="
                  f"{max(times)}")
            torch.cuda.empty_cache()
            break
        if {k: launches[k] for k in _lk_warps(0)} != _lk_warps(n):
            raise AssertionError(f"N={n}: shift warp launches {launches}")
        times[n] = sum(runs) / len(runs)
        table[n] = dict(ms=times[n], peak_gib=peak, launches=launches,
                        fps=n * L / times[n] * 1e3)
        print(f"  N={n}: {times[n]:.1f} ms per batch ("
              + ", ".join(f"{r:.1f}" for r in runs) + f"), "
              f"{table[n]['fps']:.2f} frames/s, peak {peak:.2f} GiB, "
              f"launches {launches}")
        ref = ref or dict(frames=fused, poses=box["poses"])
        table[n]["vs_n1"] = _planner_holds(n, fn, inputs, fused,
                                           box["poses"], ref, f32, rate)
        largest = (n, seen, calls)
        del fused, box
    n, seen, calls = largest
    gaps16 = batch_stage_gaps(fn, serve["inputs"], n, rate)
    gaps = batch_stage_gaps(fast["fn"], serve["inputs"], n, rate)
    for name, g in (("bf16", gaps16), ("float32", gaps)):
        print(f"  {name} fastpath at N={n} vs N=1 by stage, max / mean "
              f"|err|: " + ", ".join(
                  f"{k} {v['max']:.3e} / {v['mean']:.3e}"
                  + (" (equal)" if v["equal"] else "")
                  for k, v in g.items()))
    print("  (float32 frames tol 1e-3, the pipeline's)")
    if gaps["frames"]["max"] > 1e-3:
        raise AssertionError(f"float32 fastpath at N={n}: frames differ by "
                             f"{gaps['frames']['max']}")
    print(f"  kernels vs twins at N={n} (batch {(K - 1) * n}):")
    kernel_errs = _planner_kernels(seen, calls)
    torch.cuda.empty_cache()
    plans = {}
    for n in range(1, 17):
        plan, ms = plan_chunks(n, times), planned_ms(n, times)
        plans[n] = dict(plan=plan, ms=ms, fps=n * L / ms * 1e3)
    print("  plans: " + "; ".join(
        f"{n}: {p['plan']} {p['ms']:.0f} ms {p['fps']:.1f} f/s"
        for n, p in plans.items()))
    return dict(table=table, plans=plans, kernel_errs=kernel_errs,
                float32_gaps=gaps, bf16_gaps=gaps16)


# ---------------------------------------------------------------------------
# Z. data-parallel training over torch.distributed
# ---------------------------------------------------------------------------

# A world-2 step against a world-1 step on the same global batch, as
# tests/test_torch_parallel.py holds them on the CPU: each metric to 1e-6
# relative, the parameters after DP_CHECK_AFTER steps to 1e-6.  The
# summation order differs (each rank reduces its block, then the ranks'
# mean), and AMSGrad's g/(|g| + eps)·lr turns a rounding difference of a
# gradient near 0 into up to lr.  So, as the step tests against JAX hold
# them (tests/test_torch_train_step.py, test_torch_motion_train.py), two
# kinds of elements are held to 2·lr per update (each rank's ±lr the
# other way): those whose gradient (after the motion step's clip) lay
# below 100·eps = 1e-6 at some update, and those of a leaf whose gradient
# vanishes in exact arithmetic and holds only rounding noise, its largest
# |g| below 1e-4 of the network's (a conv bias before an instance norm, a
# key bias before a softmax); at most DP_NEAR_SHARE of a network's
# elements may lie beyond 1e-6.
DP_RTOL = 1e-6
DP_PARAM_TOL = 1e-6
DP_CHECK_AFTER = 2
DP_NEAR_SHARE = {"g": 0.02, "d": 0.05, "m": 0.02}


def _grad_recorder(opt, clip):
    """Wrap ``opt.step`` to keep, per element, the least and the largest
    |g| it was given (after the global-norm clip at ``clip``, as AMSGrad
    sees it), and to count the updates."""
    box = {}
    inner = opt.step

    def step(grads):
        g = torch.cat([x.reshape(-1) for x in grads]).float().abs()
        if clip is not None:
            g = g * torch.clamp(clip / g.norm(), max=1.0)
        box["min"] = g if "min" not in box else torch.minimum(box["min"], g)
        box["max"] = g if "max" not in box else torch.maximum(box["max"], g)
        box["updates"] = box.get("updates", 0) + 1
        return inner(grads)

    opt.step = step
    box["leaves"] = [p.numel() for p in opt.params]
    return box


def _near_zero(rec) -> np.ndarray:
    """The elements :data:`DP_PARAM_TOL` does not hold (see above)."""
    near = rec["min"] < 1e-6
    top, off = rec["max"].max(), 0
    for n in rec["leaves"]:
        if rec["max"][off:off + n].max() < 1e-4 * top:
            near[off:off + n] = True
        off += n
    return near


def _kernel_launches() -> dict:
    from renderloom_torch.ops import norm_kernel as NK
    from renderloom_torch.ops import rasterize_kernel as RK
    from renderloom_torch.ops import upconv_kernel as UK

    return {"rasterize": RK.rasterize_tables_cuda.layout_launches["nhwc"],
            "instance_norm": NK.instance_norm_cuda.launches,
            "instance_norm_r3": NK.instance_norm_cuda.r3_launches,
            "instance_norm_bwd": NK.instance_norm_bwd_cuda.launches,
            "instance_norm_bwd_r3": NK.instance_norm_bwd_cuda.r3_launches,
            "upconv": UK.upconv_cuda.launches, **_warp_launches()}


def dp_gan_run(cfg, raws, device, seed=5):
    """The renderer's train step on this rank's block of each global batch
    of raw windows in ``raws`` (world size 1 without a process group):
    the metrics and seconds of each step, both flat parameter vectors
    after ``DP_CHECK_AFTER`` steps, the least |g| per element (world 1)
    and the kernels' launches."""
    from renderloom_torch.train.gan import (create_gan_state,
                                            make_gan_train_step,
                                            make_perceptual)

    device = torch.device(device)
    state = create_gan_state(cfg, device, seed=seed)
    near = {net: _grad_recorder(getattr(state, f"opt_{net}"), None)
            for net in ("g", "d")}
    step = make_gan_train_step(cfg, make_perceptual(cfg, device, seed=seed),
                               data_cfg=cfg.data)
    _reset_launches()
    return _dp_loop(step, state, raws, device, near,
                    {"g": state.opt_g, "d": state.opt_d})


def dp_motion_run(cfg, raws, stats, device, seed=9):
    """The motion transformer's train step, as :func:`dp_gan_run`."""
    from renderloom_torch.train.motion import (create_motion_state,
                                               make_train_step)

    device = torch.device(device)
    state = create_motion_state(cfg, device, seed=seed)
    near = {"m": _grad_recorder(state.opt, state.opt.clip_norm)}
    step = make_train_step(cfg, *stats)
    _reset_launches()
    return _dp_loop(step, state, raws, device, near, {"m": state.opt})


def _dp_loop(step, state, raws, device, near, opts):
    """Run ``step`` on this rank's block of each of ``raws``; snapshot the
    optimizers ``opts`` after ``DP_CHECK_AFTER`` steps."""
    from renderloom_torch.parallel import mesh

    sync = (torch.cuda.synchronize if device.type == "cuda"
            else lambda: None)
    metrics, seconds, params, updates, moments = [], [], None, None, None
    for i, raw in enumerate(raws):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in mesh.shard_batch(raw).items()}
        sync()
        tic = time.perf_counter()
        m = step(state, batch)
        sync()
        seconds.append(time.perf_counter() - tic)
        metrics.append({k: float(v) for k, v in m.items()})
        if i + 1 == DP_CHECK_AFTER:
            params = {k: o.flat.cpu().numpy().copy()
                      for k, o in opts.items()}
            moments = {k: o.mu.cpu().numpy().copy() for k, o in opts.items()}
            updates = {k: b["updates"] for k, b in near.items()}
    return dict(metrics=metrics, seconds=seconds, params=params,
                moments=moments, updates=updates, world=mesh.world()[1],
                launches=_kernel_launches(),
                near={k: _near_zero({**b, "min": b["min"].cpu().numpy(),
                                         "max": b["max"].cpu().numpy()})
                      for k, b in near.items()})


def dp_hold(name, one, two, lrs) -> dict:
    """Hold a world-2 run (rank 0's report; every rank's parameters are
    checked equal) against the world-1 run; returns the readings."""
    if any(not np.array_equal(r["params"][k], two[0]["params"][k])
           for r in two[1:] for k in r["params"]):
        raise AssertionError(f"{name}: the ranks' parameters differ")
    two = two[0]
    worst = 0.0
    for s, (a, b) in enumerate(zip(one["metrics"][:DP_CHECK_AFTER],
                                   two["metrics"])):
        for k, v in a.items():
            rel = abs(b[k] - v) / max(abs(v), 1e-30)
            worst = max(worst, rel if abs(b[k] - v) > 1e-12 else 0.0)
            if abs(b[k] - v) > DP_RTOL * abs(v) + 1e-12:
                raise AssertionError(f"{name}: step {s} {k} world 2 {b[k]} "
                                     f"world 1 {v}")
    far, loose = 0.0, {}
    for k, lr in lrs.items():
        err = np.abs(two["params"][k] - one["params"][k])
        near = one["near"][k]
        far = max(far, float(err[~near].max(initial=0)))
        loose[k] = int((err > DP_PARAM_TOL).sum())
        if err[~near].max(initial=0) > DP_PARAM_TOL or \
                err[near].max(initial=0) > 2 * lr * one["updates"][k] or \
                loose[k] > DP_NEAR_SHARE[k] * err.size:
            raise AssertionError(
                f"{name}: parameters {k} differ by "
                f"{err[~near].max(initial=0):.3e}, near-zero elements by "
                f"{err[near].max(initial=0):.3e}; {loose[k]} of {err.size} "
                f"beyond {DP_PARAM_TOL:.0e}")
    print(f"  {name}: world 2 vs world 1, metrics within {worst:.2e} "
          f"relative (tol {DP_RTOL:.0e}), parameters after "
          f"{DP_CHECK_AFTER} steps within {far:.2e} (tol "
          f"{DP_PARAM_TOL:.0e}) but near-zero-gradient elements, "
          + ", ".join(f"{k}: {n} of {two['params'][k].size}"
                      for k, n in loose.items()) + " beyond it, each "
          "within 2·lr per update (updates "
          + ", ".join(f"{k}: {n}" for k, n in one["updates"].items()) + ")")
    return dict(metrics_rel=worst, params_abs=far, near_beyond=loose)


# The full-width float32 GAN step on the card is not reproducible to the
# bit: cuDNN's convolution backward algorithms, as its heuristics choose
# them, add in an order that varies from run to run (phase G: two world-1
# runs give gradients within about 1e-6 of the largest |g| by default and
# bit for bit with cudnn.deterministic, which costs more windows/s than the
# 5% this repository accepts for such a repair, so it is not set), and
# AMSGrad's first updates turn that into ±lr on most parameters, so after
# one update the metrics of two world-1 runs differ by 1e-3 relative and
# more (NVIDIA H100 80GB HBM3, 700 W).  So on the card the
# GAN step is held with both learning rates 0, where nothing amplifies:
# every metric of every step to DP_RTOL, and each network's first moment
# (the averaged gradients as AMSGrad accumulates them) within
# DP_MOMENT_RTOL of its largest |mu|.  World 2 reads 3.3e-4 (G) and
# 5.4e-4 (D) there.  Two witnesses say where that comes from, and what
# the limit can see: world 2 run as two threads of one process
# (_ThreadWorld: the same ranks' arithmetic at B = 2 without processes,
# gloo or host copies) must meet the gloo run within DP_WITNESS_RTOL;
# and the same threads with a planted fault must fail the hold: no
# gradient mean (each rank keeps its own half's gradient) reads moments
# 0.17 (G) and 0.32 (D) of their largest; each rank dividing by its own
# counts reads the metrics 6.8e-4 apart but the moments only 8.2e-4 and
# 5.4e-4, so the metrics' DP_RTOL is what sees that one.  Threads against
# gloo read 6.9e-7 (G) and 4.4e-7 (D), the card's own noise: the gap to
# world 1 is the B = 2 arithmetic, not the transport.  The updates
# themselves are held on the CPU and by the motion step here.
DP_MOMENT_RTOL = 3e-3
DP_WITNESS_RTOL = 1e-5


def dp_gaps(one, two) -> dict:
    """Worst relative gap of every metric of every step (and whether each
    lies within DP_RTOL), and each network's first moments' worst gap
    over their largest |mu|, of the runs ``two`` (every rank) against
    ``one``; and whether every parameter stayed equal to ``one``'s."""
    worst, ok = 0.0, True
    for r in two:
        for a, b in zip(one["metrics"], r["metrics"]):
            for k, v in a.items():
                err = abs(b[k] - v)
                worst = max(worst, err / max(abs(v), 1e-30) if err else 0.0)
                ok = ok and err <= DP_RTOL * abs(v) + 1e-12
    moments = {k: max(np.abs(r["moments"][k] - m1).max() for r in two)
               / np.abs(m1).max() for k, m1 in one["moments"].items()}
    still = all(np.array_equal(r["params"][k], one["params"][k])
                for r in two for k in one["params"])
    return dict(metrics_rel=worst, metrics_ok=ok, moments_rel=moments,
                params_equal=still)


def dp_hold_gradients(name, one, two) -> dict:
    """Hold a world-2 run at learning rate 0 against the world-1 run:
    every metric of every step, the first moments, the ranks' parameters
    (equal, and unchanged)."""
    gaps = dp_gaps(one, two)
    if not gaps["metrics_ok"]:
        raise AssertionError(f"{name}: a metric differs by "
                             f"{gaps['metrics_rel']:.3e} relative")
    if max(gaps["moments_rel"].values()) > DP_MOMENT_RTOL or \
            not gaps["params_equal"]:
        raise AssertionError(f"{name}: first moments differ by "
                             f"{gaps['moments_rel']} of the largest, or the "
                             "parameters moved")
    print(f"  {name} (learning rates 0): world 2 vs world 1, every metric "
          f"of {len(one['metrics'])} steps within {gaps['metrics_rel']:.2e} "
          f"relative (tol {DP_RTOL:.0e}); first moments after "
          f"{DP_CHECK_AFTER} steps " + ", ".join(
              f"{k} {v:.2e}" for k, v in gaps["moments_rel"].items())
          + f" of their largest (tol {DP_MOMENT_RTOL:.0e})")
    return gaps


class _ThreadWorld:
    """``torch.distributed`` as ``renderloom_torch.parallel.mesh`` uses
    it, for ``size`` threads of this process, each a rank:
    ``all_reduce`` sums the ranks' tensors in rank order (for two ranks
    the sum gloo takes, a + b), ``broadcast`` copies the source's."""

    ReduceOp = torch.distributed.ReduceOp

    def __init__(self, size: int):
        import threading

        self.size, self.local = size, threading.local()
        self.barrier = threading.Barrier(size, timeout=900)
        self.slots = [None] * size

    def is_available(self):
        return True

    def is_initialized(self):
        return True

    def get_rank(self):
        return self.local.rank

    def get_world_size(self):
        return self.size

    def get_backend(self):
        return "gloo"

    def _exchange(self, t):
        self.slots[self.local.rank] = t.clone()
        self.barrier.wait()
        got = list(self.slots)
        self.barrier.wait()
        return got

    def all_reduce(self, t, op=None):
        got = self._exchange(t)
        total = got[0]
        for g in got[1:]:
            total = total + g
        t.copy_(total)

    def broadcast(self, t, src=0):
        t.copy_(self._exchange(t)[src])

    def run(self, fn, *args) -> list:
        """``fn(*args)`` on every rank, each a thread; rank 0's result
        first.  Raises where a rank failed."""
        import threading

        from renderloom_torch.parallel import mesh

        results, errors = [None] * self.size, []

        def body(rank):
            self.local.rank = rank
            try:
                results[rank] = fn(*args)
            except BaseException as e:      # re-raised below
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(self.size)]
        real, mesh.dist = mesh.dist, self
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            mesh.dist = real
        if errors:
            raise errors[0]
        return results


def _dp_witnesses(rcfg, raws, one, two, device="cuda") -> dict:
    """The GAN step's world 2 as threads, sound and with the planted
    faults, against the gloo world 2 and world 1 (see DP_MOMENT_RTOL)."""
    import renderloom_torch.train.gan as G

    out = {}
    raws = raws[:DP_CHECK_AFTER]        # the moments are read there
    threads = _ThreadWorld(2).run(dp_gan_run, rcfg, raws, device)
    out["threads_vs_gloo"] = dp_gaps(two[0], threads)
    out["threads_vs_world1"] = dp_gaps(one, threads)
    faults = {"no gradient mean": ("all_reduce_mean", lambda t: t),
              "local counts": ("count_share",
                               lambda c: torch.clamp(c.detach(), min=1.0))}
    for fault, (name, planted) in faults.items():
        real = getattr(G, name)
        setattr(G, name, planted)
        try:
            bad = _ThreadWorld(2).run(dp_gan_run, rcfg, raws, device)
        finally:
            setattr(G, name, real)
        out[fault] = dp_gaps(one, bad)
    fmt = lambda g: (f"metrics {g['metrics_rel']:.2e}, moments " + ", ".join(
        f"{k} {v:.2e}" for k, v in g["moments_rel"].items()))
    print(f"  gan witnesses (learning rates 0; moments over their largest):"
          f"\n    world 2 as threads vs world 2 over gloo: "
          f"{fmt(out['threads_vs_gloo'])} (tol {DP_WITNESS_RTOL:.0e}); vs "
          f"world 1: {fmt(out['threads_vs_world1'])}" + "".join(
              f"\n    planted fault, {f}: vs world 1 {fmt(out[f])}"
              for f in faults))
    if max(out["threads_vs_gloo"]["moments_rel"].values()) > \
            DP_WITNESS_RTOL or not out["threads_vs_gloo"]["metrics_ok"]:
        raise AssertionError("gan: world 2 as threads departs from world 2 "
                             "over gloo")
    if max(out["no gradient mean"]["moments_rel"].values()) <= \
            DP_MOMENT_RTOL or out["local counts"]["metrics_ok"]:
        raise AssertionError("gan: the hold does not see a planted fault")
    return out


def _residual_check(name, x, s, b, slope) -> float:
    """K2's training call (output and (B, C, 3) residuals) against the
    twin's, at phase 2's and phase B's tolerances."""
    from renderloom_torch.ops import norm_kernel as NK

    stats = torch.empty((x.shape[0], x.shape[-1], 3), device="cuda")
    y = NK.instance_norm_cuda(x, s, b, slope, 1e-5, stats)
    want, want_stats = NK._plain_forward(x, s, b, slope, 1e-5)
    atol, rtol = _k2_tol(tuple(x.shape), x.dtype)
    compare(f"{name} residuals", stats, want_stats, 1e-5, 1e-5)
    return compare(f"{name} y", y, want, atol, rtol)


def _dp_kernels(train) -> float:
    """K2 with residuals and K2b against their twins at the world-2
    GAN step's per-rank batch (2): every forward and backward shape of
    phase T's step with B = 2."""
    print(f"  K2 (with residuals) at {len(train['fwd'])} and K2b at "
          f"{len(train['bwd'])} shapes of the training step at B = 2, vs "
          "twins:")
    err, big = 0.0, lambda k: -np.prod(k[0])
    for i, key in enumerate(sorted(train["fwd"], key=big)):
        x, s, b = _norm_inputs((2,) + key[0][1:], torch.float32, key[1],
                               seed=880 + i)
        err = max(err, _residual_check(f"K2 {(2,) + key[0][1:]}", x, s, b,
                                       key[2]))
    for i, key in enumerate(sorted(train["bwd"], key=big)):
        x, dy, s, b = _bwd_inputs((2,) + key[0][1:], key[1], 940 + i)
        err = max(err, _bwd_check(f"K2b {(2,) + key[0][1:]}", x, dy, s, b,
                                  key[2]))
    return err


def _dp_motion_case(cfg, n_steps, seed=12):
    """Global batches of ``cfg``'s size and length, with pad masks that
    differ per sample (so a loss's global count matters), and
    statistics."""
    from renderloom_torch.cli.train_motion import synthetic_batches

    B, L = cfg.batch_size, cfg.dataset.max_seq_length
    raws = list(synthetic_batches(np.random.default_rng(seed), n_steps, B,
                                  L))
    for raw in raws:
        for b in range(B):
            raw["pad_mask"][b, L - (b * 7) % (L // 2):] = True
    rng = np.random.default_rng(seed + 1)
    stats = (rng.normal(scale=0.1, size=(19, 2)).astype(np.float32),
             rng.uniform(0.2, 1.0, (19, 2)).astype(np.float32))
    return raws, stats


def _dp_gan_raws(cfg, n_steps, seed=3):
    from renderloom_torch.cli.train_renderer import synthetic_batches

    d = cfg.data
    return list(synthetic_batches(np.random.default_rng(seed), n_steps,
                                  cfg.batch_size, d.max_frames,
                                  d.load_height, d.load_width))


def phase_data_parallel(train):
    """Z: the two steps at world 2 (gloo, both ranks on the card) against
    world 1 on the same global batches, the GAN step's witnesses, K2 and
    K2b at the world-2 batch (phase T's shapes, ``train``), then the
    motion CLI under torchrun with NCCL, then the port's bench."""
    import dataclasses
    import shutil

    from renderloom_torch.core.config import load_motion_config
    from renderloom_torch.parallel import run_ranks

    out = {}
    mcfg = load_motion_config(os.path.join(ROOT, "configs", "motion.yaml"))
    mcfg = dataclasses.replace(mcfg, transformer=dataclasses.replace(
        mcfg.transformer, dropout=0.0))
    rcfg = _train_cfg()
    still = dataclasses.replace(rcfg, optim=dataclasses.replace(
        rcfg.optim, lr=0.0, lr_d=0.0))
    print(f"Z. data parallel: world 2 (gloo, both ranks on this card) vs "
          f"world 1 on the same global batches; motion.yaml (B "
          f"{mcfg.batch_size}, L {mcfg.dataset.max_seq_length}, dropout 0) "
          f"and hsm.yaml (B {rcfg.batch_size} x {rcfg.data.max_frames}-frame "
          f"raw windows, float32)")
    for name, run, args, unit, n in (
            ("motion", dp_motion_run,
             (mcfg, *_dp_motion_case(mcfg, DP_CHECK_AFTER + 4)), "seqs",
             mcfg.batch_size),
            ("gan", dp_gan_run, (still, _dp_gan_raws(still,
                                                     DP_CHECK_AFTER + 1)),
             "windows", rcfg.batch_size)):
        tic = time.perf_counter()
        one = run(*args, "cuda")
        t_one = time.perf_counter() - tic
        tic = time.perf_counter()
        two = run_ranks(run, 2, "cuda", backend="gloo", args=args + ("cuda",))
        t_two = time.perf_counter() - tic
        held = (dp_hold(name, one, two, {"m": mcfg.optim.lr})
                if name == "motion" else dp_hold_gradients(name, one, two))
        if name == "gan" and (
                any(r["launches"] != one["launches"] for r in two)
                or not all(one["launches"][k] for k in (
                    "rasterize", "instance_norm", "instance_norm_bwd"))
                or one["launches"]["upconv"]):
            raise AssertionError(f"gan launches: world 1 {one['launches']}, "
                                 f"world 2 {[r['launches'] for r in two]}")
        rate = lambda r: n * len(r["seconds"][1:]) / sum(r["seconds"][1:])
        print(f"    {unit}/s after the first step: world 1 "
              f"{rate(one):.3f}, world 2 {rate(two[0]):.3f} (steps "
              + ", ".join(f"{s * 1e3:.0f}" for s in one["seconds"])
              + " and " + ", ".join(f"{s * 1e3:.0f}"
                                    for s in two[0]["seconds"])
              + f" ms); launches world 1 {one['launches']}, world 2 per "
              f"rank {[r['launches'] for r in two]}; {t_one:.1f} s and "
              f"{t_two:.1f} s with the set-up")
        out[name] = dict(held, world1=rate(one), world2=rate(two[0]),
                         launches1=one["launches"],
                         launches2=[r["launches"] for r in two])
        if name == "gan":
            out["witnesses"] = _dp_witnesses(*args[:2], one, two)
    out["kernels_max_abs_err"] = _dp_kernels(train)

    # the motion CLI under torchrun, one rank on NCCL
    run_dir = os.path.join(ROOT, "build", "chip_smoke_dp")   # not brought back
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=1", "-m", "renderloom_torch.cli.train_motion",
         "--synthetic", "--epochs", "1", "--steps-per-epoch", "3",
         "--out-dir", run_dir], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    said = [ln for ln in proc.stdout.splitlines() if ln.startswith("world:")]
    print(f"  torchrun --nproc_per_node=1 train_motion: exit "
          f"{proc.returncode}, {said}")
    if proc.returncode != 0 or said != ["world: 1 backend: nccl"] or \
            not os.path.exists(os.path.join(run_dir, "checkpoint.pt")):
        raise AssertionError(f"torchrun train_motion:\n{proc.stdout[-2000:]}"
                             f"\n{proc.stderr[-4000:]}")
    shutil.rmtree(run_dir)

    # the port's bench, one process per metric
    out["bench"] = {}
    for metric in ("e2e", "motion_train", "gan_train"):
        proc = subprocess.run(
            [sys.executable, "-m", "renderloom_torch.bench"], cwd=ROOT,
            env={**os.environ, "BENCH_METRIC": metric}, capture_output=True,
            text=True, timeout=600)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or len(lines) != 1:
            raise AssertionError(f"bench {metric}: exit {proc.returncode}\n"
                                 f"{proc.stdout}\n{proc.stderr[-4000:]}")
        print(f"  bench {metric}: {lines[0]}")
        out["bench"][metric] = json.loads(lines[0])
    return out


# ---------------------------------------------------------------------------
# L. the learned flow UNet, K. the pose head, V2. the pipeline CLI on both
# ---------------------------------------------------------------------------

TRAIN_HW = (256, 384)       # the flow and pose training CLIs' default size
TRAIN_STEPS = 6             # synthetic steps each training CLI takes
SMALL_HW = (64, 96)         # card against CPU
LEARNED_DIR = os.path.join(ROOT, "build", "chip_smoke_learned")  # not copied
# Card against CPU at SMALL_HW with identical weights, inputs and draws
# (the flow UNet at FlowConfig()'s widths, the pose head at
# PoseNetConfig()'s, seeded weights with nonzero heads).  float32: the
# outputs (flows, time-warped frames, logits) over their largest
# magnitude, the train step's metrics relative, and its parameters: a
# first Adam update is lr·g/(|g| + eps), so a parameter whose |g| lies at
# the gradients' rounding level may move by up to 2·lr the other way; at
# most LEARNED_FLIP_SHARE of the elements may lie beyond 1e-6.  bf16 (the
# UNet's flows): the mean |card - CPU| over the flows' largest within
# LEARNED_BF16_MEAN, and the card's float32 flows against the CPU's bf16
# (the control) beyond it.  Readings on an NVIDIA H100 80GB HBM3 at
# 700 W: flows 1.8e-6, time_warp 1.8e-7, logits 1.3e-6, keypoints
# 2.5e-4 px; the flow step's metrics 2.1e-7 and parameters 1.5e-7 (none
# beyond 1e-6), the pose step's 1.3e-6 and 1.2e-4 (0.024% beyond); bf16
# 5.6e-4 with the control at 1.56e-3.  The limits are 5-10x the float32
# readings, 20x the share and 1.35x the bf16 reading.
LEARNED_F32_RTOL = 1e-5
LEARNED_STEP_RTOL = 1e-5
LEARNED_FLIP_SHARE = 5e-3
LEARNED_BF16_MEAN = 7.5e-4


def _flat_yaml(path: str, cfg) -> str:
    """Write a flow or pose config as yaml; raises unless the port's
    loader reads it back equal."""
    import dataclasses

    import yaml

    from renderloom_torch.core import config as C

    with open(path, "w") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f)
    load = (C.load_flow_config if isinstance(cfg, C.FlowConfig)
            else C.load_pose_config)
    if load(path) != cfg:
        raise AssertionError(f"{path} does not load as the config written")
    return path


def _steps_per_sec(fn, n: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return n / (time.perf_counter() - tic)


def _train_cli(cli, run_dir: str, extra: list) -> dict:
    """``cli.main`` (train_flow or train_pose) on synthetic data at
    TRAIN_HW for TRAIN_STEPS steps, every step logged: the final state,
    the checkpoint, the CLI's steps/s (host-side data generation
    included), peak memory and the losses."""
    H, W = TRAIN_HW
    real = cli.TRAIN_LOG_EVERY
    cli.TRAIN_LOG_EVERY = 1
    torch.cuda.reset_peak_memory_stats()
    try:
        res = cli.main(["--synthetic", "--epochs", "1", "--steps-per-epoch",
                        str(TRAIN_STEPS), "--height", str(H), "--width",
                        str(W), "--out-dir", run_dir, "--device", DEVICE]
                       + extra)
    finally:
        cli.TRAIN_LOG_EVERY = real
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    recs = _jsonl(os.path.join(run_dir, "metrics.jsonl"))
    ckpt = os.path.join(run_dir, "checkpoint.pt")
    if len(recs) != TRAIN_STEPS or res["state"].step != TRAIN_STEPS or \
            not os.path.exists(ckpt):
        raise AssertionError(f"{run_dir}: {len(recs)} records, step "
                             f"{res['state'].step}")
    if any(r["train/notfinite"] for r in recs) or not all(
            np.isfinite(v) for r in recs for v in r.values()):
        raise AssertionError(f"{run_dir}: non-finite or skipped updates")
    ep = res["epochs"][0]
    return dict(state=res["state"], ckpt=ckpt, peak_gib=peak,
                cli_steps_per_sec=ep["steps"] / ep["seconds"],
                losses=[r["train/loss/total"] for r in recs])


def _params_gap(got: torch.Tensor, want: torch.Tensor, lr: float) -> dict:
    """A card train step's flat parameters against the CPU's (see
    LEARNED_FLIP_SHARE)."""
    err = (got.cpu() - want).abs()
    return dict(max=err.max().item(),
                beyond=(err > 1e-6).float().mean().item(),
                ok=bool(err.max() <= 2 * lr + 1e-6
                        and (err > 1e-6).float().mean() <= LEARNED_FLIP_SHARE))


def _metrics_gap(got: dict, want: dict) -> float:
    return max(abs(float(got[k]) - float(want[k]))
               / max(abs(float(want[k])), 1e-12) for k in want)


def _flow_cpu_match(flows_cfg) -> dict:
    """The UNet's flows (float32 and bf16), ``time_warp`` and one train
    step, card against CPU at SMALL_HW."""
    import dataclasses

    from renderloom_torch.cli.train_flow import synthetic_triplets
    from renderloom_torch.convert import flax_trees, random_init_
    from renderloom_torch.models.flownet import time_warp
    from renderloom_torch.train.flow import (build_flow_model,
                                             create_flow_state,
                                             make_flow_train_step)

    H, W = SMALL_HW
    trip = torch.from_numpy(next(synthetic_triplets(
        np.random.default_rng(4), 1, 2, H, W))["frames"])
    tree = flax_trees(random_init_(build_flow_model(flows_cfg), 7))[0]
    out = {}
    flows = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(flows_cfg, compute_dtype=dtype)
        for dev in ("cpu", DEVICE):
            model = create_flow_state(cfg, dev, params=tree).model.eval()
            x = trip.to(dev)
            with torch.no_grad():
                f01, f10 = model(x[:, 0], x[:, 2])
                warped = time_warp(x[:, 0], x[:, 2], f01, f10, 0.5,
                                   max_disp=cfg.max_disp)
            flows[dtype, dev] = (torch.cat([f01, f10], -1).cpu(),
                                 warped.cpu())
    (fc, wc), (fg, wg) = flows["float32", "cpu"], flows["float32", DEVICE]
    scale = fc.abs().max().item()
    out["flows"] = (fg - fc).abs().max().item() / scale
    out["time_warp"] = (wg - wc).abs().max().item() / wc.abs().max().item()
    b16c, b16g = flows["bfloat16", "cpu"][0], flows["bfloat16", DEVICE][0]
    out["bf16_mean"] = (b16g - b16c).abs().mean().item() / scale
    out["bf16_control"] = (fg - b16c).abs().mean().item() / scale
    runs = {}
    for dev in ("cpu", DEVICE):
        state = create_flow_state(flows_cfg, dev, params=tree)
        m = make_flow_train_step(flows_cfg)(state, {"frames": trip.to(dev)})
        runs[dev] = ({k: float(v) for k, v in m.items()},
                     state.opt.flat.detach().cpu())
    out["step_metrics"] = _metrics_gap(runs[DEVICE][0], runs["cpu"][0])
    out["step_params"] = _params_gap(runs[DEVICE][1], runs["cpu"][1],
                                     flows_cfg.lr)
    print(f"  card vs CPU at {W}x{H} (FlowConfig() widths, seeded weights): "
          f"flows {out['flows']:.3e} of their largest ({scale:.3f} px; tol "
          f"{LEARNED_F32_RTOL:.0e}), time_warp {out['time_warp']:.3e} (tol "
          f"{LEARNED_F32_RTOL:.0e}); one train step: metrics "
          f"{out['step_metrics']:.3e} relative (tol {LEARNED_STEP_RTOL:.0e}),"
          f" parameters max {out['step_params']['max']:.3e}, "
          f"{100 * out['step_params']['beyond']:.3f}% beyond 1e-6; bf16 "
          f"flows mean {out['bf16_mean']:.3e} of the largest (tol "
          f"{LEARNED_BF16_MEAN:.1e}), control (card float32 vs CPU bf16, "
          f"must lie beyond it) {out['bf16_control']:.3e}")
    if not (out["flows"] <= LEARNED_F32_RTOL
            and out["time_warp"] <= LEARNED_F32_RTOL
            and out["step_metrics"] <= LEARNED_STEP_RTOL
            and out["step_params"]["ok"]
            and out["bf16_mean"] <= LEARNED_BF16_MEAN
            < out["bf16_control"]):
        raise AssertionError(f"flow UNet card vs CPU: {out}")
    return out


def phase_flow(serve) -> dict:
    """L: the flow UNet's training CLI in float32 and bf16, the learned
    backgrounds of phase 4's keyframes beside LK's, card vs CPU."""
    import dataclasses
    import shutil

    from renderloom_torch.cli import infer_renderer, train_flow
    from renderloom_torch.core.config import FlowConfig
    from renderloom_torch.eval.pipeline import FLOW
    from renderloom_torch.ops.flow import upsample_background
    from renderloom_torch.train.flow import make_flow_train_step

    H, W = TRAIN_HW
    cfg0 = FlowConfig()
    print(f"L. learned flow: FlowConfig() (base {cfg0.base_filters}, levels "
          f"{cfg0.levels}), train_flow --synthetic at {W}x{H}, batch "
          f"{cfg0.batch_size}, {TRAIN_STEPS} steps, float32 and bf16; seeded "
          f"weights")
    shutil.rmtree(LEARNED_DIR, ignore_errors=True)
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(cfg0, compute_dtype=dtype)
        run_dir = os.path.join(LEARNED_DIR, f"flow_{dtype}")
        os.makedirs(run_dir)
        res = _train_cli(train_flow, run_dir, [
            "--config", _flat_yaml(os.path.join(run_dir, "flow.yaml"), cfg)])
        step = make_flow_train_step(cfg)
        batch = {"frames": torch.from_numpy(next(train_flow.synthetic_triplets(
            np.random.default_rng(3), 1, cfg.batch_size, H, W))["frames"]
        ).to(DEVICE)}
        sps = _steps_per_sec(lambda: step(res["state"], batch))
        print(f"  {dtype}: the CLI {res['cli_steps_per_sec']:.2f} steps/s "
              f"(its synthetic data made on the host included), the step "
              f"alone {sps:.2f} steps/s = {sps * cfg.batch_size:.1f} "
              f"triplets/s; peak {res['peak_gib']:.2f} GiB; losses "
              + ", ".join(f"{v:.4f}" for v in res["losses"]))
        out[dtype] = dict(res, steps_per_sec=sps)
        del out[dtype]["state"]

    motion, conf, keys = serve["inputs"]
    rate = serve["rate"]
    keys = keys[0]
    interp = infer_renderer.load_flow_interp(out["float32"]["ckpt"], None,
                                             DEVICE)
    with torch.inference_mode():
        _reset_launches()
        backs = upsample_background(keys, rate, interp_fn=interp)
        torch.cuda.synchronize()
        if _warp_launches() != _time_warps(rate):
            raise AssertionError(f"learned backgrounds: shift warp launches "
                                 f"{_warp_launches()}, want "
                                 f"{_time_warps(rate)}")
        out["launches"] = _warp_launches()
        L = (keys.shape[0] - 1) * rate + 1
        if tuple(backs.shape) != (L,) + tuple(keys.shape[1:]) or \
                not bool(torch.isfinite(backs).all()) or \
                not torch.equal(backs[::rate], keys):
            raise AssertionError(f"learned backgrounds {tuple(backs.shape)}")
        ms = {"learned": cuda_ms(
            lambda: upsample_background(keys, rate, interp_fn=interp), 3, 1),
            "LK (the CLIs' full-resolution flow)": cuda_ms(
                lambda: upsample_background(keys, rate), 3, 1),
            "LK (the in-memory pipeline's flow_scale 4)": cuda_ms(
                lambda: upsample_background(keys, rate, **FLOW), 3, 1)}
    print(f"  learned upsample_background of phase 4's {keys.shape[0]} "
          f"keyframes at {keys.shape[2]}x{keys.shape[1]}, rate {rate} "
          f"({int(np.log2(rate))} doublings) from the float32 checkpoint: "
          f"{tuple(backs.shape)} finite, keyframes exact; ms per clip: "
          + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
          + f" ({card_line()})")
    out["backgrounds_ms"] = ms
    out["cpu_match"] = _flow_cpu_match(cfg0)
    return out


def _pose_cpu_match(cfg0) -> dict:
    """The head's logits and keypoints, and one train step with
    occlusion on shared draws, card against CPU at SMALL_HW."""
    from renderloom_torch.convert import flax_trees, random_init_
    from renderloom_torch.models.posenet import decode_heatmaps
    from renderloom_torch.train.pose import (build_pose_model,
                                             create_pose_state, draw_erase,
                                             erase_generator,
                                             make_pose_train_step)
    from renderloom_torch.cli.train_pose import synthetic_batches

    H, W = SMALL_HW
    raw = next(synthetic_batches(np.random.default_rng(6), 1, 4, H, W))
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    draws = draw_erase(erase_generator(2, 0), 4, cfg0.occlude_count,
                       cfg0.occlude_frac)
    tree = flax_trees(random_init_(build_pose_model(cfg0), 8))[0]
    runs = {}
    for dev in ("cpu", DEVICE):
        state = create_pose_state(cfg0, dev, params=tree)
        with torch.no_grad():
            logits = state.model(batch["images"].to(dev))
            kps, conf = decode_heatmaps(logits)
        m = make_pose_train_step(cfg0)(
            state, {k: v.to(dev) for k, v in batch.items()}, draws)
        runs[dev] = (logits.cpu(), kps.cpu(), conf.cpu(),
                     {k: float(v) for k, v in m.items()},
                     state.opt.flat.detach().cpu())
    (lc, kc, cc, mc, pc), (lg, kg, cg, mg, pg) = runs["cpu"], runs[DEVICE]
    out = dict(logits=(lg - lc).abs().max().item() / lc.abs().max().item(),
               kps_px=(kg - kc).abs().max().item(),
               conf=(cg - cc).abs().max().item(),
               step_metrics=_metrics_gap(mg, mc),
               step_params=_params_gap(pg, pc, cfg0.lr))
    print(f"  card vs CPU at {W}x{H} (PoseNetConfig() widths, seeded "
          f"weights): logits {out['logits']:.3e} of their largest (tol "
          f"{LEARNED_F32_RTOL:.0e}), keypoints {out['kps_px']:.3e} px (tol "
          f"1e-3), confidences {out['conf']:.3e}; one train step with "
          f"occlusion (rate {cfg0.occlude_rate}, shared draws): metrics "
          f"{out['step_metrics']:.3e} relative (tol "
          f"{LEARNED_STEP_RTOL:.0e}), parameters max "
          f"{out['step_params']['max']:.3e}, "
          f"{100 * out['step_params']['beyond']:.3f}% beyond 1e-6")
    if not (out["logits"] <= LEARNED_F32_RTOL and out["kps_px"] <= 1e-3
            and out["step_metrics"] <= LEARNED_STEP_RTOL
            and out["step_params"]["ok"]):
        raise AssertionError(f"pose head card vs CPU: {out}")
    return out


def _write_keyframes(path: str, keys: torch.Tensor) -> np.ndarray:
    """Phase 4's keyframes (K, H, W, 3) in [0, 1] as PNGs; returns them
    as uint8."""
    from PIL import Image

    os.makedirs(path)
    keys_u8 = (keys * 255).round().to(torch.uint8).cpu().numpy()
    for i, key in enumerate(keys_u8):
        Image.fromarray(key).save(os.path.join(path, f"{i:03d}.png"))
    return keys_u8


def phase_pose(serve, probe) -> dict:
    """K: the pose head's training CLI with occlusion, ``extract_folder``
    over phase 4's keyframes, card vs CPU."""
    import dataclasses

    from renderloom_torch.cli import extract_pose, train_pose
    from renderloom_torch.core.config import PoseNetConfig
    from renderloom_torch.data.openpose import read_openpose_dir
    from renderloom_torch.train.pose import make_pose_train_step

    H, W = TRAIN_HW
    cfg = dataclasses.replace(PoseNetConfig(), occlude_rate=0.5)
    print(f"K. pose head: PoseNetConfig() (base {cfg.base_filters}, "
          f"{cfg.blocks} blocks), train_pose --synthetic --occlude-rate "
          f"{cfg.occlude_rate} at {W}x{H}, batch {cfg.batch_size}, "
          f"{TRAIN_STEPS} steps, float32; seeded weights")
    run_dir = os.path.join(LEARNED_DIR, "pose")
    os.makedirs(run_dir)
    res = _train_cli(train_pose, run_dir,
                     ["--occlude-rate", str(cfg.occlude_rate)])
    step = make_pose_train_step(cfg)
    raw = next(train_pose.synthetic_batches(np.random.default_rng(5), 1,
                                            cfg.batch_size, H, W))
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in raw.items()}
    sps = _steps_per_sec(lambda: step(res["state"], batch))
    print(f"  the CLI {res['cli_steps_per_sec']:.2f} steps/s (its synthetic "
          f"data made on the host included), the step alone {sps:.2f} "
          f"steps/s = {sps * cfg.batch_size:.1f} images/s; peak "
          f"{res['peak_gib']:.2f} GiB; losses "
          + ", ".join(f"{v:.4f}" for v in res["losses"]))
    out = dict(res, steps_per_sec=sps)
    del out["state"]
    if _skip_line("K", "extract_folder", [m for m in ("PIL",)
                                           if not probe[m]]):
        keys = serve["inputs"][2][0]
        frames = os.path.join(LEARNED_DIR, "keyframes")
        _write_keyframes(frames, keys)
        model = extract_pose.load_pose_model(res["ckpt"], PoseNetConfig(),
                                             DEVICE)
        poses = os.path.join(LEARNED_DIR, "poses")
        tic = time.perf_counter()
        n = extract_pose.extract_folder(model, frames, poses, H, W)
        torch.cuda.synchronize()
        sec = time.perf_counter() - tic
        motion, conf, _ = read_openpose_dir(poses)
        if n != keys.shape[0] or motion.shape != (19, 2, n) or \
                not np.isfinite(motion).all():
            raise AssertionError(f"extract_folder: {n} JSONs, "
                                 f"{motion.shape}")
        print(f"  extract_folder over phase 4's {n} keyframes "
              f"({keys.shape[2]}x{keys.shape[1]} PNGs) at {W}x{H}, batch 8: "
              f"{n} JSONs in {sec:.3f} s ({n / sec:.1f} frames/s, PNG "
              f"reading and JSON writing included), read back by "
              f"data/openpose.py, confidences {conf.min():.3f}-"
              f"{conf.max():.3f}")
        out["extract_frames_per_sec"] = n / sec
    out["cpu_match"] = _pose_cpu_match(cfg)
    return out


def phase_serve_learned(serve, files, flow, pose, probe) -> dict:
    """V2: the pipeline CLI at full width with ``--pose-ckpt`` and
    ``--flow-ckpt`` (phases K and L's float32 checkpoints) on phase 4's
    weights, K1 and K2 launched as in phase V's LK run."""
    import shutil

    from renderloom_torch.cli import pipeline as pipeline_cli
    from renderloom_torch.models.layers import InstanceNorm, Spade

    mcfg, rcfg, rate, K = (serve[k] for k in ("mcfg", "rcfg", "rate", "K"))
    H, W = rcfg.data.model_height, rcfg.data.model_width
    L = (K - 1) * rate + 1
    if not _skip_line("V2", "pipeline CLI", [m for m in ("PIL",)
                                            if not probe[m]]):
        return {}
    print(f"V2. the pipeline CLI at {W}x{H}, rate {rate}, {K} keyframes, "
          f"poses from --pose-ckpt (phase K) at 384x256, learned "
          f"backgrounds from --flow-ckpt (phase L), phase 4's weights, "
          f"float32")
    work = os.path.join(LEARNED_DIR, "serve")
    os.makedirs(work)
    gen = serve["gen"]
    ckpts = (os.path.join(work, "motion.pt"),
             os.path.join(work, "renderer.pt"))
    torch.save(serve["interp"].model.state_dict(), ckpts[0])
    torch.save({"step": 0, "gen": gen.state_dict()}, ckpts[1])
    frames = os.path.join(work, "frames")
    keys_u8 = _write_keyframes(frames, serve["inputs"][2][0])
    cfgs = (_yaml_cfg(os.path.join(work, "motion.yaml"), mcfg),
            _yaml_cfg(os.path.join(work, "renderer.yaml"), rcfg))
    out_dir = os.path.join(work, "out")

    def run():
        return pipeline_cli.main([
            "--frames-dir", frames, "--pose-ckpt", pose["ckpt"],
            "--flow-ckpt", flow["float32"]["ckpt"], "--motion-ckpt",
            ckpts[0], "--renderer-ckpt", ckpts[1], "--motion-config",
            cfgs[0], "--renderer-config", cfgs[1], "--out-dir", out_dir,
            "--rate", str(rate), "--device", DEVICE])

    run()                               # warm-up
    _reset_launches()
    calls = []
    restore = _raster_recorder(calls)
    try:
        seconds = run()
        torch.cuda.synchronize()
    finally:
        restore()
    launches = _serve_launches()
    per_step = sum(isinstance(m, (InstanceNorm, Spade))
                   for m in gen.modules())
    S = (L - 1) // rate
    chunks = -(-S // max(min(16, S), 64 // rate))
    want = {"rasterize": chunks, "rasterize_packed": 0,
            "instance_norm": chunks * (rate - 1) * per_step,
            "instance_norm_parity": 0, "instance_norm_r3": 0,
            "upconv": chunks * (rate - 1) * _count_upconvs(gen),
            **_time_warps(rate)}
    lk = files["serve_files"]
    print(f"  launches {launches}; derived {want}, phase V's LK run "
          f"{lk['launches']}")
    if launches != want or dict(launches, **_lk_warps(0)) != \
            lk["launches"] or any(c[0][6] for c in calls):
        raise AssertionError(f"V2 kernel launches {launches}")
    got = _png_dir(os.path.join(out_dir, "Generated_frames"))
    n_poses = len(os.listdir(os.path.join(out_dir, "poses")))
    n_dain = len(os.listdir(os.path.join(out_dir, "DAIN")))
    key_err = _levels(got[::rate], keys_u8)[0]
    if got.shape != (L, H, W, 3) or (n_poses, n_dain) != (K, L) or \
            key_err > 1:
        raise AssertionError(f"V2: frames {got.shape}, {n_poses} poses, "
                             f"{n_dain} backgrounds, keyframes {key_err}")
    _k1_check("V2 K1 on the run's tables", calls[0][0][:3], H, W,
              torch.float32, False, "nhwc")
    total = sum(seconds.values())
    print(f"  {L} frames, {K} extracted poses, {L} learned backgrounds; "
          f"keyframes within {key_err} level; seconds: " + ", ".join(
              f"{k} {v:.3f}" for k, v in seconds.items())
          + f"; files-in/frames-out {L / total:.3f} frames/s beside phase "
          f"V's LK run {lk['fps']:.3f} ({card_line()})")
    shutil.rmtree(LEARNED_DIR)
    return dict(launches=launches, seconds=seconds, fps=L / total)


# ---------------------------------------------------------------------------
# G. reproducibility of the train steps on the card
# ---------------------------------------------------------------------------


def _resize_interpolate_aa(img: torch.Tensor, height: int,
                           width: int) -> torch.Tensor:
    """The antialiased resize as torch's ``F.interpolate(antialias=True)``
    computes it (``ops.image.resize_bilinear``'s CPU form) on the card,
    where its backward adds with atomics."""
    y = F.interpolate(img.permute(0, 3, 1, 2).float(), size=(height, width),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.to(img.dtype).permute(0, 2, 3, 1)


class _Settings:
    """Reproducibility settings for one block: ``torch.
    use_deterministic_algorithms(True, warn_only=True)`` with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (``torch_det``),
    ``cudnn.deterministic`` (``cudnn_det``), and the discriminators'
    resize (``resize``); records the operators torch names as having no
    deterministic implementation."""

    def __init__(self, torch_det=False, cudnn_det=False, resize=None):
        self.torch_det, self.cudnn_det, self.resize = (torch_det, cudnn_det,
                                                       resize)
        self.named = set()

    def __enter__(self):
        import warnings

        from renderloom_torch.models import discriminator

        self._env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        if self.torch_det:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(self.torch_det, warn_only=True)
        torch.backends.cudnn.deterministic = self.cudnn_det
        self._resize = discriminator.resize_bilinear
        if self.resize is not None:
            discriminator.resize_bilinear = self.resize
        self._warn = warnings.catch_warnings(record=True)
        self._log = self._warn.__enter__()
        warnings.simplefilter("always")
        return self

    def __exit__(self, *exc):
        from renderloom_torch.models import discriminator

        self._warn.__exit__(*exc)
        self.named |= {str(w.message).split(" does not have")[0]
                       for w in self._log if "does not have a deterministic"
                       in str(w.message)}
        discriminator.resize_bilinear = self._resize
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)
        if self._env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = self._env
        return False


def _gan_snapshot(state) -> dict:
    clone = lambda opt: {k: v.clone() for k, v in opt.state_dict().items()}
    return dict(g=clone(state.opt_g), d=clone(state.opt_d),
                buffers=[b.clone() for m in (state.gen, state.dis)
                         for b in m.buffers()],
                rng=state.rng.get_state(), step=state.step)


def _gan_restore(state, snap):
    for name in ("g", "d"):
        getattr(state, f"opt_{name}").load_state_dict(
            {k: v.clone() for k, v in snap[name].items()})
    with torch.no_grad():
        for b, s in zip([b for m in (state.gen, state.dis)
                         for b in m.buffers()], snap["buffers"]):
            b.copy_(s)
    state.rng.set_state(snap["rng"])
    state.step = snap["step"]


def _gan_run(state, snap, step, batches, lr0: bool) -> dict:
    """From the snapshot, ``step`` over ``batches``: each update's flat
    gradients per network, the metrics, the parameters after, and the
    seconds of each step; with ``lr0`` both learning rates are 0."""
    _gan_restore(state, snap)
    grads, saved = {"g": [], "d": []}, {}
    for name in ("g", "d"):
        opt = getattr(state, f"opt_{name}")
        saved[name] = (opt.step, opt.schedule)
        inner = opt.step

        def rec(gs, inner=inner, box=grads[name]):
            box.append(torch.cat([x.reshape(-1) for x in gs]).float())
            return inner(gs)

        opt.step = rec
        if lr0:
            opt.schedule = lambda c: torch.zeros((), device=c.device)
    metrics, seconds = [], []
    try:
        for b in batches:
            torch.cuda.synchronize()
            tic = time.perf_counter()
            m = step(state, b)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - tic)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        for name, (s, sch) in saved.items():
            opt = getattr(state, f"opt_{name}")
            opt.step, opt.schedule = s, sch
    return dict(grads=grads, metrics=metrics, seconds=seconds,
                flat={n: getattr(state, f"opt_{n}").flat.clone()
                      for n in ("g", "d")})


def _grad_gap(a: dict, b: dict) -> dict:
    """Each network's largest |Δg| over all updates of two runs, over
    its largest |g|."""
    return {n: max((x - y).abs().max().item() for x, y in
                   zip(a["grads"][n], b["grads"][n]))
            / max(x.abs().max().item() for x in a["grads"][n])
            for n in a["grads"]}


def _small_step_repro(name: str) -> dict:
    """The flow step (FlowConfig(), batch 8) or the pose step
    (PoseNetConfig() with occlusion 0.5, batch 16) at TRAIN_HW: two runs
    of 4 steps from one seed, as the port runs them and with
    ``cudnn.deterministic``, in turns; their bit-equality and steps/s
    (steps 2-4)."""
    import dataclasses

    from renderloom_torch.cli.train_flow import synthetic_triplets
    from renderloom_torch.cli.train_pose import synthetic_batches
    from renderloom_torch.core.config import FlowConfig, PoseNetConfig
    from renderloom_torch.train import flow as TF
    from renderloom_torch.train import pose as TP

    H, W = TRAIN_HW
    if name == "flow":
        cfg = FlowConfig()
        raws = synthetic_triplets(np.random.default_rng(2), 4,
                                  cfg.batch_size, H, W)
        create, make = TF.create_flow_state, TF.make_flow_train_step
    else:
        cfg = dataclasses.replace(PoseNetConfig(), occlude_rate=0.5)
        raws = synthetic_batches(np.random.default_rng(2), 4,
                                 cfg.batch_size, H, W)
        create, make = TP.create_pose_state, TP.make_pose_train_step
    batches = [{k: torch.from_numpy(v).to(DEVICE) for k, v in r.items()}
               for r in raws]
    step = make(cfg)
    out = {}
    for tag in ("port", "cudnn.deterministic", "port again"):
        runs = []
        with _Settings(cudnn_det=tag == "cudnn.deterministic"):
            for _ in range(2):
                state = create(cfg, DEVICE, seed=3)
                step(state, batches[0])
                torch.cuda.synchronize()
                tic = time.perf_counter()
                for b in batches[1:]:
                    step(state, b)
                torch.cuda.synchronize()
                runs.append((state.opt.flat.clone(),
                             (len(batches) - 1) / (time.perf_counter() - tic)))
        out[tag] = dict(bit_equal=torch.equal(runs[0][0], runs[1][0]),
                        max_abs=(runs[0][0] - runs[1][0]).abs().max().item(),
                        steps_per_sec=[r[1] for r in runs])
    port = np.mean(out["port"]["steps_per_sec"]
                   + out["port again"]["steps_per_sec"])
    out["cost"] = 1 - np.mean(out["cudnn.deterministic"]["steps_per_sec"]) \
        / port
    print(f"  {name} step: two runs of 4 steps, " + "; ".join(
        f"{tag} {'bit-equal' if r['bit_equal'] else 'differ'} (parameters "
        f"{r['max_abs']:.3e}), " + ", ".join(f"{v:.2f}" for v in
                                              r["steps_per_sec"])
        + " steps/s" for tag, r in out.items() if tag != "cost")
        + f"; cudnn.deterministic costs {100 * out['cost']:+.1f}% of steps/s "
        f"({card_line()})")
    if not out["cudnn.deterministic"]["bit_equal"]:
        raise AssertionError(f"the {name} step does not repeat under "
                             "cudnn.deterministic")
    return out


def _resize_cost(state, snap, step, batch) -> dict:
    """The card's matmul resize against torch's antialiased
    ``F.interpolate`` in the GAN step: the calls one step makes and
    their shapes, forward + backward ms of each formulation at those
    shapes (CUDA events), and the difference per step as a share of the
    step's ms."""
    from renderloom_torch.models import discriminator
    from renderloom_torch.ops.image import resize_matmul

    shapes = Counter()
    real = discriminator.resize_bilinear

    def rec(img, height, width):
        shapes[(tuple(img.shape), height, width)] += 1
        return real(img, height, width)

    discriminator.resize_bilinear = rec
    try:
        _gan_run(state, snap, step, [batch], lr0=True)
    finally:
        discriminator.resize_bilinear = real
    ms = {"matmul": 0.0, "F.interpolate": 0.0}
    for (shape, h, w), n in shapes.items():
        x = torch.rand(shape, device=DEVICE, requires_grad=True)
        dy = torch.rand((shape[0], h, w, shape[3]), device=DEVICE)
        for tag, fn in (("matmul", resize_matmul),
                        ("F.interpolate", _resize_interpolate_aa)):
            ms[tag] += n * cuda_ms(lambda: torch.autograd.grad(
                fn(x, h, w), x, dy), iters=10)
    step_ms = 1e3 * np.mean(_gan_run(state, snap, step, [batch],
                                     lr0=True)["seconds"])
    share = (ms["matmul"] - ms["F.interpolate"]) / step_ms
    print(f"  gan step's resizes: {sum(shapes.values())} calls at "
          f"{sorted(shapes)}; forward + backward per step: matmul "
          f"{ms['matmul']:.3f} ms, F.interpolate {ms['F.interpolate']:.3f} "
          f"ms; the difference {100 * share:+.2f}% of the step's "
          f"{step_ms:.1f} ms ({card_line()})")
    return dict(calls=sum(shapes.values()), ms=ms, step_ms=step_ms,
                share=share)


def phase_repro() -> dict:
    """G: which operators keep the card's float32 GAN step (phase C's
    configuration), the flow and the pose step (:func:`_small_step_repro`)
    from repeating bit for bit, and what determinism costs."""
    from renderloom_torch.cli.train_renderer import synthetic_batches
    from renderloom_torch.train.gan import (create_gan_state,
                                            make_gan_train_step,
                                            make_perceptual)

    cfg = _train_cfg()
    d = cfg.data
    B = cfg.batch_size
    print(f"G. reproducibility: the float32 GAN step (phase C: hsm.yaml, "
          f"batch {B} x {d.max_frames}-frame raw windows, "
          f"{d.model_width}x{d.model_height}) run twice from one state per "
          f"setting, and the flow and pose steps at "
          f"{TRAIN_HW[1]}x{TRAIN_HW[0]}")
    state = create_gan_state(cfg, DEVICE, seed=0)
    step = make_gan_train_step(cfg, make_perceptual(cfg, DEVICE, seed=0),
                               data_cfg=d)
    batches = [{k: torch.from_numpy(v).to(DEVICE) for k, v in raw.items()}
               for raw in synthetic_batches(np.random.default_rng(0), 3, B,
                                            d.max_frames, d.load_height,
                                            d.load_width)]
    step(state, batches[0])             # warm-up
    snap = _gan_snapshot(state)
    out = {"gan": {}}

    # gradients at learning rate 0, two runs of one step per setting
    settings = {
        "default": dict(),
        "deterministic (torch + cuDNN + cuBLAS)": dict(torch_det=True,
                                                       cudnn_det=True),
        "deterministic, F.interpolate resize": dict(
            torch_det=True, cudnn_det=True, resize=_resize_interpolate_aa),
    }
    for tag, kw in settings.items():
        with _Settings(**kw) as s:
            a = _gan_run(state, snap, step, batches[1:2], lr0=True)
            b = _gan_run(state, snap, step, batches[1:2], lr0=True)
        gap = _grad_gap(a, b)
        out["gan"][tag] = dict(grad_gap=gap, named=sorted(s.named))
        print(f"  gan, learning rate 0, {tag}: largest |dg| over the "
              f"largest |g|: " + ", ".join(f"{k} {v:.3e}" for k, v in
                                          gap.items())
              + f"; operators torch names without a deterministic CUDA "
              f"implementation: {sorted(s.named) or 'none'}")
    det = out["gan"]["deterministic (torch + cuDNN + cuBLAS)"]
    if max(det["grad_gap"].values()) != 0 or det["named"]:
        raise AssertionError(f"the GAN step is not reproducible under the "
                             f"deterministic settings: {det}")

    # the cost: the resize's matmul form, and windows/s in turns
    out["gan"]["resize"] = _resize_cost(state, snap, step, batches[1])
    costs = {}
    for tag, kw in (("port", {}),
                    ("F.interpolate resize", dict(
                        resize=_resize_interpolate_aa)),
                    ("cudnn.deterministic", dict(cudnn_det=True)),
                    ("port again", {})):
        with _Settings(**kw):
            r = _gan_run(state, snap, step, batches, lr0=False)
        costs[tag] = B * (len(batches) - 1) / sum(r["seconds"][1:])
    port = (costs["port"] + costs["port again"]) / 2
    print("  gan windows/s at the learning rate (steps 2-3 of 3, in turns): "
          + ", ".join(f"{k} {v:.4f}" for k, v in costs.items())
          + "; cudnn.deterministic "
          f"{100 * (costs['cudnn.deterministic'] / port - 1):+.1f}%, the "
          f"F.interpolate resize "
          f"{100 * (costs['F.interpolate resize'] / port - 1):+.1f}% against "
          f"the port ({card_line()})")
    out["gan"]["windows_per_sec"] = costs

    # at the learning rate: two runs of two steps, bit for bit or not
    for tag, kw in (("default", {}), ("cudnn.deterministic",
                                      dict(cudnn_det=True))):
        with _Settings(**kw):
            a = _gan_run(state, snap, step, batches[1:], lr0=False)
            b = _gan_run(state, snap, step, batches[1:], lr0=False)
        same = all(torch.equal(a["flat"][n], b["flat"][n]) for n in "gd") \
            and a["metrics"] == b["metrics"]
        rel = max(abs(x[k] - y[k]) / max(abs(x[k]), 1e-30)
                  for x, y in zip(a["metrics"], b["metrics"]) for k in x)
        out["gan"][f"repeat_{tag}"] = dict(bit_equal=same, metrics_rel=rel)
        print(f"  gan at the learning rate, {tag}: two runs of 2 steps "
              f"{'bit-equal' if same else 'differ'} (metrics {rel:.3e} "
              f"relative)")
        if tag != "default" and not same:
            raise AssertionError("the GAN step does not repeat under "
                                 "cudnn.deterministic")

    # the flow and pose steps (their warps differentiate no gather)
    for name in ("flow", "pose"):
        out[name] = _small_step_repro(name)
    return out


# ---------------------------------------------------------------------------
# U. the GAN step on each alternate perceptual backbone
# ---------------------------------------------------------------------------

# Card against CPU, float32 (TF32 off), each backbone's taps at 64×96
# (Inception 96×128) on seeded weights and input: the largest error of a
# tap over its largest magnitude.  Limit 3.4x the largest reading
# (2.94e-6, VGG-Face, NVIDIA H100 80GB HBM3 at 700 W; PERF.md).
BACKBONE_TAP_TOL = 1e-5


def _backbone_hw(net: str):
    return (96, 128) if net == "inception_v3" else (64, 96)


def _backbone_cpu_match(net: str) -> float:
    """Card vs CPU taps of ``net`` (seed-11 weights, seed-12 input)."""
    import copy

    from renderloom_torch.models.backbones import build_backbone
    from renderloom_torch.train.gan import set_float32_precision

    set_float32_precision()
    model, layers, _ = build_backbone(net, seed=11)
    h, w = _backbone_hw(net)
    x = torch.from_numpy(np.random.default_rng(12).normal(
        size=(2, h, w, 3)).astype(np.float32))
    with torch.no_grad():
        want = model(x)
        got = copy.deepcopy(model).to(DEVICE)(x.to(DEVICE))
    return max(((got[k].cpu() - want[k]).abs().max()
                / want[k].abs().max()).item() for k in layers)


# K2 and K2b on a step's own tensors against their twins: each output
# (K2's y and each residual, K2b's dx) over its largest magnitude.  Phase
# B holds them elementwise on random inputs; a step's activations carry
# means of many deviations (a conv's bias, a channel of small variance),
# where the moments' summation order moves a whole channel, so the
# main-path check is scaled by the call.  Limit about 3.5x the largest
# reading (1.40e-5, K2 in phase U, PERF.md).
MAIN_PATH_NORM_TOL = 5e-5


def _norm_twin_checker(errs: dict):
    """:func:`_norm_call_recorder` with the first call of each (shape,
    affine, slope) also run through its twin on the same main-path
    tensors: K2's output and residuals and K2b's dx each to
    ``MAIN_PATH_NORM_TOL`` of their largest magnitude, dγ and dβ to
    ``DPARAM_TOL`` of their terms' magnitudes.  ``errs`` collects the
    largest |kernel − twin| ("K2", "K2b") and the largest of it over
    the output's largest ("K2 rel", "K2b rel"); raises on a call beyond
    its limit.  Returns the function that puts the wrappers back."""
    from renderloom_torch.ops import norm_kernel as NK

    seen = set()

    def hold(kind, key, got, want):
        err = (got.float() - want.float()).abs().max().item()
        rel = err / max(want.float().abs().max().item(), 1e-30)
        errs[kind] = max(errs.get(kind, 0.0), err)
        errs[f"{kind} rel"] = max(errs.get(f"{kind} rel", 0.0), rel)
        if rel > MAIN_PATH_NORM_TOL:
            raise AssertionError(f"{kind} {key}: error {err}, {rel} of the "
                                 f"largest")

    def fwd(x, scale, bias, slope, eps, stats, parity, r3centered, out):
        key = ("fwd", tuple(x.shape), scale is not None, slope)
        if key in seen or parity or r3centered:
            return
        seen.add(key)
        want, want_stats = NK._plain_forward(x, scale, bias, slope, eps)
        hold("K2", key, out, want)
        if stats is not None:
            for k in range(3):
                hold("K2", key + (f"residual {k}",), stats[..., k],
                     want_stats[..., k])

    def bwd(x, dy, stats, scale, bias, slope, r3centered, got):
        key = ("bwd", tuple(x.shape), scale is not None, slope)
        if key in seen or r3centered:
            return
        seen.add(key)
        want = NK.instance_norm_bwd_plain(x, dy, stats, scale, bias, slope)
        hold("K2b", key, got[0], want[0])
        if scale is None:
            return
        xhat = ((x - stats[:, None, None, :, 0])
                - stats[:, None, None, :, 1]) * stats[:, None, None, :, 2]
        z = xhat * scale + bias
        dz = torch.where(z >= 0, dy, dy * slope) if slope is not None \
            else dy
        mags = ((dz * xhat).abs().sum((0, 1, 2)), dz.abs().sum((0, 1, 2)))
        for g_, w_, mag in zip(got[1:], want[1:], mags):
            ratio = ((g_ - w_).abs() / mag).max().item()
            if ratio > DPARAM_TOL:
                raise AssertionError(f"K2b {key}: dparam {ratio}")

    return _norm_call_recorder(Counter(), Counter(), fwd, bwd)


def phase_backbones(train) -> dict:
    """U: phase C's float32 GAN step (hsm.yaml, batch 4 × 4-frame raw
    windows, 480×320, four discriminators) for 2 steps on each alternate
    perceptual backbone (seeded random weights, ``make_perceptual(...,
    network=...)``): K1, K2 and K2b launched as in phase C, the first
    step's K2 and K2b calls held against their twins on the step's own
    tensors (first call of each shape), finite metrics and no skipped
    update; windows/s of the second step, peak memory, the perceptual
    term's forward and backward ms per step; and each backbone's taps
    card against CPU."""
    from renderloom_torch.cli.train_renderer import synthetic_batches
    from renderloom_torch.models.backbones import BACKBONES
    from renderloom_torch.train.gan import (create_gan_state,
                                            make_gan_train_step,
                                            make_perceptual)

    cfg = _train_cfg()
    d = cfg.data
    B, L, H, W = cfg.batch_size, d.max_frames, d.model_height, d.model_width
    print(f"U. the float32 GAN step on each alternate perceptual backbone "
          f"(phase C: {W}x{H}, batch {B} x {L}-frame raw windows, 2 steps "
          f"each, seeded random weights; one G/D state stepped through all)")
    state = create_gan_state(cfg, DEVICE, seed=0)
    want = derived_train_launches(cfg, state.gen, state.dis, L - 2)
    if want != train["per_step"]:
        raise AssertionError(f"derived launches {want} differ from phase C's"
                             f" {train['per_step']}")
    raws = list(synthetic_batches(np.random.default_rng(21),
                                  2 * len(BACKBONES), B, L, d.load_height,
                                  d.load_width))
    out = {}
    for i, net in enumerate(BACKBONES):
        tic = time.perf_counter()
        perc = make_perceptual(cfg, DEVICE, seed=0, network=net)
        step = make_gan_train_step(cfg, perc, data_cfg=d)
        batches = [{k: torch.from_numpy(v).to(DEVICE) for k, v in raw.items()}
                   for raw in raws[2 * i:2 * i + 2]]
        errs = {}
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        restore = _norm_twin_checker(errs)
        try:
            step(state, batches[0])
            torch.cuda.synchronize()
        finally:
            restore()
        t0 = time.perf_counter()
        metrics = step(state, batches[1])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = _train_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        vals = {k: float(v) for k, v in metrics.items()}
        if launches != {k: 2 * v for k, v in want.items()}:
            raise AssertionError(f"{net}: launches {launches}, per step "
                                 f"{want}")
        if not all(np.isfinite(v) for v in vals.values()) or \
                vals["notfinite/g"] or vals["notfinite/d"]:
            raise AssertionError(f"{net}: metrics {vals}")
        pred = torch.rand((B, H, W, 3), device=DEVICE, requires_grad=True)
        target = torch.rand((B, H, W, 3), device=DEVICE)
        perc_ms = 2 * (L - 2) * cuda_ms(
            lambda: perc(pred, target).backward(), iters=3, warmup=1)
        tap_err = _backbone_cpu_match(net)
        n_p = sum(p.numel() for p in perc.parameters())
        out[net] = dict(wps=B / sec, peak_gib=peak, perc_ms=perc_ms,
                        launches=launches, k2_err=errs.get("K2", 0.0),
                        k2b_err=errs.get("K2b", 0.0),
                        k2_rel=errs.get("K2 rel", 0.0),
                        k2b_rel=errs.get("K2b rel", 0.0), tap_err=tap_err,
                        g_perc=vals["g/perc"], params=n_p,
                        seconds=time.perf_counter() - tic)
        print(f"  {net} ({n_p:,} params): {B / sec:.4f} windows/s (step 2 "
              f"{sec * 1e3:.1f} ms), peak {peak:.2f} GiB, perceptual term "
              f"{perc_ms:.1f} ms a step (forward and backward, "
              f"{2 * (L - 2)} calls), g/perc {vals['g/perc']:.5g}; launches "
              f"in 2 steps {launches} (phase C per step "
              f"{train['per_step']}); K2 vs twin {errs.get('K2', 0):.3e} "
              f"({errs.get('K2 rel', 0):.2e} of the largest), K2b "
              f"{errs.get('K2b', 0):.3e} ({errs.get('K2b rel', 0):.2e}; "
              f"limit {MAIN_PATH_NORM_TOL:.0e}); taps card vs CPU "
              f"{tap_err:.3e} of the largest (limit {BACKBONE_TAP_TOL:.0e}); "
              f"{out[net]['seconds']:.1f} s")
        if tap_err > BACKBONE_TAP_TOL:
            raise AssertionError(f"{net}: taps card vs CPU {tap_err}")
        del perc, step, batches
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# J. data-parallel serving
# ---------------------------------------------------------------------------

# World 2 against world 1 on the same clips, the card's serving tolerance
# (phase 5's card vs CPU): each rank's batch is half of world 1's, and
# cuDNN's algorithms and K2's plan follow the batch.
DP_SERVE_TOL = 1e-3


def serve_clips(n: int, L: int, H: int, W: int, seed: int) -> dict:
    """``n`` raw clips of ``L`` frames at H×W (images and backgrounds in
    [0, 255], one standing person per clip drifting across the frame,
    one joint in twenty below the confidence threshold), numpy."""
    rng = np.random.default_rng(seed)
    box = np.array([W / 4, 3 * H / 4])
    start = rng.uniform([0, 0], [W, H] - box, (n, 1, 1, 2))
    drift = rng.uniform(-2, 2, (n, 1, 1, 2)) * np.arange(L)[None, :, None,
                                                            None]
    xy = start + drift + _PERSON * box + rng.uniform(-3, 3, (n, L, 19, 2))
    conf = np.where(rng.uniform(size=(n, L, 19, 1)) > 0.05, 0.9, 0.0)
    img = lambda: rng.uniform(0, 255, (n, L, H, W, 3)).astype(np.float32)
    return {"images": img(), "dain": img(),
            "poses": np.concatenate([xy, conf], -1).astype(np.float32)}


def dp_serve_run(rcfg, g_trees, clips, rate: int, device) -> dict:
    """Data-parallel serving on this rank (world 1 without a process
    group): the inference generator from ``g_trees`` (numpy flax params
    and batch_stats; without them seeded random weights, seed 1 + rank,
    so that :func:`~renderloom_torch.parallel.mesh.replicate` has to make
    every rank's rank 0's), replicated; this rank's contiguous block of
    ``clips`` (a dict of numpy arrays with a leading clip axis, prepared
    — label, back, key_img — or raw — images, dain, poses, which the
    rank prepares, K1 — or the arguments of :func:`serve_clips`); the
    segment rollout on it (K2); the global fused frames and masks
    gathered in clip order.  Returns them (rank 0 only), this rank's
    kernel launches and seconds."""
    from renderloom_torch.convert import random_init_
    from renderloom_torch.data.hsm import prepare_batch
    from renderloom_torch.parallel import mesh
    from renderloom_torch.train.gan import (make_inference_pair,
                                            make_segment_rollout,
                                            set_float32_precision)

    device = torch.device(device)
    set_float32_precision()         # as build_pipeline: no TF32
    rank, size = mesh.world()
    gen = make_inference_pair(rcfg, *(g_trees or (None, None)), device)
    if g_trees is None and rank:
        random_init_(gen, 1 + rank)
    mesh.replicate(gen)
    if not isinstance(clips, dict):
        clips = serve_clips(*clips)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in mesh.shard_batch(clips).items()}
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else lambda: None)
    _reset_launches()
    sync()
    tic = time.perf_counter()
    with torch.inference_mode():
        if "poses" in batch:
            p = prepare_batch(batch, rcfg.data, want_masks=False)
            batch = {"label": p["label"], "back": p["back"],
                     "key_img": p["image"]}
        fused, masks = make_segment_rollout(gen, rate)(batch)
    sync()
    seconds = time.perf_counter() - tic
    launches = _kernel_launches()
    fused, masks = mesh.gather_batch(fused), mesh.gather_batch(masks)
    out = dict(launches=launches, seconds=seconds, world=size,
               local=int(len(batch["label"])))
    if rank == 0:
        out.update(fused=fused.cpu().numpy(), masks=masks.cpu().numpy())
    return out


def phase_dp_serve(serve) -> dict:
    """J: data-parallel serving, two ranks on this card over gloo (for
    correctness, not speed): 4 clips of phase 4's configuration, float32,
    the standard generator on seeded weights, 2 clips a rank; each rank
    prepares its clips' labels (K1) and runs the segment rollout (K2);
    the gathered frames and masks against world 1 on the same 4 clips."""
    from renderloom_torch.parallel import run_ranks

    rcfg, rate, K = serve["rcfg"], serve["rate"], serve["K"]
    H, W = rcfg.data.model_height, rcfg.data.model_width
    n, L = 4, (K - 1) * rate + 1
    spec = (n, L, H, W, 31)
    print(f"J. data-parallel serving: {n} clips ({W}x{H}, rate {rate}, {K} "
          f"keyframes, L = {L}), float32 standard generator, world 2 (gloo, "
          f"both ranks on this card, {n // 2} clips a rank) vs world 1")
    tic = time.perf_counter()
    one = dp_serve_run(rcfg, None, spec, rate, DEVICE)
    t_one = time.perf_counter() - tic
    tic = time.perf_counter()
    two = run_ranks(dp_serve_run, 2, DEVICE, backend="gloo",
                    args=(rcfg, None, spec, rate, DEVICE))
    t_two = time.perf_counter() - tic
    g = lambda r: r["launches"]
    want = {"rasterize": 1, "instance_norm": _count_norms(serve["gen"])
            * (rate - 1), "upconv": _count_upconvs(serve["gen"]) * (rate - 1),
            **_lk_warps(0)}         # the clips come with backgrounds
    for who, r in [("world 1", one)] + [(f"rank {i}", r)
                                        for i, r in enumerate(two)]:
        if {k: g(r)[k] for k in want} != want or g(r)["instance_norm_bwd"]:
            raise AssertionError(f"{who}: launches {g(r)}, want {want}")
    if tuple(one["fused"].shape) != (n, L, H, W, 3):
        raise AssertionError(f"fused shape {one['fused'].shape}")
    if not np.isfinite(one["fused"]).all():
        raise AssertionError("non-finite frames")
    errs = {}
    for part in ("fused", "masks"):
        errs[part] = compare(f"world 2 vs world 1, {part}",
                             torch.from_numpy(two[0][part]),
                             torch.from_numpy(one[part]), DP_SERVE_TOL)
    print(f"  launches world 1 {g(one)}, world 2 per rank "
          f"{[g(r) for r in two]}; rollout seconds world 1 "
          f"{one['seconds']:.3f}, ranks {[round(r['seconds'], 3) for r in two]}"
          f"; {t_one:.1f} s and {t_two:.1f} s with the set-up")
    return dict(errs=errs, launches1=g(one), launches2=[g(r) for r in two],
                seconds1=one["seconds"], seconds2=[r["seconds"] for r in two])


# ---------------------------------------------------------------------------
# I. the layer variants
# ---------------------------------------------------------------------------

# Card against CPU, float32 (TF32 off), forward and backward of each
# variant at a generator-like width: the output and each gradient over
# its largest magnitude (a gradient far below the call's largest over
# 1e-2 of that).  Limits 3.5-6x the largest readings on an NVIDIA H100
# 80GB HBM3 at 700 W (outputs 2.65e-6, gradients 1.74e-5, behind a
# leaky by the mean 1.44e-4; PERF.md).
VARIANT_OUT_TOL, VARIANT_GRAD_TOL, VARIANT_MEAN_TOL = 1e-5, 1e-4, 5e-4
# (B, H, W, C) of the 2-D variants; PartialConv3d's (B, D, H, W, C)
VARIANT_SHAPE, VARIANT_3D_SHAPE = (4, 80, 120, 256), (2, 8, 40, 60, 64)


def _variant_cases():
    """(name, module, inputs (numpy), which inputs take a gradient,
    call) at ``VARIANT_SHAPE`` and ``VARIANT_3D_SHAPE``."""
    from renderloom_torch.convert import random_init_
    from renderloom_torch.models import layers as TL

    B, H, W, C = VARIANT_SHAPE
    B3, D3, H3, W3, C3 = VARIANT_3D_SHAPE
    rng = np.random.default_rng(41)
    a = lambda *shape: rng.normal(size=shape).astype(np.float32)

    def holes(shape):
        m = (rng.uniform(size=shape) > 0.1).astype(np.float32)
        m[:, H // 8:3 * H // 8, W // 6:5 * W // 12] = 0.0
        return m

    def init(mod, seed):
        """Seeded conv weights (``random_init_``); every 1-D parameter
        (biases, norm scales, γ, β) 0.1·N(0, 1) around 1 for a weight,
        0 otherwise."""
        random_init_(mod, seed)
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in mod.named_parameters():
                if p.dim() == 1:
                    p.copy_(float(name.endswith("weight"))
                            + 0.1 * torch.randn(p.shape, generator=g))
        return mod

    nl = TL.NonLocalBlock(C, spectral=False)
    cases = [
        ("NonLocalBlock", init(nl, 1), [a(B, H, W, C)], [True],
         lambda m, x: m(x)),
        ("PartialConv stride 2", init(TL.PartialConv(C, C, 3, 2), 2),
         [a(B, H, W, C), holes((B, H, W, 1))], [True, False],
         lambda m, x, k: m(x, k)),
        ("hyper_conv2d", None, [a(B, H, W, 64), 0.05 * a(B, 3, 3, 64, C),
                                a(B, C)], [True, True, True],
         lambda m, x, k, b: TL.hyper_conv2d(x, k, b)),
        ("weight_demodulated_conv2d", None,
         [a(B, H, W, 64), a(3, 3, 64, C), np.abs(a(B, 64)) + 0.5],
         [True, True, True],
         lambda m, x, k, s: TL.weight_demodulated_conv2d(x, k, s)),
        ("LayerNorm2d", init(TL.LayerNorm2d(C), 3), [a(B, H, W, C)], [True],
         lambda m, x: m(x)),
        ("HyperSpade", init(TL.HyperSpade(C, [64, 32, None], 3, hyper=True),
                            4),
         [a(B, H, W, C), a(B, H // 2, W // 2, 64), a(B, H, W, 32),
          rng.uniform(size=(B, H // 4, W // 4, 1)).astype(np.float32),
          0.05 * a(B, 3, 3, 64, 2 * C), 0.1 * a(B, 2 * C)],
         [True, True, True, False, True, True],
         lambda m, x, c0, c1, k1, kw, kb: m(x, [c0, (c1, k1), None],
                                            (kw, kb))),
        ("PartialConvBlock", init(TL.PartialConvBlock(C, C), 5),
         [a(B, H, W, C), holes((B, H, W, 1))], [True, False],
         lambda m, x, k: m(x, k)),
        ("PartialResBlock", init(TL.PartialResBlock(C // 2, C), 6),
         [a(B, H, W, C // 2), holes((B, H, W, 1))], [True, False],
         lambda m, x, k: m(x, k)),
        ("PartialConv3d", init(TL.PartialConv3d(C3, C3), 7),
         [a(B3, D3, H3, W3, C3), (rng.uniform(size=(B3, D3, H3, W3, 1))
                                  > 0.2).astype(np.float32)], [True, False],
         lambda m, x, k: m(x, k)),
    ]
    with torch.no_grad():
        nl.gamma.fill_(0.5)
    return cases


def _variant_run(module, inputs, wants_grad, call, device):
    """Outputs and gradients (inputs', then parameters' by name) of Σ
    out·c, c fixed per output shape, on ``device``."""
    xs = [torch.from_numpy(x).to(device).requires_grad_(g)
          for x, g in zip(inputs, wants_grad)]
    out = call(module, *xs)
    out = out[0] if isinstance(out, tuple) else out
    ct = torch.from_numpy(np.random.default_rng(43).normal(
        size=tuple(out.shape)).astype(np.float32)).to(device)
    (out * ct).sum().backward()
    grads = {f"d input {i}": x.grad
             for i, (x, g) in enumerate(zip(xs, wants_grad)) if g}
    if module is not None:
        grads.update({f"d{n}": p.grad for n, p in module.named_parameters()})
    return out.detach(), grads


def phase_layer_variants() -> dict:
    """I: every layer variant forward and backward on the card against
    the CPU at a generator-like width, with K2 and K2b launches counted
    for those with instance norms (HyperSpade 1, PartialConvBlock 1,
    PartialResBlock 2, each forward and backward)."""
    import copy

    from renderloom_torch.train.gan import set_float32_precision

    set_float32_precision()
    B, H, W, C = VARIANT_SHAPE
    print(f"I. the layer variants on the card vs the CPU (B {B}, {W}x{H}, C "
          f"{C}; PartialConv3d {VARIANT_3D_SHAPE}), forward and backward, "
          f"float32")
    norms = {"HyperSpade": 1, "PartialConvBlock": 1, "PartialResBlock": 2}
    out, launches = {}, {}
    for name, module, inputs, wants_grad, call in _variant_cases():
        tic = time.perf_counter()
        card = copy.deepcopy(module).to(DEVICE) if module is not None \
            else None
        y_cpu, g_cpu = _variant_run(module, inputs, wants_grad, call, "cpu")
        _reset_launches()
        y, g = _variant_run(card, inputs, wants_grad, call, DEVICE)
        torch.cuda.synchronize()
        run = _kernel_launches()
        n = norms.get(name, 0)
        if (run["instance_norm"], run["instance_norm_bwd"]) != (n, n):
            raise AssertionError(f"{name}: launches {run}, want {n} and {n}")
        if n:
            launches[name] = {k: run[k] for k in ("instance_norm",
                                                  "instance_norm_bwd")}
        top = max(v.abs().max().item() for v in g_cpu.values())
        diff = lambda a, b: (a.cpu() - b).abs()
        err_out = diff(y, y_cpu).max().item() / y_cpu.abs().max().item()
        # each gradient over its largest; one whose largest lies below
        # 1e-2 of the call's largest (a partial conv's bias ahead of an
        # instance norm, which the norm cancels but for the holes) over
        # the call's largest.  Behind a leaky (the partial blocks) a
        # pre-activation within rounding of 0 takes the other slope on
        # the card, moving its gradient by 0.8·dy: those hold the mean
        # error over the mean magnitude
        kink = name in ("PartialConvBlock", "PartialResBlock")
        grads = {k: (diff(g[k], v).mean() / v.abs().mean()).item() if kink
                 else diff(g[k], v).max().item()
                 / max(v.abs().max().item(), 1e-2 * top)
                 for k, v in g_cpu.items()}
        worst = max(grads, key=grads.get)
        err_grad = grads[worst]
        limit = VARIANT_MEAN_TOL if kink else VARIANT_GRAD_TOL
        out[name] = dict(out=err_out, grad=err_grad, worst=worst,
                         mean=kink, seconds=time.perf_counter() - tic)
        print(f"  {name}: output {err_out:.3e}, gradients {err_grad:.3e} "
              f"({worst}) of their {'mean' if kink else 'largest'} (limits "
              f"{VARIANT_OUT_TOL:.0e}, {limit:.0e}); K2 "
              f"{run['instance_norm']}, K2b {run['instance_norm_bwd']}; "
              f"{out[name]['seconds']:.1f} s")
        if err_out > VARIANT_OUT_TOL or err_grad > limit:
            raise AssertionError(f"{name}: card vs CPU {err_out}, "
                                 f"{err_grad}")
    return dict(errs=out, launches=launches)


# ---------------------------------------------------------------------------
# CI. checkpoint import from the reference
# ---------------------------------------------------------------------------

REF_EPOCH_G, REF_EPOCH_M = 6, 399        # netG/netD_epoch006, model_epoch399
# torchvision's VGG19 classifier (in, out) per layer index
VGG_CLASSIFIER = ((0, 25088, 4096), (3, 4096, 4096), (6, 4096, 1000))


def _sn_vectors(w: np.ndarray, rng: np.random.Generator, iters: int = 3):
    """torch's spectral-norm ``weight_u`` (O,) and ``weight_v`` (I·kh·kw,)
    after ``iters`` power steps from a random u, as float32."""
    mat = w.reshape(w.shape[0], -1).astype(np.float64)
    u = rng.normal(size=mat.shape[0])
    u /= np.linalg.norm(u)
    for _ in range(iters):
        v = mat.T @ u
        v /= np.linalg.norm(v)
        u = mat @ v
        u /= np.linalg.norm(u)
    return u.astype(np.float32), v.astype(np.float32)


class _RefState:
    """A reference-named state dict under construction: seeded values
    at the shapes of the port's flax trees (HWIO kernels, (in, out)
    dense kernels)."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.sd = {}

    def _w(self, shape, fan_in):
        return (self.rng.normal(size=shape) / np.sqrt(fan_in)).astype(
            np.float32)

    def _b(self, n, scale=0.1):
        return (scale * self.rng.normal(size=n)).astype(np.float32)

    def plain(self, src: str, leaf: dict):
        kh, kw, i, o = leaf["kernel"].shape
        self.sd[f"{src}.weight"] = self._w((o, i, kh, kw), kh * kw * i)
        self.sd[f"{src}.bias"] = self._b(o)

    def spectral(self, src: str, leaf: dict):
        kh, kw, i, o = leaf["kernel"].shape
        w = self._w((o, i, kh, kw), kh * kw * i)
        u, v = _sn_vectors(w, self.rng)
        self.sd.update({f"{src}.weight_orig": w, f"{src}.weight_u": u,
                        f"{src}.weight_v": v, f"{src}.bias": self._b(o)})

    def norm(self, src: str, leaf: dict):
        n = leaf["scale"].shape[0]
        self.sd[f"{src}.weight"] = 1.0 + self._b(n)
        self.sd[f"{src}.bias"] = self._b(n)

    def dense(self, src: str, leaf: dict):
        i, o = leaf["kernel"].shape
        self.sd[f"{src}.weight"] = self._w((o, i), i)
        self.sd[f"{src}.bias"] = self._b(o)

    def tensors(self, prefix: str = "") -> dict:
        return {prefix + k: torch.from_numpy(v) for k, v in self.sd.items()}


_BLOCK_TAGS = (("0", "conv_block_0"), ("1", "conv_block_1"),
               ("_s", "conv_block_s"))


def reference_generator_state(params: dict, seed: int) -> dict:
    """netG's state dict under the reference's names
    (``Pose_Guided_Neural_Rendering/models/generator.py``, as
    ``renderloom_torch.data.torch_import.map_generator_params`` reads
    them) for a generator whose flax params are ``params`` (shapes
    only): seeded spectral ``weight_orig`` with consistent ``weight_u``
    and ``weight_v``, a DataParallel ``module.`` prefix, and the
    reference's dead ``label_embedding`` and top-level ``conv_mask``."""
    import re

    st = _RefState(seed)
    emb = params["ref_embed"]
    st.spectral("ref_embedding.conv_first.layers.conv",
                emb["conv_first"]["conv"])
    for k in sorted(k for k in emb if k.startswith("down_")):
        st.spectral(f"ref_embedding.{k}.layers.conv", emb[k]["conv"])
    st.plain("down_first.layers.conv", params["down_first"])
    for blk in params:
        if not re.fullmatch(r"(down|res|up)_\d+", blk):
            continue
        for mine, tag in _BLOCK_TAGS:
            if f"conv{mine}" in params[blk]:
                st.spectral(f"{blk}.{tag}.layers.conv",
                            params[blk][f"conv{mine}"]["conv"])
                st.plain(f"{blk}.{tag}.layers.norm.mlps.0.0.layers.conv",
                         params[blk][f"spade{mine}"]["affine"])
    st.plain("conv_img.layers.conv", params["conv_img"]["conv"])
    mn, mg = params["mask_net"], "flow_network_temp"
    for mine, ref in (("lbl", "down_lbl"), ("img", "down_img")):
        names = [f"{mine}_in"] + [f"{mine}_down{j}" for j in range(
            sum(k.startswith(f"{mine}_down") for k in mn))]
        for i, name in enumerate(names):
            st.spectral(f"{mg}.{ref}.{i}.layers.conv",
                        mn[name]["conv"]["conv"])
            st.norm(f"{mg}.{ref}.{i}.layers.norm", mn[name]["norm"])
    for i in range(sum(re.fullmatch(r"res\d+", k) is not None for k in mn)):
        for mine, tag in _BLOCK_TAGS:
            if f"conv{mine}" in mn[f"res{i}"]:
                src = f"{mg}.res_flow.{i}.{tag}.layers"
                st.spectral(f"{src}.conv",
                            mn[f"res{i}"][f"conv{mine}"]["conv"])
                st.norm(f"{src}.norm", mn[f"res{i}"][f"norm{mine}"])
    n_up = sum(re.fullmatch(r"up\d+", k) is not None for k in mn)
    for k in range(n_up):              # [Upsample, conv] pairs, top first
        level = mn[f"up{n_up - 1 - k}"]
        st.spectral(f"{mg}.up_flow.{2 * k + 1}.layers.conv",
                    level["conv"]["conv"])
        st.norm(f"{mg}.up_flow.{2 * k + 1}.layers.norm", level["norm"])
    st.plain(f"{mg}.conv_mask.0.layers.conv", mn["conv_mask"]["conv"]["conv"])
    # dead in the reference's forward; the importer skips them
    st.spectral("label_embedding.conv_first.layers.conv",
                emb["conv_first"]["conv"])
    st.plain("conv_mask.layers.conv", mn["conv_mask"]["conv"]["conv"])
    return st.tensors("module.")


def reference_discriminator_state(params: dict, seed: int) -> dict:
    """netD's state dict under the reference's names
    (``models/discriminator.py``: ``net_D``, ``net_D_face``,
    ``net_D_hand``, ``discriminator_<s>.layer<i>.0.layers.{conv,norm}``,
    the head the last layer) for a discriminator set whose flax params
    are ``params`` (shapes only), ``module.``-prefixed."""
    st = _RefState(seed)
    for mine, ref in (("net_d", "net_D"), ("net_d_face", "net_D_face"),
                      ("net_d_hand", "net_D_hand")):
        for scale, layers in sorted(params.get(mine, {}).items()):
            s = int(scale[len("scale"):])
            n = sum(k.startswith("layer") for k in layers)
            for li in range(n):
                src = f"{ref}.discriminator_{s}.layer{li}.0.layers"
                st.spectral(f"{src}.conv",
                            layers[f"layer{li}"]["conv"]["conv"])
                st.norm(f"{src}.norm", layers[f"layer{li}"]["norm"])
            st.spectral(f"{ref}.discriminator_{s}.layer{n}.0.layers.conv",
                        layers["head"]["conv"])
    return st.tensors("module.")


def reference_motion_state(params: dict, seed: int) -> dict:
    """``model_epochNNN.pth`` under the reference's names
    (``Human_Motion_Modelling/models/transformer.py``: fused-QKV
    ``in_proj``, ``multihead_attn``, ``encoder.norm``) for a motion
    transformer whose flax params are ``params`` (shapes only), in the
    order the optimizer's slots follow."""
    st = _RefState(seed)

    def attention(src, blk):
        d = blk["q_proj"]["kernel"].shape[0]
        st.sd[f"{src}.in_proj_weight"] = st._w((3 * d, d), d)
        st.sd[f"{src}.in_proj_bias"] = st._b(3 * d)
        st.dense(f"{src}.out_proj", blk["out_proj"])

    st.dense("input_embed", params["input_embed"])
    st.dense("joints_embed", params["joints_embed"])
    for side, n_norms in (("enc", 2), ("dec", 3)):
        ref = "encoder" if side == "enc" else "decoder"
        i = 0
        while f"{side}_{i}" in params:
            blk, src = params[f"{side}_{i}"], f"{ref}.layers.{i}"
            attention(f"{src}.self_attn", blk["self_attn"])
            if side == "dec":
                attention(f"{src}.multihead_attn", blk["cross_attn"])
            st.dense(f"{src}.linear1", blk["ffn"]["linear1"])
            st.dense(f"{src}.linear2", blk["ffn"]["linear2"])
            for j in range(1, n_norms + 1):
                st.norm(f"{src}.norm{j}", blk[f"norm{j}"])
            i += 1
        st.norm(f"{ref}.norm", params[f"{ref}_norm"])
    return st.tensors()


def reference_opt_state(model_state: dict, steps: int, seed: int,
                        str_slots: bool = False,
                        step_tensor: bool = True) -> dict:
    """``opt_epochNNN.pth`` as the reference's trainer saves it
    (``{'transformer': Adam(amsgrad=True).state_dict()}``,
    models/trainer.py:221-225): one slot per parameter of
    ``model_state`` in its order, with seeded moments (``max_exp_avg_sq``
    at least ``exp_avg_sq``); the slot keys ints (or strings, with
    ``str_slots``), ``step`` a float tensor as recent torch stores it
    (or an int, as older torch)."""
    rng = np.random.default_rng(seed)
    state = {}
    for i, v in enumerate(model_state.values()):
        nu = rng.uniform(0, 1e-4, v.shape).astype(np.float32)
        state[str(i) if str_slots else i] = {
            "step": torch.tensor(float(steps)) if step_tensor else steps,
            "exp_avg": torch.from_numpy(
                (1e-3 * rng.normal(size=v.shape)).astype(np.float32)),
            "exp_avg_sq": torch.from_numpy(nu),
            "max_exp_avg_sq": torch.from_numpy(
                nu * rng.uniform(1, 2, v.shape).astype(np.float32))}
    group = {"lr": 1e-4, "betas": (0.5, 0.999), "eps": 1e-8,
             "weight_decay": 0.0, "amsgrad": True, "lr_mult": 1.0,
             "params": list(range(len(model_state)))}
    return {"transformer": {"state": state, "param_groups": [group]}}


def reference_vgg19_state(seed: int, classifier=VGG_CLASSIFIER) -> dict:
    """A torchvision ``vgg19()`` state dict of seeded values:
    ``features.N`` at the real shapes and ``classifier.N`` at
    ``classifier``'s (index, in, out)."""
    from renderloom_torch.models.perceptual import TORCHVISION_CONV_IDX

    g = torch.Generator().manual_seed(seed)
    state, ch = {}, 3
    for name, idx in TORCHVISION_CONV_IDX.items():
        out = (64, 128, 256, 512, 512)[int(name.split("_")[1]) - 1]
        state[f"features.{idx}.weight"] = torch.randn(
            out, ch, 3, 3, generator=g) / (9 * ch) ** 0.5
        state[f"features.{idx}.bias"] = 0.1 * torch.randn(out, generator=g)
        ch = out
    for idx, n_in, n_out in classifier:
        state[f"classifier.{idx}.weight"] = torch.randn(
            n_out, n_in, generator=g) / n_in ** 0.5
        state[f"classifier.{idx}.bias"] = 0.1 * torch.randn(n_out,
                                                           generator=g)
    return state


def write_reference_checkpoints(out_dir: str, rcfg, mcfg, seed: int = 0,
                                legacy: bool = True,
                                vgg_classifier=VGG_CLASSIFIER,
                                **opt_kw) -> dict:
    """The reference's published files for ``rcfg``'s and ``mcfg``'s
    widths, of seeded values, in torch's legacy format (the reference
    trained on torch 1.3-1.4) or the zip format: ``netG_epoch006.pth``,
    ``netD_epoch006.pth``, ``model_epoch399.pth``, ``opt_epoch399.pth``
    (``opt_kw``: :func:`reference_opt_state`'s options) and
    ``vgg19.pth``; returns their paths by kind."""
    from renderloom_torch.convert import flax_trees
    from renderloom_torch.models.discriminator import DiscriminatorSet
    from renderloom_torch.models.layers import enable_spectral_norm
    from renderloom_torch.models.motion_transformer import build_motion_model
    from renderloom_torch.models.renderer import Generator

    os.makedirs(out_dir, exist_ok=True)
    model = reference_motion_state(
        flax_trees(build_motion_model(mcfg))[0], seed + 2)
    states = {
        "netG": (f"netG_epoch{REF_EPOCH_G:03d}.pth", reference_generator_state(
            flax_trees(enable_spectral_norm(Generator(rcfg.gen)))[0], seed)),
        "netD": (f"netD_epoch{REF_EPOCH_G:03d}.pth",
                 reference_discriminator_state(flax_trees(
                     enable_spectral_norm(DiscriminatorSet(rcfg.dis)))[0],
                     seed + 1)),
        "model": (f"model_epoch{REF_EPOCH_M:03d}.pth", model),
        "opt": (f"opt_epoch{REF_EPOCH_M:03d}.pth",
                reference_opt_state(model, REF_EPOCH_M * 7, seed + 3,
                                    **opt_kw)),
        "vgg19": ("vgg19.pth", reference_vgg19_state(seed + 4,
                                                      vgg_classifier)),
    }
    paths = {}
    for kind, (name, state) in states.items():
        paths[kind] = os.path.join(out_dir, name)
        torch.save(state, paths[kind],
                   _use_new_zipfile_serialization=not legacy)
    return paths


def _flat_moment(tree: dict, model) -> torch.Tensor:
    """A flax moment tree as one vector in ``model``'s parameter order
    (the optimizer's flat layout)."""
    from renderloom_torch.convert import state_dict_from_flax

    sd = state_dict_from_flax(tree)
    return torch.cat([sd[n].reshape(-1) for n, _ in model.named_parameters()])


def phase_import(serve, probe) -> dict:
    """CI: the reference's checkpoints (seeded, at full width, legacy
    format) imported by ``cli/import_checkpoint`` and used: (a) the
    pipeline CLI on phase V's clip from the imported files, bit for bit
    the same CLI on ``.npz`` files of the trees ``map_*`` return; (b)
    ``train_motion --resume`` from the imported motion checkpoint, its
    AMSGrad state the ``.pth``'s moments bit for bit, 2 steps; (c)
    ``train_renderer --synthetic --resume`` from the imported G and D
    with ``VGG19_NPZ`` the imported ``.npz``, 2 steps at phase C's
    batch."""
    import shutil

    from renderloom_torch.cli import import_checkpoint as IC
    from renderloom_torch.cli import train_motion as TM
    from renderloom_torch.cli import train_renderer as TR
    from renderloom_torch.core.checkpoint import write_npz
    from renderloom_torch.data import torch_import as TI
    from renderloom_torch.models.layers import InstanceNorm, Spade
    from renderloom_torch.models.perceptual import find_vgg_weights
    from renderloom_torch.train.motion import create_motion_state

    if not probe["PIL"]:
        raise AssertionError("phase CI needs PIL for the pipeline CLI")
    mcfg, rcfg, rate, K = (serve[k] for k in ("mcfg", "rcfg", "rate", "K"))
    H, W = rcfg.data.model_height, rcfg.data.model_width
    L = (K - 1) * rate + 1
    work = os.path.join(ROOT, "build", "chip_smoke_import")   # not copied
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    print(f"CI. checkpoint import: the reference's netG/netD (hsm.yaml), "
          f"model/opt (motion.yaml) and torchvision VGG19 as seeded "
          f"legacy-format .pth files, imported and used")
    tic = time.perf_counter()
    ref = write_reference_checkpoints(os.path.join(work, "ref"), rcfg, mcfg)
    print(f"  wrote the reference files in {time.perf_counter() - tic:.2f} "
          f"s: " + ", ".join(f"{os.path.basename(p)} "
                             f"{os.path.getsize(p) / 2**20:.1f} MiB"
                             for p in ref.values()))
    m_yaml = _yaml_cfg(os.path.join(work, "motion.yaml"), mcfg)
    r_yaml = _yaml_cfg(os.path.join(work, "renderer.yaml"), rcfg)
    t_yaml = _yaml_cfg(os.path.join(work, "train.yaml"), _train_cfg())
    out = {"motion": os.path.join(work, "motion", "checkpoint.pt"),
           "renderer": os.path.join(work, "renderer", "checkpoint.pt"),
           "vgg19": os.path.join(work, "vgg19_features.npz")}
    seconds = {}
    for kind, argv in (
            ("motion", ["--pth", ref["model"], "--opt", ref["opt"],
                        "--config", m_yaml]),
            ("renderer", ["--pth", ref["netG"], "--pth-d", ref["netD"],
                          "--config", r_yaml]),
            ("vgg19", ["--pth", ref["vgg19"]])):
        tic = time.perf_counter()
        IC.main(["--kind", kind, *argv, "--out", out[kind]])
        seconds[kind] = time.perf_counter() - tic
    print("  import_checkpoint seconds: " + ", ".join(
        f"{k} {v:.2f}" for k, v in seconds.items()))

    # (a) the pipeline CLI from the imported files against the same CLI on
    # the trees map_* return
    g_trees = TI.map_generator_params(TI.flatten_state_dict(
        TI.read_pth(ref["netG"])))
    m_state = TI.flatten_state_dict(TI.read_pth(ref["model"]))
    m_params = TI.map_motion_params(m_state)
    npz = (os.path.join(work, "motion_mapped.npz"),
           os.path.join(work, "renderer_mapped.npz"))
    write_npz(npz[0], m_params)
    write_npz(npz[1], *g_trees)
    motion_t, conf_t, keys_t = serve["inputs"]
    keys_u8 = (keys_t[0] * 255).round().to(torch.uint8).cpu().numpy()
    inputs = _serve_files_inputs(work, keys_u8,
                                 motion_t[0].double().cpu().numpy(),
                                 conf_t[0].double().cpu().numpy(), mcfg)
    per_step = sum(isinstance(m, (InstanceNorm, Spade))
                   for m in serve["gen"].modules())
    S = (L - 1) // rate
    chunks = -(-S // max(min(16, S), 64 // rate))
    want = {"rasterize": chunks, "rasterize_packed": 0,
            "instance_norm": chunks * (rate - 1) * per_step,
            "instance_norm_parity": 0, "instance_norm_r3": 0,
            "upconv": chunks * (rate - 1) * _count_upconvs(serve["gen"]),
            **_lk_warps(0)}         # the CLI's LK: flow_scale 1
    runs = {}
    for tag, ckpts in (("imported", (out["motion"], out["renderer"])),
                       ("mapped", npz)):
        _reset_launches()
        res = _serve_by_files(work, inputs, ckpts, (m_yaml, r_yaml), mcfg,
                              rate, DEVICE)
        torch.cuda.synchronize()
        res["launches"] = _serve_launches()
        runs[tag] = res
        print(f"  pipeline CLI from the {tag} files: launches "
              f"{res['launches']} (derived {want}); seconds " + ", ".join(
                  f"{k} {v:.3f}" for k, v in res["seconds"].items()))
        if res["launches"] != want:
            raise AssertionError(f"CI {tag}: kernel launches "
                                 f"{res['launches']}")
    a, b = runs["imported"], runs["mapped"]
    if a["frames"].shape != (L, H, W, 3):
        raise AssertionError(f"CI frames {a['frames'].shape}")
    for part in ("frames", "dain", "pred"):
        if not np.array_equal(a[part], b[part]):
            raise AssertionError(f"CI: {part} from the imported files "
                                 f"differ from the mapped trees'")
    fps = L / sum(a["seconds"].values())
    print(f"  (a) {L} frames from the imported files equal the mapped "
          f"trees' bit for bit (frames, backgrounds, Predict_motion); "
          f"{fps:.3f} frames/s from files ({card_line()})")

    # (b) the motion CLI resumes from the imported checkpoint
    state = create_motion_state(mcfg, DEVICE, mcfg.seed)
    TM.load_checkpoint(out["motion"], state)
    count, mu, nu, nu_max = TI.map_motion_opt_state(
        TI.read_pth(ref["opt"]), list(m_state))
    if int(state.opt.count) != count or state.step != REF_EPOCH_M:
        raise AssertionError(f"CI motion: count {int(state.opt.count)}, "
                             f"step {state.step}")
    for name, tree in (("mu", mu), ("nu", nu), ("nu_max", nu_max)):
        same_bits(f"(b) resumed optimizer {name} vs the .pth's moments",
                  getattr(state.opt, name),
                  _flat_moment(tree, state.model).to(DEVICE))
    # slot 0 (input_embed.weight) straight from the file, no mapping
    raw = TI.read_pth(ref["opt"])["transformer"]["state"][0]["exp_avg"]
    same_bits("(b) input_embed.weight's exp_avg, raw", state.opt.mu[
        :raw.numel()], raw.reshape(-1).to(DEVICE))
    _reset_launches()
    tic = time.perf_counter()
    res = TM.main(["--synthetic", "--resume", "--config", m_yaml,
                   "--out-dir", os.path.dirname(out["motion"]),
                   "--epochs", str(REF_EPOCH_M + 2), "--steps-per-epoch",
                   "1", "--device", DEVICE])
    torch.cuda.synchronize()
    t_motion = time.perf_counter() - tic
    st = res["state"]
    if (st.step != REF_EPOCH_M + 2 or int(st.opt.count) != count + 2
            or int(st.opt.total_notfinite)
            or not bool(torch.isfinite(st.opt.flat).all())):
        raise AssertionError(f"CI motion resume: step {st.step}, count "
                             f"{int(st.opt.count)}")
    print(f"  (b) train_motion --resume: step {REF_EPOCH_M} -> {st.step}, "
          f"AMSGrad count {count} -> {int(st.opt.count)}, finite, no "
          f"skipped update; {t_motion:.2f} s")

    # (c) the renderer CLI resumes from the imported G and D
    saved = os.environ.get("VGG19_NPZ")
    os.environ["VGG19_NPZ"] = out["vgg19"]
    try:
        if find_vgg_weights() != out["vgg19"]:
            raise AssertionError("VGG19_NPZ is not the imported npz")
        _reset_launches()
        tic = time.perf_counter()
        res = TR.main(["--synthetic", "--resume", "--config", t_yaml,
                       "--out-dir", os.path.dirname(out["renderer"]),
                       "--epochs", str(REF_EPOCH_G + 2), "--steps-per-epoch",
                       "1", "--seed", "0", "--device", DEVICE])
        torch.cuda.synchronize()
        t_render = time.perf_counter() - tic
    finally:
        if saved is None:
            os.environ.pop("VGG19_NPZ", None)
        else:
            os.environ["VGG19_NPZ"] = saved
    st, hist = res["state"], res["epochs"]
    launches = _train_launches()
    derived = Counter()
    for e in hist:
        for k, v in derived_train_launches(_train_cfg(), st.gen, st.dis,
                                           e["frames"] - 2).items():
            derived[k] += e["steps"] * v
    derived = {k: derived[k] for k in launches}
    finite = all(bool(torch.isfinite(o.flat).all())
                 for o in (st.opt_g, st.opt_d))
    skipped = int(st.opt_g.total_notfinite) + int(st.opt_d.total_notfinite)
    print(f"  (c) train_renderer --synthetic --resume: step {REF_EPOCH_G} -> "
          f"{st.step} ({[e['steps'] for e in hist]} steps), launches "
          f"{launches} (derived {derived}); {t_render:.2f} s")
    if (st.step != REF_EPOCH_G + 2 or launches != derived or not finite
            or skipped):
        raise AssertionError(f"CI renderer resume: step {st.step}, "
                             f"launches {launches}, skipped {skipped}")
    per_step = {k: v // 2 for k, v in launches.items()}
    shutil.rmtree(work, ignore_errors=True)
    return dict(seconds=seconds, serve_launches=runs["imported"]["launches"],
                train_launches=launches, train_per_step=per_step,
                serve_fps=fps, motion_s=t_motion, renderer_s=t_render)


# ---------------------------------------------------------------------------
# SK. skeleton frames (K1's cfhw layout)
# ---------------------------------------------------------------------------

SK_HW = 512                     # render_skeleton_frames' default size


def skeleton_motion(L: int, seed: int) -> np.ndarray:
    """A (19, 2, L) normalized motion of the standing person
    (``_PERSON``) walking and swaying, inside [-1.6, 1.6], so that ×128
    + 256 keeps every joint in a 512×512 frame."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 4 * np.pi, L)
    body = (_PERSON - 0.5) * np.array([0.8, 2.0])          # (19, 2)
    path = np.stack([0.5 * np.sin(t / 2), 0.1 * np.sin(t)])  # (2, L)
    wiggle = 0.05 * np.sin(t[None, None] + rng.uniform(0, 6, (19, 2, 1)))
    return (body[:, :, None] + path[None] + wiggle).astype(np.float32)


def phase_skeleton(mcfg) -> dict:
    """SK: ``render_skeleton_frames`` on a motion of ``max_seq_length``
    frames at 512×512: K1 in the cfhw layout once per chunk, each chunk
    bit for bit its twin, the uint8 frames the CPU's (first and last
    chunk), per-chunk times beside the bound."""
    from renderloom_torch.ops import rasterize_kernel as RK
    from renderloom_torch.utils import visualize as V

    L, n = mcfg.dataset.max_seq_length, SK_HW
    chunks = -(-L // V.SKELETON_CHUNK)
    print(f"SK. skeleton frames: render_skeleton_frames on a {L}-frame "
          f"motion at {n}x{n} (brush {V.SKELETON_BRUSH}), K1 cfhw in "
          f"{chunks} chunks of at most {V.SKELETON_CHUNK} frames")
    # motion2gif's ×128 + 256 at 512×512
    pixels = skeleton_motion(L, 5) * (n / 4.0) + n / 2.0
    V.render_skeleton_frames(pixels[..., :V.SKELETON_CHUNK], n, n, DEVICE)
    calls = []
    _reset_launches()
    restore = _raster_recorder(calls)
    try:
        torch.cuda.synchronize()
        tic = time.perf_counter()
        frames = V.render_skeleton_frames(pixels, n, n, DEVICE)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - tic
    finally:
        restore()
    launches = dict(RK.rasterize_tables_cuda.layout_launches)
    print(f"  {L} frames in {seconds:.3f} s ({L / seconds:.1f} frames/s, "
          f"with the host copies); launches {launches}")
    if launches != {"nhwc": 0, "packed": 0, "cfhw": chunks} or \
            len(calls) != chunks:
        raise AssertionError(f"SK launches {launches}")
    if frames.shape != (L, n, n, 3) or frames.dtype != np.uint8 or \
            not frames.any():
        raise AssertionError(f"SK frames {frames.shape} {frames.dtype}")
    for i, (args, kw) in enumerate(calls):
        if kw != {"layout": "cfhw", "brush": V.SKELETON_BRUSH} or \
                args[6] is not True:
            raise AssertionError(f"SK call {i}: {kw}, masks {args[6]}")
        _k1_check(f"chunk {i} ({args[0].shape[0]} frames)", args[:3], n, n,
                  torch.float32, True, "cfhw", V.SKELETON_BRUSH)
    times = {}
    for i in (0, chunks - 1):
        F_ = calls[i][0][0].shape[0]
        times[F_] = _k1_times(f"cfhw {F_} frames at {n}x{n}, brush "
                              f"{V.SKELETON_BRUSH}", calls[i][0][:3], n, n,
                              torch.float32, True, "cfhw", V.SKELETON_BRUSH)
    # the CPU's frames of the first and the last chunk
    last = (chunks - 1) * V.SKELETON_CHUNK
    tic = time.perf_counter()
    cpu = np.concatenate([
        V.render_skeleton_frames(pixels[..., :V.SKELETON_CHUNK], n, n, "cpu"),
        V.render_skeleton_frames(pixels[..., last:], n, n, "cpu")])
    t_cpu = time.perf_counter() - tic
    card = np.concatenate([frames[:V.SKELETON_CHUNK], frames[last:]])
    if not np.array_equal(card, cpu):
        raise AssertionError(f"SK: card frames differ from the CPU's at "
                             f"{int((card != cpu).sum())} values")
    print(f"  the card's uint8 frames of chunks 0 and {chunks - 1} "
          f"({len(cpu)} frames) equal the CPU's ({t_cpu:.1f} s on the "
          f"host); {card_line()}")
    full = times[V.SKELETON_CHUNK]
    return dict(full, launches=launches["cfhw"], seconds=seconds,
                chunks=chunks, chunk_frames=V.SKELETON_CHUNK,
                last_chunk=times[L - last])


# ---------------------------------------------------------------------------
# BW. background warping (build_dataset warp)
# ---------------------------------------------------------------------------

BW_FRAMES, BW_HW = 8, (512, 768)         # extract_clips' 768×512
# card against CPU in PNG levels (largest, share of values not equal),
# with a planted control (the CPU's backgrounds a frame later) that must
# lie beyond both.  The two runs differ by float32 rounding in the LK
# flow, which moves a value near a level boundary to the next level.
# Reading in train mode on an NVIDIA H100 80GB HBM3 at 700 W: 1 level on
# 0.2329% of values (the control: 47 levels, 5.03%); the limits are one
# level more and about four times the share.
BW_MAX_LEVELS, BW_SHARE_TOL = 2, 0.01


def _warp_clip(path: str, seed: int):
    """An 8-frame clip of 768×512 PNGs: a textured background with a
    bright blob moving a few pixels a frame."""
    from PIL import Image

    H, W = BW_HW
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = 0.3 + 0.1 * np.sin(xx / 7.0)[..., None] * np.cos(yy / 11.0)[
        ..., None] + 0.05 * rng.uniform(size=(1, 1, 3))
    os.makedirs(path)
    for k in range(BW_FRAMES):
        cx, cy = W / 3 + 6 * k, H / 2 + 2 * k
        blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 400.0)[..., None]
        img = np.clip(base + 0.6 * blob, 0, 1)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(path, f"frame{k:05d}.png"))


def phase_warp(probe) -> dict:
    """BW: ``build_dataset warp`` in both modes on an 8-frame 768×512
    clip on the card, against the same command with ``--device cpu``."""
    import shutil

    from renderloom_torch.cli import build_dataset as BD

    if not probe["PIL"]:
        raise AssertionError("phase BW needs PIL")
    work = os.path.join(ROOT, "build", "chip_smoke_warp")
    shutil.rmtree(work, ignore_errors=True)
    _warp_clip(os.path.join(work, "frames", "clip0"), 8)
    print(f"BW. build_dataset warp on a {BW_FRAMES}-frame "
          f"{BW_HW[1]}x{BW_HW[0]} clip, train and test (rate 4) modes, "
          f"card against --device cpu")
    out = {}
    for mode in ("train", "test"):
        runs = {}
        for dev in (DEVICE, DEVICE, "cpu"):       # the first is a warm-up
            dst = os.path.join(work, f"{mode}_{dev}")
            shutil.rmtree(dst, ignore_errors=True)
            secs = BD.main(["warp", "--frames", os.path.join(work, "frames"),
                            "--out", dst, "--mode", mode, "--device", dev])
            runs[dev] = (_png_dir(os.path.join(dst, "clip0")),
                         secs["clip0"])
        card, cpu = runs[DEVICE][0], runs["cpu"][0]
        n = BW_FRAMES if mode == "train" else (BW_FRAMES - 1) * 4 + 1
        if card.shape != (n, *BW_HW, 3):
            raise AssertionError(f"BW {mode}: {card.shape}")
        levels, share = _levels(card, cpu)
        c_levels, c_share = _levels(card[1:], cpu[:-1])
        print(f"  {mode}: {n} frames; card vs CPU {levels} levels, "
              f"{share:.4%} of values (limits {BW_MAX_LEVELS}, "
              f"{BW_SHARE_TOL:.0%}); control (a frame later) {c_levels} "
              f"levels, {c_share:.2%}; seconds per clip: card "
              f"{runs[DEVICE][1]:.3f}, CPU {runs['cpu'][1]:.3f}")
        if levels > BW_MAX_LEVELS or share > BW_SHARE_TOL:
            raise AssertionError(f"BW {mode}: {levels} levels, {share}")
        if c_levels <= BW_MAX_LEVELS or c_share <= BW_SHARE_TOL:
            raise AssertionError(f"BW {mode}: the control reads within "
                                 f"the limits")
        out[mode] = dict(levels=levels, share=share, card_s=runs[DEVICE][1],
                         cpu_s=runs["cpu"][1])
    shutil.rmtree(work, ignore_errors=True)
    print(f"  ({card_line()})")
    return out


# ---------------------------------------------------------------------------
# TP. tensor-parallel sharding
# ---------------------------------------------------------------------------

# world 2 against world 1, the generator's image and mask over their
# largest magnitude.  Reading on an NVIDIA H100 80GB HBM3 at 700 W: 0 on
# both ranks (TF32 off; cuDNN sums each output channel of a split conv
# as the whole conv does, its algorithms fixed by the shapes); the limit
# is float32 rounding through the generator's depth, the CPU tests'.
TP_RTOL = 1e-5
TP_BATCH = 2
TP_MIN_ELEMS = 1 << 14          # shard_params_tp's default


def tp_inputs(batch: int, H: int, W: int, seed: int) -> list:
    """The generator's inputs for :func:`tp_run`: label, previous label,
    warped and previous image, uniform in [-1, 1], numpy float32."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (batch, H, W, c)).astype(np.float32)
            for c in (22, 22, 3, 3)]


def tp_run(rcfg, g_trees, batch: int, seed: int, device,
           min_elems: int = 1 << 14, grads: bool = False) -> dict:
    """The serving generator on this rank (world 1 without a process
    group): built from ``g_trees`` (numpy flax params and batch_stats;
    seeded random weights, seed 1, without), replicated, split by
    ``parallel.shard_params_tp`` over the world, then one forward on
    ``batch`` seeded inputs (label, previous label, warped and previous
    image at the config's size).  Returns the image and mask, the split
    weights' names, the parameter bytes before and after, the kernel
    launches and the forward's seconds; with ``grads``, the forward
    records the gradient and the gradients of the sum of the image and
    mask with respect to every weight are returned too (this rank's
    slice of a split one), by parameter name."""
    from renderloom_torch.parallel import mesh
    from renderloom_torch.train.gan import (make_inference_pair,
                                            set_float32_precision)

    device = torch.device(device)
    set_float32_precision()         # as build_pipeline: no TF32
    gen = make_inference_pair(rcfg, *(g_trees or (None, None)), device)
    mesh.replicate(gen)
    nbytes = lambda: sum(p.numel() * p.element_size()
                         for p in gen.parameters())
    before = nbytes()
    mesh.shard_params_tp(gen, min_elems=min_elems)
    inputs = [torch.from_numpy(x).to(device) for x in tp_inputs(
        batch, rcfg.data.model_height, rcfg.data.model_width, seed)]
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else lambda: None)
    _reset_launches()
    sync()
    tic = time.perf_counter()
    with torch.inference_mode(not grads):
        img, mask = gen(*inputs)
    sync()
    out = dict(img=img.detach().float().cpu().numpy(),
               mask=mask.detach().float().cpu().numpy(),
               split=mesh.tp_split(gen), bytes=(before, nbytes()),
               launches=_kernel_launches(),
               seconds=time.perf_counter() - tic, world=mesh.world()[1])
    if grads:
        named = [(n, p) for n, p in gen.named_parameters()
                 if n.endswith("weight")]
        got = torch.autograd.grad(img.sum() + mask.sum(),
                                  [p for _, p in named])
        out["grads"] = {n: g.cpu().numpy() for (n, _), g in zip(named, got)}
    return out


def phase_tp(serve) -> dict:
    """TP: two spawned ranks on this card over gloo (correctness, not
    speed) run ``shard_params_tp`` on the serving generator at full width
    and one forward at B = 2, against world 1."""
    from renderloom_torch.parallel import run_ranks

    rcfg = serve["rcfg"]
    H, W = rcfg.data.model_height, rcfg.data.model_width
    print(f"TP. tensor-parallel serving generator (hsm.yaml, {W}x{H}, "
          f"B = {TP_BATCH}, seeded weights): world 2 (gloo, both ranks on "
          f"this card) vs world 1")
    one = tp_run(rcfg, None, TP_BATCH, 13, DEVICE, TP_MIN_ELEMS)
    tic = time.perf_counter()
    two = run_ranks(tp_run, 2, DEVICE, backend="gloo",
                    args=(rcfg, None, TP_BATCH, 13, DEVICE, TP_MIN_ELEMS))
    t_two = time.perf_counter() - tic
    n_norm, n_up = _count_norms(serve["gen"]), _count_upconvs(serve["gen"])
    for who, r in [("world 1", one)] + [(f"rank {i}", r)
                                        for i, r in enumerate(two)]:
        if (r["launches"]["instance_norm"], r["launches"]["upconv"]) != (
                n_norm, n_up):
            raise AssertionError(f"TP {who}: launches {r['launches']}")
    if one["split"] or not two[0]["split"] or two[0]["split"] != \
            two[1]["split"]:
        raise AssertionError("TP: split layers")
    if not np.isfinite(one["img"]).all():
        raise AssertionError("TP: non-finite output")
    errs = {}
    for r_i, r in enumerate(two):
        for part in ("img", "mask"):
            ref = one[part]
            err = float(np.abs(r[part] - ref).max() / np.abs(ref).max())
            errs[f"rank{r_i}_{part}"] = err
    worst = max(errs.values())
    print(f"  {len(two[0]['split'])} weights split; parameter bytes world 1 "
          f"{one['bytes'][0]:,}, ranks {[r['bytes'][1] for r in two]}; K2 "
          f"launches world 1 {one['launches']['instance_norm']}, ranks "
          f"{[r['launches']['instance_norm'] for r in two]} ({n_norm} "
          f"derived); world 2 vs world 1 over the largest: " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tol {TP_RTOL:.0e}); forward seconds world 1 "
          f"{one['seconds']:.3f}, ranks "
          f"{[round(r['seconds'], 3) for r in two]}; {t_two:.1f} s with "
          f"the spawn ({card_line()})")
    if not worst <= TP_RTOL:
        raise AssertionError(f"TP: world 2 vs world 1 {worst}")
    return dict(errs=errs, launches1=one["launches"],
                launches2=[r["launches"] for r in two],
                bytes1=one["bytes"][0], bytes2=[r["bytes"][1] for r in two],
                split=len(two[0]["split"]))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    tic = time.perf_counter()
    phase_build()
    probe = phase_probe()
    conv_lines = fft_conv_report()
    phase_norm()
    raster = phase_raster()
    launches, fps, norm, serve = phase_pipeline()
    fast = phase_fastpath(serve)
    parity = phase_norm_parity(fast)
    phase_fast_vs_standard(serve, fast)
    bf16 = phase_bf16(serve, fast, conv_lines)
    upconv = phase_upconv(serve)
    shiftwarp = phase_shiftwarp(serve)
    r3 = phase_norm_r3(bf16)
    parity["serve_clip_fastpath_bf16"] = phase_norm_parity_bf16(bf16)
    phase_bf16_cpu_match()
    phase_rollouts(serve)
    t_x = time.perf_counter()
    print(f"build, kernel and serving phases (1 through O): "
          f"{t_x - tic:.1f} s")
    exported = phase_export(serve, launches, bf16)
    t_y = time.perf_counter()
    planner = phase_planner(serve, fast, bf16)
    print(f"export and planner phases: X {t_y - t_x:.1f} s, Y "
          f"{time.perf_counter() - t_y:.1f} s")
    t_v = time.perf_counter()
    files = phase_serve_files(serve, bf16, probe)
    t_q = time.perf_counter()
    evals = phase_eval(serve, probe)
    print(f"file serving and evaluation phases: V {t_q - t_v:.1f} s, Q "
          f"{time.perf_counter() - t_q:.1f} s")
    t_l = time.perf_counter()
    flow = phase_flow(serve)
    t_k = time.perf_counter()
    pose = phase_pose(serve, probe)
    t_v2 = time.perf_counter()
    learned = phase_serve_learned(serve, files, flow, pose, probe)
    print(f"learned flow and pose phases: L {t_k - t_l:.1f} s, K "
          f"{t_v2 - t_k:.1f} s, V2 {time.perf_counter() - t_v2:.1f} s")
    t_p = time.perf_counter()
    layouts = phase_raster_layouts(serve, fast)
    phase_cpu_match()
    raster_train = phase_raster_train()
    train = phase_train()
    norm_train, norm_bwd = phase_norm_bwd(train)
    phase_train_cpu_match()
    t_new = time.perf_counter()
    print(f"layout and float32 training phases (P through D): "
          f"{t_new - t_p:.1f} s")
    train16 = phase_train_bf16(train)
    t_t = time.perf_counter()
    r3_train, bwd_r3 = phase_norm_bwd_r3(train16)
    t_b2 = time.perf_counter()
    phase_train_bf16_cpu_match()
    print(f"bf16 training phases: T {t_t - t_new:.1f} s, B2 "
          f"{t_b2 - t_t:.1f} s, D2 {time.perf_counter() - t_b2:.1f} s")
    t_w = time.perf_counter()
    h5train = phase_train_h5(probe)
    t_m = time.perf_counter()
    motion = phase_motion_train()
    t_m2 = time.perf_counter()
    phase_motion_cpu_match()
    print(f"training from data phases: W {t_m - t_w:.1f} s, M "
          f"{t_m2 - t_m:.1f} s, M2 {time.perf_counter() - t_m2:.1f} s")
    t_g = time.perf_counter()
    repro = phase_repro()
    print(f"reproducibility phase: G {time.perf_counter() - t_g:.1f} s")
    t_z = time.perf_counter()
    dp = phase_data_parallel(train)
    print(f"data-parallel phase: Z {time.perf_counter() - t_z:.1f} s")
    t_u = time.perf_counter()
    backbones = phase_backbones(train)
    t_j = time.perf_counter()
    dp_serve = phase_dp_serve(serve)
    t_i = time.perf_counter()
    variants = phase_layer_variants()
    print(f"backbone, data-parallel serving and layer-variant phases: U "
          f"{t_j - t_u:.1f} s, J {t_i - t_j:.1f} s, I "
          f"{time.perf_counter() - t_i:.1f} s")
    t_ci = time.perf_counter()
    imported = phase_import(serve, probe)
    t_sk = time.perf_counter()
    skeleton = phase_skeleton(serve["mcfg"])
    t_bw = time.perf_counter()
    warp = phase_warp(probe)
    t_tp = time.perf_counter()
    tp = phase_tp(serve)
    print(f"import, skeleton, warp and tensor-parallel phases: CI "
          f"{t_sk - t_ci:.1f} s, SK {t_bw - t_sk:.1f} s, BW "
          f"{t_tp - t_bw:.1f} s, TP {time.perf_counter() - t_tp:.1f} s")
    ci_s, ci_t = imported["serve_launches"], imported["train_launches"]
    tps = lambda k: {"tp_world1_forward": tp["launches1"][k],
                     **{f"tp_world2_rank{i}_forward": r[k]
                        for i, r in enumerate(tp["launches2"])}}
    bb = lambda k: {f"train_backbone_{net}_2_steps": r["launches"][k]
                    for net, r in backbones.items()}
    dps = lambda k: {"serve_dp_world1": dp_serve["launches1"][k],
                     **{f"serve_dp2_rank{i}": r[k] for i, r in
                        enumerate(dp_serve["launches2"])}}
    var = lambda k: sum(r[k] for r in variants["launches"].values())
    xf, xs = exported["fastpath_bf16"], exported["standard_f32"]
    dp2 = {k: sum(r[k] for r in dp["gan"]["launches2"])
           for k in dp["gan"]["launches2"][0]}
    n8 = planner["table"][max(planner["table"])]["launches"]
    t16 = {k: v["launches"] for k, v in train16.items()}
    w32, w16 = (h5train[k]["launches"] for k in ("train_h5",
                                                 "train_h5_bf16"))
    sw = lambda k: {"serve_clip": launches[k],
                    "serve_clip_fastpath": fast["launches"][k],
                    "serve_clip_bf16": bf16["standard"]["launches"][k],
                    "serve_clip_fastpath_bf16": bf16["fastpath"]["launches"]
                    [k], **{tag: v["launches"][k]
                            for tag, v in {**files, **evals}.items()},
                    "serve_exported": xs["launches"][k],
                    "serve_exported_fastpath_bf16": xf["launches"][k],
                    "serve_planner_fastpath_bf16": n8[k],
                    "backgrounds_learned": flow["launches"][k],
                    **({"serve_files_learned": learned["launches"][k]}
                       if learned else {}),
                    **dps(k), "serve_files_imported": ci_s[k],
                    "train_3_steps": train["launches"][k]}
    kernels = [
        dict(name="shift_warp_blend", route="cuda",
             source="renderloom_torch/csrc/shiftwarp.cu",
             replaces="none: the shift loop of ops/flow.py:_shift_resample1d "
                      "and the LK time blend, which the JAX package leaves "
                      "to XLA",
             launches=launches["shift_warp_blend"],
             launches_by_path=sw("shift_warp_blend"),
             **shiftwarp["rows"]["blend"],
             upsample_background_ms=shiftwarp["whole_ms"]),
        dict(name="shift_warp", route="cuda",
             source="renderloom_torch/csrc/shiftwarp.cu",
             replaces="none: the shift loop of ops/flow.py:_shift_resample1d",
             launches=launches["shift_warp"],
             launches_by_path=sw("shift_warp"),
             **shiftwarp["rows"]["warp_consistency"],
             full_size=shiftwarp["rows"]["warp_full"]),
        dict(name="upconv", route="cuda",
             source="renderloom_torch/csrc/upconv.cu",
             replaces="none: upsample2x + the 3x3 convolution of the mask "
                      "net's up blocks, which the JAX package leaves to XLA",
             launches=launches["upconv"],
             launches_by_path={"serve_clip": launches["upconv"],
                               "serve_clip_fastpath": fast["launches"]
                               ["upconv"],
                               "serve_clip_bf16": bf16["standard"]
                               ["launches"]["upconv"],
                               "serve_clip_fastpath_bf16": bf16["fastpath"]
                               ["launches"]["upconv"],
                               "train_3_steps": train["launches"]["upconv"],
                               "train_step_bf16_3_steps": t16[True]
                               ["upconv"],
                               **{k: v["launches"]["upconv"]
                                  for k, v in {**files, **evals}.items()},
                               "train_h5": w32["upconv"],
                               "train_h5_bf16": w16["upconv"],
                               "serve_exported": xs["launches"]["upconv"],
                               "serve_exported_fastpath_bf16": xf["launches"]
                               ["upconv"],
                               "serve_planner_fastpath_bf16": n8["upconv"],
                               "train_dp2": dp2["upconv"],
                               **({"serve_files_learned": learned["launches"]
                                   ["upconv"]} if learned else {}),
                               **bb("upconv"), **dps("upconv"),
                               "serve_files_imported": ci_s["upconv"],
                               "train_imported_resumed_2_steps":
                                   ci_t["upconv"],
                               **tps("upconv")},
             **upconv),
        dict(name="rasterize", route="cuda",
             source="renderloom_torch/csrc/rasterize.cu",
             replaces="renderloom/ops/rasterize_pallas.py:408",
             launches=train["launches"]["rasterize"],
             launches_by_path={"serve_clip": launches["rasterize"],
                               "serve_clip_fastpath": fast["launches"]
                               ["rasterize"],
                               "train_3_steps": train["launches"]
                               ["rasterize"],
                               **{k: v["launches"]["rasterize"]
                                  for k, v in {**files, **evals}.items()},
                               "train_h5": w32["rasterize"],
                               "train_h5_bf16": w16["rasterize"],
                               "serve_exported": xs["launches"]["rasterize"],
                               "train_dp2": dp2["rasterize"],
                               **({"serve_files_learned": learned["launches"]
                                   ["rasterize"]} if learned else {}),
                               **bb("rasterize"), **dps("rasterize"),
                               "serve_files_imported": ci_s["rasterize"],
                               "train_imported_resumed_2_steps":
                                   ci_t["rasterize"]},
             **raster_train,
             serve=dict(shape=f"{F_RASTER}x{H_FULL}x{W_FULL}x22 f32 label, "
                              f"no masks", **raster),
             serve_pipeline_tables=layouts["standard"]),
        dict(name="instance_norm", route="cuda",
             source="renderloom_torch/csrc/instance_norm.cu",
             replaces="renderloom/ops/norm_pallas.py:150",
             launches=train["launches"]["instance_norm"],
             launches_by_path={"serve_clip": launches["instance_norm"],
                               "serve_clip_fastpath": fast["launches"]
                               ["instance_norm"],
                               "serve_clip_bf16": bf16["standard"]
                               ["launches"]["instance_norm"],
                               "serve_clip_fastpath_bf16": bf16["fastpath"]
                               ["launches"]["instance_norm"],
                               "train_3_steps": train["launches"]
                               ["instance_norm"],
                               "serve_files": files["serve_files"]
                               ["launches"]["instance_norm"],
                               "eval_h5": evals["eval_h5"]["launches"]
                               ["instance_norm"],
                               "train_h5": w32["instance_norm"],
                               "serve_exported": xs["launches"]
                               ["instance_norm"],
                               "serve_exported_fastpath_bf16": xf["launches"]
                               ["instance_norm"],
                               "serve_planner_fastpath_bf16": n8
                               ["instance_norm"],
                               "train_dp2": dp2["instance_norm"],
                               **({"serve_files_learned": learned["launches"]
                                   ["instance_norm"]} if learned else {}),
                               **bb("instance_norm"), **dps("instance_norm"),
                               "layer_variants": var("instance_norm"),
                               "serve_files_imported":
                                   ci_s["instance_norm"],
                               "train_imported_resumed_2_steps":
                                   ci_t["instance_norm"],
                               **tps("instance_norm")},
             train_backbones_max_abs_err=max(
                 r["k2_err"] for r in backbones.values()),
             **norm_train, serve=norm),
        dict(name="instance_norm_parity", route="cuda",
             source="renderloom_torch/csrc/instance_norm.cu",
             replaces="renderloom/ops/norm_pallas.py:150 (parity=True, "
                      "the reduction at :60-82)",
             launches=fast["launches"]["instance_norm_parity"],
             launches_by_path={"serve_clip_fastpath": fast["launches"]
                               ["instance_norm_parity"],
                               "serve_clip_fastpath_bf16": bf16["fastpath"]
                               ["launches"]["instance_norm_parity"],
                               "serve_exported_fastpath_bf16": xf["launches"]
                               ["instance_norm_parity"],
                               "serve_planner_fastpath_bf16": n8
                               ["instance_norm_parity"]},
             **parity),
        dict(name="instance_norm_r3centered", route="cuda",
             source="renderloom_torch/csrc/instance_norm.cu",
             replaces="renderloom/models/layers.py:226 (instance_norm bf16 "
                      "dispatch r3centered; no Pallas kernel)",
             launches=bf16["standard"]["launches"]["instance_norm_r3"],
             launches_by_path={"serve_clip_bf16": bf16["standard"]
                               ["launches"]["instance_norm_r3"],
                               "serve_clip_fastpath_bf16": bf16["fastpath"]
                               ["launches"]["instance_norm_r3"],
                               "train_step_bf16_3_steps": t16[True]
                               ["instance_norm_r3"],
                               "train_step_bf16_nockpt_3_steps": t16[False]
                               ["instance_norm_r3"],
                               "serve_files_bf16": files["serve_files_bf16"]
                               ["launches"]["instance_norm_r3"],
                               "eval_h5_bf16": evals["eval_h5_bf16"]
                               ["launches"]["instance_norm_r3"],
                               "train_h5_bf16": w16["instance_norm_r3"],
                               "serve_exported_fastpath_bf16": xf["launches"]
                               ["instance_norm_r3"],
                               "serve_planner_fastpath_bf16": n8
                               ["instance_norm_r3"]},
             **r3,
             train_step_bf16=dict(
                 r3_train, launches_per_step=train16[True]["per_step"]
                 ["instance_norm_r3"])),
        dict(name="rasterize_packed", route="cuda",
             source="renderloom_torch/csrc/rasterize.cu",
             replaces="renderloom/ops/rasterize_pallas.py:239 (_kernel_"
                      "packed; also _kernel_cmaj :196 with the relayout "
                      ":422-434)",
             launches=fast["launches"]["rasterize_packed"],
             launches_by_path={"serve_clip_fastpath": fast["launches"]
                               ["rasterize_packed"],
                               "serve_exported_fastpath_bf16": xf["launches"]
                               ["rasterize_packed"],
                               "serve_planner_fastpath_bf16": n8
                               ["rasterize_packed"]},
             **layouts[("packed", torch.bfloat16, False)],
             shape=f"{F_RASTER}x{H_FULL // 2}x{W_FULL // 2}x88 bf16 label, "
                   f"no masks", person=layouts["person"],
             serve_pipeline_tables=layouts["fastpath"]),
        dict(name="rasterize_cfhw", route="cuda",
             source="renderloom_torch/csrc/rasterize.cu",
             replaces="renderloom/ops/rasterize_pallas.py:172 (_kernel)",
             launches=skeleton["launches"],
             launches_by_path={"skeleton_frames": skeleton["launches"]},
             **{k: skeleton[k] for k in ("max_abs_err", "ms", "device_ms",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "kept_share")},
             shape=f"{skeleton['chunk_frames']}x19+3x{SK_HW}x{SK_HW} f32 "
                   f"heatmaps and skeleton + masks, brush 2 (a "
                   f"render_skeleton_frames chunk)",
             last_chunk=skeleton["last_chunk"],
             serve_shape=dict(
                 layouts[("cfhw", torch.float32, True)],
                 shape=f"{F_RASTER}x19+3x{H_FULL}x{W_FULL} f32 + masks")),
        dict(name="instance_norm_bwd", route="cuda",
             source="renderloom_torch/csrc/instance_norm.cu",
             replaces="renderloom/models/layers.py:114 (_in_bwd, the custom "
                      "VJP of the instance norm; no Pallas kernel)",
             launches=train["launches"]["instance_norm_bwd"],
             launches_by_path={"train_3_steps": train["launches"]
                               ["instance_norm_bwd"],
                               "train_h5": w32["instance_norm_bwd"],
                               "train_dp2": dp2["instance_norm_bwd"],
                               **bb("instance_norm_bwd"),
                               "layer_variants": var("instance_norm_bwd"),
                               "train_imported_resumed_2_steps":
                                   ci_t["instance_norm_bwd"]},
             train_backbones_max_abs_err=max(
                 r["k2b_err"] for r in backbones.values()),
             **norm_bwd),
        dict(name="instance_norm_bwd_r3centered", route="cuda",
             source="renderloom_torch/csrc/instance_norm.cu",
             replaces="renderloom/models/layers.py:226 (the gradient JAX's "
                      "autodiff takes of the instance_norm bf16 dispatch "
                      "r3centered; no Pallas kernel)",
             launches=t16[True]["instance_norm_bwd_r3"],
             launches_by_path={"train_step_bf16_3_steps": t16[True]
                               ["instance_norm_bwd_r3"],
                               "train_step_bf16_nockpt_3_steps": t16[False]
                               ["instance_norm_bwd_r3"],
                               "train_h5_bf16": w16["instance_norm_bwd_r3"]},
             launches_per_step=train16[True]["per_step"]
             ["instance_norm_bwd_r3"],
             **bwd_r3),
    ]
    print(f"e2e_interp_frames_per_sec {fps:.3f} (fastpath "
          f"{fast['fps']:.3f}; bf16 {bf16['standard']['fps']:.3f}, bf16 "
          f"fastpath {bf16['fastpath']['fps']:.3f}; from files "
          f"{files['serve_files']['fps']:.3f}, bf16 "
          f"{files['serve_files_bf16']['fps']:.3f}); "
          f"gan_train_windows_per_sec "
          f"{train['wps']:.4f} (bf16 {train16[True]['wps']:.4f}, bf16 "
          f"without do_checkpoint {train16[False]['wps']:.4f}); "
          f"motion_train_seqs_per_sec {motion['float32']['seqs_per_sec']:.2f} "
          f"(bf16 {motion['bfloat16']['seqs_per_sec']:.2f}); frozen "
          f"{xs['fps']:.3f} (live {xs['live_fps']:.3f}), bf16 fastpath "
          f"frozen {xf['fps']:.3f} (live {xf['live_fps']:.3f}); data "
          f"parallel world 2 vs 1: {dp['gan']['world2']:.4f} vs "
          f"{dp['gan']['world1']:.4f} windows/s, "
          f"{dp['motion']['world2']:.2f} vs {dp['motion']['world1']:.2f} "
          f"seqs/s; flow step {flow['float32']['steps_per_sec']:.2f} "
          f"steps/s (bf16 {flow['bfloat16']['steps_per_sec']:.2f}), pose "
          f"step {pose['steps_per_sec']:.2f} steps/s"
          + (f", learned pipeline from files {learned['fps']:.3f} frames/s"
             if learned else "")
          + "; gan windows/s by perceptual backbone " + ", ".join(
              f"{k} {v['wps']:.4f}" for k, v in backbones.items())
          + "; gan windows/s with cudnn.deterministic "
          f"{repro['gan']['windows_per_sec']['cudnn.deterministic']:.4f} vs "
          f"{repro['gan']['windows_per_sec']['port']:.4f}; bench " + ", ".join(
              f"{k} {v['value']}" for k, v in dp["bench"].items())
          + f"; pipeline from imported checkpoints "
          f"{imported['serve_fps']:.3f} frames/s; skeleton frames "
          f"{skeleton['chunk_frames']}-frame chunk "
          f"{skeleton['device_ms']:.4f} "
          f"device ms (bound {skeleton['bound_ms']:.4f}); build_dataset "
          f"warp {warp['train']['card_s']:.3f} s (train) and "
          f"{warp['test']['card_s']:.3f} s (test) a clip"
          + "; chip_smoke "
          f"done in "
          f"{time.perf_counter() - tic:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
