"""Tracing.

Port of the JAX package's ``renderloom/utils/profiling.py``:

* :func:`trace` — ``torch.profiler`` (host and, where there is one, the
  CUDA device) over a block of steps, written to ``log_dir`` as a Chrome
  trace (``trace_<n>.json``, open it in Perfetto or ``chrome://tracing``)
  with the kernel-time table beside it (``key_averages_<n>.txt``);
* :func:`annotate` — a named span in that trace, so host stages show up
  beside device work.

The port's hot paths carry these spans, so a trace of them (the training
CLIs' ``--profile-dir``, or any ``torch.profiler`` session) shows:

* a serving request (``eval/pipeline.py:make_pipeline_fn``):
  ``pipeline.motion`` (the motion transformer), ``pipeline.background``
  (Lucas-Kanade backgrounds), ``pipeline.label`` (poses, keyframe stream
  and the rasterized label) and ``pipeline.rollout`` (the generator's
  rollout and compositing), once each, in that order;
* a renderer train step (``train/gan.py:make_gan_train_step``):
  ``gan.prep`` once (on raw windows), then per trained frame
  ``gan.g_forward``, ``gan.d_step`` and ``gan.g_step``.
"""

from __future__ import annotations

import contextlib
import os
from typing import ContextManager, Iterator

import torch

_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block and write its trace into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    n = len([f for f in os.listdir(log_dir) if f.startswith("trace_")])
    with profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{n}.json"))
    sort = "cuda_time_total" if len(activities) > 1 else "cpu_time_total"
    with open(os.path.join(log_dir, f"key_averages_{n}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=40))


def annotate(name: str) -> ContextManager:
    """``with annotate(name):`` a named span over the block while a
    profiler records, on the host timeline of the trace its kernels are
    in; it neither synchronises nor adds a device op.  While none
    records it is one shared ``nullcontext`` after a single flag check,
    so ``torch.export`` (which traces with no profiler on) sees nothing.

    The span is a function-scope record (``RecordFunctionFast``): the
    trace lists it as a host operation (category ``cpu_op``) named
    ``name``, which costs a fraction of ``record_function``'s
    user-annotation (that one dispatches two profiler operators)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)
