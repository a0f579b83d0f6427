"""Data-parallel training over ``torch.distributed``.

The port's counterpart of the JAX package's ``renderloom/parallel/
mesh.py`` on its ``data`` axis.  There, the batch is sharded over the
mesh, the parameters are replicated, and XLA inserts the gradient
``psum``.  Here each rank is one process (``torchrun``): it takes its
contiguous block of the global batch (:func:`shard_batch`, the block
``NamedSharding(mesh, P("data"))`` gives each device), starts from the
same parameters (:func:`replicate`, a broadcast from rank 0), and
averages the gradients once per optimizer update
(:func:`all_reduce_mean`, which ``train/gan.py:AmsgradIfFinite.step``
calls on its flat gradient vector), so every rank takes the same update;
the step metrics are averaged too (:func:`mean_metrics`).
Data-parallel serving takes the same three pieces: the inference
generator replicated, each rank's block of clips through the segment
rollout (no collective in the forward), and the outputs gathered back
in clip order (:func:`gather_batch`).
The losses keep their global-batch value: a loss that divides by a
count over the batch divides by this rank's share of the global batch's
count (:func:`count_share`, which the train steps take once per frame or
step for all their counts), and a loss summed over the batch is scaled
by the world size (:func:`times_world`), so the mean over ranks of each
rank's loss and gradient is the global batch's.

Tensor parallelism (:func:`shard_params_tp`, the JAX package's
``model`` axis) splits the large conv and linear weights' output
channels over a process group and all-gathers each split layer's output.

Without an initialized process group every function is the world-size-1
identity.  gloo reduces CUDA tensors through the host: the two-rank
check on a one-card machine runs both ranks on that card over gloo (NCCL
refuses two ranks on one device), and the tensors are copied to the host
and back explicitly.
"""

from __future__ import annotations

import contextlib
import os
import socket
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _live() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> Tuple[int, int]:
    """(rank, size) of the initialized process group, else (0, 1)."""
    if not _live():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def init(rank: int, size: int, init_method: str, device,
         backend: Optional[str] = None) -> torch.device:
    """Join a process group of ``size`` ranks as ``rank``: NCCL for a CUDA
    ``device``, gloo for the CPU, or ``backend`` where the caller names
    one (gloo on the card: several ranks on one card).  Returns the
    device."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to train "
                               "on the CPU over gloo")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=size, **kwargs)
    return device


def init_from_env(device="cuda") -> torch.device:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``):
    each rank on ``cuda:LOCAL_RANK`` over NCCL, or on the CPU over gloo
    when ``device`` is the CPU.  Without ``WORLD_SIZE`` in the
    environment nothing is joined and ``device`` is returned as it is
    (world size 1)."""
    device = torch.device(device)
    if "WORLD_SIZE" not in os.environ:
        return device
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass --device cpu to train "
                               "on the CPU over gloo")
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local} but "
                               f"{torch.cuda.device_count()} CUDA devices")
        device = torch.device("cuda", local)
    return init(rank, size, "env://", device)


@contextlib.contextmanager
def torchrun(device):
    """A training CLI's run under ``torchrun``: joins its process group
    (:func:`init_from_env`) for the run and leaves it after, yielding
    this rank's device; without ``torchrun``'s environment, or with a
    group already joined, it yields ``device`` as it is."""
    if "WORLD_SIZE" not in os.environ or _live():
        yield torch.device(device)
        return
    device = init_from_env(device)
    try:
        yield device
    finally:
        shutdown()


@contextlib.contextmanager
def rank_zero_first():
    """Run the block on rank 0 before the other ranks, so that what rank
    0 writes there (a cache of statistics, say) the others then read,
    and no two ranks write one file at once.  Without a process group it
    only runs the block."""
    rank = world()[0]
    if rank:
        dist.barrier()
    yield
    if _live() and rank == 0:
        dist.barrier()


def backend() -> Optional[str]:
    """The process group's backend, None without one."""
    return dist.get_backend() if _live() else None


def _reduce_(t: torch.Tensor, op) -> torch.Tensor:
    """All-reduce ``t`` in place (through the host for gloo and CUDA)."""
    if t.is_cuda and dist.get_backend() == "gloo":
        host = t.cpu()
        dist.all_reduce(host, op=op)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op)
    return t


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the ranks, a new tensor (``t`` itself
    without a process group)."""
    if not _live():
        return t
    return _reduce_(t.detach().clone(), dist.ReduceOp.SUM).div_(
        dist.get_world_size())


def count_share(counts: torch.Tensor) -> torch.Tensor:
    """The divisors of a rank's loss terms that divide by a count over
    the batch: each of ``counts`` (this rank's) summed over the ranks in
    one all-reduce, at least 1, over the world size, so that the mean
    over ranks of each rank's sum over its share is the global batch's
    mean; in ``counts``' dtype.  ``max(counts, 1)`` without a process
    group."""
    counts = counts.detach()
    if not _live():
        return torch.clamp(counts, min=1.0)
    total = _reduce_(counts.to(torch.float32, copy=True),   # exact sums
                     dist.ReduceOp.SUM)
    return (torch.clamp(total, min=1.0) / dist.get_world_size()).to(
        counts.dtype)


def times_world(t: torch.Tensor) -> torch.Tensor:
    """``t`` × the world size: a rank's term of a loss summed over the
    global batch, or divided by a global count, so that the mean over
    ranks is the global value (``t`` itself at world size 1)."""
    size = world()[1]
    return t * size if size > 1 else t


def mean_metrics(metrics: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """Scalar metrics averaged over the ranks in one all-reduce (the
    metrics themselves without a process group)."""
    if not _live():
        return metrics
    mean = all_reduce_mean(torch.stack(list(metrics.values())))
    return dict(zip(metrics, mean.unbind()))


def replicate(module: torch.nn.Module):
    """Make a module's parameters and buffers identical on every rank:
    rank 0's values, broadcast in place."""
    if not _live():
        return
    gloo = dist.get_backend() == "gloo"
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            if gloo and t.is_cuda:
                host = t.cpu()
                dist.broadcast(host, src=0)
                t.copy_(host)
            else:
                dist.broadcast(t.data, src=0)


def shard_batch(batch: Any, global_batch: Optional[int] = None) -> Any:
    """This rank's contiguous block of a global batch: a tensor, an array
    or a dict of them, each with a leading axis of k·``global_batch``
    rows (default: the first leaf's leading size, k = 1), of which rank
    r takes rows [r·k·b, (r+1)·k·b) with b = ``global_batch`` / world
    size.  Raises where the split is not even."""
    rank, size = world()
    leaves = list(batch.values()) if isinstance(batch, dict) else [batch]
    n = global_batch if global_batch is not None else len(leaves[0])
    if n % size:
        raise ValueError(f"global batch {n} does not split evenly over "
                         f"{size} ranks")
    b = n // size

    def take(x):
        if len(x) % n:
            raise ValueError(f"leading axis {len(x)} is not a multiple of "
                             f"the global batch {n}")
        k = len(x) // n
        return x[rank * k * b:(rank + 1) * k * b]

    if size == 1:
        return batch
    if isinstance(batch, dict):
        return {key: take(v) for key, v in batch.items()}
    return take(batch)


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """The global batch of this rank's block ``x``: every rank's block
    concatenated along the leading axis in rank order (the inverse of
    :func:`shard_batch`), on ``x``'s device, through the host under gloo
    as :func:`replicate` is.  ``x`` itself without a process group.
    What serving reads where the JAX package reads its globally sharded
    output."""
    if not _live():
        return x
    src = x.detach()
    if src.is_cuda and dist.get_backend() == "gloo":
        src = src.cpu()
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(x.device)


def local_batch(global_batch: int) -> int:
    """The per-rank batch of a global batch; raises where the split is
    not even."""
    size = world()[1]
    if global_batch % size:
        raise ValueError(f"global batch {global_batch} does not split "
                         f"evenly over {size} ranks")
    return global_batch // size


def process_shard(n: int, process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> np.ndarray:
    """Indices [0, n) this process reads: a strided slice of the global
    sample order, so processes drawing the same permutation read
    disjoint samples.  Without explicit arguments, the rank and world
    size of the initialized ``torch.distributed`` process group, else
    0 of 1 (the JAX package's ``parallel.process_shard`` over
    ``jax.process_index()``)."""
    rank, size = world()
    if process_index is None:
        process_index = rank
    if process_count is None:
        process_count = size
    return np.arange(process_index, n, process_count)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _rank_main(rank, size, init_method, device, backend, fn, args, queue):
    try:
        init(rank, size, init_method, device, backend)
        queue.put((rank, fn(*args), None))
    except Exception:       # reported to the parent, which raises
        queue.put((rank, None, traceback.format_exc()))
    finally:
        shutdown()


def run_ranks(fn: Callable, size: int, device,
              backend: Optional[str] = None, args: tuple = (),
              timeout: float = 600.0) -> List[Any]:
    """Run ``fn(*args)`` on ``size`` ranks, each a spawned process that
    has joined a process group at ``tcp://localhost`` on a free port
    (:func:`init` with ``device``, which the caller names, and
    ``backend``); returns each rank's
    result (picklable: numpy arrays, numbers), rank 0 first.  Raises
    with the rank's traceback where one failed; every process is ended
    before it returns."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    init_method = f"tcp://localhost:{_free_port()}"
    procs = [ctx.Process(target=_rank_main,
                         args=(r, size, init_method, str(device), backend,
                               fn, args, queue), daemon=True)
             for r in range(size)]
    for p in procs:
        p.start()
    results, errors = [None] * size, []
    try:
        for _ in range(size):
            rank, result, err = queue.get(timeout=timeout)
            results[rank] = result
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
                break
    finally:
        for p in procs:
            p.join(timeout=5 if not errors else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("a rank failed:\n" + "\n".join(errors))
    return results


class _SumGradients(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``group``.
    A split layer's input is the same on every rank, and each rank's
    slice of the layer gives only its share of that input's gradient
    (Megatron-LM's copy to the model-parallel region)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        host = grad.cpu() if grad.is_cuda and \
            dist.get_backend(ctx.group) == "gloo" else grad.clone()
        dist.all_reduce(host, group=ctx.group)
        return host.to(grad.device), None


class _GatherChannels(torch.autograd.Function):
    """All-gather along ``dim`` over ``group`` in rank order; the
    backward keeps this rank's slice of the gradient.  Every rank
    computes the same layers downstream of the gather, so that slice is
    the whole gradient of this rank's output (the column-parallel
    gather of Megatron-LM).  ``torch.distributed.nn.functional.
    all_gather`` would sum the ranks' gradients instead, the world size
    times this one here.  Through the host under gloo, as
    :func:`gather_batch`."""

    @staticmethod
    def forward(ctx, y, dim, group):
        ctx.dim, ctx.n = dim, y.shape[dim]
        ctx.rank = dist.get_rank(group)
        src = y.detach()
        if src.is_cuda and dist.get_backend(group) == "gloo":
            src = src.cpu()
        src = src.contiguous()
        parts = [torch.empty_like(src)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim=dim).to(y.device)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


def _tp_forward(self, *args, **kwargs):
    """A split layer's forward: its slice of the output channels without
    the bias, all-gathered over its group along the channel axis, then
    the whole bias added; the input's gradient summed over the group."""
    x = _SumGradients.apply(args[0], self.tp_group)
    bias = self.bias
    self.bias = None
    try:
        y = type(self).forward(self, x, *args[1:], **kwargs)
    finally:
        self.bias = bias
    y = _GatherChannels.apply(y, self.tp_dim, self.tp_group)
    if bias is None:
        return y
    shape = [1] * y.dim()
    shape[self.tp_dim] = -1
    return y + bias.to(y.dtype).reshape(shape)


def shard_params_tp(module: torch.nn.Module, group=None,
                    min_elems: int = 1 << 14) -> torch.nn.Module:
    """Tensor-parallel split of ``module``'s layers over ``group`` (the
    world by default): the counterpart of the JAX package's
    ``parallel/mesh.py:shard_params_tp`` over its ``model`` mesh axis.

    A conv or linear weight with at least ``min_elems`` elements whose
    output-channel count divides evenly by the group's size is split:
    each rank keeps only its contiguous slice of the output channels
    (torch's OIHW and (out, in) layouts put them on dim 0, flax's last,
    so the same leaves qualify).  Every other parameter and buffer stays
    whole on every rank, the split layers' biases included, and so do
    convs with spectral-norm power-iteration state (their σ is that of
    the whole kernel): fold the spectral norm first, as the serving
    generator is.  A split layer's output is all-gathered over the group
    along the channel axis before the next layer, where XLA inserts that
    collective itself in JAX; its bias is added after the gather.  In
    the backward each rank takes its slice of the output's gradient
    (:class:`_GatherChannels`) and the input's gradient is summed over
    the group (:class:`_SumGradients`), so every gradient is JAX's: a
    split weight's this rank's slice of it, a whole one's in full.
    Changes ``module`` in place and returns it; without a process group
    or with a group of size 1 it changes nothing.  The split layers
    carry ``tp_group`` and ``tp_dim`` (their output's channel axis);
    :func:`tp_split` names them."""
    from renderloom_torch.models.layers import Conv, SNConv

    if not _live():
        return module
    group = group if group is not None else dist.group.WORLD
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if size == 1:
        return module
    spectral = {id(m.conv) for m in module.modules()
                if isinstance(m, SNConv) and hasattr(m, "sn_u")}
    for m in module.modules():
        if isinstance(m, (Conv, torch.nn.Linear)):
            dim = -1                            # channels-last outputs
        elif isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d)):
            dim = 1
        else:
            continue
        w = m.weight
        if (id(m) in spectral or w.dim() < 2 or w.numel() < min_elems
                or w.shape[0] % size):
            continue
        n = w.shape[0] // size
        m.weight = torch.nn.Parameter(
            w.detach()[rank * n:(rank + 1) * n].clone(),
            requires_grad=w.requires_grad)
        m.tp_group, m.tp_dim = group, dim
        m.forward = _tp_forward.__get__(m)
    return module


def tp_split(module: torch.nn.Module) -> List[str]:
    """Names of the weights :func:`shard_params_tp` split in ``module``
    (each as its full parameter name)."""
    return [f"{name}.weight" if name else "weight"
            for name, m in module.named_modules() if hasattr(m, "tp_group")]


def shutdown():
    """Leave the process group, if one was joined."""
    if _live():
        dist.destroy_process_group()
