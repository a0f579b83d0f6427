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
The losses keep their global-batch value: a loss that divides by a
count over the batch divides by this rank's share of the global batch's
count (:func:`count_share`, which the train steps take once per frame or
step for all their counts), and a loss summed over the batch is scaled
by the world size (:func:`times_world`), so the mean over ranks of each
rank's loss and gradient is the global batch's.

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


def shutdown():
    """Leave the process group, if one was joined."""
    if _live():
        dist.destroy_process_group()
