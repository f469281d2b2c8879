"""Data-parallel training over ``torch.distributed``.

Counterpart of ``tacotron2_tpu/parallel/mesh.py``'s data axis. JAX runs one
SPMD step over a ("data", "model") mesh and XLA inserts the collectives;
here every rank runs the same step on its rows of the global batch
(``shard_rows``) and the collectives are explicit. The step keeps JAX's
meaning, one step on the global batch:

- the train-mode BatchNorm statistics are those of the global batch
  (``batch_norm_train``: all-reduced sums in the forward pass, their
  gradients all-reduced in the backward pass);
- the CCC style loss takes all-reduced moments (``mean_over_ranks``);
- the dropout masks are drawn from one generator at the global shape on
  every rank, each rank keeping its rows (``rand_rows``), so a step equals
  the one-process step at the same seed up to the reduction order;
- the gradients are summed over the ranks and divided by their count
  (``all_reduce_grads``), as are the reported metrics.

These take effect inside ``active(dp)`` only (``training/step.py``'s
``train_step`` enters it); without a ``DataParallel`` none of this code
runs. ``init_data_parallel`` reads torchrun's environment.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import warnings
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place in the data-parallel group: rank ``rank`` of
    ``n``, which holds rows ``[rank * B / n, (rank + 1) * B / n)`` of each
    global batch of B rows; ``group`` None is the default group."""

    rank: int
    n: int
    group: Optional[object] = None

    @property
    def lead(self) -> bool:
        return self.rank == 0


_ACTIVE: Optional[DataParallel] = None


def current() -> Optional[DataParallel]:
    """The ``DataParallel`` of the step being run, None outside one."""
    return _ACTIVE


@contextlib.contextmanager
def active(dp: Optional[DataParallel]):
    """Run the enclosed forward and backward with the global-batch math of
    ``dp`` (None: the one-process math)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, dp
    try:
        yield dp
    finally:
        _ACTIVE = prev


def init_data_parallel(backend: str, init_method: Optional[str] = None,
                       rank: Optional[int] = None, world_size: Optional[int] = None
                       ) -> Tuple[int, int, int]:
    """Join the process group as torchrun describes it: ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` / ``MASTER_PORT``
    (``env://``), or the explicit ``init_method`` (``file://`` or
    ``tcp://``), ``rank`` and ``world_size``. ``backend`` is "nccl" (one
    card per rank; this rank's card becomes the current device) or "gloo"
    (the CPU, or ranks sharing a card). -> (rank, world size, local rank)"""
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if backend == "nccl":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, timeout=datetime.timedelta(minutes=30))
    return rank, world_size, local_rank


def data_parallel_degree(batch_size: int, world_size: int) -> int:
    """The largest number of ranks, at most ``world_size``, that divides
    the global batch (JAX ``make_mesh_for_batch``), with its warning when
    ranks are left idle."""
    n = world_size
    while n > 1 and batch_size % n != 0:
        n -= 1
    n = max(n, 1)
    if n < world_size:
        warnings.warn(
            f"batch_size={batch_size} is not divisible across {world_size} devices "
            f"(model_parallel=1); using only {n} device(s) — {world_size - n} idle. "
            f"Pick a batch size divisible by the data-parallel degree.", stacklevel=2)
    return n


def make_data_parallel(batch_size: int) -> Optional[DataParallel]:
    """This rank's ``DataParallel`` over the initialized default group, the
    degree from ``data_parallel_degree``. Every rank calls it (a subgroup
    is made collectively); a rank beyond the degree gets None: it takes no
    rows and leaves the training."""
    world, rank = dist.get_world_size(), dist.get_rank()
    n = data_parallel_degree(batch_size, world)
    group = None if n == world else dist.new_group(list(range(n)))
    return DataParallel(rank, n, group) if rank < n else None


def shard_rows(batch: Dict[str, object], rank: int, n: int) -> Dict[str, object]:
    """Rank ``rank``'s rows ``[rank * B / n, (rank + 1) * B / n)`` of each
    array of ``batch`` whose first axis is the batch's B (JAX
    ``shard_batch``'s split); other fields pass unchanged. The padding of
    the global batch stays: a shard keeps its T and L."""
    B = int(np.shape(batch["mel"])[0])
    if B % n:
        raise ValueError(f"a batch of {B} rows does not split over {n} ranks")
    lo, hi = rank * B // n, (rank + 1) * B // n
    return {k: (v[lo:hi] if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim
                and v.shape[0] == B else v) for k, v in batch.items()}


def local_rows(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """This rank's rows of a tensor at the global batch's shape along
    ``axis``: ``x`` itself outside a data-parallel step."""
    dp = _ACTIVE
    if dp is None:
        return x
    B = x.shape[axis] // dp.n
    return x.narrow(axis, dp.rank * B, B)


def rand_rows(shape: Sequence[int], generator: Optional[torch.Generator], device,
              axis: int = 0) -> torch.Tensor:
    """``torch.rand(shape)``; in a data-parallel step drawn at the global
    shape (``axis`` times n) and cut to this rank's rows, so every rank's
    generator advances alike and the masks are the one-process ones."""
    dp = _ACTIVE
    if dp is None:
        return torch.rand(tuple(shape), generator=generator, device=device)
    full = list(shape)
    full[axis] *= dp.n
    return local_rows(torch.rand(full, generator=generator, device=device), axis)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks, differentiable: each rank's loss depends on the
    sum, so the gradient reaching each rank's term is the sum of the
    ranks' gradients of it (``SyncBatchNorm``'s rule)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks of each rank's ``x``, differentiable: the
    global batch's mean of a quantity that each rank has as a mean over an
    equal count of its rows' elements."""
    return _AllReduceSum.apply(x, _ACTIVE.group) / _ACTIVE.n


def batch_norm_train(x: torch.Tensor, bn: torch.nn.modules.batchnorm._BatchNorm,
                     dims: Tuple[int, ...], channel_shape: Tuple[int, ...]) -> torch.Tensor:
    """Train-mode BatchNorm over ``dims`` of the global batch: the mean,
    then the biased variance as the mean of squared deviations, each from
    one all-reduced sum (their gradients all-reduced too); the running
    statistics updated in place alike on every rank (momentum 0.1, the
    unbiased variance). ``channel_shape`` broadcasts a channel vector
    against ``x``."""
    mean = mean_over_ranks(x.mean(dims))
    dev = x - mean.reshape(channel_shape)
    var = mean_over_ranks((dev * dev).mean(dims))
    with torch.no_grad():
        n = int(np.prod([x.shape[d] for d in dims])) * _ACTIVE.n
        bn.running_mean.mul_(0.9).add_(mean.detach(), alpha=0.1)
        bn.running_var.mul_(0.9).add_(var.detach() * (n / max(n - 1, 1)), alpha=0.1)
    scale = torch.rsqrt(var + bn.eps) * bn.weight
    return dev * scale.reshape(channel_shape) + bn.bias.reshape(channel_shape)


def all_reduce_grads(params: Iterable[torch.nn.Parameter], dp: DataParallel) -> None:
    """Every gradient (a finetune's frozen parameters' too: they count in
    ``grad_norm``) summed over the ranks in one coalesced all-reduce, then
    divided by the ranks' count: the gradient of the global batch's mean
    loss. A parameter without a gradient has none on every rank."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=dp.group)
    flat /= dp.n
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view_as(g))
        i += g.numel()


def all_reduce_metrics(metrics: Dict[str, torch.Tensor], dp: DataParallel
                       ) -> Dict[str, torch.Tensor]:
    """The metrics of the global batch: each rank's term times 1 / n,
    summed over the ranks in one all-reduce (the MSEs and the BCE are
    means over equal counts, so this is exact; a term already global,
    the CCC style loss, comes back as it was)."""
    names = sorted(metrics)
    flat = torch.stack([metrics[k].float() for k in names]) / dp.n
    dist.all_reduce(flat, group=dp.group)
    return dict(zip(names, flat.unbind()))


def broadcast_state(module: torch.nn.Module, dp: DataParallel) -> None:
    """Rank 0's parameters and buffers (the BatchNorm statistics) on every
    rank, in place."""
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0, group=dp.group)


def broadcast_object(obj, dp: DataParallel):
    """Rank 0's picklable ``obj`` on every rank; the others wait for it."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=dp.group)
    return box[0]
