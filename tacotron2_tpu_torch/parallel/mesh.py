"""Data- and tensor-parallel training over ``torch.distributed``.

Counterpart of ``tacotron2_tpu/parallel/mesh.py``. JAX runs one SPMD step
over a ("data", "model") mesh and XLA inserts the collectives; here every
rank runs the same step on its rows of the global batch (``shard_rows``)
and the collectives are explicit. The ranks form a grid of d data ranks by
m model ranks, rank = i_d * m + i_m (JAX ``make_mesh``'s reshape to (n //
m, m)): a data group holds the ranks of one i_m, a model group those of one
i_d (``make_data_parallel``). The step keeps JAX's meaning, one step on the
global batch:

- the train-mode BatchNorm statistics are those of the global batch
  (``batch_norm_train``: all-reduced sums over the data group in the
  forward pass, their gradients all-reduced in the backward pass);
- the CCC style loss takes all-reduced moments (``mean_over_ranks``);
- the dropout masks are drawn from one generator at the global shape on
  every rank, each rank keeping its data rank's rows (``rand_rows``), so a
  step equals the one-process step at the same seed up to the reduction
  order, and the m ranks of a model group draw the same masks;
- the gradients are summed over the data group and divided by its size
  (``all_reduce_grads``), as are the reported metrics.

Tensor parallelism (m > 1) splits, as JAX's ``param_shardings``, every
LSTM's and GRU's ``weight_ih`` / ``weight_hh`` and ``bias_ih`` / ``bias_hh``
over the model group by its output rows where m divides them, and
replicates the rest (``param_shardings``). The port splits by unit: rank r
holds the i, f, g and o rows (r, z and n for a GRU) of its H / m units
(``unit_slice``), so a step gathers h, not gate blocks; each rank keeps its
slices and their Adam moments only (``shard_parameters``). The decoder's
two cells run column-parallel step by step (``ops/train_scan.py``); every
other split parameter is gathered whole before the forward pass and keeps
its slice of the gradient (``gathered``); the clip takes the global norm
(``training/optimizer.py``); ``gather_state_dict`` rebuilds the
one-process state dict for a save. The collectives are ``all_reduce``
alone (gloo has no ``reduce_scatter``, and its CUDA tensors take no
``all_gather``): a gather is the sum of zero-padded slices.

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
class ModelParallel:
    """This process's place in its model group: rank ``rank`` of the ``n``
    ranks that take the same rows and each hold the ``rank``-th n-th of
    every split parameter's units; ``group`` the model group."""

    rank: int
    n: int
    group: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place in the data-parallel group: rank ``rank`` of
    ``n``, which holds rows ``[rank * B / n, (rank + 1) * B / n)`` of each
    global batch of B rows; ``group`` None is the default group. ``model``:
    its model group under tensor parallelism, None without."""

    rank: int
    n: int
    group: Optional[object] = None
    model: Optional[ModelParallel] = None

    @property
    def lead(self) -> bool:
        return self.rank == 0


_ACTIVE: Optional[DataParallel] = None


def current() -> Optional[DataParallel]:
    """The ``DataParallel`` of the step being run, None outside one."""
    return _ACTIVE


def model_parallel() -> Optional[ModelParallel]:
    """The model group of the step being run, None outside one or with m = 1."""
    mp = _ACTIVE.model if _ACTIVE is not None else None
    return mp if mp is not None and mp.n > 1 else None


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


def data_parallel_degree(batch_size: int, world_size: int, model_parallel: int = 1) -> int:
    """The data-parallel degree d of a grid of d x ``model_parallel`` ranks,
    at most ``world_size`` of them, whose d divides the global batch (JAX
    ``make_mesh_for_batch``'s ``shape["data"]``), with its warning when
    ranks are left idle."""
    m = model_parallel
    if not 1 <= m <= world_size:
        raise ValueError(f"model_parallel={m} needs 1 to {world_size} ranks")
    n = world_size // m * m
    while n > m and batch_size % (n // m) != 0:
        n -= m
    n = max(n, m)
    if n < world_size:
        warnings.warn(
            f"batch_size={batch_size} is not divisible across {world_size} devices "
            f"(model_parallel={m}); using only {n} device(s) — {world_size - n} idle. "
            f"Pick a batch size divisible by the data-parallel degree.", stacklevel=2)
    return n // m


def make_data_parallel(batch_size: int, model_parallel: int = 1) -> Optional[DataParallel]:
    """This rank's place in the grid of d x ``model_parallel`` ranks over the
    initialized default group, d from ``data_parallel_degree``: rank i_d *
    m + i_m is data rank i_d of the data group of i_m and model rank i_m of
    the model group of i_d. Every rank calls it (groups are made
    collectively); a rank beyond the grid gets None: it takes no rows and
    leaves the training."""
    world, rank = dist.get_world_size(), dist.get_rank()
    m = model_parallel
    d = data_parallel_degree(batch_size, world, m)
    if m == 1:
        group = None if d == world else dist.new_group(list(range(d)))
        return DataParallel(rank, d, group) if rank < d else None
    data_groups = [dist.new_group([i * m + j for i in range(d)]) for j in range(m)]
    model_groups = [dist.new_group([i * m + j for j in range(m)]) for i in range(d)]
    if rank >= d * m:
        return None
    i_d, i_m = divmod(rank, m)
    return DataParallel(i_d, d, data_groups[i_m], ModelParallel(i_m, m, model_groups[i_d]))


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


# ---------------------------------------------------------------------------
# tensor parallelism over the model group
# ---------------------------------------------------------------------------

# the decoder's two cells, which run column-parallel (``ops/train_scan.py``)
# on their slices instead of being gathered
COLUMN_PARALLEL = ("decoder.att_rnn.", "decoder.lstm.")
_SPLIT_NAMES = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")


def param_shardings(model: torch.nn.Module, model_parallel: int) -> Dict[str, Optional[int]]:
    """Each parameter's split over a model group of ``model_parallel`` ranks
    by JAX's rule (``_spec_for_param`` / ``param_shardings``): an LSTM's or
    GRU's 2-D ``weight_ih*`` / ``weight_hh*`` and its ``bias_ih*`` /
    ``bias_hh*`` split by their output rows where ``model_parallel``
    divides them, all else replicated. -> name: the split parameter's gate
    blocks G (4 for an LSTM, 3 for a GRU: its rows are G blocks of H units),
    None where replicated. The port splits by unit, so a split needs H
    divisible too."""
    out: Dict[str, Optional[int]] = {}
    for mod_name, mod in model.named_modules():
        for leaf, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            gates = (4 if isinstance(mod, (torch.nn.LSTM, torch.nn.LSTMCell)) else
                     3 if isinstance(mod, (torch.nn.GRU, torch.nn.GRUCell)) else None)
            rnn = gates is not None and leaf.startswith(_SPLIT_NAMES) and \
                (p.dim() == 2 or leaf.startswith(("bias_ih", "bias_hh")))
            if not rnn or p.shape[0] % model_parallel:
                out[name] = None
                continue
            if (p.shape[0] // gates) % model_parallel:
                raise ValueError(f"{name}: {p.shape[0] // gates} units do not split over "
                                 f"{model_parallel} ranks (the port splits by unit)")
            out[name] = gates
    return out


def unit_slice(full: torch.Tensor, gates: int, rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s n-th of the units of (G H, ...) rows, gate block by
    gate block: (G H / n, ...)."""
    H = full.shape[0] // gates
    h = H // n
    return full.reshape((gates, H) + full.shape[1:])[:, rank * h:(rank + 1) * h] \
        .reshape((gates * h,) + full.shape[1:])


def model_sum_(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """``x`` summed over the model group, in place; every rank gets the same bits."""
    dist.all_reduce(x, group=mp.group)
    return x


def gather_units(part: torch.Tensor, gates: int, mp: ModelParallel) -> torch.Tensor:
    """The whole (G H, ...) tensor from each model rank's ``unit_slice``
    (the sum of the zero-padded slices)."""
    h = part.shape[0] // gates
    full = part.new_zeros((gates, h * mp.n) + part.shape[1:])
    full[:, mp.rank * h:(mp.rank + 1) * h] = part.reshape((gates, h) + part.shape[1:])
    return model_sum_(full, mp).reshape((gates * h * mp.n,) + part.shape[1:])


def gather_columns(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """(B, h) of this rank's units -> (B, m h) of every rank's, in unit order."""
    h = x.shape[1]
    full = x.new_zeros(x.shape[0], h * mp.n)
    full[:, mp.rank * h:(mp.rank + 1) * h] = x
    return model_sum_(full, mp)


class _GatherUnits(torch.autograd.Function):
    """``gather_units``, differentiable: every model rank computes the same
    gradient of the whole tensor (the same rows, the same weights), and
    keeps its slice of it."""

    @staticmethod
    def forward(ctx, part, gates, mp):
        ctx.gates, ctx.mp = gates, mp
        return gather_units(part, gates, mp)

    @staticmethod
    def backward(ctx, g):
        return unit_slice(g, ctx.gates, ctx.mp.rank, ctx.mp.n).contiguous(), None, None


def shard_parameters(model: torch.nn.Module, dp: DataParallel) -> Dict[str, int]:
    """Cut each parameter that ``param_shardings`` splits down to this model
    rank's ``unit_slice``, in place; the names and gate blocks are kept on
    the model (``model.tp_split``). Every rank starts from the same whole
    weights; build the optimizer after, so that its moments are the
    slices'. -> the split names and their gate blocks."""
    mp = dp.model
    split = {k: g for k, g in param_shardings(model, mp.n).items() if g}
    for prefix in COLUMN_PARALLEL:
        if not any(k.startswith(prefix) for k in split):
            raise ValueError(f"the decoder's {prefix[:-1]} does not split over {mp.n} ranks")
    for name, gates in split.items():
        p = model.get_parameter(name)
        p.data = unit_slice(p.data, gates, mp.rank, mp.n).contiguous()
    model.tp_split = split
    return split


def split_ids(model: torch.nn.Module) -> frozenset:
    """The ids of the parameters a model rank holds a slice of."""
    return frozenset(id(model.get_parameter(k)) for k in getattr(model, "tp_split", {}))


@contextlib.contextmanager
def gathered(model: torch.nn.Module):
    """Inside a tensor-parallel step, every split parameter but the decoder
    cells' (``COLUMN_PARALLEL``) stands whole in its module, gathered over
    the model group, its gradient landing on the slice; elsewhere nothing.
    One collective a parameter and step: the encoder's recurrence (one
    persistent kernel) needs its W_hh whole."""
    mp = model_parallel()
    split = getattr(model, "tp_split", None)
    if mp is None or not split:
        yield
        return
    swapped = []
    try:
        for name, gates in split.items():
            if name.startswith(COLUMN_PARALLEL):
                continue
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name)
            p = mod._parameters.pop(leaf)
            swapped.append((mod, leaf, p))
            setattr(mod, leaf, _GatherUnits.apply(p, gates, mp))  # RNNs re-read it by name
        yield
    finally:
        for mod, leaf, p in reversed(swapped):
            delattr(mod, leaf)
            setattr(mod, leaf, p)


def gather_state_dict(model: torch.nn.Module, dp: Optional[DataParallel]
                      ) -> Dict[str, torch.Tensor]:
    """The one-process ``state_dict`` of a tensor-parallel model (JAX's
    ``device_get`` of a sharded tree): each split parameter gathered over
    the model group (every model rank calls it); the model's own without
    tensor parallelism."""
    sd = model.state_dict()
    mp = dp.model if dp is not None else None
    if mp is None or mp.n == 1:
        return sd
    for name, gates in getattr(model, "tp_split", {}).items():
        sd[name] = gather_units(sd[name], gates, mp)
    return sd


def gather_optimizer_state(opt: torch.optim.Optimizer, model: torch.nn.Module,
                           dp: Optional[DataParallel]) -> dict:
    """``opt.state_dict()`` with each split parameter's moments gathered
    over the model group (every model rank calls it): the one-process
    optimizer's layout, for a save or a one-process step from this state."""
    sd = opt.state_dict()
    mp = dp.model if dp is not None else None
    split = getattr(model, "tp_split", {})
    if mp is None or mp.n == 1 or not split:
        return sd
    names = {id(p): k for k, p in model.named_parameters()}
    params = [p for group in opt.param_groups for p in group["params"]]
    for i, p in enumerate(params):
        gates = split.get(names.get(id(p)))
        if gates and i in sd["state"]:
            sd["state"][i] = {k: gather_units(v, gates, mp)
                              if torch.is_tensor(v) and v.shape == p.shape and v.dim() else v
                              for k, v in sd["state"][i].items()}
    return sd
