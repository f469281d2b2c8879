"""Optimizer: clip, Adam with coupled weight decay, per-step MultiStepLR.

Counterpart of ``tacotron2_tpu/training/optimizer.py``, whose optax chain is
clip_by_global_norm(1.0) -> add_decayed_weights(wd) -> scale_by_adam ->
the MultiStepLR schedule. Here: the gradients clipped to a global norm of
1.0 (``clip_grad_norm_``'s norm and scaling), then
``torch.optim.Adam(weight_decay=wd)``, whose weight decay is the same
coupled kind (added to the gradient before the moments), then one
``MultiStepLR`` step per optimizer step.

Finetuning freezes parameters (JAX ``make_optimizer(freeze_mask=...)``:
``optax.multi_transform`` runs the whole chain on the trainable leaves and
``set_to_zero`` on the frozen ones). Here the optimizer is built over the
trainable parameters only (``trainable``), so Adam, its weight decay and
the schedule never touch a frozen one, and ``apply_gradients`` clips the
trainable gradients alone. The frozen parameters keep ``requires_grad``:
their gradients are computed, as JAX computes them, and count in the
reported norm.

Under tensor parallelism (``parallel/mesh.py``) a model rank holds slices
of the split parameters: the clip takes the global norm, each slice's
squares summed over the model group and each replicated parameter counted
once (``global_norm``), so every model rank scales by the same factor and
the replicated weights stay the same bits across the group.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import torch

from tacotron2_tpu_torch.parallel import mesh

GRAD_CLIP = 1.0


def trainable(model: torch.nn.Module, frozen_prefixes: Sequence[str] = ()
              ) -> List[torch.nn.Parameter]:
    """``model``'s parameters whose names start with none of ``frozen_prefixes``."""
    return [p for n, p in model.named_parameters() if not n.startswith(tuple(frozen_prefixes))]


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float, weight_decay: float,
                   milestones: Sequence[int] = (), gamma: float = 0.1
                   ) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.MultiStepLR]:
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=weight_decay)
    return opt, torch.optim.lr_scheduler.MultiStepLR(opt, list(milestones), gamma)


def global_norm(grads: Sequence[torch.Tensor], split: Sequence[bool],
                mp: Optional[mesh.ModelParallel] = None) -> torch.Tensor:
    """The L2 norm over a model's whole gradients, ``clip_grad_norm_``'s
    without a model group. With one (tensor parallelism), the squares of the
    slices (``split``) summed over the group, those of the replicated
    gradients once."""
    if mp is None:
        return torch.nn.utils.get_total_norm(grads)
    part = torch.nn.utils.get_total_norm([g for g, s in zip(grads, split) if s]) ** 2
    rep = torch.nn.utils.get_total_norm([g for g, s in zip(grads, split) if not s])
    return (rep ** 2 + mesh.model_sum_(part.to(rep.device), mp)).sqrt()


def apply_gradients(params, opt, sched, frozen=(), split: frozenset = frozenset(),
                    mp: Optional[mesh.ModelParallel] = None) -> torch.Tensor:
    """Clip the gradients of ``params`` (the optimizer's) by their
    ``global_norm``, step the optimizer, step the schedule; -> the global
    norm before clipping over every gradient, those of the ``frozen``
    parameters included (JAX's ``grad_norm`` metric). ``mp``: the model
    group of a tensor-parallel step, whose ranks hold slices of the
    parameters whose ids are in ``split``."""
    held = [p for p in params if p.grad is not None]
    norm = global_norm([p.grad for p in held], [id(p) in split for p in held], mp)
    torch.nn.utils.clip_grads_with_norm_(held, GRAD_CLIP, norm)
    fz = [p for p in frozen if p.grad is not None]
    if fz:
        norm = torch.linalg.vector_norm(torch.stack(
            [norm, global_norm([p.grad for p in fz], [id(p) in split for p in fz], mp)]))
    opt.step()
    sched.step()
    return norm
