"""Optimizer: clip, Adam with coupled weight decay, per-step MultiStepLR.

Counterpart of ``tacotron2_tpu/training/optimizer.py``, whose optax chain is
clip_by_global_norm(1.0) -> add_decayed_weights(wd) -> scale_by_adam ->
the MultiStepLR schedule. Here: ``clip_grad_norm_(1.0)`` on the gradients,
then ``torch.optim.Adam(weight_decay=wd)``, whose weight decay is the same
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
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import torch

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


def apply_gradients(params, opt, sched, frozen=()) -> torch.Tensor:
    """Clip the gradients of ``params`` (the optimizer's), step the
    optimizer, step the schedule; -> the global norm before clipping over
    every gradient, those of the ``frozen`` parameters included (JAX's
    ``grad_norm`` metric)."""
    norm = torch.nn.utils.clip_grad_norm_(params, GRAD_CLIP)
    grads = [p.grad for p in frozen if p.grad is not None]
    if grads:
        norm = torch.linalg.vector_norm(torch.stack(
            [norm, *(torch.linalg.vector_norm(g) for g in grads)]))
    opt.step()
    sched.step()
    return norm
