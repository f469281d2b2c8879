"""Optimizer: clip, Adam with coupled weight decay, per-step MultiStepLR.

Counterpart of ``tacotron2_tpu/training/optimizer.py``, whose optax chain is
clip_by_global_norm(1.0) -> add_decayed_weights(wd) -> scale_by_adam ->
the MultiStepLR schedule. Here: ``clip_grad_norm_(1.0)`` on the gradients,
then ``torch.optim.Adam(weight_decay=wd)``, whose weight decay is the same
coupled kind (added to the gradient before the moments), then one
``MultiStepLR`` step per optimizer step.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import torch

GRAD_CLIP = 1.0


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float, weight_decay: float,
                   milestones: Sequence[int] = (), gamma: float = 0.1
                   ) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.MultiStepLR]:
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=weight_decay)
    return opt, torch.optim.lr_scheduler.MultiStepLR(opt, list(milestones), gamma)


def apply_gradients(params, opt, sched) -> torch.Tensor:
    """Clip, step the optimizer, step the schedule; -> the global gradient
    norm before clipping."""
    norm = torch.nn.utils.clip_grad_norm_(params, GRAD_CLIP)
    opt.step()
    sched.step()
    return norm
