"""Train and eval steps.

Counterpart of ``tacotron2_tpu/training/step.py`` (``build_train_step``,
``make_eval_step``): teacher-forced forward, loss = BCE(gate) + MSE(mel) +
MSE(mel_post), backward (the decode's through kernel K4), clip 1.0, Adam,
MultiStepLR; a batch's ``speaker_id`` and ``controls`` go to the model,
as in the JAX steps. The metrics keep the JAX names; ``grad_norm`` is the global
norm before clipping. Evaluation is teacher-forced with ``train=False`` (no
BatchNorm update, no encoder/postnet/LSTM dropout) but keeps the prenet's
AlwaysDropout on, as the reference does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tacotron2_tpu_torch.training.losses import tacotron2_loss
from tacotron2_tpu_torch.training.optimizer import apply_gradients

BATCH_KEYS = ("chars_idx", "chars_len", "mel", "mel_len", "gate")
# a multi-speaker and a controllable model's batches also carry these
CONDITIONING_KEYS = ("speaker_id", "controls")


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The collated numpy batch's tensors on ``device``: ``BATCH_KEYS`` and
    those of ``CONDITIONING_KEYS`` that the batch has. ``speaker_id`` stays
    on the host: the model checks the ids' range there, without waiting for
    the card, and moves them for the embedding's gather."""
    keys = BATCH_KEYS + tuple(k for k in CONDITIONING_KEYS if k in batch)
    return {k: torch.as_tensor(batch[k]).to("cpu" if k == "speaker_id" else device,
                                            non_blocking=True) for k in keys}


def _forward_loss(model, batch, train: bool, generator, lstm_masks):
    out = model.forward_teacher(batch["chars_idx"], batch["chars_len"], batch["mel"],
                                batch["mel_len"], train=train, generator=generator,
                                lstm_masks=lstm_masks, speaker_id=batch.get("speaker_id"),
                                controls=batch.get("controls"))
    return tacotron2_loss(out.mels, out.mels_post, out.gates, batch["mel"], batch["gate"])


def train_step(model, opt, sched, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               lstm_masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
    """One optimizer step on ``batch``; -> metrics (device scalars)."""
    opt.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss, metrics = _forward_loss(model, batch, True, generator, lstm_masks)
        loss.backward()
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = apply_gradients(list(model.parameters()), opt, sched)
    return metrics


@torch.no_grad()
def eval_step(model, batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    _, metrics = _forward_loss(model, batch, False, generator, None)
    return metrics
