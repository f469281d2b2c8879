"""Train and eval steps.

Counterpart of ``tacotron2_tpu/training/step.py`` (``build_train_step``,
``make_eval_step``): teacher-forced forward, loss = BCE(gate) + MSE(mel) +
MSE(mel_post), backward (the decode's through kernel K4), clip 1.0, Adam,
MultiStepLR; a batch's ``speaker_id``, ``controls`` and
``description_embeddings`` go to the model, as in the JAX steps. The metrics keep the JAX names; ``grad_norm`` is the global
norm before clipping over every gradient, those of parameters the optimizer
does not hold (finetuning's frozen ones) included. With ``style`` (the
prosody-model configs' second phase, JAX ``build_train_step(prosody=...)``)
the loss adds the frozen predictor's ``style_loss``. Evaluation is
teacher-forced with ``train=False`` (no BatchNorm update, no
encoder/postnet/LSTM dropout) but keeps the prenet's AlwaysDropout on, as
the reference does, and also returns the batch's first row for the
validation images (JAX ``make_eval_step``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tacotron2_tpu_torch.parallel import mesh
from tacotron2_tpu_torch.training.losses import prosody_style_loss, tacotron2_loss
from tacotron2_tpu_torch.training.optimizer import apply_gradients

BATCH_KEYS = ("chars_idx", "chars_len", "mel", "mel_len", "gate")
# a multi-speaker, a controllable and a description model's batches also carry these
CONDITIONING_KEYS = ("speaker_id", "controls", "description_embeddings")


def stage_keys(batch: Dict[str, np.ndarray]) -> Tuple[str, ...]:
    """The fields of a collated batch that a step reads: ``BATCH_KEYS`` and
    those of ``CONDITIONING_KEYS`` that the batch has."""
    return BATCH_KEYS + tuple(k for k in CONDITIONING_KEYS if k in batch)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The collated numpy batch's tensors (``stage_keys``) on ``device``.
    ``speaker_id`` stays on the host: the model checks the ids' range
    there, without waiting for the card, and moves them for the
    embedding's gather."""
    return {k: torch.as_tensor(batch[k]).to("cpu" if k == "speaker_id" else device,
                                            non_blocking=True) for k in stage_keys(batch)}


def _forward_loss(model, batch, train: bool, generator, lstm_masks, style=None):
    out = model.forward_teacher(batch["chars_idx"], batch["chars_len"], batch["mel"],
                                batch["mel_len"], train=train, generator=generator,
                                lstm_masks=lstm_masks, speaker_id=batch.get("speaker_id"),
                                controls=batch.get("controls"),
                                description_embeddings=batch.get("description_embeddings"))
    loss, metrics = tacotron2_loss(out.mels, out.mels_post, out.gates, batch["mel"],
                                   batch["gate"])
    if style is not None:
        predictor, kind = style
        metrics["style_loss"] = prosody_style_loss(predictor, out.mels_post, batch["mel"],
                                                   batch["mel_len"], kind)
        loss = metrics["loss"] = loss + metrics["style_loss"]
    return loss, metrics, out


def train_step(model, opt, sched, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               lstm_masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               style: Optional[Tuple[torch.nn.Module, str]] = None,
               dp: Optional[mesh.DataParallel] = None) -> Dict[str, torch.Tensor]:
    """One optimizer step on ``batch``; -> metrics (device scalars). The
    gradients are cleared through the model, so a parameter the optimizer
    does not hold starts each step at none too. ``style``: (the frozen
    prosody predictor, "mse" or "ccc"). ``dp``: ``batch`` is this rank's
    rows of the global batch (``mesh.shard_rows``), ``lstm_masks`` if
    given are at the global batch's shape, and the step is the global
    batch's (``parallel/mesh.py``): the gradients and the metrics are
    all-reduced over the data group before the clip, so every rank takes
    the same update. Under tensor parallelism (``dp.model``, a model whose
    split parameters ``mesh.shard_parameters`` cut to this rank's slices)
    the split parameters other than the decoder cells' stand whole for the
    pass (``mesh.gathered``), the decoder runs column-parallel
    (``ops/train_scan.py``) and the clip takes the global norm."""
    model.zero_grad(set_to_none=True)
    with torch.enable_grad(), mesh.active(dp), mesh.gathered(model):
        loss, metrics, _ = _forward_loss(model, batch, True, generator, lstm_masks, style)
        loss.backward()
    metrics = {k: v.detach() for k, v in metrics.items()}
    held = {id(p) for group in opt.param_groups for p in group["params"]}
    params = list(model.parameters())
    if dp is not None:
        mesh.all_reduce_grads(params, dp)
        metrics = mesh.all_reduce_metrics(metrics, dp)
    args = ([p for p in params if id(p) in held], opt, sched,
            [p for p in params if id(p) not in held])
    mp = dp.model if dp is not None and dp.model is not None and dp.model.n > 1 else None
    metrics["grad_norm"] = apply_gradients(*args, mesh.split_ids(model), mp)
    return metrics


@torch.no_grad()
def eval_step(model, batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None
              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """-> (metrics, the first row's tensors): ``mel_spectrogram_pred``
    (mels_post), ``mel_spectrogram`` (the target), ``alignment`` (K3's
    attention weights, (T, L)), ``gate`` (the target) and ``gate_pred``
    (the logits), under JAX ``make_eval_step``'s names."""
    _, metrics, out = _forward_loss(model, batch, False, generator, None)
    firsts = {"mel_spectrogram_pred": out.mels_post[0], "mel_spectrogram": batch["mel"][0],
              "alignment": out.alignments[0], "gate": batch["gate"][0],
              "gate_pred": out.gates[0]}
    return metrics, firsts
