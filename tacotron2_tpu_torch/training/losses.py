"""Training losses.

Counterpart of ``tacotron2_tpu/training/losses.py``: loss = BCEWithLogits(gate,
gate target) + MSE(mel, target) + MSE(mel_post, target), each a plain mean
over the FULL padded tensors, as the reference computes it. Padding adds
~zero to the numerators (masked gate logits are -1000 against target 0,
masked mels are 0 against a padded target of 0) but counts in the
denominators; that is reproduced exactly. Also the prosody predictor's CCC
metrics and the style loss of the prosody-model configs (JAX :62-101).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from tacotron2_tpu_torch.parallel import mesh


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean of max(x, 0) - x y + log(1 + exp(-|x|))."""
    x, y = logits, targets
    return (torch.clamp(x, min=0.0) - x * y + torch.log1p(torch.exp(-x.abs()))).mean()


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def tacotron2_loss(mels, mels_post, gates, mel_target, gate_target
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    gate_loss = bce_with_logits(gates, gate_target)
    mel_loss = mse(mels, mel_target)
    mel_post_loss = mse(mels_post, mel_target)
    loss = gate_loss + mel_loss + mel_post_loss
    return loss, {"gate_loss": gate_loss, "mel_loss": mel_loss,
                  "mel_post_loss": mel_post_loss, "tacotron_loss": loss, "loss": loss}


def concordance_correlation_coefficient_loss(pred: torch.Tensor, target: torch.Tensor
                                             ) -> torch.Tensor:
    """1 - CCC over all elements, population moments (JAX
    ``concordance_correlation_coefficient_loss``). In a data-parallel step
    the moments are the global batch's, from all-reduced sums
    (``mesh.mean_over_ranks``, differentiable), not a mean of the ranks' CCCs."""
    if mesh.current() is not None:
        pm, tm = mesh.mean_over_ranks(torch.stack([pred.mean(), target.mean()])).unbind()
        dp, dt = pred - pm, target - tm
        cov, pv, tv = mesh.mean_over_ranks(torch.stack(
            [(dp * dt).mean(), (dp * dp).mean(), (dt * dt).mean()])).unbind()
        return 1.0 - 2.0 * cov / (pv + tv + (pm - tm) ** 2 + 1e-12)
    pm, tm = pred.mean(), target.mean()
    cov = ((pred - pm) * (target - tm)).mean()
    ccc = 2.0 * cov / (pred.var(unbiased=False) + target.var(unbiased=False) + (pm - tm) ** 2
                       + 1e-12)
    return 1.0 - ccc


def ccc_per_feature(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-column concordance correlation of a (B, F) batch with population
    moments (JAX ``ccc_per_feature``, torchmetrics' ``concordance_corrcoef``)."""
    pm, tm = pred.mean(0), target.mean(0)
    cov = ((pred - pm) * (target - tm)).mean(0)
    return 2.0 * cov / (pred.var(0, unbiased=False) + target.var(0, unbiased=False)
                        + (pm - tm) ** 2 + 1e-12)


def prosody_style_loss(predictor, mels_post: torch.Tensor, mel_target: torch.Tensor,
                       mel_lengths: torch.Tensor, kind: str = "mse") -> torch.Tensor:
    """The frozen prosody predictor's perceptual loss (JAX
    ``prosody_style_loss``): its low, mid and high activations over the
    ground-truth mel are the targets (no gradient), those over ``mels_post``
    the predictions; MSE per level, or with ``kind="ccc"`` the CCC loss, and
    the three summed. Gradients reach ``mels_post`` only: the predictor's
    parameters are frozen by its caller."""
    with torch.no_grad():
        _, low, mid, high = predictor(mel_target, mel_lengths)
    _, low_p, mid_p, high_p = predictor(mels_post, mel_lengths)
    term = concordance_correlation_coefficient_loss if kind == "ccc" else mse
    return term(low_p, low) + term(mid_p, mid) + term(high_p, high)
