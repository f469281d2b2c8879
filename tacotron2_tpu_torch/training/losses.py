"""Training losses.

Counterpart of ``tacotron2_tpu/training/losses.py``: loss = BCEWithLogits(gate,
gate target) + MSE(mel, target) + MSE(mel_post, target), each a plain mean
over the FULL padded tensors, as the reference computes it. Padding adds
~zero to the numerators (masked gate logits are -1000 against target 0,
masked mels are 0 against a padded target of 0) but counts in the
denominators; that is reproduced exactly.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


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
