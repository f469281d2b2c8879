"""Postnet: 5-layer conv refinement applied as a residual over the mel.

Counterpart of ``tacotron2_tpu/models/postnet.py``: 5x [Conv1d(k=5, SAME, no
bias) -> BatchNorm1d -> Tanh -> Dropout], the last layer without Tanh;
num_mels -> postnet_dim -> ... -> num_mels, channels-last. In train mode the
BatchNorm runs on the batch's statistics and dropout follows every layer.
"""

from __future__ import annotations

import torch
from torch import nn

from tacotron2_tpu_torch.models import layers
from tacotron2_tpu_torch.models.layers import F32, Policy


class Postnet(nn.Module):
    def __init__(self, num_mels: int, postnet_dim: int, num_layers: int = 5):
        super().__init__()
        dims = [num_mels] + [postnet_dim] * (num_layers - 1) + [num_mels]
        mods = []
        for i in range(num_layers):
            # Sequential indices: conv at 4i, BN at 4i+1 (reference names)
            mods += [
                nn.Conv1d(dims[i], dims[i + 1], 5, padding=2, bias=False),
                nn.BatchNorm1d(dims[i + 1]),
                nn.Tanh() if i < num_layers - 1 else nn.Identity(),
                nn.Dropout(0.5),
            ]
        self.postnet = nn.Sequential(*mods)
        self.num_layers = num_layers

    def forward(self, x, policy: Policy = F32, train: bool = False, dropout: float = 0.5,
                generator=None):
        for i in range(self.num_layers):
            conv, bn = self.postnet[4 * i], self.postnet[4 * i + 1]
            x = layers.conv1d(x, conv.weight, None, policy, padding="SAME", round_out=True)
            x = layers.batchnorm(x, bn, train)
            if i < self.num_layers - 1:
                x = torch.tanh(x)
            if train:
                x = layers.dropout(x, dropout, generator)
        return x
