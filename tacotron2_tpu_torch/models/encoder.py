"""Tacotron 2 character encoder.

Counterpart of ``tacotron2_tpu/models/encoder.py``: embedding (padding row
0) -> 3x [Conv1d(k, SAME) -> BatchNorm1d (eval) -> ReLU] -> bidirectional
LSTM over packed sequences (hidden = dim/2 per direction; torch's packed
LSTM, f32). The convs are unmasked, like the reference's: padding chars
perturb activations within the kernel's reach of a row's end.
"""

from __future__ import annotations

import torch
from torch import nn

from tacotron2_tpu_torch.models import layers
from tacotron2_tpu_torch.models.layers import F32, Policy


class Encoder(nn.Module):
    def __init__(self, num_chars: int, embedding_dim: int, kernel_size: int):
        super().__init__()
        self.embedding = nn.Embedding(num_chars + 1, embedding_dim, padding_idx=0)
        mods = []
        for _ in range(3):
            # Sequential indices 0/4/8 conv, 1/5/9 BN (reference names)
            mods += [
                nn.Conv1d(embedding_dim, embedding_dim, kernel_size,
                          padding=(kernel_size - 1) // 2),
                nn.BatchNorm1d(embedding_dim),
                nn.ReLU(),
                nn.Dropout(0.5),
            ]
        self.convolutions = nn.Sequential(*mods)
        self.lstm = nn.LSTM(embedding_dim, embedding_dim // 2, batch_first=True,
                            bidirectional=True)

    def forward(self, chars_idx, chars_len, policy: Policy = F32):
        """chars (B, L) int, lengths (B,) -> encoded (B, L, D), eval mode."""
        x = layers.embedding(chars_idx, self.embedding.weight)
        for i in range(3):
            conv, bn = self.convolutions[4 * i], self.convolutions[4 * i + 1]
            x = layers.conv1d(x, conv.weight, conv.bias, policy, padding="SAME")
            x = layers.batchnorm_eval(x, bn.weight, bn.bias, bn.running_mean,
                                      bn.running_var, bn.eps)
            x = torch.relu(x)
        return layers.bilstm_packed(self.lstm, x, chars_len)
