"""Tacotron 2 character encoder.

Counterpart of ``tacotron2_tpu/models/encoder.py``: embedding (padding row
0, init N(0, 0.5)) -> 3x [Conv1d(k, SAME) -> BatchNorm1d -> ReLU -> Dropout (train)] ->
bidirectional LSTM over packed sequences (hidden = dim/2 per direction). The
convs are unmasked, like the reference's: padding chars perturb activations
within the kernel's reach of a row's end, and count in the train-mode
BatchNorm statistics.

Both round as the JAX encoder does under the policy: each conv's sums are
rounded to the compute type before its bias (``conv1d(round_out=True)``),
and the BiLSTM (``layers.bilstm``) follows ``lstm_sequence``: under bf16 its
products take bf16 operands with f32 sums while the carry stays f32; under
f32 it is torch's packed LSTM (cuDNN on the card, TF32 off by
``layers.use_f32_math``).
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
        with torch.no_grad():  # the reference's init: N(0, 0.5), padding row 0
            self.embedding.weight.normal_(0.0, 0.5)
            self.embedding.weight[0].zero_()
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

    def forward(self, chars_idx, chars_len, policy: Policy = F32, train: bool = False,
                dropout: float = 0.5, generator=None):
        """chars (B, L) int, lengths (B,) -> encoded (B, L, D). ``train``:
        BatchNorm on the batch's statistics (running stats updated) and
        dropout at ``dropout`` after each ReLU, bits from ``generator``."""
        x = layers.embedding(chars_idx, self.embedding.weight)
        for i in range(3):
            conv, bn = self.convolutions[4 * i], self.convolutions[4 * i + 1]
            x = layers.conv1d(x, conv.weight, conv.bias, policy, padding="SAME", round_out=True)
            x = torch.relu(layers.batchnorm(x, bn, train))
            if train:
                x = layers.dropout(x, dropout, generator)
        return layers.bilstm(self.lstm, x, chars_len, policy)
