"""Location-sensitive attention.

Counterpart of ``tacotron2_tpu/models/attention.py``: energies =
v(tanh(query(h) + location_dense(location_conv([w, w_cum])) + memory_proj)),
the conv with 31 taps, SAME padding and no bias; padded chars masked to -inf
before the softmax; context = weights @ memory.
"""

from __future__ import annotations

import torch
from torch import nn

from tacotron2_tpu_torch.models import layers
from tacotron2_tpu_torch.models.layers import F32, Policy


class LocationAttention(nn.Module):
    def __init__(self, att_rnn_dim: int, embedding_dim: int, att_dim: int,
                 n_filters: int = 32, kernel_size: int = 31):
        super().__init__()
        self.query_layer = nn.Linear(att_rnn_dim, att_dim, bias=False)
        self.v = nn.Linear(att_dim, 1, bias=False)
        self.location_conv = nn.Conv1d(2, n_filters, kernel_size,
                                       padding=(kernel_size - 1) // 2, bias=False)
        self.location_dense = nn.Linear(n_filters, att_dim, bias=False)

    def forward(self, att_hidden, memory, processed_memory, att_weights,
                att_weights_cum, mask, policy: Policy = F32):
        """att_hidden (B, H), memory (B, L, D), processed_memory (B, L, A),
        weights (B, L) previous and cumulative, mask (B, L) True where
        padded. Returns (context (B, D), weights (B, L))."""
        q = layers.linear(att_hidden, self.query_layer.weight, None, policy)[:, None, :]
        loc = torch.stack([att_weights, att_weights_cum], dim=-1)  # (B, L, 2)
        loc = layers.conv1d(loc, self.location_conv.weight, None, policy, padding="SAME")
        loc = layers.linear(loc, self.location_dense.weight, None, policy)
        energies = layers.linear(torch.tanh(q + loc + processed_memory),
                                 self.v.weight, None, policy)[..., 0]
        energies = energies.masked_fill(mask, float("-inf"))
        weights = torch.softmax(energies, dim=1)
        context = torch.einsum("bl,bld->bd", policy.cast(weights), policy.cast(memory))
        return context, weights
