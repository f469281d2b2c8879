"""Embedding-sequence encoder: a BiGRU stack with additive attention pooling.

Counterpart of ``tacotron2_tpu/models/embedding_encoder.py`` (the
reference's model/embedding_encoder.py, which no model constructs): a
multi-layer bidirectional GRU over a sequence of embeddings with
packed-sequence semantics (``layers.gru_sequence``), dropout between layers
in train mode, the all-layer final hidden states as the context
(``context_dim = 2 * encoder_out_dim``, hard-coded there), scores
v(tanh(W_h history + W_c context)) softmaxed over each row's valid steps,
and the pooled sum. The names are the reference's (``encoder.weight_ih_l0``,
``attention.history`` ...), which JAX's
``convert_embedding_encoder_state_dict`` reads.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tacotron2_tpu_torch.models import layers
from tacotron2_tpu_torch.models.layers import F32, Policy


class EmbeddingEncoder(nn.Module):
    def __init__(self, embedding_dim: int, encoder_out_dim: int, encoder_num_layers: int,
                 encoder_dropout: float, attention_dim: int):
        super().__init__()
        self.num_layers, self.dropout = encoder_num_layers, encoder_dropout
        self.encoder = nn.GRU(embedding_dim, encoder_out_dim // 2, encoder_num_layers,
                              batch_first=True, bidirectional=True)
        self.attention = nn.ModuleDict({
            "history": nn.Linear(encoder_out_dim, attention_dim, bias=False),
            "context": nn.Linear(2 * encoder_out_dim, attention_dim, bias=False),
            "v": nn.Linear(attention_dim, 1, bias=False)})

    def forward(self, x, lengths, train: bool = False,
                generator: Optional[torch.Generator] = None,
                policy: Policy = F32) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, T, E), lengths (B,) -> (pooled (B, encoder_out_dim), scores
        (B, T, 1)); ``train``: dropout between the layers, bits from
        ``generator``."""
        T = x.shape[1]
        lengths = torch.as_tensor(lengths).to(x.device)
        out, finals = x.float(), []
        for n in range(self.num_layers):
            fwd, h_f = layers.gru_sequence(self.encoder, out, lengths, policy=policy,
                                           suffix=f"_l{n}")
            bwd, h_b = layers.gru_sequence(self.encoder, out, lengths, reverse=True,
                                           policy=policy, suffix=f"_l{n}_reverse")
            out = torch.cat([fwd, bwd], dim=-1)
            finals += [h_f, h_b]
            if train and n < self.num_layers - 1:
                out = layers.dropout(out, self.dropout, generator)
        att = self.attention
        hist = layers.linear(out, att["history"].weight, None, policy)
        ctx = layers.linear(torch.cat(finals, dim=-1), att["context"].weight, None, policy)
        score = layers.linear(torch.tanh(hist + ctx[:, None, :]), att["v"].weight, None, policy)
        pad = (torch.arange(T, device=x.device)[None, :] >= lengths[:, None])[..., None]
        score = torch.softmax(score.masked_fill(pad, float("-inf")), dim=1).masked_fill(pad, 0.0)
        return torch.einsum("btz,btd->bd", score, out), score
