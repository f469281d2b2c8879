"""Tacotron 2 decoder step.

Counterpart of ``tacotron2_tpu/models/decoder.py`` at inference (no LSTM
dropout): attention LSTMCell([prenet, context]) -> location attention ->
cumulative-weight update -> decoder LSTMCell([att_h, context, controls]) ->
gate head over [rnn_h, context] and mel head over [rnn_h, context,
controls] (the controls of a controllable model, JAX's
``extra_decoder_in``; none otherwise). This is the model's own definition of a
step; the production decode runs the same math through the kernels of
``ops/decoder_loop.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from tacotron2_tpu_torch.models import layers
from tacotron2_tpu_torch.models.attention import LocationAttention
from tacotron2_tpu_torch.models.layers import F32, Policy


class DecoderState(NamedTuple):
    att_h: torch.Tensor  # (B, att_rnn_dim)
    att_c: torch.Tensor
    att_context: torch.Tensor  # (B, encoded_full_dim)
    att_weights: torch.Tensor  # (B, L)
    att_weights_cum: torch.Tensor  # (B, L)
    rnn_h: torch.Tensor  # (B, rnn_hidden_dim)
    rnn_c: torch.Tensor


def init_state(batch: int, encoded_len: int, att_rnn_dim: int,
               encoded_dim: int, rnn_hidden_dim: int, device=None) -> DecoderState:
    z = lambda *s: torch.zeros(*s, device=device)
    return DecoderState(
        att_h=z(batch, att_rnn_dim), att_c=z(batch, att_rnn_dim),
        att_context=z(batch, encoded_dim),
        att_weights=z(batch, encoded_len), att_weights_cum=z(batch, encoded_len),
        rnn_h=z(batch, rnn_hidden_dim), rnn_c=z(batch, rnn_hidden_dim),
    )


class Decoder(nn.Module):
    def __init__(self, num_mels: int, embedding_dim: int, prenet_dim: int,
                 att_rnn_dim: int, att_dim: int, rnn_hidden_dim: int, controls_dim: int = 0):
        super().__init__()
        self.controls_dim = controls_dim
        self.att_rnn = nn.LSTMCell(prenet_dim + embedding_dim, att_rnn_dim)
        self.attention = LocationAttention(att_rnn_dim, embedding_dim, att_dim)
        self.lstm = nn.LSTMCell(att_rnn_dim + embedding_dim + controls_dim, rnn_hidden_dim)
        self.mel_out = nn.Linear(rnn_hidden_dim + embedding_dim + controls_dim, num_mels)
        self.gate = nn.Linear(rnn_hidden_dim + embedding_dim, 1)

    def step(self, prev_mel_prenet, state: DecoderState, encoded, att_encoded,
             encoded_mask, policy: Policy = F32, controls=None):
        """One step -> (mel (B, M), gate (B, 1), new_state); ``controls``
        (B, controls_dim) for a controllable decoder."""
        extra = [] if controls is None else [controls]
        a = self.att_rnn
        att_h, att_c = layers.lstm_cell(
            torch.cat([prev_mel_prenet, state.att_context], dim=-1),
            (state.att_h, state.att_c),
            a.weight_ih, a.weight_hh, a.bias_ih, a.bias_hh, policy)
        context, weights = self.attention(
            att_h, encoded, att_encoded, state.att_weights,
            state.att_weights_cum, encoded_mask, policy)
        d = self.lstm
        rnn_h, rnn_c = layers.lstm_cell(
            torch.cat([att_h, context] + extra, dim=-1), (state.rnn_h, state.rnn_c),
            d.weight_ih, d.weight_hh, d.bias_ih, d.bias_hh, policy)
        head_in = torch.cat([rnn_h, context], dim=-1)
        gate = layers.linear(head_in, self.gate.weight, self.gate.bias, policy)
        mel = layers.linear(torch.cat([head_in] + extra, dim=-1), self.mel_out.weight,
                            self.mel_out.bias, policy)
        new_state = DecoderState(att_h, att_c, context, weights,
                                 state.att_weights_cum + weights, rnn_h, rnn_c)
        return mel, gate, new_state
