"""Prosody predictor: CNN + BiRNN + attention-pooled regressor of prosodic
features from mels.

Counterpart of ``tacotron2_tpu/models/prosody.py`` (the reference's
ProsodyPredictorV2): optional delta and delta-delta input channels, 6
Xavier-init LeakyReLU ``Conv2d`` (kernel (5, 3), padding (2, 1)) with one
(2, 4) max-pool after the first, the reference's two-step reshape that
splits each pooled step's (mels / 4 x 256) vector over two output steps
(so the RNN runs at the padded frame rate), a pre-RNN projection,
bidirectional GRU layers (LSTM with ``use_lstm``) whose reverse direction
starts at each row's own last valid frame, frame weights softmaxed over the
valid frames, and a tanh head over ``num_features`` outputs. It returns
``(features, low, mid, high)``: the head's output and the activations the
style loss compares (the reshaped conv output, the RNN output, the pooled
vector). It runs in f32, as JAX's ``load_prosody_checkpoint`` builds it.

The RNN layers are one-layer ``nn.GRU`` / ``nn.LSTM`` modules over packed
sequences, with the dropout between layers applied here (``train``). They
stay in train mode whatever the predictor's mode (``train()`` below):
cuDNN computes an RNN's backward in train mode only, and the style loss
takes gradients through the frozen predictor; one-layer modules have no
dropout of their own, so train mode computes what eval mode would.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tacotron2_tpu_torch.models.layers import dropout

LRELU_SLOPE = 0.01
CONV_CHANNELS = (128, 256, 256, 256, 256, 256)
RNN_HIDDEN = 128


def compute_deltas(x: torch.Tensor, win_length: int = 5) -> torch.Tensor:
    """torchaudio's ``ComputeDeltas`` over the last (time) axis of (B, C, T):
    the least-squares slope over a +-n window with replicate padding."""
    n = (win_length - 1) // 2
    denom = n * (n + 1) * (2 * n + 1) / 3.0
    xp = F.pad(x, (n, n), mode="replicate")
    T = x.shape[-1]
    return sum((i - n) * xp[..., i:i + T] for i in range(win_length)) / denom


class ProsodyPredictor(nn.Module):
    def __init__(self, conv_out_dim: Optional[int] = None, rnn_in_dim: int = 768,
                 use_deltas: bool = True, use_lstm: bool = False, rnn_layers: int = 2,
                 rnn_dropout: float = 0.5, num_features: int = 7, num_mels: int = 80):
        super().__init__()
        if conv_out_dim is None:  # the pool quarters the mels, the reshape halves
            conv_out_dim = (num_mels // 4) * CONV_CHANNELS[-1] // 2
        self.conv_out_dim, self.rnn_in_dim = conv_out_dim, rnn_in_dim
        self.use_deltas, self.use_lstm = use_deltas, use_lstm
        self.rnn_layers, self.rnn_dropout = rnn_layers, rnn_dropout
        self.num_features, self.num_mels = num_features, num_mels
        gain = math.sqrt(2.0 / (1 + LRELU_SLOPE ** 2))
        chans = (3 if use_deltas else 1,) + CONV_CHANNELS
        self.convs = nn.ModuleList(nn.Conv2d(chans[i], chans[i + 1], (5, 3), padding=(2, 1))
                                   for i in range(len(CONV_CHANNELS)))
        for conv in self.convs:  # the reference's XavierConv2d; torch's bias init
            nn.init.xavier_uniform_(conv.weight, gain)
        self.pre_rnn = nn.Linear(conv_out_dim, rnn_in_dim)
        rnn = nn.LSTM if use_lstm else nn.GRU
        self.rnns = nn.ModuleList(
            rnn(rnn_in_dim if i == 0 else 2 * RNN_HIDDEN, RNN_HIDDEN, batch_first=True,
                bidirectional=True) for i in range(rnn_layers))
        self.frame_weights = nn.ModuleDict({"fc1": nn.Linear(2 * RNN_HIDDEN, 1),
                                            "fc2": nn.Linear(1, 1)})
        self.features_out = nn.ModuleDict({"fc1": nn.Linear(2 * RNN_HIDDEN, 64),
                                           "fc2": nn.Linear(64, num_features)})

    def hparams(self) -> dict:
        """The constructor's arguments, for the checkpoint."""
        return {"conv_out_dim": self.conv_out_dim, "rnn_in_dim": self.rnn_in_dim,
                "use_deltas": self.use_deltas, "use_lstm": self.use_lstm,
                "rnn_layers": self.rnn_layers, "rnn_dropout": self.rnn_dropout,
                "num_features": self.num_features, "num_mels": self.num_mels}

    def train(self, mode: bool = True) -> "ProsodyPredictor":
        super().train(mode)
        self.rnns.train(True)  # cuDNN's RNN backward needs it; see the module's doc
        return self

    def forward(self, mels: torch.Tensor, mel_lengths: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """mels (B, T, M), mel_lengths (B,) -> (features (B, F), low (B, T', C),
        mid (B, T', 256), high (B, 256)), T' = T rounded up to even. ``train``:
        dropout ``rnn_dropout`` between RNN layers, bits from ``generator``."""
        x = mels.float().transpose(1, 2)  # (B, M, T)
        if x.shape[2] % 2:
            x = F.pad(x, (0, 1))
        if self.use_deltas:
            d1 = compute_deltas(x)
            h = torch.stack([x, d1, compute_deltas(d1)], dim=1)  # (B, 3, M, T')
        else:
            h = x[:, None]
        h = h.transpose(2, 3)  # (B, C, T', M): the convs' H is time, W the mels
        for i, conv in enumerate(self.convs):
            h = F.leaky_relu(conv(h), LRELU_SLOPE)
            if i == 0:
                h = F.max_pool2d(h, (2, 4))
        B, C, Tp, Mp = h.shape
        t_padded = 2 * Tp
        low = h.permute(0, 2, 3, 1).reshape(B, t_padded, Mp * C // 2)
        if low.shape[-1] != self.conv_out_dim:
            raise ValueError(f"conv_out_dim mismatch: {low.shape[-1]} != {self.conv_out_dim}")
        out = F.leaky_relu(self.pre_rnn(low), LRELU_SLOPE)
        lengths = mel_lengths.clamp(max=t_padded)
        host_lengths = lengths.cpu()
        for i, rnn in enumerate(self.rnns):
            packed = nn.utils.rnn.pack_padded_sequence(out, host_lengths, batch_first=True,
                                                       enforce_sorted=False)
            out, _ = nn.utils.rnn.pad_packed_sequence(rnn(packed)[0], batch_first=True,
                                                      total_length=t_padded)
            if train and i < len(self.rnns) - 1:
                out = dropout(out, self.rnn_dropout, generator)
        mid = out
        fw = self.frame_weights
        w = fw["fc2"](torch.sigmoid(fw["fc1"](out)))[..., 0]
        pad = torch.arange(t_padded, device=w.device)[None, :] >= lengths.to(w.device)[:, None]
        w = torch.softmax(w.masked_fill(pad, float("-inf")), dim=1)
        high = torch.einsum("bt,btd->bd", w, out)
        fo = self.features_out
        feats = torch.tanh(fo["fc2"](F.leaky_relu(fo["fc1"](high), LRELU_SLOPE)))
        return feats, low, mid, high
