"""Global Style Tokens (GST): a style embedding from a reference mel.

Counterpart of ``tacotron2_tpu/models/gst.py`` (the reference's
model/gst.py, after NVIDIA Mellotron): ``ReferenceEncoder`` = 6 x [Conv2d
3x3, stride 2, pad 1 -> BatchNorm2d -> ReLU] over the mel as a one-channel
NCHW image (H the frames, W the mels), the channel-major flatten (N, C, T',
W') -> (N, T', C W'), then a GRU whose final hidden state is the encoding;
``STL`` = ``token_num`` learned tokens of ``E / num_heads`` under tanh,
read by a ``num_heads``-head attention whose scores are scaled by
sqrt(key_dim), the tokens' width (JAX ``mha_apply``). ``GST`` returns (N, 1,
E). The module names are the reference's, which JAX's
``convert_gst_state_dict`` reads.

Under a bf16 policy it rounds where JAX's does: each conv's operands and
its sums before the bias (``layers.conv2d``), the GRU's and the linears'
operands (f32 sums), and q, k, the softmax weights and v of the
attention's two products. It runs on stock PyTorch ops, as JAX's GST runs
outside Pallas.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tacotron2_tpu_torch.models import layers
from tacotron2_tpu_torch.models.layers import F32, Policy

REF_ENC_FILTERS = (32, 32, 64, 64, 128, 128)
NEUTRAL_FRAMES = 32  # the zeros reference of the neutral style (JAX ``_infer_style``)


def conv_out_len(n: int, n_convs: int, kernel: int = 3, stride: int = 2, pad: int = 1) -> int:
    for _ in range(n_convs):
        n = (n - kernel + 2 * pad) // stride + 1
    return n


class ReferenceEncoder(nn.Module):
    def __init__(self, filters: Sequence[int] = REF_ENC_FILTERS, n_mels: int = 80,
                 gru_size: int = 128):
        super().__init__()
        chans = (1,) + tuple(filters)
        self.convs = nn.ModuleList(nn.Conv2d(chans[i], chans[i + 1], 3, stride=2, padding=1)
                                   for i in range(len(filters)))
        self.bns = nn.ModuleList(nn.BatchNorm2d(c) for c in filters)
        self.gru = nn.GRU(filters[-1] * conv_out_len(n_mels, len(filters)), gru_size,
                          batch_first=True)

    def forward(self, mels, lengths=None, train: bool = False, policy: Policy = F32):
        """mels (N, T, M) -> (N, gru_size). ``lengths`` (N,) in frames, or
        None to run every step; ``train``: BatchNorm on the batch's
        statistics, the running ones updated."""
        x = mels.float()[:, None]
        for conv, bn in zip(self.convs, self.bns):
            x = layers.conv2d(x, conv.weight, conv.bias, policy, stride=2, padding=1)
            x = torch.relu(layers.batchnorm2d(x, bn, train))
        N, C, T2, W2 = x.shape
        x = x.transpose(1, 2).reshape(N, T2, C * W2)
        if lengths is not None:
            scale = 2 ** len(self.convs)
            lengths = torch.div(torch.as_tensor(lengths) + scale - 1, scale,
                                rounding_mode="floor")
        return layers.gru_sequence(self.gru, x, lengths, policy=policy)[1]


class MultiHeadAttention(nn.Module):
    def __init__(self, query_dim: int, key_dim: int, num_units: int, num_heads: int):
        super().__init__()
        self.num_heads, self.key_dim = num_heads, key_dim
        self.W_query = nn.Linear(query_dim, num_units, bias=False)
        self.W_key = nn.Linear(key_dim, num_units, bias=False)
        self.W_value = nn.Linear(key_dim, num_units, bias=False)

    def forward(self, query, key, policy: Policy = F32):
        """query (N, Tq, Dq), key (N, Tk, key_dim) -> (N, Tq, num_units)."""
        q = layers.linear(query, self.W_query.weight, None, policy)
        k = layers.linear(key, self.W_key.weight, None, policy)
        v = layers.linear(key, self.W_value.weight, None, policy)
        N, Tq, U = q.shape
        heads = lambda t: t.reshape(N, t.shape[1], self.num_heads, U // self.num_heads
                                    ).transpose(1, 2)
        q, k, v = heads(q), heads(k), heads(v)
        scores = torch.matmul(policy.cast(q), policy.cast(k).transpose(-1, -2)) / self.key_dim ** 0.5
        out = torch.matmul(policy.cast(torch.softmax(scores, dim=-1)), policy.cast(v))
        return out.transpose(1, 2).reshape(N, Tq, U)


class STL(nn.Module):
    def __init__(self, token_num: int = 10, token_embedding_size: int = 256,
                 num_heads: int = 8, query_dim: int = 128):
        super().__init__()
        key_dim = token_embedding_size // num_heads
        self.embed = nn.Parameter(torch.randn(token_num, key_dim) * 0.5)  # N(0, 0.5)
        self.attention = MultiHeadAttention(query_dim, key_dim, token_embedding_size, num_heads)

    def forward(self, enc, policy: Policy = F32):
        """enc (N, query_dim) -> (N, 1, token_embedding_size)."""
        keys = torch.tanh(self.embed)[None].expand(enc.shape[0], -1, -1)
        return self.attention(enc[:, None, :], keys, policy)


class GST(nn.Module):
    def __init__(self, n_mels: int = 80, token_embedding_size: int = 256,
                 ref_enc_filters: Sequence[int] = REF_ENC_FILTERS, gru_size: int = 128,
                 token_num: int = 10, num_heads: int = 8):
        super().__init__()
        self.n_mels = n_mels
        self.reference_encoder = ReferenceEncoder(ref_enc_filters, n_mels, gru_size)
        self.stl = STL(token_num, token_embedding_size, num_heads, gru_size)

    def forward(self, mels, lengths: Optional[torch.Tensor] = None, train: bool = False,
                policy: Policy = F32):
        """mels (N, T, M) -> the style embedding (N, 1, E) (JAX ``GST.apply``)."""
        return self.stl(self.reference_encoder(mels, lengths, train, policy), policy)

    def neutral(self, policy: Policy = F32):
        """The neutral style (1, 1, E): a zeros reference of NEUTRAL_FRAMES
        frames in eval mode. It depends on the weights alone, so a batch
        takes one row of it for every request."""
        ref = torch.zeros(1, NEUTRAL_FRAMES, self.n_mels, device=self.stl.embed.device)
        return self(ref, train=False, policy=policy)
