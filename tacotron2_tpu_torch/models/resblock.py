"""HiFi-GAN residual blocks (parameter holders with the reference's names).

Counterpart of the resblocks in ``tacotron2_tpu/models/hifigan.py`` and
``tacotron2_tpu/models/resblock.py``:

- ResBlock1: per dilation d, [lrelu -> conv(d) -> lrelu -> conv(1) -> +x];
- ResBlock2: per dilation d, [lrelu -> conv(d) -> +x].

The math runs in ``ops/mrf.py``; ``kernel_weights`` hands it the convs in
the kernels' layout. ``stock`` is JAX's ``HiFiGAN._resblock`` on stock ops
(its XLA route, taken where a resblock kernel size is even): each conv with
``get_padding``'s symmetric padding, its sum rounded to the policy's
compute type before the bias.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tacotron2_tpu_torch.models import layers
from tacotron2_tpu_torch.models.layers import Policy
from tacotron2_tpu_torch.ops.mrf import LRELU_SLOPE, ResBlockWeights, pack_conv


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def _conv(conv: nn.Conv1d, x, policy: Policy):
    """lrelu -> ``conv`` at its own symmetric padding and dilation, the sum
    rounded to the compute type before the bias (JAX ``conv1d_apply``)."""
    return layers.conv1d(torch.nn.functional.leaky_relu(x, LRELU_SLOPE), conv.weight, conv.bias,
                         policy, padding=conv.padding[0], dilation=conv.dilation[0],
                         round_out=True)


class ResBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int, dilation: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=get_padding(kernel_size, d)) for d in dilation)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, padding=get_padding(kernel_size, 1))
            for _ in dilation)

    def kernel_weights(self, dtype: torch.dtype) -> ResBlockWeights:
        return [(pack_conv(c1, dtype), pack_conv(c2, dtype))
                for c1, c2 in zip(self.convs1, self.convs2)]

    def stock(self, x, policy: Policy):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = _conv(c2, _conv(c1, x, policy), policy) + x
        return x


class ResBlock2(nn.Module):
    def __init__(self, channels: int, kernel_size: int, dilation: Sequence[int] = (1, 3)):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=get_padding(kernel_size, d)) for d in dilation)

    def kernel_weights(self, dtype: torch.dtype) -> ResBlockWeights:
        return [(pack_conv(c, dtype), None) for c in self.convs]

    def stock(self, x, policy: Policy):
        for c in self.convs:
            x = _conv(c, x, policy) + x
        return x
