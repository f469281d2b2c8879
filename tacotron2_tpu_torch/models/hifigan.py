"""HiFi-GAN generator (vocoder).

Counterpart of ``tacotron2_tpu/models/hifigan.py``: conv_pre (num_mels ->
initial channels, k=7) -> per stage the MRF stage of ``ops/mrf.py``
([lrelu(0.1) -> ConvTranspose1d(ch -> ch/2, k_u, stride u)] -> mean of the
resblocks) -> leaky ReLU with torch's default slope 0.01 -> conv_post
(ch -> 1, k=7) -> tanh. Channels-last: mel (B, T, M) -> wav (B, T * prod(u)).
Weight norm is folded at load (``convert.load_hifigan_checkpoint``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tacotron2_tpu_torch.models import layers
from tacotron2_tpu_torch.models.layers import F32, Policy
from tacotron2_tpu_torch.models.resblock import ResBlock1, ResBlock2
from tacotron2_tpu_torch.ops.mrf import (conv_pre, mrf_stage, pack_conv, pack_upsample,
                                         plain_stage)

PACK_CALLS = [0]  # packings of a generator's weights for the kernels: once per model


@dataclasses.dataclass(frozen=True)
class HiFiGANConfig:
    """The checkpoint's JSON config; defaults are UNIVERSAL_V1."""

    resblock: str = "1"
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    num_mels: int = 80

    @staticmethod
    def from_dict(h: dict) -> "HiFiGANConfig":
        return HiFiGANConfig(
            resblock=str(h["resblock"]),
            upsample_rates=tuple(h["upsample_rates"]),
            upsample_kernel_sizes=tuple(h["upsample_kernel_sizes"]),
            upsample_initial_channel=int(h["upsample_initial_channel"]),
            resblock_kernel_sizes=tuple(h["resblock_kernel_sizes"]),
            resblock_dilation_sizes=tuple(tuple(d) for d in h["resblock_dilation_sizes"]),
            num_mels=int(h.get("num_mels", 80)),
        )

    @property
    def total_upsample(self) -> int:
        return math.prod(self.upsample_rates)


def stage_reach(resblock: str, kernels, dilations) -> int:
    """Largest one-sided reach, in samples, of any resblock chain of a
    stage (the JAX package's ``ops/mrf_pallas.py::stage_reach``)."""
    reach = 0
    for kr, dil in zip(kernels, dilations):
        r = 0
        for d in dil:
            r += d * (kr - 1) // 2
            if resblock == "1":
                r += (kr - 1) // 2
        reach = max(reach, r)
    return reach


class HiFiGAN(nn.Module):
    def __init__(self, config: HiFiGANConfig, policy: Policy = F32):
        super().__init__()
        c = config
        self.cfg = c
        self.policy = policy
        self.conv_pre = nn.Conv1d(c.num_mels, c.upsample_initial_channel, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        block = ResBlock1 if c.resblock == "1" else ResBlock2
        ch = c.upsample_initial_channel
        for u, k in zip(c.upsample_rates, c.upsample_kernel_sizes):
            self.ups.append(nn.ConvTranspose1d(ch, ch // 2, k, u, padding=(k - u) // 2))
            ch //= 2
            for kr, dil in zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes):
                self.resblocks.append(block(ch, kr, dil))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)
        self._packed = self._pre = None

    def mel_receptive_field(self) -> int:
        """One-sided receptive field of the generator in mel frames."""
        c = self.cfg
        rf = 3.0  # conv_pre, k=7
        cum = 1.0
        reach = stage_reach(c.resblock, c.resblock_kernel_sizes, c.resblock_dilation_sizes)
        for u, k in zip(c.upsample_rates, c.upsample_kernel_sizes):
            rf += -(-k // u) / cum
            cum *= u
            rf += reach / cum
        rf += 3.0 / cum  # conv_post
        return int(math.ceil(rf)) + 1

    def kernel_weights(self):
        """Per stage: (resblock weights, upsample weights) in the layouts of
        the kernel of the policy's compute type (bf16: ``csrc/mrf.cu``; f32,
        the default and the JAX package's: ``csrc/mrf_f32.cu``), tiled
        copies included; ``conv_pre``'s (``conv_pre_weights``) in the same
        packing. Packed at the first call and kept: a model moved to
        another device or given new weights packs again."""
        if self._packed is None:
            PACK_CALLS[0] += 1
            dt = self.policy.compute_dtype
            n = len(self.cfg.resblock_kernel_sizes)
            with torch.no_grad():
                self._packed = [
                    ([rb.kernel_weights(dt) for rb in self.resblocks[i * n:(i + 1) * n]],
                     pack_upsample(up, dt))
                    for i, up in enumerate(self.ups)
                ]
                self._pre = pack_conv(self.conv_pre, dt)
        return self._packed

    def conv_pre_weights(self):
        """``conv_pre`` in ``mrf_conv``'s layouts (``kernel_weights``)."""
        self.kernel_weights()
        return self._pre

    def _apply(self, fn, *args, **kwargs):  # .to(), .cuda(), .float(), ...
        self._packed = self._pre = None
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        self._packed = self._pre = None
        return super().load_state_dict(*args, **kwargs)

    @torch.no_grad()
    def apply(self, mel: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """mel (B, T, num_mels) -> wav (B, T * total_upsample). ``conv_pre``
        and ``conv_post`` round their f32 sums to the compute type before the
        bias, as JAX's ``conv1d_apply`` emits the policy's type (the identity
        under F32). The kernels' route, under either policy: ``conv_pre``
        (``mrf_conv``'s kernel) writes only stage 1's upsample operand, and
        each MRF stage (``mrf_stage``) passes its output to the next upsample
        as its operand alone (bf16, or f32 under F32); ``plain``: the
        plain reference route instead, ``conv_pre`` in PyTorch and each stage
        computed from its f32 input by ``plain_stage`` (on any device)."""
        pol = self.policy
        packed = self.kernel_weights()
        if plain:
            x = layers.conv1d(mel, self.conv_pre.weight, self.conv_pre.bias, pol, padding=3,
                              round_out=True)
            for rbs, ups in packed:
                x = plain_stage(x.contiguous(), rbs, ups)
        else:
            a = conv_pre(mel.to(pol.compute_dtype).contiguous(), self.conv_pre_weights())
            for i, (rbs, ups) in enumerate(packed):
                if i < len(packed) - 1:
                    a = mrf_stage(None, rbs, ups, a, want_operand=True)
                else:
                    x = mrf_stage(None, rbs, ups, a)
        x = F.leaky_relu(x, 0.01)
        x = layers.conv1d(x, self.conv_post.weight, self.conv_post.bias, pol, padding=3,
                          round_out=True)
        return torch.tanh(x)[..., 0]
