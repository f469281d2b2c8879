"""HiFi-GAN generator (vocoder).

Counterpart of ``tacotron2_tpu/models/hifigan.py``: conv_pre (num_mels ->
initial channels, k=7) -> per stage the MRF stage of ``ops/mrf.py``
([lrelu(0.1) -> ConvTranspose1d(ch -> ch/2, k_u, stride u)] -> mean of the
resblocks) -> leaky ReLU with torch's default slope 0.01 -> conv_post
(ch -> 1, k=7) -> tanh. Channels-last: mel (B, T, M) -> wav (B, T * prod(u)).
Weight norm is folded at load (``convert.load_hifigan_checkpoint``).

Routes, as the JAX package's ``HiFiGAN.apply`` takes them: with every
resblock kernel size odd, each stage on K2 (``ops/mrf.py``: the wide or the
narrow kernel by its shape; an upsample that does not fold on stock ops,
JAX's XLA transposed conv); with any even one, JAX runs its whole generator
on XLA with ``get_padding``'s symmetric padding, and so does the port, on
stock ops (``apply_stock``, counted in ``mrf.STOCK_ROUTES``). A conv whose
symmetric padding changes its length (d (k - 1) odd: any ResBlock1 of an
even k, an odd dilation of an even k) cannot add its residual, in JAX's
generator too: such a config raises ValueError here, at construction.
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
from tacotron2_tpu_torch.ops import build
from tacotron2_tpu_torch.ops.mrf import (LRELU_SLOPE, STOCK_ROUTES, conv_pre, mrf_stage,
                                         pack_conv, pack_upsample, plain_stage)

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


def check_lengths(c: HiFiGANConfig) -> None:
    """Raise ValueError where a resblock conv's symmetric padding
    (``get_padding``) changes its length, d (k - 1) odd: its residual add
    does not fit, as it does not in JAX's ``_resblock`` either."""
    for kr, dil in zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes):
        for d in (*dil, *((1,) if c.resblock == "1" else ())):
            if d * (kr - 1) % 2:
                raise ValueError(
                    f"HiFi-GAN resblock {c.resblock}: a conv of kernel {kr} and dilation {d} "
                    f"takes symmetric padding {(kr * d - d) // 2} and returns one sample fewer "
                    "than its input, so its residual add does not fit (the JAX package's "
                    "generator fails there too)")


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
        check_lengths(c)
        self.cfg = c
        self.policy = policy
        # JAX's ``odd``: the stages on the kernels; else the whole generator on stock ops
        self.odd = all(k % 2 == 1 for k in c.resblock_kernel_sizes)
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
        computed from its f32 input by ``plain_stage`` (on any device). A
        generator with an even resblock kernel size takes ``apply_stock``
        on either."""
        if not self.odd:
            return self.apply_stock(mel)
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
        return self._post(x)

    def _post(self, x):
        x = F.leaky_relu(x, 0.01)
        x = layers.conv1d(x, self.conv_post.weight, self.conv_post.bias, self.policy, padding=3,
                          round_out=True)
        return torch.tanh(x)[..., 0]

    @torch.no_grad()
    def apply_stock(self, mel: torch.Tensor) -> torch.Tensor:
        """JAX's XLA generator (its ``apply`` where a resblock kernel size is
        even) on stock ops, counted as ``generator_stock``: every conv and
        transposed conv with its sum rounded to the compute type before the
        bias, resblocks by ``ResBlock*.stock``, each stage the sum of its
        resblocks over their number."""
        build.count(STOCK_ROUTES, "generator_stock")
        c, pol = self.cfg, self.policy
        n = len(c.resblock_kernel_sizes)
        x = layers.conv1d(mel, self.conv_pre.weight, self.conv_pre.bias, pol, padding=3,
                          round_out=True)
        for i, (up, u, k) in enumerate(zip(self.ups, c.upsample_rates, c.upsample_kernel_sizes)):
            x = layers.conv_transpose1d(F.leaky_relu(x, LRELU_SLOPE), up.weight, up.bias, u,
                                        (k - u) // 2, pol, round_out=True)
            acc = None
            for rb in self.resblocks[i * n:(i + 1) * n]:
                y = rb.stock(x, pol)
                acc = y if acc is None else acc + y
            x = acc / n
        return self._post(x)
