"""HiFi-GAN MRF stage: kernel K2 (a dilated-conv kernel and a
transposed-conv kernel, ``csrc/mrf.cu``) and its plain version.

Replaces the TPU kernels of ``tacotron2_tpu/ops/mrf_pallas.py``:
``_make_stage_kernel`` (the MRF alone, via ``_mrf_stage_call``),
``_make_stage_kernel_ups`` (with the u=2 upsample fused in front, via
``_mrf_stage_ups_call``) and ``_make_stage_kernel_ups_expand`` (the u=8
upsample, via ``_mrf_stage_ups_expand_call``). The function of all three is
``[lrelu -> ConvTranspose1d(u, k, pad (k-u)/2)] -> mean over resblocks of
[lrelu -> dilated conv -> (lrelu -> conv) -> + residual]`` in channels-last
(B, T, C). The port computes that function; the TPU's phase folding, tap
plans and halo tiles are not carried over.

What bounds it on this card. The function -- a whole stage, reading its
input once and writing its output once -- is bound by operations: a
UNIVERSAL_V1 vocode does 18 convs of 2*k*C*C flops per output sample in
each of its four stages, about 0.6 GFLOP per mel frame (~0.6 us/frame at
989 TFLOP/s bf16). This design runs one launch per conv, so every conv
also reads and writes its f32 activations in device memory: that traffic
is the cost of the design, not part of the bound (``chip_smoke.py``
reports both). A stage-fused kernel that keeps the activations on chip is
the redesign that removes it.

The design: ``mrf_conv`` is an implicit GEMM on the tensor cores
(``mma.sync`` m16n8k16, bf16 operands, f32 accumulation) over a 64-row x
32-channel output tile; the input tile with its dilated halo is staged in
shared memory once per 32-channel slice and reused by every tap; the leaky
ReLU is applied as the tile is loaded, and bias, residual and the 1/n-scaled
sum into the stage mean are applied in the epilogue, so no separate
elementwise pass goes through device memory. ``conv_transpose`` runs on the
same kernel: a transposed conv of stride u is u plain convs of k/u taps, one
per output phase, written with stride u (``make_upsample`` packs the taps).

Each wrapper runs its plain PyTorch version for CPU tensors only; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from tacotron2_tpu_torch.models import layers
from tacotron2_tpu_torch.ops import build

LRELU_SLOPE = 0.1
LAUNCHES = {"mrf_conv": 0, "conv_transpose": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class ConvWeights(NamedTuple):
    w: torch.Tensor  # (K, Co, Ci) tap-major
    b: torch.Tensor  # (Co,) f32
    dilation: int


class UpsampleWeights(NamedTuple):
    w: torch.Tensor  # (K, Ci, Co) tap-major
    b: torch.Tensor  # (Co,) f32
    stride: int
    padding: int
    w_phase: torch.Tensor  # (stride, K / stride, Co, Ci): the kernel's per-phase taps


# one resblock = a list of (conv, second conv or None) per dilation:
# ResBlock1 pairs [dilated conv, conv], ResBlock2 has only the dilated conv
ResBlockWeights = List[Tuple[ConvWeights, Optional[ConvWeights]]]


def pack_conv(conv, dtype: torch.dtype) -> ConvWeights:
    """nn.Conv1d (torch (Co, Ci, K)) -> the kernel's tap-major layout."""
    return ConvWeights(conv.weight.detach().permute(2, 0, 1).to(dtype).contiguous(),
                       conv.bias.detach().float().contiguous(), int(conv.dilation[0]))


def make_upsample(w: torch.Tensor, b: torch.Tensor, stride: int,
                  padding: int) -> UpsampleWeights:
    """Transposed-conv weights from the tap-major (K, Ci, Co) layout.

    Output sample t = q * stride + r is reached by the taps m = m0 + i *
    stride, m0 = (r + padding) % stride, from input q + (r + padding - m) /
    stride; so phase r is a plain conv of K / stride taps, stored for the
    kernel in order of increasing input row: w_phase[r, j] = w[m0 + (K /
    stride - 1 - j) * stride]^T."""
    K = w.shape[0]
    if K % stride:
        raise ValueError(f"transposed conv needs kernel % stride == 0, got {K}, {stride}")
    kt = K // stride
    taps = [[(r + padding) % stride + (kt - 1 - j) * stride for j in range(kt)]
            for r in range(stride)]
    w_phase = w[torch.tensor(taps)].permute(0, 1, 3, 2).contiguous()  # (u, kt, Co, Ci)
    return UpsampleWeights(w.contiguous(), b.float().contiguous(), stride, padding, w_phase)


def pack_upsample(convt, dtype: torch.dtype) -> UpsampleWeights:
    """nn.ConvTranspose1d (torch (Ci, Co, K)) -> the kernel's layouts."""
    return make_upsample(convt.weight.detach().permute(2, 0, 1).to(dtype),
                         convt.bias.detach(), int(convt.stride[0]), int(convt.padding[0]))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _lrelu_rounded(x, w):
    """The kernels' prologue: leaky ReLU, then the operand rounded to the
    weights' type (bf16 on the card)."""
    return F.leaky_relu(x, LRELU_SLOPE).to(w.dtype).float()


def mrf_conv_plain(x, cw: ConvWeights, res=None, acc=None, acc_scale: float = 0.0):
    """y = conv(lrelu(x)) + b (+ res), SAME padding with dilation; returns
    (y, acc + acc_scale * y) -- the second is None when acc_scale == 0."""
    y = layers.conv1d(_lrelu_rounded(x, cw.w), cw.w.float().permute(1, 2, 0), cw.b,
                      padding="SAME", dilation=cw.dilation)
    if res is not None:
        y = y + res
    if acc_scale == 0.0:
        return y, None
    return y, (acc_scale * y if acc is None else acc + acc_scale * y)


def conv_transpose_plain(x, uw: UpsampleWeights):
    """ConvTranspose1d(lrelu(x)) over channels-last x."""
    return layers.conv_transpose1d(_lrelu_rounded(x, uw.w), uw.w.float().permute(1, 2, 0),
                                   uw.b, uw.stride, uw.padding)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

_LIB = None
P = ctypes.c_void_p
I = ctypes.c_int


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("mrf")
        lib.t2_mrf_conv.argtypes = [P] * 7 + [I] * 7 + [ctypes.c_float, P]
        lib.t2_conv_transpose.argtypes = [P] * 4 + [I] * 8 + [P]
        lib.t2_mrf_conv.restype = I
        lib.t2_conv_transpose.restype = I
        _LIB = lib
    return _LIB


def mrf_conv(x, cw: ConvWeights, res=None, acc=None, acc_scale: float = 0.0):
    """Dilated SAME conv with the leaky-ReLU prologue and the bias, residual
    and stage-mean epilogue; see ``mrf_conv_plain``."""
    if x.device.type == "cpu":
        return mrf_conv_plain(x, cw, res, acc, acc_scale)
    B, T, Ci = x.shape
    K, Co, _ = cw.w.shape
    build.require(x, torch.float32, (B, T, Ci), "x")
    build.require(cw.w, torch.bfloat16, (K, Co, Ci), "w")
    build.require(cw.b, torch.float32, (Co,), "b")
    if res is not None:
        build.require(res, torch.float32, (B, T, Co), "res")
    if acc is not None:
        build.require(acc, torch.float32, (B, T, Co), "acc")
    y = torch.empty(B, T, Co, device=x.device)
    acc_out = torch.empty(B, T, Co, device=x.device) if acc_scale != 0.0 else None
    mode = 0 if acc_out is None else (1 if acc is None else 2)
    build.count(LAUNCHES, "mrf_conv")
    build.check(_lib().t2_mrf_conv(
        x.data_ptr(), cw.w.data_ptr(), cw.b.data_ptr(),
        0 if res is None else res.data_ptr(),
        0 if acc is None else acc.data_ptr(),
        0 if acc_out is None else acc_out.data_ptr(), y.data_ptr(),
        B, T, Ci, Co, K, cw.dilation, mode, ctypes.c_float(acc_scale),
        torch.cuda.current_stream().cuda_stream), "mrf_conv")
    return y, acc_out


def conv_transpose(x, uw: UpsampleWeights):
    """ConvTranspose1d(lrelu(x)); see ``conv_transpose_plain``."""
    if x.device.type == "cpu":
        return conv_transpose_plain(x, uw)
    B, Tin, Ci = x.shape
    K, _, Co = uw.w.shape
    u = uw.stride
    build.require(x, torch.float32, (B, Tin, Ci), "x")
    build.require(uw.w_phase, torch.bfloat16, (u, K // u, Co, Ci), "w_phase")
    build.require(uw.b, torch.float32, (Co,), "b")
    Tout = (Tin - 1) * uw.stride - 2 * uw.padding + K
    y = torch.empty(B, Tout, Co, device=x.device)
    build.count(LAUNCHES, "conv_transpose")
    build.check(_lib().t2_conv_transpose(
        x.data_ptr(), uw.w_phase.data_ptr(), uw.b.data_ptr(), y.data_ptr(),
        B, Tin, Tout, Ci, Co, K, uw.stride, uw.padding,
        torch.cuda.current_stream().cuda_stream), "conv_transpose")
    return y


# ---------------------------------------------------------------------------
# the stage
# ---------------------------------------------------------------------------


def run_stage(x, resblocks: Sequence[ResBlockWeights],
              upsample: Optional[UpsampleWeights], conv, conv_t):
    """The stage over the given conv callables (the wrappers, or timing
    hooks that call them)."""
    if upsample is not None:
        x = conv_t(x, upsample)
    scale = 1.0 / len(resblocks)
    acc = None
    for rb in resblocks:
        z = x
        for j, (c1, c2) in enumerate(rb):
            last = j == len(rb) - 1
            s = scale if last else 0.0
            if c2 is None:
                z, a = conv(z, c1, res=z, acc=acc, acc_scale=s)
            else:
                t, _ = conv(z, c1)
                z, a = conv(t, c2, res=z, acc=acc, acc_scale=s)
            if last:
                acc = a
    return acc


def mrf_stage(x, resblocks: Sequence[ResBlockWeights],
              upsample: Optional[UpsampleWeights] = None):
    """``[lrelu -> ConvTranspose1d] -> mean over resblocks`` on (B, T, C)."""
    return run_stage(x, resblocks, upsample, mrf_conv, conv_transpose)


def plain_stage(x, resblocks: Sequence[ResBlockWeights],
                upsample: Optional[UpsampleWeights] = None):
    """``mrf_stage`` through the plain versions, on any device."""
    return run_stage(x, resblocks, upsample, mrf_conv_plain, conv_transpose_plain)
