"""HiFi-GAN MRF stage: kernel K2 (a dilated-conv kernel, which also runs
the upsample and the vocoder's ``conv_pre``: ``csrc/mrf.cu`` on bf16
operands, ``csrc/mrf_f32.cu`` on f32 ones, and ``csrc/mrf_narrow.cu`` at
every other shape in either type) and its plain version.

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
989 TFLOP/s bf16; at f32 ~9 us/frame on the CUDA cores' 67 TFLOP/s, or
~3.6 us/frame as a three-pass TF32 split at 495 TFLOP/s). This design runs
one launch per conv, so every conv also reads and writes its activations
in device memory: that traffic is
the cost of the design, not part of the bound (``chip_smoke.py`` reports
both). A stage-fused kernel that keeps the activations on chip is the
redesign that removes it.

The design (bf16; the f32 mode below keeps its dataflow). A conv's input
reaches it only through its prologue ``bf16(lrelu(x))``, so every producer
writes that bf16 operand for the next conv (``act``) and f32 only where
f32 is read: the residual stream ``z`` (the residual add and the stage
mean) and the stage mean itself. The intermediate of a ResBlock1 pair is
written as its operand alone, and the last conv of a resblock writes only
the stage mean. This is exact: the
operand is what the next conv's prologue would compute (``plain_stage``
and ``side_output_stage`` agree bit for bit).

``mrf_conv`` is an implicit GEMM on Hopper's warpgroup products (``wgmma``
m64nNk16, bf16 operands, f32 sums; N = 128, 64 or 32 output channels by
Co, or 64 of 128 where the grid would leave SMs idle) over blocks of 128 or
256 samples: the operand's slice of 64 input
channels with its dilated halo comes by TMA from a 3-D (B, T, C) tensor
map (rows outside the batch row read zero) into the no-swizzle core-matrix
layout, where every tap's descriptor starts at its own row; the weights of
each (slice, tap) come by bulk copy through a 4-stage mbarrier ring from a
copy tiled once at load (``tile_conv``). Bias, residual, the next conv's
operand and the 1/n-scaled sum into the stage mean are the epilogue. Each
output's sum runs in one order whatever the batch, length or tile.
``mrf_pair`` runs a ResBlock1 pair (C up to 128) as one launch of the same
kernel: the first conv over the block's rows and the second conv's halo,
its operand kept in shared memory, then the second conv; its outputs equal
the two launches' bit for bit. ``mrf_stage`` fuses every pair it takes:
45 launches a UNIVERSAL_V1 vocode instead of 72.

``conv_transpose`` runs on the same kernel. A transposed conv of stride u,
kernel k and padding (k - u) / 2 has Tout = u Tin, and its output sample
q u + r reads input rows q - 1, q, q + 1 at most (every HiFi-GAN config
has k = 2u), so in channels-last it is the same memory as a SAME 3-tap
conv from Ci to u Co channels, (B, Tin, u Co) (``fold_upsample``; the tap
a phase does not reach is zero: 1.5x the transposed conv's flops, as the
TPU kernel's u-folded layout, ``mrf_pallas.py:319``). It reads the bf16
operand of its input like every conv: stage 1's from ``conv_pre``, stages
2-4's from the previous stage's last conv, whose epilogue writes the stage
mean as that operand (``acc_act``) instead of f32, which nothing else reads.

``conv_pre`` (num_mels -> initial channels, k = 7) runs on the same kernel
too, from the bf16 mel (a cast, no lrelu): its epilogue rounds the f32 sum
to bf16 before the bias, as JAX's ``conv1d_apply`` emits a bf16 policy's
type, and writes only ``bf16(lrelu(v))``, stage 1's upsample operand, so
the vocoder writes and reads no f32 activation before stage 1. Its 80 mel
channels are not a multiple of the staged slice: the last slice reaches
past them, where the tensor map reads zeros and the tiled copy is zero.

The f32 mode (``csrc/mrf_f32.cu``) is the TPU kernels' ``bf16=False``,
the JAX package's vocoder precision (its HiFi-GAN's default policy is
F32): the same entries on f32 operands and weights, f32 products and f32
sums, the same implicit GEMM on the tensor cores as a three-pass TF32
split. Each f32 value x is split into ``hi = tf32_rna(x)`` and ``lo = x -
hi`` (``tf32_split``: exact, hi + lo == x), and each product is ``a_hi
w_hi + a_hi w_lo + a_lo w_hi`` in f32 sums (``wgmma`` m64nNk8 tf32; the
``lo lo`` term, ~2^-22 of the product, is left out). The weights are split
once at load: an f32 ``ConvWeights`` carries the hi and lo planes of each
(N tile, 16-channel slice, tap) side by side (``tile_conv``); the kernel
splits the operand in shared memory once per staged slice. Its launches
count in ``F32_LAUNCHES`` as ``<entry>_f32``.

The other shapes (``csrc/mrf_narrow.cu``): the wide kernels take Co a
multiple of 32 (their N tiles) and Ci a multiple of 8 (``wide``); the TPU
stage kernel takes any C (its phase fold s = 128 / C where 128 % C == 0,
else none, ``mrf_pallas.py:440``). Every conv of another shape -- HiFi-GAN
V2's stages 3 and 4 at 16 and 8 channels and its last upsample to 2 x 8,
stages at 4, 2 or 1 channels, widths off 32 (200, 100, 50, 25), a
``conv_pre`` from a num_mels off 8 -- launches the narrow kernel instead, in
the weights' type, on one of three routes (``narrow_plan``), the first two on
the tensor cores (``narrow_mma``), bf16 or f32 as the three-pass TF32 split:
at Ci and Co in ``PAIR_C`` (V2's shapes, and the fused pair) the small route
(``narrow_small``: ``mma.sync`` in blocks of 128 outputs, the whole weight
copy resident, from a copy in the B fragments' order, ``small_layout``); at
every other shape of Co >= 8 ``wgmma`` with the operand's fragments in
registers, from a copy (K, planes, Co8, Ci_pad) padded with zeros to n8
tiles and the k tile (``mma_pads``); below 8 output channels the CUDA cores
(FFMA, f32 sums in one fixed order per output) from a copy (Ci, K, Co)
(``tile_conv``). Its launches count as ``narrow_conv``, ``narrow_pair`` (C
in ``PAIR_C`` only) and ``narrow_transpose`` (``launch_key``; a
``conv_pre`` of such a shape as ``narrow_conv``), ``_f32`` in
``F32_LAUNCHES``.

JAX's XLA routes. Where the JAX package runs XLA instead of a Pallas
kernel, the port runs stock PyTorch ops, counted in ``STOCK_ROUTES``: an
upsample that does not fold into a SAME conv (``fold_reach`` None: JAX's
``conv_transpose1d_apply`` before its stage kernel) as
``conv_transpose_stock``; a generator with an even resblock kernel size
(``models/hifigan.py``) as ``generator_stock``. Where JAX runs the
upsample on XLA although the port folds it (``jax_fuses_upsample`` false),
JAX's bf16 conv emits bf16 before the bias, and so does the port's folded
conv (``UpsampleWeights.round_sum``).

Each wrapper runs its plain PyTorch version for CPU tensors only; a CUDA
tensor launches the kernel of its shape's route or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from tacotron2_tpu_torch.models import layers
from tacotron2_tpu_torch.ops import build

LRELU_SLOPE = 0.1
# the narrow kernel's counter of each wrapper (``csrc/mrf_narrow.cu``)
NARROW_ENTRY = {"mrf_conv": "narrow_conv", "mrf_pair": "narrow_pair",
                "conv_transpose": "narrow_transpose", "conv_pre": "narrow_conv"}
LAUNCHES = {k: 0 for k in ("mrf_conv", "mrf_pair", "conv_transpose", "conv_pre",
                           "narrow_conv", "narrow_pair", "narrow_transpose")}
# the f32 kernels' (``csrc/mrf_f32.cu``, the narrow kernel's f32 entries),
# beside the bf16 ones
F32_LAUNCHES = {k + "_f32": 0 for k in LAUNCHES}
# JAX's XLA routes, run on stock ops (no kernel): an upsample that does not
# fold, and a whole generator with an even resblock kernel size
STOCK_ROUTES = {"conv_transpose_stock": 0, "generator_stock": 0}
PAIR_C = (8, 16)  # the channels (C = Ci = Co) the narrow kernel's fused pair takes


def reset_launches() -> None:
    for counts in (LAUNCHES, F32_LAUNCHES, STOCK_ROUTES):
        for k in counts:
            counts[k] = 0


class ConvWeights(NamedTuple):
    w: torch.Tensor  # (K, Co, Ci) tap-major
    b: torch.Tensor  # (Co,) f32
    dilation: int
    wt: Optional[torch.Tensor] = None  # the kernel's tiled copy of w (tile_conv)


class UpsampleWeights(NamedTuple):
    w: torch.Tensor  # (K, Ci, Co) tap-major
    b: torch.Tensor  # (Co,) f32
    stride: int
    padding: int
    # the same map as a SAME conv to stride * Co channels, the kernel's
    # (fold_upsample); None where the shape does not fold (JAX's XLA route)
    folded: Optional[ConvWeights] = None
    # the sum rounded to the weights' type before the bias: a bf16 upsample
    # that the JAX package runs on XLA (``jax_fuses_upsample`` false)
    round_sum: bool = False


# one resblock = a list of (conv, second conv or None) per dilation:
# ResBlock1 pairs [dilated conv, conv], ResBlock2 has only the dilated conv
ResBlockWeights = List[Tuple[ConvWeights, Optional[ConvWeights]]]


F32_KC = 16  # input channels a staged slice of the f32 kernel (``kKC``)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 ``x`` -> (hi, lo): ``hi`` is x rounded to TF32 (10 mantissa bits,
    to nearest, ties away from zero: ``cvt.rna.tf32.f32``), its low 13 bits
    zero; ``lo = x - hi``, exact in f32, so hi + lo == x bit for bit. The
    f32 kernel's three passes take ``a_hi w_hi + a_hi w_lo + a_lo w_hi``."""
    i = x.contiguous().view(torch.int32)
    hi = ((i + 0x1000) & -0x2000).view(torch.float32)
    return hi, x - hi


def conv_tiles(Co: int, Ci: int, dtype: torch.dtype = torch.bfloat16) -> Tuple[int, int]:
    """(NI, KC) of the weight copy of ``mrf_conv``'s kernel for weights of
    ``dtype``: output channels per N tile (128, 64 or 32 by Co) and input
    channels per staged slice (the last slice reaches past Ci where KC does
    not divide it, the copy zero there). A block's wgmma takes the N tile
    or, where the grid is small, a part of it; slices of 64 or 32 (bf16),
    ``F32_KC`` (f32). Both wide kernels take Co a multiple of 32 and Ci a
    multiple of 8 (``wide``: the operand's rows whole 16-byte pieces, as TMA
    reads them); any other shape runs on the narrow kernel, whose copies
    have no such tiles (``tile_conv``; its blocks and steps are
    ``csrc/mrf_narrow.cu::narrow_plan``'s), and raises here."""
    if not wide(Co, Ci):
        raise ValueError(f"the wide kernels take Co a multiple of 32 and Ci of 8, got Co={Co}, "
                         f"Ci={Ci} (the narrow kernel's copies have no such tiles)")
    NI = 128 if Co % 128 == 0 else 64 if Co % 64 == 0 else 32
    if dtype == torch.float32:
        return NI, F32_KC
    return NI, (64 if Ci % 64 == 0 else 32)


def wide(Co: int, Ci: int) -> bool:
    """Whether convs from ``Ci`` to ``Co`` channels run on the wide kernels
    (``csrc/mrf.cu``, ``csrc/mrf_f32.cu``): Co a multiple of 32 (the rule in
    their ``conv_plan``), Ci a multiple of 8."""
    return Co % 32 == 0 and Ci % 8 == 0 and Ci >= 8


def narrow_mma(Co: int, Ci: int) -> bool:
    """Whether convs from ``Ci`` to ``Co`` channels run on the narrow
    kernel's tensor cores: not ``wide`` and Co >= 8 (``narrow_small``'s
    route, else ``csrc/mrf_narrow.cu::narrow_mma_kernel``). Below 8 output
    channels the narrow kernel runs on the CUDA cores."""
    return not wide(Co, Ci) and Co >= 8


def narrow_small(Co: int, Ci: int) -> bool:
    """Whether convs from ``Ci`` to ``Co`` channels run on the narrow
    kernel's small route (``csrc/mrf_narrow.cu::narrow_small_kernel``, the
    fused pair's): Ci and Co both in ``PAIR_C``."""
    return Co in PAIR_C and Ci in PAIR_C


def small_layout(Co: int, Ci: int, dtype: torch.dtype = torch.bfloat16) -> Tuple[int, ...]:
    """The small route's copy's shape past its taps: (n8 tiles, k steps, 32
    lanes, elements a lane), a (tap, n8 tile, k step)'s B fragments of
    ``mma.sync`` side by side. bf16: one k step of Ci (m16n8k16 at 16,
    m16n8k8 at 8), Ci / 4 elements a lane; f32: Ci / 8 steps of m16n8k8
    TF32, a lane's two hi and two lo elements."""
    if dtype == torch.float32:
        return Co // 8, Ci // 8, 32, 4
    return Co // 8, 1, 32, Ci // 4


def mma_pads(Co: int, Ci: int, dtype: torch.dtype = torch.bfloat16) -> Tuple[int, int]:
    """(Co8, Ci_pad) of the tensor-core route's copy: Co padded to n8
    tiles, Ci to the k tile of ``dtype``'s product (16 for bf16's m16n8k16,
    8 for TF32's m16n8k8)."""
    kt = 8 if dtype == torch.float32 else 16
    return -(-Co // 8) * 8, -(-Ci // kt) * kt


def launch_key(name: str, cw: "ConvWeights") -> str:
    """The counter that a launch of wrapper ``name`` (``mrf_conv``,
    ``mrf_pair``, ``conv_transpose``, ``conv_pre``) on the (folded) weights
    ``cw`` adds one to: the narrow kernel's entry at a shape the wide
    kernels do not take, ``_f32`` for f32 weights."""
    _, Co, Ci = cw.w.shape
    key = name if wide(Co, Ci) else NARROW_ENTRY[name]
    return key + ("_f32" if cw.w.dtype == torch.float32 else "")


def slices(Ci: int, KC: int) -> int:
    """Staged slices of KC input channels over Ci, the last maybe partial."""
    return -(-Ci // KC)


def tile_offset(j, co, ci, K: int, Co: int, Ci: int, dtype: torch.dtype = torch.bfloat16,
                plane: int = 0):
    """Element offset of w[j, co, ci] in ``tile_conv``'s copy of weights of
    ``dtype``, as the kernel addresses it (ints, or integer tensors that
    broadcast). The wide kernels': N tile co // NI, slice ci // KC, tap j,
    then the tile in the no-swizzle core-matrix layout of a K-major wgmma
    operand, 16-byte groups of input channels of rows of NI: bf16 [KC /
    8][NI][8]; f32 the ``plane`` (0 hi, 1 lo: ``tf32_split``) of two such
    tiles side by side, [2][KC / 4][NI][4]. The narrow kernel's tensor-core
    routes: the small route's (``narrow_small``) in the B fragments' order of
    ``mma.sync``, (K, n8 tiles, k steps, 32 lanes, elements) (``small_layout``):
    w[j, co, ci] is element e of lane 4 (co % 8) + t of (j, co // 8, k step),
    bf16 t = (ci % 8) // 2, e = 2 (ci // 8) + ci % 2; f32 (k steps of 8) t =
    ci % 4, e = 2 plane + (ci % 8) // 4; ``narrow_mma_kernel``'s (K,
    planes, Co8, Ci_pad), a tap's plane one [output channel][input channel]
    matrix whose rows a weight step copies 16 bytes at a time (planes 2 in
    f32, hi and lo, else 1; ``mma_pads``). Its CUDA cores' route (no planes):
    (Ci, K, Co), a slice's channels one run, each (channel, tap) its Co
    weights side by side."""
    if narrow_small(Co, Ci):
        nt, ks, _, E = small_layout(Co, Ci, dtype)
        if dtype == torch.float32:
            s, t, e = ci // 8, ci % 4, 2 * plane + (ci % 8) // 4
        else:
            s, t, e = 0, (ci % 8) // 2, 2 * (ci // 8) + ci % 2
        return (((j * nt + co // 8) * ks + s) * 32 + 4 * (co % 8) + t) * E + e
    if narrow_mma(Co, Ci):
        co8, cp = mma_pads(Co, Ci, dtype)
        planes = 2 if dtype == torch.float32 else 1
        return ((j * planes + plane) * co8 + co) * cp + ci
    if not wide(Co, Ci):
        return (ci * K + j) * Co + co
    NI, KC = conv_tiles(Co, Ci, dtype)
    tile = ((co // NI) * slices(Ci, KC) + ci // KC) * K + j
    if dtype == torch.float32:
        return ((tile * 2 + plane) * NI * KC + ((ci % KC) // 4) * NI * 4 + (co % NI) * 4
                + ci % 4)
    return tile * NI * KC + ((ci % KC) // 8) * NI * 8 + (co % NI) * 8 + ci % 8


def tile_conv(w: torch.Tensor) -> torch.Tensor:
    """(K, Co, Ci) tap-major weights -> the tiled copy of the kernel of
    their type and shape (``tile_offset``). The wide kernels': one
    contiguous tile per (N tile, slice, tap), zero past Ci in the last
    slice; shape (Co / NI, ceil(Ci / KC), K, KC / 8, NI, 8) for bf16 and,
    split once here into hi and lo planes, (Co / NI, ceil(Ci / KC), K, 2,
    KC / 4, NI, 4) for f32. A ring stage's consecutive taps are one run. The
    narrow kernel's small route: its B fragments, (K, Co / 8, k steps, 32,
    elements), every element a weight (f32 its hi and lo), no pad; its
    ``narrow_mma_kernel``: (K, 1, Co8, Ci_pad) for bf16, (K, 2, Co8,
    Ci_pad) for f32 (hi, lo), zero past Co and Ci. Its CUDA cores': (Ci, K,
    Co), in the weights' type."""
    K, Co, Ci = w.shape
    if narrow_small(Co, Ci):
        shape = (K, *small_layout(Co, Ci, w.dtype))
        j, co, ci = (torch.arange(n, device=w.device).view(v) for n, v in (
            (K, (K, 1, 1)), (Co, (1, Co, 1)), (Ci, (1, 1, Ci))))
        out = w.new_zeros(math.prod(shape))
        for plane, x in enumerate(tf32_split(w) if w.dtype == torch.float32 else (w,)):
            out[tile_offset(j, co, ci, K, Co, Ci, w.dtype, plane).reshape(-1)] = x.reshape(-1)
        return out.view(shape)
    if narrow_mma(Co, Ci):
        co8, cp = mma_pads(Co, Ci, w.dtype)
        w = F.pad(w, (0, cp - Ci, 0, co8 - Co))
        if w.dtype == torch.float32:
            return torch.stack(tf32_split(w), 1).contiguous()
        return w.unsqueeze(1).contiguous()
    if not wide(Co, Ci):
        return w.permute(2, 0, 1).contiguous()
    NI, KC = conv_tiles(Co, Ci, w.dtype)
    ns = slices(Ci, KC)
    w = F.pad(w, (0, ns * KC - Ci))
    if w.dtype == torch.float32:
        t = torch.stack(tf32_split(w), 1)  # (j, plane, co, ci)
        t = t.reshape(K, 2, Co // NI, NI, ns, KC // 4, 4)  # (j, p, nt, co, s, g, e)
        return t.permute(2, 4, 0, 1, 5, 3, 6).contiguous()
    t = w.reshape(K, Co // NI, NI, ns, KC // 8, 8)  # (j, nt, co, s, g, e)
    return t.permute(1, 3, 0, 4, 2, 5).contiguous()


def read_tiled(wt: torch.Tensor, K: int, Co: int, Ci: int,
               plane: Optional[int] = None) -> torch.Tensor:
    """The (K, Co, Ci) weights back from a tiled copy, every element read at
    its ``tile_offset`` for the copy's type (the plain reader of the
    kernels' layouts); an f32 copy's ``plane`` (0 hi, 1 lo), or by default
    the sum of both, the weights themselves (the narrow kernel's FFMA
    copies have no planes)."""
    j = torch.arange(K)[:, None, None]
    co = torch.arange(Co)[None, :, None]
    ci = torch.arange(Ci)[None, None, :]
    flat = wt.reshape(-1)
    if wt.dtype != torch.float32 or not (wide(Co, Ci) or narrow_mma(Co, Ci)):
        return flat[tile_offset(j, co, ci, K, Co, Ci, wt.dtype)]
    at = lambda p: flat[tile_offset(j, co, ci, K, Co, Ci, wt.dtype, p)]
    return at(0) + at(1) if plane is None else at(plane)


def pack_conv(conv, dtype: torch.dtype) -> ConvWeights:
    """nn.Conv1d (torch (Co, Ci, K)) -> the kernels' layouts: tap-major, and
    the tiled copy of the kernel its channels run on."""
    w = conv.weight.detach().permute(2, 0, 1).to(dtype).contiguous()
    return ConvWeights(w, conv.bias.detach().float().contiguous(), int(conv.dilation[0]),
                       tile_conv(w))


def fold_reach(K: int, stride: int, padding: int) -> Optional[int]:
    """Input rows on each side that a transposed conv's output row reads,
    where it folds into a SAME conv (``fold_upsample``), else None. Output
    sample t = q u + r (phase r, u = stride) takes the taps m = j u + beta
    from input rows q + alpha - j, j < K / u, with alpha, beta = divmod(r +
    padding, u); it folds where Tout = u Tin (K - 2 padding = u) and the
    phases' rows together are a window centred on q."""
    if stride < 1 or padding < 0 or K % stride or K - 2 * padding != stride:
        return None
    alphas = [(r + padding) // stride for r in range(stride)]
    lo, hi = min(alphas) - K // stride + 1, max(alphas)
    return hi if lo == -hi else None


def fold_upsample(w: torch.Tensor, b: torch.Tensor, stride: int, padding: int) -> ConvWeights:
    """Transposed-conv weights, tap-major (K, Ci, Co) -> the SAME conv of
    2 R + 1 taps (R = ``fold_reach``, 1 for k = 2u) from Ci to u Co
    channels whose (B, Tin, u Co) output is the transposed conv's (B, u
    Tin, Co) output in memory: tap R + alpha - j of output channel r Co +
    co is w[j u + beta, :, co] (phase r, as ``fold_reach``), every other tap
    zero; the bias tiled u times; the tiled copy of the kernel its channels
    run on. Raises ValueError where the shape does not fold."""
    K, Ci, Co = w.shape
    reach = fold_reach(K, stride, padding)
    if reach is None:
        raise ValueError(f"a transposed conv of kernel {K}, stride {stride}, padding {padding} "
                         "does not fold into a SAME conv (it needs kernel % stride == 0, "
                         "kernel - 2 padding == stride and a centred window)")
    wf = w.new_zeros(2 * reach + 1, stride, Co, Ci)
    for r in range(stride):
        alpha, beta = divmod(r + padding, stride)
        for j in range(K // stride):
            wf[reach + alpha - j, r] = w[j * stride + beta].t()
    wf = wf.reshape(2 * reach + 1, stride * Co, Ci).contiguous()
    return ConvWeights(wf, b.float().repeat(stride).contiguous(), 1, tile_conv(wf))


def _fold(C: int) -> int:
    """The TPU stage kernel's phase fold of C channels (``mrf_pallas.py:440``)."""
    return 128 // C if C < 128 and 128 % C == 0 else 1


def _taps_fit_halo(ku: int, u: int, s: int, s_in: int) -> bool:
    """The JAX fused upsample's row shifts (``mrf_pallas.py::upsample_taps``)
    within its 8-row input halo (``_taps_fit_halo``)."""
    pad = (ku - u) // 2
    return max(abs(((j + pad - m) // u) // s_in) for j in range(s) for m in range(ku)
               if (j + pad - m) % u == 0) <= 8


def jax_fuses_upsample(u: int, Cin: int, C: int, ku: int) -> bool:
    """Whether the JAX package fuses this upsample into its Pallas stage
    kernel (``mrf_pallas.py::upsample_fusable`` or
    ``upsample_fusable_expand``), rather than running XLA's transposed conv
    in front of it (``models/hifigan.py:391-395``)."""
    aligned = (C < 128 and 128 % C == 0 and 128 % Cin == 0 and u * (128 // Cin) == 128 // C
               and _taps_fit_halo(ku, u, 128 // C, 128 // Cin))
    expand = _fold(C) == 1 and u in (2, 4, 8) and _taps_fit_halo(ku, u, u, 1)
    return aligned or expand


def make_upsample(w: torch.Tensor, b: torch.Tensor, stride: int,
                  padding: int) -> UpsampleWeights:
    """Transposed-conv weights from the tap-major (K, Ci, Co) layout, with
    the folded conv where the shape folds; a bf16 upsample that the JAX
    package runs on XLA rounds its sum before the bias."""
    K, Ci, Co = w.shape
    folded = (fold_upsample(w, b, stride, padding)
              if fold_reach(K, stride, padding) is not None else None)
    round_sum = w.dtype != torch.float32 and not jax_fuses_upsample(stride, Ci, Co, K)
    return UpsampleWeights(w.contiguous(), b.float().contiguous(), stride, padding, folded,
                           round_sum)


def pack_upsample(convt, dtype: torch.dtype) -> UpsampleWeights:
    """nn.ConvTranspose1d (torch (Ci, Co, K)) -> the kernel's layouts."""
    return make_upsample(convt.weight.detach().permute(2, 0, 1).to(dtype),
                         convt.bias.detach(), int(convt.stride[0]), int(convt.padding[0]))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def operand(x, dtype: torch.dtype):
    """A conv's operand, the kernels' prologue: ``lrelu(x)`` rounded to
    ``dtype``, the weights' type (bf16 on the card), kept in that type."""
    return F.leaky_relu(x, LRELU_SLOPE).to(dtype)


def mrf_conv_plain(a, cw: ConvWeights, res=None, acc=None, acc_scale: float = 0.0,
                   want_y: bool = True, want_act: bool = False, acc_act: bool = False,
                   round_sum: bool = False):
    """From the operand ``a = operand(x, w.dtype)``: v = conv(a) + b (+ res),
    SAME padding with dilation -> (v or None, operand(v) or None, acc +
    acc_scale * v or None), the last None when acc_scale == 0; with
    ``acc_act`` the last is that sum's operand (the next stage's upsample
    reads only it), not the sum. ``round_sum``: the sum is rounded to the
    weights' type before the bias (``conv_pre``)."""
    v = layers.conv1d(a.float(), cw.w.float().permute(1, 2, 0), cw.b,
                      layers.Policy(cw.w.dtype) if round_sum else layers.F32, padding="SAME",
                      dilation=cw.dilation, round_out=round_sum)
    if res is not None:
        v = v + res
    acc_out = None
    if acc_scale != 0.0:
        acc_out = acc_scale * v if acc is None else acc + acc_scale * v
        if acc_act:
            acc_out = operand(acc_out, cw.w.dtype)
    return (v if want_y else None, operand(v, cw.w.dtype) if want_act else None, acc_out)


def mrf_pair_plain(a, c1: ConvWeights, c2: ConvWeights, res=None, acc=None,
                   acc_scale: float = 0.0, want_y: bool = True, want_act: bool = False,
                   acc_act: bool = False):
    """A ResBlock1 pair from the operand ``a``: ``mrf_conv_plain`` of c2 on
    the operand of c1's output, with c2's epilogue."""
    _, at, _ = mrf_conv_plain(a, c1, want_y=False, want_act=True)
    return mrf_conv_plain(at, c2, res, acc, acc_scale, want_y, want_act, acc_act)


def pair_fusable(c1: ConvWeights, c2: Optional[ConvWeights]) -> bool:
    """Whether ``mrf_pair`` takes the pair: a second conv of dilation 1 and
    the first's shape, C = Ci = Co one N tile of its kernel (32 to 128 on
    the wide kernels, ``PAIR_C`` on the narrow one)."""
    if c2 is None or c2.dilation != 1 or c1.w.shape != c2.w.shape:
        return False
    K, Co, Ci = c1.w.shape
    if Co != Ci:
        return False
    return conv_tiles(Co, Ci)[0] == Co if wide(Co, Ci) else Co in PAIR_C


def conv_transpose_plain(a, uw: UpsampleWeights, want_act: bool = False):
    """From the operand ``a = operand(x, w.dtype)``, channels-last:
    y = ConvTranspose1d(a) + b -> (y, operand(y) or None); with
    ``uw.round_sum`` the sum rounded to the weights' type before the bias
    (JAX's ``conv_transpose1d_apply`` under a bf16 policy)."""
    pol = layers.Policy(uw.w.dtype) if uw.round_sum else layers.F32
    y = layers.conv_transpose1d(a.float(), uw.w.float().permute(1, 2, 0), uw.b, uw.stride,
                                uw.padding, pol, round_out=uw.round_sum)
    return y, (operand(y, uw.w.dtype) if want_act else None)


def conv_pre_plain(a, cw: ConvWeights):
    """The vocoder's ``conv_pre`` from its operand ``a``, the mel in the
    weights' type: ``operand(bf16(conv(a)) + b)``, the sum rounded to the
    weights' type before the bias as ``layers.conv1d(..., round_out=True)``
    -- stage 1's upsample operand."""
    return mrf_conv_plain(a, cw, want_y=False, want_act=True, round_sum=True)[1]


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

_LIB = None
_LIB_F32 = None
_LIB_NARROW = None
P = ctypes.c_void_p
I = ctypes.c_int


def bind(lib: ctypes.CDLL, suffix: str = "", kind: str = "mrf") -> ctypes.CDLL:
    """Declare the C entry points of a loaded build of ``csrc/mrf.cu`` (or,
    with ``suffix`` "_f32", of ``csrc/mrf_f32.cu``: the same interface;
    ``kind`` "narrow": ``csrc/mrf_narrow.cu``'s, ``t2_narrow_*<suffix>``)."""
    conv = getattr(lib, f"t2_{kind}_conv{suffix}")
    pair = getattr(lib, f"t2_{kind}_pair{suffix}")
    conv.argtypes = [P] * 8 + [I] * 7 + [ctypes.c_float, P]
    pair.argtypes = [P] * 10 + [I] * 6 + [ctypes.c_float, P]
    for fn in (conv, pair):
        fn.restype = I
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = bind(build.load("mrf"))
    return _LIB


def _lib_f32():
    global _LIB_F32
    if _LIB_F32 is None:
        _LIB_F32 = bind(build.load("mrf_f32"), "_f32")
    return _LIB_F32


def _lib_narrow():
    global _LIB_NARROW
    if _LIB_NARROW is None:
        _LIB_NARROW = bind(bind(build.load("mrf_narrow"), "", "narrow"), "_f32", "narrow")
    return _LIB_NARROW


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _require_conv(cw: ConvWeights, Ci: int, name: str):
    """The weights' tiled copy in the layout of the kernel of their type
    (bf16 or f32) and shape (the narrow kernel's route's where not
    ``wide``), and the f32 bias."""
    K, Co, _ = cw.w.shape
    dt = cw.w.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: the kernels take bf16 or f32 weights, got {dt}")
    if cw.wt is None:
        raise ValueError(f"{name}: the weights have no tiled copy (pack_conv, tile_conv)")
    if narrow_small(Co, Ci):
        build.require(cw.wt, dt, (K, *small_layout(Co, Ci, dt)), f"{name}.wt")
    elif narrow_mma(Co, Ci):
        build.require(cw.wt, dt, (K, 2 if dt == torch.float32 else 1, *mma_pads(Co, Ci, dt)),
                      f"{name}.wt")
    elif not wide(Co, Ci):
        build.require(cw.wt, dt, (Ci, K, Co), f"{name}.wt")
    else:
        NI, KC = conv_tiles(Co, Ci, dt)
        tile = (2, KC // 4, NI, 4) if dt == torch.float32 else (KC // 8, NI, 8)
        build.require(cw.wt, dt, (Co // NI, slices(Ci, KC), K, *tile), f"{name}.wt")
    build.require(cw.b, torch.float32, (Co,), f"{name}.b")


def _launch_conv(name, a, c1, c2, res, acc, acc_scale, want_y, want_act, acc_act=False,
                 round_sum=False):
    """``mrf_conv`` (c2 None; also ``conv_transpose``'s folded conv and
    ``conv_pre``) or ``mrf_pair``: check, allocate, launch; the weights'
    type picks the kernel, bf16 (``csrc/mrf.cu``) or f32
    (``csrc/mrf_f32.cu``, counted in ``F32_LAUNCHES``), and the operands'
    type (``a``, ``act`` and an ``acc_act`` sum) is theirs; at a shape not
    ``wide`` the narrow kernel's entry of that type (``csrc/mrf_narrow.cu``),
    counted as ``launch_key`` says."""
    B, T, Ci = a.shape
    K, Co, _ = c1.w.shape
    dt = c1.w.dtype
    build.require(a, dt, (B, T, Ci), "a")
    _require_conv(c1, Ci, name)
    if c2 is not None:
        if not pair_fusable(c1, c2):
            raise ValueError(f"mrf_pair takes a pair of (K, C, C) convs, C one N tile (8, 16, "
                             f"32, 64 or 128), the second of dilation 1: got "
                             f"{tuple(c1.w.shape)}, {tuple(c2.w.shape)}, dilation {c2.dilation}")
        if c2.w.dtype != dt:
            raise ValueError(f"mrf_pair: the convs' types differ, {dt} and {c2.w.dtype}")
        _require_conv(c2, Co, name)
    if res is not None:
        build.require(res, torch.float32, (B, T, Co), "res")
    if acc is not None:
        build.require(acc, torch.float32, (B, T, Co), "acc")
    if not (want_y or want_act or acc_scale != 0.0):
        raise ValueError(f"{name}: no output asked for")
    y = torch.empty(B, T, Co, device=a.device) if want_y else None
    act = torch.empty(B, T, Co, device=a.device, dtype=dt) if want_act else None
    acc_out = (torch.empty(B, T, Co, device=a.device, dtype=dt if acc_act else torch.float32)
               if acc_scale != 0.0 else None)
    mode = 0 if acc_out is None else (1 if acc is None else 2) + (4 if acc_act else 0)
    mode += 8 if round_sum else 0
    ptr = lambda t: 0 if t is None else t.data_ptr()
    stream = _stream()
    sfx = "_f32" if dt == torch.float32 else ""
    key = launch_key(name, c1)
    if not wide(Co, Ci):
        lib, kind = _lib_narrow(), "narrow"
    else:
        lib, kind = (_lib_f32() if sfx else _lib()), "mrf"
    conv, pair = getattr(lib, f"t2_{kind}_conv{sfx}"), getattr(lib, f"t2_{kind}_pair{sfx}")
    build.count(F32_LAUNCHES if sfx else LAUNCHES, key)
    if c2 is None:
        err = conv(a.data_ptr(), c1.wt.data_ptr(), c1.b.data_ptr(), ptr(res), ptr(acc),
                   ptr(acc_out), ptr(y), ptr(act), B, T, Ci, Co, K, c1.dilation, mode,
                   ctypes.c_float(acc_scale), stream)
    else:
        err = pair(a.data_ptr(), c1.wt.data_ptr(), c1.b.data_ptr(), c2.wt.data_ptr(),
                   c2.b.data_ptr(), ptr(res), ptr(acc), ptr(acc_out), ptr(y), ptr(act), B, T,
                   Ci, K, c1.dilation, mode, ctypes.c_float(acc_scale), stream)
    build.check(err, key)
    return y, act, acc_out


def mrf_conv(a, cw: ConvWeights, res=None, acc=None, acc_scale: float = 0.0,
             want_y: bool = True, want_act: bool = False, acc_act: bool = False):
    """Dilated SAME conv of the operand ``a`` (in the weights' type: bf16 or
    f32) with the bias, residual, next-operand and stage-mean epilogue; see
    ``mrf_conv_plain``."""
    if a.device.type == "cpu":
        return mrf_conv_plain(a, cw, res, acc, acc_scale, want_y, want_act, acc_act)
    return _launch_conv("mrf_conv", a, cw, None, res, acc, acc_scale, want_y, want_act,
                        acc_act)


def mrf_pair(a, c1: ConvWeights, c2: ConvWeights, res=None, acc=None, acc_scale: float = 0.0,
             want_y: bool = True, want_act: bool = False, acc_act: bool = False):
    """A ResBlock1 pair in one launch, its intermediate kept in shared
    memory; see ``mrf_pair_plain``."""
    if a.device.type == "cpu":
        return mrf_pair_plain(a, c1, c2, res, acc, acc_scale, want_y, want_act, acc_act)
    return _launch_conv("mrf_pair", a, c1, c2, res, acc, acc_scale, want_y, want_act, acc_act)


def conv_transpose(a, uw: UpsampleWeights, want_act: bool = False):
    """ConvTranspose1d of the operand ``a`` (B, Tin, Ci) -> (y (B, u
    Tin, Co) f32, operand(y) or None): one ``mrf_conv`` launch of the folded
    conv (``fold_upsample``; ``uw.round_sum`` its epilogue's mode 8), its
    outputs viewed as the transposed conv's; see ``conv_transpose_plain``.
    A shape that does not fold takes JAX's XLA route on any device:
    ``conv_transpose_plain`` on stock ops (cuDNN on the card, TF32 off as
    ``layers.use_f32_math`` sets it), counted as ``conv_transpose_stock``."""
    if uw.folded is None:  # contiguous, as the stage's kernels read them
        build.count(STOCK_ROUTES, "conv_transpose_stock")
        y, act = conv_transpose_plain(a, uw, want_act)
        return y.contiguous(), (None if act is None else act.contiguous())
    if a.device.type == "cpu":
        return conv_transpose_plain(a, uw, want_act)
    K, Ci, Co = uw.w.shape
    B, Tin, _ = a.shape
    y, act, _ = _launch_conv("conv_transpose", a, uw.folded, None, None, None, 0.0, True,
                             want_act, round_sum=uw.round_sum)
    Tout = Tin * uw.stride
    return y.view(B, Tout, Co), (None if act is None else act.view(B, Tout, Co))


def conv_pre(a, cw: ConvWeights):
    """The vocoder's ``conv_pre`` from the mel ``a`` (B, T, num_mels) in the
    weights' type: one ``mrf_conv`` launch whose epilogue rounds the sum to
    that type before the bias (the identity at f32) and writes only stage
    1's upsample operand (B, T, Co) in it; see ``conv_pre_plain``."""
    if a.device.type == "cpu":
        return conv_pre_plain(a, cw)
    return _launch_conv("conv_pre", a, cw, None, None, None, 0.0, False, True,
                        round_sum=True)[1]


# ---------------------------------------------------------------------------
# the stage
# ---------------------------------------------------------------------------


def run_stage(x, resblocks: Sequence[ResBlockWeights],
              upsample: Optional[UpsampleWeights], conv, conv_t, pair=None, a=None,
              want_operand: bool = False):
    """The stage over the given conv callables (the wrappers, their plain
    versions, or timing hooks that call them), passing each conv's operand
    to the next: a ResBlock1 pair's intermediate as its operand only, the
    residual stream as f32 and operand, and the last conv of a resblock as
    its share of the stage mean only; ``pair``, where given, runs each
    ResBlock1 pair that ``pair_fusable`` takes as one call.

    ``a``: the operand of the stage input ``x``, where its producer wrote
    it (the vocoder's: ``conv_pre`` for stage 1, the stage before for the
    rest); the upsample reads only it (x may then be None). Else it is made
    here with ``operand`` (PyTorch, on any device: the plain dataflow, and
    the checks that start a stage from an f32 input). -> the stage mean
    (f32), or with ``want_operand`` the
    mean's operand alone, the next stage's upsample's input: the last conv
    writes that instead of the f32 mean."""
    if a is None:
        x = x.contiguous()
        a = operand(x, resblocks[0][0][0].w.dtype)
    if upsample is not None:
        x, a = conv_t(a, upsample, want_act=True)
    scale = 1.0 / len(resblocks)
    acc = None
    for i, rb in enumerate(resblocks):
        z, az = x, a
        for j, (c1, c2) in enumerate(rb):
            last = j == len(rb) - 1
            tail = dict(res=z, acc=acc, acc_scale=scale if last else 0.0, want_y=not last,
                        want_act=not last)
            if last and want_operand and i == len(resblocks) - 1:
                tail["acc_act"] = True
            if pair is not None and pair_fusable(c1, c2):
                z, az, out = pair(az, c1, c2, **tail)
                continue
            if c2 is not None:
                _, az, _ = conv(az, c1, want_y=False, want_act=True)
            z, az, out = conv(az, c1 if c2 is None else c2, **tail)
        acc = out
    return acc


def mrf_stage(x, resblocks: Sequence[ResBlockWeights],
              upsample: Optional[UpsampleWeights] = None, a=None, want_operand: bool = False):
    """``[lrelu -> ConvTranspose1d] -> mean over resblocks`` on (B, T, C)
    through the kernels; ``a`` and ``want_operand`` as ``run_stage``."""
    return run_stage(x, resblocks, upsample, mrf_conv, conv_transpose, mrf_pair, a,
                     want_operand)


def side_output_stage(x, resblocks: Sequence[ResBlockWeights],
                      upsample: Optional[UpsampleWeights] = None, a=None):
    """``mrf_stage``'s dataflow (operands passed between convs) through the
    plain versions, on any device; ``a`` as ``run_stage``. Equal to
    ``plain_stage`` bit for bit (on an input whose operand is ``a``)."""
    return run_stage(x, resblocks, upsample, mrf_conv_plain, conv_transpose_plain,
                     mrf_pair_plain, a)


def _conv_ref(x, cw: ConvWeights, res=None):
    y = layers.conv1d(operand(x, cw.w.dtype).float(), cw.w.float().permute(1, 2, 0), cw.b,
                      padding="SAME", dilation=cw.dilation)
    return y if res is None else y + res


def plain_stage(x, resblocks: Sequence[ResBlockWeights],
                upsample: Optional[UpsampleWeights] = None):
    """The stage as defined, in plain PyTorch on any device: every conv
    takes the rounded ``lrelu`` of its f32 input (the JAX kernels'
    prologue), every activation is f32."""
    if upsample is not None:
        x = conv_transpose_plain(operand(x, upsample.w.dtype), upsample)[0]
    scale = 1.0 / len(resblocks)
    acc = None
    for rb in resblocks:
        z = x
        for c1, c2 in rb:
            z = _conv_ref(z, c1, res=z) if c2 is None else _conv_ref(_conv_ref(z, c1), c2, res=z)
        acc = scale * z if acc is None else acc + scale * z
    return acc
