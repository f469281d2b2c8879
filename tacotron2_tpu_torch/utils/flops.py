"""Analytic FLOP model for roofline and MFU accounting.

Counterpart of ``tacotron2_tpu/utils/flops.py``, with the same arithmetic:
a multiply-accumulate counts 2 FLOPs, and only the matmul and conv terms
count (elementwise work and the softmax are not FLOP-relevant on the tensor
cores' roofline).

- decode step: prenet, attention LSTM, location attention, decoder LSTM and
  heads of one autoregressive frame, plus the postnet's share of a frame;
  the one-time encoder pass is left out;
- training frame: the forward (the encoder's per-char share, the decode
  step, the postnet) times 3, the backward's dX and dW products each
  costing one forward again.

The peaks are NVIDIA's data-sheet figures for the H100 SXM ("NVIDIA H100
80GB HBM3"): dense bf16 989 TFLOP/s, dense int8 1,979 TOP/s, dense TF32
494.7 TFLOP/s, FP32 on the CUDA cores 66.9 TFLOP/s, HBM3 3.35 TB/s. A card
set below its 700 W limit runs below them. f32-exact products (K2's f32
mode) take the CUDA cores' FP32 rate, or the TF32 rate for three passes of
a split operand.
"""

from __future__ import annotations

DEVICE = "NVIDIA H100 80GB HBM3"
H100_BF16_TFLOPS = 989.0  # dense bf16 tensor-core peak, data sheet
H100_INT8_TOPS = 1979.0  # dense int8 tensor-core peak, data sheet
H100_TF32_TFLOPS = 494.7  # dense TF32 tensor-core peak, data sheet
H100_F32_TFLOPS = 66.9  # FP32 on the CUDA cores, data sheet
H100_HBM_TBPS = 3.35  # HBM3 bandwidth, data sheet


def decode_step_flops(cfg, chars_len: int, postnet: bool = True) -> float:
    """FLOPs per decoded mel frame per batch row; ``cfg`` a model config
    with the JAX config's field names (``encoded_full_dim`` included)."""
    P, M = cfg.prenet_dim, cfg.num_mels
    H1, H2, A = cfg.att_rnn_dim, cfg.rnn_hidden_dim, cfg.att_dim
    D = cfg.encoded_full_dim
    L = chars_len
    macs = 0
    macs += M * P + P * P  # prenet
    macs += (P + D) * 4 * H1 + H1 * 4 * H1  # attention LSTM
    macs += H1 * A  # query projection
    macs += L * (2 * 31 * 32 + 32 * A + A + D)  # location conv / dense, energies, context
    macs += (H1 + D) * 4 * H2 + H2 * 4 * H2  # decoder LSTM
    macs += (H2 + D) * (M + 1)  # mel and gate heads
    if postnet:
        macs += postnet_frame_macs(cfg)
    return 2.0 * macs


def postnet_frame_macs(cfg) -> float:
    """The five k=5 postnet convs' MACs per frame."""
    M, C, k = cfg.num_mels, cfg.postnet_dim, 5
    return k * (M * C + 3 * C * C + C * M)


def encoder_char_macs(cfg) -> float:
    """The three k-wide convs and the BiLSTM's MACs per input char."""
    Dc = cfg.encoded_dim
    k = cfg.encoder_kernel_size
    h = Dc // 2  # a direction's hidden width
    return 3 * k * Dc * Dc + 2 * (Dc * 4 * h + h * 4 * h)


def train_frame_flops(cfg, chars_len: int, frames_per_char: float = 4.0) -> float:
    """FLOPs per mel frame of one training step (forward and backward)."""
    fwd = decode_step_flops(cfg, chars_len, postnet=True)
    fwd += 2.0 * encoder_char_macs(cfg) / frames_per_char
    return 3.0 * fwd


def mfu(flops_per_item: float, items_per_sec: float,
        peak_tflops: float = H100_BF16_TFLOPS) -> tuple:
    """-> (achieved TFLOP/s, its fraction of ``peak_tflops``)."""
    tf = flops_per_item * items_per_sec / 1e12
    return tf, tf / peak_tflops
