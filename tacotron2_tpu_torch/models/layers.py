"""Functional layers on tensors, in torch's weight layouts.

Counterpart of ``tacotron2_tpu/models/layers.py``. The JAX package stores
weights as Linear ``(in, out)`` and Conv1d ``(W, I, O)``; here every weight
keeps torch's layout (Linear ``(out, in)``, Conv1d ``(O, I, W)``,
ConvTranspose1d ``(I, O, W)``, LSTM ``(4H, in)``), because the modules hold
them under the reference's ``state_dict`` names. Activations are
channels-last ``(B, T, C)`` as in the JAX package, so the tests compare like
with like.

In a data-parallel step (``parallel/mesh.py``) the train-mode BatchNorms
take the global batch's statistics and dropout the global batch's mask.

Also the GST's pieces: ``conv2d`` (NCHW), ``batchnorm2d`` and
``gru_sequence`` (JAX ``conv2d_apply``, ``batchnorm_apply`` over N, H and
W, ``gru_sequence``).

``Policy`` carries the precision: under bf16 compute every matmul and conv
operand is rounded to bf16 and the sum is taken in f32, the same class as the
JAX package's bf16 policy (bf16 operands, f32 accumulation).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tacotron2_tpu_torch.ops.encoder_lstm import BiLSTMRecurrence
from tacotron2_tpu_torch.parallel import mesh


@dataclasses.dataclass(frozen=True)
class Policy:
    """Mixed precision: ``compute_dtype`` is the operand type of matmuls."""

    compute_dtype: torch.dtype = torch.float32

    @staticmethod
    def from_string(precision: str) -> "Policy":
        if precision in ("bf16-mixed", "16-mixed", "bf16"):
            return Policy(torch.bfloat16)
        if precision in ("32", "32-true", "float32", "fp32"):
            return Policy(torch.float32)
        raise ValueError(f"unknown precision {precision!r}")

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        """Round an operand to the compute type, keep f32 storage."""
        if self.compute_dtype == torch.float32:
            return x.float()
        return x.to(self.compute_dtype).float()


F32 = Policy()


def resolve_device(device: Optional[str | torch.device] = None) -> torch.device:
    """The port's entry points run on the card unless the caller asks for
    the CPU; asking for CUDA where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return dev


def use_f32_math() -> None:
    """TF32 off for matmuls and cuDNN, so what the policy keeps in f32 (the
    encoder's BiLSTM, the sums of bf16 operands, the dW GEMMs) is computed in
    f32 on the card. The entry points set it, and ``chip_smoke.py`` measures
    under it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def linear(x, w, b=None, policy: Policy = F32):
    """x (..., in) @ w (out, in)^T + b."""
    return F.linear(policy.cast(x), policy.cast(w), b)


def _same_pad(k: int, dilation: int) -> int:
    eff = (k - 1) * dilation + 1
    if eff % 2 == 0:
        raise ValueError("SAME padding needs an odd effective kernel")
    return (eff - 1) // 2


def conv1d(x, w, b=None, policy: Policy = F32, padding: str | int = "SAME",
           dilation: int = 1, round_out: bool = False):
    """Conv1d over channels-last x (B, T, C); w is torch's (O, I, W). With
    ``round_out`` the f32 sums are rounded to the compute type before the
    bias is added, as JAX's ``conv1d_apply`` emits the policy's type (the
    encoder's and the postnet's convs)."""
    pad = _same_pad(w.shape[2], dilation) if padding == "SAME" else int(padding)
    y = F.conv1d(policy.cast(x).transpose(1, 2), policy.cast(w), None if round_out else b,
                 padding=pad, dilation=dilation).transpose(1, 2)
    if round_out:
        y = policy.cast(y)
        if b is not None:
            y = y + b
    return y


def conv2d(x, w, b=None, policy: Policy = F32, stride: int = 1, padding: int = 0):
    """Conv2d over NCHW x; w is torch's (O, I, KH, KW). The f32 sums are
    rounded to the compute type before the bias is added, as JAX's
    ``conv2d_apply`` emits the policy's type and adds the bias in f32."""
    y = policy.cast(F.conv2d(policy.cast(x), policy.cast(w), None, stride=stride,
                             padding=padding))
    return y if b is None else y + b[None, :, None, None]


def conv_transpose1d(x, w, b, stride: int, padding: int, policy: Policy = F32,
                     round_out: bool = False):
    """ConvTranspose1d over channels-last x (B, T, C); w is torch's
    (I, O, W). out_len = (T-1)*stride - 2*padding + W. ``round_out``: the
    f32 sums rounded to the compute type before the bias, as JAX's
    ``conv_transpose1d_apply`` emits the policy's type."""
    y = F.conv_transpose1d(policy.cast(x).transpose(1, 2), policy.cast(w),
                           None if round_out else b, stride=stride,
                           padding=padding).transpose(1, 2)
    if round_out:
        y = policy.cast(y)
        if b is not None:
            y = y + b
    return y


def embedding(idx, table):
    return F.embedding(idx, table)


def batchnorm_eval(x, weight, bias, running_mean, running_var, eps: float = 1e-5):
    """BatchNorm1d in eval mode over the channel (last) axis of (B, T, C)."""
    return (x - running_mean) * torch.rsqrt(running_var + eps) * weight + bias


def batchnorm(x, bn: torch.nn.BatchNorm1d, train: bool):
    """BatchNorm1d over the channel (last) axis of (B, T, C). In train mode
    (JAX ``batchnorm_apply``) it normalizes with the batch's biased variance
    and updates the running stats in place with the unbiased one, momentum
    0.1; padded steps count in the statistics, as in the reference."""
    if not train:
        return batchnorm_eval(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
    if mesh.current() is not None:  # the global batch's statistics
        return mesh.batch_norm_train(x, bn, (0, 1), (1, 1, -1))
    y = F.batch_norm(x.transpose(1, 2), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                     training=True, momentum=0.1, eps=bn.eps)
    return y.transpose(1, 2)


def batchnorm2d(x, bn: torch.nn.BatchNorm2d, train: bool):
    """BatchNorm2d over the channels (axis 1) of NCHW x, under ``batchnorm``'s
    rules: train mode normalizes with the biased variance over N, H and W
    (padded frames included) and updates the running stats in place with
    the unbiased one, momentum 0.1; eval mode reads the running stats."""
    if train and mesh.current() is not None:  # the global batch's statistics
        return mesh.batch_norm_train(x, bn, (0, 2, 3), (1, -1, 1, 1))
    if train:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                            training=True, momentum=0.1, eps=bn.eps)
    c = lambda v: v[None, :, None, None]
    return ((x - c(bn.running_mean)) * torch.rsqrt(c(bn.running_var) + bn.eps) * c(bn.weight)
            + c(bn.bias))


def dropout(x, rate: float, generator: Optional[torch.Generator] = None):
    """Inverted dropout (torch semantics: keep with 1 - rate, scale by
    1 / (1 - rate)) with the bits from ``generator``; in a data-parallel
    step the global batch's mask, cut to this rank's rows (axis 0)."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    return x * ((mesh.rand_rows(x.shape, generator, x.device) < keep).to(x.dtype) / keep)


def lstm_cell(x, hc: Tuple[torch.Tensor, torch.Tensor], w_ih, w_hh, b_ih, b_hh,
              policy: Policy = F32):
    """One LSTM step, torch gate order i, f, g, o."""
    h, c = hc
    gates = linear(x, w_ih, b_ih, policy) + linear(h, w_hh, b_hh, policy)
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def _valid_reversed(xs, lengths):
    """(the valid mask (B, T), each row's valid prefix reversed as gather
    indices (B, T): position t < length reads length - 1 - t, the rest t)."""
    t = torch.arange(xs.shape[1], device=xs.device)[None, :]
    lens = lengths.to(xs.device)[:, None]
    valid = t < lens
    return valid, torch.where(valid, lens - 1 - t, t)


def bilstm_rows(lstm: torch.nn.LSTM, xs, lengths):
    """Bidirectional one-layer ``nn.LSTM`` over (B, T, C) with packed-sequence
    semantics, as the reference encoder runs it, in f32 on every row at
    every step: each direction one unidirectional f32 LSTM (cuDNN on the
    card) over the padded batch, the reverse one over each row's valid
    prefix reversed (a per-row gather), so it starts at the row's own last
    valid step; outputs past a row's length are zero. A packed LSTM's steps
    take only the rows still running, so a row's products there take the
    shape the batch's lengths give; here they take (B, ...) whatever the
    lengths, so a row of a batch of fixed rows (the server's
    ``encode_rows``) equals the row alone in such a batch, bit for bit.
    Returns (B, T, 2H), forward then reverse features."""
    B, T, C = xs.shape
    valid, rev = _valid_reversed(xs, lengths)
    xs = xs.float()
    h0 = xs.new_zeros(1, B, lstm.hidden_size)

    def run(x, sfx):
        params = [getattr(lstm, f"{n}_l0{sfx}") for n in ("weight_ih", "weight_hh", "bias_ih",
                                                          "bias_hh")]
        with warnings.catch_warnings():  # one direction's weights: not the module's flat copy
            warnings.filterwarnings("ignore", "RNN module weights are not part of single")
            return torch.lstm(x, (h0, h0), params, True, 1, 0.0, lstm.training, False, True)[0]

    fwd = run(xs, "")
    bwd = run(torch.gather(xs, 1, rev[..., None].expand(B, T, C)), "_reverse")
    bwd = torch.gather(bwd, 1, rev[..., None].expand_as(bwd))
    return torch.where(valid[..., None], torch.cat([fwd, bwd], dim=-1), 0.0)


def bilstm(lstm: torch.nn.LSTM, xs, lengths, policy: Policy = F32):
    """``bilstm_rows``'s function with the policy's operand rounding, as
    the JAX encoder's two ``lstm_sequence`` calls compute it (each of them
    runs every row every step, masked). Under f32 it is ``bilstm_rows``,
    f32 throughout. Under bf16 the input projection of every step is
    one product with bf16 operands and f32 sums (+ b_ih); the recurrence
    (``ops/encoder_lstm.py``) then adds ``bf16(h) . W_hh^T + b_hh`` each
    step while h and c stay f32. The reverse direction runs over each row's
    own reversed valid prefix (a per-row gather), both directions in one
    recurrence. Outputs past a row's length are zero."""
    if policy.compute_dtype == torch.float32:
        return bilstm_rows(lstm, xs, lengths)
    B, T, C = xs.shape
    valid, rev = _valid_reversed(xs, lengths)  # each row's valid prefix reversed
    xs = xs.float()
    x2 = torch.stack([xs, torch.gather(xs, 1, rev[..., None].expand(B, T, C))])
    stack = lambda name: torch.stack([getattr(lstm, f"{name}_l0"),
                                      getattr(lstm, f"{name}_l0_reverse")])
    w_ih, w_hh, b_ih, b_hh = (stack(n) for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
    xp = torch.matmul(policy.cast(x2).reshape(2, B * T, C), policy.cast(w_ih).transpose(1, 2))
    xp = xp.reshape(2, B, T, -1) + b_ih[:, None, None, :]
    hs = BiLSTMRecurrence.apply(xp, w_hh, b_hh)  # (2, B, T, H)
    bwd = torch.gather(hs[1], 1, rev[..., None].expand_as(hs[1]))
    return torch.where(valid[..., None], torch.cat([hs[0], bwd], dim=-1), 0.0)


def gru_sequence(gru: torch.nn.GRU, xs, lengths=None, reverse: bool = False,
                 policy: Policy = F32, suffix: str = "_l0"):
    """One direction of a GRU over (B, T, C) with packed-sequence semantics
    (JAX ``gru_sequence``): the weights are ``gru``'s ``weight_ih{suffix}``
    etc., gates r, z, n in torch's order, n = tanh(xn + r (h W_hn + b_hn)).
    ``lengths`` None runs every step; else a row's state holds past its
    length, its outputs there are zero and ``reverse`` runs each row's own
    valid prefix backwards. Every product takes the policy's operands with
    f32 sums; h stays f32. -> (outputs (B, T, H), the final hidden state
    (B, H) at each row's true last step, zeros for a row of length 0)."""
    w_ih, w_hh, b_ih, b_hh = (getattr(gru, f"{n}{suffix}")
                              for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
    B, T, C = xs.shape
    dev = xs.device
    lens = (torch.full((B,), T, device=dev) if lengths is None
            else torch.as_tensor(lengths).to(dev)).long()[:, None]
    t = torch.arange(T, device=dev)[None, :]
    valid = t < lens
    xs = xs.float()
    if reverse:
        rev = torch.where(valid, lens - 1 - t, t)
        xs = torch.gather(xs, 1, rev[..., None].expand(B, T, C))
    xp = linear(xs, w_ih, b_ih, policy)
    h = h_final = xs.new_zeros(B, w_hh.shape[1])
    outs = []
    for s in range(T):
        xr, xz, xn = xp[:, s].chunk(3, dim=-1)
        hr, hz, hn = linear(h, w_hh, b_hh, policy).chunk(3, dim=-1)
        r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
        h2 = (1.0 - z) * torch.tanh(xn + r * hn) + z * h
        h_final = torch.where(lens == s + 1, h2, h_final)
        h = torch.where(valid[:, s, None], h2, h)
        outs.append(h)
    hs = torch.stack(outs, dim=1)
    if reverse:
        hs = torch.gather(hs, 1, rev[..., None].expand_as(hs))
    return torch.where(valid[..., None], hs, 0.0), h_final
