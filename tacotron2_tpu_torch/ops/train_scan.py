"""Teacher-forced decode on stock ops, step by step: the route of an F32
model's train step, and of a tensor-parallel one, whose decoder's two LSTM
cells are column-parallel over the model group.

Counterpart of ``tacotron2_tpu/ops/train_scan.py``, the XLA scan with
hoisted weight gradients (``run_decode_scan``) that the JAX package runs
wherever its Pallas training kernels do not (``Tacotron2.forward_teacher``):
under any policy but bf16 (``pallas_train_supported`` is false there: the
kernels pin DEFAULT precision, the XLA scan keeps f32 products) and on a mesh
with a "model" axis (the kernels need whole weights). Here too kernels K3 /
K4 do not run there: stock PyTorch ops carry the decode, f32 products with
TF32 off on the card (``layers.use_f32_math``): the forward is
``ops/train_decode.py``'s ``teacher_steps`` (with a model group, or none;
the two cells' widths H1 and H2 apart, as a model whose two LSTM widths
differ takes this route in its teacher-forced eval),
the backward shares its ``attention_pull`` and ``_lstm_pull``, and the
weight gradients are its ``grads_from``, on its residual contract. Without a
model group a rank holds every unit and nothing is gathered or reduced.

A model rank holds the i, f, g and o rows of its H / m units of each cell
(``parallel/mesh.py::unit_slice``: W1 and W2 as (4H / m, R) slices):

- forward: each step computes its units' gates, cell state and h (times its
  columns of the dropout mask), then all-gathers h (B, H / m -> B, H) for
  the attention, the next cell's input and the heads, which every rank
  computes whole;
- backward: the reverse pass pulls its units' gate cotangents dg (B, 4H /
  m) and all-reduces each step's d(xh) = dg . W over the model group
  (``reduce_dxh``);
- the hoisted weight gradient of its rows is one local GEMM over all T * B
  rows, dg_stack^T . xh_stack, with no collective; the replicated weights'
  gradients are the same on every model rank.

The residuals keep, beyond ``Residuals``, the f32 att_h and rnn_h after
dropout of every step, so the backward gathers nothing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tacotron2_tpu_torch.ops.decoder_loop import _acc, _rnd
from tacotron2_tpu_torch.ops.train_decode import (DECODER_PARAMS, BackwardOut, Residuals,
                                                  TrainWeights, _controls_dim, _gates,
                                                  _lstm_pull, attention_pull, grads_from,
                                                  pack_weights, packed_dims, pad_controls,
                                                  teacher_steps, unit_columns)
from tacotron2_tpu_torch.ops import build
from tacotron2_tpu_torch.parallel import mesh

# teacher-forced decodes on this route (no K3 / K4 launch): F32 models, a
# tensor-parallel step, a model whose two LSTM widths differ
STOCK_ROUTES = {"teacher_scan": 0}


class Hidden(NamedTuple):
    att_h: torch.Tensor  # (T, B, H) f32: the attention LSTM's h after dropout, each step
    rnn_h: torch.Tensor  # (T, B, H) f32: the decoder LSTM's, the heads' input


def reduce_dxh(x: torch.Tensor, mp: Optional[mesh.ModelParallel]) -> torch.Tensor:
    """A step's d(xh) = dg . W of this rank's units, summed over the model
    group (without one, every unit's: ``x`` itself)."""
    return x if mp is None else mesh.model_sum_(x, mp)


def teacher_forward_tp(w: TrainWeights, decoder_in, encoded, att_enc, lengths, dm1, dm2, ctl,
                       mp: Optional[mesh.ModelParallel]):
    """``train_decode.teacher_steps`` on a model rank: ``w``'s cells the
    rank's unit rows (every row without a model group), dm1 / dm2 (T, B, H)
    the whole masks. -> (mel_gate (T, B, M + 1), Residuals with this rank's
    units of the cell states, Hidden)."""
    mel_gate, res, hs = teacher_steps(w, decoder_in, encoded, att_enc, lengths, dm1, dm2, ctl,
                                      mp)
    return mel_gate, res, Hidden(*hs)


def teacher_backward_tp(w: TrainWeights, res: Residuals, hid: Hidden, encoded, att_enc, lengths,
                        dm1, dm2, d_mel_gate, d_align,
                        mp: Optional[mesh.ModelParallel]) -> BackwardOut:
    """``teacher_backward_plain`` with this rank's units of the cells: its
    dg1 / dg2 stacks are (T, B, 4H / m), every other field whole and the
    same on every model rank (d(xh) summed over the group each step). The
    attention and the heads read the forward's gathered h (``hid``)."""
    T, B, R1 = res.xh1.shape
    L, D = encoded.shape[1], encoded.shape[2]
    H, _, E = packed_dims(w, D, mp)
    own = unit_columns(mp, H)
    P = R1 - D - H
    cd = w.w1.dtype
    W1, W2, wq, wl, wv, wout = (_acc(t) for t in (w.w1, w.w2, w.wq, w.w_loc, w.wv, w.w_out))
    enc = _acc(encoded)
    G1 = _acc(res.xh1) @ W1.t() + w.b1
    G2 = _acc(res.xh2) @ W2.t() + w.b2
    z = lambda *s: d_align.new_zeros(*s)
    h4 = w.w1.shape[0]
    dg1, dg2 = z(T, B, h4).to(cd), z(T, B, h4).to(cd)
    dxh1, dctx, dq = z(T + 1, B, R1), z(T, B, D), z(T, B, w.wq.shape[0])
    sums = (z(*att_enc.shape), z(B, wq.shape[0]), z(B, *wl.shape))  # d_attenc, d_wv, d_wloc
    d_att_c, d_rnn_c = z(B, h4 // 4), z(B, h4 // 4)
    d_rnn_h, d_ctrl, d_w, d_cum = z(B, H), z(B, E), z(B, L), z(B, L)
    pad = torch.arange(L, device=enc.device)[None, :] >= lengths[:, None]
    for t in range(T - 1, -1, -1):
        # decoder LSTM (this rank's units) and heads (whole)
        d_headin = _rnd(d_mel_gate[t], w.w_out) @ wout  # (B, H + D + E)
        dg, d_rnn_c = _lstm_pull(_gates(G2[t]), res.c_rnn[t], (d_headin[:, :H] + d_rnn_h)[:, own],
                                 dm2[t, :, own], d_rnn_c)
        dg2[t] = dg.to(cd)
        dx2 = reduce_dxh(_acc(dg2[t]) @ W2, mp)
        d_ctrl = d_ctrl + (d_headin[:, H + D:] + dx2[:, H + D:H + D + E])
        d_rnn_h = dx2[:, H + D + E:]
        dc = dxh1[t + 1, :, P:P + D] + d_headin[:, H:H + D] + dx2[:, H:H + D]
        dctx[t] = dc
        # attention, recomputed from the forward's att_h
        dws = d_w + d_align[t] + d_cum + torch.einsum("bd,bld->bl", _rnd(dc, encoded), enc)
        dq[t], d_win = attention_pull(w, (wq, wl, wv), hid.att_h[t], res.al[t], res.cum[t], dws,
                                      encoded, att_enc, pad, sums)
        d_w, d_cum = d_win[:, 0], d_cum + d_win[:, 1]
        # attention LSTM (this rank's units)
        d_hd = dxh1[t + 1, :, P + D:] + dx2[:, :H] + dq[t] @ wq
        dg, d_att_c = _lstm_pull(_gates(G1[t]), res.c_att[t], d_hd[:, own], dm1[t, :, own],
                                 d_att_c)
        dg1[t] = dg.to(cd)
        dxh1[t] = reduce_dxh(_acc(dg1[t]) @ W1, mp)
    return BackwardOut(dg1, dg2, dxh1, dctx, dq, hid.rnn_h.to(cd), *sums, d_ctrl)


class TeacherDecodeTP(torch.autograd.Function):
    """``train_decode.TeacherDecode``'s function and gradients on a model
    rank: the same arguments after the model group, the cells' four
    parameters each this rank's unit rows. The gradients of the inputs and
    of the replicated parameters are whole, those of the cells' slices."""

    @staticmethod
    def forward(ctx, compute_dtype, mp, decoder_in, encoded, att_encoded, lengths, dm1, dm2,
                controls, *params):
        C = _controls_dim(params)
        w = pack_weights(params, compute_dtype, C)
        ctl = pad_controls(controls, C, decoder_in[0])
        enc = encoded.to(compute_dtype)
        lens = lengths.to(torch.int32)
        mel_gate, res, hid = teacher_forward_tp(w, decoder_in, enc, att_encoded, lens, dm1, dm2,
                                                ctl, mp)
        ctx.mp, ctx.w, ctx.res, ctx.hid, ctx.enc, ctx.lens = mp, w, res, hid, enc, lens
        ctx.save_for_backward(att_encoded, dm1, dm2, *params)
        M = mel_gate.shape[2] - 1
        return mel_gate[..., :M], mel_gate[..., M], res.al[1:]

    @staticmethod
    def backward(ctx, d_mels, d_gates, d_aligns):
        att, dm1, dm2, *params = ctx.saved_tensors
        acc = ctx.res.c_att.dtype
        d_mel_gate = torch.cat([d_mels, d_gates[..., None]], dim=2).to(acc)
        out = teacher_backward_tp(ctx.w, ctx.res, ctx.hid, ctx.enc, att, ctx.lens, dm1, dm2,
                                  d_mel_gate, d_aligns.to(acc), ctx.mp)
        d_prenet, d_enc, d_attenc, d_ctrl, *d_params = grads_from(params, ctx.w, ctx.res,
                                                                  ctx.enc, out, d_mel_gate,
                                                                  ctx.mp)
        d_ctrl = d_ctrl if ctx.needs_input_grad[8] else None
        return (None, None, d_prenet, d_enc, d_attenc, None, None, None, d_ctrl, *d_params)


def teacher_decode(decoder, decoder_in, encoded, att_encoded, lengths, dm1, dm2,
                   compute_dtype: torch.dtype, controls: Optional[torch.Tensor] = None):
    """``TeacherDecodeTP`` over a ``models.decoder.Decoder`` module: in a
    step with a model group (``mesh.model_parallel``) its cells hold this
    model rank's slices; without one (an F32 model's step, JAX's
    ``run_decode_scan``) they are whole."""
    mp = mesh.model_parallel()
    build.count(STOCK_ROUTES, "teacher_scan")
    named = dict(decoder.named_parameters())
    return TeacherDecodeTP.apply(compute_dtype, mp, decoder_in, encoded, att_encoded, lengths,
                                 dm1, dm2, controls, *(named[k] for k in DECODER_PARAMS))
