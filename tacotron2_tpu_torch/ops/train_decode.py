"""Teacher-forced decode of training: kernels K3 (forward) and K4 (backward)
and the ``TeacherDecode`` autograd function around them.

Replaces ``tacotron2_tpu/ops/train_decode_pallas.py`` (``_teacher_step_kernel``
and ``_teacher_bwd_kernel``) and keeps the residual contract of
``tacotron2_tpu/ops/train_scan.py``: the forward stacks, per step, the
compute-dtype LSTM inputs xh1 = [prenet | ctx | att_h] and xh2 = [att_h_d |
ctx | controls | rnn_h], the cell states, the previous and cumulative
attention weights; the backward walks t = T-1 .. 0, recomputes each step from
them, pulls the cotangents through heads -> decoder LSTM -> location
attention -> attention LSTM, and stacks the gate cotangents dg1/dg2. The two
fat weight gradients are then two GEMMs over all T * B rows
(``_split_big_small`` / ``_merge_dw``: b_ih and b_hh receive the same db).

A controllable model's C controls (B, C) are inputs of the decoder LSTM and
of the mel head at every step (JAX ``_pack_training_weights``): their
columns of W2 and of the mel rows of ``w_out`` are padded to E = C rounded up
to 16 with zero columns, the gate row is zero there (the gate reads [rnn_h |
ctx] only), and every step's xh2 holds the controls, zero-padded to E. The
reverse pass sums the controls' cotangent over the steps (``d_ctrl``), from
the heads and from the decoder LSTM's input. A model without controls has E
= 0: a zero-width segment, the layouts and kernels of the vanilla model.

The LSTM dropout masks dm1, dm2 (keep 0.9, scale 1/0.9) are inputs, drawn
outside from a ``torch.Generator`` (``lstm_masks``), so the tests can inject
JAX's. The carried att_h and rnn_h are the values after dropout.

On the card ``teacher_forward`` is one host call into ``csrc/train_decode.cu``
(``t2_teacher_forward``, 2 + 3 launches a step, two of them the gate GEMM
with its LSTM epilogue) and ``teacher_backward`` another
(``t2_teacher_backward``, 4 + 4 launches a step); each wrapper adds its own
launches to ``LAUNCHES``, and those of a call with controls also to
``CONTROLS_LAUNCHES`` (the controls add no launch). Both run the attention
of a step on a cluster of ``attention_cluster`` blocks per batch row. Their plain
versions below are the definition: same operand
rounding (bf16 operands, f32 sums, bf16 residual and dg stacks), used for
CPU tensors and as what the kernels are held against on the card. The plain
versions keep the sum type of the weights, so they also run in f64 (the
gradient check).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from tacotron2_tpu_torch.ops import build
from tacotron2_tpu_torch.parallel import mesh
from tacotron2_tpu_torch.ops.decoder_loop import (
    CONTROLS_ALIGN,
    MAX_CLUSTER,
    _acc,
    _rnd,
    check_cluster_dims,
    controls_cols,
    heads_plain,
    location_attention_plain,
    lstm_cell_plain,
)

KEEP = 0.9  # LSTM dropout keep probability (decoder.py: dropout 0.1)

# launches of each kernel; counted only where the kernel is launched
LAUNCHES = {"teacher_forward": 0, "teacher_backward": 0}
# of those, the launches of calls with controls (their controls rows), so a
# run can show that a controllable model's training went through them
CONTROLS_LAUNCHES = {"teacher_forward": 0, "teacher_backward": 0}

# K3's and K4's step loops launch with programmatic dependent launch (each
# launch may start, and stream its weights, while the previous one ends);
# False only to check and time the difference
_PDL = True

# the decoder's parameters that TeacherDecode differentiates, in its order
DECODER_PARAMS = (
    "att_rnn.weight_ih", "att_rnn.weight_hh", "att_rnn.bias_ih", "att_rnn.bias_hh",
    "lstm.weight_ih", "lstm.weight_hh", "lstm.bias_ih", "lstm.bias_hh",
    "attention.query_layer.weight", "attention.v.weight",
    "attention.location_conv.weight", "attention.location_dense.weight",
    "mel_out.weight", "mel_out.bias", "gate.weight", "gate.bias",
)


def reset_launches() -> None:
    for table in (LAUNCHES, CONTROLS_LAUNCHES):
        for k in table:
            table[k] = 0


def forward_launches(T: int) -> int:
    """K3's launches for T steps: the prenet slice of the residual stack and
    the gate GEMM's tiled weights once, then per step two gate GEMMs and the
    attention, then the heads of every step at once."""
    return 2 + 3 * T


def backward_launches(T: int) -> int:
    """K4's launches for T steps: the two gate recomputes, the query
    projection and the heads' pull of every step once, then per step the
    decoder-LSTM pull, two dx GEMMs and the attention pull (with the
    query's and the attention LSTM's pulls)."""
    return 4 + 4 * T


def cluster_size(B: int, sms: int) -> int:
    """Blocks per batch row of K3's and K4's attention: the largest power of
    two up to ``MAX_CLUSTER`` with ``B * S <= sms`` (one wave on a card of
    ``sms`` SMs), at least 1. S = 4 at B = 32 on 132 SMs."""
    if B < 1 or sms < 1:
        raise ValueError(f"cluster_size: want B >= 1 and sms >= 1, got B={B}, sms={sms}")
    s = MAX_CLUSTER
    while s > 1 and B * s > sms:
        s //= 2
    return s


CL_THREADS = 512  # csrc/decode_common.cuh kClThreads: a cluster attention block's threads
SMEM_LIMIT = 227 * 1024  # the dynamic shared memory one Hopper block may opt in to


def att_smem_bytes(bwd: bool, L: int, S: int, H: int, A: int, D: int, K: int) -> int:
    """The dynamic shared memory of K3's (``bwd`` False) or K4's cluster
    attention block: ``csrc/decode_common.cuh::att_smem``, mirrored (each
    array rounded up to 4 floats). A rank holds its ceil(L / S) chars' slice,
    so at S = 1 K4's grows by ~784 bytes a char and passes ``SMEM_LIMIT``
    past L = 216 (H = 1024, A = 128, K = 31)."""
    up4 = lambda n: (n + 3) & ~3
    ch4 = up4(-(-L // S))
    arrays = [2 * K * A, H, A, A, 2 * (ch4 + K - 1) + 4, ch4, 4]
    if bwd:
        NG = CL_THREADS // A
        arrays += [(ch4 + K - 1) * A, ch4, D, NG * A, NG * A, A, A, A,
                   max(2 * K * A, ch4 * A // 2)]
    else:
        arrays += [(A // 4) * ch4, D]
    return 4 * sum(up4(n) for n in arrays)


def attention_cluster(B: int, sms: int, L: int, H: int, A: int, D: int, K: int) -> int:
    """K3's and K4's cluster size S: ``cluster_size``'s (one wave), doubled
    while K4's attention block at S would need more than ``SMEM_LIMIT`` of
    shared memory (long texts at many rows: S = 1, B = 128's, takes L <= 216
    at the configs' widths; a larger S runs the rows in more than one
    wave)."""
    S = cluster_size(B, sms)
    while S < MAX_CLUSTER and att_smem_bytes(True, L, S, H, A, D, K) > SMEM_LIMIT:
        S *= 2
    return S


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


class TrainWeights(NamedTuple):
    """The decoder's weights in the kernels' layouts (``_split_big_small``)."""

    w1: torch.Tensor  # (4H, P + D + H) cols [prenet | ctx | att_h]
    b1: torch.Tensor  # (4H,) b_ih + b_hh, sum type
    w2: torch.Tensor  # (4H, 2H + D + E) cols [att_h | ctx | controls (zero past C) | rnn_h]
    b2: torch.Tensor
    wq: torch.Tensor  # (A, H)
    w_loc: torch.Tensor  # (A, 2, K) location conv folded with the location dense
    wv: torch.Tensor  # (A,)
    w_out: torch.Tensor  # (M + 1, H + D + E) rows 0..M-1 mel, row M gate (zero over controls)
    b_out: torch.Tensor  # (M + 1,) sum type


class Residuals(NamedTuple):
    """What the forward keeps for the backward. The four state stacks have
    T + 1 slots: slot 0 is the (zero) initial state, slot t + 1 the state
    after step t, so step t's previous state is slot t."""

    xh1: torch.Tensor  # (T, B, P + D + H) compute dtype
    xh2: torch.Tensor  # (T, B, 2H + D + E) compute dtype [att_h | ctx | controls | rnn_h]
    c_att: torch.Tensor  # (T + 1, B, H)
    c_rnn: torch.Tensor  # (T + 1, B, H)
    al: torch.Tensor  # (T + 1, B, L) attention weights; al[1:] are the aligns
    cum: torch.Tensor  # (T + 1, B, L) cumulative weights


class BackwardOut(NamedTuple):
    dg1: torch.Tensor  # (T, B, 4H) compute dtype
    dg2: torch.Tensor  # (T, B, 4H) compute dtype
    dxh1: torch.Tensor  # (T + 1, B, P + D + H), slot T zero; [:T, :, :P] = d_prenet
    dctx: torch.Tensor  # (T, B, D) the context's whole cotangent per step
    dq: torch.Tensor  # (T, B, A) the query projection's cotangent
    head_h: torch.Tensor  # (T, B, H) compute dtype: rnn_h after dropout (heads input)
    d_attenc: torch.Tensor  # (B, L, A)
    d_wv: torch.Tensor  # (B, A) per batch row; summed after
    d_wloc: torch.Tensor  # (B, A, 2, K) per batch row; summed after
    d_ctrl: torch.Tensor  # (B, E) the controls' cotangent summed over the steps (zero past C)


def pack_weights(params: Sequence[torch.Tensor], dtype: torch.dtype,
                 controls_dim: int = 0) -> TrainWeights:
    """``DECODER_PARAMS`` tensors -> kernel layouts, weights in ``dtype``;
    the last ``controls_dim`` input columns of the decoder LSTM and of the
    mel head are the controls', padded to ``controls_cols`` with zeros, and
    the gate row gets zeros there. Differentiable (the reference loop in the
    tests differentiates it)."""
    (a_ih, a_hh, ab_ih, ab_hh, d_ih, d_hh, db_ih, db_hh, wq, v, conv, dense,
     mel_w, mel_b, gate_w, gate_b) = params
    acc = torch.promote_types(dtype, torch.float32)
    c = lambda t: t.to(dtype).contiguous()
    w_loc = torch.einsum("af,fck->ack", dense.to(acc), conv.to(acc))
    C = controls_dim
    E = controls_cols(C)
    pad_ctl = lambda w: torch.cat([w[:, :w.shape[1] - C], F.pad(w[:, w.shape[1] - C:],
                                                                (0, E - C))], dim=1)
    return TrainWeights(
        w1=c(torch.cat([a_ih, a_hh], dim=1)), b1=(ab_ih + ab_hh).to(acc),
        w2=c(torch.cat([pad_ctl(d_ih), d_hh], dim=1)), b2=(db_ih + db_hh).to(acc),
        wq=c(wq), w_loc=c(w_loc), wv=c(v[0]),
        w_out=c(torch.cat([pad_ctl(mel_w), F.pad(gate_w, (0, E))], dim=0)),
        b_out=torch.cat([mel_b, gate_b]).to(acc),
    )


def _controls_dim(params: Sequence[torch.Tensor]) -> int:
    """C of ``DECODER_PARAMS`` tensors: the mel head's inputs beyond the
    gate's."""
    named = dict(zip(DECODER_PARAMS, params))
    return named["mel_out.weight"].shape[1] - named["gate.weight"].shape[1]


def packed_dims(w: TrainWeights, D: int, mp: Optional[mesh.ModelParallel] = None
                ) -> Tuple[int, int, int]:
    """(H1, H2, E) of packed weights, with D the encoder's width: the
    attention LSTM's width H1 (``att_rnn_dim``), the decoder LSTM's H2
    (``rnn_hidden_dim``; ``w.w2``'s rows are this model rank's 4 H2 / m
    with a model group ``mp``), and E, what W2's columns hold beyond [att_h
    | ctx | rnn_h]. The kernels take H1 == H2."""
    H1 = w.wq.shape[1]
    H2 = w.w2.shape[0] // 4 * (1 if mp is None else mp.n)
    return H1, H2, w.w2.shape[1] - H1 - H2 - D


def pad_controls(controls: Optional[torch.Tensor], C: int, like: torch.Tensor) -> torch.Tensor:
    """The controls (B, C) as the teacher pass reads them: (B, E) in the type
    and on the device of ``like`` (B, ...), E = ``controls_cols(C)``, zero
    past C; None -> (B, 0) for a model without controls (C = 0)."""
    B = like.shape[0]
    if controls is None:
        if C:
            raise ValueError("the weights take controls, but none were passed")
        return like.new_zeros(B, 0)
    if tuple(controls.shape) != (B, C):
        raise ValueError(f"want controls of shape ({B}, {C}), got {tuple(controls.shape)}")
    return F.pad(controls.to(like), (0, controls_cols(C) - C)).contiguous()


def lstm_masks(T: int, B: int, H: int, generator, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """LSTM dropout scale masks (T, B, H) x 2 (keep 0.9, 1/0.9); in a
    data-parallel step the global batch's, cut to this rank's B rows."""
    m1 = (mesh.rand_rows((T, B, H), generator, device, 1) < KEEP).float() / KEEP
    m2 = (mesh.rand_rows((T, B, H), generator, device, 1) < KEEP).float() / KEEP
    return m1, m2


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def teacher_forward_plain(w: TrainWeights, decoder_in, encoded, att_enc, lengths, dm1, dm2,
                          ctl=None):
    """T teacher-forced steps from the zero state -> (mel_gate (T, B, M + 1),
    Residuals). decoder_in (T, B, P), encoded (B, L, D) in the compute dtype,
    att_enc (B, L, A), lengths (B,), dm1/dm2 (T, B, H), ctl (B, E) the
    controls zero-padded to the weights' E (``pad_controls``; None where E =
    0). Written without in-place updates, so autograd can also
    differentiate it."""
    mel_gate, res, _ = teacher_steps(w, decoder_in, encoded, att_enc, lengths, dm1, dm2, ctl)
    return mel_gate, res


def unit_columns(mp: Optional[mesh.ModelParallel], H: int) -> slice:
    """The columns of (B, H) that model rank ``mp`` holds the units of; all
    of them without a model group."""
    if mp is None:
        return slice(None)
    h = H // mp.n
    return slice(mp.rank * h, (mp.rank + 1) * h)


def teacher_steps(w: TrainWeights, decoder_in, encoded, att_enc, lengths, dm1, dm2, ctl=None,
                  mp: Optional[mesh.ModelParallel] = None):
    """``teacher_forward_plain``'s steps. With a model group ``mp``, ``w``'s
    cells hold the rank's unit rows (``mesh.unit_slice``): each step computes
    its units' gates, cell state and h (times its columns of the whole
    masks), then all-gathers h for the attention, the next cell and the
    heads, which every rank computes whole. -> (mel_gate, Residuals with
    the rank's units of the cell states, the f32 att_h and rnn_h after
    dropout of every step (T, B, H) x 2)."""
    T, B, _ = decoder_in.shape
    L, D = encoded.shape[1], encoded.shape[2]
    H1, H2, E = packed_dims(w, D, mp)
    if ctl is None:
        ctl = pad_controls(None, E, decoder_in[0])
    own1, own2 = unit_columns(mp, H1), unit_columns(mp, H2)
    gather = (lambda x: x) if mp is None else (lambda x: mesh.gather_columns(x, mp))
    cd = w.w1.dtype
    z = lambda *s: decoder_in.new_zeros(*s)
    att_h, ctx, rnn_h = z(B, H1), z(B, D), z(B, H2)
    c_att, c_rnn = [z(B, w.w1.shape[0] // 4)], [z(B, w.w2.shape[0] // 4)]
    al, cum = [z(B, L)], [z(B, L)]
    xh1, xh2, mel_gate, att_hs, rnn_hs = [], [], [], [], []
    for t in range(T):
        xh1.append(torch.cat([decoder_in[t], ctx, att_h], dim=1).to(cd))
        hl, c = lstm_cell_plain(w.w1, w.b1, decoder_in[t], ctx, att_h, c_att[-1])
        att_h = gather(hl * dm1[t, :, own1])
        c_att.append(c)
        ctx, wt, cm = location_attention_plain(att_h, w.wq, w.w_loc, w.wv, att_enc, encoded,
                                               lengths, al[-1], cum[-1])
        al.append(wt)
        cum.append(cm)
        xh2.append(torch.cat([att_h, ctx, ctl, rnn_h], dim=1).to(cd))
        hl, c = lstm_cell_plain(w.w2, w.b2, att_h, ctx, rnn_h, c_rnn[-1], ctl)
        rnn_h = gather(hl * dm2[t, :, own2])
        c_rnn.append(c)
        att_hs.append(att_h)
        rnn_hs.append(rnn_h)
        mel_gate.append(heads_plain(w.w_out, w.b_out, rnn_h, ctx, ctl=ctl))
    st = torch.stack
    return (st(mel_gate), Residuals(st(xh1), st(xh2), st(c_att), st(c_rnn), st(al), st(cum)),
            (st(att_hs), st(rnn_hs)))


def _gates(g: torch.Tensor):
    i, f, gg, o = g.chunk(4, dim=-1)
    return torch.sigmoid(i), torch.sigmoid(f), torch.tanh(gg), torch.sigmoid(o)


def _lstm_pull(gates, c_prev, d_hd, mask, d_c):
    """-> (dg (B, 4H), d_c_prev) through one cell whose output times
    ``mask`` has cotangent d_hd and whose cell state has cotangent d_c."""
    i, f, g, o = gates
    c = f * c_prev + i * g
    tc = torch.tanh(c)
    dh = d_hd * mask
    dc = d_c + dh * o * (1 - tc * tc)
    dg = torch.cat([dc * g * i * (1 - i), dc * c_prev * f * (1 - f), dc * i * (1 - g * g),
                    dh * tc * o * (1 - o)], dim=1)
    return dg, dc * f


def attention_pull(w: TrainWeights, W, att_h, al, cum, dws, encoded, att_enc, pad, sums):
    """One step's location attention recomputed from its query's att_h and
    its window (al, cum), then pulled back from dws (B, L), the cotangent of
    its weights. ``W`` is (wq, w_loc, wv) in the sum type, ``pad`` the
    (B, L) mask of the padded chars; the step's d_attenc, d_wv and d_wloc are
    added into ``sums``, those three accumulators. -> (dq (B, A), d_win (B,
    2, L), the cotangent of the window)."""
    wq, wl, wv = W
    K = wl.shape[2]
    q = _rnd(_rnd(att_h, w.wq) @ wq.t(), w.wq)
    win = _rnd(torch.stack([al, cum], dim=1), w.w_loc)  # (B, 2, L)
    loc = F.conv1d(win, wl, padding=K // 2).transpose(1, 2)  # (B, L, A)
    th = torch.tanh(q[:, None, :] + loc + att_enc)
    e = (_rnd(th, w.wv) @ wv).masked_fill(pad, float("-inf"))
    wt = torch.softmax(e, dim=1)
    d_attenc, d_wv, d_wloc = sums
    de = wt * (dws - (dws * wt).sum(dim=1, keepdim=True))
    d_wv += torch.einsum("bla,bl->ba", th, de)
    de_pre = de[:, :, None] * wv * (1 - th * th)  # (B, L, A)
    d_attenc += de_pre
    patches = F.pad(win, (K // 2, K // 2)).unfold(2, K, 1)  # (B, 2, L, K)
    d_wloc += torch.einsum("bclk,bla->back", patches, de_pre)
    d_win = F.conv_transpose1d(de_pre.transpose(1, 2), wl, padding=K // 2)  # (B, 2, L)
    return de_pre.sum(dim=1), d_win


def teacher_backward_plain(w: TrainWeights, res: Residuals, encoded, att_enc, lengths, dm1, dm2,
                           d_mel_gate, d_align) -> BackwardOut:
    """The reverse pass (``train_scan._vjp_bwd``, pulled by hand as
    ``_teacher_bwd_kernel`` does). d_mel_gate (T, B, M + 1), d_align
    (T, B, L)."""
    T, B, R1 = res.xh1.shape
    L, D = encoded.shape[1], encoded.shape[2]
    H, _, E = packed_dims(w, D)
    P = R1 - D - H
    cd = w.w1.dtype
    W1, W2, wq, wl, wv, wout = (_acc(t) for t in (w.w1, w.w2, w.wq, w.w_loc, w.wv, w.w_out))
    enc = _acc(encoded)
    # the gate pre-activations of every step: they need no cotangent
    G1 = _acc(res.xh1) @ W1.t() + w.b1
    G2 = _acc(res.xh2) @ W2.t() + w.b2
    z = lambda *s: d_align.new_zeros(*s)
    dg1, dg2 = z(T, B, 4 * H).to(cd), z(T, B, 4 * H).to(cd)
    dxh1, dctx, dq = z(T + 1, B, R1), z(T, B, D), z(T, B, w.wq.shape[0])
    head_h = z(T, B, H).to(cd)
    sums = (z(*att_enc.shape), z(B, wq.shape[0]), z(B, *wl.shape))  # d_attenc, d_wv, d_wloc
    d_att_c, d_rnn_c, d_rnn_h, d_ctrl = z(B, H), z(B, H), z(B, H), z(B, E)
    d_w, d_cum = z(B, L), z(B, L)
    pad = torch.arange(L, device=enc.device)[None, :] >= lengths[:, None]
    for t in range(T - 1, -1, -1):
        # decoder LSTM and heads
        g2 = _gates(G2[t])
        c2 = g2[1] * res.c_rnn[t] + g2[0] * g2[2]
        rnn_h_d = g2[3] * torch.tanh(c2) * dm2[t]
        head_h[t] = rnn_h_d.to(cd)
        d_headin = _rnd(d_mel_gate[t], w.w_out) @ wout  # (B, H + D + E)
        dg, d_rnn_c = _lstm_pull(g2, res.c_rnn[t], d_headin[:, :H] + d_rnn_h, dm2[t], d_rnn_c)
        dg2[t] = dg.to(cd)
        dx2 = _acc(dg2[t]) @ W2
        d_ctrl = d_ctrl + (d_headin[:, H + D:] + dx2[:, H + D:H + D + E])
        d_rnn_h = dx2[:, H + D + E:]
        dc = dxh1[t + 1, :, P:P + D] + d_headin[:, H:H + D] + dx2[:, H:H + D]
        dctx[t] = dc
        # attention, recomputed from the gates' att_h
        g1 = _gates(G1[t])
        c1 = g1[1] * res.c_att[t] + g1[0] * g1[2]
        h = g1[3] * torch.tanh(c1) * dm1[t]
        dws = d_w + d_align[t] + d_cum + torch.einsum("bd,bld->bl", _rnd(dc, encoded), enc)
        dq[t], d_win = attention_pull(w, (wq, wl, wv), h, res.al[t], res.cum[t], dws, encoded,
                                      att_enc, pad, sums)
        d_w, d_cum = d_win[:, 0], d_cum + d_win[:, 1]
        # attention LSTM
        d_hd = dxh1[t + 1, :, P + D:] + dx2[:, :H] + dq[t] @ wq
        dg, d_att_c = _lstm_pull(g1, res.c_att[t], d_hd, dm1[t], d_att_c)
        dg1[t] = dg.to(cd)
        dxh1[t] = _acc(dg1[t]) @ W1
    return BackwardOut(dg1, dg2, dxh1, dctx, dq, head_h, *sums, d_ctrl)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_LIB = None
Ptr = ctypes.c_void_p
Int = ctypes.c_int


def bind(lib):
    """Declare the C entry points of a loaded ``csrc/train_decode.cu`` (the
    build's, or a copy's on the card) -> lib."""
    lib.t2_teacher_forward.argtypes = [ctypes.POINTER(Ptr), ctypes.POINTER(Int), Ptr]
    lib.t2_teacher_backward.argtypes = [ctypes.POINTER(Ptr), ctypes.POINTER(Int), Ptr]
    lib.t2_smem_bytes.argtypes = [Int, ctypes.POINTER(Int)]
    for fn in (lib.t2_teacher_forward, lib.t2_teacher_backward, lib.t2_smem_bytes):
        fn.restype = Int
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = bind(build.load("train_decode"))
    return _LIB


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ptrs(tensors):
    return (Ptr * len(tensors))(*(t.data_ptr() for t in tensors))


def _require_weights(w: TrainWeights, P: int, D: int) -> Tuple[int, int, int, int, int]:
    H, _, E = packed_dims(w, D)
    A, K, N = w.wq.shape[0], w.w_loc.shape[2], w.w_out.shape[0]
    if E < 0 or E % CONTROLS_ALIGN:
        raise ValueError(f"w2 has {w.w2.shape[1]} columns: want 2H + D + E, E a multiple of "
                         f"{CONTROLS_ALIGN}")
    bf, f32 = torch.bfloat16, torch.float32
    for name, t, dt, shape in (
        ("w1", w.w1, bf, (4 * H, P + D + H)), ("b1", w.b1, f32, (4 * H,)),
        ("w2", w.w2, bf, (4 * H, 2 * H + D + E)), ("b2", w.b2, f32, (4 * H,)),
        ("wq", w.wq, bf, (A, H)), ("w_loc", w.w_loc, bf, (A, 2, K)), ("wv", w.wv, bf, (A,)),
        ("w_out", w.w_out, bf, (N, H + D + E)), ("b_out", w.b_out, f32, (N,)),
    ):
        build.require(t, dt, shape, name)
    return H, A, K, N, E


def _count(name: str, n: int, E: int) -> None:
    build.count(LAUNCHES, name, n)
    if E:
        build.count(CONTROLS_LAUNCHES, name, n)


def teacher_forward(w: TrainWeights, decoder_in, encoded, att_enc, lengths, dm1, dm2, ctl=None):
    """``teacher_forward_plain`` through kernel K3 for CUDA tensors; ``ctl``
    (B, E) f32, the padded controls, where the weights have E > 0 controls
    columns (K3 writes them into every step's xh2)."""
    if decoder_in.device.type == "cpu":
        return teacher_forward_plain(w, decoder_in, encoded, att_enc, lengths, dm1, dm2, ctl)
    T, B, P = decoder_in.shape
    L, D = encoded.shape[1], encoded.shape[2]
    H, A, K, N, E = _require_weights(w, P, D)
    f32 = torch.float32
    if ctl is None:
        ctl = pad_controls(None, E, decoder_in[0])
    for name, t, dt, shape in (
        ("decoder_in", decoder_in, f32, (T, B, P)), ("encoded", encoded, torch.bfloat16, (B, L, D)),
        ("att_enc", att_enc, f32, (B, L, A)), ("lengths", lengths, torch.int32, (B,)),
        ("dm1", dm1, f32, (T, B, H)), ("dm2", dm2, f32, (T, B, H)), ("ctl", ctl, f32, (B, E)),
    ):
        build.require(t, dt, shape, name)
    dev = decoder_in.device
    S = attention_cluster(B, _sms(dev), L, H, A, D, K)
    check_cluster_dims(S, H, A, D, K)
    e = lambda *s, dtype=f32: torch.empty(*s, device=dev, dtype=dtype)
    mel_gate = e(T, B, N)
    res = Residuals(e(T, B, P + D + H, dtype=torch.bfloat16),
                    e(T, B, 2 * H + D + E, dtype=torch.bfloat16),
                    e(T + 1, B, H), e(T + 1, B, H), e(T + 1, B, L), e(T + 1, B, L))
    for stack in res[2:]:
        stack[0].zero_()
    rnn_h = torch.empty(T, B, H, device=dev, dtype=torch.bfloat16)  # the heads' input
    # the gate GEMM's tiled copies of w1, w2: rows padded to 64-column tiles
    tiles = [torch.empty(4 * H, -(-t.shape[1] // 64) * 64, device=dev, dtype=torch.bfloat16)
             for t in (w.w1, w.w2)]
    ctl_bf = ctl.to(torch.bfloat16).contiguous()  # the operand K3 writes into xh2
    tensors = (*w, decoder_in, encoded, att_enc, lengths, dm1, dm2, mel_gate, *res, rnn_h, *tiles,
               ctl_bf)
    _count("teacher_forward", forward_launches(T), E)
    build.check(_lib().t2_teacher_forward(
        _ptrs(tensors), (Int * 12)(T, B, P, H, D, L, A, K, N, S, int(_PDL), E), _stream()),
        "teacher_forward")
    return mel_gate, res


def _splits(H4: int) -> int:
    """Splits of the dx GEMMs' 4H contraction (64-wide chunks each), the
    blocks of one cluster."""
    for s in (8, 4, 2, 1):
        if H4 % (64 * s) == 0:
            return s
    raise ValueError(f"4H = {H4} is not a multiple of 64")


def teacher_backward(w: TrainWeights, res: Residuals, encoded, att_enc, lengths, dm1, dm2,
                     d_mel_gate, d_align) -> BackwardOut:
    """``teacher_backward_plain`` through kernel K4 for CUDA tensors. The
    kernel projects the query of every step at once from the forward's own
    att_h (``res.xh2[..., :H]``) where the plain version, as JAX's kernel,
    recomputes it from the gates: the same values up to the order of the
    recomputed gates' sums."""
    if encoded.device.type == "cpu":
        return teacher_backward_plain(w, res, encoded, att_enc, lengths, dm1, dm2,
                                      d_mel_gate, d_align)
    T, B, R1 = res.xh1.shape
    L, D = encoded.shape[1], encoded.shape[2]
    P = R1 - D - w.wq.shape[1]
    H, A, K, N, E = _require_weights(w, P, D)
    R2 = 2 * H + D + E
    bf, f32 = torch.bfloat16, torch.float32
    for name, t, dt, shape in (
        ("encoded", encoded, bf, (B, L, D)), ("att_enc", att_enc, f32, (B, L, A)),
        ("lengths", lengths, torch.int32, (B,)), ("dm1", dm1, f32, (T, B, H)),
        ("dm2", dm2, f32, (T, B, H)), ("d_mel_gate", d_mel_gate, f32, (T, B, N)),
        ("d_align", d_align, f32, (T, B, L)), ("xh1", res.xh1, bf, (T, B, R1)),
        ("xh2", res.xh2, bf, (T, B, R2)), ("c_att", res.c_att, f32, (T + 1, B, H)),
        ("c_rnn", res.c_rnn, f32, (T + 1, B, H)), ("al", res.al, f32, (T + 1, B, L)),
        ("cum", res.cum, f32, (T + 1, B, L)),
    ):
        build.require(t, dt, shape, name)
    SX = _splits(4 * H)
    dev = encoded.device
    S = attention_cluster(B, _sms(dev), L, H, A, D, K)
    check_cluster_dims(S, H, A, D, K)
    e = lambda *s, dtype=f32: torch.empty(*s, device=dev, dtype=dtype)
    zr = lambda *s: torch.zeros(*s, device=dev)
    out = BackwardOut(e(T, B, 4 * H, dtype=bf), e(T, B, 4 * H, dtype=bf), e(T + 1, B, R1),
                      e(T, B, D), e(T, B, A), e(T, B, H, dtype=bf), zr(B, L, A), zr(B, A),
                      zr(B, A, 2, K), zr(B, E))
    out.dxh1[T].zero_()
    scratch = (e(T, B, 4 * H), e(T, B, 4 * H), e(T, B, A), e(T, B, H + D + E), zr(B, R2),
               zr(B, H), zr(B, H), zr(B, L), zr(B, L))
    tensors = (*w[:8], encoded, att_enc, lengths, dm1, dm2, d_mel_gate, d_align, *res, *out[:9],
               *scratch, out.d_ctrl)
    _count("teacher_backward", backward_launches(T), E)
    build.check(_lib().t2_teacher_backward(
        _ptrs(tensors), (Int * 13)(T, B, P, H, D, L, A, K, N, SX, S, int(_PDL), E), _stream()),
        "teacher_backward")
    return out


def smem_bytes(L: int, S: int, H: int, A: int, D: int, K: int) -> dict:
    """The dynamic shared memory of K3's gate GEMM and of the cluster
    attention (forward, backward) at these dims, from the kernels' own plan."""
    d = (Int * 6)(L, S, H, A, D, K)
    return {name: _lib().t2_smem_bytes(i, d)
            for i, name in enumerate(("gate_tma", "att_fwd_cluster", "att_bwd_cluster"))}


# ---------------------------------------------------------------------------
# the autograd function
# ---------------------------------------------------------------------------


def _gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T b over all rows of two (T, B, n) stacks, in the sum type. Where
    both hold bf16 on the card, one product of the bf16 operands with f32
    sums and output (as the JAX package's dot with an f32 result): the f32
    product of the same values up to the order of its sums, without f32
    copies of the stacks and an f32 GEMM (TF32 is off)."""
    a2, b2 = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    if a2.is_cuda and a2.dtype == b2.dtype == torch.bfloat16:
        return torch.mm(a2.t(), b2, out_dtype=torch.float32)
    return _acc(a2).t() @ _acc(b2)


def grads_from(params, w: TrainWeights, res: Residuals, encoded, out: BackwardOut, d_mel_gate,
               mp: Optional[mesh.ModelParallel] = None):
    """``TeacherDecode``'s gradients from the reverse pass's stacks: those
    of decoder_in, encoded, att_encoded and the controls (B, C), then of
    ``DECODER_PARAMS``: dW1 = dg1^T xh1 and dW2 = dg2^T xh2 over all T * B
    rows (dW2's E - C pad columns dropped), the bias sums, d_wq = dq^T h_att,
    d_wout = bf16(dmg)^T [head_h | ctx | controls] (the mel rows over all of
    it, the gate row over [head_h | ctx]), and the folded location window's
    gradient unfolded into the conv and the dense. These products sit
    outside the kernels, as in the JAX package. ``mp``: the model group
    whose rank's unit rows ``w``'s cells hold (``train_scan``)."""
    (a_ih, _, _, _, d_ih, _, _, _, _, _, conv, dense, *_) = params
    T, B, _ = res.xh1.shape
    D = encoded.shape[2]
    H, _, E = packed_dims(w, D, mp)
    M = w.w_out.shape[0] - 1
    C = _controls_dim(params)
    acc = torch.promote_types(w.w1.dtype, torch.float32)
    flat = lambda t: _acc(t).reshape(T * B, -1)
    d_prenet = out.dxh1[:-1, :, :res.xh1.shape[2] - D - H]
    d_enc = torch.einsum("tbl,tbd->bld", _rnd(res.al[1:], encoded), out.dctx)
    dW1, dW2 = _gram(out.dg1, res.xh1), _gram(out.dg2, res.xh2)
    db1, db2 = flat(out.dg1).sum(0), flat(out.dg2).sum(0)
    d_wq = flat(out.dq).t() @ flat(res.xh2[:, :, :H])
    head_in = torch.cat([flat(out.head_h), flat(res.xh2[:, :, H:H + D + E])], dim=1)
    d_wout = flat(_rnd(d_mel_gate, w.w_out)).t() @ head_in
    dmg_sum = d_mel_gate.reshape(T * B, -1).sum(0)
    d_wl = out.d_wloc.sum(0)  # (A, 2, K)
    d_conv = torch.einsum("af,ack->fck", dense.to(acc), d_wl)
    d_dense = torch.einsum("ack,fck->af", d_wl, conv.to(acc))
    n1, n2 = a_ih.shape[1], d_ih.shape[1]  # n2 = H + D + C
    grads = (dW1[:, :n1], dW1[:, n1:], db1, db1, dW2[:, :n2], dW2[:, n2 + E - C:], db2, db2,
             d_wq, out.d_wv.sum(0)[None], d_conv, d_dense,
             d_wout[:M, :H + D + C], dmg_sum[:M], d_wout[M:, :H + D], dmg_sum[M:])
    return (d_prenet, d_enc, out.d_attenc, out.d_ctrl[:, :C],
            *(g.to(p.dtype) for g, p in zip(grads, params)))


class TeacherDecode(torch.autograd.Function):
    """(decoder_in (T, B, P), encoded (B, L, D), att_encoded (B, L, A),
    lengths, dm1, dm2, controls (B, C) or None, *DECODER_PARAMS) -> (mels
    (T, B, M), gates (T, B), aligns (T, B, L)), with ``compute_dtype`` the
    operands' type; C is the decoder's controls_dim (0: no controls). The
    backward returns the gradients of decoder_in, encoded, att_encoded, the
    controls (where they need one) and every parameter."""

    @staticmethod
    def forward(ctx, compute_dtype, decoder_in, encoded, att_encoded, lengths, dm1, dm2,
                controls, *params):
        C = _controls_dim(params)
        w = pack_weights(params, compute_dtype, C)
        ctl = pad_controls(controls, C, decoder_in[0])
        enc = encoded.to(compute_dtype).contiguous()
        att = att_encoded.contiguous()
        lens = lengths.to(torch.int32).contiguous()
        mel_gate, res = teacher_forward(w, decoder_in.contiguous(), enc, att, lens,
                                        dm1.contiguous(), dm2.contiguous(), ctl)
        ctx.w, ctx.res, ctx.enc, ctx.att, ctx.lens = w, res, enc, att, lens
        ctx.save_for_backward(dm1, dm2, *params)
        M = mel_gate.shape[2] - 1
        return mel_gate[..., :M], mel_gate[..., M], res.al[1:]

    @staticmethod
    def backward(ctx, d_mels, d_gates, d_aligns):
        dm1, dm2, *params = ctx.saved_tensors
        w, res = ctx.w, ctx.res
        acc = res.c_att.dtype
        d_mel_gate = torch.cat([d_mels, d_gates[..., None]], dim=2).to(acc).contiguous()
        out = teacher_backward(w, res, ctx.enc, ctx.att, ctx.lens, dm1.contiguous(),
                               dm2.contiguous(), d_mel_gate, d_aligns.to(acc).contiguous())
        d_prenet, d_enc, d_attenc, d_ctrl, *d_params = grads_from(params, w, res, ctx.enc, out,
                                                                  d_mel_gate)
        d_ctrl = d_ctrl if ctx.needs_input_grad[7] else None
        return (None, d_prenet, d_enc, d_attenc, None, None, None, d_ctrl, *d_params)


def teacher_decode(decoder, decoder_in, encoded, att_encoded, lengths, dm1, dm2,
                   compute_dtype: torch.dtype, controls: Optional[torch.Tensor] = None):
    """``TeacherDecode`` over a ``models.decoder.Decoder`` module's
    parameters; ``controls`` (B, controls_dim) for a decoder with controls."""
    named = dict(decoder.named_parameters())
    return TeacherDecode.apply(compute_dtype, decoder_in, encoded, att_encoded, lengths, dm1, dm2,
                               controls, *(named[k] for k in DECODER_PARAMS))
