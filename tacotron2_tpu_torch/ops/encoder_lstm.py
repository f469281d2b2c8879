"""The encoder's BiLSTM recurrence under the bf16 policy, and its pull.

Counterpart of the scan in ``tacotron2_tpu/models/layers.py::lstm_sequence``
(XLA, not a Pallas kernel) for both directions at once: given the input
projections ``xp`` (2, B, T, 4H) of every step (+ b_ih), step s computes
``g = (xp[:, :, s] + bf16(h) . W_hh^T) + b_hh`` with bf16 operands and f32
sums, then ``c = sig(f) c + sig(i) tanh(g)``, ``h = sig(o) tanh(c)``, h and c
kept in f32. ``BiLSTMRecurrence`` is its autograd function: the backward
walks the steps in reverse, pulls each step's gate cotangents from the saved
activations, and passes ``bf16(dg . W_hh)`` to the step before (the
cotangent of the bf16-rounded operand, rounded as autograd and JAX round
it); d_W_hh is one product over all steps after the loop, rounded to bf16
once (the cast's pull), as autograd through the plain loop computes it.

On the card ``bilstm_forward`` is one launch of ``csrc/encoder_lstm.cu``'s
persistent forward (``t2_bilstm_forward``: a thread-block cluster of
``ENC_CLUSTER`` blocks per direction and tile of up to ``ENC_TILE`` rows
walks all T steps, W_hh, h and c on chip; ``forward_plan`` says which dims
it takes) and ``bilstm_backward`` one launch of its persistent backward
(``t2_bilstm_backward``: the same clusters walk the steps in reverse, each
rank's W_hh columns held as tensor-core fragments, dc in registers, the
gate cotangents pushed to every rank a step; ``backward_plan``); each adds
its launches to ``LAUNCHES``. Their plain versions are
the definition, used for CPU tensors and as what the kernels are held
against on the card; they keep the dtype of ``xp``, so they also run in f64
(the tests).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from tacotron2_tpu_torch.ops import build

LAUNCHES = {"bilstm_forward": 0, "bilstm_backward": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


ENC_CLUSTER = 8  # blocks per cluster of the forward: the units' split (csrc ES)
ENC_TILE = 8  # batch rows per cluster (csrc ETILE)
ENC_MAX_WARPS = 16  # a block's warps: one per m16 tile of its gate rows (csrc EMAXWARPS)
ENC_SMEM = 227 * 1024  # shared memory a block may use


def forward_launches(T: int) -> int:
    return 1


def backward_launches(T: int) -> int:
    return 1


ENC_BWD_H = (128, 256)  # the backward's widths: its template instances (csrc bwd_check)
ENC_BWD_KSPLIT = 4  # K quarters of its product, a warp per (m16 tile, quarter) (csrc BKS)


def unit_rows(H: int, rank: int) -> list:
    """W_hh rows (of one direction, 4H) that block ``rank`` of the forward's
    cluster holds, in its shared-memory order: row 16 mt + i is gate i // 4
    of unit rank EU + 4 mt + i % 4 (EU = H / ENC_CLUSTER), so that a lane
    and the lane 16 away hold the four gates of one unit."""
    EU = H // ENC_CLUSTER
    rows = []
    for mt in range(4 * EU // 16):
        rows += [(i // 4) * H + rank * EU + 4 * mt + i % 4 for i in range(16)]
    return rows


def forward_plan(B: int, H: int) -> dict:
    """The forward kernel's plan for B rows of width H: EU units a rank,
    ``warps`` (one m16 tile of its 4 EU gate rows each), ``rows`` of a
    cluster's tile (padded to 8), the grid's ``clusters`` and a block's
    shared memory ``smem`` (W's rows, two h buffers, the rank's own h, xp
    of two steps; rows 16 bytes longer than their data). Raises ValueError
    for what the kernel does not take: EU not a multiple of 8 (whole
    16-byte pieces of h), more than ENC_MAX_WARPS warps, or more than
    ENC_SMEM bytes."""
    EU = H // ENC_CLUSTER
    if B < 1 or H < 1 or H % (8 * ENC_CLUSTER):
        raise ValueError(f"the forward's cluster of {ENC_CLUSTER} blocks takes H a multiple of "
                         f"{8 * ENC_CLUSTER} (units a rank a multiple of 8); got H={H}")
    warps = 4 * EU // 16
    if warps > ENC_MAX_WARPS:
        raise ValueError(f"H={H}: {warps} warps a block, at most {ENC_MAX_WARPS}")
    rows = (min(B, ENC_TILE) + 7) // 8 * 8
    stride = 2 * H + 16
    smem = (32 + 4 * EU * stride + 2 * rows * stride + rows * EU * 2
            + 2 * rows * (4 * EU + 4) * 4)
    if smem > ENC_SMEM:
        raise ValueError(f"H={H}: the forward's block would need {smem} bytes of shared memory "
                         f"at {rows} rows; at most {ENC_SMEM}")
    return {"units": EU, "warps": warps, "rows": rows, "smem": smem,
            "clusters": 2 * -(-B // ENC_TILE)}


def backward_plan(B: int, H: int) -> dict:
    """The backward kernel's plan for B rows of width H: EU units a rank
    (whole m16 tiles), ``warps`` (EU / 4: one per (m16 tile, K quarter) in
    the product, one thread per (row, unit) in the pull), ``a_regs`` (a
    thread's registers of W's fragments, H / 4), the grid's ``clusters``
    and a block's shared memory ``smem`` (two dg buffers of hi and lo, the
    rank's own hi and lo, act / cs / dhs of two steps, the product's
    partial sums). Raises ValueError for what the kernel does not take: H
    other than its template instances ENC_BWD_H (EU a multiple of 16, W's
    fragments in registers)."""
    if B < 1 or H not in ENC_BWD_H:
        raise ValueError(f"the backward takes H in {ENC_BWD_H} (its template instances: whole "
                         f"m16 tiles of units a rank, W's fragments in registers); got B={B}, "
                         f"H={H}")
    EU = H // ENC_CLUSTER
    stride = 8 * H + 16
    smem = (32 + 2 * 2 * ENC_TILE * stride + 2 * ENC_TILE * 4 * EU * 2
            + 2 * ENC_TILE * (6 * EU + 4) * 4 + ENC_BWD_KSPLIT * ENC_TILE * EU * 4)
    return {"units": EU, "warps": EU // 4, "a_regs": H // 4, "smem": smem,
            "clusters": 2 * -(-B // ENC_TILE)}


def _rnd(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16, keep the dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def bilstm_forward_plain(xp, w_hh, b_hh) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xp (2, B, T, 4H), w_hh (2, 4H, H) bf16 (or bf16 values in a wider
    type), b_hh (2, 4H) -> hs, cs (2, B, T, H) and the activated gates act
    (2, B, T, 4H), all in xp's dtype."""
    _, B, T, G = xp.shape
    H = G // 4
    w_t = w_hh.to(xp.dtype).transpose(1, 2)
    h = c = xp.new_zeros(2, B, H)
    hs, cs, acts = [], [], []
    for s in range(T):
        g = (xp[:, :, s] + torch.bmm(_rnd(h), w_t)) + b_hh[:, None, :]
        i, f, gg, o = g.chunk(4, dim=-1)
        i, f, gg, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(gg), torch.sigmoid(o)
        c = f * c + i * gg
        h = o * torch.tanh(c)
        hs.append(h)
        cs.append(c)
        acts.append(torch.cat([i, f, gg, o], dim=-1))
    st = lambda xs: torch.stack(xs, dim=2)
    return st(hs), st(cs), st(acts)


def bilstm_backward_plain(dhs, act, cs, w_hh) -> torch.Tensor:
    """dhs (2, B, T, H), the forward's act and cs, w_hh (2, 4H, H) -> the
    gate cotangents dg (2, B, T, 4H) (also the cotangent of xp)."""
    _, B, T, H = dhs.shape
    W = w_hh.to(dhs.dtype)
    dg = dhs.new_zeros(2, B, T, 4 * H)
    dh_rec, dc = dhs.new_zeros(2, B, H), dhs.new_zeros(2, B, H)
    for s in range(T - 1, -1, -1):
        i, f, gg, o = act[:, :, s].chunk(4, dim=-1)
        cv = cs[:, :, s]
        c_prev = cs[:, :, s - 1] if s > 0 else torch.zeros_like(cv)
        tc = torch.tanh(cv)
        dh = dhs[:, :, s] + dh_rec
        dcv = dc + dh * o * (1 - tc * tc)
        g = torch.cat([dcv * gg * i * (1 - i), dcv * c_prev * f * (1 - f), dcv * i * (1 - gg * gg),
                       dh * tc * o * (1 - o)], dim=-1)
        dg[:, :, s] = g
        dc = dcv * f
        dh_rec = _rnd(torch.bmm(g, W))
    return dg


_LIB = None
Ptr = ctypes.c_void_p
Int = ctypes.c_int


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("encoder_lstm")
        for fn in (lib.t2_bilstm_forward, lib.t2_bilstm_backward):
            fn.argtypes = [ctypes.POINTER(Ptr), ctypes.POINTER(Int), Ptr]
            fn.restype = Int
        _LIB = lib
    return _LIB


def _call(fn, tensors, B: int, T: int, H: int, what: str) -> None:
    ptrs = (Ptr * len(tensors))(*(t.data_ptr() for t in tensors))
    build.check(fn(ptrs, (Int * 3)(B, T, H), torch.cuda.current_stream().cuda_stream), what)


def bilstm_forward(xp, w_hh, b_hh):
    """``bilstm_forward_plain`` through ``t2_bilstm_forward`` (one launch)
    for CUDA tensors (w_hh bf16)."""
    if xp.device.type == "cpu":
        return bilstm_forward_plain(xp, w_hh, b_hh)
    _, B, T, G = xp.shape
    H = G // 4
    build.require(xp, torch.float32, (2, B, T, G), "xp")
    build.require(w_hh, torch.bfloat16, (2, G, H), "w_hh")
    build.require(b_hh, torch.float32, (2, G), "b_hh")
    forward_plan(B, H)  # raises for dims the kernel does not take
    e = lambda *s: torch.empty(*s, device=xp.device)
    hs, cs, act = e(2, B, T, H), e(2, B, T, H), e(2, B, T, G)
    build.count(LAUNCHES, "bilstm_forward", forward_launches(T))
    _call(_lib().t2_bilstm_forward, (xp, w_hh, b_hh, hs, cs, act), B, T, H, "bilstm_forward")
    return hs, cs, act


def bilstm_backward(dhs, act, cs, w_hh):
    """``bilstm_backward_plain`` through ``t2_bilstm_backward`` (one launch)
    for CUDA tensors (w_hh bf16)."""
    if dhs.device.type == "cpu":
        return bilstm_backward_plain(dhs, act, cs, w_hh)
    _, B, T, H = dhs.shape
    for name, t, dt, shape in (("dhs", dhs, torch.float32, (2, B, T, H)),
                               ("act", act, torch.float32, (2, B, T, 4 * H)),
                               ("cs", cs, torch.float32, (2, B, T, H)),
                               ("w_hh", w_hh, torch.bfloat16, (2, 4 * H, H))):
        build.require(t, dt, shape, name)
    backward_plan(B, H)  # raises for dims the kernel does not take
    dg = torch.empty(2, B, T, 4 * H, device=dhs.device)
    build.count(LAUNCHES, "bilstm_backward", backward_launches(T))
    _call(_lib().t2_bilstm_backward, (dhs, act, cs, w_hh, dg), B, T, H, "bilstm_backward")
    return dg


class BiLSTMRecurrence(torch.autograd.Function):
    """(xp (2, B, T, 4H), w_hh (2, 4H, H), b_hh (2, 4H)) -> hs (2, B, T, H):
    the recurrence under the bf16 policy; gradients of all three."""

    @staticmethod
    def forward(ctx, xp, w_hh, b_hh):
        on_card = xp.device.type != "cpu"
        wb = w_hh.to(torch.bfloat16).contiguous() if on_card else _rnd(w_hh)
        hs, cs, act = bilstm_forward(xp.contiguous(), wb, b_hh.contiguous())
        ctx.save_for_backward(hs, cs, act, wb)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        hs, cs, act, wb = ctx.saved_tensors
        dg = bilstm_backward(dhs.contiguous(), act, cs, wb)
        h_prev = _rnd(torch.cat([torch.zeros_like(hs[:, :, :1]), hs[:, :, :-1]], dim=2))
        d_w = _rnd(torch.einsum("dbtg,dbth->dgh", dg, h_prev))
        return dg, d_w, dg.sum(dim=(1, 2))
