"""Free-running decode: kernel K1 (one decode step as four CUDA kernels)
and the host loop over 64-frame chunks.

Replaces the TPU kernel ``tacotron2_tpu/ops/decoder_loop_pallas.py::
_decode_chunk_kernel`` in bf16 mode (built by ``FusedDecodeLoop._chunk_call``,
driven by ``FusedDecodeLoop.decode``). That kernel decodes 64 frames per
launch with both LSTM weight blocks resident in VMEM. One H100 SM holds
227 KB of shared memory, not the 35.7 MB block, so each step here is a few
kernels over the whole card (``csrc/decode_step.cu``):

- ``prenet``: two Linear+ReLU layers times the dropout masks, over a
  thread-block cluster of ``PRENET_CLUSTER`` blocks per group of rows,
  each block owning P / 8 units of both layers (their weights from a copy
  tiled once per model, ``tile_prenet``) and sharing its first layer's
  output with the others through distributed shared memory;
- ``lstm_cell`` (twice): the gate GEMM over the concatenated inputs,
  passed as separate pointers, on the tensor cores, with the i/f/g/o
  nonlinearity and the c/h update fused. It streams a copy of the weights
  tiled once per model (``tile_gates``, made by ``pack_decoder``) over a
  thread-block cluster per ``GATE_UNITS`` hidden units that splits the
  contraction, so each weight byte is read once per step whatever the rows
  (up to 64);
- ``location_attention``: query projection, the 31-tap location conv folded
  with its dense layer into one (A, 2, 31) weight, tanh energies, the
  masked softmax, the context and the cumulative weights, over a
  thread-block cluster of ``location_cluster_size`` blocks per batch row
  (K3's cluster attention: each rank computes A/S of the query and the
  energies of its slice of chars; the softmax and the context are combined
  in rank order, so the sums' order depends on L and the dims, never on
  the batch);
- ``heads``: the mel and gate linear over [rnn_h, ctx], a split-K product
  on the tensor cores over a thread-block cluster of ``HEADS_CLUSTER``
  blocks, each reading its 16-column pieces of a copy of the weights tiled
  once per model (``tile_heads``) and summing in rank order, so that a
  row's sums follow the dims alone.

The controls mode (the controllable configs; the same TPU kernel's controls
rows, ``_decode_chunk_kernel`` :534 and :569, packed by
``pack_decoder_params`` :115-122 and :145-149): the decoder cell reads [att_h
| ctx | controls | rnn_h] and the heads [rnn_h | ctx | controls], the
request's controls zero-padded to ``controls_cols`` = a multiple of 16
(whole 16-byte pieces of the cells' operands), with zero weight columns
there and in the gate's row (the gate reads [rnn_h | ctx] alone). The
controls are staged once per decode (``stage_controls``). A pack of a model
without controls has no controls columns.

What bounds a step at every batch the decode runs (1 to 64 rows): the bytes
of the bf16 LSTM weights, 2 x 4H x (P + D + H | 2H + D) x 2 B = 35.7 MB at
the flagship dims, over the HBM rate (3.35 TB/s): 10.7 us; a 64-row step's
2.3 GFLOP take 2.4 us at the bf16 peak. The block fits the 50 MB L2, so a
warm step may beat that HBM bound. The other three kernels move well under
1 MB.

The main path is ``decode_chunk``: one host call (``t2_decode_chunk``)
launches the five kernels of each of 64 steps, so Python does not pace the
steps. Each wrapper runs its plain PyTorch version for CPU tensors only; a
CUDA tensor launches the kernels or raises. The host loop checks the gates
once per chunk (one device-to-host sync per 64 frames) and then does the
exact step bookkeeping of the reference stop rule, so that ``n_frames``,
``lengths``, mels, gates and alignments equal the per-step decode's.

The int8 mode (``pack_decoder(..., quantize=True)``) replaces the same TPU
kernel with ``quantize=True`` (``pack_decoder_params`` :156-162 and the
kernel's ``_quantize_xh`` / int8 gate products): the two LSTM weight blocks
are int8 with one f32 scale per gate row, and both cells run on kernel K5,
``lstm_cell_int8`` (the same cell kernel on the int8 tensor cores), over
its f32 input quantised per batch row by a ``quantize_xh`` launch, with
sums in int32. Every other product takes bf16 activations whatever the
policy, as in the JAX kernel. Its bound at batch 1 is the int8 weights,
17.8 MB over the HBM rate: 5.3 us a step.

The f32 mode (``pack_decoder(..., torch.float32)``: the JAX package's
default policy and every ``"32-true"`` / ``"32"`` model, whose decode the
same TPU kernel runs with f32 weights, ``dt = w_s.dtype``, :386) runs every
product on f32 operands with f32 sums, nothing rounded: ``lstm_cell`` on
``t2_lstm_cell_f32`` (the bf16 cell's cluster design with the gate GEMM on
the tensor cores as a three-pass TF32 split, ``tf32_split``: w_hi a_lo +
w_lo a_hi + w_hi a_hi in f32 sums, over an f32 copy tiled once per model in
the mma fragments' order, ``tile_gates_f32``), ``prenet``,
``location_attention`` and ``heads`` on their f32 entries (the heads the
same split over ``tile_heads_f32``'s copy), five launches a step, each
counted in ``F32_LAUNCHES``. An int8 pack of an F32
model keeps the prenet's and heads' weights f32, as the JAX pack does: its
chunk runs them on the f32 entries with the activations rounded to bf16
(``prenet_f32_act_bf16``, ``heads_f32_act_bf16``: the JAX kernel's
``x.astype(bf16)`` on f32 weights), K5's cells and the bf16 attention, seven
launches a step. The f32 weights bound a step at 71.3 MB over the HBM rate,
21.3 us at one row; a 64-row step's three passes, 14 us at the TF32 peak.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from tacotron2_tpu_torch.ops import build

T_CHUNK = 64  # frames per chunk; early stop is checked once per chunk

# launches of each kernel; counted only where the kernel is launched
LAUNCHES = {"prenet": 0, "lstm_cell": 0, "quantize_xh": 0, "lstm_cell_int8": 0,
            "location_attention": 0, "heads": 0}
# of those, the launches that read a request's controls (the controls mode's
# decoder cell, its quantize_xh and the heads): a run shows by them that its
# controls went through the kernels' controls rows
CONTROLS_LAUNCHES = {"lstm_cell": 0, "quantize_xh": 0, "lstm_cell_int8": 0, "heads": 0}
# the f32 entries' launches (K1's f32 mode, and the prenet's and heads' in
# the int8 mode of an F32 model, ``_act_bf16``), beside the bf16 ones, and
# of them those that read a request's controls
F32_LAUNCHES = {k: 0 for k in ("prenet_f32", "prenet_f32_act_bf16", "lstm_cell_f32",
                               "location_attention_f32", "heads_f32", "heads_f32_act_bf16")}
F32_CONTROLS_LAUNCHES = {k: 0 for k in ("lstm_cell_f32", "heads_f32", "heads_f32_act_bf16")}
PACK_CALLS = [0]  # pack_decoder calls: a warm server packs each model once
ACT_INT8 = torch.bfloat16  # operand type of the products other than the int8 cells
GATE_UNITS = 16  # hidden units per cluster of the cell kernel (csrc/decode_step.cu GC_U)
GATE_CHUNK = 128  # bytes of each weight row per streamed chunk
F32_GATE_UNITS = 16  # hidden units per cluster of the f32 cell (csrc/decode_step.cu CF_U)
F32_GATE_CHUNK = 64  # columns of each weight row per streamed chunk of the f32 cell (CF_KC)
PRENET_CLUSTER = 8  # blocks of the prenet's cluster (csrc/decode_step.cu PN_S)
PRENET_THREADS = 256  # threads of a prenet block: rows of its group x units (PN_THREADS)
PRENET_SMEM = 227 * 1024  # shared memory a block may use
HEADS_CLUSTER = 8  # blocks of the heads' cluster: the contraction split (csrc HD_S)
HEADS_PIECE = 16  # columns of a piece: one k-step of the heads' mma


def reset_launches() -> None:
    for table in (LAUNCHES, CONTROLS_LAUNCHES, F32_LAUNCHES, F32_CONTROLS_LAUNCHES):
        for k in table:
            table[k] = 0


def _count(name: str, n: int = 1, controls: bool = False) -> None:
    f32 = name in F32_LAUNCHES
    build.count(F32_LAUNCHES if f32 else LAUNCHES, name, n)
    if controls:
        build.count(F32_CONTROLS_LAUNCHES if f32 else CONTROLS_LAUNCHES, name, n)


class PackedDecoder(NamedTuple):
    """Decoder weights in the kernels' layouts (torch row-major)."""

    w_att: torch.Tensor  # (4H, P + D + H) rows = gates; cols [prenet | ctx | att_h]
    # (bf16, int8 or f32: the pack's mode, ``decode_mode``)
    b_att: torch.Tensor  # (4H,) f32, b_ih + b_hh
    w_dec: torch.Tensor  # (4H, H + D + E + H) cols [att_h | ctx | controls | rnn_h]
    b_dec: torch.Tensor  # (4H,) f32
    wp1_t: torch.Tensor  # (M, P) prenet fc1, input-major
    wp2_t: torch.Tensor  # (P, P) prenet fc2, input-major
    wq: torch.Tensor  # (A, H) query projection
    w_loc: torch.Tensor  # (A, 2, K) location conv folded with the location dense
    wv: torch.Tensor  # (A,) energy vector
    w_out: torch.Tensor  # (M + 1, H + D + E) rows 0..M-1 mel, row M gate (0 over controls)
    b_out: torch.Tensor  # (M + 1,) f32
    s_att: Optional[torch.Tensor] = None  # int8 mode: (4H,) f32 scale of each w_att row
    s_dec: Optional[torch.Tensor] = None  # int8 mode: (4H,) f32 scale of each w_dec row
    wt_att: Optional[torch.Tensor] = None  # w_att tiled for the cell kernel (tile_gates;
    # f32: tile_gates_f32)
    wt_dec: Optional[torch.Tensor] = None  # w_dec tiled for the cell kernel
    wt_prenet: Optional[torch.Tensor] = None  # the prenet's weights tiled (tile_prenet)
    wt_out: Optional[torch.Tensor] = None  # w_out tiled for the heads kernel (tile_heads;
    # f32: tile_heads_f32)

    @property
    def quantized(self) -> bool:
        return self.s_att is not None

    @property
    def controls_cols(self) -> int:
        """E, the controls' columns of w_dec and w_out (0 without controls)."""
        H = self.wq.shape[1]
        D = self.w_att.shape[1] - self.wp2_t.shape[0] - H
        return self.w_out.shape[1] - H - D


def _div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as a true division: a Python scalar divisor becomes a
    multiply by its reciprocal on the card, which rounds otherwise."""
    return t / torch.full((), 127.0, device=t.device)


def quantize_weights(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 (rows, R) -> (int8 rows, f32 scale per row): scale max(max |row|
    / 127, 1e-12), values clip(round(w / scale), -127, 127), rounding half
    to even (JAX ``pack_decoder_params(quantize=True)``, one scale per
    column of its transposed ``w_stream``)."""
    w = w.float()
    s = _div127(w.abs().amax(dim=1)).clamp_min(1e-12)
    q = torch.round(w / s[:, None]).clamp(-127, 127).to(torch.int8)
    return q.contiguous(), s.contiguous()


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 quantisation of an f32 activation (B, R) -> (values as
    f32 integers in [-127, 127], scale (B, 1) = max(max |row|, 1e-12) / 127)
    (the JAX kernel's ``_quantize_xh``)."""
    sx = _div127(x.abs().amax(dim=1, keepdim=True).clamp_min(1e-12))
    return torch.round(x / sx).clamp(-127, 127), sx


def gate_tile_offset(row, byte, H: int, row_bytes: int, units: int = GATE_UNITS):
    """Byte offset in ``tile_gates``' copy of byte ``byte`` of weight row
    ``row`` (gate = row // H, unit j = row % H) of an LSTM block (4H rows of
    ``row_bytes``): the cell kernel's addressing. Cluster gi = j // units
    reads chunks c = byte // 128 of its 4 units rows (row gate units + u for
    unit units gi + u), each chunk 4 units rows x 128 bytes with the 16-byte
    piece k of row rr at piece k ^ (rr % 8), chunks of a cluster end to end.
    Works on ints and on integer tensors."""
    nk = -(-row_bytes // GATE_CHUNK)
    gate, j = row // H, row % H
    gi, u = j // units, j % units
    rr = gate * units + u
    c, cb = byte // GATE_CHUNK, byte % GATE_CHUNK
    return (((gi * nk + c) * 4 * units + rr) * GATE_CHUNK + (((cb // 16) ^ (rr % 8)) * 16)
            + cb % 16)


def tile_gates(w: torch.Tensor, units: int = GATE_UNITS) -> Optional[torch.Tensor]:
    """An LSTM block's weights (4H, R), bf16 or int8, as the cell kernel
    streams them: a flat uint8 copy laid out by ``gate_tile_offset``, rows
    zero-padded to whole 128-byte chunks. None where H is not a multiple of
    GATE_UNITS (no kernel takes those dims; the plain version needs no
    copy)."""
    rows = w.shape[0]
    H = rows // 4
    if H % units or rows != 4 * H:
        return None
    wb = w.detach().contiguous().view(torch.uint8)  # (4H, row bytes)
    nk = -(-wb.shape[1] // GATE_CHUNK)
    padded = wb.new_zeros(rows, nk * GATE_CHUNK)
    padded[:, :wb.shape[1]] = wb
    t = padded.view(4, H // units, units, nk, GATE_CHUNK).permute(1, 3, 0, 2, 4)
    t = t.reshape(H // units, nk, 4 * units, 8, 16)
    rr = torch.arange(4 * units, device=w.device)[:, None]
    piece = torch.arange(8, device=w.device)[None, :] ^ (rr % 8)  # out piece p holds p ^ rr % 8
    return t[:, :, rr, piece].reshape(-1).contiguous()


def gate_f32_offset(row, col, H: int, R: int):
    """Element offset in ``tile_gates_f32``' copy of weight row ``row`` (gate
    = row // H, unit j = row % H), column ``col`` of an f32 LSTM block (4H, R):
    the f32 cell kernel's addressing. Cluster gi = j // F32_GATE_UNITS reads
    chunks c = col // 64 of its 64 rows, m16 tile mt = gate (units 16 gi ..
    16 gi + 15), in the order of the tf32 mma's A fragments: [chunk][m tile]
    [k8 step s][lane][register e], lane = 4 g + t and e = e_lo + 2 e_hi for
    row 16 mt + g + 8 e_lo and column 16 (s // 2) + 4 t + 2 (s % 2) + e_hi of
    the chunk (so that a lane's input columns of a k16 pair of steps are 4
    consecutive floats); a cluster's chunks end to end. Works on ints and on
    integer tensors."""
    nk = -(-R // F32_GATE_CHUNK)
    gate, j = row // H, row % H
    gi, u = j // F32_GATE_UNITS, j % F32_GATE_UNITS
    g, e_lo = u % 8, u // 8
    c, kk = col // F32_GATE_CHUNK, col % F32_GATE_CHUNK
    q, t, h, e_hi = kk // 16, (kk % 16) // 4, (kk % 4) // 2, kk % 2
    s = 2 * q + h
    return (((((gi * nk + c) * 4 + gate) * (F32_GATE_CHUNK // 8) + s) * 32 + 4 * g + t) * 4
            + e_lo + 2 * e_hi)


def tiled_f32_len(H: int, R: int) -> int:
    """Elements of ``tile_gates_f32``' copy of 4H rows of R columns."""
    return 4 * H * -(-R // F32_GATE_CHUNK) * F32_GATE_CHUNK


def tile_gates_f32(w: torch.Tensor) -> Optional[torch.Tensor]:
    """An f32 LSTM block's weights (4H, R) as the f32 cell kernel streams
    them: a flat f32 copy laid out by ``gate_f32_offset``, rows zero-padded
    to whole 64-column chunks. None where H is not a multiple of
    F32_GATE_UNITS (no kernel takes those dims)."""
    rows, R = w.shape
    H = rows // 4
    if H % F32_GATE_UNITS or rows != 4 * H:
        return None
    nk = -(-R // F32_GATE_CHUNK)
    padded = F.pad(w.detach().float(), (0, nk * F32_GATE_CHUNK - R))
    # (gate, gi, e_lo, g, c, q, t, h, e_hi) -> [gi][c][gate][q][h][g][t][e_hi][e_lo]
    t = padded.view(4, H // F32_GATE_UNITS, 2, 8, nk, F32_GATE_CHUNK // 16, 4, 2, 2)
    return t.permute(1, 4, 0, 5, 7, 3, 6, 8, 2).reshape(-1).contiguous()


def prenet_units(M: int, P: int, esize: int = 2) -> int:
    """Units of both layers a block of the prenet's cluster owns, U = P /
    PRENET_CLUSTER; its group is PRENET_THREADS / U rows. Raises ValueError
    for dims the split does not take: U a multiple of 8 (whole 16-byte
    rows of its weight slice) that divides PRENET_THREADS, M a multiple of
    4 (the kernel reads 4 inputs a load), and a block's shared memory (its
    slice of ``esize``-byte weights, 2 bf16 or 4 f32, the group's mel and
    first-layer outputs) within PRENET_SMEM."""
    U = P // PRENET_CLUSTER
    if M < 1 or M % 4 or P % PRENET_CLUSTER or U % 8 or PRENET_THREADS % U:
        raise ValueError(f"the prenet's cluster of {PRENET_CLUSTER} blocks takes P = 8 U with U "
                         f"a multiple of 8 dividing {PRENET_THREADS} and M a multiple of 4, got "
                         f"P={P}, M={M}")
    smem = 16 + (M + P) * U * esize + (PRENET_THREADS // U) * (M + P) * 4
    if smem > PRENET_SMEM:
        raise ValueError(f"the prenet's block would need {smem} bytes of shared memory at "
                         f"M={M}, P={P}; at most {PRENET_SMEM}")
    return U


def prenet_tile_offset(k, p, M: int, P: int):
    """Element offset in ``tile_prenet``'s copy of row k of [wp1_t; wp2_t]
    ((M + P, P), input-major: k < M is layer 1's input k, then layer 2's),
    column (unit) p: block p // U's slice, (M + P) x U, then [k // 4][p %
    U][k % 4], so that a unit's 4 consecutive weights are one 8-byte load
    (the kernel's addressing). Works on ints and on integer tensors."""
    U = prenet_units(M, P)
    return (((p // U) * ((M + P) // 4) + k // 4) * U + p % U) * 4 + k % 4


def prenet_tiled_shape(M: int, P: int) -> Tuple[int, int, int, int]:
    """Shape of ``tile_prenet``'s copy."""
    U = prenet_units(M, P)
    return P // U, (M + P) // 4, U, 4


def tile_prenet(wp1_t: torch.Tensor, wp2_t: torch.Tensor) -> Optional[torch.Tensor]:
    """The prenet's weights (M, P) and (P, P), input-major, as its kernel's
    blocks copy them: block r's units [r U, (r + 1) U) of both layers, (M +
    P) x U, one contiguous run each, shape (P / U, (M + P) / 4, U, 4)
    (``prenet_tile_offset``). None where the cluster split does not take
    the dims (``prenet_units``; the plain version needs no copy)."""
    M, P = wp1_t.shape
    try:
        U = prenet_units(M, P, wp1_t.element_size())
    except ValueError:
        return None
    w = torch.cat([wp1_t, wp2_t], dim=0).detach()  # (M + P, P)
    return w.reshape((M + P) // 4, 4, P // U, U).permute(2, 0, 3, 1).contiguous()


def heads_rows(N: int) -> int:
    """The heads' output rows padded to whole m16 tiles (81 -> 96)."""
    return -(-N // 16) * 16


def heads_pieces(K: int, rank: int, ranks: int = HEADS_CLUSTER) -> range:
    """The 16-column pieces of the heads' K columns that block ``rank`` of
    their cluster sums: [rank nk / ranks, (rank + 1) nk / ranks), nk = ceil(K
    / 16). It follows K and the cluster alone, never the batch."""
    nk = -(-K // HEADS_PIECE)
    return range(rank * nk // ranks, (rank + 1) * nk // ranks)


def check_heads_dims(n1: int, n2: int, n3: int) -> None:
    """Raise unless the heads kernel takes inputs of these widths: each
    segment [rnn_h | ctx | controls] whole pieces of 16 columns (a piece
    lies in one segment; a rank with no piece adds zeros)."""
    if any(n % HEADS_PIECE for n in (n1, n2, n3)) or n1 + n2 + n3 == 0:
        raise ValueError(f"the heads kernel takes inputs of whole {HEADS_PIECE}-column "
                         f"pieces; got widths {n1, n2, n3}")


def heads_tile_offset(row, col, N: int):
    """Element offset in ``tile_heads``' copy of w_out[row, col]: piece p =
    col // 16 of every padded row end to end ([p][row][16]), so that a rank's
    pieces are one contiguous run, with the 8-element half h of row r at
    half h ^ ((r >> 2) & 1) (the kernel's conflict-free fragment loads).
    Works on ints and on integer tensors."""
    NP = heads_rows(N)
    p, c = col // HEADS_PIECE, col % HEADS_PIECE
    return (p * NP + row) * HEADS_PIECE + (((c // 8) ^ ((row // 4) % 2)) * 8) + c % 8


def heads_tiled_shape(N: int, K: int) -> Tuple[int, int, int]:
    """Shape of ``tile_heads``' copy: (pieces, padded rows, 16)."""
    return -(-K // HEADS_PIECE), heads_rows(N), HEADS_PIECE


def tile_heads(w_out: torch.Tensor) -> torch.Tensor:
    """The heads' weights (N, K) as their kernel's ranks copy them
    (``heads_tile_offset``): zero past N rows and K columns."""
    N, K = w_out.shape
    nk, NP, _ = heads_tiled_shape(N, K)
    w = w_out.detach().new_zeros(NP, nk * HEADS_PIECE)
    w[:N, :K] = w_out.detach()
    t = w.view(NP, nk, 2, 8).permute(1, 0, 2, 3)  # (piece, row, half, 8)
    swap = ((torch.arange(NP, device=w.device) // 4) % 2)[None, :, None]
    half = torch.arange(2, device=w.device)[None, None, :] ^ swap  # out half h holds h ^ swap
    return torch.take_along_dim(t, half[..., None].expand(nk, NP, 2, 8), dim=2).reshape(
        nk, NP, HEADS_PIECE).contiguous()


def heads_f32_offset(row, col, N: int):
    """Element offset in ``tile_heads_f32``' copy of an f32 w_out[row, col]:
    piece p = col // 16, then the f32 heads kernel's tf32 A fragments, the
    f32 cell's order (``gate_f32_offset``) within a piece: [p][m16 tile]
    [k8 step h][lane][register], so that a rank's pieces are one contiguous
    run. Works on ints and on integer tensors."""
    MT = heads_rows(N) // 16
    p, c = col // HEADS_PIECE, col % HEADS_PIECE
    t, h, e_hi = c // 4, (c % 4) // 2, c % 2
    mt, g, e_lo = row // 16, row % 8, (row % 16) // 8
    return ((((p * MT + mt) * 2 + h) * 32 + 4 * g + t) * 4) + e_lo + 2 * e_hi


def heads_f32_tiled_shape(N: int, K: int) -> Tuple[int, int, int, int, int]:
    """Shape of ``tile_heads_f32``' copy: (pieces, m16 tiles, k8 steps of a
    piece, lanes, registers)."""
    return -(-K // HEADS_PIECE), heads_rows(N) // 16, 2, 32, 4


def tile_heads_f32(w_out: torch.Tensor) -> torch.Tensor:
    """The heads' f32 weights (N, K) as the f32 heads kernel's ranks copy
    them (``heads_f32_offset``): zero past N rows and K columns."""
    N, K = w_out.shape
    nk, MT = heads_f32_tiled_shape(N, K)[:2]
    w = w_out.detach().float().new_zeros(MT * 16, nk * HEADS_PIECE)
    w[:N, :K] = w_out.detach()
    # (mt, e_lo, g, p, t, h, e_hi) -> [p][mt][h][g][t][e_hi][e_lo]
    t = w.view(MT, 2, 8, nk, 4, 2, 2).permute(3, 0, 5, 2, 4, 6, 1)
    return t.reshape(heads_f32_tiled_shape(N, K)).contiguous()


CONTROLS_ALIGN = 16  # the controls' columns are padded to a multiple of this


def controls_cols(controls_dim: int) -> int:
    """Columns the kernels give ``controls_dim`` controls: whole 16-byte
    pieces of the int8 operand (JAX pads to 16 as well); 0 without."""
    return -(-controls_dim // CONTROLS_ALIGN) * CONTROLS_ALIGN


def stage_controls(pk: PackedDecoder, controls: Optional[torch.Tensor], B: int, device
                   ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """A decode's controls (B, E0) as the kernels read them, once per decode:
    f32 (B, E) zero-padded to the pack's ``controls_cols`` (the heads', and
    K5's quantize_xh's) and its bf16 operand (K1's decoder cell; None for an
    int8 pack; an f32 pack's chunk does not read it). (None, None) for a
    pack without controls."""
    E = pk.controls_cols
    if E == 0:
        if controls is not None:
            raise ValueError("the model has no controls, but controls were passed")
        return None, None
    if controls is None or controls.dim() != 2 or controls.shape[0] != B:
        raise ValueError(f"want controls of shape ({B}, <= {E}), got "
                         f"{None if controls is None else tuple(controls.shape)}")
    if controls.shape[1] > E:
        raise ValueError(f"{controls.shape[1]} controls for {E} columns")
    c32 = F.pad(controls.to(device=device, dtype=torch.float32),
                (0, E - controls.shape[1])).contiguous()
    return c32, None if pk.quantized else c32.to(torch.bfloat16)


def decode_mode(pk: PackedDecoder) -> int:
    """The chunk's mode of a pack (``t2_decode_chunk``'s d[9]): bit 0 the
    cells int8 (K5), bit 1 the prenet's and heads' weights f32 (alone: K1's
    f32 mode, every weight f32; with bit 0: the int8 pack of an F32 model)."""
    return int(pk.quantized) | (2 if pk.wp1_t.dtype == torch.float32 else 0)


def pack_decoder(prenet, decoder, dtype: torch.dtype, quantize: bool = False) -> PackedDecoder:
    """Repack the prenet and decoder modules for the kernels; weights in
    ``dtype`` (bf16 on the card), biases in f32. ``quantize``: the two LSTM
    blocks int8 with a scale per gate row, quantised from the f32 weights;
    the attention's weights bf16 whatever ``dtype``, and the prenet's and
    heads' in ``dtype`` with their activations rounded to bf16
    (``ACT_INT8``), as the JAX kernel's int8 mode takes those products
    (f32 weights of an F32 model run on the f32 entries with that rounding).
    A decoder with controls gets their columns in w_dec and w_out, padded
    to ``controls_cols`` with zeros (the gate's row zero over all of them).
    The two LSTM blocks also get the cell kernel's tiled copies
    (``tile_gates``; f32 blocks ``tile_gates_f32``), the prenet its
    kernel's (``tile_prenet``) and the heads theirs (``tile_heads``; f32
    ``tile_heads_f32``), made here once per pack."""
    PACK_CALLS[0] += 1
    a, d, att = decoder.att_rnn, decoder.lstm, decoder.attention
    with torch.no_grad():
        w_loc = torch.einsum("af,fck->ack", att.location_dense.weight.float(),
                             att.location_conv.weight.float())
        cast = lambda t: t.detach().to(dtype).contiguous()
        att_cast = (lambda t: t.detach().to(ACT_INT8).contiguous()) if quantize else cast
        f32 = lambda t: t.detach().float().contiguous()
        E0 = decoder.controls_dim
        pad_e = lambda w: F.pad(w, (0, controls_cols(E0) - E0))  # zero controls columns
        # the controls are the last E0 inputs of the LSTM and of the mel head
        split = lambda w: torch.cat([w[:, :w.shape[1] - E0], pad_e(w[:, w.shape[1] - E0:])], 1)
        w_att = torch.cat([a.weight_ih, a.weight_hh], dim=1)
        w_dec = torch.cat([split(d.weight_ih), d.weight_hh], dim=1)
        mel_w = split(decoder.mel_out.weight)
        gate_w = F.pad(decoder.gate.weight, (0, controls_cols(E0)))
        scales = {}
        if quantize:
            (w_att, scales["s_att"]), (w_dec, scales["s_dec"]) = (
                quantize_weights(w_att), quantize_weights(w_dec))
        else:
            w_att, w_dec = cast(w_att), cast(w_dec)
        wp1_t, wp2_t = cast(prenet[0].weight.t()), cast(prenet[3].weight.t())
        w_out = cast(torch.cat([mel_w, gate_w], dim=0))
        f32_cells, f32_heads = w_att.dtype == torch.float32, w_out.dtype == torch.float32
        return PackedDecoder(
            w_att=w_att,
            b_att=f32(a.bias_ih + a.bias_hh),
            w_dec=w_dec,
            b_dec=f32(d.bias_ih + d.bias_hh),
            wp1_t=wp1_t,
            wp2_t=wp2_t,
            wq=att_cast(att.query_layer.weight),
            w_loc=att_cast(w_loc),
            wv=att_cast(att.v.weight[0]),
            w_out=w_out,
            b_out=f32(torch.cat([decoder.mel_out.bias, decoder.gate.bias], dim=0)),
            wt_att=tile_gates_f32(w_att) if f32_cells else tile_gates(w_att),
            wt_dec=tile_gates_f32(w_dec) if f32_cells else tile_gates(w_dec),
            wt_prenet=tile_prenet(wp1_t, wp2_t),
            wt_out=tile_heads_f32(w_out) if f32_heads else tile_heads(w_out),
            **scales,
        )


# ---------------------------------------------------------------------------
# plain versions (the definition; used for CPU tensors and as the reference
# the kernels are held against on the card)
# ---------------------------------------------------------------------------


MAX_CLUSTER = 8  # the portable thread-block cluster size
K1_MIN_CHARS = 8  # chars per rank below which K1's cluster is halved


def _cluster_dims_ok(S: int, H: int, A: int, D: int, K: int) -> bool:
    return (S in (1, 2, 4, 8) and A % S == 0 and H % (8 * S) == 0 and D % S == 0
            and A % 4 == 0 and 512 % A == 0 and D % 8 == 0 and K % 2 == 1)


def check_cluster_dims(S: int, H: int, A: int, D: int, K: int) -> None:
    """Raise unless the attention's cluster split takes these dims: each
    rank computes A/S of the query, sums D/S of the context and pulls H/S
    of the query's input in 16-byte groups; a block of 512 threads takes A
    (dividing 512) in groups of 4; the location window is centred (K odd)."""
    if S not in (1, 2, 4, 8):
        raise ValueError(f"cluster size {S}: want 1, 2, 4 or 8")
    if not _cluster_dims_ok(S, H, A, D, K):
        raise ValueError(f"the cluster attention takes A % S == D % S == H % (8 S) == 0, "
                         f"A % 4 == 0, A | 512, D % 8 == 0 and K odd: got S={S}, H={H}, A={A}, "
                         f"D={D}, K={K}")


def location_cluster_size(L: int, H: int, A: int, D: int, K: int) -> int:
    """Blocks per batch row of K1's attention: the largest power of two up
    to ``MAX_CLUSTER`` that ``check_cluster_dims`` takes and that leaves
    each rank at least ``K1_MIN_CHARS`` chars, at least 1. It reads the
    dims and L only: a row's softmax and context sums run in one order
    whatever rows share its launch (S = 8 at the flagship dims for L >=
    57, so at the say's 96 chars and the server's 128-char buckets)."""
    check_cluster_dims(1, H, A, D, K)
    s = MAX_CLUSTER
    while s > 1 and not (_cluster_dims_ok(s, H, A, D, K) and -(-L // s) >= K1_MIN_CHARS):
        s //= 2
    return s


def _acc(t: torch.Tensor) -> torch.Tensor:
    """A weight in its sum type: f32, or f64 for f64 weights (the
    gradient checks run the plain versions in f64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _rnd(x: torch.Tensor, like: torch.Tensor, act: Optional[torch.dtype] = None
         ) -> torch.Tensor:
    """Round an activation to ``act``, or else to the weights' type (bf16
    operands), keep the sum type."""
    return _acc(x.to(act or like.dtype))


def prenet_plain(mel, wp1_t, wp2_t, m1, m2, act: Optional[torch.dtype] = None):
    h1 = torch.relu(_rnd(mel, wp1_t, act) @ _acc(wp1_t)) * m1
    return torch.relu(_rnd(h1, wp2_t, act) @ _acc(wp2_t)) * m2


def _xh(x1, x2, x3, ctl=None):
    """A cell's input [x1 | x2 | ctl | x3]: ``ctl``, the controls (the
    decoder cell's [att_h | ctx | controls | rnn_h]), where given."""
    return torch.cat([x1, x2, x3] if ctl is None else [x1, x2, ctl, x3], dim=1)


def lstm_cell_plain(w, b, x1, x2, x3, c, ctl=None):
    gates = _rnd(_xh(x1, x2, x3, ctl), w) @ _acc(w).t() + b
    i, f, g, o = gates.chunk(4, dim=1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def lstm_cell_int8_plain(w, ws, b, x1, x2, x3, c, ctl=None):
    """The LSTM cell over int8 weight rows ``w`` (4H, R) with scales ``ws``
    (4H,): the f32 input quantised per row (its scale over all of R, the
    controls included), the integer product exact (in f64: |sum| < 127^2 R
    < 2^53), gates (float(sum) * sx) * ws + b."""
    q, sx = quantize_rows(_xh(x1, x2, x3, ctl).float())
    acc = (q.double() @ w.double().t()).float()
    gates = (acc * sx) * ws + b
    i, f, g, o = gates.chunk(4, dim=1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def location_attention_plain(h, wq, w_loc, wv, att_enc, encoded, lengths,
                             w_prev, cum_prev):
    L = att_enc.shape[1]
    q = _rnd(_rnd(h, wq) @ _acc(wq).t(), wq)  # (B, A), rounded as the JAX kernel's qT
    win = _rnd(torch.stack([w_prev, cum_prev], dim=1), w_loc)  # (B, 2, L)
    loc = F.conv1d(win, _acc(w_loc), padding=w_loc.shape[2] // 2)  # (B, A, L)
    e = torch.tanh(q[:, None, :] + loc.transpose(1, 2) + att_enc)
    energies = _rnd(e, wv) @ _acc(wv)  # (B, L)
    pad = torch.arange(L, device=h.device)[None, :] >= lengths[:, None]
    w = torch.softmax(energies.masked_fill(pad, float("-inf")), dim=1)
    ctx = torch.einsum("bl,bld->bd", _rnd(w, encoded), _acc(encoded))
    return ctx, w, cum_prev + w


def heads_plain(w_out, b_out, rnn_h, ctx, act: Optional[torch.dtype] = None, ctl=None):
    x = torch.cat([rnn_h, ctx] if ctl is None else [rnn_h, ctx, ctl], dim=1)
    return _rnd(x, w_out, act) @ _acc(w_out).t() + b_out


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 ``x`` -> (hi, lo), the f32 cell's and heads' operand split
    (``tf32_split`` in csrc/decode_step.cu): hi is x rounded to TF32 (10
    mantissa bits, to nearest, ties away from zero: ``cvt.rna.tf32.f32``, the
    low 13 bits zero), lo the same of x - hi. Their three passes take w_hi
    a_lo + w_lo a_hi + w_hi a_hi (the lo lo term left out). For the tests."""
    def rna(t: torch.Tensor) -> torch.Tensor:
        return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    x = x.float()
    hi = rna(x)
    return hi, rna(x - hi)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

_LIB = None
P = ctypes.c_void_p
I = ctypes.c_int


def bind(lib):
    """Declare the C entry points of a loaded ``csrc/decode_step.cu`` (the
    build's, or a copy's for an A/B on the card) -> lib."""
    lib.t2_prenet.argtypes = [P] * 5 + [I] * 3 + [P]
    lib.t2_lstm_cell.argtypes = [P, P, P, I, P, I, P, I, P, I, P, P, P, I, I, P]
    lib.t2_quantize_xh.argtypes = [P, I, P, I, P, I, P, I, P, P, I, P]
    lib.t2_lstm_cell_int8.argtypes = [P, P, P, P, P, I, I, I, I, P, P, P, I, I, P]
    lib.t2_location_attention.argtypes = [P] * 12 + [I] * 7 + [P]
    lib.t2_heads.argtypes = [P, P, P, I, P, I, P, I, P, I, I, P]
    lib.t2_decode_chunk.argtypes = [ctypes.POINTER(P), ctypes.POINTER(I), P]
    # K1's f32 mode: the bf16 entries' arguments; the prenet and heads one more
    # int, act_bf16
    lib.t2_lstm_cell_f32.argtypes = lib.t2_lstm_cell.argtypes
    lib.t2_prenet_f32.argtypes = [P] * 5 + [I] * 4 + [P]
    lib.t2_location_attention_f32.argtypes = lib.t2_location_attention.argtypes
    lib.t2_heads_f32.argtypes = [P, P, P, I, P, I, P, I, P, I, I, I, P]
    for fn in (lib.t2_prenet, lib.t2_lstm_cell, lib.t2_quantize_xh, lib.t2_lstm_cell_int8,
               lib.t2_location_attention, lib.t2_heads, lib.t2_decode_chunk,
               lib.t2_lstm_cell_f32, lib.t2_prenet_f32, lib.t2_location_attention_f32,
               lib.t2_heads_f32):
        fn.restype = I
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = bind(build.load("decode_step"))
    return _LIB


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _act_bf16(act: Optional[torch.dtype]) -> bool:
    """An f32 entry's rounding of its activations: None (K1's f32 mode) or
    bf16 (``ACT_INT8``: the int8 mode of an F32 model)."""
    if act not in (None, torch.bfloat16):
        raise ValueError(f"act: want None or torch.bfloat16, got {act}")
    return act is not None


def prenet(mel, wp1_t, wp2_t, m1, m2, wt=None, act: Optional[torch.dtype] = None):
    """(B, M) previous mel -> (B, P) prenet output with dropout masks. On
    the card the kernel reads ``wt``, the tiled copy of both weights
    (``tile_prenet``, the pack's ``wt_prenet``), bf16 or f32 as the weights
    are: f32 weights run the f32 entry, its activations rounded to ``act``
    (None, or bf16 for the int8 mode of an F32 model; bf16 weights round
    them to bf16 in any case)."""
    if mel.device.type == "cpu":
        return prenet_plain(mel, wp1_t, wp2_t, m1, m2, act)
    B, M = mel.shape
    Pd = wp2_t.shape[0]
    f32 = wp1_t.dtype == torch.float32
    prenet_units(M, Pd, 4 if f32 else 2)  # raises for dims the cluster split does not take
    if wt is None:
        raise ValueError("prenet: the kernel reads the tiled copy of its weights (tile_prenet, "
                         "the pack's wt_prenet); none was given")
    rnd = _act_bf16(act) if f32 else None
    build.require(mel, torch.float32, (B, M), "mel")
    build.require(wt, torch.float32 if f32 else torch.bfloat16, prenet_tiled_shape(M, Pd), "wt")
    build.require(m1, torch.float32, (B, Pd), "m1")
    build.require(m2, torch.float32, (B, Pd), "m2")
    out = torch.empty(B, Pd, device=mel.device)
    if f32:
        name = "prenet_f32_act_bf16" if rnd else "prenet_f32"
        _count(name)
        build.check(_lib().t2_prenet_f32(mel.data_ptr(), wt.data_ptr(), m1.data_ptr(),
                                         m2.data_ptr(), out.data_ptr(), B, M, Pd, int(rnd),
                                         _stream()), name)
        return out
    build.count(LAUNCHES, "prenet")
    build.check(_lib().t2_prenet(mel.data_ptr(), wt.data_ptr(), m1.data_ptr(), m2.data_ptr(),
                                 out.data_ptr(), B, M, Pd, _stream()), "prenet")
    return out


def tiled_bytes(H: int, row_bytes: int) -> int:
    """Bytes of ``tile_gates``' copy of 4H rows of ``row_bytes``."""
    return 4 * H * -(-row_bytes // GATE_CHUNK) * GATE_CHUNK


def _cell_operands(w, dt, b, x1, x2, x3, c, wt, ctl=None) -> Tuple[int, int, int, int, int]:
    """Check a cell's operands (the inputs x_i and the controls ``ctl`` in
    the kernel's type: bf16 for bf16 weights, f32 for int8 and f32 ones)
    -> (B, H, n1, n2, nc, n3)."""
    B, H = c.shape
    xs = (("x1", x1), ("x2", x2), ("x3", x3)) + ((("ctl", ctl),) if ctl is not None else ())
    n1, n2, n3 = x1.shape[1], x2.shape[1], x3.shape[1]
    nc = 0 if ctl is None else ctl.shape[1]
    R = n1 + n2 + nc + n3
    build.require(w, dt, (4 * H, R), "w")
    if wt is None:
        raise ValueError("wt: the cell kernel streams the tiled copy of w (pack_decoder's "
                         "wt_att / wt_dec, tile_gates); none was given")
    if dt == torch.float32:
        if H % F32_GATE_UNITS:
            raise ValueError(f"the f32 cell kernel takes H a multiple of {F32_GATE_UNITS}; "
                             f"got H={H}")
        if any(n % 16 for n in (n1, n2, nc, n3)):
            raise ValueError(f"the f32 cell kernel takes input segments of whole 16-column "
                             f"groups; got widths {n1, n2, nc, n3}")
        build.require(wt, torch.float32, (tiled_f32_len(H, R),), "wt")
    else:
        build.require(wt, torch.uint8, (tiled_bytes(H, R * w.element_size()),), "wt")
    build.require(b, torch.float32, (4 * H,), "b")
    for name, x in xs:
        build.require(x, torch.bfloat16 if dt == torch.bfloat16 else torch.float32,
                      (B, x.shape[1]), name)
    build.require(c, torch.float32, (B, H), "c")
    if any(t.data_ptr() % 16 for _, t in xs):
        raise ValueError("x1, x2, x3, ctl: the cell kernel reads its input in 16-byte pieces; "
                         "want 16-byte aligned tensors")
    return B, H, n1, n2, nc, n3


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def lstm_cell(w, b, x1, x2, x3, c, wt=None, ctl=None):
    """LSTM cell over the input [x1 | x2 | ctl | x3] with weight rows =
    gates (4H, R) and summed bias (4H,) -> (h, c); ``ctl`` the controls
    (the decoder cell of a controllable model), else [x1 | x2 | x3]. On the
    card the kernel streams ``wt``, the tiled copy of ``w`` (bf16 weights:
    ``tile_gates``, the inputs their bf16 operands, which in the chunk their
    producers write; f32 weights: ``tile_gates_f32``, the inputs f32, K1's
    f32 mode). Inputs of another type than the weights' kernel reads are
    refused, not cast."""
    if x1.device.type == "cpu":
        return lstm_cell_plain(w, b, x1, x2, x3, c, ctl)
    f32 = w.dtype == torch.float32
    B, H, n1, n2, nc, n3 = _cell_operands(w, torch.float32 if f32 else torch.bfloat16, b, x1,
                                          x2, x3, c, wt, ctl)
    h_out = torch.empty(B, H, device=c.device)
    c_out = torch.empty(B, H, device=c.device)
    name = "lstm_cell_f32" if f32 else "lstm_cell"
    _count(name, controls=nc > 0)
    entry = _lib().t2_lstm_cell_f32 if f32 else _lib().t2_lstm_cell
    build.check(entry(
        wt.data_ptr(), b.data_ptr(), x1.data_ptr(), n1, x2.data_ptr(), n2, _ptr(ctl), nc,
        x3.data_ptr(), n3, c.data_ptr(), h_out.data_ptr(), c_out.data_ptr(), B, H, _stream()),
        name)
    return h_out, c_out


def quantize_xh_plain(x1, x2, x3, ctl=None):
    """K5's operand: the f32 input [x1 | x2 | ctl | x3] quantised per row
    -> (int8 values (B, R), f32 scales (B,)) (``quantize_rows``): a row's
    scale is over all of it, the controls included."""
    q, sx = quantize_rows(_xh(x1, x2, x3, ctl).float())
    return q.to(torch.int8), sx[:, 0].contiguous()


def quantize_xh(x1, x2, x3, ctl=None):
    """``quantize_xh_plain`` as the kernel before each K5 cell computes it
    (one block per row, JAX's ``_quantize_xh``)."""
    if x1.device.type == "cpu":
        return quantize_xh_plain(x1, x2, x3, ctl)
    B = x1.shape[0]
    xs = (("x1", x1), ("x2", x2), ("x3", x3)) + ((("ctl", ctl),) if ctl is not None else ())
    for name, x in xs:
        build.require(x, torch.float32, (B, x.shape[1]), name)
    n1, n2, n3 = x1.shape[1], x2.shape[1], x3.shape[1]
    nc = 0 if ctl is None else ctl.shape[1]
    if any(n % 4 for n in (n1, n2, nc, n3)):
        raise ValueError(f"quantize_xh reads float4s: want widths % 4 == 0, got "
                         f"{n1, n2, nc, n3}")
    xq = torch.empty(B, n1 + n2 + nc + n3, device=x1.device, dtype=torch.int8)
    sx = torch.empty(B, device=x1.device)
    _count("quantize_xh", controls=nc > 0)
    build.check(_lib().t2_quantize_xh(x1.data_ptr(), n1, x2.data_ptr(), n2, _ptr(ctl), nc,
                                      x3.data_ptr(), n3, xq.data_ptr(), sx.data_ptr(), B,
                                      _stream()), "quantize_xh")
    return xq, sx


def lstm_cell_int8(w, ws, b, x1, x2, x3, c, wt=None, ctl=None):
    """Kernel K5: ``lstm_cell`` over int8 weight rows (4H, R) with one f32
    scale per row ``ws`` (4H,) -> (h, c); on the card ``quantize_xh`` then
    the cell kernel over ``wt``, the tiled copy of ``w``."""
    if x1.device.type == "cpu":
        return lstm_cell_int8_plain(w, ws, b, x1, x2, x3, c, ctl)
    B, H, n1, n2, nc, n3 = _cell_operands(w, torch.int8, b, x1, x2, x3, c, wt, ctl)
    build.require(ws, torch.float32, (4 * H,), "ws")
    xq, sx = quantize_xh(x1, x2, x3, ctl)
    h_out = torch.empty(B, H, device=c.device)
    c_out = torch.empty(B, H, device=c.device)
    _count("lstm_cell_int8", controls=nc > 0)
    build.check(_lib().t2_lstm_cell_int8(
        wt.data_ptr(), ws.data_ptr(), b.data_ptr(), xq.data_ptr(), sx.data_ptr(), n1, n2, nc,
        n3, c.data_ptr(), h_out.data_ptr(), c_out.data_ptr(), B, H, _stream()),
        "lstm_cell_int8")
    return h_out, c_out


def location_attention(h, wq, w_loc, wv, att_enc, encoded, lengths, w_prev, cum_prev):
    """-> (context (B, D), weights (B, L), cumulative weights (B, L)). On
    the card the weights and the memory are bf16 (operands rounded to bf16)
    or, K1's f32 mode, all f32 (nothing rounded)."""
    if h.device.type == "cpu":
        return location_attention_plain(h, wq, w_loc, wv, att_enc, encoded,
                                        lengths, w_prev, cum_prev)
    B, H = h.shape
    A, _, K = w_loc.shape
    L, D = encoded.shape[1], encoded.shape[2]
    f32 = wq.dtype == torch.float32
    bf = torch.float32 if f32 else torch.bfloat16  # the weights' and the memory's type
    build.require(h, torch.float32, (B, H), "h")
    build.require(wq, bf, (A, H), "wq")
    build.require(w_loc, bf, (A, 2, K), "w_loc")
    build.require(wv, bf, (A,), "wv")
    build.require(att_enc, torch.float32, (B, L, A), "att_enc")
    build.require(encoded, bf, (B, L, D), "encoded")
    build.require(lengths, torch.int32, (B,), "lengths")
    build.require(w_prev, torch.float32, (B, L), "w_prev")
    build.require(cum_prev, torch.float32, (B, L), "cum_prev")
    S = location_cluster_size(L, H, A, D, K)
    ctx = torch.empty(B, D, device=h.device)
    w = torch.empty(B, L, device=h.device)
    cum = torch.empty(B, L, device=h.device)
    name = "location_attention_f32" if f32 else "location_attention"
    _count(name)
    entry = _lib().t2_location_attention_f32 if f32 else _lib().t2_location_attention
    build.check(entry(
        h.data_ptr(), wq.data_ptr(), w_loc.data_ptr(), wv.data_ptr(),
        att_enc.data_ptr(), encoded.data_ptr(), lengths.data_ptr(),
        w_prev.data_ptr(), cum_prev.data_ptr(), ctx.data_ptr(), w.data_ptr(),
        cum.data_ptr(), B, L, H, A, D, K, S, _stream()), name)
    return ctx, w, cum


def heads(w_out, b_out, rnn_h, ctx, ctl=None, wt=None, act: Optional[torch.dtype] = None):
    """-> (B, M + 1): mel frame and gate logit over [rnn_h | ctx], or
    [rnn_h | ctx | ctl] with the controls ``ctl`` (f32). On the card the
    kernel reads ``wt``, the tiled copy of ``w_out`` (``tile_heads``, the
    pack's ``wt_out``; f32 weights: ``tile_heads_f32`` and the f32 entry,
    its inputs rounded to ``act``, None or bf16, as ``prenet``)."""
    if rnn_h.device.type == "cpu":
        return heads_plain(w_out, b_out, rnn_h, ctx, act, ctl)
    B = rnn_h.shape[0]
    N = w_out.shape[0]
    n1, n2 = rnn_h.shape[1], ctx.shape[1]
    nc = 0 if ctl is None else ctl.shape[1]
    f32 = w_out.dtype == torch.float32
    rnd = _act_bf16(act) if f32 else None
    build.require(w_out, torch.float32 if f32 else torch.bfloat16, (N, n1 + n2 + nc), "w_out")
    build.require(b_out, torch.float32, (N,), "b_out")
    build.require(rnn_h, torch.float32, (B, n1), "rnn_h")
    build.require(ctx, torch.float32, (B, n2), "ctx")
    if ctl is not None:
        build.require(ctl, torch.float32, (B, nc), "ctl")
    check_heads_dims(n1, n2, nc)
    if wt is None:
        raise ValueError("heads: the kernel reads the tiled copy of w_out (tile_heads, the "
                         "pack's wt_out); none was given")
    out = torch.empty(B, N, device=rnn_h.device)
    if f32:
        build.require(wt, torch.float32, heads_f32_tiled_shape(N, n1 + n2 + nc), "wt")
        name = "heads_f32_act_bf16" if rnd else "heads_f32"
        _count(name, controls=nc > 0)
        build.check(_lib().t2_heads_f32(wt.data_ptr(), b_out.data_ptr(), rnn_h.data_ptr(), n1,
                                        ctx.data_ptr(), n2, _ptr(ctl), nc, out.data_ptr(), B, N,
                                        int(rnd), _stream()), name)
        return out
    build.require(wt, torch.bfloat16, heads_tiled_shape(N, n1 + n2 + nc), "wt")
    _count("heads", controls=nc > 0)
    build.check(_lib().t2_heads(wt.data_ptr(), b_out.data_ptr(), rnn_h.data_ptr(), n1,
                                ctx.data_ptr(), n2, _ptr(ctl), nc, out.data_ptr(), B, N,
                                _stream()), "heads")
    return out


# ---------------------------------------------------------------------------
# the chunk of steps and the decode loop
# ---------------------------------------------------------------------------


class StepState(NamedTuple):
    mel: torch.Tensor  # (B, M) previous frame
    att_h: torch.Tensor
    att_c: torch.Tensor
    ctx: torch.Tensor
    att_w: torch.Tensor
    att_cum: torch.Tensor
    rnn_h: torch.Tensor
    rnn_c: torch.Tensor


def init_step_state(B: int, M: int, H: int, D: int, L: int, device) -> StepState:
    z = lambda *s: torch.zeros(*s, device=device)
    return StepState(z(B, M), z(B, H), z(B, H), z(B, D), z(B, L), z(B, L), z(B, H), z(B, H))


def _cells_plain(pk: PackedDecoder):
    """The plain LSTM cell for each of the pack's two blocks."""
    if pk.quantized:
        return (lambda *a: lstm_cell_int8_plain(pk.w_att, pk.s_att, pk.b_att, *a),
                lambda *a: lstm_cell_int8_plain(pk.w_dec, pk.s_dec, pk.b_dec, *a))
    return (lambda *a: lstm_cell_plain(pk.w_att, pk.b_att, *a),
            lambda *a: lstm_cell_plain(pk.w_dec, pk.b_dec, *a))


def decode_chunk_plain(pk: PackedDecoder, encoded, att_enc, lengths, s: StepState, m1, m2,
                       controls=None, controls_bf=None):
    """``decode_chunk`` in plain PyTorch, for any device (``controls_bf``,
    the kernel's bf16 operand of the controls, is not read: the decoder cell
    rounds its whole input to the weights' type)."""
    M = s.mel.shape[1]
    att_cell, dec_cell = _cells_plain(pk)
    act = ACT_INT8 if pk.quantized else None
    outs, aligns = [], []
    for t in range(m1.shape[0]):
        x = prenet_plain(s.mel, pk.wp1_t, pk.wp2_t, m1[t], m2[t], act)
        att_h, att_c = att_cell(x, s.ctx, s.att_h, s.att_c)
        ctx, w, cum = location_attention_plain(att_h, pk.wq, pk.w_loc, pk.wv, att_enc,
                                               encoded, lengths, s.att_w, s.att_cum)
        rnn_h, rnn_c = dec_cell(att_h, ctx, s.rnn_h, s.rnn_c, controls)
        mel_gate = heads_plain(pk.w_out, pk.b_out, rnn_h, ctx, act, controls)
        outs.append(mel_gate)
        aligns.append(w)
        s = StepState(mel_gate[:, :M], att_h, att_c, ctx, w, cum, rnn_h, rnn_c)
    return torch.stack(outs), torch.stack(aligns), s


def decode_chunk(pk: PackedDecoder, encoded, att_enc, lengths, s: StepState, m1, m2,
                 controls=None, controls_bf=None):
    """n = m1.shape[0] decode steps from state ``s`` with prenet masks
    (n, B, P) x 2 -> (mel_gate (n, B, M + 1), aligns (n, B, L), new state).
    A pack with controls takes them as ``stage_controls`` makes them:
    ``controls`` (B, E) f32 and, for a bf16 pack, ``controls_bf`` (B, E)
    bf16.

    On the card this is one host call (``t2_decode_chunk``) that launches
    the four kernels five times per step, the two LSTM cells on K5 (each
    after a ``quantize_xh`` launch: seven a step) when the pack is int8,
    over the pack's tiled weight copies (the cells' and the prenet's);
    each launch is counted. The pack's mode (``decode_mode``) picks the
    entries: an f32 pack runs the f32 ones (five a step, ``F32_LAUNCHES``,
    the memory f32), an int8 pack of an F32 model K5's cells, the bf16
    attention and the f32 prenet and heads with bf16 activations; a pack
    whose weights mix the types otherwise is refused."""
    if encoded.device.type == "cpu":
        return decode_chunk_plain(pk, encoded, att_enc, lengths, s, m1, m2, controls)
    n, B, Pd = m1.shape
    L, D = encoded.shape[1], encoded.shape[2]
    M, H, A = pk.wp1_t.shape[0], pk.wq.shape[1], pk.wq.shape[0]
    K = pk.w_loc.shape[2]
    bf, f32 = torch.bfloat16, torch.float32
    mode = decode_mode(pk)
    f32_mode = mode == 2  # every weight f32; 3: int8 cells, f32 prenet and heads
    lstm_dt = torch.int8 if pk.quantized else f32 if f32_mode else bf
    pre_dt = f32 if mode & 2 else bf  # the prenet's and the heads' weights
    att_dt = f32 if f32_mode else bf  # the attention's weights and the memory
    scales = (("s_att", pk.s_att, f32, (4 * H,)), ("s_dec", pk.s_dec, f32, (4 * H,))
              ) if pk.quantized else ()
    if pk.wt_att is None or pk.wt_dec is None:
        raise ValueError("the pack has no tiled copies of its LSTM weights (tile_gates takes "
                         f"H a multiple of {GATE_UNITS}; got H={H})")
    if pk.wt_prenet is None:
        raise ValueError("the pack has no tiled copy of its prenet weights (tile_prenet)")
    if pk.wt_out is None:
        raise ValueError("the pack has no tiled copy of its heads' weights (tile_heads)")
    E = pk.controls_cols
    check_heads_dims(H, D, E)
    if E:
        ctl = (("controls", controls, f32, (B, E)),) + (
            () if pk.quantized or f32_mode else (("controls_bf", controls_bf, bf, (B, E)),))
    elif controls is not None or controls_bf is not None:
        raise ValueError("the pack has no controls columns, but controls were passed")
    else:
        ctl = ()
    R1, R2 = Pd + D + H, 2 * H + D + E
    if f32_mode:
        if H % F32_GATE_UNITS:
            raise ValueError(f"the f32 cell kernel takes H a multiple of {F32_GATE_UNITS}; "
                             f"got H={H}")
        cell_copies = (("wt_att", pk.wt_att, f32, (tiled_f32_len(H, R1),)),
                       ("wt_dec", pk.wt_dec, f32, (tiled_f32_len(H, R2),)))
    else:
        esize = 1 if pk.quantized else 2
        cell_copies = (("wt_att", pk.wt_att, torch.uint8, (tiled_bytes(H, R1 * esize),)),
                       ("wt_dec", pk.wt_dec, torch.uint8, (tiled_bytes(H, R2 * esize),)))
    heads_shape = (heads_f32_tiled_shape if mode & 2 else heads_tiled_shape)(M + 1, H + D + E)
    operands_in = (
        ("w_att", pk.w_att, lstm_dt, (4 * H, R1)), ("b_att", pk.b_att, f32, (4 * H,)),
        ("w_dec", pk.w_dec, lstm_dt, (4 * H, R2)), ("b_dec", pk.b_dec, f32, (4 * H,)),
        ("wp1_t", pk.wp1_t, pre_dt, (M, Pd)), ("wp2_t", pk.wp2_t, pre_dt, (Pd, Pd)),
        ("wq", pk.wq, att_dt, (A, H)), ("w_loc", pk.w_loc, att_dt, (A, 2, K)),
        ("wv", pk.wv, att_dt, (A,)),
        ("w_out", pk.w_out, pre_dt, (M + 1, H + D + E)), ("b_out", pk.b_out, f32, (M + 1,)),
        ("att_enc", att_enc, f32, (B, L, A)), ("encoded", encoded, att_dt, (B, L, D)),
        ("lengths", lengths, torch.int32, (B,)),
        ("m1", m1, f32, (n, B, Pd)), ("m2", m2, f32, (n, B, Pd)),
        ("mel", s.mel, f32, (B, M)), ("att_h", s.att_h, f32, (B, H)),
        ("att_c", s.att_c, f32, (B, H)), ("ctx", s.ctx, f32, (B, D)),
        ("att_w", s.att_w, f32, (B, L)), ("att_cum", s.att_cum, f32, (B, L)),
        ("rnn_h", s.rnn_h, f32, (B, H)), ("rnn_c", s.rnn_c, f32, (B, H)),
        *cell_copies,
        ("wt_prenet", pk.wt_prenet, pre_dt, prenet_tiled_shape(M, Pd)),
        ("wt_out", pk.wt_out, pre_dt, heads_shape),
    ) + scales + ctl
    mixed = [f"{name} {t.dtype}" for name, t, dt, _ in operands_in
             if t is not None and t.dtype != dt]
    if mixed:
        raise ValueError(f"a pack of mode {mode} ({lstm_dt} cells, {pre_dt} prenet and heads, "
                         f"{att_dt} attention and memory) got {', '.join(mixed)}")
    for name, t, dt, shape in operands_in:
        if t is None:
            raise ValueError(f"{name}: the pack takes it, none was given")
        build.require(t, dt, shape, name)
    dev = encoded.device
    mel_gate = torch.empty(n, B, M + 1, device=dev)
    aligns = torch.empty(n, B, L, device=dev)
    x = torch.empty(B, Pd, device=dev)
    pp = {k: torch.empty(2, B, w, device=dev)
          for k, w in (("att_h", H), ("att_c", H), ("ctx", D), ("att_cum", L),
                       ("rnn_h", H), ("rnn_c", H))}
    # bf16 mode: the cells' bf16 operands, written by their producers; slot 1
    # of the ping-pong pairs and the context start from the state in
    operands = (None,) * 4
    quantized = (None, None)
    if pk.quantized:  # K5's operand, rewritten before each cell
        quantized = (torch.empty(B, max(Pd + D + H, 2 * H + D + E), device=dev,
                                 dtype=torch.int8),
                     torch.empty(B, device=dev))
    elif not f32_mode:
        x_bf = torch.empty(B, Pd, device=dev, dtype=bf)
        atth_bf = torch.empty(2, B, H, device=dev, dtype=bf)
        rnnh_bf = torch.empty(2, B, H, device=dev, dtype=bf)
        atth_bf[1] = s.att_h
        rnnh_bf[1] = s.rnn_h
        operands = (x_bf, s.ctx.to(bf), atth_bf, rnnh_bf)
    # slot 9: the heads read their tiled copy, not w_out
    tensors = (*pk[:9], pk.wt_out, pk.b_out, att_enc, encoded, lengths, m1, m2, *s, mel_gate,
               aligns, x, pp["att_h"], pp["att_c"], pp["ctx"], pp["att_cum"], pp["rnn_h"],
               pp["rnn_c"])
    ptrs = (ctypes.c_void_p * 46)(*(t.data_ptr() for t in tensors), _ptr(pk.s_att),
                                  _ptr(pk.s_dec), pk.wt_att.data_ptr(), pk.wt_dec.data_ptr(),
                                  *(_ptr(t) for t in operands), *(_ptr(t) for t in quantized),
                                  pk.wt_prenet.data_ptr(), _ptr(controls if E else None),
                                  _ptr(controls_bf if E and mode == 0 else None))
    dims = (ctypes.c_int * 12)(n, B, M, Pd, H, D, L, A, K, mode,
                               location_cluster_size(L, H, A, D, K), E)
    cell = "lstm_cell_int8" if pk.quantized else "lstm_cell_f32" if f32_mode else "lstm_cell"
    act = "_act_bf16" if mode == 3 else ""  # the int8 mode's f32 entries round to bf16
    _count("prenet" + ("_f32" + act if mode & 2 else ""), n)
    _count(cell, n)  # the attention cell's
    _count(cell, n, controls=E > 0)  # the decoder cell's, with the controls
    if pk.quantized:
        _count("quantize_xh", n)
        _count("quantize_xh", n, controls=E > 0)
    _count("location_attention_f32" if f32_mode else "location_attention", n)
    _count("heads" + ("_f32" + act if mode & 2 else ""), n, controls=E > 0)
    build.check(_lib().t2_decode_chunk(ptrs, dims, _stream()), "decode_chunk")
    last = (n - 1) % 2
    new = StepState(mel_gate[n - 1, :, :M].contiguous(), pp["att_h"][last], pp["att_c"][last],
                    pp["ctx"][last], aligns[n - 1], pp["att_cum"][last], pp["rnn_h"][last],
                    pp["rnn_c"][last])
    return mel_gate, aligns, new


def prenet_masks(n: int, B: int, Pd: int, dropout: float, generator, device):
    """AlwaysDropout scale masks (n, B, P) x 2 from a torch.Generator, or
    from a sequence of B generators, one per row: row b then draws its m1
    and m2 at (n, 1, P) from its own, as a batch of one seeded alike does,
    so a row's masks do not depend on the rest of the batch."""
    if isinstance(generator, Sequence):
        if len(generator) != B:
            raise ValueError(f"{len(generator)} row generators for {B} rows")
        rows = [prenet_masks(n, 1, Pd, dropout, g, device) for g in generator]
        return tuple(torch.cat(m, dim=1) for m in zip(*rows))
    keep = 1.0 - dropout
    m1 = (torch.rand(n, B, Pd, generator=generator, device=device) < keep).float() / keep
    m2 = (torch.rand(n, B, Pd, generator=generator, device=device) < keep).float() / keep
    return m1, m2


def decode(pk: PackedDecoder, encoded, att_enc, lengths, max_len: int,
           dropout: float = 0.5, generator=None, prenet_dropout: bool = True,
           masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, controls=None):
    """Free-running decode with early stop checked once per 64-frame chunk.

    encoded (B, L, D) in the type of ``pk.wq``, att_enc (B, L, A) f32,
    lengths (B,) int32; ``controls`` (B, controls_dim) for a pack with
    controls columns (each row its own), staged once for the whole decode
    (``stage_controls``). ``masks``: optional precomputed prenet masks (T, B,
    P) x 2, frame t's masks applying to the prenet of frame t-1's mel;
    otherwise they are drawn per chunk from ``generator``, one
    torch.Generator or one per row (``prenet_masks``). Returns (mels (B, T, M)
    raw over the executed frames and zero past them, gates (B, T) with
    -1000 past them, aligns (B, T, L), lengths (B,), executed frames)."""
    B, L, D = encoded.shape
    dev = encoded.device
    M = pk.wp1_t.shape[0]
    H = pk.wq.shape[1]
    Pd = pk.wp2_t.shape[0]
    s = init_step_state(B, M, H, D, L, dev)
    use_dropout = prenet_dropout and dropout > 0.0
    ctl = stage_controls(pk, controls, B, dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    mel_gate_chunks, align_chunks = [], []
    n_chunks = -(-max_len // T_CHUNK)
    for k in range(n_chunks):
        t0 = k * T_CHUNK
        n = min(T_CHUNK, max_len - t0)
        if masks is not None:
            m1, m2 = masks[0][t0:t0 + n], masks[1][t0:t0 + n]
        elif use_dropout:
            m1, m2 = prenet_masks(n, B, Pd, dropout, generator, dev)
        else:
            m1 = m2 = torch.ones(n, B, Pd, device=dev)
        chunk, aligns, s = decode_chunk(pk, encoded, att_enc, lengths, s, m1, m2, *ctl)
        mel_gate_chunks.append(chunk)  # (n, B, M + 1)
        align_chunks.append(aligns)
        done = done | (chunk[:, :, M] < 0.0).any(dim=0)
        if bool(done.all()):  # the one host sync per chunk
            break

    mel_gate = torch.cat(mel_gate_chunks).transpose(0, 1)  # (B, Tc, M + 1)
    aligns = torch.cat(align_chunks).transpose(0, 1)  # (B, Tc, L)
    Tc = mel_gate.shape[1]
    gates_raw = mel_gate[:, :, M]
    # reference stop bookkeeping: per executed step done |= gate < 0 and
    # lengths += gate >= 0; the loop ends right after the step where every
    # row has fired. The chunk may run past that step: exclude those frames.
    fired = gates_raw < 0.0
    all_fired_by_t = (torch.cumsum(fired.int(), dim=1) > 0).all(dim=0)  # (Tc,)
    not_done = (~all_fired_by_t).int()
    executed = torch.cat([torch.ones(1, dtype=torch.int32, device=dev),
                          torch.cumprod(not_done, dim=0)[:-1].int()]) > 0
    out_lengths = ((gates_raw >= 0.0) & executed[None, :]).sum(dim=1).int()
    n_exec = int(executed.sum())

    ex = executed.float()
    mels = torch.zeros(B, max_len, M, device=dev)
    mels[:, :Tc] = mel_gate[:, :, :M] * ex[None, :, None]
    gates = torch.full((B, max_len), -1000.0, device=dev)
    gates[:, :Tc] = torch.where(executed[None, :], gates_raw, torch.full_like(gates_raw, -1000.0))
    al = torch.zeros(B, max_len, L, device=dev)
    al[:, :Tc] = aligns * ex[None, :, None]
    return mels, gates, al, out_lengths, n_exec
