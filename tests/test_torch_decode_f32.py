"""K1's f32 mode and the F32 teacher-forced route, at small sizes on the CPU.

The JAX package decodes a model whose precision is ``"32-true"`` / ``"32"``
(its default policy) on ``_decode_chunk_kernel`` with f32 weights (``dt =
w_s.dtype``, decoder_loop_pallas.py:386), and trains it on its XLA scan
``run_decode_scan`` (``pallas_train_supported`` is false outside bf16). The
port's counterparts:

- the f32 pack's tiled copies read back element for element through the
  kernels' offset functions (``tile_gates_f32`` / ``gate_f32_offset``,
  ``tile_heads_f32`` / ``heads_f32_offset``, ``tile_prenet`` of f32
  weights), made once by ``pack_decoder``; the int8 pack of an F32 model
  (the prenet and heads f32, the attention bf16, the cells int8) against
  JAX ``pack_decoder_params(dtype=f32, quantize=True)`` entry for entry;
- the wrappers and the chunk on meta tensors with a stand-in library: an f32
  chunk launches the f32 entries, 5 a step (``F32_LAUNCHES``), the int8
  chunk of an F32 model 7 (the prenet and heads as ``*_act_bf16``), a bf16
  chunk what it did before; the wrappers pick the f32 entries by the
  weights' type and refuse inputs and packs of mixed types;
- the F32 teacher-forced decode (``train_scan.TeacherDecodeTP`` without a
  model group) against JAX's ``run_decode_scan`` on the same weights and
  LSTM masks, forward and gradients, within ``3e-5 * max + 1e-7`` (the
  32-true tolerance of tests/test_torch_train_decode.py); the route chosen
  by the policy in ``Tacotron2.forward_teacher``; K3's wrapper refusing f32
  weights.
"""

import functools

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tacotron2_tpu.models import decoder as jax_decoder
from tacotron2_tpu.models.layers import Policy as JaxPolicy
from tacotron2_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from tacotron2_tpu.models.tacotron2 import Tacotron2Config as JaxConfig
from tacotron2_tpu.ops import train_scan as jax_train_scan
from tacotron2_tpu.ops.decoder_loop_pallas import pack_decoder_params
from tacotron2_tpu_torch.convert import from_jax_params
from tacotron2_tpu_torch.models.layers import Policy
from tacotron2_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from tacotron2_tpu_torch.ops import build
from tacotron2_tpu_torch.ops import decoder_loop as dl
from tacotron2_tpu_torch.ops import train_decode as td
from tacotron2_tpu_torch.ops import train_scan
from tacotron2_tpu_torch.parallel import mesh
from tests.test_torch_decode import CFG as DEC_CFG
from tests.test_torch_decode_cells import _FakeLib, _meta
from tests.test_torch_train_decode import (CFG as TD_CFG, LENS, TOL, _assert_close, _loss,
                                           _port_params)

torch.set_num_threads(1)

F32 = torch.float32
# a model the kernels' splits take: the prenet's cluster (P = 64), the heads'
# 16-column pieces (H, D), the f32 cell's 8-unit blocks
CFG = dict(num_chars=20, encoded_dim=16, encoder_kernel_size=5, num_mels=8, prenet_dim=64,
           att_rnn_dim=32, att_dim=8, rnn_hidden_dim=32, postnet_dim=16, dropout=0.5)


def _model(precision="32-true", controls_dim=0):
    torch.manual_seed(0)
    return Tacotron2(Tacotron2Config(**CFG, controls_dim=controls_dim),
                     Policy.from_string(precision)).eval()


# ---------------------------------------------------------------------------
# the f32 pack's layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("H,R", [(16, 200), (32, 128), (48, 40), (1024, 1792)])
def test_tile_gates_f32_reads_back(H, R):
    """Every weight of ``tile_gates_f32``' copy at the offset the f32 cell
    kernel reads (``gate_f32_offset``), every other element zero (the rows'
    pad to whole 64-column chunks)."""
    g = torch.Generator().manual_seed(H + R)
    w = torch.randn(4 * H, R, generator=g)
    wt = dl.tile_gates_f32(w)
    assert wt.dtype == F32 and wt.shape == (dl.tiled_f32_len(H, R),)
    rows, cols = torch.meshgrid(torch.arange(4 * H), torch.arange(R), indexing="ij")
    off = dl.gate_f32_offset(rows, cols, H, R)
    assert torch.equal(wt[off], w)
    covered = torch.zeros_like(wt, dtype=torch.bool)
    covered[off.reshape(-1)] = True
    assert int(covered.sum()) == w.numel() and not wt[~covered].any()
    # a cluster's chunk is one contiguous run of 64 rows x 64 columns: cluster
    # gi, chunk c starts at (gi nk + c) 4096; unit u's column 0 is register
    # u // 8 of lane 4 (u % 8) of its gate's m16 tile, k8 step 0
    nk = -(-R // dl.F32_GATE_CHUNK)
    j = torch.arange(H)
    assert torch.equal(dl.gate_f32_offset(j, torch.zeros_like(j), H, R),
                       (j // 16) * nk * 4096 + (j % 8) * 16 + (j % 16) // 8)
    if H > 16 and nk > 1:
        assert int(dl.gate_f32_offset(16, 64, H, R)) == (nk + 1) * 64 * 64


def test_tile_gates_f32_takes_whole_blocks():
    """H off a multiple of 8 (the f32 cell's block of units) gets no copy."""
    assert dl.tile_gates_f32(torch.zeros(4 * 12, 64)) is None


@pytest.mark.parametrize("N,K", [(81, 1536), (81, 1552), (17, 48), (9, 32)])
def test_tile_heads_f32_reads_back(N, K):
    """Every weight of ``tile_heads_f32``' copy at ``heads_f32_offset``,
    zero past N rows and K columns; a rank's pieces one contiguous run, a
    piece the A fragments of its m16 tiles and two k8 steps."""
    g = torch.Generator().manual_seed(N + K)
    w = torch.randn(N, K, generator=g)
    wt = dl.tile_heads_f32(w)
    assert wt.dtype == F32 and wt.shape == dl.heads_f32_tiled_shape(N, K)
    rows, cols = torch.meshgrid(torch.arange(N), torch.arange(K), indexing="ij")
    flat = wt.reshape(-1)
    assert torch.equal(flat[dl.heads_f32_offset(rows, cols, N)], w)
    assert float(flat.abs().sum()) == pytest.approx(float(w.abs().sum()), rel=1e-6)
    NP = dl.heads_rows(N)
    assert int(dl.heads_f32_offset(0, 16, N)) == 16 * NP  # piece 1 after piece 0's 16 NP
    assert int(dl.heads_f32_offset(8, 1, N)) == 1 + 2  # row 8, column 1: lane 0, register 3


def test_pack_makes_the_f32_copies_once():
    """``pack_decoder`` of an F32 model (one call): every weight f32, the
    cells' copies ``tile_gates_f32``'s, the prenet's ``tile_prenet``'s of
    its f32 weights (read back through ``prenet_tile_offset``), the heads'
    ``tile_heads_f32``'s; the pack's mode 2."""
    m = _model()
    n0 = dl.PACK_CALLS[0]
    pk = m.make_packed_decoder()
    assert dl.PACK_CALLS[0] == n0 + 1 and dl.decode_mode(pk) == 2 and not pk.quantized
    for name in ("w_att", "w_dec", "wp1_t", "wp2_t", "wq", "w_loc", "wv", "w_out",
                 "wt_att", "wt_dec", "wt_prenet", "wt_out"):
        assert getattr(pk, name).dtype == F32, name
    assert torch.equal(pk.wt_att, dl.tile_gates_f32(pk.w_att))
    assert torch.equal(pk.wt_dec, dl.tile_gates_f32(pk.w_dec))
    assert torch.equal(pk.wt_out, dl.tile_heads_f32(pk.w_out))
    M, P = pk.wp1_t.shape
    assert pk.wt_prenet.shape == dl.prenet_tiled_shape(M, P)
    k, p = torch.meshgrid(torch.arange(M + P), torch.arange(P), indexing="ij")
    both = torch.cat([pk.wp1_t, pk.wp2_t])
    assert torch.equal(pk.wt_prenet.reshape(-1)[dl.prenet_tile_offset(k, p, M, P)], both)
    cm = _model(controls_dim=5)
    cpk = cm.make_packed_decoder()
    c32, _ = dl.stage_controls(cpk, torch.randn(2, 5), 2, "cpu")
    assert c32.shape == (2, 16) and c32.dtype == F32 and dl.decode_mode(cpk) == 2


def test_prenet_f32_smem_rule():
    """The f32 prenet's block holds its slice at 4 bytes a weight: the
    flagship dims fit, the split's other rules are the bf16 kernel's."""
    assert dl.prenet_units(80, 256, 4) == 32
    with pytest.raises(ValueError, match="shared memory"):
        dl.prenet_units(4096, 2048, 4)


def test_int8_pack_of_an_f32_model_equals_jax():
    """The int8 pack of a 32-true model: the cells int8 with one scale per
    gate row (quantised from the f32 weights), the prenet and heads f32 (as
    JAX's pack with dtype f32 keeps them), the attention bf16 (JAX's kernel
    casts them at use, dt = bf16 when quantized): entry for entry against
    JAX ``pack_decoder_params(dtype=f32, quantize=True)``; mode 3."""
    jm = JaxTacotron2(JaxConfig(**DEC_CFG), JaxPolicy.from_string("32-true"))
    params, state = jm.init(jax.random.PRNGKey(0))
    tm = Tacotron2(Tacotron2Config(**DEC_CFG), Policy.from_string("32-true"))
    tm.load_state_dict(from_jax_params(params, state))
    H, D = DEC_CFG["att_rnn_dim"], DEC_CFG["encoded_dim"]
    P, M = DEC_CFG["prenet_dim"], DEC_CFG["num_mels"]
    jp = pack_decoder_params(params, M, D, H, H, P, 0, dtype=jnp.float32, quantize=True,
                             resident_cols=0)
    pk = tm.make_packed_decoder(quantize=True)
    assert dl.decode_mode(pk) == 3
    ws = np.asarray(jp.w_stream)
    R1 = P + D + H
    np.testing.assert_array_equal(pk.w_att.numpy(), ws[:R1, :4 * H].T)
    dec = ws[:, 4 * H:]
    np.testing.assert_array_equal(pk.w_dec.numpy(), np.concatenate([dec[:H + D],
                                                                   dec[H + D + 16:]]).T)
    scales = np.asarray(jp.w_scales)[0]
    np.testing.assert_array_equal(pk.s_att.numpy(), scales[:4 * H])
    np.testing.assert_array_equal(pk.s_dec.numpy(), scales[4 * H:])
    for name, ref in (("wp1_t", jp.wp1), ("wp2_t", jp.wp2)):
        t = getattr(pk, name)
        assert t.dtype == F32, name
        np.testing.assert_array_equal(t.numpy(), np.asarray(ref))
    assert pk.w_out.dtype == F32
    np.testing.assert_array_equal(pk.w_out.numpy(), np.asarray(jp.w_out)[:H + D, :M + 1].T)
    assert not np.asarray(jp.w_out)[H + D:].any()  # JAX's controls rows, zero without controls
    bf = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
    assert torch.equal(pk.wq, bf(np.asarray(jp.wq).T))  # JAX's (H, A), input-major
    assert torch.equal(pk.wv, bf(np.asarray(jp.wv).reshape(-1)))
    wl = np.asarray(jp.w_loc_win, np.float32)  # rows 0..30 the previous, 32..62 the cumulative
    ref = torch.stack([bf(wl[0:31].T), bf(wl[32:63].T)], dim=1)
    assert pk.w_loc.dtype == torch.bfloat16
    torch.testing.assert_close(pk.w_loc.float(), ref.float(), rtol=2 ** -8, atol=0)


# ---------------------------------------------------------------------------
# the wrappers and the chunk on meta tensors with a stand-in library
# ---------------------------------------------------------------------------


class _FakeF32Lib(_FakeLib):
    """``_FakeLib`` with the f32 entries."""

    def t2_lstm_cell_f32(self, *args):
        self.calls.append(("lstm_cell_f32", args))
        return 0

    def t2_prenet_f32(self, *args):
        self.calls.append(("prenet_f32", args))
        return 0

    def t2_location_attention(self, *args):
        self.calls.append(("location_attention", args))
        return 0

    def t2_location_attention_f32(self, *args):
        self.calls.append(("location_attention_f32", args))
        return 0

    def t2_heads_f32(self, *args):
        self.calls.append(("heads_f32", args))
        return 0


def _require_on_meta(t, dtype, shape, name):
    """``build.require`` but the device: meta tensors stand for CUDA ones."""
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {dtype} tensor, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want shape {tuple(shape)}, got {tuple(t.shape)}")


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeF32Lib()
    monkeypatch.setattr(dl, "_lib", lambda: lib)
    monkeypatch.setattr(dl, "_stream", lambda: 0)
    monkeypatch.setattr(build, "require", _require_on_meta)
    return lib


H, D, P, M, A, K, L = 64, 32, 64, 8, 8, 31, 20


def _meta_pack(mode: int, E: int = 0) -> dl.PackedDecoder:
    """A pack on meta tensors of ``decode_mode`` ``mode`` (0 bf16, 1 int8, 2
    f32, 3 int8 of an F32 model), ``E`` controls columns."""
    bf, i8 = torch.bfloat16, torch.int8
    cell = {0: bf, 1: i8, 2: F32, 3: i8}[mode]
    pre = F32 if mode & 2 else bf
    att = F32 if mode == 2 else bf
    R1, R2 = P + D + H, 2 * H + D + E
    if cell == F32:
        copies = (_meta(dl.tiled_f32_len(H, R1)), _meta(dl.tiled_f32_len(H, R2)))
    else:
        es = 1 if cell == i8 else 2
        copies = (_meta(dl.tiled_bytes(H, es * R1), dtype=torch.uint8),
                  _meta(dl.tiled_bytes(H, es * R2), dtype=torch.uint8))
    scales = dict(s_att=_meta(4 * H), s_dec=_meta(4 * H)) if cell == i8 else {}
    heads = (dl.heads_f32_tiled_shape if pre == F32 else dl.heads_tiled_shape)(M + 1, H + D + E)
    return dl.PackedDecoder(
        _meta(4 * H, R1, dtype=cell), _meta(4 * H), _meta(4 * H, R2, dtype=cell), _meta(4 * H),
        _meta(M, P, dtype=pre), _meta(P, P, dtype=pre), _meta(A, H, dtype=att),
        _meta(A, 2, K, dtype=att), _meta(A, dtype=att), _meta(M + 1, H + D + E, dtype=pre),
        _meta(M + 1), **scales, wt_att=copies[0], wt_dec=copies[1],
        wt_prenet=_meta(*dl.prenet_tiled_shape(M, P), dtype=pre),
        wt_out=_meta(*heads, dtype=pre))


def _meta_chunk(pk, B, n, controls=None, enc_dtype=None):
    s = dl.StepState(_meta(B, M), _meta(B, H), _meta(B, H), _meta(B, D), _meta(B, L),
                     _meta(B, L), _meta(B, H), _meta(B, H))
    enc = _meta(B, L, D, dtype=enc_dtype or pk.wq.dtype)
    ctl = () if controls is None else controls
    return dl.decode_chunk(pk, enc, _meta(B, L, A), _meta(B, dtype=torch.int32), s,
                           _meta(n, B, P), _meta(n, B, P), *ctl)


def _grown(before):
    now = {**dl.LAUNCHES, **dl.F32_LAUNCHES}
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
@pytest.mark.parametrize("B,n", [(1, 64), (16, 4), (64, 1)])
def test_chunk_counts_what_it_launches(fake, mode, B, n):
    """One host call of n steps: the f32 chunk (mode 2) counts the f32
    entries, 5 a step, and nothing of the bf16 ones; the int8 chunk of an
    F32 model (mode 3) K5's cells and quantize_xh, the bf16 attention and
    the f32 prenet and heads with bf16 activations, 7 a step; the bf16
    (0) and int8 (1) chunks what they counted before, nothing of
    ``F32_LAUNCHES``. The call gets the mode in d[9], the same 46 pointer
    slots and 12 dims as ever; the bf16 operand slots are null but in mode
    0."""
    pk = _meta_pack(mode)
    before = {**dl.LAUNCHES, **dl.F32_LAUNCHES}
    _meta_chunk(pk, B, n)
    want = {0: {"prenet": n, "lstm_cell": 2 * n, "location_attention": n, "heads": n},
            1: {"prenet": n, "quantize_xh": 2 * n, "lstm_cell_int8": 2 * n,
                "location_attention": n, "heads": n},
            2: {"prenet_f32": n, "lstm_cell_f32": 2 * n, "location_attention_f32": n,
                "heads_f32": n},
            3: {"prenet_f32_act_bf16": n, "quantize_xh": 2 * n, "lstm_cell_int8": 2 * n,
                "location_attention": n, "heads_f32_act_bf16": n}}[mode]
    assert _grown(before) == want
    assert sum(want.values()) == (7 if mode & 1 else 5) * n
    [(kind, ptrs, dims)] = fake.calls
    assert kind == "chunk" and len(ptrs) == 46 and len(dims) == 12
    assert dims[:2] == [n, B] and dims[9] == mode and dims[11] == 0
    assert dims[10] == dl.location_cluster_size(L, H, A, D, K)
    assert ptrs[44:] == [None, None]
    if mode != 0:  # the bf16 operands: K1's bf16 cells' alone
        assert ptrs[37:41] == [None] * 4


@pytest.mark.parametrize("mode", [2, 3])
def test_chunk_counts_the_controls_rows(fake, mode):
    """With controls, the f32 chunk's decoder cell and heads (the int8 one's
    cell, quantize_xh and heads) read them: counted in CONTROLS_LAUNCHES
    and, the f32 entries, F32_CONTROLS_LAUNCHES;
    the f32 chunk takes the controls' f32 copy alone (slot 45 null)."""
    E, B, n = 16, 2, 3
    pk = _meta_pack(mode, E)
    ctl = lambda: {**dl.CONTROLS_LAUNCHES, **dl.F32_CONTROLS_LAUNCHES}
    before = ctl()
    _meta_chunk(pk, B, n, (_meta(B, E), None))
    grown = {k: ctl()[k] - before[k] for k in before if ctl()[k] != before[k]}
    assert grown == ({"lstm_cell_f32": n, "heads_f32": n} if mode == 2 else
                     {"lstm_cell_int8": n, "quantize_xh": n, "heads_f32_act_bf16": n})
    [(_, ptrs, dims)] = fake.calls
    assert dims[11] == E and ptrs[45] is None


@pytest.mark.parametrize("mode,field,dtype", [
    (2, "wp1_t", torch.bfloat16),   # an f32 pack with a bf16 prenet
    (2, "wq", torch.bfloat16),      # an f32 pack with a bf16 attention
    (2, "w_out", torch.bfloat16),   # an f32 pack with bf16 heads
    (3, "wq", F32),                 # the int8 pack of an F32 model with an f32 attention
    (0, "w_out", F32),              # a bf16 pack with f32 heads
])
def test_chunk_refuses_a_mixed_pack(fake, mode, field, dtype):
    """A pack whose weights mix the types otherwise than a mode takes is
    refused before anything launches."""
    pk = _meta_pack(mode)
    pk = pk._replace(**{field: _meta(*getattr(pk, field).shape, dtype=dtype)})
    before = {**dl.LAUNCHES, **dl.F32_LAUNCHES}
    with pytest.raises(ValueError, match="mode"):
        _meta_chunk(pk, 2, 1)
    assert {**dl.LAUNCHES, **dl.F32_LAUNCHES} == before and fake.calls == []


def test_chunk_refuses_a_bf16_memory_for_the_f32_pack(fake):
    with pytest.raises(ValueError, match="encoded"):
        _meta_chunk(_meta_pack(2), 2, 1, enc_dtype=torch.bfloat16)
    assert fake.calls == []


@pytest.mark.parametrize("B", [1, 64])
def test_f32_wrappers_launch_the_f32_entries(fake, B):
    """Each wrapper picks the f32 entry by its weights' type (one counted
    launch in ``F32_LAUNCHES``, none in ``LAUNCHES``), over the f32 copies,
    the prenet's and heads' activation rounding passed as a flag."""
    pk = _meta_pack(2)
    before = {**dl.LAUNCHES, **dl.F32_LAUNCHES}
    xs = (_meta(B, P), _meta(B, D), _meta(B, H))
    dl.lstm_cell(pk.w_att, pk.b_att, *xs, _meta(B, H), pk.wt_att)
    pre = (_meta(B, M), pk.wp1_t, pk.wp2_t, _meta(B, P), _meta(B, P))
    dl.prenet(*pre, pk.wt_prenet)
    dl.prenet(*pre, pk.wt_prenet, act=torch.bfloat16)
    dl.location_attention(_meta(B, H), pk.wq, pk.w_loc, pk.wv, _meta(B, L, A), _meta(B, L, D),
                          _meta(B, dtype=torch.int32), _meta(B, L), _meta(B, L))
    hd = (pk.w_out, pk.b_out, _meta(B, H), _meta(B, D))
    dl.heads(*hd, wt=pk.wt_out)
    dl.heads(*hd, wt=pk.wt_out, act=torch.bfloat16)
    assert [k for k, _ in fake.calls] == ["lstm_cell_f32", "prenet_f32", "prenet_f32",
                                         "location_attention_f32", "heads_f32", "heads_f32"]
    assert fake.calls[0][1][-3:] == (B, H, 0) and fake.calls[0][1][0] == pk.wt_att.data_ptr()
    assert [c[1][8] for c in fake.calls[1:3]] == [0, 1]  # t2_prenet_f32's act_bf16
    assert [c[1][11] for c in fake.calls[4:6]] == [0, 1]  # t2_heads_f32's act_bf16
    assert fake.calls[4][1][9:11] == (B, M + 1)
    assert _grown(before) == {"lstm_cell_f32": 1, "prenet_f32": 1, "prenet_f32_act_bf16": 1,
                              "location_attention_f32": 1, "heads_f32": 1,
                              "heads_f32_act_bf16": 1}


def test_wrappers_refuse_mixed_inputs(fake):
    """The cell wrappers take their inputs in their kernel's type and cast
    nothing: f32 inputs to the bf16 cell and bf16 ones to the f32 cell are
    refused; an f32 copy is refused by the bf16 cell and a bf16 memory by
    the f32 attention; ``act`` is None or bf16."""
    B = 2
    f32p, bfp = _meta_pack(2), _meta_pack(0)
    f32x = (_meta(B, P), _meta(B, D), _meta(B, H))
    bfx = tuple(_meta(*x.shape, dtype=torch.bfloat16) for x in f32x)
    with pytest.raises(ValueError, match="bfloat16"):
        dl.lstm_cell(bfp.w_att, bfp.b_att, *f32x, _meta(B, H), bfp.wt_att)
    with pytest.raises(ValueError, match="float32"):
        dl.lstm_cell(f32p.w_att, f32p.b_att, *bfx, _meta(B, H), f32p.wt_att)
    with pytest.raises(ValueError, match="wt"):
        dl.lstm_cell(bfp.w_att, bfp.b_att, *bfx, _meta(B, H), f32p.wt_att)
    with pytest.raises(ValueError, match="encoded"):
        dl.location_attention(_meta(B, H), f32p.wq, f32p.w_loc, f32p.wv, _meta(B, L, A),
                              _meta(B, L, D, dtype=torch.bfloat16), _meta(B, dtype=torch.int32),
                              _meta(B, L), _meta(B, L))
    with pytest.raises(ValueError, match="act"):
        dl.heads(f32p.w_out, f32p.b_out, _meta(B, H), _meta(B, D), wt=f32p.wt_out,
                 act=torch.float16)
    assert fake.calls == []
    # bf16 inputs to the bf16 cell, as the chunk's producers write them, are taken
    dl.lstm_cell(bfp.w_att, bfp.b_att, *bfx, _meta(B, H), bfp.wt_att)
    assert [k for k, _ in fake.calls] == ["lstm_cell"]


def test_f32_cell_refuses_partial_column_groups(fake):
    """The f32 cell copies its input by 16-column groups: a segment of
    another width is refused before any launch."""
    B = 2
    f32p = _meta_pack(2)
    x = (_meta(B, P - 4), _meta(B, D + 4), _meta(B, H))
    with pytest.raises(ValueError, match="16-column"):
        dl.lstm_cell(f32p.w_att, f32p.b_att, *x, _meta(B, H), f32p.wt_att)
    assert fake.calls == []


def test_f32_cell_constants_mirror_the_kernel():
    """The host's f32 cell tiling (units a cluster, columns a chunk) equals
    the source's, and so do the heads' pieces (``tile_heads_f32``: two k8
    steps of the tf32 mma a piece)."""
    import re
    from pathlib import Path

    src = (Path(dl.__file__).parents[1] / "csrc" / "decode_step.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("CF_U") == dl.F32_GATE_UNITS
    assert const("CF_KC") == dl.F32_GATE_CHUNK
    assert dl.heads_f32_tiled_shape(81, 1536)[2:] == (dl.HEADS_PIECE // 8, 32, 4)


# ---------------------------------------------------------------------------
# the f32 cell's and heads' three-pass TF32 products
# ---------------------------------------------------------------------------

K1F_TOL = chip_smoke.K1F_TOL  # the card's limit of an f32 entry against its plain version


def _fragments(a: torch.Tensor) -> torch.Tensor:
    """The A fragments of an m16n8k8 tf32 mma, (..., 32 lanes, 4 registers)
    -> the (..., 16, 8) tile they hold: lane 4 g + t holds rows g, g + 8 of
    columns t (registers 0, 1) and t + 4 (registers 2, 3)."""
    g, t = torch.arange(32) // 4, torch.arange(32) % 4
    out = a.new_zeros(*a.shape[:-2], 16, 8)
    for e, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 4), (8, 4))):
        out[..., g + dr, t + dk] = a[..., e]
    return out


def _step_columns(s: int) -> torch.Tensor:
    """The columns (within a 16-column pair of k8 steps) that k = 0..7 of k8
    step s take: lane t's four consecutive columns 4 t .. 4 t + 3, step 2 q +
    h the columns 4 t + 2 h (k = t) and 4 t + 2 h + 1 (k = t + 4), as the
    kernels load the input's fragment of a pair as one float4."""
    t, h = torch.arange(4), s % 2
    return torch.cat([4 * t + 2 * h, 4 * t + 2 * h + 1]) + 16 * (s // 2)


def _cell_kernel_gates(wt, x, H: int, R: int) -> torch.Tensor:
    """The f32 cell kernel's products as its lanes index them, in f64: each
    cluster's chunks, each m16 tile (a gate) and k8 step, A from the tiled
    copy's fragments and B the input's columns that the step takes (zero
    past R) -> the gate sums (B, 4H) without the bias."""
    nk = -(-R // dl.F32_GATE_CHUNK)
    steps = dl.F32_GATE_CHUNK // 8
    A = _fragments(wt.double().reshape(H // 16, nk, 4, steps, 32, 4))  # gi c mt s 16 8
    xp = F.pad(x.double(), (0, nk * dl.F32_GATE_CHUNK - R)).view(x.shape[0], nk, -1)
    gates = x.new_zeros(x.shape[0], 4, H // 16, 16, dtype=torch.float64)  # b gate gi unit
    for s in range(steps):
        xb = xp[:, :, _step_columns(s)]  # (B, c, 8)
        gates += torch.einsum("icmrk,bck->bmir", A[:, :, :, s], xb)
    return gates.reshape(x.shape[0], 4 * H)


@pytest.mark.parametrize("H,R,B", [(16, 200, 3), (32, 80, 9), (48, 40, 1)])
def test_f32_cell_fragments_compute_the_product(H, R, B):
    """The f32 cell's indexing end to end: the tiled copy's A fragments
    against the input's columns that each lane loads (``_step_columns``),
    summed over every cluster's chunks, equal the gate GEMM x . W^T (f64)."""
    g = torch.Generator().manual_seed(H * R + B)
    w = torch.randn(4 * H, R, generator=g)
    x = torch.randn(B, R, generator=g)
    got = _cell_kernel_gates(dl.tile_gates_f32(w), x, H, R)
    torch.testing.assert_close(got, x.double() @ w.double().t(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("N,K,B", [(81, 1552, 5), (17, 48, 2), (9, 32, 16)])
def test_f32_heads_fragments_compute_the_product(N, K, B):
    """The f32 heads' indexing end to end: ``tile_heads_f32``'s A fragments
    of each piece, m16 tile and k8 step against the input's columns of the
    step equal x . W_out^T (f64) over the padded rows."""
    g = torch.Generator().manual_seed(N + K + B)
    w = torch.randn(N, K, generator=g)
    x = torch.randn(B, K, generator=g)
    nk, MT = dl.heads_f32_tiled_shape(N, K)[:2]
    A = _fragments(dl.tile_heads_f32(w).double())  # (piece, mt, step, 16, 8)
    xp = x.double().view(B, nk, dl.HEADS_PIECE)
    out = sum(torch.einsum("pmrk,bpk->bmr", A[:, :, s], xp[:, :, _step_columns(s)])
              for s in range(2)).reshape(B, MT * 16)
    torch.testing.assert_close(out[:, :N], x.double() @ w.double().t(), rtol=1e-12, atol=1e-12)
    assert not out[:, N:].any()


@pytest.mark.parametrize("kh", [0, 1])
@pytest.mark.parametrize("NR", [8, 64])
def test_f32_cell_wgmma_planes_hold_the_steps(kh, NR):
    """The f32 cell's wgmma instance: warpgroup kh's split pass (thread (row,
    k16 group) storing four columns of a core matrix's row) writes hi / lo
    planes that wgmma, through its descriptor (K-major core matrices, lbo =
    NR x 16 bytes along K, sbo = 128 along N), reads as B[k][n] = the step's
    column for k of input row n: the columns the weight copy's A fragments
    take (``_step_columns``)."""
    g = torch.Generator().manual_seed(NR + kh)
    x = torch.randn(NR, dl.F32_GATE_CHUNK, generator=g)
    hi_x, lo_x = dl.tf32_split(x)
    planes = torch.full((2 * 4 * NR * 8,), float("nan"))
    for i in range(2 * NR):  # the kernel's split pass
        row, qq = i % NR, i // NR
        q = 2 * kh + qq
        for c in range(4):
            off = ((2 * qq + c // 2) * 2 + c % 2) * NR * 4 + row * 4
            cols = 16 * q + 4 * torch.arange(4) + c
            planes[off:off + 4] = hi_x[row, cols]
            planes[4 * NR * 8 + off:4 * NR * 8 + off + 4] = lo_x[row, cols]
    k, n = torch.meshgrid(torch.arange(8), torch.arange(NR), indexing="ij")
    for sl in range(4):  # wgmma's B of step 4 kh + sl, hi and lo planes
        addr = sl * NR * 8 + (k // 4) * (NR * 16 // 4) + (n // 8) * (128 // 4) + (n % 8) * 4 + k % 4
        cols = _step_columns(4 * kh + sl)[k]
        assert torch.equal(planes[addr], hi_x[n, cols])
        assert torch.equal(planes[4 * NR * 8 + addr], lo_x[n, cols])


def test_tf32_split_emulates_cvt_rna():
    """``tf32_split``: hi has its low 13 bits zero and is the nearest TF32
    value, ties away from zero; lo the same of x - hi; hi + lo within 2^-22
    of x relative."""
    x = torch.tensor([1.0, 1.0 + 2 ** -11, -(1.0 + 2 ** -11), 1.0 + 2 ** -11 - 2 ** -23,
                      3.0e-3, -7.25e5])
    hi, lo = dl.tf32_split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
    assert hi[1] == 1.0 + 2 ** -10 and hi[2] == -(1.0 + 2 ** -10)  # ties away from zero
    assert hi[3] == 1.0
    assert torch.all((hi.double() + lo.double() - x.double()).abs() <= 2 ** -22 * x.abs().double())


def _passes(w, x, passes: int = 7) -> torch.Tensor:
    """x . W^T as the kernels' passes take it (1 w_hi a_lo, 2 w_lo a_hi, 4
    w_hi a_hi), each product of two TF32 values exact in f64, f64 sums."""
    (wh, wl), (xh, xl) = (tuple(t.double() for t in dl.tf32_split(v)) for v in (w, x))
    terms = ((1, xl, wh), (2, xh, wl), (4, xh, wh))
    return sum(a @ b.t() for bit, a, b in terms if passes & bit).float()


def _lstm_update(gates, c):
    i, f, gg, o = gates.chunk(4, dim=1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def _rel(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("B", [1, 16])
def test_three_tf32_passes_hold_k1f_tol_at_the_flagship_widths(B):
    """The f32 cells (H = 1024, R = 1,792 and 2,560) and heads (N = 81, K =
    1,536) at the flagship widths, weights and inputs from a numpy seed: the
    three-pass product within K1F_TOL of ``lstm_cell_plain`` / ``heads_plain``
    in f32 (each output against its max, as the card's check); one TF32 pass
    (w_hi a_hi, the planted defect) beyond 10x K1F_TOL."""
    rng = np.random.default_rng(23 + B)
    Hf, Pf, Df, N = 1024, 256, 512, 81
    t = lambda *s, scale=1.0: torch.as_tensor(rng.standard_normal(s).astype(np.float32) * scale)
    for R in (Pf + Df + Hf, 2 * Hf + Df):
        w = t(4 * Hf, R, scale=Hf ** -0.5)
        b = t(4 * Hf, scale=0.1)
        x1, x2, x3 = t(B, R - Hf, scale=0.5), t(B, Hf // 2, scale=0.5), t(B, Hf // 2)
        x = torch.cat([x1, x2, x3], 1)
        c = t(B, Hf)
        ref = dl.lstm_cell_plain(w, b, x1, x2, x3, c)
        for passes, lo, hi in ((7, 0.0, K1F_TOL), (4, 10 * K1F_TOL, 1.0)):
            got = _lstm_update(_passes(w, x, passes) + b, c)
            for gv, rv in zip(got, ref):
                assert lo < _rel(gv, rv) <= hi, (R, passes)
    w_out, b_out = t(N, Hf + Df, scale=(Hf + Df) ** -0.5), t(N, scale=0.1)
    rnn_h, ctx = t(B, Hf, scale=0.5), t(B, Df)
    ref = dl.heads_plain(w_out, b_out, rnn_h, ctx)
    x = torch.cat([rnn_h, ctx], 1)
    assert _rel(_passes(w_out, x) + b_out, ref) <= K1F_TOL
    assert _rel(_passes(w_out, x, 4) + b_out, ref) > 10 * K1F_TOL


@pytest.mark.parametrize("name,subs", chip_smoke.K1F_DEFECTS,
                         ids=[d for d, _ in chip_smoke.K1F_DEFECTS])
def test_k1f_defects_match_the_source_once(name, subs):
    """Each planted defect of the f32 entries (``chip_smoke.K1F_DEFECTS``, a
    copy of csrc/decode_step.cu built on the card) finds what it replaces
    exactly once, as ``build_copies`` requires, and names its entry."""
    import re
    from pathlib import Path

    src = (Path(dl.__file__).parents[1] / "csrc" / "decode_step.cu").read_text()
    for pattern, _ in subs:
        assert len(re.findall(pattern, src)) == 1, pattern
    assert chip_smoke.K1F_DEFECT_ENTRY[name] in dl.F32_LAUNCHES


# ---------------------------------------------------------------------------
# the F32 teacher-forced route
# ---------------------------------------------------------------------------

B, LT, T, HT, DT, PT, AT = 2, 9, 24, 32, 32, 16, 16


@functools.lru_cache(maxsize=None)
def _jax_scan():
    """JAX's XLA scan (``run_decode_scan``, the F32 route) on the dims of
    tests/test_torch_train_decode.py: outputs, gradients, weights, masks."""
    model = JaxTacotron2(JaxConfig(**TD_CFG), JaxPolicy.from_string("32-true"))
    params, _ = model.init(jax.random.PRNGKey(0))
    enc = jax.random.normal(jax.random.PRNGKey(1), (B, LT, DT))
    att = jax.random.normal(jax.random.PRNGKey(2), (B, LT, AT))
    din = jax.random.normal(jax.random.PRNGKey(3), (T, B, PT))
    mask = jnp.arange(LT)[None, :] >= jnp.asarray(LENS)[:, None]
    keys = jax.random.split(jax.random.PRNGKey(13), T)
    st = jax_decoder.init_state(B, LT, HT, DT, HT)

    def run(dec_params, enc, att, din):
        return jax_train_scan.run_decode_scan(dec_params, st, din, keys, enc, att, mask, None,
                                              train=True, policy=model.policy)

    args = (params["decoder"], enc, att, din)
    outs = run(*args)
    grads = jax.grad(lambda *a: _loss(*run(*a), jnp), argnums=(0, 1, 2, 3))(*args)
    dm1, dm2 = jax.vmap(lambda k: jax_train_scan._dropout_masks(k, (B, HT), True))(keys)
    np_ = lambda t: np.asarray(t, np.float32)
    return (params["decoder"], [np_(a) for a in (enc, att, din)], [np_(o) for o in outs],
            grads, np_(dm1), np_(dm2))


def test_f32_scan_matches_jax_run_decode_scan():
    """``TeacherDecodeTP`` without a model group (the F32 route's function)
    against JAX's ``run_decode_scan`` under 32-true: mels, gates, aligns and
    the gradients of every decoder parameter, ``encoded``, ``att_encoded``
    and ``decoder_in`` within 3e-5 of each one's max + 1e-7."""
    from tacotron2_tpu_torch.convert import decoder_from_jax

    dec_tree, (enc, att, din), outs, grads, dm1, dm2 = _jax_scan()
    rel, floor = TOL["32-true"]
    params = [p.requires_grad_() for p in _port_params(dec_tree)]
    enc_t, att_t, din_t = (torch.tensor(a, requires_grad=True) for a in (enc, att, din))
    mels, gates, aligns = train_scan.TeacherDecodeTP.apply(
        F32, None, din_t, enc_t, att_t, torch.tensor(LENS), torch.as_tensor(dm1),
        torch.as_tensor(dm2), None, *params)
    for name, got, ref in zip(("mels", "gates", "aligns"), (mels, gates, aligns), outs):
        _assert_close(got, ref, rel, floor, name)
    _loss(mels, gates, aligns, torch).backward()
    g_dec, g_enc, g_att, g_din = grads
    ref_dec = decoder_from_jax(jax.tree.map(np.asarray, g_dec))
    for name, p in zip(td.DECODER_PARAMS, params):
        _assert_close(p.grad, ref_dec[name].numpy(), rel, floor, f"grad {name}")
    for name, t, g in (("encoded", enc_t, g_enc), ("att_encoded", att_t, g_att),
                       ("decoder_in", din_t, g_din)):
        _assert_close(t.grad, g, rel, floor, f"grad {name}")


class _Group:
    n, rank = 2, 0


@pytest.mark.parametrize("precision,group,route", [
    ("32-true", False, "scan"), ("32", False, "scan"), ("bf16-mixed", False, "kernels"),
    ("16-mixed", False, "kernels"), ("bf16-mixed", True, "scan"), ("32-true", True, "scan")])
def test_teacher_route_follows_the_policy(monkeypatch, precision, group, route):
    """JAX's choice (``pallas_train_supported``): K3 / K4 under bf16
    without a model group, the stock-op scan under F32 and in a
    tensor-parallel step."""
    monkeypatch.setattr(mesh, "model_parallel", lambda: _Group() if group else None)
    got = _model(precision).teacher_route()
    assert got is (train_scan.teacher_decode if route == "scan" else td.teacher_decode)


def test_forward_teacher_f32_never_reaches_k3(monkeypatch):
    """A 32-true train-mode pass runs the scan (K3 / K4's entry made to
    raise), equal to ``TeacherDecode``'s plain versions on the same masks;
    under bf16 the same pass reaches K3 / K4's entry."""
    m = _model()
    g = torch.Generator().manual_seed(1)
    ci = torch.randint(1, 20, (2, 7), generator=g)
    cl = torch.tensor([7, 5])
    mel = torch.randn(2, 12, 8, generator=g)
    ml = torch.tensor([12, 9])
    masks = td.lstm_masks(12, 2, 32, g, "cpu")

    def run():
        return m.forward_teacher(ci, cl, mel, ml, train=True,
                                 generator=torch.Generator().manual_seed(2), lstm_masks=masks)

    ref = run()  # before the patch: the scan too (the policy is F32)

    def k3(*a, **k):
        raise AssertionError("K3 / K4 reached under F32")

    monkeypatch.setattr(td, "teacher_decode", k3)
    out = run()
    assert torch.equal(out.mels_post, ref.mels_post)
    with pytest.raises(AssertionError, match="K3"):
        _model("bf16-mixed").forward_teacher(ci, cl, mel, ml, train=True, generator=g,
                                             lstm_masks=masks)


def test_k3_k4_refuse_f32_weights(monkeypatch):
    """K3's and K4's wrappers keep refusing f32 weights on a tensor that is
    not on the CPU: the F32 route is chosen by the policy, not by a
    fallback in the wrappers."""
    monkeypatch.setattr(build, "require", _require_on_meta)
    before = dict(td.LAUNCHES)
    w = td.TrainWeights(_meta(32, 24), _meta(32), _meta(32, 24), _meta(32), _meta(4, 8),
                        _meta(4, 2, 31), _meta(4), _meta(81, 16), _meta(81))
    with pytest.raises(ValueError, match="bfloat16"):
        td.teacher_forward(w, _meta(2, 1, 8), _meta(1, 5, 8, dtype=torch.bfloat16),
                           _meta(1, 5, 4), _meta(1, dtype=torch.int32), _meta(2, 1, 8),
                           _meta(2, 1, 8))
    res = td.Residuals(_meta(2, 1, 24, dtype=torch.bfloat16), _meta(2, 1, 24, dtype=torch.bfloat16),
                       _meta(3, 1, 8), _meta(3, 1, 8), _meta(3, 1, 5), _meta(3, 1, 5))
    with pytest.raises(ValueError, match="bfloat16"):
        td.teacher_backward(w, res, _meta(1, 5, 8, dtype=torch.bfloat16), _meta(1, 5, 4),
                            _meta(1, dtype=torch.int32), _meta(2, 1, 8), _meta(2, 1, 8),
                            _meta(2, 1, 81), _meta(2, 1, 5))
    assert td.LAUNCHES == before


# ---------------------------------------------------------------------------
# the inference postnet's rows (``Tacotron2._postnet_rows``)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B", [1, 16, 17, 40])
def test_f32_server_postnet_runs_fixed_row_tiles(monkeypatch, B):
    """Under F32 with a server's fixed rows the postnet runs on tiles of
    POSTNET_ROWS rows, the last one padded, so its convs take one shape
    whatever B; its rows equal the postnet over the B rows at once."""
    from tacotron2_tpu_torch.models import tacotron2 as t2

    m = _model()
    mels = torch.randn(B, 7, CFG["num_mels"], generator=torch.Generator().manual_seed(B))
    with torch.no_grad():
        want = m.postnet(mels, m.policy)
        shapes = []
        real = m.postnet.forward
        monkeypatch.setattr(m.postnet, "forward",
                            lambda x, *a, **k: (shapes.append(tuple(x.shape)), real(x, *a, **k))[1])
        got = m._postnet_rows(mels, True)
    assert shapes == [(t2.POSTNET_ROWS, 7, CFG["num_mels"])] * -(-B // t2.POSTNET_ROWS)
    assert got.shape == mels.shape
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("precision,fixed", [("32-true", False), ("bf16-mixed", True),
                                             ("bf16-mixed", False)])
def test_postnet_runs_the_batch_once_elsewhere(monkeypatch, precision, fixed):
    """Without fixed rows, and under bf16 (whose served rows equal alone at
    B rows), the postnet is one call at B rows, bit for bit the plain call."""
    m = _model(precision)
    mels = torch.randn(5, 7, CFG["num_mels"], generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = m.postnet(mels, m.policy)
        shapes = []
        real = m.postnet.forward
        monkeypatch.setattr(m.postnet, "forward",
                            lambda x, *a, **k: (shapes.append(tuple(x.shape)), real(x, *a, **k))[1])
        got = m._postnet_rows(mels, fixed)
    assert shapes == [tuple(mels.shape)]
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the smoke's check of prenet_f32_act_bf16 (rows on a bf16 rounding boundary)
# ---------------------------------------------------------------------------


def _smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _prenet_inputs(B, seed=0):
    g = torch.Generator().manual_seed(seed)
    M, P = 80, 256  # the flagship's mel and prenet widths
    m1, m2 = dl.prenet_masks(1, B, P, 0.5, g, torch.device("cpu"))
    return (torch.randn(B, M, generator=g), torch.randn(M, P, generator=g) * 0.1,
            torch.randn(P, P, generator=g) * 0.06, m1[0], m2[0])


def _prenet_reordered(mel, w1, w2, m1, m2):
    """prenet_plain with bf16 activations, its f32 sums in reverse order:
    a kernel that sums in another order than the plain version."""
    x = mel.to(torch.bfloat16).float()
    s = torch.zeros(mel.shape[0], w1.shape[1])
    for k in reversed(range(w1.shape[0])):
        s = s + x[:, k:k + 1] * w1[k]
    h = (torch.relu(s) * m1).to(torch.bfloat16).float()
    z = torch.zeros(mel.shape[0], w2.shape[1])
    for k in reversed(range(w2.shape[0])):
        z = z + h[:, k:k + 1] * w2[k]
    return torch.relu(z) * m2


def test_smoke_holds_prenet_boundary_rows_to_their_rounding():
    """A prenet that sums in another order flips first-layer elements on a
    bf16 rounding boundary, moving whole rows past K1F_TOL of the plain
    version; the smoke's check holds each such row to K1F_TOL of one of
    the roundings its boundary elements allow, and passes it."""
    smoke = _smoke()
    pre = _prenet_inputs(400)
    got, ref = _prenet_reordered(*pre), dl.prenet_plain(*pre, torch.bfloat16)
    log = {}
    smoke.k1f_check("reordered", "prenet_f32_act_bf16", [got], [ref], log, pre)
    rows = log["checks"][-1]["boundary_rows"]
    assert rows, "no row flipped: the case does not test the boundary rows"
    assert all(r["rel_err"] > smoke.K1F_TOL >= r["held"] for r in rows.values())


def test_smoke_fails_a_prenet_on_bf16_weights_at_one_row():
    """The planted defect: the prenet's f32 weights rounded to bf16 fails
    the check at one row (``k1f_prenet_defect`` logs it), and a wrong row
    far from any rounding fails ``k1f_check`` too."""
    smoke = _smoke()
    pre = _prenet_inputs(1, seed=3)
    log = {}
    smoke.k1f_prenet_defect(dl, pre, log)
    assert log["k1f_defects"]["prenet_bf16_weights"]["rel_err"] >= 10 * smoke.K1F_TOL
    ref = dl.prenet_plain(*pre, torch.bfloat16)
    with pytest.raises(smoke.SmokeFailure):
        smoke.k1f_check("off", "prenet_f32_act_bf16", [ref * (1 + 1e-3)], [ref], {}, pre)


def _relu_net_grads(w1, w2, x):
    """Gradients of a two-ReLU net's sum with respect to (w1, w2)."""
    w1, w2 = w1.clone().requires_grad_(), w2.clone().requires_grad_()
    torch.relu(torch.relu(x @ w1) @ w2).sum().backward()
    return w1.grad, w2.grad


def test_smoke_relu_branches_follow_another_runs():
    """The F32 step's CPU side takes the card's ReLU branches: following a
    run's own branches gives its gradients bit for bit, each element taken
    on another branch is counted with its |x| over the call's max, and a
    ReLU call with no recorded branch raises."""
    smoke = _smoke()
    g = torch.Generator().manual_seed(5)
    w1, w2, x = (torch.randn(*s, generator=g) for s in ((8, 16), (16, 4), (32, 8)))
    with smoke.relu_branches() as xs:
        ref = _relu_net_grads(w1, w2, x)
    masks = [t > 0 for t in xs]
    with smoke.relu_branches(masks) as again:
        got = _relu_net_grads(w1, w2, x)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert smoke.flip_reading(masks, again) == {"flips": 0, "flip_rel": 0.0}
    j = int(xs[0].reshape(-1).abs().argmin())
    flat = masks[0].reshape(-1).clone()
    flat[j] = ~flat[j]
    flipped = [flat.reshape(masks[0].shape), masks[1]]
    with smoke.relu_branches(flipped) as moved:
        got = _relu_net_grads(w1, w2, x)
    r = smoke.flip_reading(flipped, moved)
    assert r["flips"] == 1
    assert r["flip_rel"] == float(xs[0].abs().min() / xs[0].abs().max())
    assert not torch.equal(got[0], ref[0])
    with pytest.raises(smoke.SmokeFailure), smoke.relu_branches(masks[:1]):
        _relu_net_grads(w1, w2, x)
