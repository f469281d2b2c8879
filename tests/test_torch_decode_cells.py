"""The LSTM cells' and the prenet's host side on the CPU (no card, no
JAX): the tiled weight copies that K1's ``lstm_cell`` and K5's
``lstm_cell_int8`` stream (``tile_gates``, read back through
``gate_tile_offset``, the kernel's addressing) and that the prenet's
cluster copies (``tile_prenet``, ``prenet_tile_offset``), the pack that
makes them once per model, the wrappers' checks (the dims the prenet's
cluster split takes), the C entry points' arities and the constants
against the source, and the launches ``decode_chunk`` counts against what
its host call launches."""

import numpy as np
import pytest
import torch

from tacotron2_tpu_torch.models.layers import Policy
from tacotron2_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from tacotron2_tpu_torch.ops import build
from tacotron2_tpu_torch.ops import decoder_loop as dl

torch.set_num_threads(1)


def _weights(H, R, dtype, seed):
    rng = np.random.default_rng(seed)
    w = torch.as_tensor(rng.standard_normal((4 * H, R)).astype(np.float32))
    return (w * 40).round().clamp(-127, 127).to(torch.int8) if dtype == torch.int8 else w.to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("H,R", [(32, 64), (64, 176), (96, 400), (1024, 1792)])
def test_gate_tiles_read_back(H, R, dtype):
    """Every byte of every weight row read from ``tile_gates``' copy at
    ``gate_tile_offset`` is the row's byte; the copy holds nothing else (the
    rows' pad to whole 128-byte chunks is zero), and each cluster's chunks
    are one contiguous run of 16 KB chunks."""
    w = _weights(H, R, dtype, H + R)
    wt = dl.tile_gates(w)
    wb = w.view(torch.uint8)
    rb = wb.shape[1]
    assert wt.dtype == torch.uint8 and wt.numel() == dl.tiled_bytes(H, rb)
    rows = torch.arange(4 * H)[:, None].expand(4 * H, rb)
    off = dl.gate_tile_offset(rows, torch.arange(rb)[None, :].expand(4 * H, rb), H, rb)
    assert torch.equal(wt[off], wb)
    assert off.unique().numel() == off.numel()
    rest = torch.ones(wt.numel(), dtype=torch.bool)
    rest[off.reshape(-1)] = False
    assert not bool(wt[rest].any())
    # cluster gi's chunk c starts at (gi nk + c) x 8 KB; its row rr (gate 16 + u) first
    nk = -(-rb // dl.GATE_CHUNK)
    chunk = 4 * dl.GATE_UNITS * dl.GATE_CHUNK
    for gi, c in ((0, 0), (H // dl.GATE_UNITS - 1, nk - 1)):
        for gate, u in ((0, 0), (3, dl.GATE_UNITS - 1)):
            row = gate * H + gi * dl.GATE_UNITS + u
            rr = gate * dl.GATE_UNITS + u
            assert dl.gate_tile_offset(row, c * dl.GATE_CHUNK, H, rb) == (
                (gi * nk + c) * chunk + rr * dl.GATE_CHUNK + (rr % 8) * 16)


def test_constants_mirror_the_kernel():
    """The host's copy of the cell kernel's units per cluster (the tiled
    copy's row groups) and its swizzle equal the source's."""
    import re
    from pathlib import Path

    src = (Path(dl.__file__).parents[1] / "csrc" / "decode_step.cu").read_text()
    assert int(re.search(r"constexpr int GC_U = (\d+);", src).group(1)) == dl.GATE_UNITS
    assert "row * 128 + ((((byte >> 4) ^ row) & 7) << 4)" in src  # gate_tile_offset's swizzle


def test_ab_constants_are_in_the_source():
    """The source lines that ``chip_smoke.py --k1-ab`` rewrites in its
    copies of the source (``cell_ab``: the prenet's rows a cluster; the
    cells' prefetch, measured so before) occur once, as its patterns match
    them."""
    import re
    from pathlib import Path

    src = (Path(dl.__file__).parents[1] / "csrc" / "decode_step.cu").read_text()
    for pattern in (r"constexpr int GC_PREFETCH = \d+;", r"constexpr int PN_THREADS = \d+;"):
        assert len(re.findall(pattern, src)) == 1, pattern


def test_gate_tiles_need_whole_clusters():
    """No copy where H is not a multiple of the kernel's 16 units."""
    assert dl.tile_gates(torch.zeros(4 * 40, 64, dtype=torch.bfloat16)) is None


def _model(att_rnn_dim=32, seed=0, prenet_dim=16):
    torch.manual_seed(seed)
    cfg = Tacotron2Config(num_chars=20, encoded_dim=16, encoder_kernel_size=5, num_mels=8,
                          prenet_dim=prenet_dim, att_rnn_dim=att_rnn_dim, att_dim=8,
                          rnn_hidden_dim=att_rnn_dim, postnet_dim=16, dropout=0.5)
    return Tacotron2(cfg, Policy(torch.bfloat16)).eval()


@pytest.mark.parametrize("quantize", [False, True])
def test_pack_makes_the_tiled_copies_once(quantize):
    """``pack_decoder`` (one call, counted) carries both cells' tiled
    copies of its own LSTM weights, bf16 or int8."""
    m = _model()
    n0 = dl.PACK_CALLS[0]
    pk = m.make_packed_decoder(quantize)
    assert dl.PACK_CALLS[0] == n0 + 1
    assert pk.quantized == quantize
    assert pk.w_att.dtype == (torch.int8 if quantize else torch.bfloat16)
    assert torch.equal(pk.wt_att, dl.tile_gates(pk.w_att))
    assert torch.equal(pk.wt_dec, dl.tile_gates(pk.w_dec))


def test_pack_without_whole_clusters_has_no_copies():
    """At H = 24 the pack runs on the plain versions only."""
    pk = _model(att_rnn_dim=24).make_packed_decoder()
    assert pk.wt_att is None and pk.wt_dec is None


def test_cpu_cells_ignore_the_copy():
    """On the CPU the wrappers run the plain versions, with or without the
    tiled copy."""
    g = torch.Generator().manual_seed(3)
    H, n1, n2, n3 = 32, 16, 16, 32
    w = _weights(H, n1 + n2 + n3, torch.bfloat16, 5)
    b = torch.randn(4 * H, generator=g)
    xs = [torch.randn(2, n, generator=g) for n in (n1, n2, n3)]
    c = torch.randn(2, H, generator=g)
    ref = dl.lstm_cell_plain(w, b, *xs, c)
    for got in (dl.lstm_cell(w, b, *xs, c), dl.lstm_cell(w, b, *xs, c, dl.tile_gates(w))):
        assert all(torch.equal(x, y) for x, y in zip(got, ref))


@pytest.mark.parametrize("M,P", [(80, 256), (8, 64), (16, 128), (80, 512), (80, 2048 // 8)])
def test_prenet_tiles_read_back(M, P):
    """Every weight of both prenet layers read from ``tile_prenet``'s copy
    at ``prenet_tile_offset`` is the weight; block r's slice (units r U ..
    r U + U - 1 of both layers, layer 1's rows first) is one contiguous
    run with a unit's 4 consecutive weights side by side, and the copy
    holds nothing else."""
    g = torch.Generator().manual_seed(M + P)
    w1, w2 = (torch.randn(M, P, generator=g).to(torch.bfloat16),
              torch.randn(P, P, generator=g).to(torch.bfloat16))
    wt = dl.tile_prenet(w1, w2)
    U = dl.prenet_units(M, P)
    assert U == P // dl.PRENET_CLUSTER
    assert wt.shape == dl.prenet_tiled_shape(M, P) == (dl.PRENET_CLUSTER, (M + P) // 4, U, 4)
    w = torch.cat([w1, w2])
    k = torch.arange(M + P)[:, None].expand(M + P, P)
    p = torch.arange(P)[None, :].expand(M + P, P)
    off = dl.prenet_tile_offset(k, p, M, P)
    assert torch.equal(wt.reshape(-1)[off], w) and off.unique().numel() == wt.numel()
    for r in (0, dl.PRENET_CLUSTER - 1):
        assert torch.equal(wt[r].permute(0, 2, 1).reshape(M + P, U), w[:, r * U:(r + 1) * U])
        assert dl.prenet_tile_offset(0, r * U, M, P) == r * (M + P) * U
        assert dl.prenet_tile_offset(5, r * U + 1, M, P) == r * (M + P) * U + (U + 1) * 4 + 1


@pytest.mark.parametrize("M,P", [(80, 16), (80, 96), (80, 100), (80, 2048), (100000, 64),
                                 (78, 256)])
def test_prenet_refuses_dims_the_split_does_not_take(M, P):
    """The cluster of 8 blocks takes P = 8 U, U a multiple of 8 dividing
    256, M a multiple of 4, within a block's shared memory: otherwise no
    tiled copy, and the wrapper refuses before anything is launched."""
    with pytest.raises(ValueError, match="prenet"):
        dl.prenet_units(M, P)
    bf = torch.bfloat16
    assert dl.tile_prenet(torch.zeros(M, P, dtype=bf), torch.zeros(P, P, dtype=bf)) is None
    before = dict(dl.LAUNCHES)
    with pytest.raises(ValueError, match="prenet"):
        dl.prenet(_meta(1, M), _meta(M, P, dtype=bf), _meta(P, P, dtype=bf), _meta(1, P),
                  _meta(1, P), _meta(8, M + P, max(1, P // 8), dtype=bf))
    assert dl.LAUNCHES == before


@pytest.mark.parametrize("quantize", [False, True])
def test_pack_makes_the_prenet_copy_once(quantize):
    """``pack_decoder`` (one call) carries the prenet's tiled copy of its
    own weights, in either mode; a prenet the split does not take gets
    none."""
    m = _model(prenet_dim=64)
    n0 = dl.PACK_CALLS[0]
    pk = m.make_packed_decoder(quantize)
    assert dl.PACK_CALLS[0] == n0 + 1
    assert torch.equal(pk.wt_prenet, dl.tile_prenet(pk.wp1_t, pk.wp2_t))
    assert pk.wt_prenet.shape == (8, (8 + 64) // 4, 8, 4)
    assert _model().make_packed_decoder(quantize).wt_prenet is None  # P = 16: U = 2


def test_prenet_constants_mirror_the_kernel():
    """The host's copy of the prenet kernel's cluster and block sizes (the
    tiled copy's slices, the rows of a group) equal the source's."""
    import re
    from pathlib import Path

    src = (Path(dl.__file__).parents[1] / "csrc" / "decode_step.cu").read_text()
    assert int(re.search(r"constexpr int PN_S = (\d+);", src).group(1)) == dl.PRENET_CLUSTER
    assert int(re.search(r"constexpr int PN_THREADS = (\d+);", src).group(1)) == dl.PRENET_THREADS


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, device="meta", dtype=dtype)


class _FakeLib:
    """Stands for the built library: records what the wrappers pass."""

    def __init__(self):
        self.calls = []

    def t2_decode_chunk(self, ptrs, dims, stream):
        self.calls.append(("chunk", [ptrs[i] for i in range(46)], list(dims)))
        return 0

    def t2_lstm_cell(self, *args):
        self.calls.append(("lstm_cell", args))
        return 0

    def t2_lstm_cell_int8(self, *args):
        self.calls.append(("lstm_cell_int8", args))
        return 0

    def t2_quantize_xh(self, *args):
        self.calls.append(("quantize_xh", args))
        return 0

    def t2_prenet(self, *args):
        self.calls.append(("prenet", args))
        return 0

    def t2_heads(self, *args):
        self.calls.append(("heads", args))
        return 0


H, D, P, M, A, K, L = 64, 32, 64, 8, 8, 31, 20


def _meta_pack(quantize, E=0):
    """A pack on meta tensors; ``E`` controls columns."""
    q = torch.int8 if quantize else torch.bfloat16
    es = 1 if quantize else 2
    bf = torch.bfloat16
    scales = dict(s_att=_meta(4 * H), s_dec=_meta(4 * H)) if quantize else {}
    return dl.PackedDecoder(
        _meta(4 * H, P + D + H, dtype=q), _meta(4 * H), _meta(4 * H, 2 * H + D + E, dtype=q),
        _meta(4 * H), _meta(M, P, dtype=bf), _meta(P, P, dtype=bf), _meta(A, H, dtype=bf),
        _meta(A, 2, K, dtype=bf), _meta(A, dtype=bf), _meta(M + 1, H + D + E, dtype=bf),
        _meta(M + 1), **scales,
        wt_att=_meta(dl.tiled_bytes(H, es * (P + D + H)), dtype=torch.uint8),
        wt_dec=_meta(dl.tiled_bytes(H, es * (2 * H + D + E)), dtype=torch.uint8),
        wt_prenet=_meta(*dl.prenet_tiled_shape(M, P), dtype=bf),
        wt_out=_meta(*dl.heads_tiled_shape(M + 1, H + D + E), dtype=bf))


def _meta_chunk(pk, B, n):
    s = dl.StepState(_meta(B, M), _meta(B, H), _meta(B, H), _meta(B, D), _meta(B, L),
                     _meta(B, L), _meta(B, H), _meta(B, H))
    return dl.decode_chunk(pk, _meta(B, L, D, dtype=torch.bfloat16), _meta(B, L, A),
                           _meta(B, dtype=torch.int32), s, _meta(n, B, P), _meta(n, B, P))


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(dl, "_lib", lambda: lib)
    monkeypatch.setattr(dl, "_stream", lambda: 0)
    monkeypatch.setattr(build, "require", lambda *a, **k: None)
    return lib


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("B,n", [(1, 64), (16, 4), (64, 1)])
def test_chunk_counts_what_it_launches(fake, quantize, B, n):
    """One host call of n steps launches five kernels a step, seven in int8
    mode (a ``quantize_xh`` before each cell): the counters grow by n
    prenet, 2n of the pack's cell (and 2n quantize_xh), n attention and n
    heads, and nothing else; the call gets the pack's mode, the attention's
    cluster size, no controls columns (a pack without controls) and the
    pointer slots up to the controls', null here."""
    pk = _meta_pack(quantize)
    before, before_ctl = dict(dl.LAUNCHES), dict(dl.CONTROLS_LAUNCHES)
    _meta_chunk(pk, B, n)
    assert dl.CONTROLS_LAUNCHES == before_ctl  # no launch read controls
    grown = {k: dl.LAUNCHES[k] - before[k] for k in dl.LAUNCHES}
    assert grown == {"prenet": n, "lstm_cell": 0 if quantize else 2 * n,
                     "quantize_xh": 2 * n if quantize else 0,
                     "lstm_cell_int8": 2 * n if quantize else 0, "location_attention": n,
                     "heads": n}
    [(kind, ptrs, dims)] = fake.calls
    assert kind == "chunk" and dims[:2] == [n, B] and dims[9] == int(quantize)
    assert len(dims) == 12 and dims[10] == dl.location_cluster_size(L, H, A, D, K)
    assert dims[11] == 0 and len(ptrs) == 46 and ptrs[44:] == [None, None]
    assert ptrs[9] == (pk.wt_out.data_ptr() or None)  # the heads' tiled copy, not w_out
    assert sum(grown.values()) == (7 if quantize else 5) * n


@pytest.mark.parametrize("copy", ["wt_att", "wt_prenet", "wt_out"])
def test_chunk_refuses_a_pack_without_copies(fake, copy):
    pk = _meta_pack(False)._replace(**{copy: None})
    before = dict(dl.LAUNCHES)
    with pytest.raises(ValueError, match="tiled"):
        _meta_chunk(pk, 2, 1)
    assert dl.LAUNCHES == before and fake.calls == []


@pytest.mark.parametrize("B", [1, 64])
def test_prenet_wrapper_passes_the_copy(fake, B):
    """The prenet's one-kernel entry launches over the tiled copy (one
    counted launch, its dims passed); without the copy it refuses."""
    pk = _meta_pack(False)
    args = (_meta(B, M), pk.wp1_t, pk.wp2_t, _meta(B, P), _meta(B, P))
    before = dl.LAUNCHES["prenet"]
    dl.prenet(*args, pk.wt_prenet)
    [(kind, cargs)] = fake.calls
    assert kind == "prenet" and len(cargs) == 9 and cargs[5:8] == (B, M, P)
    assert dl.LAUNCHES["prenet"] == before + 1
    with pytest.raises(ValueError, match="tiled"):
        dl.prenet(*args)
    assert dl.LAUNCHES["prenet"] == before + 1


@pytest.mark.parametrize("B", [1, 64, 80])
def test_heads_wrapper_passes_the_copy(fake, B):
    """The heads' one-kernel entry launches over the tiled copy of w_out
    (one counted launch, its dims passed); without the copy, or with one
    of another shape, it refuses before anything launches."""
    pk = _meta_pack(False)
    args = (pk.w_out, pk.b_out, _meta(B, H), _meta(B, D))
    before = dl.LAUNCHES["heads"]
    dl.heads(*args, wt=pk.wt_out)
    [(kind, cargs)] = fake.calls
    assert kind == "heads" and len(cargs) == 12 and cargs[0] == pk.wt_out.data_ptr()
    assert cargs[3] == H and cargs[5] == D and cargs[9:11] == (B, M + 1)
    assert dl.LAUNCHES["heads"] == before + 1
    with pytest.raises(ValueError, match="tiled"):
        dl.heads(*args)
    assert dl.LAUNCHES["heads"] == before + 1 and len(fake.calls) == 1


def test_heads_wrapper_refuses_other_widths(fake):
    """A segment of the heads' input that is not whole 16-column pieces
    is refused before anything launches."""
    before = dict(dl.LAUNCHES)
    with pytest.raises(ValueError, match="16-column"):
        dl.heads(_meta(M + 1, H + 24, dtype=torch.bfloat16), _meta(M + 1), _meta(2, H),
                 _meta(2, 24), wt=_meta(*dl.heads_tiled_shape(M + 1, H + 24),
                                        dtype=torch.bfloat16))
    assert dl.LAUNCHES == before and fake.calls == []


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("B", [3, 16])
def test_cell_wrappers_pass_the_copy(fake, quantize, B):
    """The cell wrappers launch over the tiled copy (not w) and count one
    launch each; K5's quantises its input first (one ``quantize_xh``
    launch)."""
    pk = _meta_pack(quantize)
    before = dict(dl.LAUNCHES)
    xs = (_meta(B, P), _meta(B, D), _meta(B, H))
    if quantize:
        dl.lstm_cell_int8(pk.w_att, pk.s_att, pk.b_att, *xs, _meta(B, H), pk.wt_att)
    else:
        dl.lstm_cell(pk.w_att, pk.b_att, *xs, _meta(B, H), pk.wt_att)
    name = "lstm_cell_int8" if quantize else "lstm_cell"
    kinds = [k for k, _ in fake.calls]
    assert kinds == (["quantize_xh", name] if quantize else [name])
    args = fake.calls[-1][1]
    assert args[0] == pk.wt_att.data_ptr() and args[-3:] == (B, H, 0)
    assert dl.LAUNCHES[name] == before[name] + 1
    assert dl.LAUNCHES["quantize_xh"] == before["quantize_xh"] + int(quantize)


def test_quantize_xh_plain_is_the_cells_operand():
    """``quantize_xh_plain`` is the int8 cell's quantisation of its input
    (``quantize_rows``): int8 values and one scale per row."""
    g = torch.Generator().manual_seed(4)
    xs = [torch.randn(3, n, generator=g) * 3 for n in (16, 32, 16)]
    q, sx = dl.quantize_xh_plain(*xs)
    qr, sr = dl.quantize_rows(torch.cat(xs, 1))
    assert q.dtype == torch.int8 and torch.equal(q.float(), qr) and torch.equal(sx, sr[:, 0])


def _cell_call(quantize, wt, B=1):
    q = torch.int8 if quantize else torch.bfloat16
    w = _meta(4 * H, P + D + H, dtype=q)
    xs = (_meta(B, P), _meta(B, D), _meta(B, H), _meta(B, H))
    if quantize:
        return lambda: dl.lstm_cell_int8(w, _meta(4 * H), _meta(4 * H), *xs, wt)
    return lambda: dl.lstm_cell(w, _meta(4 * H), *xs, wt)


class _OnCard:
    """A meta tensor as ``build.require`` sees a CUDA tensor of its type,
    shape and layout."""

    def __init__(self, t):
        self.t, self.device = t, torch.device("cuda")

    def __getattr__(self, name):
        return getattr(self.t, name)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("wt,match", [
    (None, "tiled copy"),
    (_meta(100, dtype=torch.uint8), "shape"),
    (_meta(4 * H * 112, dtype=torch.float32), "uint8"),
])
def test_cell_wrappers_refuse(monkeypatch, fake, quantize, wt, match):
    """A call on the card without the tiled copy, or with one of another
    size or type, raises before anything launches (meta tensors seen as
    CUDA ones by the wrappers' own operand checks)."""
    monkeypatch.setattr(build, "require", lambda t, *a: _REQUIRE(_OnCard(t), *a))
    before = dict(dl.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        _cell_call(quantize, wt)()
    assert dl.LAUNCHES == before and fake.calls == []


_REQUIRE = build.require


def test_entry_points_match_the_source():
    """Every C entry point that ``bind`` declares exists in
    ``csrc/decode_step.cu`` with as many parameters as its argtypes (a
    mismatch shows on the card only as a wrong call or an undefined
    symbol), and every ``t2_*`` entry there is bound."""
    import re
    import types
    from pathlib import Path

    src = (Path(dl.__file__).parents[1] / "csrc" / "decode_step.cu").read_text()
    src = src[src.index('extern "C"'):]
    arity = {m.group(1): len(m.group(2).split(","))
             for m in re.finditer(r"^int (t2_\w+)\(([^)]*)\)", src, re.M)}

    class Lib(types.SimpleNamespace):
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    lib = dl.bind(Lib())
    bound = {k: len(v.argtypes) for k, v in vars(lib).items()}
    assert bound == arity
