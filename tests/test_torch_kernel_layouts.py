"""The layouts and host-side rules of K2's ``mrf_conv`` and K1's cluster
attention, on the CPU (no card, no JAX): the tiled weight copy that the
kernel reads, the bf16 operands passed between a stage's convs, the
HiFi-GAN's packing once per model, and K1's cluster size, which must not
depend on the batch."""

import ctypes

import numpy as np
import pytest
import torch

from tacotron2_tpu_torch.models import hifigan as hifigan_mod
from tacotron2_tpu_torch.models.hifigan import HiFiGAN, HiFiGANConfig
from tacotron2_tpu_torch.models.layers import Policy
from tacotron2_tpu_torch.ops import build, mrf
from tacotron2_tpu_torch.ops import decoder_loop as dl

torch.set_num_threads(1)


@pytest.mark.parametrize("C", [32, 64, 128, 256])
@pytest.mark.parametrize("K", [3, 7, 11])
def test_tiled_weights_read_back(K, C):
    """Every weight of ``pack_conv`` read from the tiled copy at the offset
    the kernel computes (``tile_offset``) is the tap-major weight; each
    (N tile, slice, tap) tile is one contiguous run."""
    rng = np.random.default_rng(K * 1000 + C)
    conv = torch.nn.Conv1d(C, C, K, dilation=3, padding=3 * (K - 1) // 2)
    with torch.no_grad():
        conv.weight.copy_(torch.as_tensor(rng.standard_normal((C, C, K)).astype(np.float32)))
    cw = mrf.pack_conv(conv, torch.bfloat16)
    NI, KC = mrf.conv_tiles(C, C)
    assert cw.wt.shape == (C // NI, C // KC, K, KC // 8, NI, 8)
    assert torch.equal(mrf.read_tiled(cw.wt, K, C, C), cw.w)
    # the tile of (N tile 0, slice 0, tap 1) starts NI * KC elements in
    assert mrf.tile_offset(1, 0, 0, K, C, C) == NI * KC


@pytest.mark.parametrize("Co,Ci,NI,KC", [(256, 256, 128, 64), (128, 128, 128, 64),
                                         (64, 64, 64, 64), (32, 32, 32, 32),
                                         (96, 160, 32, 32), (192, 64, 64, 64),
                                         (512, 80, 128, 32)])
def test_conv_tiles(Co, Ci, NI, KC):
    """The wgmma's N (128, 64 or 32) and the staged slice (64 or 32
    channels) follow the channels alone; conv_pre's 80 mel channels take
    three slices of 32, the last half past Ci."""
    assert mrf.conv_tiles(Co, Ci) == (NI, KC)


@pytest.mark.parametrize("Co,Ci", [(48, 64), (512, 20)])
def test_conv_tiles_refuse_other_channels(Co, Ci):
    """Co must be a multiple of 32 (an N tile), Ci of 8 (the operand's rows
    whole 16-byte pieces, as TMA reads them); other channels run on the
    narrow kernel, whose copy has no tiles."""
    assert not mrf.wide(Co, Ci)
    with pytest.raises(ValueError):
        mrf.conv_tiles(Co, Ci)


def test_conv_pre_copy_partial_slice():
    """UNIVERSAL_V1's conv_pre (80 -> 512, k=7) packs a tiled copy of three
    32-channel slices: read back through ``tile_offset`` it is the
    tap-major weight, and the last slice is zero past channel 80."""
    h = HiFiGAN(HiFiGANConfig(), Policy(torch.bfloat16))
    cw = h.conv_pre_weights()
    K, Co, Ci = cw.w.shape
    assert (K, Co, Ci) == (7, 512, 80) and cw.wt.shape == (4, 3, 7, 4, 128, 8)
    assert torch.equal(mrf.read_tiled(cw.wt, K, Co, Ci), cw.w)
    assert not cw.wt[:, 2, :, 2:].any()  # 8-channel groups 2-3 of slice 2: channels 80-95
    assert h.kernel_weights() is h.kernel_weights() and h.conv_pre_weights() is cw


RB = {"1": ((3, 7, 11), ((1, 3, 5),) * 3), "2": ((3, 5), ((1, 3), (1, 3)))}


def _stage(rb_type, C, ups, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s, scale=0.1: torch.randn(*s, generator=g) * scale

    def conv(k, d):
        w = (rn(k, C, C, scale=0.5 / (C * k) ** 0.5)).to(dtype)
        return mrf.ConvWeights(w, rn(C), d, mrf.tile_conv(w))

    kernels, dils = RB[rb_type]
    rbs = [[(conv(k, d), conv(k, 1) if rb_type == "1" else None) for d in dil]
           for k, dil in zip(kernels, dils)]
    up = None
    if ups:
        up = mrf.make_upsample(rn(4, 2 * C, C, scale=0.1).to(dtype), rn(C), 2, 1)
    return rbs, up


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ups", [False, True])
@pytest.mark.parametrize("rb_type", ["1", "2"])
def test_side_outputs_equal_plain_stage(rb_type, ups, dtype):
    """The stage's dataflow with the bf16 operands passed between convs
    (``side_output_stage``: a ResBlock1 pair's intermediate as its operand
    only, the residual stream as f32 and operand) equals ``plain_stage``,
    where every conv rounds lrelu of its f32 input, bit for bit; asked
    for, the stage mean's operand (what the next stage's upsample reads) is
    ``operand`` of that mean, bit for bit."""
    C = 32
    rbs, up = _stage(rb_type, C, ups, dtype, 5)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 37, 2 * C if ups else C, generator=g)
    want = mrf.plain_stage(x, rbs, up)
    got = mrf.side_output_stage(x, rbs, up)
    assert torch.equal(got, want)
    assert torch.equal(mrf.mrf_stage(x, rbs, up), want)  # the wrappers on CPU tensors
    a_want = mrf.operand(want, dtype)
    for a_out in (mrf.run_stage(x, rbs, up, mrf.mrf_conv_plain, mrf.conv_transpose_plain,
                                mrf.mrf_pair_plain, want_operand=True),
                  mrf.mrf_stage(x, rbs, up, want_operand=True)):
        assert a_out.dtype == dtype and torch.equal(a_out, a_want)


def test_mrf_conv_plain_outputs():
    """The plain conv's three outputs: v, its operand bf16(lrelu(v)) in the
    weights' type, and acc + scale v."""
    rbs, _ = _stage("2", 32, False, torch.bfloat16, 9)
    cw = rbs[0][0][0]
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 20, 32, generator=g)
    a, res = mrf.operand(x, torch.bfloat16), torch.randn(1, 20, 32, generator=g)
    acc = torch.ones(1, 20, 32)
    y, act, acc_out = mrf.mrf_conv_plain(a, cw, res, acc, 0.5, True, True)
    assert act.dtype == torch.bfloat16
    assert torch.equal(act, torch.nn.functional.leaky_relu(y, 0.1).to(torch.bfloat16))
    assert torch.equal(acc_out, acc + 0.5 * y)
    none = mrf.mrf_conv_plain(a, cw, want_y=False)
    assert none == (None, None, None)


def test_hifigan_packs_once():
    """``apply`` packs the kernels' weights (tiled copies included) at its
    first call only; new weights or another device or type pack again."""
    cfg = HiFiGANConfig(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                        upsample_initial_channel=64)
    torch.manual_seed(3)
    h = HiFiGAN(cfg, Policy(torch.bfloat16)).eval()
    mel = torch.randn(1, 6, cfg.num_mels)
    n0 = hifigan_mod.PACK_CALLS[0]
    first = h.apply(mel)
    for _ in range(3):
        assert torch.equal(h.apply(mel), first)
    assert hifigan_mod.PACK_CALLS[0] == n0 + 1
    assert h.kernel_weights() is h.kernel_weights()
    assert h.kernel_weights()[0][0][0][0][0].wt is not None  # stage, resblocks, pair, conv
    h.load_state_dict(h.state_dict())
    h.apply(mel)
    assert hifigan_mod.PACK_CALLS[0] == n0 + 2
    h.float()
    h.apply(mel)
    assert hifigan_mod.PACK_CALLS[0] == n0 + 3


@pytest.mark.parametrize("L,S", [(96, 8), (128, 8), (57, 8), (56, 4), (40, 4), (20, 2),
                                 (15, 2), (14, 1), (5, 1)])
def test_location_cluster_size(L, S):
    """K1's blocks per row: the largest power of two up to 8 leaving each
    rank at least 8 chars, at the flagship dims (H 1024, A 128, D 512, K
    31)."""
    assert dl.location_cluster_size(L, 1024, 128, 512, 31) == S


@pytest.mark.parametrize("H,A,D,K,S", [(1024, 128, 512, 31, 8), (1024, 4, 512, 31, 4),
                                       (1056, 128, 512, 31, 4), (1032, 128, 512, 31, 1)])
def test_location_cluster_size_follows_dims(H, A, D, K, S):
    """Dims that a larger cluster cannot split (A/S, H % 8S) take the
    largest one that ``check_cluster_dims`` accepts."""
    assert dl.location_cluster_size(128, H, A, D, K) == S


@pytest.mark.parametrize("H,A,D,K", [(1024, 96, 512, 31), (1024, 128, 508, 31),
                                     (1024, 128, 512, 30), (1020, 128, 512, 31)])
def test_location_cluster_size_refuses(H, A, D, K):
    """Dims the kernel cannot take at any cluster size raise."""
    with pytest.raises(ValueError):
        dl.location_cluster_size(128, H, A, D, K)


class _FakeLib:
    """Stands for the built library: records the dims the wrappers pass."""

    def __init__(self):
        self.calls = []

    def t2_decode_chunk(self, ptrs, dims, stream):
        self.calls.append(("chunk", list(dims)))
        return 0

    def t2_location_attention(self, *args):
        self.calls.append(("att", list(args[12:19])))
        return 0


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, device="meta", dtype=dtype)


@pytest.mark.parametrize("L", [96, 128])
def test_k1_cluster_size_does_not_follow_the_batch(L, monkeypatch):
    """The chunk entry and the attention wrapper pass K1 the same cluster
    size for 1, 16 and 64 rows at one L: a row's softmax and context sums
    run in one order whatever window it is served in."""
    fake = _FakeLib()
    monkeypatch.setattr(dl, "_lib", lambda: fake)
    monkeypatch.setattr(dl, "_stream", lambda: 0)
    monkeypatch.setattr(build, "require", lambda *a, **k: None)
    H, A, D, K, M, P, n = 1024, 128, 512, 31, 80, 256, 2
    bf = torch.bfloat16
    pk = dl.PackedDecoder(_meta(4 * H, P + D + H, dtype=bf), _meta(4 * H),
                          _meta(4 * H, 2 * H + D, dtype=bf), _meta(4 * H), _meta(M, P, dtype=bf),
                          _meta(P, P, dtype=bf), _meta(A, H, dtype=bf),
                          _meta(A, 2, K, dtype=bf), _meta(A, dtype=bf),
                          _meta(M + 1, H + D, dtype=bf), _meta(M + 1),
                          wt_att=_meta(dl.tiled_bytes(H, 2 * (P + D + H)), dtype=torch.uint8),
                          wt_dec=_meta(dl.tiled_bytes(H, 2 * (2 * H + D)), dtype=torch.uint8),
                          wt_prenet=_meta(*dl.prenet_tiled_shape(M, P), dtype=bf),
                          wt_out=_meta(*dl.heads_tiled_shape(M + 1, H + D), dtype=bf))
    for B in (1, 16, 64):
        s = dl.StepState(_meta(B, M), _meta(B, H), _meta(B, H), _meta(B, D), _meta(B, L),
                         _meta(B, L), _meta(B, H), _meta(B, H))
        dl.decode_chunk(pk, _meta(B, L, D, dtype=bf), _meta(B, L, A),
                        _meta(B, dtype=torch.int32), s, _meta(n, B, P), _meta(n, B, P))
        dl.location_attention(_meta(B, H), pk.wq, pk.w_loc, pk.wv, _meta(B, L, A),
                              _meta(B, L, D, dtype=bf), _meta(B, dtype=torch.int32),
                              _meta(B, L), _meta(B, L))
    chunk_S = {d[10] for kind, d in fake.calls if kind == "chunk"}
    att = [d for kind, d in fake.calls if kind == "att"]
    assert [d[0] for d in att] == [1, 16, 64]  # B
    assert chunk_S == {d[6] for d in att} == {dl.location_cluster_size(L, H, A, D, K)}


@pytest.mark.parametrize("shape,d2,ok", [((3, 32, 32), 1, True), ((11, 128, 128), 1, True),
                                         ((7, 64, 64), 1, True), ((3, 256, 256), 1, False),
                                         ((3, 32, 32), 3, False), ((3, 96, 96), 1, False)])
def test_pair_fusable(shape, d2, ok):
    """``mrf_pair`` takes a ResBlock1 pair of (K, C, C) convs with C one N
    tile (32, 64 or 128) and a second conv of dilation 1."""
    w = torch.zeros(*shape, dtype=torch.bfloat16)
    c1 = mrf.ConvWeights(w, torch.zeros(shape[1]), 3, None)
    c2 = mrf.ConvWeights(w, torch.zeros(shape[1]), d2, None)
    assert mrf.pair_fusable(c1, c2) == ok
    assert not mrf.pair_fusable(c1, None)


@pytest.mark.parametrize("rb", [0, 1, 2])
def test_fused_pair_plain_equals_two_convs(rb):
    """The pair's plain version is the two convs' plain versions in a row,
    bit for bit, every output, for each kernel size of a ResBlock1."""
    rbs, _ = _stage("1", 32, False, torch.bfloat16, 11)
    c1, c2 = rbs[rb][2]
    g = torch.Generator().manual_seed(4)
    a = mrf.operand(torch.randn(2, 23, 32, generator=g), torch.bfloat16)
    res, acc = torch.randn(2, 23, 32, generator=g), torch.randn(2, 23, 32, generator=g)
    got = mrf.mrf_pair_plain(a, c1, c2, res, acc, 0.25, True, True)
    _, at, _ = mrf.mrf_conv_plain(a, c1, want_y=False, want_act=True)
    want = mrf.mrf_conv_plain(at, c2, res, acc, 0.25, True, True)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_stage_runs_every_fusable_pair_as_one_call():
    """``mrf_stage``'s dataflow sends each ResBlock1 pair that ``mrf_pair``
    takes through the pair call (one launch on the card) and no conv of it
    through the single-conv call, and equals ``plain_stage`` bit for bit."""
    rbs, up = _stage("1", 32, True, torch.bfloat16, 12)
    calls = {"conv": 0, "pair": 0}

    def conv(*a, **k):
        calls["conv"] += 1
        return mrf.mrf_conv_plain(*a, **k)

    def pair(*a, **k):
        calls["pair"] += 1
        return mrf.mrf_pair_plain(*a, **k)

    x = torch.randn(1, 29, 64, generator=torch.Generator().manual_seed(5))
    got = mrf.run_stage(x, rbs, up, conv, mrf.conv_transpose_plain, pair)
    assert calls == {"conv": 0, "pair": 9}
    assert torch.equal(got, mrf.plain_stage(x, rbs, up))
    assert torch.equal(mrf.mrf_stage(x, rbs, up), got)


# ---------------------------------------------------------------------------
# K1's heads: the split-K copy tiled once per model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N,K", [(81, 1536), (81, 1552), (81, 1544), (9, 112)])
def test_heads_tiled_copy_reads_back(N, K):
    """Every weight of ``tile_heads``' copy read at the offset the kernel
    computes (``heads_tile_offset``) is w_out's; everything else (rows past
    N, columns past K in a partial last piece) is zero; the controls' 1,552
    columns are 97 whole pieces."""
    rng = np.random.default_rng(N * 10000 + K)
    w = torch.as_tensor(rng.standard_normal((N, K)).astype(np.float32)).to(torch.bfloat16)
    wt = dl.tile_heads(w)
    assert wt.shape == dl.heads_tiled_shape(N, K) and wt.dtype == torch.bfloat16
    rows = torch.arange(N)[:, None].expand(N, K)
    cols = torch.arange(K)[None, :].expand(N, K)
    off = dl.heads_tile_offset(rows, cols, N)
    flat = wt.reshape(-1)
    assert torch.equal(flat[off], w)
    assert off.unique().numel() == N * K  # one slot a weight
    rest = torch.ones(flat.numel(), dtype=torch.bool)
    rest[off.reshape(-1)] = False
    assert not bool(flat[rest].float().abs().sum())
    # a 16-byte half of row r lies at half h ^ ((r >> 2) & 1): rows 4-7 swapped
    assert dl.heads_tile_offset(4, 0, N) == 4 * 16 + 8
    assert dl.heads_tile_offset(0, 8, N) == 8


@pytest.mark.parametrize("K", [1536, 1552])
@pytest.mark.parametrize("ranks", range(1, 9))
def test_heads_split_covers_every_column_once(K, ranks):
    """The cluster's ranks take consecutive runs of 16-column pieces that
    cover the K columns once, by the dims alone, and each run is one
    contiguous slice of the tiled copy."""
    nk, NP, _ = dl.heads_tiled_shape(81, K)
    pieces = [dl.heads_pieces(K, r, ranks) for r in range(ranks)]
    assert [p for run in pieces for p in run] == list(range(nk))
    assert max(len(r) for r in pieces) - min(len(r) for r in pieces) <= 1
    cols = sorted(c for run in pieces for p in run for c in range(16 * p, min(K, 16 * p + 16)))
    assert cols == list(range(K))
    for run in pieces:  # a rank's pieces x all padded rows: one run of the copy
        if len(run):
            rows = torch.arange(NP)[:, None]
            cols = torch.arange(16 * run[0], 16 * run[-1] + 16)[None, :]
            off = dl.heads_tile_offset(rows, cols, 81).unique()
            assert torch.equal(off, torch.arange(run[0] * NP * 16, (run[-1] + 1) * NP * 16))


def test_heads_constants_mirror_the_kernel():
    """The host's copy of the heads kernel's cluster size equals the
    source's."""
    import re
    from pathlib import Path

    src = (Path(dl.__file__).parents[1] / "csrc" / "decode_step.cu").read_text()
    assert int(re.search(r"constexpr int HD_S = (\d+);", src).group(1)) == dl.HEADS_CLUSTER


def test_pack_makes_the_heads_copy():
    """``pack_decoder`` tiles w_out once for the heads, controls columns
    included (the gate's row zero there)."""
    from tests.test_torch_decode_cells import _model

    for quantize in (False, True):
        pk = _model().make_packed_decoder(quantize)
        assert pk.wt_out is not None and torch.equal(pk.wt_out, dl.tile_heads(pk.w_out))
