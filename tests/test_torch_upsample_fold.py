"""K2's upsample as a folded SAME conv, on the CPU (no card, no JAX): a
transposed conv of stride u, kernel k = 2u and padding (k - u) / 2 is, in
channels-last memory, a 3-tap conv from Ci to u Co channels
(``fold_upsample``), which ``conv_transpose`` runs on ``mrf_conv``'s
kernel. Here: the fold's math against ``conv_transpose_plain``, its zero
taps, its tiled copy, the shapes it refuses, the HiFi-GAN's packing, the
vocoder's operand route (``conv_pre`` writing stage 1's operand, each
stage's mean passed on as the next upsample's bf16 operand) against the
plain stages, and the launches a vocode makes through the wrappers, counted
against a stand-in library."""

import numpy as np
import pytest
import torch

from tacotron2_tpu_torch.models import hifigan as hifigan_mod
from tacotron2_tpu_torch.models import layers
from tacotron2_tpu_torch.models.hifigan import HiFiGAN, HiFiGANConfig
from tacotron2_tpu_torch.models.layers import Policy
from tacotron2_tpu_torch.ops import build, mrf

torch.set_num_threads(1)

FOLD_TOL = 1e-6  # max |folded - transposed| / max |transposed|, f32 sums in another order
# (k, u, Ci, Co): UNIVERSAL_V1's two upsample kinds at its channel ratio
# (Ci = 2 Co), and V2/V3's k = 8, u = 4, at narrow widths
FOLDS = [(16, 8, 64, 32), (4, 2, 64, 32), (8, 4, 64, 32)]


def _upsample(k, u, Ci, Co, dtype, seed):
    rng = np.random.default_rng(seed)
    w = torch.as_tensor(rng.standard_normal((k, Ci, Co)).astype(np.float32) / (Ci * 2) ** 0.5)
    b = torch.as_tensor(rng.standard_normal(Co).astype(np.float32))
    return mrf.make_upsample(w.to(dtype), b, u, (k - u) // 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,u,Ci,Co", FOLDS)
def test_fold_equals_conv_transpose(k, u, Ci, Co, dtype):
    """``mrf_conv_plain`` on the folded weights, its (B, Tin, u Co) output
    viewed as (B, u Tin, Co), equals ``conv_transpose_plain`` on the same
    operand within FOLD_TOL (readings: 1.6e-7 to 2.2e-7 in f32, 1.1e-7 to
    1.5e-7 with bf16 operands and weights): only the sums' order differs.
    A bf16 upsample that JAX runs on XLA rounds its sum before the bias in
    both (``round_sum``, the kernel's mode 8, as ``conv_transpose`` passes
    it)."""
    uw = _upsample(k, u, Ci, Co, dtype, k * 100 + u)
    assert uw.folded is not None and uw.folded.w.shape == (3, u * Co, Ci)
    x = torch.randn(2, 13, Ci, generator=torch.Generator().manual_seed(k + u))
    a = mrf.operand(x, dtype)
    ref, ref_act = mrf.conv_transpose_plain(a, uw, want_act=True)
    y, act, _ = mrf.mrf_conv_plain(a, uw.folded, want_act=True, round_sum=uw.round_sum)
    got = y.reshape(2, 13 * u, Co)
    assert got.shape == ref.shape
    rel = float((got - ref).abs().max() / ref.abs().max())
    assert rel <= FOLD_TOL, rel
    assert torch.equal(act.reshape(2, 13 * u, Co), mrf.operand(got, dtype))


@pytest.mark.parametrize("k,u,Ci,Co", FOLDS)
def test_unreached_taps_are_zero(k, u, Ci, Co):
    """Each phase r (output channels r Co .. r Co + Co - 1) reaches k / u
    = 2 of the 3 taps, which hold the transposed conv's taps j u + beta;
    the third is exactly zero, and the bias is tiled u times."""
    uw = _upsample(k, u, Ci, Co, torch.float32, 7)
    wf = uw.folded.w.view(3, u, Co, Ci)
    pad = (k - u) // 2
    for r in range(u):
        alpha, beta = divmod(r + pad, u)
        reached = {1 + alpha - j: j * u + beta for j in range(k // u)}
        assert len(reached) == 2
        for tap in range(3):
            if tap in reached:
                assert torch.equal(wf[tap, r], uw.w[reached[tap]].t())
            else:
                assert not bool(wf[tap, r].any())
    assert torch.equal(uw.folded.b, uw.b.repeat(u))
    assert uw.folded.dilation == 1


@pytest.mark.parametrize("k,u,Ci,Co", [(16, 8, 512, 256), (16, 8, 256, 128), (4, 2, 128, 64),
                                       (4, 2, 64, 32)])
def test_folded_copy_reads_back(k, u, Ci, Co):
    """UNIVERSAL_V1's four upsamples: the folded conv's tiled copy, read at
    the kernel's offsets (``tile_offset`` / ``read_tiled``), is the folded
    tap-major weights."""
    uw = _upsample(k, u, Ci, Co, torch.bfloat16, Ci)
    cw = uw.folded
    NI, KC = mrf.conv_tiles(u * Co, Ci)
    assert cw.wt.shape == (u * Co // NI, Ci // KC, 3, KC // 8, NI, 8)
    assert torch.equal(mrf.read_tiled(cw.wt, 3, u * Co, Ci), cw.w)


@pytest.mark.parametrize("k,u,pad", [(6, 4, 1), (4, 2, 0), (5, 2, 1), (4, 2, 2)])
def test_shapes_that_do_not_fold(k, u, pad):
    """No fold where k % u != 0 or Tout != u Tin: ``fold_upsample`` raises
    ValueError, ``make_upsample`` keeps no folded copy (the plain version
    still runs), and off the CPU the wrapper takes no kernel's path but
    JAX's XLA route on stock ops, counted as ``conv_transpose_stock``."""
    assert mrf.fold_reach(k, u, pad) is None
    w = torch.zeros(k, 64, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="fold"):
        mrf.fold_upsample(w, torch.zeros(32), u, pad)
    uw = mrf.make_upsample(w, torch.zeros(32), u, pad)
    assert uw.folded is None
    before, stock = dict(mrf.LAUNCHES), mrf.STOCK_ROUTES["conv_transpose_stock"]
    uw = mrf.make_upsample(w.to("meta"), torch.zeros(32, device="meta"), u, pad)
    y, act = mrf.conv_transpose(torch.empty(1, 8, 64, device="meta", dtype=torch.bfloat16), uw,
                                want_act=True)
    assert y.shape == act.shape == (1, 7 * u - 2 * pad + k, 32) and act.dtype == torch.bfloat16
    assert mrf.LAUNCHES == before and mrf.STOCK_ROUTES["conv_transpose_stock"] == stock + 1


@pytest.mark.parametrize("k,u,reach", [(16, 8, 1), (4, 2, 1), (8, 4, 1), (6, 2, 1), (12, 4, 1),
                                       (2, 2, 0), (10, 2, 2)])
def test_fold_reach(k, u, reach):
    """Where Tout = u Tin and k % u == 0 the phases' rows are a centred
    window: one row each side for k = 2u, more for longer kernels."""
    assert mrf.fold_reach(k, u, (k - u) // 2) == reach


def _hifigan(policy=torch.float32, seed=3):
    cfg = HiFiGANConfig(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                        upsample_initial_channel=128, num_mels=16)
    torch.manual_seed(seed)
    return HiFiGAN(cfg, Policy(policy)).eval()


def test_hifigan_packs_the_fold_once():
    """``kernel_weights`` packs each upsample's folded conv (tiled) with the
    rest, once per model."""
    h = _hifigan(torch.bfloat16)
    n0 = hifigan_mod.PACK_CALLS[0]
    packed = h.kernel_weights()
    for _ in range(2):
        h.apply(torch.randn(1, 5, 16))
    assert hifigan_mod.PACK_CALLS[0] == n0 + 1 and h.kernel_weights() is packed
    for (_, uw), up in zip(packed, h.ups):
        want = mrf.fold_upsample(up.weight.detach().permute(2, 0, 1).to(torch.bfloat16),
                                 up.bias.detach(), up.stride[0], up.padding[0])
        assert torch.equal(uw.folded.w, want.w) and torch.equal(uw.folded.wt, want.wt)
        assert torch.equal(uw.folded.b, want.b)


@pytest.mark.parametrize("policy", [torch.float32, torch.bfloat16])
def test_vocoder_operand_route_equals_plain_stages(policy):
    """``HiFiGAN.apply``'s route (each stage's mean passed to the next
    upsample as its operand alone, stage 1's written by ``conv_pre``)
    equals the plain reference route (``plain_stage`` from f32 inputs) bit
    for bit; ``conv_pre`` from the mel in the compute type is ``operand`` of
    the policy's conv with its sum rounded before the bias; a stage asked
    for its operand returns that of its mean, and ``side_output_stage``
    from an operand the stage from its input."""
    h = _hifigan(policy)
    mel = torch.randn(2, 7, 16, generator=torch.Generator().manual_seed(1))
    assert torch.equal(h.apply(mel), h.apply(mel, plain=True))
    pre = layers.conv1d(mel, h.conv_pre.weight, h.conv_pre.bias, h.policy, padding=3,
                        round_out=True)
    assert torch.equal(mrf.conv_pre(mel.to(policy), h.conv_pre_weights()),
                       mrf.operand(pre, policy))
    rbs, ups = h.kernel_weights()[0]
    x = torch.randn(2, 7, 128, generator=torch.Generator().manual_seed(2))
    mean = mrf.mrf_stage(x, rbs, ups)
    a = mrf.mrf_stage(x, rbs, ups, want_operand=True)
    assert torch.equal(a, mrf.operand(mean, ups.w.dtype))
    a_in = mrf.operand(x, ups.w.dtype)
    assert torch.equal(mrf.mrf_stage(None, rbs, ups, a_in), mean)
    assert torch.equal(mrf.side_output_stage(None, rbs, ups, a_in), mrf.plain_stage(x, rbs, ups))


class _FakeLib:
    """Stands for the built library: records what the wrappers pass."""

    def __init__(self):
        self.calls = []

    def t2_mrf_conv(self, *args):
        self.calls.append(("mrf_conv", args))
        return 0

    def t2_mrf_pair(self, *args):
        self.calls.append(("mrf_pair", args))
        return 0


def test_vocode_launches_what_it_counts(monkeypatch):
    """A UNIVERSAL_V1 vocode through the wrappers (meta tensors, a stand-in
    library) counts 18 ``mrf_conv``, 27 ``mrf_pair``, 4 ``conv_transpose``
    and 1 ``conv_pre`` launch, and makes as many C calls: ``conv_pre`` first,
    a 7-tap conv from the 80 mel channels writing only its operand with the
    sum rounded before the bias (mode bit 8), each upsample one 3-tap conv
    of dilation 1 to u Co channels (mode 0), and the last conv of stages
    1-3 the mean's operand only (mode bit 4)."""
    fake = _FakeLib()
    monkeypatch.setattr(mrf, "_lib", lambda: fake)
    monkeypatch.setattr(mrf, "_stream", lambda: 0)
    monkeypatch.setattr(build, "require", lambda *a, **k: None)
    names = []
    launch = mrf._launch_conv
    monkeypatch.setattr(mrf, "_launch_conv", lambda name, *a, **k: (names.append(name),
                                                                    launch(name, *a, **k))[1])
    h = HiFiGAN(HiFiGANConfig(), Policy(torch.bfloat16)).to("meta").eval()
    before = dict(mrf.LAUNCHES)
    wav = h.apply(torch.empty(1, 16, 80, device="meta"))
    assert wav.shape == (1, 16 * 256)
    grown = {k: mrf.LAUNCHES[k] - before[k] for k in mrf.LAUNCHES}
    assert grown == {**dict.fromkeys(mrf.LAUNCHES, 0), "mrf_conv": 18, "mrf_pair": 27,
                     "conv_transpose": 4, "conv_pre": 1}  # no narrow entry at V1's widths
    assert len(fake.calls) == sum(grown.values()) and names[0] == "conv_pre"
    convs = fake.calls
    assert len(names) == len(convs) and convs[0][0] == "mrf_conv"
    # conv_pre: the mel's 80 channels to 512, k=7, mode 8
    assert convs[0][1][8:15] == (1, 16, 80, 512, 7, 1, 8)
    # t2_mrf_conv's ints: B, T, Ci, Co, K, dil, mode at 8..14
    ups = [args[8:15] for name, (_, args) in zip(names, convs) if name == "conv_transpose"]
    assert ups == [(1, 16, 512, 2048, 3, 1, 0), (1, 128, 256, 1024, 3, 1, 0),
                   (1, 1024, 128, 128, 3, 1, 0), (1, 2048, 64, 64, 3, 1, 0)]
    modes = [args[-3] for _, args in convs if args[-3] & 3 == 2]
    # per stage two resblocks add to the mean; the last of stages 1-3 writes its operand
    assert [m & 4 for m in modes] == [0, 4, 0, 4, 0, 4, 0, 0]
