"""K2's f32 mode on the CPU: the vocoder at the JAX package's precision.

The JAX package vocodes under its HiFi-GAN's default policy, F32
(``run/common.py::load_hifigan``), so its MRF stage kernels run with
``bf16=False``. The port's commands build the same generator
(``run/say.py::load_hifigan``), whose stages run on the card through
``csrc/mrf_f32.cu``. Here, without a card: the f32 kernel's
tiled weight copies read back at the offsets the kernel computes, the
wrappers sending f32 weights to the f32 entries (a stand-in library on meta
tensors) with the launch plan ``chip_smoke.py`` holds the card to, and the
port's F32 generator against JAX's ``32-true`` ``apply`` with the fused
Pallas stages in interpret mode, in PCM16 LSB.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.models.hifigan import HiFiGAN as JaxHiFiGAN
from tacotron2_tpu.models.hifigan import HiFiGANConfig as JaxHiFiGANConfig
from tacotron2_tpu.models.layers import Policy as JaxPolicy
from tacotron2_tpu_torch.convert import hifigan_from_jax_params
from tacotron2_tpu_torch.models import layers
from tacotron2_tpu_torch.models.hifigan import HiFiGAN, HiFiGANConfig
from tacotron2_tpu_torch.models.layers import F32, Policy
from tacotron2_tpu_torch.ops import build, mrf

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

GEN_CFGS = {  # tests/test_torch_hifigan.py's generators
    "rb1_u4_2_2": dict(upsample_rates=(4, 2, 2), upsample_kernel_sizes=(8, 4, 4),
                       upsample_initial_channel=256, num_mels=16),
    "rb2_u2_2": dict(resblock="2", upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                     upsample_initial_channel=128, num_mels=16, resblock_kernel_sizes=(3, 5),
                     resblock_dilation_sizes=((1, 3), (1, 3))),
}


def _smoke():
    """``chip_smoke.py`` as a module (it imports torch and the port inside
    its functions only)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# UNIVERSAL_V1's conv shapes (K, Co, Ci) at reduced channels: the resblocks'
# three kernel sizes, the two folded upsamples (16, 8: Ci -> 8 Co; 4, 2: Ci
# -> 2 Co), conv_pre from 80 mel channels, and Ci past a 16-channel slice
SHAPES = [(3, 32, 32), (7, 64, 64), (11, 128, 128), (3, 256, 256), (3, 128, 32),
          (3, 64, 64), (7, 64, 80), (5, 96, 40)]


@pytest.mark.parametrize("K,Co,Ci", SHAPES)
def test_f32_tiled_copy_reads_back(K, Co, Ci):
    """``pack_conv(..., float32)``'s copy has the f32 kernel's shape (Co /
    NI, ceil(Ci / 16), K, 2, 4, NI, 4): the hi and lo planes of each tap's
    tile; every weight read at ``tile_offset`` (both planes added) is the
    tap-major weight, exactly; past Ci it is zero; each (N tile, slice) is
    one run of K x 2 tiles of 16 x NI, the taps' tiles in order."""
    rng = np.random.default_rng(K * 1000 + Co + Ci)
    conv = torch.nn.Conv1d(Ci, Co, K, padding=K // 2)
    with torch.no_grad():
        conv.weight.copy_(torch.as_tensor(rng.standard_normal((Co, Ci, K)).astype(np.float32)))
    cw = mrf.pack_conv(conv, torch.float32)
    NI, KC = mrf.conv_tiles(Co, Ci, torch.float32)
    ns = -(-Ci // KC)
    assert KC == mrf.F32_KC == 16 and NI == (128 if Co % 128 == 0 else 64 if Co % 64 == 0 else 32)
    assert cw.wt.dtype == torch.float32 and cw.wt.shape == (Co // NI, ns, K, 2, KC // 4, NI, 4)
    assert torch.equal(mrf.read_tiled(cw.wt, K, Co, Ci), cw.w)
    assert torch.equal(cw.w, conv.weight.detach().permute(2, 0, 1))
    if ns * KC > Ci:
        past = torch.arange(KC) >= Ci - (ns - 1) * KC  # the last slice's channels past Ci
        last = cw.wt[:, -1].permute(0, 1, 2, 3, 5, 4).reshape(Co // NI, K, 2, KC, NI)
        assert not last[:, :, :, past].any()
    assert mrf.tile_offset(0, 0, 0, K, Co, Ci, torch.float32, plane=1) == KC * NI
    assert mrf.tile_offset(1, 0, 0, K, Co, Ci, torch.float32) == 2 * KC * NI
    assert mrf.tile_offset(0, 0, 4, K, Co, Ci, torch.float32) == 4 * NI
    if ns > 1:
        assert mrf.tile_offset(0, 0, KC, K, Co, Ci, torch.float32) == 2 * K * KC * NI


@pytest.mark.parametrize("k,u,Ci,Co", [(16, 8, 64, 32), (16, 8, 32, 16), (4, 2, 64, 32),
                                       (4, 2, 32, 16)])
def test_f32_folded_upsample_copy_reads_back(k, u, Ci, Co):
    """UNIVERSAL_V1's two upsample kinds, folded at f32: the SAME 3-tap conv
    to u Co channels keeps f32 weights, and its f32 copy reads back to them
    exactly at the kernel's offsets."""
    rng = np.random.default_rng(k + u + Ci)
    w = torch.as_tensor(rng.standard_normal((k, Ci, Co)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal(Co).astype(np.float32))
    uw = mrf.make_upsample(w, b, u, (k - u) // 2)
    cw = uw.folded
    NI, KC = mrf.conv_tiles(u * Co, Ci, torch.float32)
    assert cw.w.dtype == torch.float32 and cw.wt.shape == (u * Co // NI, -(-Ci // KC), 3, 2,
                                                           KC // 4, NI, 4)
    assert torch.equal(mrf.read_tiled(cw.wt, 3, u * Co, Ci), cw.w)


def test_f32_pair_copies_read_back():
    """An F32 generator's ResBlock1 pairs: both convs packed as f32 copies
    that read back, and the pairs ``mrf_pair`` takes (C one N tile) are the
    same as under bf16 (channels 128, 64 and 32 here): the fused pair fits
    the f32 kernel's shared memory at every UNIVERSAL_V1 width."""
    h32 = HiFiGAN(HiFiGANConfig(**GEN_CFGS["rb1_u4_2_2"]), F32)
    hbf = HiFiGAN(HiFiGANConfig(**GEN_CFGS["rb1_u4_2_2"]), Policy(torch.bfloat16))
    hbf.load_state_dict(h32.state_dict())
    for (rbs, _), (rbs_bf, _) in zip(h32.kernel_weights(), hbf.kernel_weights()):
        for rb, rb_bf in zip(rbs, rbs_bf):
            for (c1, c2), (b1, b2) in zip(rb, rb_bf):
                for cw in (c1, c2):
                    K, Co, Ci = cw.w.shape
                    assert cw.wt.dtype == torch.float32
                    assert torch.equal(mrf.read_tiled(cw.wt, K, Co, Ci), cw.w)
                assert mrf.pair_fusable(c1, c2) == mrf.pair_fusable(b1, b2)


class _FakeLib:
    """Stands for the built libraries: records what the wrappers pass."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith(("t2_mrf_", "t2_narrow_")):
            raise AttributeError(name)
        return lambda *args: (self.calls.append((name, args)), 0)[1]


def _fake_launches(monkeypatch, policy):
    """A UNIVERSAL_V1 vocode of 16 frames through the wrappers on meta
    tensors, each library a stand-in: -> (the C calls, the wrappers'
    names, the launch counters' growth, bf16 and f32)."""
    fake = _FakeLib()
    monkeypatch.setattr(mrf, "_lib", lambda: fake)
    monkeypatch.setattr(mrf, "_lib_f32", lambda: fake)
    monkeypatch.setattr(mrf, "_stream", lambda: 0)
    names = []
    launch = mrf._launch_conv
    monkeypatch.setattr(mrf, "_launch_conv", lambda name, *a, **k: (names.append(name),
                                                                    launch(name, *a, **k))[1])
    h = HiFiGAN(HiFiGANConfig(), policy).to("meta").eval()
    before, before32 = dict(mrf.LAUNCHES), dict(mrf.F32_LAUNCHES)
    wav = h.apply(torch.empty(1, 16, 80, device="meta"))
    assert wav.shape == (1, 16 * 256)
    grown = {k: mrf.LAUNCHES[k] - before[k] for k in mrf.LAUNCHES}
    grown32 = {k: mrf.F32_LAUNCHES[k] - before32[k] for k in mrf.F32_LAUNCHES}
    return fake.calls, names, grown, grown32


def test_f32_vocode_launches_the_f32_entries(monkeypatch):
    """An F32 UNIVERSAL_V1 vocode (meta tensors, stand-in libraries) makes
    every call through ``t2_mrf_conv_f32`` / ``t2_mrf_pair_f32``: 18
    ``mrf_conv_f32``, 27 ``mrf_pair_f32``, 4 ``conv_transpose_f32`` and 1
    ``conv_pre_f32``, none of the bf16 counters, the plan
    ``chip_smoke.vocode_launches`` holds the card to; the calls' shapes and
    modes are the bf16 mode's (conv_pre at Ci = 80 with mode bit 8, the
    identity at f32; the upsamples 3-tap convs; the last conv of stages
    1-3 the mean's operand)."""
    monkeypatch.setattr(build, "require", lambda *a, **k: None)
    calls, names, grown, grown32 = _fake_launches(monkeypatch, F32)
    assert grown == dict.fromkeys(mrf.LAUNCHES, 0)
    assert grown32 == {**dict.fromkeys(mrf.F32_LAUNCHES, 0), "mrf_conv_f32": 18,
                       "mrf_pair_f32": 27, "conv_transpose_f32": 4, "conv_pre_f32": 1}
    assert grown32 == _smoke().vocode_launches(_smoke().UNIVERSAL_V1, torch.float32)
    assert {c for c, _ in calls} == {"t2_mrf_conv_f32", "t2_mrf_pair_f32"}
    assert len(calls) == 50 and names[0] == "conv_pre"
    assert calls[0][1][8:15] == (1, 16, 80, 512, 7, 1, 8)
    ups = [args[8:15] for name, (_, args) in zip(names, calls) if name == "conv_transpose"]
    assert ups == [(1, 16, 512, 2048, 3, 1, 0), (1, 128, 256, 1024, 3, 1, 0),
                   (1, 1024, 128, 128, 3, 1, 0), (1, 2048, 64, 64, 3, 1, 0)]
    modes = [args[-3] for _, args in calls if args[-3] & 3 == 2]
    assert [m & 4 for m in modes] == [0, 4, 0, 4, 0, 4, 0, 0]


def test_bf16_vocode_keeps_the_bf16_entries(monkeypatch):
    """A generator built under a bf16 policy runs K2's bf16 mode: the bf16
    entries and counters only, the smoke's bf16 plan."""
    monkeypatch.setattr(build, "require", lambda *a, **k: None)
    calls, _, grown, grown32 = _fake_launches(monkeypatch, Policy(torch.bfloat16))
    assert not any(grown32.values())
    assert grown == _smoke().vocode_launches(_smoke().UNIVERSAL_V1, torch.bfloat16)
    assert {c for c, _ in calls} == {"t2_mrf_conv", "t2_mrf_pair"}


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, device="meta", dtype=dtype)


def _conv(K, C, dtype, tiled=True, dil=1):
    w = torch.zeros(K, C, C, dtype=dtype)
    return mrf.ConvWeights(w, torch.zeros(C), dil, mrf.tile_conv(w) if tiled else None)



@pytest.mark.parametrize("case", ["f32_weights_bf16_operand", "fp16_weights", "mixed_pair",
                                  "bf16_copy_for_f32_weights", "pair_co24",
                                  "wide_copy_for_narrow_weights"])
def test_wrappers_refuse_what_the_kernels_do_not_take(case, monkeypatch):
    """On a non-CPU tensor the wrappers launch the kernel of the weights'
    type or raise, counting nothing: an operand of another type, weights of
    a type no kernel takes, a pair of two types, a tiled copy in the other
    kernel's layout; a pair that no fused pair takes (C 24: the wide
    kernels' pairs take one N tile, the narrow kernel's C in ``PAIR_C``); a
    narrow conv given another layout's copy. Every channel count has a
    kernel (the narrow one where the wide ones do not take it): Co 24, Ci 4
    and a fold from 4 channels are held against JAX in
    tests/test_torch_vocoder_shapes.py."""
    fake = _FakeLib()
    monkeypatch.setattr(mrf, "_lib", lambda: fake)
    monkeypatch.setattr(mrf, "_lib_f32", lambda: fake)
    monkeypatch.setattr(mrf, "_lib_narrow", lambda: fake)
    monkeypatch.setattr(mrf, "_stream", lambda: 0)
    monkeypatch.setattr(mrf, "mrf_conv_plain", lambda *a, **k: pytest.fail("plain version"))
    monkeypatch.setattr(mrf, "mrf_pair_plain", lambda *a, **k: pytest.fail("plain version"))
    monkeypatch.setattr(mrf, "conv_transpose_plain",
                        lambda *a, **k: pytest.fail("plain version"))

    def require(t, dtype, shape, name):  # build.require without the device rule
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, want {dtype} {shape}")

    monkeypatch.setattr(build, "require", require)
    a32, a16 = _meta(1, 8, 32), _meta(1, 8, 32, dtype=torch.bfloat16)
    c32, c16 = _conv(3, 32, torch.float32), _conv(3, 32, torch.bfloat16)
    calls = {
        "f32_weights_bf16_operand": lambda: mrf.mrf_conv(a16, c32),
        "fp16_weights": lambda: mrf.mrf_conv(_meta(1, 8, 32, dtype=torch.float16),
                                             _conv(3, 32, torch.float16)),
        "mixed_pair": lambda: mrf.mrf_pair(a32, c32, c16),
        "bf16_copy_for_f32_weights": lambda: mrf.mrf_conv(
            a32, c32._replace(wt=mrf.tile_conv(c16.w).float())),
        "pair_co24": lambda: mrf.mrf_pair(_meta(1, 8, 24), _conv(3, 24, torch.float32, dil=3),
                                          _conv(3, 24, torch.float32)),
        "wide_copy_for_narrow_weights": lambda: mrf.mrf_conv(  # the (Co / NI, ...) layout
            _meta(1, 8, 32), mrf.ConvWeights(torch.zeros(3, 16, 32), torch.zeros(16), 1,
                                             torch.zeros(1, 2, 3, 2, 4, 16, 4))),
    }
    before, before32 = dict(mrf.LAUNCHES), dict(mrf.F32_LAUNCHES)
    with pytest.raises(ValueError):
        calls[case]()
    assert mrf.LAUNCHES == before and mrf.F32_LAUNCHES == before32 and not fake.calls
    # the same weights with the right operand go through
    mrf.mrf_conv(a32, c32)
    assert fake.calls[-1][0] == "t2_mrf_conv_f32" and mrf.F32_LAUNCHES["mrf_conv_f32"] == \
        before32["mrf_conv_f32"] + 1


@pytest.mark.parametrize("name", list(GEN_CFGS))
def test_f32_launch_plan_counts_run_stage(name):
    """``chip_smoke.vocode_launches`` of an F32 generator (one launch per
    entry, per fusable pair and per other conv) equals what its stages call
    through ``run_stage`` on the CPU, counted by hooks around the plain
    versions under the counter each call's launch would add to
    (``mrf.launch_key``), and those stages equal ``apply``'s."""
    kw = GEN_CFGS[name]
    h = HiFiGAN(HiFiGANConfig(**kw), F32).eval()
    counts = dict.fromkeys(mrf.F32_LAUNCHES, 0)
    counts[mrf.launch_key("conv_pre", h.conv_pre_weights())] += 1

    def hook(name, fn, weights=lambda w: w):
        def call(a, w, *rest, **k):
            counts[mrf.launch_key(name, weights(w))] += 1
            return fn(a, w, *rest, **k)
        return call

    conv = hook("mrf_conv", mrf.mrf_conv_plain)
    pair = hook("mrf_pair", mrf.mrf_pair_plain)
    conv_t = hook("conv_transpose", mrf.conv_transpose_plain, lambda uw: uw.folded)
    mel = torch.randn(2, 9, kw["num_mels"], generator=torch.Generator().manual_seed(3))
    a = mrf.conv_pre(mel, h.conv_pre_weights())
    packed = h.kernel_weights()
    for i, (rbs, ups) in enumerate(packed):
        a = mrf.run_stage(None, rbs, ups, conv, conv_t, pair, a, i < len(packed) - 1)
    h_dict = {"resblock": "1", "resblock_kernel_sizes": [3, 7, 11],
              "resblock_dilation_sizes": [[1, 3, 5]] * 3, **kw}
    assert counts == _smoke().vocode_launches(h_dict, torch.float32)
    want = h.apply(mel)
    x = torch.nn.functional.leaky_relu(a, 0.01)
    x = layers.conv1d(x, h.conv_post.weight, h.conv_post.bias, F32, padding=3, round_out=True)
    assert torch.equal(torch.tanh(x)[..., 0], want)


def _pcm(wav):
    return np.clip(np.round(wav.astype(np.float64) * 32767), -32768, 32767)


F32_GEN_LSB = 1  # PCM16 LSB: the two sum in other orders, within 1e-5 of each stage's scale


@pytest.mark.parametrize("name", list(GEN_CFGS))
def test_f32_apply_matches_jax_32_true(name):
    """The port's F32 generator (the commands' vocoder: ``load_hifigan``)
    against JAX's ``apply`` under ``32-true`` with the fused Pallas stages
    (``mrf_pallas=True, fuse_ups=True``, interpret mode), the TPU kernels'
    ``bf16=False``, on the same weights: at most ``F32_GEN_LSB`` PCM16 LSB
    apart."""
    kw = GEN_CFGS[name]
    jm = JaxHiFiGAN(JaxHiFiGANConfig(**kw), JaxPolicy.from_string("32-true"))
    p = jax.tree.map(lambda a: a * 3.0, jm.init(jax.random.PRNGKey(1)))
    mel = np.random.default_rng(2).standard_normal((2, 17, 16)).astype(np.float32)
    ref = np.asarray(jm.apply(p, jnp.asarray(mel), mrf_pallas=True, fuse_ups=True,
                              interpret=True))
    tm = HiFiGAN(HiFiGANConfig(**kw), F32)
    tm.load_state_dict(hifigan_from_jax_params(p))
    got = tm.apply(torch.as_tensor(mel)).numpy()
    assert got.shape == ref.shape == (2, 17 * tm.cfg.total_upsample)
    assert np.abs(_pcm(got) - _pcm(ref)).max() <= F32_GEN_LSB
