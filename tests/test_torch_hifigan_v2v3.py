"""HiFi-GAN V2 and V3 (jik876/hifi-gan's config_v2.json and config_v3.json)
on the CPU: K2 at every shape the TPU stage kernel takes.

V2 runs its stages 3 and 4 at 16 and 8 channels (the TPU kernel's phase
fold s = 128 / C) and folds its last upsample into a conv to 2 x 8
channels: on the card those run on the narrow kernel
(``csrc/mrf_narrow.cu``). V3 runs ResBlock2 (one dilated conv per
dilation, dilations up to 12: a k = 7, d = 12 conv reads 36 rows on each
side) at 128, 64 and 32 channels, and a u = 4, k = 8 upsample that JAX runs
as XLA's transposed conv before the stage kernel, which the port folds.

Here, without a card: the port's generators at the published widths
against JAX's ``apply`` with the fused Pallas stages in interpret mode;
``mrf.mrf_stage`` against ``mrf_stage_pallas`` at C = 16 and 8 and at V3's
stage 3; the narrow kernel's weight copy read back at the offsets the
kernel computes; the launches of a V2 / V3 vocode through the wrappers on
meta tensors with a stand-in library against ``chip_smoke.vocode_launches``;
the narrow entries' C signatures and shared-memory plan against the
source.
"""

import importlib.util
import math
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.models.hifigan import HiFiGAN as JaxHiFiGAN
from tacotron2_tpu.models.hifigan import HiFiGANConfig as JaxHiFiGANConfig
from tacotron2_tpu.models.layers import Policy as JaxPolicy
from tacotron2_tpu.models.layers import conv_transpose1d_apply
from tacotron2_tpu.ops.mrf_pallas import mrf_stage_pallas
from tacotron2_tpu_torch.convert import hifigan_from_jax_params
from tacotron2_tpu_torch.models.hifigan import HiFiGAN, HiFiGANConfig
from tacotron2_tpu_torch.models.layers import F32, Policy
from tacotron2_tpu_torch.ops import build, mrf

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SRC = (ROOT / "tacotron2_tpu_torch" / "csrc" / "mrf_narrow.cu").read_text()


def _smoke():
    """``chip_smoke.py`` as a module (it imports torch and the port inside
    its functions only): its HIFIGAN_V2 / HIFIGAN_V3 are the configs."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _smoke()
CONFIGS = {"v2": SMOKE.HIFIGAN_V2, "v3": SMOKE.HIFIGAN_V3}
# the random weights' scale over JAX's init: outputs of 0.1-0.5 (at 3x, V2's
# peak is 0.0016, 52 PCM16 LSB, too small to read LSB on)
WEIGHT_SCALE = {"v2": 6.0, "v3": 4.0}


def _kw(h: dict) -> dict:
    """A config dict -> HiFiGANConfig's keyword arguments (both packages')."""
    return dict(resblock=h["resblock"], upsample_rates=tuple(h["upsample_rates"]),
                upsample_kernel_sizes=tuple(h["upsample_kernel_sizes"]),
                upsample_initial_channel=h["upsample_initial_channel"],
                resblock_kernel_sizes=tuple(h["resblock_kernel_sizes"]),
                resblock_dilation_sizes=tuple(tuple(d) for d in h["resblock_dilation_sizes"]),
                num_mels=h["num_mels"])


def _pcm(wav):
    return np.clip(np.round(wav.astype(np.float64) * 32767), -32768, 32767)


F32_GEN_LSB = 1  # tests/test_torch_vocoder_f32.py's: the sums' order only
# bf16: the mean PCM16 LSB from JAX's Pallas route, from readings (V2 5.13,
# V3 2.61, both stages 2 of V2 and 2-3 of V3 rounding the upsample's sum
# before its bias as JAX's XLA transposed conv does; 7.51 and 9.13 without)
BF16_GEN_MEAN_LSB = {"v2": 6.0, "v3": 3.0}


def _generators(name: str, precision: str):
    kw = _kw(CONFIGS[name])
    jm = JaxHiFiGAN(JaxHiFiGANConfig(**kw), JaxPolicy.from_string(precision))
    p = jax.tree.map(lambda a: a * WEIGHT_SCALE[name], jm.init(jax.random.PRNGKey(1)))
    pol = F32 if precision == "32-true" else Policy(torch.bfloat16)
    tm = HiFiGAN(HiFiGANConfig(**kw), pol)
    tm.load_state_dict(hifigan_from_jax_params(p))
    return jm, p, tm


@pytest.mark.parametrize("precision", ["32-true", "bf16-mixed"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_generator_matches_jax(name, precision):
    """The port's generator at the published widths (the weights JAX's
    init draws, scaled, through ``convert.hifigan_from_jax_params``) against
    JAX's ``apply`` with the fused Pallas stages in interpret mode, on 2
    rows of 5 mel frames. F32 (the commands' vocoder): within
    ``F32_GEN_LSB``. bf16: no further from JAX's Pallas route than JAX's own
    XLA route (``mrf_pallas=False``) is in the worst sample, and on average
    within ``BF16_GEN_MEAN_LSB``. At outputs of 0.18 / 0.35 a one-ulp
    rounding flip of a bf16 operand, carried through the later convs, moves
    a sample by tens of LSB, so tests/test_torch_hifigan.py's 10 LSB (read
    at a peak under 1/16) does not carry over; readings (max / mean LSB): V2
    40 / 5.1 against JAX's own 64 / 8.6, V3 60 / 2.6 against 63 / 12.8
    (before the upsamples that JAX runs on XLA rounded their sums: 47 / 7.5
    and 63 / 9.1, within JAX's spread plus one bf16 ulp of the peak)."""
    jm, p, tm = _generators(name, precision)
    mel = np.random.default_rng(2).standard_normal((2, 5, 80)).astype(np.float32)
    ref = np.asarray(jm.apply(p, jnp.asarray(mel), mrf_pallas=True, fuse_ups=True,
                              interpret=True))
    got = tm.apply(torch.as_tensor(mel)).numpy()
    assert got.shape == ref.shape == (2, 5 * 256)
    assert 0.1 < np.abs(ref).max() < 0.9  # real audio, tanh not saturated
    lsb = np.abs(_pcm(got) - _pcm(ref))
    if precision == "32-true":
        assert lsb.max() <= F32_GEN_LSB, lsb.max()
        return
    xla = np.asarray(jm.apply(p, jnp.asarray(mel), mrf_pallas=False, fuse_ups=False))
    spread = np.abs(_pcm(xla) - _pcm(ref))
    assert lsb.mean() <= BF16_GEN_MEAN_LSB[name] and lsb.max() <= spread.max(), (
        lsb.max(), lsb.mean(), spread.max(), spread.mean())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_mel_receptive_field_equal(name):
    """The vocode bucket's reach (``say.vocode_bucket``, the server's
    windows) is JAX's for both configs: ResBlock2's sum of d (k - 1) / 2
    reaches 45 samples at V3's stage 1."""
    kw = _kw(CONFIGS[name])
    assert (HiFiGAN(HiFiGANConfig(**kw)).mel_receptive_field()
            == JaxHiFiGAN(JaxHiFiGANConfig(**kw)).mel_receptive_field())


RB = {"1": ((3, 7, 11), ((1, 3, 5),) * 3), "2": ((3, 5, 7), ((1, 2), (2, 6), (3, 12)))}
BF16_STAGE_TOL = 4e-3  # tests/test_torch_hifigan.py's, of the output's scale


def _jax_conv(rng, k, cin, cout, scale=0.15):
    return {"w": jnp.asarray(rng.standard_normal((k, cin, cout)).astype(np.float32) * scale),
            "b": jnp.asarray(rng.standard_normal(cout).astype(np.float32) * 0.1)}


def _to_torch_conv(p, d, dtype):
    w = np.asarray(p["w"]).transpose(0, 2, 1).copy()
    return mrf.ConvWeights(torch.as_tensor(w).to(dtype), torch.as_tensor(np.array(p["b"])), d)


def _stage_params(rng, rb_type, C, dtype):
    kernels, dils = RB[rb_type]
    jrbs, trbs = [], []
    for kr, dil in zip(kernels, dils):
        if rb_type == "1":
            c1 = [_jax_conv(rng, kr, C, C) for _ in dil]
            c2 = [_jax_conv(rng, kr, C, C) for _ in dil]
            jrbs.append({"convs1": c1, "convs2": c2})
            trbs.append([(_to_torch_conv(a, d, dtype), _to_torch_conv(b, 1, dtype))
                         for a, b, d in zip(c1, c2, dil)])
        else:
            c = [_jax_conv(rng, kr, C, C) for _ in dil]
            jrbs.append({"convs": c})
            trbs.append([(_to_torch_conv(a, d, dtype), None) for a, d in zip(c, dil)])
    return jrbs, trbs


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("rb_type,variant,u,cin,C,length", [
    ("1", "mrf_only", None, 16, 16, 157),     # V2's stage 3 MRF, s = 8
    ("1", "mrf_only", None, 8, 8, 201),       # V2's stage 4 MRF, s = 16
    ("2", "mrf_only", None, 16, 16, 157),     # ResBlock2 at the narrow widths
    ("2", "mrf_only", None, 8, 8, 201),
    ("1", "ups_aligned", 2, 32, 16, 61),      # V2's 32 -> 16: _make_stage_kernel_ups
    ("1", "ups_aligned", 2, 16, 8, 77),       # V2's 16 -> 8 (the narrow upsample)
    ("2", "ups_xla", 4, 64, 32, 23),          # V3's stage 3: XLA's convT, then the kernel
])
def test_mrf_stage_matches_pallas(rb_type, variant, u, cin, C, length, bf16):
    """``mrf.mrf_stage`` (plain versions on the CPU; on the card the narrow
    kernel at C = 16 and 8, the wide ones at V3's stage 3) against
    ``mrf_stage_pallas`` in interpret mode on the same weights, with
    tests/test_torch_hifigan.py's tolerances: f32 1e-5 of the output's
    scale, bf16 ``BF16_STAGE_TOL``. V3's stage 3 is not fusable on the TPU
    (u = 4 at C = 32 is neither aligned nor expanded): there JAX runs
    ``conv_transpose1d_apply`` (XLA, under bf16 its sum rounded before the
    bias, as JAX's ``apply`` passes its policy) and the stage kernel after
    it, the port one folded conv (``fold_reach(8, 4, 2) == 1``, the same
    rounding: ``UpsampleWeights.round_sum``) and the stage."""
    rng = np.random.default_rng(C + (u or 0) + int(rb_type))
    kernels, dils = RB[rb_type]
    dtype = torch.bfloat16 if bf16 else torch.float32
    jrbs, trbs = _stage_params(rng, rb_type, C, dtype)
    x = rng.standard_normal((2, length, cin)).astype(np.float32)
    kw = dict(resblock=rb_type, kernels=kernels, dilations=dils, bf16=bf16, interpret=True)
    ups_t, xj = None, jnp.asarray(x)
    if u is not None:
        k = 2 * u
        ups = _jax_conv(rng, k, cin, C, scale=0.2)
        ups_t = mrf.make_upsample(torch.as_tensor(np.array(ups["w"])).to(dtype),
                                  torch.as_tensor(np.array(ups["b"])), u, (k - u) // 2)
        assert ups_t.folded is not None
        if variant == "ups_xla":
            assert ups_t.round_sum == bf16
            xj = conv_transpose1d_apply(ups, jax.nn.leaky_relu(xj, 0.1), stride=u,
                                        padding=(k - u) // 2,
                                        policy=JaxPolicy.from_string("bf16-mixed" if bf16
                                                                     else "32-true"))
        else:
            kw["upsample"] = (ups, u)
    ref = np.asarray(mrf_stage_pallas(jrbs, xj, **kw))
    got = mrf.mrf_stage(torch.as_tensor(x), trbs, ups_t).numpy()
    assert got.shape == ref.shape
    scale = float(np.abs(ref).max())
    tol = BF16_STAGE_TOL * scale if bf16 else 1e-5 * max(scale, 1e-3)
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


# (K, Co, Ci): V2's narrow resblock convs, its folded last upsample (3, 2 x
# 8, 16), a conv_pre at 16 channels (Ci = 80: 8-channel slices) and Ci = 24
NARROW_SHAPES = [(3, 16, 16), (7, 16, 16), (11, 16, 16), (11, 8, 8), (3, 16, 16), (7, 16, 80),
                 (5, 8, 24)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,Co,Ci", NARROW_SHAPES)
def test_narrow_copy_reads_back(K, Co, Ci, dtype):
    """At 8 or 16 output channels and Ci a multiple of 8 the narrow kernel
    runs on the tensor cores (``narrow_mma``): at Ci 8 or 16 (V2's shapes)
    the small route, whose copy ``pack_conv`` makes in the B fragments'
    order, (K, Co / 8, k steps, 32 lanes, elements) (``small_layout``),
    every element a weight (no pad; f32 its hi and lo planes, adding to the
    weights bit for bit); at another Ci (80, 24) ``narrow_mma_kernel``'s
    (K, planes, Co8, Ci_pad). Every weight read at ``tile_offset`` is the
    tap-major weight, exactly; a tap's fragments are one run, a lane's
    elements side by side; ``_require_conv`` refuses the CUDA cores' (Ci,
    K, Co) copy."""
    rng = np.random.default_rng(K * 100 + Co + Ci)
    conv = torch.nn.Conv1d(Ci, Co, K, padding=K // 2)
    with torch.no_grad():
        conv.weight.copy_(torch.as_tensor(rng.standard_normal((Co, Ci, K)).astype(np.float32)))
    cw = mrf.pack_conv(conv, dtype)
    f32 = dtype == torch.float32
    assert not mrf.wide(Co, Ci) and mrf.narrow_mma(Co, Ci)
    assert mrf.narrow_small(Co, Ci) == (Ci in (8, 16))
    with pytest.raises(ValueError):  # no tiles of the wide kernels
        mrf.conv_tiles(Co, Ci, dtype)
    assert cw.wt.dtype == dtype and torch.equal(mrf.read_tiled(cw.wt, K, Co, Ci), cw.w)
    if f32:
        hi, lo = mrf.tf32_split(cw.w)
        assert torch.equal(mrf.read_tiled(cw.wt, K, Co, Ci, 0), hi)
        assert torch.equal(mrf.read_tiled(cw.wt, K, Co, Ci, 1), lo) and torch.equal(hi + lo, cw.w)
    if mrf.narrow_small(Co, Ci):
        shape = (K, Co // 8, Ci // 8 if f32 else 1, 32, 4 if f32 else Ci // 4)
        assert mrf.small_layout(Co, Ci, dtype) == shape[1:] and cw.wt.shape == shape
        j, co, ci = (torch.arange(n).view(*[-1 if i == d else 1 for i in range(3)])
                     for d, n in enumerate((K, Co, Ci)))
        offs = torch.cat([mrf.tile_offset(j, co, ci, K, Co, Ci, dtype, p).reshape(-1)
                          for p in range(2 if f32 else 1)])
        assert torch.equal(offs.sort().values, torch.arange(cw.wt.numel()))  # no pad
        # lane 4 g + t of (tap, n tile, k step): w[g][2t, 2t + 1 (, 2t + 8, 2t + 9)] in bf16,
        # w[g][t], w[g][t + 4] of the hi plane then the lo plane in f32
        lane = cw.wt[1, 0, 0, 4 * 3 + 2]
        want = ([hi[1, 3, 2], hi[1, 3, 6], lo[1, 3, 2], lo[1, 3, 6]] if f32 else
                [cw.w[1, 3, c] for c in ((4, 5, 12, 13) if Ci == 16 else (4, 5))])
        assert torch.equal(lane, torch.stack(want))
    else:
        assert cw.wt.shape == (K, 2 if f32 else 1, *mrf.mma_pads(Co, Ci, dtype))
    require = build.require
    try:  # the device rule aside: the copy's shape and type
        build.require = lambda t, dt, shape, name: (
            None if t.dtype == dt and tuple(t.shape) == tuple(shape) else
            (_ for _ in ()).throw(ValueError(f"{name}: {tuple(t.shape)}, want {tuple(shape)}")))
        mrf._require_conv(cw, Ci, "conv")
        with pytest.raises(ValueError):
            mrf._require_conv(cw._replace(wt=torch.zeros(Ci, K, Co, dtype=dtype)), Ci, "conv")
    finally:
        build.require = require


@pytest.mark.parametrize("k,u,Ci,Co", [(4, 2, 16, 8), (4, 2, 8, 4)])
def test_narrow_upsample_fold(k, u, Ci, Co):
    """V2's last upsample (16 -> 2 x 8) folds into a conv to 16 channels,
    which the narrow kernel's small route takes (its copy in the B
    fragments' order, ``small_layout``, made by ``fold_upsample``); a fold
    to 8 channels (8 -> 2 x 4) is taken too, and so is one to 2 x 4 or 2 x
    8 from 4 input channels (Ci off 8: ``narrow_mma_kernel``'s copy (K,
    planes, Co8, Ci_pad))."""
    rng = np.random.default_rng(k + Ci)
    w = torch.as_tensor(rng.standard_normal((k, Ci, Co)).astype(np.float32))
    uw = mrf.make_upsample(w, torch.zeros(Co), u, (k - u) // 2)
    assert mrf.narrow_small(u * Co, Ci) and uw.folded.wt.shape == (3, *mrf.small_layout(
        u * Co, Ci, torch.float32))
    assert torch.equal(mrf.read_tiled(uw.folded.wt, 3, u * Co, Ci), uw.folded.w)
    uw4 = mrf.make_upsample(w[:, :4], torch.zeros(Co), u, 1)
    assert not mrf.wide(u * Co, 4) and mrf.narrow_mma(u * Co, 4)
    assert not mrf.narrow_small(u * Co, 4)
    assert uw4.folded.wt.shape == (3, 2, u * Co, 8)  # f32: hi and lo, Ci to the k tile 8
    assert torch.equal(mrf.read_tiled(uw4.folded.wt, 3, u * Co, 4), uw4.folded.w)


class _FakeLib:
    """Stands for every built library: records what the wrappers pass."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith(("t2_mrf_", "t2_narrow_")):
            raise AttributeError(name)
        return lambda *args: (self.calls.append((name, args)), 0)[1]


def _stand_in(monkeypatch):
    fake = _FakeLib()
    for lib in ("_lib", "_lib_f32", "_lib_narrow"):
        monkeypatch.setattr(mrf, lib, lambda: fake)
    monkeypatch.setattr(mrf, "_stream", lambda: 0)
    return fake


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_vocode_launches_match_the_plan(name, dtype, monkeypatch):
    """A V2 / V3 vocode through the wrappers (meta tensors, a stand-in for
    the libraries) grows the counters by exactly
    ``chip_smoke.vocode_launches`` of its config, and no counter of the
    other mode: V2 9 + 9 narrow pairs, 18 wide pairs and 1 narrow upsample;
    V3 18 ResBlock2 convs and 3 upsamples on the wide kernel. Each C call
    is the entry of its width and type, the narrow ones at Co 8 or 16."""
    monkeypatch.setattr(build, "require", lambda *a, **k: None)
    fake = _stand_in(monkeypatch)
    h = CONFIGS[name]
    gen = HiFiGAN(HiFiGANConfig.from_dict(h), Policy(dtype)).to("meta").eval()
    before, before32 = dict(mrf.LAUNCHES), dict(mrf.F32_LAUNCHES)
    wav = gen.apply(torch.empty(1, 16, 80, device="meta"))
    assert wav.shape == (1, 16 * 256)
    f32 = dtype == torch.float32
    grown = {k: v - before[k] for k, v in mrf.LAUNCHES.items()}
    grown32 = {k: v - before32[k] for k, v in mrf.F32_LAUNCHES.items()}
    want = SMOKE.vocode_launches(h, dtype)
    assert (grown32 if f32 else grown) == want
    assert not any((grown if f32 else grown32).values())
    sfx = "_f32" if f32 else ""
    narrow = {"v2": {"narrow_pair": 18, "narrow_transpose": 1}, "v3": {}}[name]
    assert {k: v for k, v in want.items() if k.startswith("narrow") and v} == {
        k + sfx: v for k, v in narrow.items()}
    assert len(fake.calls) == sum(want.values())
    for entry, args in fake.calls:
        Ci, Co = args[10:12] if "conv" in entry else args[12:13] * 2  # t2_*_pair takes C once
        assert entry.startswith("t2_narrow_") == (not mrf.wide(Co, Ci)), (entry, Co)
        assert entry.endswith("_f32") == f32
    if name == "v3":  # ResBlock2: single convs carrying the residual, no pair
        assert {e for e, _ in fake.calls} == {"t2_mrf_conv" + sfx}


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, device="meta", dtype=dtype)


def _narrow_conv(K, Co, Ci, dtype, dil=1):
    w = torch.zeros(K, Co, Ci, dtype=dtype)
    return mrf.ConvWeights(w, torch.zeros(Co), dil, mrf.tile_conv(w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("entry,C", [("mrf_conv", 16), ("mrf_conv", 8), ("mrf_pair", 16),
                                     ("mrf_pair", 8), ("conv_transpose", 8)])
def test_wrappers_launch_the_narrow_entries(entry, C, dtype, monkeypatch):
    """At 8 or 16 output channels each wrapper launches the narrow kernel's
    entry of the weights' type with the wide entries' argument layout, and
    counts it as ``narrow_*`` (``_f32`` in ``F32_LAUNCHES``); never the plain
    version."""
    monkeypatch.setattr(build, "require", lambda *a, **k: None)
    fake = _stand_in(monkeypatch)
    for plain in ("mrf_conv_plain", "mrf_pair_plain", "conv_transpose_plain"):
        monkeypatch.setattr(mrf, plain, lambda *a, **k: pytest.fail("plain version"))
    f32 = dtype == torch.float32
    counts = mrf.F32_LAUNCHES if f32 else mrf.LAUNCHES
    before = dict(counts)
    a = _meta(2, 40, C, dtype=dtype)
    if entry == "mrf_conv":
        y, act, acc = mrf.mrf_conv(a, _narrow_conv(7, C, C, dtype, 3), res=_meta(2, 40, C),
                                   acc=_meta(2, 40, C), acc_scale=0.5, want_act=True)
        key, n_args = "narrow_conv", 17
    elif entry == "mrf_pair":
        y, act, acc = mrf.mrf_pair(a, _narrow_conv(11, C, C, dtype, 5),
                                   _narrow_conv(11, C, C, dtype), res=_meta(2, 40, C),
                                   want_act=True)
        key, n_args = "narrow_pair", 18
    else:
        w = torch.zeros(4, 2 * C, C, dtype=dtype)
        a = _meta(2, 40, 2 * C, dtype=dtype)
        y, act = mrf.conv_transpose(a, mrf.make_upsample(w, torch.zeros(C), 2, 1),
                                    want_act=True)
        key, n_args = "narrow_transpose", 17
    name, args = fake.calls[-1]
    assert len(fake.calls) == 1 and len(args) == n_args
    assert name == ("t2_narrow_pair" if entry == "mrf_pair" else "t2_narrow_conv") + (
        "_f32" if f32 else "")
    key += "_f32" if f32 else ""
    assert {k: v - before[k] for k, v in counts.items() if v != before[k]} == {key: 1}
    assert act.dtype == dtype and y.dtype == torch.float32
    assert y.shape == ((2, 80, C) if entry == "conv_transpose" else (2, 40, C))


def test_narrow_entries_match_the_source():
    """Every narrow entry ``bind(..., kind="narrow")`` declares exists in
    ``csrc/mrf_narrow.cu`` with as many parameters as its argtypes (a
    mismatch shows on the card only as a wrong call or an undefined
    symbol), and every ``t2_*`` entry there is bound."""
    src = SRC[SRC.index('extern "C"'):]
    arity = {m.group(1): len(m.group(2).split(","))
             for m in re.finditer(r"^int (t2_\w+)\(([^)]*)\)", src, re.M)}

    class Lib(types.SimpleNamespace):
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    lib = mrf.bind(mrf.bind(Lib(), "", "narrow"), "_f32", "narrow")
    assert {k: len(v.argtypes) for k, v in vars(lib).items()} == arity
    assert set(arity) == {"t2_narrow_conv", "t2_narrow_pair", "t2_narrow_conv_f32",
                          "t2_narrow_pair_f32"}
    assert "mrf_narrow" in build.SOURCES


def _const(name: str) -> int:
    """A constant of csrc/mrf_narrow.cu (digits and products)."""
    expr = re.search(rf"constexpr \w+ {name} = ([\d *]+);", SRC).group(1)
    return math.prod(int(x) for x in expr.split("*"))


def test_narrow_plan_fits_every_v2_conv():
    """``narrow_plan`` of csrc/mrf_narrow.cu in Python, from the source's
    constants: every narrow conv of a V2 vocode (and a ResBlock2 conv of
    V3's reach, k = 7, d = 12, at the narrow widths) runs on the small
    route and fits the shared memory in both types with its whole weight
    copy (both convs' for a pair), its slab and both epilogue tiles, two
    blocks an SM; a fused pair's intermediate (its first conv's 9 m16 tiles,
    128 + 2 kSmallLead rows) fits in the slab it replaces."""
    rows, lead, max_smem = _const("kSmallRows"), _const("kSmallLead"), _const("kMaxSmem")
    assert (rows, lead, max_smem) == (128, 8, 227 * 1024)
    gen = HiFiGAN(HiFiGANConfig.from_dict(CONFIGS["v2"]), F32)
    convs = [(c1, mrf.pair_fusable(c1, c2)) for rbs, _ in gen.kernel_weights() for rb in rbs
             for c1, c2 in rb]
    convs += [(ups.folded, False) for _, ups in gen.kernel_weights()]
    convs += [(_narrow_conv(7, C, C, torch.float32, 12), False) for C in (8, 16)]
    narrow = [(cw, pair) for cw, pair in convs if not mrf.wide(*cw.w.shape[1:])]
    assert len(narrow) == 18 + 1 + 2
    for cw, pair in narrow:
        K, Co, Ci = cw.w.shape
        assert mrf.narrow_small(Co, Ci)
        for dt in (torch.float32, torch.bfloat16):
            es = 4 if dt == torch.float32 else 2
            copy = K * math.prod(mrf.small_layout(Co, Ci, dt)) * es * (2 if pair else 1)
            slab = (rows + (2 * lead if pair else 0) + cw.dilation * (K - 1)) * (
                (Ci * es // 16) | 1) * 16
            smem = max(copy + slab, rows * _const("kSmallPitchO") * 4) + 2 * rows * Co * 4
            assert smem <= _const("kSoftSmem") <= max_smem, (K, Co, Ci, cw.dilation, dt)
        if pair:
            assert Co == Ci and (K - 1) // 2 <= lead
