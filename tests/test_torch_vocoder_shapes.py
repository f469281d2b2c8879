"""K2 at every HiFi-GAN shape the JAX package vocodes, on the CPU.

JAX's stage kernel (``tacotron2_tpu/ops/mrf_pallas.py``) takes any channel
count; the port's wide kernels take Co a multiple of 32 and Ci a multiple
of 8, and every other shape runs on the narrow kernel
(``csrc/mrf_narrow.cu``: at Co >= 8 an implicit GEMM on the tensor cores,
below 8 channels FFMA on the CUDA cores). Where JAX runs
XLA the port runs stock ops: an upsample that does not fold (u = 5, k = 11)
before the stage kernels, and a whole generator with an even resblock
kernel size (``get_padding``'s symmetric padding). Where that padding
changes a conv's length, JAX's generator fails, and the port's raises
ValueError at construction.

Here, without a card: small generators of each family against JAX's
``apply(mrf_pallas=True, fuse_ups=True, interpret=True)`` in both
precisions; ``mrf_stage`` against ``mrf_stage_pallas`` at the shapes that
had no kernel before (Co 24, Ci 4, a fold from 4 channels, C = 2 and 1, an
odd C); the narrow copy read back at the new shapes; the launches and
stock routes of the smoke's C2 generators through the wrappers on meta
tensors with a stand-in library against ``chip_smoke.vocode_launches`` /
``vocode_routes``; the narrow plan against the source (its routes, shared
memory, grid, and that only grid y follows the batch); the tensor-core
route emulated step by step; the upsamples JAX runs on XLA.
"""

import importlib.util
import math
import re
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
from tacotron2_tpu.ops.mrf_pallas import (mrf_stage_pallas, upsample_fusable,
                                          upsample_fusable_expand)
from tacotron2_tpu_torch.convert import hifigan_from_jax_params
from tacotron2_tpu_torch.models.hifigan import HiFiGAN, HiFiGANConfig
from tacotron2_tpu_torch.models.layers import F32, Policy
from tacotron2_tpu_torch.ops import build, mrf

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SRC = (ROOT / "tacotron2_tpu_torch" / "csrc" / "mrf_narrow.cu").read_text()


def _smoke():
    """``chip_smoke.py`` as a module: its C2 generators are the configs."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _smoke()

R1 = dict(resblock="1", resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1,), (3,)))
SMALL = dict(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4), num_mels=16)
# one small generator of each family (stage widths in the comments)
FAMILIES = {
    "co_off_32": dict(R1, **SMALL, upsample_initial_channel=96),  # 48, 24: Ci a multiple of 8
    "ci_off_8": dict(R1, **SMALL, upsample_initial_channel=24),  # 12, 6
    "odd_c": dict(R1, **SMALL, upsample_initial_channel=100),  # 50, 25
    "c4_2_1": dict(R1, **{**SMALL, "upsample_rates": (2, 2, 2), "upsample_kernel_sizes": (4, 4, 4)},
                   upsample_initial_channel=8),  # 4, 2, 1
    "mels_13": dict(R1, **{**SMALL, "num_mels": 13}, upsample_initial_channel=64),  # conv_pre 13
    "u5_no_fold": dict(R1, **{**SMALL, "upsample_rates": (5, 2), "upsample_kernel_sizes": (11, 4)},
                       upsample_initial_channel=64),  # JAX's XLA transposed conv at u = 5
    "even_k": dict(resblock="2", resblock_kernel_sizes=(4, 6),
                   resblock_dilation_sizes=((2, 4), (2, 4)), **SMALL,
                   upsample_initial_channel=64),  # JAX's XLA generator
}
# JAX's init scaled by these, the output peaks near 0.3 (real audio, tanh
# not saturated: 0.26-0.38)
WEIGHT_SCALE = {"co_off_32": 4.6, "ci_off_8": 7.0, "odd_c": 4.7, "c4_2_1": 16.6, "mels_13": 5.1,
                "u5_no_fold": 5.0, "even_k": 5.1}
STOCK = {"u5_no_fold": {"conv_transpose_stock": 1, "generator_stock": 0},
         "even_k": {"conv_transpose_stock": 0, "generator_stock": 1}}
FRAMES = 16
F32_GEN_LSB = 1  # tests/test_torch_vocoder_f32.py's: the sums' order only
# bf16 where JAX runs its Pallas stages: the mean PCM16 LSB from that route,
# from readings (0.00-0.45; max 0-32 against JAX's own XLA route's 32-90)
BF16_GEN_MEAN_LSB = 1.0
# bf16 where JAX runs XLA for the whole generator: both sum bf16 products
# in f32 and round each conv's sum alike (readings: 0 LSB)
BF16_STOCK_LSB = 1


def _pcm(wav):
    return np.clip(np.round(wav.astype(np.float64) * 32767), -32768, 32767)


def _jax_generator(name: str, precision: str):
    """JAX's generator of a family, its weights JAX's init times
    ``WEIGHT_SCALE``, and a mel: -> (module, params, mel)."""
    kw = FAMILIES[name]
    jm = JaxHiFiGAN(JaxHiFiGANConfig(**kw), JaxPolicy.from_string(precision))
    p = jax.tree.map(lambda a: a * WEIGHT_SCALE[name], jm.init(jax.random.PRNGKey(1)))
    mel = jnp.asarray(np.random.default_rng(2).standard_normal((2, FRAMES, kw["num_mels"]))
                      .astype(np.float32))
    return jm, p, mel


@pytest.mark.parametrize("precision", ["32-true", "bf16-mixed"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_generator_matches_jax(name, precision):
    """Each family's generator (JAX's weights through
    ``convert.hifigan_from_jax_params``) against JAX's ``apply`` with the
    fused Pallas stages in interpret mode, on 2 rows of 16 mel frames, with
    the stock routes counted where JAX runs XLA. F32 (the commands'
    vocoder): within ``F32_GEN_LSB``. bf16: no further from JAX's Pallas
    route in the worst sample than JAX's own XLA route is, and within
    ``BF16_GEN_MEAN_LSB`` on average; where JAX runs its XLA generator (even
    k), within ``BF16_STOCK_LSB``."""
    jm, p, mel = _jax_generator(name, precision)
    ref = np.asarray(jm.apply(p, mel, mrf_pallas=True, fuse_ups=True, interpret=True))
    mel = np.array(mel)
    kw = FAMILIES[name]
    pol = F32 if precision == "32-true" else Policy(torch.bfloat16)
    tm = HiFiGAN(HiFiGANConfig(**kw), pol)
    tm.load_state_dict(hifigan_from_jax_params(p))
    before = dict(mrf.STOCK_ROUTES)
    got = tm.apply(torch.as_tensor(mel)).numpy()
    grown = {k: v - before[k] for k, v in mrf.STOCK_ROUTES.items()}
    assert grown == STOCK.get(name, dict.fromkeys(mrf.STOCK_ROUTES, 0))
    assert got.shape == ref.shape == (2, FRAMES * math.prod(kw["upsample_rates"]))
    assert 0.1 < np.abs(ref).max() < 0.9
    lsb = np.abs(_pcm(got) - _pcm(ref))
    if precision == "32-true":
        assert lsb.max() <= F32_GEN_LSB, lsb.max()
    elif name == "even_k":
        assert lsb.max() <= BF16_STOCK_LSB, lsb.max()
    else:  # JAX's own XLA route, only where it is the bound
        xla = np.asarray(jm.apply(p, jnp.asarray(mel), mrf_pallas=False, fuse_ups=False))
        spread = np.abs(_pcm(xla) - _pcm(ref))
        assert lsb.mean() <= BF16_GEN_MEAN_LSB and lsb.max() <= spread.max(), (
            lsb.max(), lsb.mean(), spread.max())


@pytest.mark.parametrize("kernels,dilations", [
    ((4,), ((2, 4),)),         # ResBlock1: its second conv (k = 4, d = 1) loses a sample
    ((3, 4), ((1, 3), (1, 2))),
])
@pytest.mark.parametrize("resblock", ["1", "2"])
def test_even_kernels_that_jax_refuses_raise(resblock, kernels, dilations):
    """Where ``get_padding``'s symmetric padding changes a conv's length (d (k
    - 1) odd: every ResBlock1 of an even k, an odd dilation of an even k), the
    residual add does not fit: JAX's generator fails inside its ``apply``,
    the port's raises ValueError naming the conv at construction. ResBlock2
    with k = 4 and dilations 2, 4 keeps every length and runs (above)."""
    kw = dict(resblock=resblock, resblock_kernel_sizes=kernels,
              resblock_dilation_sizes=dilations, **SMALL, upsample_initial_channel=16)
    jm = JaxHiFiGAN(JaxHiFiGANConfig(**kw))
    p = jm.init(jax.random.PRNGKey(1))
    mel = jnp.zeros((1, 4, 16))
    if resblock == "2" and kernels == (4,):
        jm.apply(p, mel, mrf_pallas=True, interpret=True)  # every length kept: runs
        HiFiGAN(HiFiGANConfig(**kw))
        return
    with pytest.raises(Exception):
        jm.apply(p, mel, mrf_pallas=True, interpret=True)
    with pytest.raises(ValueError, match="residual add does not fit"):
        HiFiGAN(HiFiGANConfig(**kw))


BF16_STAGE_TOL = 4e-3  # tests/test_torch_hifigan.py's, of the output's scale
RB = {"1": ((3, 11), ((1, 5), (1, 3))), "2": ((3, 7), ((1, 2), (3, 12)))}


def _jax_conv(rng, k, cin, cout, scale=0.15):
    return {"w": jnp.asarray(rng.standard_normal((k, cin, cout)).astype(np.float32) * scale),
            "b": jnp.asarray(rng.standard_normal(cout).astype(np.float32) * 0.1)}


def _to_torch_conv(p, d, dtype):
    w = torch.as_tensor(np.asarray(p["w"]).transpose(0, 2, 1).copy()).to(dtype)
    return mrf.ConvWeights(w, torch.as_tensor(np.array(p["b"])), d, mrf.tile_conv(w))


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


# (rb, u or None, Cin, C, length): the shapes no kernel took before, in ids
STAGES = {
    "co24": ("1", None, 24, 24, 90),          # Co 24: neither 32k nor 8 / 16
    "ci4": ("1", 2, 8, 4, 61),                # C = 4 convs (Ci 4), the aligned u = 2 fold 8 -> 4
    "transpose_ci4": ("2", 2, 4, 8, 37),      # a fold from 4 channels (JAX: XLA's convT)
    "c2": ("1", 2, 4, 2, 45),                 # C = 2 after the aligned fold 4 -> 2
    "c1": ("2", 2, 2, 1, 53),                 # C = 1, the fold 2 -> 1
    "odd25": ("1", 2, 50, 25, 41),            # an odd C after a fold from 50 (JAX: XLA's convT)
    "co200": ("2", None, 200, 200, 33),       # 13 groups of 16, the last of 8
    "u5": ("1", 5, 64, 32, 19),               # no fold: stock convT, then the stage
}


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", list(STAGES))
def test_mrf_stage_matches_pallas(case, bf16):
    """``mrf.mrf_stage`` (plain versions on the CPU; on the card the narrow
    kernel at these shapes) against ``mrf_stage_pallas`` in interpret mode
    on the same weights, with tests/test_torch_hifigan.py's tolerances: f32
    1e-5 of the output's scale, bf16 ``BF16_STAGE_TOL``. Where JAX fuses the
    upsample (``upsample_fusable``) it takes it in front; else XLA's
    transposed conv under the precision's policy runs before the stage
    kernel, as JAX's ``apply`` does, and the port's upsample rounds its bf16
    sum before the bias alike (``round_sum``) or, at u = 5, runs on stock
    ops."""
    rb_type, u, cin, C, length = STAGES[case]
    rng = np.random.default_rng(C * 7 + cin + (u or 0))
    kernels, dils = RB[rb_type]
    dtype = torch.bfloat16 if bf16 else torch.float32
    jrbs, trbs = _stage_params(rng, rb_type, C, dtype)
    x = rng.standard_normal((2, length, cin)).astype(np.float32)
    kw = dict(resblock=rb_type, kernels=kernels, dilations=dils, bf16=bf16, interpret=True)
    ups_t, xj = None, jnp.asarray(x)
    if u is not None:
        k = 11 if u == 5 else 2 * u
        ups = _jax_conv(rng, k, cin, C, scale=0.2)
        ups_t = mrf.make_upsample(torch.as_tensor(np.array(ups["w"])).to(dtype),
                                  torch.as_tensor(np.array(ups["b"])), u, (k - u) // 2)
        fused = upsample_fusable(u, cin, C, k) or upsample_fusable_expand(u, cin, C, k)
        assert (ups_t.folded is None) == (u == 5)
        assert ups_t.round_sum == (bf16 and not fused)
        if fused:
            kw["upsample"] = (ups, u)
        else:
            pol = JaxPolicy.from_string("bf16-mixed" if bf16 else "32-true")
            xj = conv_transpose1d_apply(ups, jax.nn.leaky_relu(xj, 0.1), stride=u,
                                        padding=(k - u) // 2, policy=pol)
    ref = np.asarray(mrf_stage_pallas(jrbs, xj, **kw))
    got = mrf.mrf_stage(torch.as_tensor(x), trbs, ups_t).numpy()
    assert got.shape == ref.shape
    scale = float(np.abs(ref).max())
    tol = BF16_STAGE_TOL * scale if bf16 else 1e-5 * max(scale, 1e-3)
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


# (K, Co, Ci): a resblock conv at 24, 25, 200, 4, 2 and 1 channels, conv_pre
# from 13 and 100 mels, a fold from 4 channels, a folded upsample 100 -> 2 x 50
NEW_SHAPES = [(3, 24, 24), (11, 25, 25), (7, 200, 200), (11, 4, 4), (3, 2, 2), (7, 1, 1),
              (7, 64, 13), (7, 400, 100), (3, 16, 4), (3, 100, 100), (5, 48, 96)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,Co,Ci", NEW_SHAPES)
def test_narrow_copy_reads_back(K, Co, Ci, dtype):
    """At a shape the wide kernels do not take, ``pack_conv`` makes the copy
    of the narrow kernel's route in the weights' type: at Co >= 8 the
    tensor-core route's (K, planes, Co8, Ci_pad) (``mma_pads``: n8 tiles, the
    k tile 16 / 8; f32 its hi and lo planes, hi + lo the weights), zero past
    Co and Ci; below 8 channels the CUDA cores' (Ci, K, Co). Every weight
    read at ``tile_offset`` is the tap-major weight, exactly, and
    ``_require_conv`` takes the copy and refuses the other route's."""
    rng = np.random.default_rng(K * 1000 + Co + Ci)
    conv = torch.nn.Conv1d(Ci, Co, K, padding=K // 2)
    with torch.no_grad():
        conv.weight.copy_(torch.as_tensor(rng.standard_normal((Co, Ci, K)).astype(np.float32)))
    cw = mrf.pack_conv(conv, dtype)
    assert not mrf.wide(Co, Ci) and mrf.narrow_mma(Co, Ci) == (Co >= 8)
    assert _plan(Co, Ci, K, 1, es=cw.w.element_size())["route"] == ("mma" if Co >= 8 else "ffma")
    assert cw.wt.dtype == dtype and torch.equal(mrf.read_tiled(cw.wt, K, Co, Ci), cw.w)
    ffma = (Ci, K, Co)
    if Co >= 8:
        co8, cp = mrf.mma_pads(Co, Ci, dtype)
        assert (co8, cp) == (-(-Co // 8) * 8, -(-Ci // (8 if dtype == torch.float32 else 16))
                             * (8 if dtype == torch.float32 else 16))
        planes = 2 if dtype == torch.float32 else 1
        assert cw.wt.shape == (K, planes, co8, cp)
        assert not cw.wt[:, :, Co:].any() and not cw.wt[:, :, :, Ci:].any()  # the pads
        if planes == 2:
            hi, lo = mrf.tf32_split(cw.w)
            assert torch.equal(mrf.read_tiled(cw.wt, K, Co, Ci, 0), hi)
            assert torch.equal(mrf.read_tiled(cw.wt, K, Co, Ci, 1), lo)
            assert torch.equal(hi + lo, cw.w)
        assert mrf.tile_offset(K - 1, Co - 1, Ci - 1, K, Co, Ci, dtype, planes - 1) == (
            ((K - 1) * planes + planes - 1) * co8 + Co - 1) * cp + Ci - 1
        other = cw._replace(wt=torch.zeros(ffma, dtype=dtype))
    else:
        assert cw.wt.shape == ffma
        assert mrf.tile_offset(K - 1, Co - 1, Ci - 1, K, Co, Ci, dtype) == Ci * K * Co - 1
        other = cw._replace(wt=torch.zeros(K, 1, 8, -(-Ci // 8) * 8, dtype=dtype))
    require = build.require
    try:  # the device rule aside: the copy's shape and type
        build.require = lambda t, dt, shape, name: (
            None if t.dtype == dt and tuple(t.shape) == tuple(shape) else
            (_ for _ in ()).throw(ValueError(f"{name}: {tuple(t.shape)}, want {tuple(shape)}")))
        mrf._require_conv(cw, Ci, "conv")
        with pytest.raises(ValueError):
            mrf._require_conv(other, Ci, "conv")
    finally:
        build.require = require


@pytest.mark.parametrize("u,Cin,C,k", [(8, 512, 256, 16), (8, 256, 128, 16), (2, 128, 64, 4),
                                       (2, 64, 32, 4), (8, 128, 64, 16), (4, 64, 32, 8),
                                       (8, 256, 128, 16), (4, 128, 64, 8), (2, 16, 8, 4),
                                       (2, 2, 1, 4), (8, 400, 200, 16), (2, 100, 50, 4),
                                       (2, 50, 25, 4), (5, 256, 128, 11), (2, 4, 8, 4),
                                       (2, 8, 4, 8), (4, 8, 4, 8)])
def test_upsamples_jax_runs_on_xla(u, Cin, C, k):
    """``mrf.jax_fuses_upsample`` is JAX's ``upsample_fusable or
    upsample_fusable_expand`` (UNIVERSAL_V1's four, V2's and V3's stages 2
    and 3, the smoke's C2 generators, others); a bf16 upsample off it rounds
    its sum before the bias, an f32 one never (the identity)."""
    want = upsample_fusable(u, Cin, C, k) or upsample_fusable_expand(u, Cin, C, k)
    assert mrf.jax_fuses_upsample(u, Cin, C, k) == want
    w = torch.zeros(k, Cin, C)
    assert mrf.make_upsample(w.bfloat16(), torch.zeros(C), u, (k - u) // 2).round_sum == (not want)
    assert not mrf.make_upsample(w, torch.zeros(C), u, (k - u) // 2).round_sum


class _FakeLib:
    """Stands for every built library: records what the wrappers pass."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith(("t2_mrf_", "t2_narrow_")):
            raise AttributeError(name)
        return lambda *args: (self.calls.append((name, args)), 0)[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["c2_wide", "c2_deep", "c2_u5", "c2_even"])
def test_vocode_launches_match_the_plan(name, dtype, monkeypatch):
    """A vocode of each of the smoke's C2 generators through the wrappers
    (meta tensors, a stand-in for the libraries) grows the counters by
    exactly ``chip_smoke.vocode_launches`` and the stock routes by
    ``vocode_routes``, no counter of the other mode, and makes as many C
    calls, each the entry of its shape's route and the weights' type (the
    narrow one where ``mrf.wide`` is false), with its channels; mode bit 8
    (the sum rounded before the bias) on ``conv_pre`` and, in bf16, on the
    upsamples JAX runs on XLA."""
    monkeypatch.setattr(build, "require", lambda *a, **k: None)
    fake = _FakeLib()
    for lib in ("_lib", "_lib_f32", "_lib_narrow"):
        monkeypatch.setattr(mrf, lib, lambda: fake)
    monkeypatch.setattr(mrf, "_stream", lambda: 0)
    h = SMOKE.C2_GENERATORS[name]
    gen = HiFiGAN(HiFiGANConfig.from_dict(h), Policy(dtype)).to("meta").eval()
    before = {**mrf.LAUNCHES, **mrf.F32_LAUNCHES, **mrf.STOCK_ROUTES}
    wav = gen.apply(torch.empty(1, 16, h["num_mels"], device="meta"))
    assert wav.shape == (1, 16 * math.prod(h["upsample_rates"]))
    grown = {k: v - before[k] for k, v in {**mrf.LAUNCHES, **mrf.F32_LAUNCHES}.items()}
    f32 = dtype == torch.float32
    want = SMOKE.vocode_launches(h, dtype)
    assert {k: v for k, v in grown.items() if k in want} == want
    assert not any(v for k, v in grown.items() if k not in want)
    assert {k: v - before[k] for k, v in mrf.STOCK_ROUTES.items()} == SMOKE.vocode_routes(h)
    assert len(fake.calls) == sum(want.values())
    for entry, args in fake.calls:
        Ci, Co = args[10:12] if "conv" in entry else args[12:13] * 2
        assert entry.startswith("t2_narrow_") == (not mrf.wide(Co, Ci)), (entry, Ci, Co)
        assert entry.endswith("_f32") == f32
    if name == "c2_wide":  # conv_pre 100 -> 400, every resblock conv and stages 3-4's folds
        assert fake.calls[0][0].startswith("t2_narrow_conv")
        assert fake.calls[0][1][8:15] == (1, 16, 100, 400, 7, 1, 8)
        assert not any(e.startswith("t2_narrow_pair") for e, _ in fake.calls)
    rounded = [args[14] & 8 for e, args in fake.calls if "conv" in e]
    if gen.odd:
        ups = [u for _, u in gen.kernel_weights() if u.folded is not None]
        assert sum(rounded) == 8 * (1 + sum(u.round_sum for u in ups))
        assert not (f32 and any(u.round_sum for u in ups))


def test_c2_generators_reach_the_shapes_they_name():
    """The smoke's C2 generators reach what their comments say: c2_wide
    Co off 32 with Ci a multiple of 8 (200 from 400's fold's 8 x 200 = 1600,
    wide), Ci off 8 (100, 50, 25), an odd C and conv_pre from 100 mels;
    c2_deep C = 4, 2 and 1; c2_u5 a u = 5 upsample with no fold; c2_even an
    even resblock kernel size."""
    shapes = {}
    for name, h in SMOKE.C2_GENERATORS.items():
        gen = HiFiGAN(HiFiGANConfig.from_dict(h), F32)
        convs = [gen.conv_pre_weights()] if gen.odd else []
        for rbs, ups in (gen.kernel_weights() if gen.odd else []):
            convs += [ups.folded] if ups.folded is not None else []
            convs += [c for rb in rbs for pair in rb for c in pair if c is not None]
        shapes[name] = {tuple(c.w.shape[1:]) for c in convs}
    assert shapes["c2_wide"] == {(400, 100), (1600, 400), (200, 200), (800, 200), (100, 100),
                                 (50, 50), (25, 25)}
    assert {(8, 8), (4, 4), (2, 2), (1, 1)} <= shapes["c2_deep"]
    assert not shapes["c2_even"]
    assert any(ups.folded is None for _, ups in HiFiGAN(
        HiFiGANConfig.from_dict(SMOKE.C2_GENERATORS["c2_u5"])).kernel_weights())


def _const(name: str) -> int:
    """A constant of csrc/mrf_narrow.cu (digits and products)."""
    expr = re.search(rf"constexpr \w+ {name} = ([\d *]+);", SRC).group(1)
    return math.prod(int(x) for x in expr.split("*"))


THREADS, MAX_SMEM = _const("kThreads"), _const("kMaxSmem")
FFMA_ROWS, MMA_ROWS, MMA_TILES = _const("kFfmaRows"), _const("kMmaRows"), _const("kMmaTiles")
MMA_THREADS = _const("kMmaThreads")
RING, FILL_BLOCKS = _const("kRing"), _const("kFillBlocks")
SOFT_SMEM, STEP_TILES = _const("kSoftSmem"), _const("kStepTiles")
SMALL_THREADS, SMALL_ROWS = _const("kSmallThreads"), _const("kSmallRows")
SMALL_LEAD, SMALL_PITCH_O = _const("kSmallLead"), _const("kSmallPitchO")


def _plan(Co: int, Ci: int, K: int, dilation: int, pair: bool = False, B: int = 1,
          T: int = 1024, es: int = 4, max_smem: int = MAX_SMEM) -> dict:
    """``csrc/mrf_narrow.cu::narrow_plan`` in Python, from the source's
    constants, for operands of ``es`` bytes: the route ("small":
    ``narrow_small_kernel`` at Ci and Co in ``PAIR_C``, the pair's only one;
    "ffma": ``narrow_group_kernel`` below 8 output channels; "mma":
    ``narrow_mma_kernel``), the small route's slab rows, pitch, copy size and
    offsets, the CUDA cores' group, slice and rows, or the tensor-core
    route's pads, chunks, steps, pitches and ring; the shared memory in
    bytes (the small route's with both epilogue tiles) and the grid;
    ValueError where the kernel refuses the shape. ``max_smem`` stands in
    for the card's 227 KB (a smaller one forces the operand into chunks)."""
    small = mrf.narrow_small(Co, Ci)
    route = "small" if small else "ffma" if Co < 8 else "mma"
    if pair and (Ci != Co or not small or K > 2 * SMALL_LEAD + 1) or K % 2 == 0:
        raise ValueError(f"the narrow kernel does not take K={K}, Ci={Ci}, Co={Co}, pair={pair}")
    halo = dilation * (K - 1)
    if route == "small":
        rows = (SMALL_ROWS + 2 * SMALL_LEAD if pair else SMALL_ROWS) + halo
        pitch = (Ci * es // 16) | 1
        w_units = K * math.prod(mrf.small_layout(Co, Ci, torch.float32 if es == 4 else
                                                 torch.bfloat16)) * es // 16
        slab_off = (2 if pair else 1) * w_units * 16
        pre_off = max(slab_off + rows * pitch * 16, SMALL_ROWS * SMALL_PITCH_O * 4)
        smem = pre_off + 2 * SMALL_ROWS * Co * 4
        if smem > max_smem:
            raise ValueError(f"the small route's slab does not fit: K={K}, dilation={dilation}")
        return {"route": route, "rows": rows, "pitch": pitch, "w_units": w_units,
                "slab_off": slab_off, "pre_off": pre_off, "smem": smem,
                "grid": (-(-T // SMALL_ROWS), B, 1)}
    if route == "ffma":
        group, bt = 1 << (Co - 1).bit_length(), THREADS * FFMA_ROWS
        rows_p = (bt + halo) | 1
        kc = 16 if Ci % 16 == 0 else 8 if Ci % 8 == 0 else min(16, Ci)
        smem = lambda kc: 4 * (kc * K * group + kc * rows_p)
        while kc > 1 and smem(kc) > max_smem:
            kc = (kc + 1) // 2
        if smem(kc) > max_smem:
            raise ValueError(f"the narrow kernel's rows do not fit: K={K}, dilation={dilation}")
        return {"route": route, "group": group, "kc": kc, "rows_p": rows_p, "smem": smem(kc),
                "grid": (-(-T // bt), B, 1)}
    kt, epu, planes = (8, 4, 2) if es == 4 else (16, 8, 1)
    max_tiles = MMA_TILES
    ci_pad, co_pad = -(-Ci // kt) * kt, -(-Co // 8) * 8
    tiles, mblocks = co_pad // 8, -(-T // MMA_ROWS)
    fill = FILL_BLOCKS // 2 if es == 4 else FILL_BLOCKS
    nch0 = max(-(-tiles // max_tiles), min(tiles, -(-fill // mblocks)))
    ct0, ct = -(-tiles // nch0), 1
    while (ct < ct0) if es == 4 else (2 * ct <= ct0):
        ct *= 2
    rows = MMA_ROWS + halo
    slab = lambda ck: rows * ((ck // epu) | 1) * 16
    ring = lambda nrows, ckw: RING * planes * (ckw // epu) * nrows * 16
    halve = lambda ch: (ch // 2 + kt - 1) // kt * kt
    ck = ci_pad
    while ck > kt and slab(ck) + ring(max_tiles * 8, kt) > min(SOFT_SMEM, max_smem):
        ck = halve(ck)
    while ck > kt and slab(ck) + ring(max_tiles * 8, kt) > max_smem:
        ck = halve(ck)
    if slab(ck) + ring(max_tiles * 8, kt) > max_smem:
        raise ValueError(f"the narrow kernel's slab does not fit: K={K}, dilation={dilation}")
    ckw = min(ck, (STEP_TILES // 2 if es == 4 else STEP_TILES) * kt)
    while ckw > (32 if es == 4 else 64) and slab(ck) + ring(ct * 8, ckw) > min(SOFT_SMEM,
                                                                                  max_smem):
        ckw = halve(ckw)
    while ckw > kt and slab(ck) + ring(ct * 8, ckw) > max_smem:
        ckw = halve(ckw)
    pitch_o = -(-ct * 8 // 32) * 32 + 8
    plane = (ckw // epu) * ct * 8 * 16
    smem = max(slab(ck) + RING * planes * plane, MMA_ROWS * pitch_o * 4)
    pre = 2 * MMA_ROWS * ct * 8 * 4  # the prefetched res and acc_in tiles
    pre_off = smem if smem + pre <= SOFT_SMEM else 0
    return {"route": route, "ci_pad": ci_pad, "co_pad": co_pad, "ck": ck, "ckw": ckw,
            "ct": ct, "pitch_a": (ck // epu) | 1, "pitch_o": pitch_o, "ring_off": slab(ck),
            "plane_bytes": plane, "pre_off": pre_off, "smem": smem + (pre if pre_off else 0),
            "grid": (mblocks, B, -(-tiles // ct))}


def _c2_convs():
    """Every conv of the smoke's C2 generators that the narrow kernel runs,
    with the frames of its stage at C2_FRAMES mel frames: [(cw, pair, T)]."""
    out = []
    for name, h in SMOKE.C2_GENERATORS.items():
        gen = HiFiGAN(HiFiGANConfig.from_dict(h), F32)
        if not gen.odd:
            continue
        T = SMOKE.C2_FRAMES
        convs = [(gen.conv_pre_weights(), False, T)]
        for rbs, ups in gen.kernel_weights():
            convs += [(ups.folded, False, T)] if ups.folded is not None else []
            T *= ups.stride
            convs += [(c, mrf.pair_fusable(c1, c2) and c is c1, T) for rb in rbs
                      for c1, c2 in rb for c in (c1, c2) if c is not None]
        out += [(cw, pair, T) for cw, pair, T in convs if not mrf.wide(*cw.w.shape[1:])]
    return out


def test_narrow_plan_mirrors_the_source():
    """``narrow_plan`` of the source in Python (``_plan``, from its
    constants): Ci and Co in ``PAIR_C`` a ``narrow_small_kernel`` instance
    of each (Ci, Co) (and the pair, only at Ci = Co), Co < 8 a
    ``narrow_group_kernel`` of each group width on the CUDA cores, every
    other shape (Co 8 or 16 from other Ci too) a ``narrow_mma_kernel`` of a
    wgmma N of 8 to 64 (``mrf.narrow_mma``: both tensor-core routes), and
    every narrow conv of the smoke's C2 generators fits the shared memory in
    both types at 1 and 16 rows."""
    assert (THREADS, MAX_SMEM, FFMA_ROWS) == (128, 227 * 1024, 1)
    assert (MMA_ROWS, MMA_TILES, RING, FILL_BLOCKS) == (128, 8, 3, 132)
    assert (SOFT_SMEM, STEP_TILES, MMA_THREADS) == (113 * 1024, 8, 256)
    assert (SMALL_THREADS, SMALL_ROWS, SMALL_LEAD, SMALL_PITCH_O) == (256, 128, 8, 24)
    small = set(re.findall(r"T2_SMALL\((\d+), (\d+), (true|false)\)", SRC))
    assert small == {("16", "16", "false"), ("8", "8", "false"), ("8", "16", "false"),
                     ("16", "8", "false"), ("16", "16", "true"), ("8", "8", "true")}
    assert set(re.findall(r"T2_GROUP\((\d+)\)", SRC)) == {"8", "4", "2", "1"}
    assert set(re.findall(r"T2_MMA\((\d+)\)", SRC)) == {"8", "4", "2", "1"}
    routes = set()
    for cw, pair, T in _c2_convs():
        K, Co, Ci = cw.w.shape
        for es in (4, 2):
            for B in SMOKE.C2_ROWS:
                plan = _plan(Co, Ci, K, cw.dilation, pair, B, T, es)
                assert plan["smem"] <= MAX_SMEM
                assert (plan["route"] != "ffma") == mrf.narrow_mma(Co, Ci) == (Co >= 8)
                assert (plan["route"] == "small") == mrf.narrow_small(Co, Ci)
                routes.add(plan["route"])
                if plan["route"] == "mma":  # the prefetch only where two blocks an SM fit
                    assert not plan["pre_off"] or plan["smem"] <= SOFT_SMEM
                    assert plan["ct"] in (1, 2, 4, 8)
    assert routes == {"small", "ffma", "mma"}
    big = _plan(1, 64, 11, 5)
    assert big["group"] == 1 and big["route"] == "ffma" and big["smem"] <= MAX_SMEM
    assert _plan(16, 16, 7, 1)["route"] == "small" and _plan(8, 16, 3, 1)["route"] == "small"
    assert _plan(16, 80, 7, 1)["route"] == "mma" and _plan(16, 100, 7, 1)["route"] == "mma"
    assert _plan(8, 4, 3, 1)["route"] == "mma" and _plan(7, 64, 3, 1)["group"] == 8
    assert _plan(16, 16, 17, 1, pair=True)["route"] == "small"
    for shape in ((24, 24, 3), (16, 4, 3), (16, 8, 3), (16, 80, 3), (16, 16, 19)):
        with pytest.raises(ValueError):  # no pair off PAIR_C, past K = 2 kSmallLead + 1
            _plan(*shape, 1, pair=True)


def test_narrow_plan_fills_the_card_at_one_row():
    """At one row of a 128-frame bucket: ``c2_wide``'s stages 2-4 (T =
    8,192 to 32,768) launch at least ``kFillBlocks`` blocks on the tensor
    cores in bf16, half that in f32 (whose restaged operand and narrow
    wgmmas cost more at 16 rows); stage 1 (T = 1,024, 8 blocks of 128
    samples) splits N, into 13 chunks of 2 n8 tiles in bf16 (104 blocks) and
    7 of 4 in f32 (56); ``c2_deep``'s convs below 8 channels (C = 4, 2, 1
    and the folds to 4 and 2) at least 32 blocks of 128 samples on the CUDA
    cores (the parent's 4)."""
    seen = set()
    for cw, pair, T in _c2_convs():
        K, Co, Ci = cw.w.shape
        for es in (4, 2):
            plan = _plan(Co, Ci, K, cw.dilation, pair, 1, T, es)
            blocks = math.prod(plan["grid"])
            if plan["route"] == "mma" and T >= 8192:
                assert blocks >= FILL_BLOCKS // (2 if es == 4 else 1), (Co, Ci, T, plan["grid"])
                seen.add(Co)
            if plan["route"] == "mma" and T == 1024:
                assert plan["grid"] == ((8, 1, 7) if es == 4 else (8, 1, 13)), plan
                seen.add(Co)
            if plan["route"] == "ffma":
                assert blocks >= 32, (Co, Ci, T, plan["grid"])
                seen.add(Co)
    assert {200, 100, 50, 25, 4, 2, 1} <= seen


def test_narrow_plan_does_not_follow_the_batch():
    """Nothing in the plan but grid y (the batch rows) depends on B: each
    output's sum runs over the same (chunk, tap, k tile) or (channel, tap)
    order at every batch, so rows of a batch equal the rows alone."""
    routes = set()
    for cw, pair, T in _c2_convs() + _v2_convs():
        K, Co, Ci = cw.w.shape
        for es in (4, 2):
            one = _plan(Co, Ci, K, cw.dilation, pair, 1, T, es)
            routes.add((one["route"], pair))
            for B in (2, 16, 64):
                many = _plan(Co, Ci, K, cw.dilation, pair, B, T, es)
                assert many["grid"][1] == B
                assert {k: v for k, v in many.items() if k != "grid"} == {
                    k: v for k, v in one.items() if k != "grid"}
                assert many["grid"][::2] == one["grid"][::2]
    assert routes == {("small", True), ("small", False), ("mma", False), ("ffma", False)}


V2_FRAMES = 384  # the say's vocode bucket of V2 (phase 4l)


def _v2_convs():
    """Every conv of HiFi-GAN V2 that the narrow kernel runs, with the frames
    of its stage at V2_FRAMES mel frames: [(cw, pair, T)] (each pair once,
    as its first conv)."""
    gen = HiFiGAN(HiFiGANConfig.from_dict(SMOKE.HIFIGAN_V2), F32)
    out, T = [], V2_FRAMES
    for rbs, ups in gen.kernel_weights():
        out.append((ups.folded, False, T))
        T *= ups.stride
        out += [(c1, mrf.pair_fusable(c1, c2), T) for rb in rbs for c1, c2 in rb]
    return [(cw, pair, T) for cw, pair, T in out if not mrf.wide(*cw.w.shape[1:])]


def test_small_plan_fills_the_card_at_one_row():
    """At one row the small route's blocks of 128 outputs fill the card:
    V2's stages 3-4 at the say's 384-frame bucket (T = 49,152 and 98,304;
    its 18 pairs and its last upsample's fold 16 -> 2 x 8) launch at least
    ``kFillBlocks`` blocks, ``c2_deep``'s C = 16 / 8 pairs and folds at a
    128-frame bucket at least 16."""
    v2 = _v2_convs()
    assert len(v2) == 19 and sum(pair for _, pair, _ in v2) == 18
    for cw, pair, T in v2:
        K, Co, Ci = cw.w.shape
        for es in (4, 2):
            plan = _plan(Co, Ci, K, cw.dilation, pair, 1, T, es)
            assert plan["route"] == "small" and math.prod(plan["grid"]) >= FILL_BLOCKS, plan
    deep = [(cw, pair, T) for cw, pair, T in _c2_convs() if mrf.narrow_small(*cw.w.shape[1:])]
    assert {cw.w.shape[1] for cw, _, _ in deep} == {16, 8} and any(p for _, p, _ in deep)
    for cw, pair, T in deep:
        K, Co, Ci = cw.w.shape
        for es in (4, 2):
            assert math.prod(_plan(Co, Ci, K, cw.dilation, pair, 1, T, es)["grid"]) >= 16


def test_small_plan_fits_every_v2_and_c2_shape():
    """The small route's shared memory (both epilogue tiles) is at most 227
    KB at every V2 and C2 shape it takes, in both types, and two blocks fit
    an SM (113 KB); the pair's slab holds the first conv's 9 m16 tiles and
    the dilated halo, and its second conv reads only rows it wrote."""
    for cw, pair, T in _c2_convs() + _v2_convs():
        K, Co, Ci = cw.w.shape
        if not mrf.narrow_small(Co, Ci):
            continue
        for es in (4, 2):
            plan = _plan(Co, Ci, K, cw.dilation, pair, 1, T, es)
            assert plan["smem"] <= SOFT_SMEM <= MAX_SMEM, plan
            tiles = SMALL_ROWS // 16 + (1 if pair else 0)
            assert plan["rows"] == 16 * tiles + cw.dilation * (K - 1)
            if pair:  # the second conv reads rows lead - (K - 1) / 2 .. lead + 127 + (K - 1) / 2
                assert 0 <= SMALL_LEAD - (K - 1) // 2
                assert SMALL_LEAD + SMALL_ROWS - 1 + (K - 1) // 2 < 16 * tiles


# ---------------------------------------------------------------------------
# narrow_mma_kernel emulated on the CPU: its staging, cp.async ring,
# ldmatrix lane addresses, wgmma's register fragments and descriptors, and
# the epilogue, step by step as csrc/mrf_narrow.cu runs them, on shared
# memory that starts as NaN
# ---------------------------------------------------------------------------

LANE = np.arange(32)


def _ldsm(smem32, addrs, n):
    """ldmatrix .x``n`` (b16): matrix i's row r from lane 8 i + r's address;
    lane l receives 32-bit word l % 4 of row l // 4 of each -> (32, n)."""
    assert not (addrs % 16).any()
    return np.stack([smem32[addrs[8 * i + LANE // 4] // 4 + LANE % 4] for i in range(n)], 1)


def _bf16_pair(words):
    """The two bf16 halves of 32-bit registers (low half first), as f64."""
    lo = (words & 0xFFFF).astype(np.uint32) << 16
    hi = words & 0xFFFF0000
    return lo.view(np.float32).astype(np.float64), hi.view(np.float32).astype(np.float64)


def _tf32(words):
    """tf32 registers as the tensor core reads them: the low 13 bits dropped."""
    return (words & np.uint32(0xFFFFE000)).view(np.float32).astype(np.float64)


def _wgmma(d, a, smem, start, N, f32):
    """wgmma m64nNk8 tf32 / m64nNk16 bf16 with A from registers, one warp's
    16 rows: d (32, N / 2) += A B, A from the warp's registers (32, 4) in the
    mma.sync A layout, B (k x N) read through a K-major no-swizzle
    descriptor at ``start`` (core matrices of 8 rows x 16 bytes, N 16 bytes
    apart along K, 128 along N); d per n8 tile the m16n8 layout."""
    g, t = LANE // 4, LANE % 4
    es, kt = (4, 8) if f32 else (2, 16)
    k, n = np.meshgrid(np.arange(kt), np.arange(N), indexing="ij")
    off = start + ((k // (16 // es)) * N + n) * 16 + (k % (16 // es)) * es
    raw = smem[off[..., None] + np.arange(es)].copy().view(np.uint32 if f32 else np.uint16)[..., 0]
    if f32:
        A, B = np.zeros((16, 8)), _tf32(raw)
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = _tf32(a).T
    else:
        A = np.zeros((16, 16))
        for r, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
            A[g + dr, 2 * t + dc], A[g + dr, 2 * t + dc + 1] = _bf16_pair(a[:, r])
        B = (raw.astype(np.uint32) << 16).view(np.float32).astype(np.float64)
    D = A @ B
    for i in range(N // 8):
        d[:, 4 * i:4 * i + 4] += np.stack([D[g, 8 * i + 2 * t], D[g, 8 * i + 2 * t + 1],
                                           D[g + 8, 8 * i + 2 * t], D[g + 8, 8 * i + 2 * t + 1]], 1)


def _rna(x32):
    """cvt.rna.tf32.f32 of f32 values -> (the rounded f32, its bits)."""
    bits = (x32.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return bits.view(np.float32), bits


def _emulate_mma(a, wt, Co, K, dil, plan, offset=0):
    """narrow_mma_kernel's sums (before the bias) of the operand ``a`` (B, T,
    Ci) and the copy ``wt``, block by block as the source runs them, ``a``
    placed ``offset`` elements past a 16-byte boundary -> (B, T, Co) f64 and
    how often each output was written."""
    B, T, Ci = a.shape
    f32 = a.dtype == torch.float32
    es, epu, kt, planes = (4, 4, 8, 2) if f32 else (2, 8, 16, 1)
    raw = (a if f32 else a.view(torch.int16)).contiguous().numpy().view(np.uint8).reshape(-1)
    gmem = np.zeros(64 + raw.size + 64, np.uint8)
    base = 64 + offset * es
    gmem[base:base + raw.size] = raw
    el_type = np.uint32 if f32 else np.uint16
    a_el = raw.view(el_type)
    w_el = (wt if f32 else wt.view(torch.int16)).contiguous().numpy().reshape(-1).view(
        np.uint32 if f32 else np.uint16)
    ci_pad, co_pad, ck, ckw, ct = (plan[k] for k in ("ci_pad", "co_pad", "ck", "ckw", "ct"))
    pitch_a, pitch_o, plane_bytes = plan["pitch_a"], plan["pitch_o"], plan["plane_bytes"]
    pe, N, rows = pitch_a * epu, ct * 8, MMA_ROWS + dil * (K - 1)
    nck = -(-ci_pad // ck)
    last_len = ci_pad - (nck - 1) * ck
    q_full, q_last = -(-ck // ckw), -(-last_len // ckw)
    steps = K * ((nck - 1) * q_full + q_last)
    out, written = np.zeros((B, T, Co)), np.zeros((B, T, Co), int)
    for bx, b, bz in np.ndindex(*plan["grid"]):
        smem = np.full(plan["smem"], 0xFF, np.uint8)  # NaN: a stale read shows
        slab = smem[:plan["ring_off"]].view(el_type)
        t0, tile0 = bx * MMA_ROWS, bz * ct
        ntl = min(ct, co_pad // 8 - tile0)
        x0 = t0 - dil * (K - 1) // 2
        ra, rb = max(0, -x0), min(rows, T - x0)

        def stage(c0, cl):  # mma_stage
            units, real = cl // epu, min(cl, Ci - c0)
            for r in list(range(ra)) + list(range(rb, rows)):
                slab[r * pe:r * pe + units * epu] = 0
            for r in range(ra, rb):
                slab[r * pe + real:r * pe + cl] = 0
            lo, n = (b * T + x0 + ra) * Ci, (rb - ra) * Ci
            first = base + lo * es
            p0, off0 = first & ~15, (first - (first & ~15)) // es
            for i in range(-(-(off0 + n) // epu)):
                e0 = i * epu - off0
                if e0 >= 0 and e0 + epu <= n:  # a whole 16-byte piece of the run
                    v = gmem[p0 + 16 * i:p0 + 16 * i + 16].view(el_type)
                else:
                    v = np.array([a_el[lo + e0 + q] if 0 <= e0 + q < n else 0
                                  for q in range(epu)], el_type)
                for q in range(epu):
                    e = e0 + q
                    if 0 <= e < n and c0 <= e % Ci < c0 + real:
                        slab[(ra + e // Ci) * pe + e % Ci - c0] = v[q]

        def load(step, slot):  # mma_load_w: cp.async of 16-byte units, [unit][N rows][16 B]
            c, j, q = step
            length = last_len if c == nck - 1 else ck
            k0, kl = c * ck + q * ckw, min(ckw, length - q * ckw)
            dst = plan["ring_off"] + slot * planes * plane_bytes
            for pl in range(planes):
                for r in range(ntl * 8):
                    src = ((j * planes + pl) * co_pad + tile0 * 8 + r) * ci_pad + k0
                    for u in range(kl // epu):
                        d = dst + pl * plane_bytes + (u * N + r) * 16
                        smem[d:d + 16] = w_el[src + u * epu:src + (u + 1) * epu].view(np.uint8)

        order = [(c, j, q) for c in range(nck) for j in range(K)
                 for q in range(q_last if c == nck - 1 else q_full)]
        assert len(order) == steps
        for s in range(min(steps, RING - 1)):
            load(order[s], s)
        stage(0, min(ck, ci_pad))
        staged = 0
        warps = MMA_THREADS // 32
        acc = np.zeros((warps, 32, N // 2))  # warp, lane, register
        smem32 = smem.view(np.uint32)
        for s, (c, j, q) in enumerate(order):
            if c != staged:
                stage(c * ck, min(ck, ci_pad - c * ck))
                staged = c
            if s + RING - 1 < steps:
                load(order[s + RING - 1], (s + RING - 1) % RING)
            length = last_len if c == nck - 1 else ck
            cs, nk = q * ckw, min(ckw, length - q * ckw) // kt
            w_s = plan["ring_off"] + (s % RING) * planes * plane_bytes
            for warp in range(warps):
                part = np.zeros((32, N // 2))
                for k in range(nk):
                    a_reg = _ldsm(smem32, ((warp * 16 + j * dil + (LANE & 15)) * pitch_a
                                           + cs // epu + 2 * k + (LANE >> 4)) * 16, 4)
                    bh = w_s + 2 * k * N * 16
                    if f32:
                        h32, hb = _rna(a_reg.view(np.float32))
                        lb = _rna((a_reg.view(np.float32) - h32).astype(np.float32))[1]
                        for x, start in ((lb, bh), (hb, bh + plane_bytes), (hb, bh)):
                            _wgmma(part, x, smem, start, N, True)
                    else:
                        _wgmma(acc[warp], a_reg, smem, bh, N, False)
                acc[warp] += part
        # the epilogue: through shared memory
        so = smem.view(np.float32)
        g, tq = LANE // 4, LANE % 4
        for warp in range(warps):
            for i in range(ntl):
                r, col = warp * 16 + g, 8 * i + 2 * tq
                for e, (dr, dc) in enumerate(((0, 0), (0, 1), (8, 0), (8, 1))):
                    so[(r + dr) * pitch_o + col + dc] = acc[warp, :, 4 * i + e]
        n0 = tile0 * 8
        ncols = min(Co - n0, ct * 8)
        for r in range(min(MMA_ROWS, T - t0)):
            out[b, t0 + r, n0:n0 + ncols] = so[r * pitch_o:r * pitch_o + ncols]
            written[b, t0 + r, n0:n0 + ncols] += 1
    return out, written


# (K, Co, Ci, dilation, B, T, offset, chunked): odd Co and Ci (pads in n8 and
# the k tile), two N chunks and a partial one, pieces of a chunk (Ci 100 in
# bf16: 64 + 48; Ci 50 in f32: 32 + 24), a halo past T, an operand off 16
# bytes, an operand staged in chunks (a small shared memory; and Ci 200 in
# f32, whose whole slab would leave one block an SM)
MMA_CASES = [(3, 25, 25, 2, 2, 70, 0, False), (7, 100, 100, 1, 1, 133, 1, False),
             (5, 50, 50, 3, 2, 40, 3, False), (11, 12, 9, 5, 2, 30, 1, False),
             (3, 24, 40, 1, 1, 50, 0, True), (3, 200, 200, 1, 1, 64, 0, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MMA_CASES, ids=lambda c: f"k{c[0]}co{c[1]}ci{c[2]}")
def test_mma_route_emulation(case, dtype):
    """The tensor-core route's index work, emulated step by step on the CPU
    from shared memory that starts as NaN: every output written exactly
    once, none stale, the sums those of the SAME conv in f64 (bf16: the
    products summed in f64 and rounded to f32, 1e-7 of the max; f32: the
    three TF32 passes, 1e-5, K2F_TOL), with random values in the copy's pads (the
    operand's pad channels are zero, so the kernel does not rest on them)."""
    K, Co, Ci, dil, B, T, offset, chunked = case
    rng = np.random.default_rng(Co * 31 + Ci)
    a = torch.as_tensor(rng.standard_normal((B, T, Ci)).astype(np.float32)).to(dtype)
    w = torch.as_tensor(rng.standard_normal((K, Co, Ci)).astype(np.float32)).to(dtype)
    wt = mrf.tile_conv(w)
    co8, cp = mrf.mma_pads(Co, Ci, dtype)
    noise = torch.as_tensor(rng.standard_normal(wt.shape).astype(np.float32)).to(dtype)
    pad = torch.ones(wt.shape, dtype=torch.bool)
    pad[:, :, :Co, :Ci] = False
    wt = torch.where(pad, noise, wt)
    es = a.element_size()
    small = {4: 30 * 1024, 2: 18 * 1024}[es]  # the least ring fits, the whole slab beside it not
    plan = _plan(Co, Ci, K, dil, False, B, T, es, max_smem=small if chunked else MAX_SMEM)
    assert plan["route"] == "mma" and (plan["ck"] < plan["ci_pad"] or not chunked)
    got, written = _emulate_mma(a, wt, Co, K, dil, plan, offset)
    assert (written == 1).all() and np.isfinite(got).all()
    ref = torch.nn.functional.conv1d(a.double().transpose(1, 2), w.double().permute(1, 2, 0),
                                     padding=dil * (K - 1) // 2, dilation=dil).transpose(1, 2)
    tol = 1e-5 if dtype == torch.float32 else 1e-7  # bf16: the sums rounded to f32
    assert float(np.abs(got - ref.numpy()).max()) <= tol * float(ref.abs().max())


# ---------------------------------------------------------------------------
# narrow_small_kernel emulated on the CPU: its cp.async staging, ldmatrix
# lane addresses, mma.sync register fragments (A from the slab, B from the
# copy), the three TF32 passes, the pair's intermediate over the slab and
# the epilogue through shared memory, warp by warp as csrc/mrf_narrow.cu
# runs them, on shared memory that starts as NaN
# ---------------------------------------------------------------------------


def _mma_sync(d, a, b, kind):
    """mma.sync of one warp, d (32, 4) f32 += A B: ``kind`` "k16" (m16n8k16
    bf16: a 4 registers, b 2), "k8" (m16n8k8 bf16: a 2, b 1) or "tf32"
    (m16n8k8: a 4, b 2), the PTX fragment layouts (lane 4 g + t)."""
    g, t = LANE // 4, LANE % 4
    if kind == "tf32":
        A, B = np.zeros((16, 8)), np.zeros((8, 8))
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = _tf32(a).T
        B[t, g], B[t + 4, g] = _tf32(b).T
    else:
        kt = 16 if kind == "k16" else 8
        A, B = np.zeros((16, kt)), np.zeros((kt, 8))
        for r in range(a.shape[1]):  # a0: rows g, a1: g + 8, a2 / a3: the same at k + 8
            dr, dc = 8 * (r % 2), 8 * (r // 2)
            A[g + dr, 2 * t + dc], A[g + dr, 2 * t + dc + 1] = _bf16_pair(a[:, r])
        for r in range(b.shape[1]):
            B[2 * t + 8 * r, g], B[2 * t + 8 * r + 1, g] = _bf16_pair(b[:, r])
    D = A @ B
    return (d + np.stack([D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t], D[g + 8, 2 * t + 1]],
                         1)).astype(np.float32)


def _small_conv(smem, acc, slab_off, pitch, row0, ntiles, w_off, K, dil, CI, CO, f32):
    """small_conv: acc (warps, MT, n8 tiles, 32, 4) f32 += the conv's sums,
    over (tap, k step, pass), A by ldmatrix at the tap's shift, B the
    lane's fragment of the copy at ``w_off``."""
    nt, ks, _, E = mrf.small_layout(CO, CI, torch.float32 if f32 else torch.bfloat16)
    es, x2 = (4, False) if f32 else (2, CI == 8)
    words = E * es // 4
    smem32 = smem.view(np.uint32)
    for warp in range(acc.shape[0]):
        a_lane = slab_off + ((row0 + warp * 16 + (LANE & 15)) * pitch
                             + (0 if x2 else LANE >> 4)) * 16
        for tap in range(K):
            bw = {(n, s): np.stack([smem32[(w_off + (((tap * nt + n) * ks + s) * 32 + LANE)
                                             * E * es) // 4 + q] for q in range(words)], 1)
                  for n in range(nt) for s in range(ks)}
            for m in range(acc.shape[1]):
                if warp + 8 * m >= ntiles:
                    break
                am = a_lane + (128 * m + tap * dil) * pitch * 16
                if f32:
                    part = np.zeros((nt, 32, 4), np.float32)
                    for s in range(ks):
                        ah = _ldsm(smem32, am + 2 * s * 16, 4)
                        h32, hb = _rna(ah.view(np.float32))
                        lb = _rna((ah.view(np.float32) - h32).astype(np.float32))[1]
                        for n in range(nt):
                            w = bw[n, s]
                            for x, b in ((lb, w[:, 0:2]), (hb, w[:, 2:4]), (hb, w[:, 0:2])):
                                part[n] = _mma_sync(part[n], x, b, "tf32")
                    acc[warp, m] = acc[warp, m] + part  # rounded to nearest
                else:
                    a_reg = _ldsm(smem32, am, 2 if x2 else 4)
                    for n in range(nt):
                        acc[warp, m, n] = _mma_sync(acc[warp, m, n], a_reg, bw[n, 0],
                                                    "k8" if x2 else "k16")


def _to_op(v, f32):
    """f32 values as the operand type, back in f32."""
    return v if f32 else torch.from_numpy(v).bfloat16().float().numpy()


def _lrelu(v):
    return np.where(v > 0, v, np.float32(0.1) * v).astype(np.float32)


def _emulate_small(a, c1, c2=None, res=None, acc_in=None, scale=0.0, acc_act=False,
                   round_sum=False, zero_halo=True):
    """narrow_small_kernel's outputs (y, act, acc_out: (B, T, Co) f32, NaN
    where not written) and how often each was written, block by block as
    the source runs them; ``zero_halo`` False leaves the pair's intermediate
    outside [0, T) as the first conv's values (the planted defect)."""
    B, T, Ci = a.shape
    K, Co, _ = c1.w.shape
    f32, pair = a.dtype == torch.float32, c2 is not None
    es, dil = (4 if f32 else 2), c1.dilation
    mode = (0 if acc_in is None and scale == 0.0 else 1 if acc_in is None else 2) + (
        4 if acc_act else 0) + (8 if round_sum else 0)
    plan = _plan(Co, Ci, K, dil, pair, B, T, es)
    tiles = (res is not None) + ((mode & 3) == 2)
    raw = lambda x: (x if x.dtype == torch.float32 else x.view(torch.int16)).contiguous().numpy(
    ).view(np.uint8).reshape(-1)
    a_rows, w1 = raw(a).reshape(B, T, Ci * es), raw(c1.wt)
    w2 = raw(c2.wt) if pair else None
    units, pitch, rows = Ci * es // 16, plan["pitch"], plan["rows"]
    out = {k: np.full((B, T, Co), np.nan, np.float32) for k in ("y", "act", "acc")}
    written = np.zeros((B, T, Co), int)
    for bx, b, _ in np.ndindex(*plan["grid"]):
        smem = np.full(plan["pre_off"] + tiles * SMALL_ROWS * Co * 4, 0xFF, np.uint8)
        t0 = bx * SMALL_ROWS
        r0 = t0 - SMALL_LEAD if pair else t0
        x0, nrows = r0 - dil * (K - 1) // 2, min(SMALL_ROWS, T - t0)
        smem[:w1.size] = w1
        if pair:
            smem[w1.size:2 * w1.size] = w2
        slab = smem[plan["slab_off"]:plan["slab_off"] + rows * pitch * 16].reshape(rows, -1)
        for r in range(rows):  # cp.async, zero-filled outside [0, T)
            t = x0 + r
            slab[r, :units * 16] = a_rows[b, t] if 0 <= t < T else 0
        pre = plan["pre_off"]
        for x in (res, acc_in if (mode & 3) == 2 else None):
            if x is not None:
                smem[pre:pre + nrows * Co * 4] = raw(x[b, t0:t0 + nrows])
                pre += SMALL_ROWS * Co * 4
        warps = SMALL_THREADS // 32
        acc = np.zeros((warps, 1, Co // 8, 32, 4), np.float32)
        if pair:
            acc1 = np.zeros((warps, 2, Co // 8, 32, 4), np.float32)
            _small_conv(smem, acc1, plan["slab_off"], pitch, 0, SMALL_ROWS // 16 + 1, 0, K, dil,
                        Ci, Co, f32)
            bias = c1.b.numpy()
            g, tq = LANE // 4, LANE % 4
            for warp, m, n, h in np.ndindex(warps, 2, Co // 8, 2):
                if warp + 8 * m >= SMALL_ROWS // 16 + 1:
                    continue
                row, col = 16 * (warp + 8 * m) + g + 8 * h, 8 * n + 2 * tq
                kept = ((r0 + row >= 0) & (r0 + row < T)) | (not zero_halo)
                for q in range(2):
                    v = _to_op(_lrelu(acc1[warp, m, n, :, 2 * h + q] + bias[col + q]), f32)
                    v = np.where(kept, v, np.float32(0))
                    at = plan["slab_off"] + row * pitch * 16 + (col + q) * es
                    for lane in range(32):
                        cell = smem[at[lane]:at[lane] + es]
                        cell[:] = (v[lane:lane + 1] if f32 else
                                   torch.from_numpy(v[lane:lane + 1]).bfloat16().view(
                                       torch.int16).numpy()).view(np.uint8)
            _small_conv(smem, acc, plan["slab_off"], pitch, SMALL_LEAD - (K - 1) // 2,
                        SMALL_ROWS // 16, w1.size, K, 1, Co, Co, f32)
        else:
            _small_conv(smem, acc, plan["slab_off"], pitch, 0, SMALL_ROWS // 16, 0, K, dil, Ci,
                        Co, f32)
        so = smem[:SMALL_ROWS * SMALL_PITCH_O * 4].view(np.float32)
        g, tq = LANE // 4, LANE % 4
        for warp, n in np.ndindex(warps, Co // 8):
            row, col = 16 * warp + g, 8 * n + 2 * tq
            for e, (dr, dc) in enumerate(((0, 0), (0, 1), (8, 0), (8, 1))):
                so[(row + dr) * SMALL_PITCH_O + col + dc] = acc[warp, 0, n, :, e]
        pres = smem[plan["pre_off"]:].view(np.float32)
        bo = (c2 if pair else c1).b.numpy()
        for r in range(nrows):
            x = so[r * SMALL_PITCH_O:r * SMALL_PITCH_O + Co]
            v = (_to_op(x, f32) if round_sum else x) + bo
            if res is not None:
                v = v + pres[r * Co:(r + 1) * Co]
            t = t0 + r
            out["y"][b, t], out["act"][b, t] = v, _to_op(_lrelu(v), f32)
            if mode & 3:
                s = np.float32(scale) * v
                if (mode & 3) == 2:
                    s = pres[tiles // 2 * SMALL_ROWS * Co + r * Co:][:Co] + s
                out["acc"][b, t] = _to_op(_lrelu(s), f32) if acc_act else s
            written[b, t] += 1
    return out, written


# (pair, K, Co, Ci, dilation, B, T, res, acc mode): the pairs at 16 and 8
# (K = 11 at dilation 5: the widest halo) with the residual and both stage
# means, single convs at every (Ci, Co) of the route (a fold's 3 taps, the
# sum rounded before the bias), ragged T (a partial last block; the first
# block reads the SAME padding), one block of T < 128
SMALL_CASES = [(True, 11, 16, 16, 5, 2, 300, True, 2), (True, 7, 8, 8, 3, 1, 200, True, 5),
               (True, 3, 16, 16, 1, 1, 100, False, 1), (False, 3, 16, 8, 1, 2, 130, False, 0),
               (False, 5, 8, 16, 2, 1, 64, True, 8), (False, 11, 16, 16, 1, 1, 257, True, 2),
               (False, 3, 8, 8, 1, 1, 150, False, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SMALL_CASES, ids=lambda c: f"{'pair' if c[0] else 'conv'}"
                         f"k{c[1]}co{c[2]}ci{c[3]}d{c[4]}t{c[6]}m{c[8]}")
def test_small_route_emulation(case, dtype):
    """The small route's index work, emulated warp by warp on the CPU from
    shared memory that starts as NaN: every output written exactly once,
    y, act and the stage mean (or its operand) those of ``mrf_pair_plain`` /
    ``mrf_conv_plain`` (f32 within K2F_TOL = 1e-5 of each output's max, the
    three TF32 passes; bf16 within K2_TOL = 5e-3, the intermediate rounded to
    bf16 from other f32 sums), at both edges of a ragged T; the pair's
    intermediate left unzeroed outside [0, T) reads at least 10x the
    limit."""
    pair, K, Co, Ci, dil, B, T, with_res, mode = case
    rng = np.random.default_rng(K * 100 + Co * 10 + Ci + T)
    f = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32))

    def conv(d):
        w = (f(K, Co if d else Co, Ci if d else Co) * 0.3).to(dtype)
        return mrf.ConvWeights(w, f(Co) * 0.1, d, mrf.tile_conv(w))

    c1 = conv(dil)
    c2 = conv(1) if pair else None
    a = mrf.operand(f(B, T, Ci), dtype)
    res = f(B, T, Co) if with_res else None
    acc = f(B, T, Co) if mode & 3 == 2 else None
    scale = 0.25 if mode & 3 else 0.0
    kw = dict(res=res, acc=acc, acc_scale=scale, want_y=True, want_act=True,
              acc_act=bool(mode & 4))
    if pair:
        ref = mrf.mrf_pair_plain(a, c1, c2, **kw)
    else:
        ref = mrf.mrf_conv_plain(a, c1, **kw, round_sum=bool(mode & 8))
    got, written = _emulate_small(a, c1, c2, res, acc, scale, bool(mode & 4), bool(mode & 8))
    assert (written == 1).all()
    tol = 1e-5 if dtype == torch.float32 else 5e-3
    for name, r in zip(("y", "act", "acc"), ref):
        if r is None:
            continue
        r = r.float().numpy()
        assert np.isfinite(got[name]).all(), name
        assert np.abs(got[name] - r).max() <= tol * np.abs(r).max(), name
    if pair:  # the planted defect: the intermediate's rows outside [0, T) kept
        bad, _ = _emulate_small(a, c1, c2, res, acc, scale, bool(mode & 4), zero_halo=False)
        y = ref[0].numpy()
        assert np.abs(bad["y"] - y).max() >= 10 * tol * np.abs(y).max()
