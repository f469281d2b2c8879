"""K2 at every HiFi-GAN shape the JAX package vocodes, on the CPU.

JAX's stage kernel (``tacotron2_tpu/ops/mrf_pallas.py``) takes any channel
count; the port's wide kernels take Co a multiple of 32 and Ci a multiple
of 8, and every other shape runs on the narrow kernel
(``csrc/mrf_narrow.cu``: groups of up to 16 output channels a block, a
partial last group, a partial last slice of input channels). Where JAX runs
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
``vocode_routes``; the narrow plan against the source; the upsamples JAX
runs on XLA.
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
    """At a shape the wide kernels do not take, ``pack_conv`` makes the
    narrow kernel's copy (Ci, K, Co) in the weights' type: every weight read
    at ``tile_offset`` is the tap-major weight, exactly; a block's group of
    output channels (``_plan``) reads its columns of each (channel, tap)
    run, the last group's past Co not in the copy (the kernel stages zeros
    there)."""
    rng = np.random.default_rng(K * 1000 + Co + Ci)
    conv = torch.nn.Conv1d(Ci, Co, K, padding=K // 2)
    with torch.no_grad():
        conv.weight.copy_(torch.as_tensor(rng.standard_normal((Co, Ci, K)).astype(np.float32)))
    cw = mrf.pack_conv(conv, dtype)
    assert not mrf.wide(Co, Ci)
    G = _plan(Co, Ci, K, 1)["group"]
    assert G == min(16, 1 << (Co - 1).bit_length())
    assert cw.wt.dtype == dtype and cw.wt.shape == (Ci, K, Co)
    assert torch.equal(mrf.read_tiled(cw.wt, K, Co, Ci), cw.w)
    last = (-(-Co // G) - 1) * G  # the last group's first channel
    assert torch.equal(cw.wt[Ci - 1, K - 1, last:], cw.w[K - 1, last:, Ci - 1])
    assert mrf.tile_offset(K - 1, Co - 1, Ci - 1, K, Co, Ci, dtype) == Ci * K * Co - 1


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


THREADS, ACCUM, MAX_SMEM = _const("kThreads"), _const("kAccum"), _const("kMaxSmem")


def _plan(Co: int, Ci: int, K: int, dilation: int, pair: bool = False) -> dict:
    """``csrc/mrf_narrow.cu::narrow_plan`` in Python: ``general``
    (``narrow_group_kernel``: every shape but Co in ``PAIR_C`` with Ci a
    multiple of 8, ``narrow_conv_kernel``'s), the group (Co there, else
    ``kGroup`` or the least power of two >= Co below it), the staged slice
    (16 input channels where they divide Ci, else 8 where they do, else
    min(16, Ci), halved rounding up while a general kernel's does not fit),
    the operand's rows a slice (odd), the shared memory in bytes;
    ValueError where the kernel refuses the shape."""
    general = not (Co in mrf.PAIR_C and Ci % 8 == 0)
    group = Co if not general else min(_const("kGroup"), 1 << (Co - 1).bit_length())
    bt = THREADS * (ACCUM // group)
    if pair and (Ci != Co or general) or K % 2 == 0 or (pair and bt - (K - 1) < 1):
        raise ValueError(f"the narrow kernel does not take K={K}, Ci={Ci}, Co={Co}, pair={pair}")
    rows_p = (bt + dilation * (K - 1)) | 1
    kc = 16 if Ci % 16 == 0 else 8 if Ci % 8 == 0 else min(16, Ci)
    smem = lambda kc: 4 * (kc * K * group + kc * rows_p)
    while general and kc > 1 and smem(kc) > MAX_SMEM:
        kc = (kc + 1) // 2
    if smem(kc) > MAX_SMEM:
        raise ValueError(f"the narrow kernel's rows do not fit: K={K}, dilation={dilation}")
    return {"general": general, "group": group, "kc": kc, "rows_p": rows_p, "smem": smem(kc)}


def test_narrow_plan_mirrors_the_source():
    """``narrow_plan`` of the source in Python (``_plan``, from its
    constants): Co 8 and 16 at Ci a
    multiple of 8 keep PR 20's ``narrow_conv_kernel`` instances (and the
    pair, only at ``PAIR_C``), every other shape a ``narrow_group_kernel`` of
    each group width, and every narrow conv of the smoke's C2 generators
    fits the shared memory: C = 1's blocks of 8,192 rows stage 1-channel
    slices; a conv of many input channels at G = 1 halves its slice until
    it fits."""
    assert (THREADS, ACCUM, MAX_SMEM, _const("kGroup")) == (128, 64, 227 * 1024, 16)
    v2 = set(re.findall(r"T2_NARROW\((\d+), (true|false)\)", SRC))
    assert v2 == {("16", "false"), ("8", "false"), ("16", "true"), ("8", "true")}
    assert set(re.findall(r"T2_GROUP\((\d+)\)", SRC)) == {"16", "8", "4", "2", "1"}
    for name, h in SMOKE.C2_GENERATORS.items():
        gen = HiFiGAN(HiFiGANConfig.from_dict(h), F32)
        if not gen.odd:
            continue
        convs = [(gen.conv_pre_weights(), False)]
        for rbs, ups in gen.kernel_weights():
            convs += [(ups.folded, False)] if ups.folded is not None else []
            convs += [(c, mrf.pair_fusable(c1, c2) and c is c1) for rb in rbs for c1, c2 in rb
                      for c in (c1, c2) if c is not None]
        for cw, pair in convs:
            K, Co, Ci = cw.w.shape
            if not mrf.wide(Co, Ci):
                plan = _plan(Co, Ci, K, cw.dilation, pair)
                assert plan["smem"] <= MAX_SMEM and plan["group"] <= 16
    big = _plan(1, 64, 11, 5)
    assert big["group"] == 1 and big["kc"] < 16 and big["smem"] <= MAX_SMEM and big["general"]
    assert not _plan(16, 80, 7, 1)["general"] and _plan(16, 100, 7, 1)["general"]
    with pytest.raises(ValueError):
        _plan(24, 24, 3, 1, pair=True)
