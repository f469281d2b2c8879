"""The port's HiFi-GAN (tacotron2_tpu_torch, plain versions on the CPU)
against the JAX package's fused Pallas MRF path run in interpret mode, on
the same weights. Covers the three TPU stage kernels' functions (the MRF
alone, the u=2 aligned upsample and the u=8 expand upsample), both
resblock types, the whole generator and the receptive field.

With f32 dots (``bf16=False``, the ``32-true`` policy) the tolerance is
tests/test_mrf_pallas.py's: 1e-5 of the output's scale.

Under bf16 (K2's bf16 mode, a generator built under ``Policy(torch.bfloat16)``)
every conv takes bf16 operands with f32 sums on both sides, and the port
sums in another order than XLA. A sum that lands near a bf16 rounding
boundary then rounds the next conv's operand the other way, and ResBlock1's
chains of 18 convs carry such flips on. Readings (stage against
``mrf_stage_pallas(..., bf16=True)``, max over the output's scale): 3.0e-4,
2.0e-3, 1.4e-5 and 2.0e-3 for ResBlock1's four shapes, <= 1.4e-4 for
ResBlock2's. The port against itself with its convs' input channels
permuted (the same function, another f32 sum order) reads 2.8e-4, 1.9e-3,
1.9e-4 and 2.0e-3, <= 6.9e-5: the differences are rounding flips, not a
different function. Limit: 4e-3 of the scale (``BF16_STAGE_TOL``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.models.hifigan import HiFiGAN as JaxHiFiGAN
from tacotron2_tpu.models.hifigan import HiFiGANConfig as JaxHiFiGANConfig
from tacotron2_tpu.models.layers import Policy as JaxPolicy
from tacotron2_tpu.ops.mrf_pallas import mrf_stage_pallas
from tacotron2_tpu_torch.convert import hifigan_from_jax_params
from tacotron2_tpu_torch.models.hifigan import HiFiGAN, HiFiGANConfig
from tacotron2_tpu_torch.models.layers import Policy
from tacotron2_tpu_torch.ops import mrf

torch.set_num_threads(1)

RB = {"1": ((3, 7, 11), ((1, 3, 5),) * 3), "2": ((3, 5), ((1, 3), (1, 3)))}


def _tol(ref):
    return 1e-5 * max(float(np.abs(ref).max()), 1e-3)


def _jax_conv(rng, k, cin, cout, scale=0.05):
    return {"w": jnp.asarray(rng.standard_normal((k, cin, cout)).astype(np.float32) * scale),
            "b": jnp.asarray(rng.standard_normal(cout).astype(np.float32) * 0.1)}


def _to_torch_conv(p, d, dtype=torch.float32):
    """JAX (W, I, O) conv -> the port's tap-major (K, Co, Ci) weights in
    ``dtype``, the type its operands are rounded to."""
    w = np.asarray(p["w"]).transpose(0, 2, 1).copy()
    return mrf.ConvWeights(torch.as_tensor(w).to(dtype), torch.as_tensor(np.array(p["b"])), d)


def _stage_params(rng, rb_type, C, dtype=torch.float32):
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


BF16_STAGE_TOL = 4e-3  # of the output's scale; readings in the module's docstring


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("rb_type", ["1", "2"])
@pytest.mark.parametrize("variant,u,cin,C,length", [
    ("mrf_only", None, 32, 32, 333),      # _make_stage_kernel, folded layout on the TPU
    ("mrf_only", None, 128, 128, 100),    # _make_stage_kernel, unfolded
    ("ups_aligned", 2, 64, 32, 57),       # _make_stage_kernel_ups
    ("ups_expand", 8, 256, 128, 13),      # _make_stage_kernel_ups_expand
])
def test_mrf_stage_matches_pallas(rb_type, variant, u, cin, C, length, bf16):
    rng = np.random.default_rng(0)
    kernels, dils = RB[rb_type]
    dtype = torch.bfloat16 if bf16 else torch.float32
    jrbs, trbs = _stage_params(rng, rb_type, C, dtype)
    x = rng.standard_normal((2, length, cin)).astype(np.float32)
    kw = dict(resblock=rb_type, kernels=kernels, dilations=dils, bf16=bf16, interpret=True)
    ups_t = None
    if u is not None:
        k = 2 * u
        ups = _jax_conv(rng, k, cin, C, scale=0.1)
        kw["upsample"] = (ups, u)
        ups_t = mrf.make_upsample(
            torch.as_tensor(np.array(ups["w"])).to(dtype),  # (K, Ci, Co) in both
            torch.as_tensor(np.array(ups["b"])), u, (k - u) // 2)
    ref = np.asarray(mrf_stage_pallas(jrbs, jnp.asarray(x), **kw))
    got = mrf.mrf_stage(torch.as_tensor(x), trbs, ups_t).numpy()
    assert got.shape == ref.shape
    tol = BF16_STAGE_TOL * float(np.abs(ref).max()) if bf16 else _tol(ref)
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


GEN_CFGS = {
    "rb1_u4_2_2": dict(upsample_rates=(4, 2, 2), upsample_kernel_sizes=(8, 4, 4),
                       upsample_initial_channel=256, num_mels=16),
    "rb2_u2_2": dict(resblock="2", upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                     upsample_initial_channel=128, num_mels=16, resblock_kernel_sizes=(3, 5),
                     resblock_dilation_sizes=((1, 3), (1, 3))),
}


@pytest.mark.parametrize("name", list(GEN_CFGS))
def test_hifigan_apply_matches_jax_fused(name):
    kw = GEN_CFGS[name]
    jm = JaxHiFiGAN(JaxHiFiGANConfig(**kw), JaxPolicy.from_string("32-true"))
    p = jax.tree.map(lambda a: a * 3.0, jm.init(jax.random.PRNGKey(0)))
    mel = np.random.default_rng(1).standard_normal((2, 13, 16)).astype(np.float32)
    ref = np.asarray(jm.apply(p, jnp.asarray(mel), mrf_pallas=True, fuse_ups=True,
                              interpret=True))
    tm = HiFiGAN(HiFiGANConfig(**kw))
    tm.load_state_dict(hifigan_from_jax_params(p))
    got = tm.apply(torch.as_tensor(mel)).numpy()
    assert got.shape == ref.shape == (2, 13 * tm.cfg.total_upsample)
    np.testing.assert_allclose(got, ref, atol=_tol(ref), rtol=0)


def _pcm(wav):
    return np.clip(np.round(wav.astype(np.float64) * 32767), -32768, 32767)


# PCM16 LSB of the bf16 generator against JAX's bf16 apply: (max, mean)
# limits per GEN_CFGS entry; readings in the test's docstring
BF16_GEN_LSB = {"rb1_u4_2_2": (10, 2.5), "rb2_u2_2": (1, 0.05)}


@pytest.mark.parametrize("name", list(GEN_CFGS))
def test_hifigan_bf16_apply_matches_jax(name):
    """The port's bf16 generator (the card's vocoder policy) against JAX's
    ``apply`` under ``bf16-mixed`` (``mrf_pallas=True, fuse_ups=True``, in
    interpret mode) on the same weights, in PCM16 LSB. ``conv_pre`` and
    ``conv_post`` round their f32 sums to bf16 before the bias, as JAX's
    ``conv1d_apply`` emits the policy's type. Readings (max / mean LSB):
    ResBlock1 8 / 1.80, ResBlock2 0 / 0 (its differences are libm's tanh,
    <= 1.5e-8). What is left in ResBlock1 is the stages' rounding flips (the
    module's docstring); the largest, 8 LSB = 2^-12, is one bf16 ulp of
    conv_post's rounding at |x| in [1/32, 1/16). With f32 sums kept at
    conv_pre and conv_post (the fault this test was added for) it read 13 /
    3.13 and 15 / 4.79. Limits: ``BF16_GEN_LSB``."""
    kw = GEN_CFGS[name]
    jm = JaxHiFiGAN(JaxHiFiGANConfig(**kw), JaxPolicy.from_string("bf16-mixed"))
    p = jax.tree.map(lambda a: a * 3.0, jm.init(jax.random.PRNGKey(0)))
    mel = np.random.default_rng(1).standard_normal((2, 13, 16)).astype(np.float32)
    ref = np.asarray(jm.apply(p, jnp.asarray(mel), mrf_pallas=True, fuse_ups=True,
                              interpret=True))
    tm = HiFiGAN(HiFiGANConfig(**kw), Policy.from_string("bf16-mixed"))
    tm.load_state_dict(hifigan_from_jax_params(p))
    got = tm.apply(torch.as_tensor(mel)).numpy()
    assert got.shape == ref.shape == (2, 13 * tm.cfg.total_upsample)
    lsb = np.abs(_pcm(got) - _pcm(ref))
    max_lsb, mean_lsb = BF16_GEN_LSB[name]
    assert lsb.max() <= max_lsb and lsb.mean() <= mean_lsb, (lsb.max(), lsb.mean())


@pytest.mark.parametrize("kw", [{}, GEN_CFGS["rb1_u4_2_2"], GEN_CFGS["rb2_u2_2"]])
def test_mel_receptive_field_equal(kw):
    assert (HiFiGAN(HiFiGANConfig(**kw)).mel_receptive_field()
            == JaxHiFiGAN(JaxHiFiGANConfig(**kw)).mel_receptive_field())
