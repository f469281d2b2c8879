"""The port's HiFi-GAN (tacotron2_tpu_torch, plain versions on the CPU)
against the JAX package's fused Pallas MRF path run in interpret mode with
f32 dots (``bf16=False``), on the same weights. Covers the three TPU stage
kernels' functions (the MRF alone, the u=2 aligned upsample and the u=8
expand upsample), both resblock types, the whole generator and the
receptive field. Tolerance as tests/test_mrf_pallas.py: 1e-5 of the
output's scale."""

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
from tacotron2_tpu_torch.ops import mrf

torch.set_num_threads(1)

RB = {"1": ((3, 7, 11), ((1, 3, 5),) * 3), "2": ((3, 5), ((1, 3), (1, 3)))}


def _tol(ref):
    return 1e-5 * max(float(np.abs(ref).max()), 1e-3)


def _jax_conv(rng, k, cin, cout, scale=0.05):
    return {"w": jnp.asarray(rng.standard_normal((k, cin, cout)).astype(np.float32) * scale),
            "b": jnp.asarray(rng.standard_normal(cout).astype(np.float32) * 0.1)}


def _to_torch_conv(p, d):
    """JAX (W, I, O) conv -> the port's tap-major (K, Co, Ci) weights."""
    w = np.asarray(p["w"]).transpose(0, 2, 1).copy()
    return mrf.ConvWeights(torch.as_tensor(w), torch.as_tensor(np.array(p["b"])), d)


def _stage_params(rng, rb_type, C):
    kernels, dils = RB[rb_type]
    jrbs, trbs = [], []
    for kr, dil in zip(kernels, dils):
        if rb_type == "1":
            c1 = [_jax_conv(rng, kr, C, C) for _ in dil]
            c2 = [_jax_conv(rng, kr, C, C) for _ in dil]
            jrbs.append({"convs1": c1, "convs2": c2})
            trbs.append([(_to_torch_conv(a, d), _to_torch_conv(b, 1))
                         for a, b, d in zip(c1, c2, dil)])
        else:
            c = [_jax_conv(rng, kr, C, C) for _ in dil]
            jrbs.append({"convs": c})
            trbs.append([(_to_torch_conv(a, d), None) for a, d in zip(c, dil)])
    return jrbs, trbs


@pytest.mark.parametrize("rb_type", ["1", "2"])
@pytest.mark.parametrize("variant,u,cin,C,length", [
    ("mrf_only", None, 32, 32, 333),      # _make_stage_kernel, folded layout on the TPU
    ("mrf_only", None, 128, 128, 100),    # _make_stage_kernel, unfolded
    ("ups_aligned", 2, 64, 32, 57),       # _make_stage_kernel_ups
    ("ups_expand", 8, 256, 128, 13),      # _make_stage_kernel_ups_expand
])
def test_mrf_stage_matches_pallas(rb_type, variant, u, cin, C, length):
    rng = np.random.default_rng(0)
    kernels, dils = RB[rb_type]
    jrbs, trbs = _stage_params(rng, rb_type, C)
    x = rng.standard_normal((2, length, cin)).astype(np.float32)
    kw = dict(resblock=rb_type, kernels=kernels, dilations=dils, bf16=False, interpret=True)
    ups_t = None
    if u is not None:
        k = 2 * u
        ups = _jax_conv(rng, k, cin, C, scale=0.1)
        kw["upsample"] = (ups, u)
        ups_t = mrf.make_upsample(
            torch.as_tensor(np.array(ups["w"])),  # (K, Ci, Co) in both
            torch.as_tensor(np.array(ups["b"])), u, (k - u) // 2)
    ref = np.asarray(mrf_stage_pallas(jrbs, jnp.asarray(x), **kw))
    got = mrf.mrf_stage(torch.as_tensor(x), trbs, ups_t).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=_tol(ref), rtol=0)


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


@pytest.mark.parametrize("kw", [{}, GEN_CFGS["rb1_u4_2_2"], GEN_CFGS["rb2_u2_2"]])
def test_mel_receptive_field_equal(kw):
    assert (HiFiGAN(HiFiGANConfig(**kw)).mel_receptive_field()
            == JaxHiFiGAN(JaxHiFiGANConfig(**kw)).mel_receptive_field())
