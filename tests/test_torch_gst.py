"""The port's Global Style Tokens (``models/gst.py``) and the pieces it adds
to ``models/layers.py`` against the JAX package's, on the CPU.

- ``GST`` against JAX ``GST.apply`` on the same weights and mels made from
  a numpy seed: in f32 within 2e-5 (JAX's own bound against the reference,
  tests/test_parity_aux_models.py), in eval and train mode, with
  ``lengths`` None and ragged; under the bf16 policy within ``BF16_TOL`` of
  the style's max (seeds 0-5 read 0 in eval mode but one draw's 1.1e-3, and
  1.6e-3 to 6.3e-3 in train mode, seed 3 the worst, which the test uses:
  the batch statistics' f32 sums differ in the last bits between the
  libraries, and the next conv's bf16 operand rounding then flips an ulp,
  2^-8 of a value);
- train mode's BatchNorm running statistics against JAX's ``new_state``;
- the neutral style (a zeros reference of 32 frames) against JAX
  ``Tacotron2._infer_style``, one row broadcast to B;
- ``layers.gru_sequence`` against JAX ``gru_sequence`` both ways, ragged,
  and ``layers.conv2d`` / ``batchnorm2d`` under both policies; the GST's
  state dict read back by JAX's ``convert_gst_state_dict``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.convert import convert_gst_state_dict
from tacotron2_tpu.models import layers as jl
from tacotron2_tpu.models.gst import GST as JaxGST
from tacotron2_tpu.models.layers import Policy as JaxPolicy
from tacotron2_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from tacotron2_tpu.models.tacotron2 import Tacotron2Config as JaxConfig
from tacotron2_tpu_torch.convert import from_jax_params, gst_from_jax_params
from tacotron2_tpu_torch.models import layers
from tacotron2_tpu_torch.models.gst import GST
from tacotron2_tpu_torch.models.layers import Policy
from tacotron2_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config

torch.set_num_threads(1)

F32_TOL = 2e-5
BF16_TOL = 1.3e-2  # of the output's max: twice the worst reading
M, E = 16, 32  # mels and the style's width in these tests


def _gst(seed=0, E=E, policy="32-true"):
    jg = JaxGST(n_mel_channels=M, token_embedding_size=E, policy=JaxPolicy.from_string(policy))
    params, state = jg.init(jax.random.PRNGKey(seed))
    # BatchNorm statistics other than (0, 1), so eval mode reads them
    r = np.random.default_rng(seed + 50)
    for bn in state["reference_encoder"]["bns"]:
        bn["mean"] = jnp.asarray(r.uniform(-0.1, 0.1, bn["mean"].shape).astype(np.float32))
        bn["var"] = jnp.asarray(r.uniform(0.05, 0.2, bn["var"].shape).astype(np.float32))
    for bn in params["reference_encoder"]["bns"]:
        bn["scale"] = jnp.asarray(r.uniform(0.5, 1.5, bn["scale"].shape).astype(np.float32))
        bn["bias"] = jnp.asarray(r.uniform(-0.2, 0.2, bn["bias"].shape).astype(np.float32))
    tg = GST(M, E)
    tg.load_state_dict(gst_from_jax_params(params, state))
    return jg, params, state, tg


def _mels(B=3, T=150, seed=1):
    return np.random.default_rng(seed).standard_normal((B, T, M)).astype(np.float32)


def _close(got, ref, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_gst_matches_jax_f32(train, ragged):
    jg, params, state, tg = _gst()
    mels = _mels()
    lengths = np.array([150, 97, 64]) if ragged else None
    ref, new_state = jg.apply(params, state, jnp.asarray(mels),
                              None if lengths is None else jnp.asarray(lengths), train=train)
    got = tg(torch.as_tensor(mels), None if lengths is None else torch.as_tensor(lengths),
             train=train)
    assert got.shape == (3, 1, E)
    _close(got, ref, F32_TOL, "style")
    for i, bn in enumerate(tg.reference_encoder.bns):  # eval: unchanged; train: JAX's new_state
        s = new_state["reference_encoder"]["bns"][i]
        _close(bn.running_mean, s["mean"], 1e-6, f"bn {i} mean")
        _close(bn.running_var, s["var"], 1e-6 * float(np.abs(s["var"]).max()), f"bn {i} var")
    if train:
        assert not np.allclose(np.asarray(new_state["reference_encoder"]["bns"][0]["mean"]),
                               np.asarray(state["reference_encoder"]["bns"][0]["mean"]))


@pytest.mark.parametrize("train", [False, True])
def test_gst_matches_jax_bf16(train):
    jg, params, state, tg = _gst(3, policy="bf16-mixed")
    mels = _mels(seed=4)
    ref, _ = jg.apply(params, state, jnp.asarray(mels), train=train)
    got = tg(torch.as_tensor(mels), train=train, policy=Policy.from_string("bf16-mixed"))
    scale = float(np.abs(np.asarray(ref)).max())
    _close(got, ref, BF16_TOL * scale, "bf16 style")
    f32 = tg(torch.as_tensor(mels), train=train)  # and the policy did round
    assert float((f32 - got).detach().abs().max()) > 0


def test_neutral_style_matches_jax():
    cfg = dict(num_chars=12, encoded_dim=32, encoder_kernel_size=5, num_mels=M, prenet_dim=16,
               att_rnn_dim=32, att_dim=16, rnn_hidden_dim=32, postnet_dim=16, dropout=0.5,
               gst=True, gst_token_embedding_size=E)
    jm = JaxTacotron2(JaxConfig(**cfg))
    params, state = jm.init(jax.random.PRNGKey(5))
    tm = Tacotron2(Tacotron2Config(**cfg))
    tm.load_state_dict(from_jax_params(params, state))
    ref = jm._infer_style(params, state, 4, None)
    got = tm.gst_embedding(4)
    assert got.shape == (4, E)
    _close(got, ref, F32_TOL, "neutral")
    assert torch.equal(got[0], got[3])
    mels = _mels(2, 70, 6)
    _close(tm.gst_embedding(2, torch.as_tensor(mels)),
           jm._infer_style(params, state, 2, jnp.asarray(mels)), F32_TOL, "reference")
    with pytest.raises(ValueError, match="GST reference mel of shape"):
        tm.gst_embedding(2, torch.zeros(3, 40, M))
    assert Tacotron2(Tacotron2Config(**{**cfg, "gst": False})).gst_embedding(2) is None


def _gru_params(seed, C, Hd):
    p = jl.gru_cell_init(jax.random.PRNGKey(seed), C, Hd)
    gru = torch.nn.GRU(C, Hd, batch_first=True)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(torch.as_tensor(np.asarray(p["w_ih"]).T))
        gru.weight_hh_l0.copy_(torch.as_tensor(np.asarray(p["w_hh"]).T))
        gru.bias_ih_l0.copy_(torch.as_tensor(np.asarray(p["b_ih"])))
        gru.bias_hh_l0.copy_(torch.as_tensor(np.asarray(p["b_hh"])))
    return p, gru


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("lengths", [None, (11, 4, 0, 7)])
@pytest.mark.parametrize("policy", ["32-true", "bf16-mixed"])
def test_gru_sequence_matches_jax(reverse, lengths, policy):
    p, gru = _gru_params(2, 6, 5)
    xs = np.random.default_rng(3).standard_normal((4, 11, 6)).astype(np.float32)
    jlen = None if lengths is None else jnp.asarray(lengths)
    ref_out, ref_h = jl.gru_sequence(p, jnp.asarray(xs), jlen, reverse,
                                     JaxPolicy.from_string(policy))
    out, h = layers.gru_sequence(gru, torch.as_tensor(xs),
                                 None if lengths is None else torch.as_tensor(lengths), reverse,
                                 Policy.from_string(policy))
    tol = F32_TOL if policy == "32-true" else 1e-2
    _close(out, ref_out, tol, "outputs")
    _close(h, ref_h, tol, "final")
    if lengths is not None:
        assert float(out[1, 4:].abs().max()) == 0.0 and float(h[2].abs().max()) == 0.0
    if lengths is None and not reverse and policy == "32-true":  # torch's own GRU agrees
        t_out, t_h = gru(torch.as_tensor(xs))
        _close(out, t_out.detach().numpy(), 1e-5)
        _close(h, t_h[0].detach().numpy(), 1e-5)


@pytest.mark.parametrize("policy", ["32-true", "bf16-mixed"])
def test_conv2d_and_batchnorm2d_match_jax(policy):
    r = np.random.default_rng(8)
    x = r.standard_normal((2, 3, 9, 7)).astype(np.float32)
    p = jl.conv2d_init(jax.random.PRNGKey(1), 3, 4, (3, 3))
    ref = jl.conv2d_apply(p, jnp.asarray(x.transpose(0, 2, 3, 1)), (2, 2), (1, 1),
                          JaxPolicy.from_string(policy))
    w = torch.as_tensor(np.asarray(p["w"]).transpose(3, 2, 0, 1).copy())
    got = layers.conv2d(torch.as_tensor(x), w, torch.as_tensor(np.asarray(p["b"])),
                        Policy.from_string(policy), stride=2, padding=1)
    _close(got.permute(0, 2, 3, 1), ref, 1e-5, "conv2d")  # bit-level agreement class
    bn = torch.nn.BatchNorm2d(4)
    bp, bs = jl.batchnorm_init(4)
    y, new = jl.batchnorm_apply(bp, bs, ref, True)
    got_y = layers.batchnorm2d(got, bn, True)
    _close(got_y.permute(0, 2, 3, 1), y, 1e-5, "bn train")
    _close(bn.running_mean, new["mean"], 1e-6)
    _close(bn.running_var, new["var"], 1e-6)
    y2, _ = jl.batchnorm_apply(bp, new, ref, False)
    _close(layers.batchnorm2d(got, bn, False).permute(0, 2, 3, 1), y2, 1e-5, "bn eval")


def test_gst_state_dict_read_back_by_jax():
    _, params, state, tg = _gst(9)
    back_p, back_s = convert_gst_state_dict(tg.state_dict())
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back_p)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(back_s)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jax.tree.structure(jax.tree.map(np.asarray, params)) == jax.tree.structure(back_p)
