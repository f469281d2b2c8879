"""The port's teacher-forced decode (``tacotron2_tpu_torch/ops/train_decode.py``,
``TeacherDecode`` on its plain versions on the CPU) against the JAX function
that reaches the two training kernels,
``run_decode_scan_pallas(..., interpret=True, bwd="pallas")``.

Dims of tests/test_train_pallas.py: B=2 with a padded row (lengths 9 and 6),
T=24, H=D=32, P=16, A=16, M=16. The LSTM dropout masks are JAX's own
(``train_scan._dropout_masks`` over the step keys), injected into the port.
Weights come from the JAX ``init`` through ``convert.decoder_from_jax``, and
the JAX gradient tree maps through the same function. Forward outputs and the
gradients of every decoder parameter, ``encoded``, ``att_encoded`` and
``decoder_in`` agree within ``3e-5 * max + 1e-7`` under 32-true and within
``0.02 * max + 1e-6`` under bf16 (the JAX file's own tolerances).

Also: ``torch.autograd.gradcheck`` of the plain ``TeacherDecode`` in float64,
and its gradients against autograd of the straightforward step loop.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.models import decoder as jax_decoder
from tacotron2_tpu.models.layers import Policy as JaxPolicy
from tacotron2_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from tacotron2_tpu.models.tacotron2 import Tacotron2Config as JaxConfig
from tacotron2_tpu.ops import train_scan
from tacotron2_tpu.ops.train_decode_pallas import run_decode_scan_pallas
from tacotron2_tpu_torch.convert import decoder_from_jax
from tacotron2_tpu_torch.ops import train_decode as td

torch.set_num_threads(1)

CFG = dict(num_chars=16, encoded_dim=32, encoder_kernel_size=5, num_mels=16, prenet_dim=16,
           att_rnn_dim=32, att_dim=16, rnn_hidden_dim=32, postnet_dim=16, dropout=0.0)
B, L, T, H, D, P, A = 2, 9, 24, 32, 32, 16, 16
LENS = (9, 6)
TOL = {"32-true": (3e-5, 1e-7), "bf16-mixed": (0.02, 1e-6)}
PORT_DTYPE = {"32-true": torch.float32, "bf16-mixed": torch.bfloat16}


def _loss(mels, gates, aligns, xp):
    return (xp.sum(mels ** 2) + xp.sum(gates ** 2)
            + xp.sum(aligns * xp.arange(L)[None, None, :]))


@functools.lru_cache(maxsize=None)
def _jax_side(policy: str):
    """JAX outputs, gradients, weights and masks, as numpy."""
    model = JaxTacotron2(JaxConfig(**CFG), JaxPolicy.from_string(policy))
    params, _ = model.init(jax.random.PRNGKey(0))
    enc = jax.random.normal(jax.random.PRNGKey(1), (B, L, D))
    att = jax.random.normal(jax.random.PRNGKey(2), (B, L, A))
    din = jax.random.normal(jax.random.PRNGKey(3), (T, B, P))
    mask = jnp.arange(L)[None, :] >= jnp.asarray(LENS)[:, None]
    keys = jax.random.split(jax.random.PRNGKey(13), T)
    st = jax_decoder.init_state(B, L, H, D, H)

    def run(dec_params, enc, att, din):
        return run_decode_scan_pallas(dec_params, st, din, keys, enc, att, mask, None,
                                      train=True, policy=model.policy, interpret=True,
                                      bwd="pallas")

    args = (params["decoder"], enc, att, din)
    outs = run(*args)
    grads = jax.grad(lambda *a: _loss(*run(*a), jnp), argnums=(0, 1, 2, 3))(*args)
    dm1, dm2 = jax.vmap(lambda k: train_scan._dropout_masks(k, (B, H), True))(keys)
    np_ = lambda t: np.asarray(t, np.float32)
    return (params["decoder"], [np_(a) for a in (enc, att, din)], [np_(o) for o in outs],
            grads, np_(dm1), np_(dm2))


def _port_params(dec_tree, dtype=torch.float32):
    sd = decoder_from_jax(dec_tree)
    return [sd[k].to(dtype) for k in td.DECODER_PARAMS]


def _assert_close(got, ref, rel, floor, what):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale + floor, err_msg=what)


@pytest.mark.parametrize("policy", ["32-true", "bf16-mixed"])
def test_teacher_decode_matches_jax_pallas(policy):
    dec_tree, (enc, att, din), outs, grads, dm1, dm2 = _jax_side(policy)
    rel, floor = TOL[policy]
    params = [p.requires_grad_() for p in _port_params(dec_tree)]
    enc_t, att_t, din_t = (torch.tensor(a, requires_grad=True) for a in (enc, att, din))
    lengths = torch.tensor(LENS)
    mels, gates, aligns = td.TeacherDecode.apply(
        PORT_DTYPE[policy], din_t, enc_t, att_t, lengths, torch.as_tensor(dm1),
        torch.as_tensor(dm2), None, *params)
    for name, got, ref in zip(("mels", "gates", "aligns"), (mels, gates, aligns), outs):
        _assert_close(got, ref, rel, floor, name)
    _loss(mels, gates, aligns, torch).backward()

    g_dec, g_enc, g_att, g_din = grads
    ref_dec = decoder_from_jax(jax.tree.map(np.asarray, g_dec))
    for name, p in zip(td.DECODER_PARAMS, params):
        _assert_close(p.grad, ref_dec[name].numpy(), rel, floor, f"grad {name}")
    for name, t, g in (("encoded", enc_t, g_enc), ("att_encoded", att_t, g_att),
                       ("decoder_in", din_t, g_din)):
        _assert_close(t.grad, g, rel, floor, f"grad {name}")


def _tiny_case():
    """f64 inputs at tiny dims, weights from the JAX init."""
    cfg = dict(CFG, encoded_dim=8, num_mels=4, prenet_dim=6, att_rnn_dim=8, att_dim=4,
               rnn_hidden_dim=8)
    params, _ = JaxTacotron2(JaxConfig(**cfg)).init(jax.random.PRNGKey(5))
    ps = [p.double().requires_grad_() for p in _port_params(params["decoder"])]
    r = np.random.default_rng(0)
    Tt, Lt = 4, 7
    mk = lambda *s: torch.tensor(r.standard_normal(s), dtype=torch.float64, requires_grad=True)
    din, enc, att = mk(Tt, 2, 6), mk(2, Lt, 8), mk(2, Lt, 4)
    keep = lambda: torch.tensor((r.random((Tt, 2, 8)) < td.KEEP) / td.KEEP)
    return ps, din, enc, att, torch.tensor([Lt, 4]), keep(), keep()


def test_teacher_decode_gradcheck_f64():
    ps, din, enc, att, lengths, dm1, dm2 = _tiny_case()
    f = lambda d, e, a, *p: td.TeacherDecode.apply(torch.float64, d, e, a, lengths, dm1, dm2, None,
                                                          *p)
    assert torch.autograd.gradcheck(f, (din, enc, att, *ps), eps=1e-6, atol=1e-6,
                                    fast_mode=True)


def test_teacher_decode_grads_equal_autograd_of_step_loop():
    """The hand-pulled reverse pass against autograd through the plain
    forward loop (``teacher_forward_plain``, no custom backward)."""
    ps, din, enc, att, lengths, dm1, dm2 = _tiny_case()
    r = np.random.default_rng(1)

    def loop(d, e, a, *p):
        mg, res = td.teacher_forward_plain(td.pack_weights(p, torch.float64), d, e, a, lengths,
                                           dm1, dm2)
        return mg[..., :-1], mg[..., -1], res.al[1:]

    inputs = (din, enc, att, *ps)
    outs_a = td.TeacherDecode.apply(torch.float64, din, enc, att, lengths, dm1, dm2, None, *ps)
    outs_b = loop(*inputs)
    cots = [torch.tensor(r.standard_normal(o.shape)) for o in outs_a]
    ga = torch.autograd.grad(outs_a, inputs, cots)
    gb = torch.autograd.grad(outs_b, inputs, cots)
    for a, b in zip(outs_a, outs_b):
        torch.testing.assert_close(a, b, atol=1e-12, rtol=0)
    for a, b in zip(ga, gb):
        torch.testing.assert_close(a, b, atol=1e-10, rtol=0)


@pytest.mark.parametrize("T", [1, 128, 384])
def test_launch_counts(T):
    """K3: the prenet slice of the residual stack and the gate GEMM's tiled
    weights once (one launch), then two gate GEMMs and the cluster attention
    a step (no gathers), then the heads of every step in one GEMM; K4: the
    two gate recomputes, the query projection and the heads' pull of every
    step once, then four launches a step (the attention LSTM's pull fused
    into the attention's; each dx GEMM one cluster launch, no second
    reduction pass)."""
    assert td.forward_launches(T) == 2 + 3 * T
    assert td.backward_launches(T) == 4 + 4 * T


@pytest.mark.parametrize("B,sms,S", [(32, 132, 4), (16, 132, 8), (64, 132, 2), (1, 132, 8),
                                     (33, 132, 4), (34, 132, 2), (132, 132, 1), (500, 132, 1), (32, 114, 2)])
def test_cluster_size(B, sms, S):
    """The largest power of two up to 8 (the portable cluster size) with
    B * S <= the SM count, at least 1: one wave of clusters."""
    assert td.cluster_size(B, sms) == S
    assert S == 1 or B * S <= sms


def test_cluster_size_refuses_empty():
    for B, sms in ((0, 132), (32, 0)):
        with pytest.raises(ValueError):
            td.cluster_size(B, sms)


@pytest.mark.parametrize("S,H,A,D,K,ok", [
    (4, 1024, 128, 512, 31, True),     # the flagship dims at B = 32
    (8, 1024, 128, 512, 31, True),
    (3, 1024, 128, 512, 31, False),    # not a cluster size the kernels take
    (16, 1024, 128, 512, 31, False),   # beyond the portable cluster size
    (8, 1024, 4 * 6, 512, 31, False),  # A / S not whole
    (4, 1024, 128, 512, 30, False),    # an even window has no centre
    (4, 1024, 96, 512, 31, False),     # A does not divide 512 threads
    (4, 1000, 128, 512, 31, False),    # H % (8 S)
    (4, 1024, 128, 508, 31, False),    # D not in 16-byte groups
])
def test_check_cluster_dims(S, H, A, D, K, ok):
    if ok:
        td.check_cluster_dims(S, H, A, D, K)
    else:
        with pytest.raises(ValueError):
            td.check_cluster_dims(S, H, A, D, K)
