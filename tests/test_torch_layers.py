"""The port's layers (tacotron2_tpu_torch/models/layers.py) against their
JAX counterparts (tacotron2_tpu/models/layers.py) on the CPU, in f32 and,
for the BiLSTM and the whole encoder, under the bf16 policy. Inputs and
weights are made with numpy from a seed; weights cross in each framework's
own layout. Tolerance 1e-5 abs (f32 rounding of one op) unless stated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.models import layers as jl
from tacotron2_tpu_torch.models import layers as tl

torch.set_num_threads(1)
ATOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


@pytest.mark.parametrize("bias", [True, False])
def test_linear(bias):
    r = _rng(1)
    x = r.standard_normal((3, 5, 24)).astype(np.float32)
    w = (r.standard_normal((24, 16)) * 0.2).astype(np.float32)  # JAX (in, out)
    b = r.standard_normal(16).astype(np.float32)
    p = {"w": jnp.asarray(w)} | ({"b": jnp.asarray(b)} if bias else {})
    ref = jl.linear_apply(p, jnp.asarray(x))
    got = tl.linear(torch.as_tensor(x), torch.as_tensor(w.T), torch.as_tensor(b) if bias else None)
    _close(got, ref)


def test_linear_bf16_policy():
    """bf16 operands with f32 sums on both sides."""
    r = _rng(2)
    x = r.standard_normal((4, 64)).astype(np.float32)
    w = (r.standard_normal((64, 32)) * 0.2).astype(np.float32)
    ref = jl.linear_apply({"w": jnp.asarray(w)}, jnp.asarray(x),
                          jl.Policy.from_string("bf16-mixed"))
    got = tl.linear(torch.as_tensor(x), torch.as_tensor(w.T), None,
                    tl.Policy.from_string("16-mixed"))
    _close(got, ref, atol=1e-5 * float(np.abs(np.asarray(ref)).max()))


@pytest.mark.parametrize("k,dilation,padding", [(5, 1, "SAME"), (31, 1, "SAME"), (7, 3, "SAME"),
                                                (7, 1, 3), (3, 5, 5)])
def test_conv1d(k, dilation, padding):
    r = _rng(3)
    x = r.standard_normal((2, 40, 8)).astype(np.float32)
    w = (r.standard_normal((k, 8, 12)) * 0.2).astype(np.float32)  # WIO
    b = r.standard_normal(12).astype(np.float32)
    ref = jl.conv1d_apply({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
                          padding=padding, dilation=dilation)
    got = tl.conv1d(torch.as_tensor(x), torch.as_tensor(w.transpose(2, 1, 0).copy()),
                    torch.as_tensor(b), padding=padding, dilation=dilation)
    _close(got, ref)


@pytest.mark.parametrize("u,k", [(8, 16), (2, 4), (4, 8)])
def test_conv_transpose1d(u, k):
    r = _rng(4)
    x = r.standard_normal((2, 11, 16)).astype(np.float32)
    w = (r.standard_normal((k, 16, 8)) * 0.2).astype(np.float32)  # WIO
    b = r.standard_normal(8).astype(np.float32)
    pad = (k - u) // 2
    ref = jl.conv_transpose1d_apply({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
                                    stride=u, padding=pad)
    got = tl.conv_transpose1d(torch.as_tensor(x), torch.as_tensor(w.transpose(1, 2, 0).copy()),
                              torch.as_tensor(b), stride=u, padding=pad)
    assert got.shape[1] == (11 - 1) * u - 2 * pad + k
    _close(got, ref)


def test_embedding():
    r = _rng(5)
    table = r.standard_normal((21, 8)).astype(np.float32)
    idx = r.integers(0, 21, size=(2, 9))
    ref = jl.embedding_apply({"table": jnp.asarray(table)}, jnp.asarray(idx))
    _close(tl.embedding(torch.as_tensor(idx), torch.as_tensor(table)), ref, atol=0)


def test_batchnorm_eval():
    r = _rng(6)
    x = r.standard_normal((2, 7, 10)).astype(np.float32)
    scale, bias, mean = (r.standard_normal(10).astype(np.float32) for _ in range(3))
    var = r.uniform(0.5, 2.0, 10).astype(np.float32)
    ref, _ = jl.batchnorm_apply({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                                {"mean": jnp.asarray(mean), "var": jnp.asarray(var)},
                                jnp.asarray(x), train=False)
    got = tl.batchnorm_eval(*(torch.as_tensor(a) for a in (x, scale, bias, mean, var)))
    _close(got, ref)


def _lstm_params(r, n_in, hidden):
    return {k: (r.standard_normal(s) * 0.3).astype(np.float32) for k, s in (
        ("w_ih", (n_in, 4 * hidden)), ("w_hh", (hidden, 4 * hidden)),
        ("b_ih", (4 * hidden,)), ("b_hh", (4 * hidden,)))}


def _torch_lstm(p):
    return (torch.as_tensor(p["w_ih"].T.copy()), torch.as_tensor(p["w_hh"].T.copy()),
            torch.as_tensor(p["b_ih"]), torch.as_tensor(p["b_hh"]))


def test_lstm_cell():
    r = _rng(7)
    p = _lstm_params(r, 12, 16)
    x = r.standard_normal((3, 12)).astype(np.float32)
    h, c = (r.standard_normal((3, 16)).astype(np.float32) for _ in range(2))
    jp = jax.tree.map(jnp.asarray, p)
    rh, rc = jl.lstm_cell_apply(jp, jnp.asarray(x), (jnp.asarray(h), jnp.asarray(c)))
    gh, gc = tl.lstm_cell(torch.as_tensor(x), (torch.as_tensor(h), torch.as_tensor(c)),
                          *_torch_lstm(p))
    _close(gh, rh)
    _close(gc, rc)


@pytest.mark.parametrize("policy", ["32-true", "bf16-mixed"])
@pytest.mark.parametrize("lengths", [[9, 6, 1], [9, 9, 9], [4, 9, 7]])
def test_bilstm_packed(lengths, policy):
    """Packed semantics with padded rows against the JAX package's
    lstm_sequence run forward and reverse under the same policy: each row's
    reverse direction starts at its own last valid char; outputs past a
    row's end are 0. Under 32-true ``bilstm`` is ``bilstm_rows`` (two
    unidirectional f32 LSTMs over every row, the reverse one over each
    row's reversed valid prefix); under bf16 its loop rounds h and the operands as
    JAX does, and the products of bf16 operands are exact in f32, so only
    the sum order differs: held to the same 1e-5 (readings <= 6e-8)."""
    r = _rng(8)
    pf, pb = _lstm_params(r, 10, 8), _lstm_params(r, 10, 8)
    x = r.standard_normal((3, 9, 10)).astype(np.float32)
    lens = np.asarray(lengths)
    ref = np.concatenate([
        np.asarray(jl.lstm_sequence(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                    jnp.asarray(lens), reverse=rev,
                                    policy=jl.Policy.from_string(policy)))
        for p, rev in ((pf, False), (pb, True))], axis=-1)
    lstm = torch.nn.LSTM(10, 8, batch_first=True, bidirectional=True)
    with torch.no_grad():
        for suffix, p in (("", pf), ("_reverse", pb)):
            for name, t in zip(("weight_ih", "weight_hh", "bias_ih", "bias_hh"), _torch_lstm(p)):
                getattr(lstm, f"{name}_l0{suffix}").copy_(t)
    got = tl.bilstm(lstm, torch.as_tensor(x), torch.as_tensor(lens), tl.Policy.from_string(policy))
    _close(got, ref)
    for b, n in enumerate(lengths):
        assert not bool(got[b, n:].any())


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("policy", ["32-true", "bf16-mixed"])
def test_encoder_matches_jax(policy, train):
    """The whole encoder (embedding, three conv -> BatchNorm -> ReLU blocks,
    the BiLSTM) against ``tacotron2_tpu/models/encoder.py::apply`` on the
    same weights, with ragged lengths; in train mode the BatchNorm runs on
    the batch's statistics (dropout rate 0, so no bits are drawn). Under
    bf16 both round each conv's sums and the BiLSTM's operands to bf16.
    Readings: 32-true 7.5e-8 (eval), 4.7e-7 (train); bf16-mixed in eval
    mode 4.5e-8 (1.6e-4 before
    the port rounded as JAX does: the BiLSTM in f32, the convs' sums
    unrounded); all held to 1e-5. In train mode under bf16 the batch
    statistics differ at f32 rounding (torch's and XLA's reduction orders),
    which flips the bf16 rounding of a few inputs of the next conv, and the
    next BatchNorm amplifies the flip: reads 2.2e-4, held to 1e-3."""
    from tacotron2_tpu.models import encoder as je
    from tacotron2_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
    from tacotron2_tpu.models.tacotron2 import Tacotron2Config as JaxConfig
    from tacotron2_tpu_torch.convert import from_jax_params
    from tacotron2_tpu_torch.models.encoder import Encoder

    cfg = dict(num_chars=20, encoded_dim=64, encoder_kernel_size=5, num_mels=16, prenet_dim=32,
               att_rnn_dim=64, att_dim=32, rnn_hidden_dim=64, postnet_dim=16)
    params, state = JaxTacotron2(JaxConfig(**cfg)).init(jax.random.PRNGKey(0))
    sd = from_jax_params(params, state)
    enc = Encoder(cfg["num_chars"], cfg["encoded_dim"], cfg["encoder_kernel_size"])
    enc.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()
                         if k.startswith("encoder.")})
    r = _rng(9)
    lens = np.array([11, 7, 1, 10])
    chars = r.integers(1, 21, size=(4, 11))
    chars[np.arange(11)[None, :] >= lens[:, None]] = 0
    ref, _ = je.apply(params["encoder"], state["encoder"], jnp.asarray(chars), jnp.asarray(lens),
                      train, 0.0, rng=jax.random.PRNGKey(1),
                      policy=jl.Policy.from_string(policy))
    with torch.no_grad():
        got = enc(torch.as_tensor(chars), torch.as_tensor(lens), tl.Policy.from_string(policy),
                  train=train, dropout=0.0)
    _close(got, ref, 1e-3 if train and policy == "bf16-mixed" else ATOL)
