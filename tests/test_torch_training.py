"""The port's training pieces (``tacotron2_tpu_torch/training``, the train
mode of the models) against their JAX counterparts on the CPU:

- BatchNorm in train mode (output and new running stats) against
  ``batchnorm_apply``;
- ``tacotron2_loss``;
- the encoder's embedding init (N(0, 0.5), padding row 0) against
  ``embedding_init``, and the speaker embedding's (N(0, 0.5)) against the
  JAX model's;
- three optimizer steps that cross a milestone (clip 1.0, Adam with coupled
  weight decay, MultiStepLR) against ``make_optimizer``'s optax chain on the
  same gradients;
- ``forward_teacher`` in train mode (``cfg.dropout`` 0, the LSTM masks
  injected) against JAX ``forward_teacher(dw_hoist=True, pallas_train=True)``,
  outputs and BatchNorm state, under 32-true and bf16;
- two whole train steps against JAX ``build_train_step(pallas_train=True)``:
  losses, ``grad_norm``, parameters and BatchNorm state after each step.
  The JAX step folds its step count into the rng; the injected masks are
  derived the same way.

Weights come from the JAX ``init`` through ``convert.from_jax_params``;
inputs from numpy. Each tolerance is stated where it is used.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tacotron2_tpu.models import layers as jl
from tacotron2_tpu.models.layers import Policy as JaxPolicy
from tacotron2_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from tacotron2_tpu.models.tacotron2 import Tacotron2Config as JaxConfig
from tacotron2_tpu.ops import train_scan
from tacotron2_tpu.training.losses import tacotron2_loss as jax_loss
from tacotron2_tpu.training.optimizer import make_optimizer as jax_optimizer
from tacotron2_tpu.training.step import build_train_step
from tacotron2_tpu.training.train_state import TrainState
from tacotron2_tpu_torch.convert import from_jax_params
from tacotron2_tpu_torch.models import layers as tl
from tacotron2_tpu_torch.models.layers import Policy
from tacotron2_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from tacotron2_tpu_torch.training import losses, optimizer, step

torch.set_num_threads(1)

CFG = dict(num_chars=16, encoded_dim=32, encoder_kernel_size=5, num_mels=16, prenet_dim=16,
           att_rnn_dim=32, att_dim=16, rnn_hidden_dim=32, postnet_dim=16, dropout=0.0)
B, L, T, H = 2, 9, 24, 32


def _np(t):
    return t.detach().double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, ref, atol, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float64), rtol=0, atol=atol,
                               err_msg=what)


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 9, 8), (3, 40, 5)])
def test_batchnorm_train_mode(shape):
    r = np.random.default_rng(0)
    x = (r.standard_normal(shape) * 2 + 1).astype(np.float32)
    C = shape[-1]
    scale, bias = r.standard_normal(C).astype(np.float32), r.standard_normal(C).astype(np.float32)
    mean0, var0 = r.standard_normal(C).astype(np.float32), r.uniform(0.5, 2, C).astype(np.float32)
    y_ref, st = jl.batchnorm_apply({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                                   {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)},
                                   jnp.asarray(x), train=True)
    bn = torch.nn.BatchNorm1d(C)
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(scale))
        bn.bias.copy_(torch.as_tensor(bias))
        bn.running_mean.copy_(torch.as_tensor(mean0))
        bn.running_var.copy_(torch.as_tensor(var0))
    y = tl.batchnorm(torch.as_tensor(x), bn, train=True)
    _close(y, y_ref, 1e-5, "output")  # f32 rounding of the normalization
    _close(bn.running_mean, st["mean"], 1e-6, "running_mean")
    _close(bn.running_var, st["var"], 1e-6, "running_var")
    y_eval = tl.batchnorm(torch.as_tensor(x), bn, train=False)  # eval reads the new stats
    ref_eval, _ = jl.batchnorm_apply({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, st,
                                     jnp.asarray(x), train=False)
    _close(y_eval, ref_eval, 1e-5, "eval output")


def test_encoder_embedding_init_matches_jax():
    """The encoder inits its embedding as the JAX encoder does: N(0, 0.5)
    with the padding row 0. The draws differ, so the statistics are held
    (100k entries: the std's standard error is ~0.0011, held to 0.02)."""
    from tacotron2_tpu_torch.models.encoder import Encoder

    torch.manual_seed(0)
    got = Encoder(399, 256, 5).embedding.weight.detach().numpy()
    ref = np.asarray(jl.embedding_init(jax.random.PRNGKey(0), 400, 256, std=0.5,
                                       padding_idx=0)["table"])
    assert got.shape == ref.shape
    for table in (got, ref):
        assert not table[0].any()
        assert abs(table[1:].std() - 0.5) < 0.02 and abs(table[1:].mean()) < 0.02


def test_speaker_embedding_init_matches_jax():
    """The speaker embedding inits as the JAX package's (N(0, 0.5), no
    padding row), from the module RNG ``do_train`` seeds; 100k entries, as
    the encoder's test."""
    torch.manual_seed(0)
    cfg = dict(num_chars=8, encoded_dim=256, speaker_tokens=True, num_speakers=400)
    got = Tacotron2(Tacotron2Config(**cfg)).speaker_embedding.weight.detach().numpy()
    params, _ = JaxTacotron2(JaxConfig(**cfg)).init(jax.random.PRNGKey(0))
    ref = np.asarray(params["speaker_embedding"]["table"])
    assert got.shape == ref.shape
    for table in (got, ref):
        assert abs(table.std() - 0.5) < 0.02 and abs(table.mean()) < 0.02


def test_tacotron2_loss_matches_jax():
    r = np.random.default_rng(1)
    mels, post, tgt = (r.standard_normal((2, 12, 16)).astype(np.float32) for _ in range(3))
    gates = r.standard_normal((2, 12, 1)).astype(np.float32) * 3
    gates[1, 8:] = -1000.0  # masked logits against a padded target of 0
    gate_t = np.ones((2, 12, 1), np.float32)
    gate_t[0, -1], gate_t[1, 7:] = 0.0, 0.0
    ref_loss, ref = jax_loss(*(jnp.asarray(a) for a in (mels, post, gates, tgt, gate_t)))
    loss, got = losses.tacotron2_loss(*(torch.as_tensor(a) for a in (mels, post, gates, tgt,
                                                                       gate_t)))
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], 1e-6, k)


def test_optimizer_three_steps_across_a_milestone():
    """lr 1e-2, weight decay 1e-2, milestone at step 2: steps 0 and 1 at lr,
    step 2 at lr / 10; the step-1 gradient's norm is above the clip."""
    r = np.random.default_rng(2)
    p0 = [r.standard_normal((4, 3)).astype(np.float32), r.standard_normal(5).astype(np.float32)]
    grads = [[(r.standard_normal(p.shape) * s).astype(np.float32) for p in p0]
             for s in (0.1, 3.0, 0.2)]
    tx, _ = jax_optimizer(1e-2, 1e-2, scheduler_milestones=[2], grad_clip=1.0)
    jp = [jnp.asarray(p) for p in p0]
    st = tx.init(jp)
    params = [torch.nn.Parameter(torch.as_tensor(p.copy())) for p in p0]
    opt, sched = optimizer.make_optimizer(params, 1e-2, 1e-2, [2])
    for i, g in enumerate(grads):
        upd, st = tx.update([jnp.asarray(x) for x in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(params, g):
            p.grad = torch.as_tensor(x.copy())
        norm = optimizer.apply_gradients(params, opt, sched)
        _close(norm, np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in g)), 1e-5, "norm")
        for p, q in zip(params, jp):
            # Adam's f32 update, two libraries' operation orders; torch's
            # clip adds 1e-6 to the norm
            _close(p, q, 2e-6, f"step {i}")
    assert sched.get_last_lr()[0] == pytest.approx(1e-3)


# ---------------------------------------------------------------------------


def _batch(seed=0):
    r = np.random.default_rng(seed)
    chars = r.integers(1, 16, size=(B, L)).astype(np.int64)
    chars[1, 6:] = 0
    mel = (r.standard_normal((B, T, 16)) * 0.5).astype(np.float32)
    mel[1, T - 6:] = 0.0
    gate = np.ones((B, T, 1), np.float32)
    gate[0, -1], gate[1, T - 7:] = 0.0, 0.0
    return {"chars_idx": chars, "chars_len": np.array([L, 6]), "mel": mel,
            "mel_len": np.array([T, T - 6]), "gate": gate}


def _masks(rng):
    """The LSTM masks JAX's forward_teacher draws from ``rng``."""
    scan_rng = jax.random.split(rng, 5)[3]
    keys = jax.random.split(scan_rng, T)
    m = jax.vmap(lambda k: train_scan._dropout_masks(k, (B, H), True))(keys)
    return tuple(torch.as_tensor(np.array(a)) for a in m)


@functools.lru_cache(maxsize=None)
def _jax_model(policy: str):
    model = JaxTacotron2(JaxConfig(**CFG), JaxPolicy.from_string(policy))
    params, state = model.init(jax.random.PRNGKey(0))
    return model, params, state


def _port_model(params, state, policy: str) -> Tacotron2:
    m = Tacotron2(Tacotron2Config(**CFG), Policy.from_string(policy))
    m.load_state_dict(from_jax_params(params, state))
    return m


def _bn_state_close(model, state, atol, enc_mean_atol=None):
    for part, mods in (("encoder", model.encoder.convolutions), ("postnet", model.postnet.postnet)):
        for i, s in enumerate(state[part]["bns"]):
            bn = mods[4 * i + 1]
            m_atol = enc_mean_atol if part == "encoder" and enc_mean_atol else atol
            _close(bn.running_mean, s["mean"], m_atol, f"{part} bn {i} mean")
            _close(bn.running_var, s["var"], atol, f"{part} bn {i} var")


TEACHER_RNG = 3
INPUTS = ("chars_idx", "chars_len", "mel", "mel_len")


@functools.lru_cache(maxsize=None)
def _jax_teacher(policy: str):
    jm, params, state = _jax_model(policy)
    b = _batch()
    return jm.forward_teacher(params, state, *(jnp.asarray(b[k]) for k in INPUTS),
                              rng=jax.random.PRNGKey(TEACHER_RNG), train=True, dw_hoist=True,
                              pallas_train=True)


@pytest.mark.parametrize("policy", ["32-true", "bf16-mixed"])
def test_forward_teacher_train_mode_matches_jax(policy):
    """32-true: within 3e-5 of each output's max (the JAX training kernels'
    own tolerance). bf16: the two frameworks' f32 reductions (the train-mode
    BatchNorm statistics, the decode's sums) differ in order, which flips
    bf16 roundings downstream, so the port's bf16 output is held within the
    distance of JAX's own bf16 output from JAX's f32 output. Readings, as a
    share of that distance: mels 0.38, mels_post 0.73 (2.6% of its max, the
    postnet's train-mode BatchNorm amplifying the flips), gates 0.40,
    alignments 0.82; the BatchNorm state <= 1.5e-4. Before the encoder and
    the postnet rounded as JAX's (BiLSTM operands, convs' sums) mels_post
    read 4.3% of its max, 1.2x that distance, and the limit was 2x."""
    _, params, state = _jax_model(policy)
    ref, new_state = _jax_teacher(policy)
    model = _port_model(params, state, policy)
    b = _batch()
    with torch.no_grad():
        out = model.forward_teacher(*(torch.as_tensor(b[k]) for k in INPUTS), train=True,
                                    lstm_masks=_masks(jax.random.PRNGKey(TEACHER_RNG)))
    for name in ("mels", "mels_post", "gates", "alignments"):
        r = np.asarray(getattr(ref, name))
        if policy == "32-true":
            atol = 3e-5 * float(np.abs(r).max()) + 1e-6
        else:
            gap = np.abs(r - np.asarray(getattr(_jax_teacher("32-true")[0], name))).max()
            atol = float(gap) + 1e-6
        _close(getattr(out, name), r, atol, name)
    _bn_state_close(model, new_state, 1e-5 if policy == "32-true" else 5e-4)


LR = 1e-3
# the encoder convs' biases feed a train-mode BatchNorm, which removes them:
# their gradient is 0 in exact arithmetic, and Adam scales the rounding
# noise that both frameworks leave there up to steps of ~lr
NOISE_GRAD = tuple(f"encoder.convolutions.{4 * i}.bias" for i in range(3))


def test_two_train_steps_match_jax():
    """Per step: the losses and ``grad_norm`` within 1e-4 relative (the
    second step starts from weights that already differ at f32 rounding);
    every gradient within 1e-4 of its tensor's max (those of ``NOISE_GRAD``
    below 1e-6 on both sides); every weight within 5e-5, 5% of one Adam
    step of lr 1e-3 (elements whose gradient is near Adam's eps amplify f32
    differences of the gradients), and the biases of ``NOISE_GRAD`` within
    two steps; the BatchNorm statistics within 1e-5 (the encoder's running
    means within 2e-4)."""
    jm, params, state = _jax_model("32-true")
    tx, _ = jax_optimizer(LR, 1e-6, scheduler_milestones=[])
    ts = TrainState.create(params, state, tx)
    jstep = jax.jit(build_train_step(jm, tx, pallas_train=True))

    @jax.jit
    def jgrad(p, s, batch, rng):
        def f(p):
            out, _ = jm.forward_teacher(p, s, *(batch[k] for k in INPUTS), rng=rng, train=True,
                                        dw_hoist=True, pallas_train=True)
            return jax_loss(out.mels, out.mels_post, out.gates, batch["mel"], batch["gate"])[0]
        return jax.grad(f)(p)

    rng = jax.random.PRNGKey(11)
    model = _port_model(params, state, "32-true")
    opt, sched = optimizer.make_optimizer(model.parameters(), LR, 1e-6)
    for i, b in enumerate([_batch(0), _batch(1)]):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        g_ref = from_jax_params(jax.tree.map(np.asarray, jgrad(ts.params, ts.model_state, jb,
                                                               jax.random.fold_in(rng, i))), None)
        ts, ref = jstep(ts, jb, rng)
        masks = _masks(jax.random.fold_in(rng, i))
        got = step.train_step(model, opt, sched, step.to_device(b, "cpu"), lstm_masks=masks)
        for k in ("loss", "gate_loss", "mel_loss", "mel_post_loss", "grad_norm"):
            _close(got[k], ref[k], 1e-4 * abs(float(ref[k])) + 1e-7, f"step {i} {k}")
        unclip = max(1.0, float(got["grad_norm"]) + 1e-6)  # clip_grad_norm_ scaled p.grad
        named = dict(model.named_parameters())
        sd = from_jax_params(jax.tree.map(np.asarray, ts.params), None)
        for k, v in sd.items():
            g = g_ref[k].numpy()
            if k in NOISE_GRAD:  # both zero up to rounding
                assert max(np.abs(g).max(), float(named[k].grad.abs().max())) < 1e-6, k
            else:
                _close(named[k].grad * unclip, g, 1e-4 * float(np.abs(g).max()) + 1e-8,
                       f"step {i} grad {k}")
            _close(named[k], v.numpy(), 2 * LR if k in NOISE_GRAD else 5e-5, f"step {i} {k}")
        # the encoder BNs' running means carry their conv's bias (momentum
        # 0.1), so they inherit its two-step bound times 0.1
        _bn_state_close(model, jax.tree.map(np.asarray, ts.model_state), 1e-5, 0.2 * LR)
