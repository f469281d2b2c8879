"""The prosody predictor and its uses in the port (``models/prosody.py``,
``training/losses.py``' CCC and style loss, ``run/train_prosody.py``, the
style-loss phase of ``run/train.py``) against the JAX package on the CPU:

- ``ProsodyPredictor`` against JAX ``apply`` in f32 on weights carried by
  ``convert.prosody_from_jax_params``: features, low, mid and high within
  1e-5 of each tensor's max, with ragged lengths, GRU and LSTM, with and
  without deltas, odd and even frame counts;
- ``compute_deltas`` against JAX's (1e-6);
- ``ccc_per_feature`` and the CCC loss (1e-5), and ``prosody_style_loss``
  of both kinds with its gradient in ``mels_post`` (1e-4 relative);
- one ``train_prosody`` step against JAX ``make_prosody_train_step``
  (dropout off, lr 1e-3): loss and prediction within 1e-5, every weight
  within 5e-5 (5% of one Adam step);
- two style-phase train steps against JAX ``build_train_step(prosody=...)``
  with ``test_two_train_steps_match_jax``'s bounds, ``style_loss`` within
  1e-4 relative, the predictor unchanged;
- the ``train_prosody`` CLI on a tiny corpus (its checkpoint, the CCC
  scalars logged), then ``train`` of a prosody-model config with
  it: ``style_loss`` from step ``int(max_steps * active_after) + 1`` on and
  not before, the predictor's weights unchanged, and the refusal without
  ``--prosody-model-checkpoint``;
- without a card, ``train_prosody`` and ``train`` raise unless asked for
  the CPU.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from run.train_prosody import make_prosody_train_step
from tacotron2_tpu.models.prosody import ProsodyPredictor as JaxPredictor
from tacotron2_tpu.models.prosody import compute_deltas as jax_deltas
from tacotron2_tpu.training import losses as jl
from tacotron2_tpu.training.optimizer import make_optimizer as jax_optimizer
from tacotron2_tpu.training.step import build_train_step
from tacotron2_tpu.training.train_state import TrainState
from tacotron2_tpu_torch.__main__ import main as cli
from tacotron2_tpu_torch.convert import from_jax_params, prosody_from_jax_params
from tacotron2_tpu_torch.models.prosody import ProsodyPredictor, compute_deltas
from tacotron2_tpu_torch.run.train_prosody import prosody_train_step
from tacotron2_tpu_torch.training import checkpoint as ckpt_lib
from tacotron2_tpu_torch.training import losses, optimizer, step
from tests.test_prosody_training import FEATS, _raw_cfg, _tiny_corpus
from tests.test_torch_training import (INPUTS, LR, _batch, _bn_state_close, _jax_model, _masks,
                                       _port_model)

torch.set_num_threads(1)

M = 16  # the tiny Tacotron's mels


def _np(t):
    return t.detach().double().numpy()


def _close(got, ref, atol, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float64), rtol=0, atol=atol,
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def _jax_predictor(use_lstm=False, use_deltas=True, rnn_dropout=0.5):
    jp = JaxPredictor(num_mels=M, rnn_in_dim=24, use_lstm=use_lstm, use_deltas=use_deltas,
                      num_features=3, rnn_dropout=rnn_dropout)
    return jp, jax.tree.map(np.asarray, jp.init(jax.random.PRNGKey(1)))


def _port_predictor(use_lstm=False, use_deltas=True, rnn_dropout=0.5):
    jp, params = _jax_predictor(use_lstm, use_deltas, rnn_dropout)
    p = ProsodyPredictor(num_mels=M, rnn_in_dim=24, use_lstm=use_lstm, use_deltas=use_deltas,
                         num_features=3, rnn_dropout=rnn_dropout)
    p.load_state_dict(prosody_from_jax_params(params))
    return p


def _mels(B, T, seed=0):
    return np.random.default_rng(seed).standard_normal((B, T, M)).astype(np.float32)


@pytest.mark.parametrize("use_lstm", [False, True], ids=["gru", "lstm"])
@pytest.mark.parametrize("use_deltas", [True, False], ids=["deltas", "plain"])
@pytest.mark.parametrize("T", [23, 32])
def test_predictor_matches_jax(use_lstm, use_deltas, T):
    jp, params = _jax_predictor(use_lstm, use_deltas)
    mels, lens = _mels(3, T), np.array([T, T - 7, 5])
    ref = jp.apply(params, jnp.asarray(mels), jnp.asarray(lens))
    with torch.no_grad():
        got = _port_predictor(use_lstm, use_deltas)(torch.as_tensor(mels), torch.as_tensor(lens))
    for name, g, r in zip(("features", "low", "mid", "high"), got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape, name
        _close(g, r, 1e-5 * max(1.0, float(np.abs(r).max())), name)
    assert not got[2][2, 6:].any()  # mid is zero past a row's (even-padded) length


def test_compute_deltas_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 5, 17)).astype(np.float32)
    _close(compute_deltas(torch.as_tensor(x)), jax_deltas(jnp.asarray(x)), 1e-6)


def test_ccc_matches_jax():
    r = np.random.default_rng(3)
    y = r.standard_normal((64, 3)).astype(np.float32)
    p = (0.5 * y + 0.3 * r.standard_normal((64, 3))).astype(np.float32)
    _close(losses.ccc_per_feature(torch.as_tensor(p), torch.as_tensor(y)),
           jl.ccc_per_feature(jnp.asarray(p), jnp.asarray(y)), 1e-5)
    _close(losses.concordance_correlation_coefficient_loss(torch.as_tensor(p),
                                                           torch.as_tensor(y)),
           jl.concordance_correlation_coefficient_loss(jnp.asarray(p), jnp.asarray(y)), 1e-5)


@pytest.mark.parametrize("kind", ["mse", "ccc"])
def test_style_loss_and_its_gradient_match_jax(kind):
    jp, params = _jax_predictor()
    post, target = _mels(2, 30, 4), _mels(2, 30, 5)
    lens = np.array([30, 21])
    f = lambda x: jl.prosody_style_loss(jp, params, x, jnp.asarray(target), jnp.asarray(lens),
                                        kind)
    ref, ref_grad = jax.value_and_grad(f)(jnp.asarray(post))
    pred = _port_predictor().requires_grad_(False)
    x = torch.as_tensor(post).requires_grad_()
    got = losses.prosody_style_loss(pred, x, torch.as_tensor(target), torch.as_tensor(lens), kind)
    got.backward()
    _close(got, ref, 1e-4 * abs(float(ref)))
    _close(x.grad, ref_grad, 1e-4 * float(np.abs(np.asarray(ref_grad)).max()))
    assert all(p.grad is None for p in pred.parameters())


def test_train_prosody_step_matches_jax():
    jp, params = _jax_predictor(rnn_dropout=0.0)
    tx, _ = jax_optimizer(1e-3, weight_decay=0.0, scheduler_milestones=[65], grad_clip=1e9)
    r = np.random.default_rng(6)
    batch = {"mel": _mels(3, 26, 7), "mel_len": np.array([26, 19, 12]),
             "features": r.uniform(-1, 1, (3, 3)).astype(np.float32)}
    new, _, ref_loss, ref_pred = make_prosody_train_step(jp, tx)(
        params, tx.init(params), {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    pred = _port_predictor(rnn_dropout=0.0)
    opt = torch.optim.Adam(pred.parameters(), lr=1e-3)
    sched = torch.optim.lr_scheduler.MultiStepLR(opt, [65], 0.1)
    loss, out = prosody_train_step(pred, opt, sched, {k: torch.as_tensor(v)
                                                      for k, v in batch.items()})
    _close(loss, ref_loss, 1e-5)
    _close(out, ref_pred, 1e-5)
    want = prosody_from_jax_params(jax.tree.map(np.asarray, new))
    for k, v in pred.state_dict().items():
        _close(v, want[k].numpy(), 5e-5, k)


NOISE = 1e-6  # gradients under it are f32 noise, which Adam scales up to steps of ~lr


@pytest.mark.parametrize("kind", ["mse", "ccc"])
def test_two_style_phase_train_steps_match_jax(kind):
    """``test_two_train_steps_match_jax`` with the frozen predictor's style
    loss added, and its bounds: the losses, ``style_loss`` and ``grad_norm``
    within 1e-4 relative, every gradient of the first step within 1e-4 of
    its tensor's max or both under ``NOISE`` (the second step starts from
    weights that differ by up to two steps where the gradient is noise, and
    its gradients read up to 1.7e-4 of their max), every weight within
    5e-5, but where JAX's gradient was under ``NOISE`` at some step (the
    encoder convs' biases before a train-mode BatchNorm, and a few elements
    elsewhere: one of 5,120 of the last encoder conv's weight read 6.7e-5
    with gradients of 2e-8 and -7e-8) within two steps; the BatchNorm
    statistics as there; the predictor unchanged."""
    jm, params, state = _jax_model("32-true")
    jp, p_params = _jax_predictor()
    prosody = (jp, jax.tree.map(jnp.asarray, p_params), kind)
    tx, _ = jax_optimizer(LR, 1e-6, scheduler_milestones=[])
    ts = TrainState.create(params, state, tx)
    jstep = jax.jit(build_train_step(jm, tx, pallas_train=True, prosody=prosody))

    @jax.jit
    def jgrad(p, s, batch, rng):
        def f(p):
            out, _ = jm.forward_teacher(p, s, *(batch[k] for k in INPUTS), rng=rng, train=True,
                                        dw_hoist=True, pallas_train=True)
            loss = jl.tacotron2_loss(out.mels, out.mels_post, out.gates, batch["mel"],
                                     batch["gate"])[0]
            return loss + jl.prosody_style_loss(jp, prosody[1], out.mels_post, batch["mel"],
                                                batch["mel_len"], kind)
        return jax.grad(f)(p)

    model = _port_model(params, state, "32-true")
    pred = _port_predictor().requires_grad_(False)
    start = {k: v.clone() for k, v in pred.state_dict().items()}
    opt, sched = optimizer.make_optimizer(model.parameters(), LR, 1e-6)
    rng, noisy = jax.random.PRNGKey(11), {}
    for i, b in enumerate([_batch(0), _batch(1)]):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        g_ref = from_jax_params(jax.tree.map(np.asarray, jgrad(ts.params, ts.model_state, jb,
                                                               jax.random.fold_in(rng, i))), None)
        ts, ref = jstep(ts, jb, rng)
        got = step.train_step(model, opt, sched, step.to_device(b, "cpu"),
                              lstm_masks=_masks(jax.random.fold_in(rng, i)), style=(pred, kind))
        for k in ("loss", "style_loss", "tacotron_loss", "grad_norm"):
            _close(got[k], ref[k], 1e-4 * abs(float(ref[k])) + 1e-7, f"step {i} {k}")
        unclip = max(1.0, float(got["grad_norm"]) + 1e-6)  # clip_grad_norm_ scaled p.grad
        named = dict(model.named_parameters())
        for k, v in from_jax_params(jax.tree.map(np.asarray, ts.params), None).items():
            g, gp = g_ref[k].numpy(), _np(named[k].grad * unclip)
            noise = np.abs(g) < NOISE
            assert i > 0 or ((np.abs(gp - g) <= 1e-4 * float(np.abs(g).max()) + 1e-8)
                             | (noise & (np.abs(gp) < NOISE))).all(), f"grad {k}"
            noisy[k] = noisy.get(k, False) | noise  # an element noisy once stays apart
            tol = np.where(noisy[k], 2 * LR, 5e-5)
            assert (np.abs(_np(named[k]) - v.numpy()) <= tol).all(), f"step {i} {k}"
        _bn_state_close(model, jax.tree.map(np.asarray, ts.model_state), 1e-5, 0.2 * LR)
    assert all(torch.equal(v, start[k]) for k, v in pred.state_dict().items())


# ---------------------------------------------------------------------------
# the CLI


def _prosody_config(tmp_path, active):
    speech, csv = _tiny_corpus(tmp_path)
    raw = _raw_cfg(csv, {"prosody_model": {"active": active, "active_after": 0.5,
                                           "features": FEATS}})
    cfg = tmp_path / f"cfg-{active}.json"
    cfg.write_text(json.dumps(raw))
    return speech, str(cfg)


def test_train_prosody_then_the_style_phase(tmp_path, monkeypatch):
    speech, cfg = _prosody_config(tmp_path, False)
    out = cli(["train_prosody", "--config", cfg, "--speech-dir", str(speech), "--results-dir",
               str(tmp_path / "p"), "--steps", "3", "--batch-size", "2", "--device", "cpu"])
    assert out["checkpoint"] == str(tmp_path / "p" / "prosody_final.ckpt")
    assert out["features"] == FEATS and [s["step"] for s in out["steps"]] == [1, 2, 3]
    assert all(np.isfinite(s["loss"]) for s in out["steps"])
    logs = tmp_path / "p" / "lightning_logs" / "prosody"
    assert len(list(logs.glob("events.out.tfevents.*"))) == 1
    tags = set().union(*(json.loads(x) for x in (logs / "metrics.jsonl").read_text().splitlines()))
    assert {"train_loss", "lr", "val_loss"} | {f"{s}_{f}" for s in ("train", "val")
                                                 for f in FEATS} <= tags
    predictor = ckpt_lib.load_prosody_checkpoint(out["checkpoint"])
    assert predictor.num_features == len(FEATS) and predictor.num_mels == M
    assert not any(p.requires_grad for p in predictor.parameters())

    speech, style_cfg = _prosody_config(tmp_path, True)
    base = ["train", "--config", style_cfg, "--speech-dir", str(speech), "--device", "cpu"]
    with pytest.raises(ValueError, match="no prosody model checkpoint"):
        cli(base + ["--results-dir", str(tmp_path / "refused")])
    loaded = []
    load = ckpt_lib.load_prosody_checkpoint
    monkeypatch.setattr(ckpt_lib, "load_prosody_checkpoint",
                        lambda path: loaded.append(load(path)) or loaded[-1])
    res = cli(base + ["--results-dir", str(tmp_path / "s"), "--prosody-model-checkpoint",
                      out["checkpoint"]])
    steps = res["steps"]
    assert [s["step"] for s in steps] == [1, 2, 3, 4]
    assert ["style_loss" in s for s in steps] == [False, False, True, True]
    assert all(np.isfinite(s["style_loss"]) and s["style_loss"] >= 0 for s in steps[2:])
    saved = torch.load(out["checkpoint"], map_location="cpu", weights_only=False)["state_dict"]
    assert all(torch.equal(v, saved[k]) for k, v in loaded[0].state_dict().items())


def test_train_prosody_and_train_run_on_the_card_unless_asked(tmp_path, monkeypatch):
    """Without a card both entries raise unless given ``device="cpu"``."""
    from tacotron2_tpu_torch.config import config_from_dict
    from tacotron2_tpu_torch.run.train import do_train
    from tacotron2_tpu_torch.run.train_prosody import do_train_prosody

    speech, cfg = _prosody_config(tmp_path, False)
    raw = json.loads(open(cfg).read())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        do_train_prosody(config_from_dict(json.loads(open(cfg).read())), raw, str(speech),
                         str(tmp_path / "p"))
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        do_train(config_from_dict(json.loads(open(cfg).read())), raw, str(speech),
                 str(tmp_path / "t"))
    assert not (tmp_path / "p").exists() and not (tmp_path / "t").exists()
