"""The JAX package's Orbax checkpoints read by the port
(``tacotron2_tpu_torch/training/orbax.py``, ``convert.lightning_from_orbax``,
``python -m tacotron2_tpu_torch convert``), on the CPU; skipped where
``tensorstore`` is absent.

- JAX's ``save_checkpoint`` writes a vanilla, a controllable, a description
  and a GST model (tiny widths) and a ``train_prosody`` predictor: the port's
  reader and ``convert`` give state dicts equal bit for bit to
  ``from_jax_params`` / ``prosody_from_jax_params`` of the same trees, and the
  same ``model_config_from``;
- two JAX train steps saved with their optimizer state: the port resumed
  from the converted ``.ckpt`` (and from the directory) takes JAX's third
  step within the two-step test's tolerances, the schedule's milestone
  crossed at the same step;
- a finetune's ``multi_transform`` state gives JAX's warning and the
  weights alone;
- ``say`` from the directory equals ``say`` from the converted ``.ckpt``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("tensorstore")

from run.common import build_model as jax_build_model  # noqa: E402
from tacotron2_tpu.config import config_from_dict as jax_config  # noqa: E402
from tacotron2_tpu.models.prosody import ProsodyPredictor as JaxPredictor  # noqa: E402
from tacotron2_tpu.training.checkpoint import save_checkpoint  # noqa: E402
from tacotron2_tpu.training.optimizer import make_optimizer as jax_optimizer  # noqa: E402
from tacotron2_tpu.training.step import build_train_step  # noqa: E402
from tacotron2_tpu.training.train_state import TrainState  # noqa: E402
from tacotron2_tpu_torch.__main__ import main as cli  # noqa: E402
from tacotron2_tpu_torch.config import config_from_dict  # noqa: E402
from tacotron2_tpu_torch.convert import (from_jax_params, lightning_from_orbax,  # noqa: E402
                                         load_strict, load_tacotron2_checkpoint,
                                         prosody_from_jax_params)
from tacotron2_tpu_torch.models.tacotron2 import Tacotron2  # noqa: E402
from tacotron2_tpu_torch.run.say import model_config_from  # noqa: E402
from tacotron2_tpu_torch.training import checkpoint as ckpt_lib  # noqa: E402
from tacotron2_tpu_torch.training import optimizer, step  # noqa: E402
from tests.test_torch_training import LR, NOISE_GRAD, _batch, _close, _masks  # noqa: E402

torch.set_num_threads(1)

CHARS = "!'(),.:;? \\-abcdefghijklmnopqrstuvwxyz"


def _raw(kind: str) -> dict:
    args = {"encoded_dim": 32, "encoder_kernel_size": 5, "prenet_dim": 16, "att_rnn_dim": 32,
            "att_dim": 16, "rnn_hidden_dim": 32, "postnet_dim": 16, "dropout": 0.0}
    ext = {}
    if kind == "controllable":
        ext = {"controls": {"active": True, "features": ["f0", "f1", "f2"]},
               "speaker_tokens": {"active": True, "num_speakers": 3}}
    elif kind == "description":
        args.update(description_embeddings=True, description_embeddings_dim=24)
        ext = {"speaker_tokens": {"active": True, "num_speakers": 3}}
    elif kind == "gst":
        ext = {"gst": {"active": True, "token_embedding_size": 32}}
    return {"dataset": {"preprocessing": {"allowed_chars": CHARS, "end_token": "^",
                                          "num_mels": 16, "sample_rate": 22050, "trim": False}},
            "training": {"precision": "32-true", "batch_size": 2, "lr": LR,
                         "weight_decay": 1e-6, "name": kind, "args": {"max_steps": 4}},
            "model": {"scheduler_milestones": [0.5], "args": args}, "extensions": ext}


def _jax_checkpoint(tmp_path, kind: str, gate_bias=None):
    raw = _raw(kind)
    params, state = jax_build_model(jax_config(raw)).init(jax.random.PRNGKey(3))
    params, state = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)
    if gate_bias is not None:  # a decode that runs to its cap
        params["decoder"]["gate"]["b"] = np.full_like(params["decoder"]["gate"]["b"], gate_bias)
    d = str(tmp_path / f"{kind}.ckpt")
    save_checkpoint(d, params, state, raw)
    return d, raw, params, state


def _assert_sd_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("kind", ["vanilla", "controllable", "description", "gst"])
def test_model_checkpoint_reads_bit_for_bit(tmp_path, kind):
    d, raw, params, state = _jax_checkpoint(tmp_path, kind)
    want = from_jax_params(params, state)
    sd, hp = load_tacotron2_checkpoint(d)
    _assert_sd_equal(sd, want)
    assert model_config_from(config_from_dict(hp)) == model_config_from(config_from_dict(raw))
    load_strict(Tacotron2(model_config_from(config_from_dict(hp))), sd)
    out = str(tmp_path / "converted.ckpt")
    cli(["convert", d, out])
    sd2, hp2 = load_tacotron2_checkpoint(out)
    _assert_sd_equal(sd2, want)
    assert hp2 == hp == raw
    assert "optimizer_states" not in torch.load(out, weights_only=False)  # no train/ item


def test_prosody_checkpoint_reads_bit_for_bit(tmp_path):
    jp = JaxPredictor(num_mels=16, rnn_in_dim=24, num_features=3)
    params = jax.tree.map(np.asarray, jp.init(jax.random.PRNGKey(1)))
    hparams = dict(conv_out_dim=jp.conv_out_dim, rnn_in_dim=jp.rnn_in_dim,
                   use_deltas=jp.use_deltas, use_lstm=jp.use_lstm, rnn_layers=jp.rnn_layers,
                   rnn_dropout=jp.rnn_dropout, num_features=3, num_mels=16,
                   features=["a", "b", "c"])
    d = str(tmp_path / "prosody_final.ckpt")
    save_checkpoint(d, params, {}, {"prosody_predictor": hparams, "source_config": _raw("x")})
    want = prosody_from_jax_params(params)
    _assert_sd_equal(ckpt_lib.load_prosody_checkpoint(d).state_dict(), want)
    out = str(tmp_path / "prosody.ckpt")
    assert cli(["convert", d, out])["kind"] == "prosody"
    pred = ckpt_lib.load_prosody_checkpoint(out)
    _assert_sd_equal(pred.state_dict(), want)
    assert not any(p.requires_grad for p in pred.parameters())
    assert torch.load(out, weights_only=False)["hyper_parameters"]["prosody_predictor"] == hparams


def test_resumed_third_step_matches_jax(tmp_path):
    """JAX takes two steps (the milestone at int(0.5 * 4) = step 2), saves,
    takes a third; the port resumes from the converted ``.ckpt`` and takes
    the third: Adam's moments and steps, the schedule's lr (lr / 10 from
    the third step on, both sides), the losses and ``grad_norm`` within
    1e-4 relative, the weights within 5e-5 (``NOISE_GRAD``'s within two
    steps of lr), the BatchNorm statistics within 1e-5 (the encoder's
    means 0.2 lr): the two-step test's tolerances."""
    raw = _raw("vanilla")
    jm = jax_build_model(jax_config(raw))
    params, state = jm.init(jax.random.PRNGKey(0))
    tx, schedule = jax_optimizer(LR, 1e-6, scheduler_milestones=[2])
    ts = TrainState.create(params, state, tx)
    jstep = jax.jit(build_train_step(jm, tx, pallas_train=True))
    rng = jax.random.PRNGKey(11)
    batches = [{k: jnp.asarray(v) for k, v in _batch(i).items()} for i in range(3)]
    for b in batches[:2]:
        ts, _ = jstep(ts, b, rng)
    d = str(tmp_path / "jax.ckpt")
    save_checkpoint(d, ts.params, ts.model_state, raw, opt_state=ts.opt_state, step=int(ts.step))
    ts3, ref = jstep(ts, batches[2], rng)

    out = str(tmp_path / "port.ckpt")
    assert cli(["convert", d, out]) == {"out": out, "kind": "tacotron2", "step": 2}
    cfg = config_from_dict(raw)
    for source in (out, d):
        model = Tacotron2(model_config_from(cfg))
        ckpt_lib.load_model_state(source, model)
        opt, sched = optimizer.make_optimizer(model.parameters(), LR, 1e-6, [2])
        assert ckpt_lib.load_train_state(source, opt, sched) == 2
        named = dict(model.named_parameters())
        mu = from_jax_params(jax.tree.map(np.asarray, ts.opt_state[2].mu), None)
        for k, p in named.items():
            assert torch.equal(opt.state[p]["exp_avg"], mu[k]) and int(opt.state[p]["step"]) == 2
        assert opt.param_groups[0]["lr"] == pytest.approx(float(schedule(2))) == LR / 10
        got = step.train_step(model, opt, sched, step.to_device(_batch(2), "cpu"),
                              lstm_masks=_masks(jax.random.fold_in(rng, 2)))
        for k in ("loss", "gate_loss", "mel_loss", "mel_post_loss", "grad_norm"):
            _close(got[k], ref[k], 1e-4 * abs(float(ref[k])) + 1e-7, f"{source} {k}")
        sd = from_jax_params(jax.tree.map(np.asarray, ts3.params),
                             jax.tree.map(np.asarray, ts3.model_state))
        for k, v in sd.items():
            if k.endswith("num_batches_tracked"):
                continue
            if "running" in k:
                atol = 0.2 * LR if k.startswith("encoder.") and k.endswith("mean") else 1e-5
            else:
                atol = 2 * LR if k in NOISE_GRAD else 5e-5
            _close(model.state_dict()[k], v.numpy(), atol, f"{source} {k}")
        assert sched.last_epoch == 3


def test_finetune_state_warns_and_loads_weights(tmp_path, capsys):
    d, raw, params, state = _jax_checkpoint(tmp_path, "vanilla")
    freeze = jax.tree.map(lambda _: True, params)
    freeze["encoder"] = jax.tree.map(lambda _: False, params["encoder"])
    tx, _ = jax_optimizer(LR, 1e-6, scheduler_milestones=[2], freeze_mask=freeze)
    save_checkpoint(d, params, state, raw, opt_state=tx.init(params), step=5)
    ckpt = lightning_from_orbax(d)
    assert "warning: optimizer state in" in capsys.readouterr().out
    assert "optimizer_states" not in ckpt
    _assert_sd_equal({k[len("tacotron2."):]: v for k, v in ckpt["state_dict"].items()},
                     from_jax_params(params, state))
    model = Tacotron2(model_config_from(config_from_dict(raw)))
    opt, sched = optimizer.make_optimizer(model.parameters(), LR, 1e-6, [2])
    assert ckpt_lib.load_train_state(d, opt, sched) == 0  # JAX starts fresh too
    assert "does not match the current optimizer" in capsys.readouterr().out
    assert not opt.state


def test_say_from_the_directory_equals_the_converted_ckpt(tmp_path):
    d, raw, params, state = _jax_checkpoint(tmp_path, "vanilla", gate_bias=3.0)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(raw))
    out = str(tmp_path / "c.ckpt")
    cli(["convert", d, out])
    wavs = []
    for src in (d, out):
        wav = str(tmp_path / f"{os.path.basename(src)}.wav")
        cli(["say", "--config", str(cfg), "--checkpoint", src, "--text", "hello there",
             "--out", wav, "--random-seed", "3", "--max-len-override", "8", "--device", "cpu"])
        wavs.append(open(wav, "rb").read())
    assert wavs[0] == wavs[1] and len(wavs[0]) > 44
