"""Finetuning in the port (``run/train.py --finetune``, the freeze in
``training/optimizer.py``, the gradients cleared in ``training/step.py``)
against the JAX package on the CPU, at a tiny 3-speaker config:

- two finetune steps against JAX ``build_train_step(pallas_train=True)``
  with ``make_optimizer(lr / 10, freeze_mask=...)`` (the encoder and the
  speaker embedding frozen): losses and ``grad_norm`` (every gradient, the
  frozen ones included) within 1e-4 relative, the frozen parameters equal
  to their start bit for bit on both sides, the rest within 5e-5 (5% of one
  Adam step of lr 1e-3, ``test_two_train_steps_match_jax``'s bound) and the
  BatchNorm state within that test's bounds. The batch's gradient norm is
  above 1, so the clip acts;
- the same comparison finds the two defects it guards against: a clip over
  every gradient (frozen ones included) moves the trained parameters off
  JAX's, and gradients cleared through the optimizer alone pile the frozen
  ones up, which moves the second step's ``grad_norm``;
- ``python -m tacotron2_tpu_torch train`` then ``train --finetune`` on a
  tiny corpus: ``finetuned.ckpt``, lr / 10 logged, batches of twice the
  config's rows, a fresh optimizer from step 0, the frozen tensors equal to
  the resumed checkpoint's and the others moved; and the two refusals.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from tacotron2_tpu.models.tacotron2 import Tacotron2Config as JaxConfig
from tacotron2_tpu.training.optimizer import make_optimizer as jax_optimizer
from tacotron2_tpu.training.step import build_train_step
from tacotron2_tpu.training.train_state import TrainState
from tacotron2_tpu_torch.__main__ import main as cli
from tacotron2_tpu_torch.convert import from_jax_params
from tacotron2_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from tacotron2_tpu_torch.run.train import FINETUNE_FROZEN
from tacotron2_tpu_torch.training import optimizer, step
from tests.test_torch_train_controls import _conditioned_corpus, FEATURES
from tests.test_torch_training import B, CFG, _batch, _bn_state_close, _masks

torch.set_num_threads(1)

SPEAKERS = 3
FT_CFG = dict(CFG, speaker_tokens=True, num_speakers=SPEAKERS)
LR = 1e-2  # the config's; finetuning steps at LR / 10
WD = 1e-6


def _ft_batch(seed):
    b = _batch(seed)
    b["speaker_id"] = np.array([seed % SPEAKERS, 2], np.int64)[:B]
    b["mel"] = b["mel"] * 4.0  # a gradient norm above the clip's 1.0
    return b


@functools.lru_cache(maxsize=None)
def _jax_run():
    """Two finetune steps of the JAX package; -> (start params, state,
    [(metrics, params, state) after each step])."""
    jm = JaxTacotron2(JaxConfig(**FT_CFG))
    params, state = jm.init(jax.random.PRNGKey(0))
    mask = jax.tree.map(lambda _: True, params)
    for part in ("encoder", "speaker_embedding"):
        mask[part] = jax.tree.map(lambda _: False, params[part])
    tx, _ = jax_optimizer(LR / 10, WD, scheduler_milestones=[], freeze_mask=mask)
    ts = TrainState.create(params, state, tx)
    jstep = jax.jit(build_train_step(jm, tx, pallas_train=True))
    rng, out = jax.random.PRNGKey(11), []
    for i in range(2):
        ts, metrics = jstep(ts, {k: jnp.asarray(v) for k, v in _ft_batch(i).items()}, rng)
        out.append(jax.tree.map(np.asarray, (metrics, ts.params, ts.model_state)))
    return jax.tree.map(np.asarray, (params, state)), out


def _mismatches(defect=None, monkeypatch=None):
    """Two port finetune steps (``defect``: None, "clip_all" or
    "opt_zero_grad") held against ``_jax_run``; -> what differs."""
    (params, state), ref = _jax_run()
    model = Tacotron2(Tacotron2Config(**FT_CFG))
    model.load_state_dict(from_jax_params(params, state))
    opt, sched = optimizer.make_optimizer(optimizer.trainable(model, FINETUNE_FROZEN),
                                          LR / 10, WD)
    if defect == "clip_all":
        def clip_all(params, opt, sched, frozen=(), split=frozenset(), mp=None):
            norm = torch.nn.utils.clip_grad_norm_(list(params) + list(frozen), 1.0)
            opt.step()
            sched.step()
            return norm
        monkeypatch.setattr(step, "apply_gradients", clip_all)
    elif defect == "opt_zero_grad":
        model.zero_grad = lambda set_to_none=True: opt.zero_grad(set_to_none=set_to_none)
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    bad = []
    for i in range(2):
        masks = _masks(jax.random.fold_in(jax.random.PRNGKey(11), i))
        got = step.train_step(model, opt, sched, step.to_device(_ft_batch(i), "cpu"),
                              lstm_masks=masks)
        metrics, jparams, jstate = ref[i]
        assert float(metrics["grad_norm"]) > 1.0  # the clip acts
        for k in ("loss", "gate_loss", "mel_loss", "mel_post_loss", "grad_norm"):
            want = float(metrics[k])
            if not abs(float(got[k]) - want) <= 1e-4 * abs(want) + 1e-7:
                bad.append(f"step {i} {k}: {float(got[k])} != {want}")
        sd = from_jax_params(jparams, None)
        for k, p in model.named_parameters():
            if k.startswith(FINETUNE_FROZEN):
                assert torch.equal(p, start[k]), f"port: frozen {k} moved"
                assert np.array_equal(sd[k].numpy(), start[k].numpy()), f"JAX: frozen {k} moved"
            elif not np.abs(p.detach().double().numpy() - sd[k].numpy()).max() <= 5e-5:
                bad.append(f"step {i} {k}")
        # the encoder's running means within two lr steps x momentum 0.1
        # (test_two_train_steps_match_jax's bounds)
        _bn_state_close(model, jstate, 1e-5, 0.2 * LR / 10)
    return bad


def test_two_finetune_steps_match_jax():
    assert _mismatches() == []


def test_clip_over_all_gradients_is_caught(monkeypatch):
    bad = _mismatches("clip_all", monkeypatch)
    assert [b for b in bad if ":" not in b], bad  # trained parameters off JAX's


def test_gradients_cleared_by_the_optimizer_alone_are_caught():
    bad = _mismatches("opt_zero_grad")
    assert "step 1 grad_norm" in " ".join(bad) and not any(b.startswith("step 0") for b in bad)


def test_frozen_parameters_keep_their_gradients_out_of_the_optimizer():
    model = Tacotron2(Tacotron2Config(**FT_CFG))
    held = optimizer.trainable(model, FINETUNE_FROZEN)
    names = {id(p): n for n, p in model.named_parameters()}
    frozen = [n for n, p in model.named_parameters() if id(p) not in {id(q) for q in held}]
    assert frozen and all(n.startswith(FINETUNE_FROZEN) for n in frozen)
    assert "encoder.embedding.weight" in frozen and "speaker_embedding.weight" in frozen
    assert all(not names[id(p)].startswith(FINETUNE_FROZEN) for p in held)
    assert all(p.requires_grad for p in model.parameters())  # JAX computes their gradients


# ---------------------------------------------------------------------------
# the CLI


def _ft_config(tmp_path):
    speech, csv, _ = _conditioned_corpus(tmp_path)
    raw = json.loads((tmp_path / "cfg.json").read_text())
    raw["dataset"]["train"] = raw["dataset"]["val"] = str(csv)
    raw["extensions"] = {"speaker_tokens": {"active": True, "num_speakers": 2},
                         "controls": {"active": True, "features": FEATURES}}
    cfg = tmp_path / "ft.json"
    cfg.write_text(json.dumps(raw))
    return speech, str(cfg), raw


def test_train_then_finetune_cli(tmp_path):
    """Train 3 steps at batch 2, then finetune with ``--finetune-steps 1
    --max-steps 3``: 4 steps at batch 4 (the 4-row corpus is one step an
    epoch, so validation follows every step), lr 1e-3 / 10 logged at step
    1 (the milestones, 0.5 and 0.75 of 4 steps, lie behind it)."""
    speech, cfg, raw = _ft_config(tmp_path)
    base = ["train", "--config", cfg, "--speech-dir", str(speech), "--device", "cpu"]
    first = cli(base + ["--results-dir", str(tmp_path / "r1")])
    ft = cli(base + ["--results-dir", str(tmp_path / "ft"), "--resume-ckpt",
                     first["checkpoint"], "--finetune", "--finetune-steps", "1",
                     "--max-steps", "3"])
    assert ft["checkpoint"] == str(tmp_path / "ft" / "finetuned.ckpt")
    assert [s["step"] for s in ft["steps"]] == [1, 2, 3, 4]
    assert {s["rows"] for s in ft["steps"]} == {2 * raw["training"]["batch_size"]}
    assert all(np.isfinite(s["loss"]) for s in ft["steps"])
    assert len(ft["val_decode_frames"]) == 4 + 1  # once an epoch, and at the end
    rows = [json.loads(x) for x in (tmp_path / "ft" / "lightning_logs" / "tiny" /
                                    "metrics.jsonl").read_text().splitlines()]
    lr1 = [r["lr"] for r in rows if r["step"] == 1 and "lr" in r]
    assert lr1 == [pytest.approx(raw["training"]["lr"] / 10)]
    before, after = (torch.load(p, map_location="cpu", weights_only=False)
                     for p in (first["checkpoint"], ft["checkpoint"]))
    assert after["global_step"] == 4
    state = after["optimizer_states"][0]["state"]
    assert all(int(s["step"]) == 4 for s in state.values())  # fresh at step 0
    n_trained = sum(1 for k in after["state_dict"] if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))
        and not k[len("tacotron2."):].startswith(FINETUNE_FROZEN))
    assert len(state) == n_trained
    for k, v in after["state_dict"].items():
        name = k[len("tacotron2."):]
        if name.startswith(FINETUNE_FROZEN) and "running_" not in name \
                and "num_batches" not in name:
            assert torch.equal(v, before["state_dict"][k]), name
        elif name.startswith(("decoder.", "postnet.")) and name.endswith("weight"):
            assert not torch.equal(v, before["state_dict"][k]), name


def test_finetune_refusals(tmp_path):
    speech, cfg, _ = _ft_config(tmp_path)
    base = ["train", "--config", cfg, "--speech-dir", str(speech), "--device", "cpu",
            "--results-dir", str(tmp_path / "r")]
    with pytest.raises(ValueError, match="--finetune-steps is required"):
        cli(base + ["--finetune", "--resume-ckpt", "x.ckpt"])
    with pytest.raises(ValueError, match="--resume-ckpt is required"):
        cli(base + ["--finetune", "--finetune-steps", "2"])
    assert not (tmp_path / "r").exists()
