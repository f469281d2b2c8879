"""Training with speaker tokens and controls on the port (the controls rows
of K3 and K4, on their plain versions on the CPU) against the JAX package.

Dims of tests/test_train_pallas.py: B=2 with a padded row (lengths 9 and 6),
T=24, H=D=32, P=16, A=16, M=16, with C=4 controls (E=16 columns in the
kernels' layouts). Weights from the JAX ``init``, inputs from ``jax.random``
or numpy, the LSTM dropout masks JAX's own.

- ``TeacherDecode`` with controls against ``run_decode_scan_pallas(...,
  controls, interpret=True, bwd="pallas")``: outputs, every decoder
  parameter's gradient and those of ``encoded``, ``att_encoded``,
  ``decoder_in`` and the controls within ``3e-5 * max + 1e-7`` (32-true) and
  ``0.02 * max + 1e-6`` (bf16-mixed), tests/test_torch_train_decode.py's TOL;
- ``torch.autograd.gradcheck`` of the plain ``TeacherDecode`` with controls
  in f64, and its gradients against autograd of the step loop;
- the layouts: ``pack_weights`` with controls against JAX's
  ``_pack_training_weights`` (zero pad columns), and without controls the
  plain concatenations the vanilla kernels take;
- two whole train steps of a model with 3 speakers and 4 controls against
  JAX ``build_train_step(pallas_train=True)``, with
  tests/test_torch_training.py's tolerances, the speaker embedding's
  gradient and update included (its init: tests/test_torch_training.py);
- the dataset and ``collate`` with speaker ids and features against JAX's,
  and ``force_speaker``'s row filter against the pandas one of the JAX
  package's ``run/train.py``;
- ``train`` on a tiny controllable multi-speaker config: runs, resumes, and
  its checkpoint says with ``--speaker-id`` and ``--controls``;
- the wrappers on meta tensors with a fake library: the controls add no
  launch and reach K3 (its controls slot and E) and K4 (E and d_ctrl).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from run.common import read_manifest as jax_read_manifest
from tacotron2_tpu.data.dataset import TTSDataset as JaxDataset
from tacotron2_tpu.data.loader import collate as jax_collate
from tacotron2_tpu.models import decoder as jax_decoder
from tacotron2_tpu.models.layers import Policy as JaxPolicy
from tacotron2_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from tacotron2_tpu.models.tacotron2 import Tacotron2Config as JaxConfig
from tacotron2_tpu.ops import train_scan
from tacotron2_tpu.ops.train_decode_pallas import _pack_training_weights, run_decode_scan_pallas
from tacotron2_tpu.training.losses import tacotron2_loss as jax_loss
from tacotron2_tpu.training.optimizer import make_optimizer as jax_optimizer
from tacotron2_tpu.training.step import build_train_step
from tacotron2_tpu.training.train_state import TrainState
from tacotron2_tpu_torch.__main__ import main as cli
from tacotron2_tpu_torch.audio.io import read_wav
from tacotron2_tpu_torch.config import config_from_dict
from tacotron2_tpu_torch.convert import decoder_from_jax, from_jax_params
from tacotron2_tpu_torch.data.dataset import TTSDataset
from tacotron2_tpu_torch.data.loader import collate
from tacotron2_tpu_torch.data.manifest import read_manifest, select_rows
from tacotron2_tpu_torch.models.layers import Policy
from tacotron2_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from tacotron2_tpu_torch.ops import build
from tacotron2_tpu_torch.ops import train_decode as td
from tacotron2_tpu_torch.training import optimizer, step
from tests.test_torch_train_cli import CHARS, TEXTS, _corpus, _hifigan
from tests.test_torch_train_decode import PORT_DTYPE, TOL, _assert_close, _loss
from tests.test_torch_training import LR, NOISE_GRAD, _bn_state_close, _close

torch.set_num_threads(1)

CFG = dict(num_chars=16, encoded_dim=32, encoder_kernel_size=5, num_mels=16, prenet_dim=16,
           att_rnn_dim=32, att_dim=16, rnn_hidden_dim=32, postnet_dim=16, dropout=0.0)
B, L, T, H, D, P, A, M = 2, 9, 24, 32, 32, 16, 16, 16
C, E = 4, 16
LENS = (9, 6)


def _controls_np(seed=4):
    return np.random.default_rng(seed).uniform(-1, 1, size=(B, C)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_side(policy: str):
    """JAX outputs and gradients (decoder, encoded, att_encoded,
    decoder_in, controls), weights and masks, as numpy."""
    model = JaxTacotron2(JaxConfig(**CFG, controls=True, controls_dim=C),
                         JaxPolicy.from_string(policy))
    params, _ = model.init(jax.random.PRNGKey(0))
    enc = jax.random.normal(jax.random.PRNGKey(1), (B, L, D))
    att = jax.random.normal(jax.random.PRNGKey(2), (B, L, A))
    din = jax.random.normal(jax.random.PRNGKey(3), (T, B, P))
    ctl = jnp.asarray(_controls_np())
    mask = jnp.arange(L)[None, :] >= jnp.asarray(LENS)[:, None]
    keys = jax.random.split(jax.random.PRNGKey(13), T)
    st = jax_decoder.init_state(B, L, H, D, H)

    def run(dec_params, enc, att, din, ctl):
        return run_decode_scan_pallas(dec_params, st, din, keys, enc, att, mask, ctl,
                                      train=True, policy=model.policy, interpret=True,
                                      bwd="pallas")

    args = (params["decoder"], enc, att, din, ctl)
    outs = run(*args)
    grads = jax.grad(lambda *a: _loss(*run(*a), jnp), argnums=(0, 1, 2, 3, 4))(*args)
    dm1, dm2 = jax.vmap(lambda k: train_scan._dropout_masks(k, (B, H), True))(keys)
    np_ = lambda t: np.asarray(t, np.float32)
    return (params["decoder"], [np_(a) for a in (enc, att, din, ctl)], [np_(o) for o in outs],
            grads, np_(dm1), np_(dm2))


def _port_params(dec_tree, dtype=torch.float32):
    sd = decoder_from_jax(dec_tree)
    return [sd[k].to(dtype) for k in td.DECODER_PARAMS]


@pytest.mark.parametrize("policy", ["32-true", "bf16-mixed"])
def test_teacher_decode_with_controls_matches_jax_pallas(policy):
    dec_tree, (enc, att, din, ctl), outs, grads, dm1, dm2 = _jax_side(policy)
    rel, floor = TOL[policy]
    params = [p.requires_grad_() for p in _port_params(dec_tree)]
    enc_t, att_t, din_t, ctl_t = (torch.tensor(a, requires_grad=True)
                                  for a in (enc, att, din, ctl))
    mels, gates, aligns = td.TeacherDecode.apply(
        PORT_DTYPE[policy], din_t, enc_t, att_t, torch.tensor(LENS), torch.tensor(dm1),
        torch.tensor(dm2), ctl_t, *params)
    for name, got, ref in zip(("mels", "gates", "aligns"), (mels, gates, aligns), outs):
        _assert_close(got, ref, rel, floor, name)
    _loss(mels, gates, aligns, torch).backward()

    g_dec, g_enc, g_att, g_din, g_ctl = grads
    ref_dec = decoder_from_jax(jax.tree.map(np.asarray, g_dec))
    for name, p in zip(td.DECODER_PARAMS, params):
        _assert_close(p.grad, ref_dec[name].numpy(), rel, floor, f"grad {name}")
    for name, t, g in (("encoded", enc_t, g_enc), ("att_encoded", att_t, g_att),
                       ("decoder_in", din_t, g_din), ("controls", ctl_t, g_ctl)):
        _assert_close(t.grad, g, rel, floor, f"grad {name}")
    assert float(ctl_t.grad.abs().max()) > 1e-3  # the controls' gradient is not vacuous


def _tiny_case(controls_dim=3):
    """f64 inputs at tiny dims with controls, weights from the JAX init."""
    cfg = dict(CFG, encoded_dim=8, num_mels=4, prenet_dim=6, att_rnn_dim=8, att_dim=4,
               rnn_hidden_dim=8, controls=True, controls_dim=controls_dim)
    params, _ = JaxTacotron2(JaxConfig(**cfg)).init(jax.random.PRNGKey(5))
    ps = [p.double().requires_grad_() for p in _port_params(params["decoder"])]
    r = np.random.default_rng(0)
    Tt, Lt = 4, 7
    mk = lambda *s: torch.tensor(r.standard_normal(s), dtype=torch.float64, requires_grad=True)
    din, enc, att, ctl = mk(Tt, 2, 6), mk(2, Lt, 8), mk(2, Lt, 4), mk(2, controls_dim)
    keep = lambda: torch.tensor((r.random((Tt, 2, 8)) < td.KEEP) / td.KEEP)
    return ps, din, enc, att, ctl, torch.tensor([Lt, 4]), keep(), keep()


def test_teacher_decode_with_controls_gradcheck_f64():
    ps, din, enc, att, ctl, lengths, dm1, dm2 = _tiny_case()
    f = lambda d, e, a, c, *p: td.TeacherDecode.apply(torch.float64, d, e, a, lengths, dm1,
                                                      dm2, c, *p)
    assert torch.autograd.gradcheck(f, (din, enc, att, ctl, *ps), eps=1e-6, atol=1e-6,
                                    fast_mode=True)


def test_teacher_decode_with_controls_grads_equal_autograd_of_step_loop():
    """The hand-pulled reverse pass, d_ctrl included, against autograd
    through the plain forward loop with the controls padded to E."""
    ps, din, enc, att, ctl, lengths, dm1, dm2 = _tiny_case()
    r = np.random.default_rng(1)

    def loop(d, e, a, c, *p):
        mg, res = td.teacher_forward_plain(td.pack_weights(p, torch.float64, 3), d, e, a,
                                           lengths, dm1, dm2, td.pad_controls(c, 3, d[0]))
        return mg[..., :-1], mg[..., -1], res.al[1:]

    inputs = (din, enc, att, ctl, *ps)
    outs_a = td.TeacherDecode.apply(torch.float64, din, enc, att, lengths, dm1, dm2, ctl, *ps)
    outs_b = loop(*inputs)
    cots = [torch.tensor(r.standard_normal(o.shape)) for o in outs_a]
    ga = torch.autograd.grad(outs_a, inputs, cots)
    gb = torch.autograd.grad(outs_b, inputs, cots)
    for a, b in zip(outs_a, outs_b):
        torch.testing.assert_close(a, b, atol=1e-12, rtol=0)
    for a, b in zip(ga, gb):
        torch.testing.assert_close(a, b, atol=1e-10, rtol=0)


def test_teacher_decode_without_controls_needs_none():
    """A decoder with controls refuses a missing or mis-sized controls
    tensor; one without refuses controls."""
    ps, din, enc, att, ctl, lengths, dm1, dm2 = _tiny_case()
    run = lambda c, p=ps: td.TeacherDecode.apply(torch.float64, din, enc, att, lengths, dm1,
                                                 dm2, c, *p)
    for bad in (None, ctl[:1], ctl[:, :-1], torch.zeros(2, 17, dtype=torch.float64)):
        with pytest.raises(ValueError, match="controls"):
            run(bad)
    vanilla = _port_params(JaxTacotron2(JaxConfig(**dict(
        CFG, encoded_dim=8, num_mels=4, prenet_dim=6, att_rnn_dim=8, att_dim=4,
        rnn_hidden_dim=8))).init(jax.random.PRNGKey(5))[0]["decoder"], torch.float64)
    with pytest.raises(ValueError, match="controls"):
        run(ctl, vanilla)


@pytest.mark.parametrize("controls_dim", [4, 5, 16])
def test_pack_weights_with_controls_equals_jax(controls_dim):
    """JAX holds both LSTMs in one (R2k, 8H) block, inputs as rows, and the
    heads as (H + D + E, 128) columns [mel | gate | pad]: the port's w1, w2
    and w_out are their transposes without the padding, the controls'
    columns padded from C to E with zeros in W2 and the mel rows, the
    gate's row zero over all E."""
    Cd = controls_dim
    Ed = td.controls_cols(Cd)
    model = JaxTacotron2(JaxConfig(**CFG, controls=True, controls_dim=Cd))
    dec = model.init(jax.random.PRNGKey(6))[0]["decoder"]
    w1, w2, small = train_scan._split_big_small(dec)
    ref = _pack_training_weights(w1, w2, small, H=H, D=D, P=P, E=Ed, C=Cd, M=M,
                                 dt=jnp.float32)
    w = td.pack_weights(_port_params(dec), torch.float32, Cd)
    w_res = np.asarray(ref["w_res"])
    np.testing.assert_array_equal(w.w1.numpy(), w_res[:P + D + H, :4 * H].T)
    np.testing.assert_array_equal(w.w2.numpy(), w_res[:, 4 * H:].T)
    np.testing.assert_array_equal(w.w_out.numpy(), np.asarray(ref["w_out"])[:, :M + 1].T)
    np.testing.assert_array_equal(w.b_out.numpy(), np.asarray(ref["b_out"])[0, :M + 1])
    assert w.w2.shape == (4 * H, 2 * H + D + Ed) and w.w_out.shape == (M + 1, H + D + Ed)
    assert not w.w2[:, H + D + Cd:H + D + Ed].any()
    assert not w.w_out[:M, H + D + Cd:].any() and not w.w_out[M, H + D:].any()


def test_pack_weights_without_controls_is_the_vanilla_layout():
    dec = JaxTacotron2(JaxConfig(**CFG)).init(jax.random.PRNGKey(6))[0]["decoder"]
    ps = _port_params(dec)
    named = dict(zip(td.DECODER_PARAMS, ps))
    w = td.pack_weights(ps, torch.float32)
    assert td.controls_cols(0) == 0
    torch.testing.assert_close(w.w2, torch.cat([named["lstm.weight_ih"],
                                                named["lstm.weight_hh"]], 1), atol=0, rtol=0)
    torch.testing.assert_close(w.w_out, torch.cat([named["mel_out.weight"],
                                                   named["gate.weight"]], 0), atol=0, rtol=0)


# ---------------------------------------------------------------------------
# two train steps of a multi-speaker, controllable model

EXT = dict(speaker_tokens=True, num_speakers=3, controls=True, controls_dim=C)
INPUTS = ("chars_idx", "chars_len", "mel", "mel_len")


def _batch(seed=0):
    r = np.random.default_rng(seed)
    chars = r.integers(1, 16, size=(B, L)).astype(np.int64)
    chars[1, 6:] = 0
    mel = (r.standard_normal((B, T, M)) * 0.5).astype(np.float32)
    mel[1, T - 6:] = 0.0
    gate = np.ones((B, T, 1), np.float32)
    gate[0, -1], gate[1, T - 7:] = 0.0, 0.0
    return {"chars_idx": chars, "chars_len": np.array([L, 6]), "mel": mel,
            "mel_len": np.array([T, T - 6]), "gate": gate,
            "speaker_id": np.array([2, 0 + seed], np.int64), "controls": _controls_np(seed + 7)}


def _masks(rng):
    """The LSTM masks JAX's forward_teacher draws from ``rng``."""
    keys = jax.random.split(jax.random.split(rng, 5)[3], T)
    m = jax.vmap(lambda k: train_scan._dropout_masks(k, (B, H), True))(keys)
    return tuple(torch.as_tensor(np.array(a)) for a in m)


def test_two_train_steps_with_speakers_and_controls_match_jax():
    """tests/test_torch_training.py::test_two_train_steps_match_jax on a
    model with 3 speakers and 4 controls, batches of speakers (2, 0) and (2,
    1), with its tolerances: the losses and ``grad_norm`` within 1e-4
    relative, every gradient within 1e-4 of its tensor's max, every weight
    within 5e-5 (those of ``NOISE_GRAD`` as there), the BatchNorm state
    within 1e-5 (the encoder's running means 2e-4). The speaker embedding's
    rows of the batch's speakers get a gradient and move; the row of no
    batch's speaker gets none in the first step."""
    jm = JaxTacotron2(JaxConfig(**CFG, **EXT), JaxPolicy.from_string("32-true"))
    params, state = jm.init(jax.random.PRNGKey(0))
    tx, _ = jax_optimizer(LR, 1e-6, scheduler_milestones=[])
    ts = TrainState.create(params, state, tx)
    jstep = jax.jit(build_train_step(jm, tx, pallas_train=True))

    @jax.jit
    def jgrad(p, s, batch, rng):
        def f(p):
            out, _ = jm.forward_teacher(p, s, *(batch[k] for k in INPUTS), rng=rng, train=True,
                                        speaker_id=batch["speaker_id"],
                                        controls=batch["controls"], dw_hoist=True,
                                        pallas_train=True)
            return jax_loss(out.mels, out.mels_post, out.gates, batch["mel"], batch["gate"])[0]
        return jax.grad(f)(p)

    rng = jax.random.PRNGKey(11)
    model = Tacotron2(Tacotron2Config(**CFG, **EXT), Policy.from_string("32-true"))
    model.load_state_dict(from_jax_params(params, state))
    table0 = model.speaker_embedding.weight.detach().clone()
    opt, sched = optimizer.make_optimizer(model.parameters(), LR, 1e-6)
    for i, b in enumerate([_batch(0), _batch(1)]):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        g_ref = from_jax_params(jax.tree.map(np.asarray, jgrad(ts.params, ts.model_state, jb,
                                                               jax.random.fold_in(rng, i))), None)
        ts, ref = jstep(ts, jb, rng)
        got = step.train_step(model, opt, sched, step.to_device(b, "cpu"),
                              lstm_masks=_masks(jax.random.fold_in(rng, i)))
        for k in ("loss", "gate_loss", "mel_loss", "mel_post_loss", "grad_norm"):
            _close(got[k], ref[k], 1e-4 * abs(float(ref[k])) + 1e-7, f"step {i} {k}")
        unclip = max(1.0, float(got["grad_norm"]) + 1e-6)
        named = dict(model.named_parameters())
        sd = from_jax_params(jax.tree.map(np.asarray, ts.params), None)
        assert "speaker_embedding.weight" in sd
        for k, v in sd.items():
            g = g_ref[k].numpy()
            if k in NOISE_GRAD:
                assert max(np.abs(g).max(), float(named[k].grad.abs().max())) < 1e-6, k
            else:
                _close(named[k].grad * unclip, g, 1e-4 * float(np.abs(g).max()) + 1e-8,
                       f"step {i} grad {k}")
            _close(named[k], v.numpy(), 2 * LR if k in NOISE_GRAD else 5e-5, f"step {i} {k}")
        _bn_state_close(model, jax.tree.map(np.asarray, ts.model_state), 1e-5, 0.2 * LR)
        g_spk = model.speaker_embedding.weight.grad
        if i == 0:
            assert not g_spk[1].any() and g_spk[0].abs().max() > 0 and g_spk[2].abs().max() > 0
    moved = (model.speaker_embedding.weight.detach() - table0).abs().amax(1)
    assert bool((moved > 0).all())


def test_to_device_keeps_speaker_ids_on_the_host():
    """``to_device`` moves the batch's tensors, the controls too, but leaves
    the speaker ids on the host, where ``_encode`` checks their range
    without waiting for the card."""
    got = step.to_device(_batch(0), "meta")
    assert set(got) == {*step.BATCH_KEYS, "speaker_id", "controls"}
    assert got["speaker_id"].device.type == "cpu"
    assert all(got[k].device.type == "meta" for k in (*step.BATCH_KEYS, "controls"))


def test_forward_teacher_refuses_bad_conditioning():
    model = Tacotron2(Tacotron2Config(**CFG, **EXT))
    b = {k: torch.as_tensor(v) for k, v in _batch().items()}
    args = tuple(b[k] for k in INPUTS)
    spk, ctl = b["speaker_id"], b["controls"]
    for kw, match in ((dict(controls=ctl), "speaker_id tensor required"),
                      (dict(speaker_id=spk), "no control vector"),
                      (dict(speaker_id=spk, controls=ctl[:, :3]), "shape"),
                      (dict(speaker_id=spk[:1], controls=ctl), "speaker ids"),
                      (dict(speaker_id=spk + 2, controls=ctl), "out of range")):
        with pytest.raises(ValueError, match=match):
            model.forward_teacher(*args, **kw)


# ---------------------------------------------------------------------------
# data


FEATURES = ["pitch_speaker_norm", "rate_speaker_norm"]


def _conditioned_corpus(tmp_path):
    speech, _, _ = _corpus(tmp_path)
    r = np.random.default_rng(8)
    rows = [(t, f"u{i}.wav", i % 2, *r.uniform(-1, 1, 2)) for i, t in enumerate(TEXTS)]
    csv = tmp_path / "cond.csv"
    csv.write_text("text|wav|speaker_id|" + "|".join(FEATURES) + "\n" + "".join(
        f"{t}|{w}|{s}|{float(a)!r}|{float(b)!r}\n" for t, w, s, a, b in rows))
    return speech, csv, rows


def test_dataset_and_collate_with_speakers_and_features_match_jax(tmp_path):
    speech, _, rows = _conditioned_corpus(tmp_path)
    files, spk = [r[1] for r in rows], [r[2] for r in rows]
    feats = [[r[3], r[4]] for r in rows]
    kw = dict(allowed_chars=CHARS, end_token="^", silence=512, trim=True, num_mels=16,
              expand_abbreviations=True)
    port = TTSDataset(files, TEXTS, str(speech), speaker_ids=spk, features=feats, **kw)
    ref = JaxDataset(files, TEXTS, str(speech), speaker_ids=spk, features=feats, **kw)
    items, ref_items = [port[i] for i in range(4)], [ref[i] for i in range(4)]
    for (_, m, _), (_, rm, _) in zip(items, ref_items):
        assert set(m) == set(rm)
        for k in rm:
            assert np.asarray(m[k]).dtype == np.asarray(rm[k]).dtype, k
            np.testing.assert_array_equal(m[k], rm[k], err_msg=k)
    for buckets in ((None, None), (32, 128)):
        got, want = collate(items, *buckets), jax_collate(ref_items, *buckets)
        assert set(got) == set(want) and {"speaker_id", "controls"} <= set(got)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("force", [None, 0, 1])
def test_force_speaker_keeps_the_rows_jax_keeps(tmp_path, force):
    _, csv, _ = _conditioned_corpus(tmp_path)
    ext = {"controls": {"active": True, "features": FEATURES}}
    if force is not None:
        ext["speaker_tokens"] = {"active": False, "force_speaker": force}
    cfg = config_from_dict({"dataset": {"preprocessing": {"allowed_chars": CHARS}},
                            "training": {}, "model": {"args": {}}, "extensions": ext})
    got = select_rows(cfg, read_manifest(str(csv)))
    df = jax_read_manifest(str(csv))
    if force is not None:
        df = df[df.speaker_id == force].reset_index(drop=True)
    assert [r["wav"] for r in got] == list(df.wav)
    # the dataset keeps them in f32; pandas' C parser may read the decimal
    # one f64 ulp off the exact value that float() reads
    np.testing.assert_array_equal(np.asarray([[float(r[f]) for f in FEATURES] for r in got],
                                             np.float32),
                                  df[FEATURES].values.astype(np.float32))


# ---------------------------------------------------------------------------
# the CLI


def test_train_controllable_resume_and_say(tmp_path):
    """``train`` of a 2-speaker, 2-control tiny config on the CPU: 3 steps,
    a resume to 4; the speaker embedding moved; the checkpoint says with
    ``--speaker-id 1 --controls=-0.5,0.25``."""
    speech, csv, _ = _conditioned_corpus(tmp_path)
    raw = json.loads((tmp_path / "cfg.json").read_text())
    raw["dataset"]["train"] = raw["dataset"]["val"] = str(csv)
    raw["extensions"] = {"speaker_tokens": {"active": True, "num_speakers": 2},
                         "controls": {"active": True, "features": FEATURES}}
    cfg = tmp_path / "ctl.json"
    cfg.write_text(json.dumps(raw))
    base = ["train", "--config", str(cfg), "--speech-dir", str(speech), "--device", "cpu"]
    first = cli(base + ["--results-dir", str(tmp_path / "r1")])
    second = cli(base + ["--results-dir", str(tmp_path / "r2"), "--resume-ckpt",
                         first["checkpoint"], "--max-steps", "4"])
    assert [s["step"] for s in first["steps"] + second["steps"]] == [1, 2, 3, 4]
    assert all(np.isfinite(s["loss"]) for s in first["steps"] + second["steps"])
    sds = [torch.load(x["checkpoint"], map_location="cpu", weights_only=False)["state_dict"]
           for x in (first, second)]
    k = "tacotron2.speaker_embedding.weight"
    assert sds[0][k].shape == (2, 32) and not torch.equal(sds[0][k], sds[1][k])
    assert sds[0]["tacotron2.decoder.mel_out.weight"].shape == (16, 32 + 32 + 2)

    out = str(tmp_path / "say.wav")
    res = cli(["say", "--config", str(cfg), "--checkpoint", second["checkpoint"],
               "--hifi-gan-checkpoint", _hifigan(tmp_path), "--text", "hello there",
               "--out", out, "--random-seed", "3", "--max-len-override", "8",
               "--speaker-id", "1", "--controls=-0.5,0.25", "--device", "cpu"])
    wav, sr = read_wav(out)
    assert sr == 22050 and len(wav) == res["samples"] and np.isfinite(wav).all()


# ---------------------------------------------------------------------------
# the wrappers with a fake library


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, device="meta", dtype=dtype)


class _FakeLib:
    def __init__(self):
        self.calls = []

    def t2_teacher_forward(self, ptrs, dims, stream):
        self.calls.append(("forward", 26, list(dims)))
        return 0

    def t2_teacher_backward(self, ptrs, dims, stream):
        self.calls.append(("backward", 40, list(dims)))
        return 0


Hm, Dm, Pm, Am, Km, Nm = 64, 32, 16, 8, 31, 9


def _meta_weights(Em):
    bf = torch.bfloat16
    return td.TrainWeights(
        _meta(4 * Hm, Pm + Dm + Hm, dtype=bf), _meta(4 * Hm),
        _meta(4 * Hm, 2 * Hm + Dm + Em, dtype=bf), _meta(4 * Hm), _meta(Am, Hm, dtype=bf),
        _meta(Am, 2, Km, dtype=bf), _meta(Am, dtype=bf), _meta(Nm, Hm + Dm + Em, dtype=bf),
        _meta(Nm))


@pytest.mark.parametrize("Em", [0, 16])
@pytest.mark.parametrize("Tm", [1, 384])
def test_controls_add_no_launches(monkeypatch, Em, Tm):
    """K3 and K4 with controls count as many launches as without
    (``forward_launches`` / ``backward_launches``), and in
    ``CONTROLS_LAUNCHES`` too; the calls get E in their last dim slot."""
    lib = _FakeLib()
    monkeypatch.setattr(td, "_lib", lambda: lib)
    monkeypatch.setattr(td, "_stream", lambda: 0)
    monkeypatch.setattr(td, "_sms", lambda dev: 132)
    monkeypatch.setattr(build, "require", lambda *a, **k: None)
    Bm, Lm = 3, 20
    w = _meta_weights(Em)
    before, before_ctl = dict(td.LAUNCHES), dict(td.CONTROLS_LAUNCHES)
    ctl = _meta(Bm, Em) if Em else None
    mg, res = td.teacher_forward(w, _meta(Tm, Bm, Pm), _meta(Bm, Lm, Dm, dtype=torch.bfloat16),
                                 _meta(Bm, Lm, Am), _meta(Bm, dtype=torch.int32),
                                 _meta(Tm, Bm, Hm), _meta(Tm, Bm, Hm), ctl)
    assert res.xh2.shape == (Tm, Bm, 2 * Hm + Dm + Em)
    out = td.teacher_backward(w, res, _meta(Bm, Lm, Dm, dtype=torch.bfloat16),
                              _meta(Bm, Lm, Am), _meta(Bm, dtype=torch.int32),
                              _meta(Tm, Bm, Hm), _meta(Tm, Bm, Hm), _meta(Tm, Bm, Nm),
                              _meta(Tm, Bm, Lm))
    assert out.d_ctrl.shape == (Bm, Em)
    grown = {k: td.LAUNCHES[k] - before[k] for k in td.LAUNCHES}
    assert grown == {"teacher_forward": td.forward_launches(Tm),
                     "teacher_backward": td.backward_launches(Tm)}
    grown_ctl = {k: td.CONTROLS_LAUNCHES[k] - before_ctl[k] for k in td.LAUNCHES}
    assert grown_ctl == (grown if Em else {k: 0 for k in grown})
    (f, _, fd), (b, _, bd) = lib.calls
    assert f == "forward" and len(fd) == 12 and fd[11] == Em and fd[:2] == [Tm, Bm]
    assert b == "backward" and len(bd) == 13 and bd[12] == Em
