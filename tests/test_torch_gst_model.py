"""The port's Tacotron 2 with Global Style Tokens (plain versions of K1,
K3 and K4 on the CPU) against the JAX package, at tiny sizes.

- the decode: B=2 with speakers 0 and 2, each row its own description
  (dim 24) and a GST of 32 columns, so D = enc + 128 + S = 224 in JAX's
  order, 66 frames, against JAX ``forward_infer_fused(interpret=True)``
  and ``forward_infer_fast``, with a reference mel and with the neutral
  style, prenet dropout off, within tests/test_torch_controls.py's
  ``DECODE_TOL``; the port's per-step reference decode equals its chunked
  one (1e-5); a reference moves the mels; a row of a batch equals the row
  alone; ``_encode`` wants the style, of the batch's shape;
- training: ``forward_teacher`` in train mode (the style of the batch's
  ground-truth mel, the GST's BatchNorm on batch statistics) with JAX's
  LSTM masks within 3e-5 of each output's max (test_torch_training.py's
  32-true limit), every BatchNorm's running statistics (the GST's six
  too) against JAX's ``new_state`` within 1e-5; the gradients of the loss
  against ``jax.grad`` of JAX's (``test_pallas_grad_with_gst``'s manner):
  within 1e-4 of each tensor's max, the GST convs' biases (a train-mode
  BatchNorm removes them: cancellation noise, JAX's own test floors them at
  5e-7) and the encoder convs' below 1e-6 on both sides; the style tokens
  get a gradient through K4's memory gradient; eval mode leaves the
  statistics alone;
- drivers: ``say --gst-reference`` (the reference's log-mel equal to JAX's
  frontend's, the audio other than the neutral say's) and its errors
  (a config without GST, another sample rate); the server's GST entry: the
  rows of one window each within 1 LSB of the request served alone; ``train``
  (2 steps) -> ``train --finetune`` of a tiny GST config through the CLI:
  the GST's weights and BatchNorm statistics move in both, the encoder
  stays bit for bit; ``test`` and ``train_mel_export`` of the checkpoint.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.audio.mel import TacotronMelSpectrogram as JaxMel
from tacotron2_tpu.models.layers import Policy as JaxPolicy
from tacotron2_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from tacotron2_tpu.models.tacotron2 import Tacotron2Config as JaxConfig
from tacotron2_tpu.ops import train_scan
from tacotron2_tpu.training.losses import tacotron2_loss as jax_loss
from tacotron2_tpu_torch.__main__ import main as port_cli
from tacotron2_tpu_torch.audio.io import read_wav, write_wav
from tacotron2_tpu_torch.config import load_config
from tacotron2_tpu_torch.convert import from_jax_params, load_tacotron2_checkpoint, to_lightning
from tacotron2_tpu_torch.models.layers import Policy
from tacotron2_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from tacotron2_tpu_torch.run import server as srv
from tacotron2_tpu_torch.run.say import model_config_from
from tacotron2_tpu_torch.training.losses import tacotron2_loss
from tests.test_torch_controls import DECODE_TOL
from tests.test_torch_decode import CFG as DEC_CFG
from tests.test_torch_decode import _inputs
from tests.test_torch_say import _files as _say_files
from tests.test_torch_train_cli import CHARS, TEXTS, _wav
from tests.test_torch_training import CFG as TRAIN_CFG
from tests.test_torch_training import NOISE_GRAD, _bn_state_close, _close

torch.set_num_threads(1)

S = 32  # the style's width in these tests (8 heads of 4)
DIM = 24  # the description embeddings' width
GST = dict(gst=True, gst_token_embedding_size=S)
EXT = dict(speaker_tokens=True, num_speakers=3, description_embeddings=True,
           description_embeddings_dim=DIM, **GST)
SPEAKERS = np.array([0, 2])
GST_NOISE_GRAD = tuple(f"gst.reference_encoder.convs.{i}.bias" for i in range(6))


def _descs(seed=5, n=2):
    return np.random.default_rng(seed).standard_normal((n, DIM)).astype(np.float32)


def _ref_mel(seed=8, B=2, T=70, M=16):
    return np.random.default_rng(seed).standard_normal((B, T, M)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _decode_models():
    jm = JaxTacotron2(JaxConfig(**DEC_CFG, **EXT))
    params, state = jm.init(jax.random.PRNGKey(0))
    params["decoder"]["gate"]["b"] = jnp.full_like(params["decoder"]["gate"]["b"], 3.0)
    tm = Tacotron2(Tacotron2Config(**DEC_CFG, **EXT))
    tm.load_state_dict(from_jax_params(params, state))
    return jm, params, state, tm.eval()


@pytest.mark.parametrize("jax_fn", ["forward_infer_fused", "forward_infer_fast"])
@pytest.mark.parametrize("reference", [False, True])
def test_gst_decode_matches_jax(jax_fn, reference):
    jm, params, state, tm = _decode_models()
    assert tm.cfg.encoded_full_dim == DEC_CFG["encoded_dim"] + 128 + S
    chars, lens = _inputs(2)
    kw = {"interpret": True} if jax_fn == "forward_infer_fused" else {}
    if reference:
        kw["gst_reference_mel"] = jnp.asarray(_ref_mel())
    ref = getattr(jm, jax_fn)(params, state, jnp.asarray(chars), jnp.asarray(lens), 66,
                              rng=jax.random.PRNGKey(7), prenet_dropout=False,
                              speaker_id=jnp.asarray(SPEAKERS),
                              description_embeddings=jnp.asarray(_descs()), **kw)
    out = tm.forward_infer_fast(torch.as_tensor(chars), torch.as_tensor(lens), 66,
                                prenet_dropout=False, speaker_id=torch.as_tensor(SPEAKERS),
                                description_embeddings=torch.as_tensor(_descs()),
                                gst_reference_mel=(torch.as_tensor(_ref_mel()) if reference
                                                   else None))
    assert int(out.n_frames) == int(ref.n_frames) == 66
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    for name, atol in DECODE_TOL.items():
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=atol, rtol=0, err_msg=name)


def test_memory_order_is_jax_order():
    """The memory's columns: the speaker-fused encoder, then the
    description's 128, then the style's S (JAX ``_encode``)."""
    jm, params, state, tm = _decode_models()
    chars, lens = _inputs(2)
    style = jm._infer_style(params, state, 2, None)
    ref, *_ = jm._encode(params, state, jnp.asarray(chars), jnp.asarray(lens), False, None,
                         jnp.asarray(SPEAKERS), jnp.asarray(_descs()), style=style)
    got, *_ = tm._encode(torch.as_tensor(chars), torch.as_tensor(lens),
                         speaker_id=torch.as_tensor(SPEAKERS),
                         description_embeddings=torch.as_tensor(_descs()),
                         gst_embedding=tm.gst_embedding(2))
    E = DEC_CFG["encoded_dim"]
    assert got.shape == (2, 9, E + 128 + S)
    _close(got, ref, 2e-5, "memory")
    _close(got[:, :, E + 128:], np.broadcast_to(np.asarray(style)[:, None], (2, 9, S)), 2e-5)


def test_reference_decode_and_batch_invariance():
    *_, tm = _decode_models()
    chars, lens = (torch.as_tensor(a) for a in _inputs(2))
    kw = dict(prenet_dropout=False, speaker_id=torch.as_tensor(SPEAKERS),
              description_embeddings=torch.as_tensor(_descs()))
    ref_mel = torch.as_tensor(_ref_mel())
    slow = tm.forward_infer(chars, lens, 40, gst_reference_mel=ref_mel, **kw)
    fast = tm.forward_infer_fast(chars, lens, 40, gst_reference_mel=ref_mel, **kw)
    assert fast.n_frames == slow.n_frames and torch.equal(fast.lengths, slow.lengths)
    for name in ("mels", "mels_post", "gates", "alignments"):
        torch.testing.assert_close(getattr(fast, name), getattr(slow, name), atol=1e-5, rtol=0)
    neutral = tm.forward_infer_fast(chars, lens, 40, **kw)
    # JAX's init gives a small style: the reference moves the mels by 1.3e-4
    assert (neutral.mels - fast.mels).abs().max() > 5e-5
    # the neutral style's row 1 alone equals row 1 of the batch (one row of
    # the style for every row), with a padded empty row (``encode_rows``) too
    alone = tm.forward_infer_fast(chars[1:], lens[1:], 40, prenet_dropout=False,
                                  speaker_id=torch.as_tensor(SPEAKERS[1:]),
                                  description_embeddings=torch.as_tensor(_descs()[1:]),
                                  encode_rows=4)
    torch.testing.assert_close(alone.mels[0], neutral.mels[1, :alone.mels.shape[1]], atol=1e-5,
                               rtol=0)


def test_encode_wants_the_style():
    *_, tm = _decode_models()
    chars, lens = (torch.as_tensor(a) for a in _inputs(2))
    kw = dict(speaker_id=torch.as_tensor(SPEAKERS), description_embeddings=torch.as_tensor(
        _descs()))
    with pytest.raises(ValueError, match="style embedding required"):
        tm._encode(chars, lens, **kw)
    with pytest.raises(ValueError, match="GST embedding of shape"):
        tm.forward_infer_fast(chars, lens, 4, gst_embedding=torch.zeros(2, S + 1), **kw)
    with pytest.raises(ValueError, match="GST reference mel of shape"):
        tm.forward_infer_fast(chars, lens, 4, gst_reference_mel=torch.zeros(2, 30, 15), **kw)


# ---------------------------------------------------------------------------
# training

B, L, T, H = 3, 9, 48, 32
INPUTS = ("chars_idx", "chars_len", "mel", "mel_len")


def _batch(seed=0):
    r = np.random.default_rng(seed)
    chars = r.integers(1, 16, size=(B, L)).astype(np.int64)
    chars[1, 6:] = 0
    mel = (r.standard_normal((B, T, 16)) * 0.5).astype(np.float32)
    mel[1, T - 6:] = 0.0
    gate = np.ones((B, T, 1), np.float32)
    gate[:, -1], gate[1, T - 7:] = 0.0, 0.0
    return {"chars_idx": chars, "chars_len": np.array([L, 6, L]), "mel": mel,
            "mel_len": np.array([T, T - 6, T]), "gate": gate}


def _masks(rng):
    """The LSTM masks JAX's forward_teacher draws from ``rng``."""
    keys = jax.random.split(jax.random.split(rng, 5)[3], T)
    m = jax.vmap(lambda k: train_scan._dropout_masks(k, (B, H), True))(keys)
    return tuple(torch.as_tensor(np.array(a)) for a in m)


@functools.lru_cache(maxsize=None)
def _train_models():
    jm = JaxTacotron2(JaxConfig(**TRAIN_CFG, **GST), JaxPolicy.from_string("32-true"))
    params, state = jm.init(jax.random.PRNGKey(0))
    return jm, params, state


def _port(params, state):
    m = Tacotron2(Tacotron2Config(**TRAIN_CFG, **GST), Policy.from_string("32-true"))
    m.load_state_dict(from_jax_params(params, state))
    return m


def _gst_bn_close(model, gst_state, atol):
    for i, s in enumerate(gst_state["reference_encoder"]["bns"]):
        bn = model.gst.reference_encoder.bns[i]
        _close(bn.running_mean, s["mean"], atol, f"gst bn {i} mean")
        _close(bn.running_var, s["var"], atol * max(1.0, float(np.abs(s["var"]).max())),
               f"gst bn {i} var")


@pytest.mark.parametrize("train", [True, False])
def test_forward_teacher_with_gst_matches_jax(train):
    jm, params, state = _train_models()
    b = _batch()
    ref, new_state = jm.forward_teacher(
        params, state, *(jnp.asarray(b[k]) for k in INPUTS), rng=jax.random.PRNGKey(3),
        train=train, dw_hoist=True, pallas_train=True)
    model = _port(params, state)
    masks = _masks(jax.random.PRNGKey(3)) if train else None
    with torch.no_grad():
        out = model.forward_teacher(*(torch.as_tensor(b[k]) for k in INPUTS), train=train,
                                    lstm_masks=masks)
    for name in ("mels", "mels_post", "gates", "alignments"):
        r = np.asarray(getattr(ref, name))
        _close(getattr(out, name), r, 3e-5 * float(np.abs(r).max()) + 1e-6, name)
    _bn_state_close(model, new_state, 1e-5)
    _gst_bn_close(model, new_state["gst"], 1e-5)
    moved = not np.array_equal(np.asarray(new_state["gst"]["reference_encoder"]["bns"][0]["mean"]),
                               np.asarray(state["gst"]["reference_encoder"]["bns"][0]["mean"]))
    assert moved == train


def test_gst_gradients_match_jax():
    jm, params, state = _train_models()
    b = _batch(1)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    rng = jax.random.PRNGKey(11)

    def f(p):
        out, _ = jm.forward_teacher(p, state, *(jb[k] for k in INPUTS), rng=rng, train=True,
                                    dw_hoist=True, pallas_train=True)
        return jax_loss(out.mels, out.mels_post, out.gates, jb["mel"], jb["gate"])[0]

    g_ref = from_jax_params(jax.tree.map(np.asarray, jax.grad(f)(params)), None)
    model = _port(params, state)
    out = model.forward_teacher(*(torch.as_tensor(b[k]) for k in INPUTS), train=True,
                                lstm_masks=_masks(rng))
    loss, _ = tacotron2_loss(out.mels, out.mels_post, out.gates, torch.as_tensor(b["mel"]),
                             torch.as_tensor(b["gate"]))
    loss.backward()
    named = dict(model.named_parameters())
    assert set(named) == set(g_ref) and "gst.stl.embed" in named
    for k, g in g_ref.items():
        g = g.numpy()
        if k in NOISE_GRAD or k in GST_NOISE_GRAD:
            assert max(np.abs(g).max(), float(named[k].grad.abs().max())) < 1e-6, k
        else:
            _close(named[k].grad, g, 1e-4 * float(np.abs(g).max()) + 1e-9, f"grad {k}")
    assert float(named["gst.stl.embed"].grad.abs().max()) > 1e-6


# ---------------------------------------------------------------------------
# the drivers


def _gst_files(tmp_path, gate_bias=3.0):
    """test_torch_say's tiny files as a GST model (32 columns of style)."""
    cfg_path, ckpt, g_path = _say_files(tmp_path, gate_bias)
    raw = json.loads(open(cfg_path).read())
    raw["extensions"] = {"gst": {"active": True, "token_embedding_size": S}}
    open(cfg_path, "w").write(json.dumps(raw))
    torch.manual_seed(2)
    model = Tacotron2(model_config_from(load_config(cfg_path)))
    with torch.no_grad():
        model.decoder.gate.bias.fill_(gate_bias)
        model.gst.stl.attention.W_value.weight.mul_(8.0)  # a style that moves the audio
    torch.save(to_lightning(model.state_dict()), ckpt)
    return cfg_path, ckpt, g_path


def _ref_wav(path, sr=22050, secs=0.8):
    t = np.arange(int(sr * secs)) / sr
    wav = 0.3 * np.sin(2 * np.pi * 170 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    write_wav(str(path), wav.astype(np.float32), sr)
    return str(path)


def test_say_gst_reference(tmp_path, monkeypatch):
    cfg_path, ckpt, g_path = _gst_files(tmp_path)
    ref = _ref_wav(tmp_path / "ref.wav")
    common = ["say", "--config", cfg_path, "--checkpoint", ckpt, "--hifi-gan-checkpoint", g_path,
              "--text", "Hello there.", "--random-seed", "7", "--max-len-override", "24",
              "--device", "cpu"]
    from tacotron2_tpu_torch.run import say as port_say

    seen = []
    infer = Tacotron2.forward_infer_fast

    def catching(self, *a, **k):
        seen.append(k.get("gst_reference_mel"))
        return infer(self, *a, **k)

    monkeypatch.setattr(Tacotron2, "forward_infer_fast", catching)
    res = port_cli(common + ["--out", str(tmp_path / "ref_say.wav"), "--gst-reference", ref])
    neutral = port_cli(common + ["--out", str(tmp_path / "neutral.wav")])
    assert res["gst_reference"] == ref and neutral["gst_reference"] is None
    assert seen[1] is None
    want = JaxMel(n_mels=16, sample_rate=22050)(read_wav(ref)[0])
    np.testing.assert_allclose(seen[0][0].numpy(), want, atol=1e-5, rtol=0)
    a, b = (read_wav(str(tmp_path / n))[0] for n in ("ref_say.wav", "neutral.wav"))
    assert len(a) == len(b) == 23 * 256 and np.abs(a - b).max() > 0
    assert port_say.gst_reference_mel(load_config(cfg_path), ref).shape == (1, len(want), 16)


def test_say_gst_reference_errors(tmp_path):
    cfg_path, ckpt, _ = _gst_files(tmp_path)
    argv = ["say", "--config", cfg_path, "--checkpoint", ckpt, "--text", "x", "--out",
            str(tmp_path / "o.wav"), "--device", "cpu", "--max-len-override", "4"]
    with pytest.raises(ValueError, match="sample rate 16000 != configured 22050"):
        port_cli(argv + ["--gst-reference", _ref_wav(tmp_path / "r16.wav", 16000)])
    (tmp_path / "v").mkdir()
    vanilla, v_ckpt, _ = _say_files(tmp_path / "v", 3.0)
    with pytest.raises(ValueError, match="extensions.gst is not active"):
        port_cli(["say", "--config", vanilla, "--checkpoint", v_ckpt, "--text", "x", "--out",
                  str(tmp_path / "v.wav"), "--device", "cpu",
                  "--gst-reference", _ref_wav(tmp_path / "r.wav")])
    assert not (tmp_path / "o.wav").exists() and not (tmp_path / "v.wav").exists()


def test_server_gst_rows_equal_alone(tmp_path, monkeypatch):
    """A window of three requests of a GST entry: each row's audio equals
    the same request served alone (the neutral style one row for all)."""
    monkeypatch.chdir(tmp_path)
    cfg_path, ckpt, g_path = _gst_files(tmp_path)
    entry = {"name": "gst", "config": cfg_path, "checkpoint": ckpt, "hifi_gan_checkpoint": g_path,
             "max_len": 40}
    app = srv.App({"models": [entry], "batching": {"max_batch": 4}}, device="cpu")
    try:
        bundle = app.registry.load(0)
        reqs = [{"text": t, "seed": 3 + i, "use_vocoder": True,
                 "out_path": str(tmp_path / f"w{i}.wav")}
                for i, t in enumerate(("one style.", "and another one", "three"))]
        srv.synthesize_batch(bundle, reqs, 4)
        for i, r in enumerate(reqs):
            alone = dict(r, out_path=str(tmp_path / f"a{i}.wav"))
            srv.synthesize_batch(bundle, [alone], 4)
            a, b = read_wav(r["out_path"])[0], read_wav(alone["out_path"])[0]
            # 1 LSB on the CPU, whose convs sum another batch in another
            # order (test_torch_serve.py's limit); the card's run holds 0
            assert a.shape == b.shape and np.abs(a - b).max() <= 1 / 32768, i
        assert bundle.gst_embedding.shape == (1, S)
    finally:
        app.close(wait=True)


def _gst_corpus(tmp_path):
    speech = tmp_path / "speech"
    speech.mkdir()
    lines = ["text|wav"]
    for i in range(6):
        write_wav(str(speech / f"u{i}.wav"), _wav(i, 4000 + 300 * i), 22050)
        lines.append(f"{TEXTS[i % 4]}|u{i}.wav")
    csv = tmp_path / "m.csv"
    csv.write_text("\n".join(lines) + "\n")
    return speech, str(csv)


def test_train_finetune_and_eval_drivers_cli(tmp_path):
    """train (2 steps) -> train --finetune (2 steps) -> test and
    train_mel_export of a tiny GST config through the CLI."""
    speech, csv = _gst_corpus(tmp_path)
    raw = {
        "dataset": {"train": csv, "val": csv, "test": csv,
                    "preprocessing": {"allowed_chars": CHARS, "end_token": "^", "num_mels": 16,
                                      "trim": False, "cache": False}},
        "training": {"lr": 1e-2, "batch_size": 2, "weight_decay": 1e-6,
                     "precision": "32-true", "name": "gst", "args": {"max_steps": 2}},
        "model": {"scheduler_milestones": [],
                  "args": {"encoded_dim": 32, "encoder_kernel_size": 5, "prenet_dim": 16,
                           "att_rnn_dim": 32, "att_dim": 16, "rnn_hidden_dim": 32,
                           "postnet_dim": 16, "dropout": 0.1}},
        "extensions": {"gst": {"active": True, "token_embedding_size": S}},
    }
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(raw))
    base = ["train", "--config", str(cfg), "--speech-dir", str(speech), "--device", "cpu"]
    pre = port_cli(base + ["--results-dir", str(tmp_path / "pre")])
    ft = port_cli(base + ["--results-dir", str(tmp_path / "ft"), "--resume-ckpt",
                          pre["checkpoint"], "--finetune", "--finetune-steps", "2"])
    assert pre["step"] == 2 and ft["step"] == 4
    assert all(np.isfinite(r["loss"]) for r in pre["steps"] + ft["steps"])
    torch.manual_seed(0)  # train's seed 0: the initial weights
    init = Tacotron2(model_config_from(load_config(str(cfg)))).state_dict()
    a = load_tacotron2_checkpoint(pre["checkpoint"])[0]
    b = load_tacotron2_checkpoint(ft["checkpoint"])[0]
    for k in ("gst.stl.embed", "gst.reference_encoder.convs.0.weight",
              "gst.reference_encoder.gru.weight_hh_l0", "gst.stl.attention.W_query.weight",
              "gst.reference_encoder.bns.2.running_mean", "gst.reference_encoder.bns.5.running_var"):
        assert not torch.equal(init[k], a[k]), k  # train moved it
        assert not torch.equal(a[k], b[k]), k  # and so did the finetune
    for k in a:
        if k.startswith("encoder.") and "running_" not in k and "num_batches" not in k:
            assert torch.equal(a[k], b[k]), k
    test = port_cli(["test", "--config", str(cfg), "--speech-dir", str(speech), "--checkpoint",
                     ft["checkpoint"], "--results-dir", str(tmp_path / "test"),
                     "--max-len-override", "32", "--device", "cpu"])
    assert test["rows"] == 6
    exp = port_cli(["train_mel_export", "--config", str(cfg), "--speech-dir", str(speech),
                    "--checkpoint", ft["checkpoint"], "--results-dir", str(tmp_path / "mels"),
                    "--device", "cpu"])
    assert len(exp["train"]["files"]) == 6
    mel = np.load(exp["train"]["files"][0])
    assert mel.shape[1] == 16 and np.isfinite(mel).all()
