"""The port's ``test``, ``train_mel_export`` and ``say --export-mel`` (the
CLI, on the CPU) against the JAX package's ``run.test.do_test``,
``run.train_mel_export.do_train_mel_export`` and ``run.say.do_say`` on the
same files: a tiny corpus and config (dims 16-32, ``num_mels`` 16,
``dropout: 0.0``, so both frameworks use all-ones prenet masks and their
generators draw nothing that matters, ``32-true``), vanilla and with speaker
tokens and two control columns, one reference-format Lightning ``.ckpt``
and a HiFi-GAN ``g_*`` file.

The gate's bias is chosen from a probe decode of the test rows (the gate
does not feed back, so a bias only shifts its logits): at least one row
fails (fires at frame 0 or never within ``max_len``), and the others stop at
as many distinct frames in between as one bias allows.
Limits: the same ``failures.csv``, the same WAV names and lengths, PCM16
within 2 LSB with HiFi-GAN (the say tests' limit; on the CPU both vocode
in f32); each kept row's decoded mel within 5e-4 of JAX's, and with
Griffin-Lim, JAX's mel through both Griffin-Lims stage by stage (see
``GL_LINEAR_TOL``); the same ``.npy`` names and shapes, the
mels within 3e-5 of their max + 1e-6 (``test_torch_training.py``'s
``forward_teacher`` limit under 32-true); ``say --export-mel``'s mel within
5e-4 (``test_torch_decode.py``'s ``mels_post`` limit).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import run.test as jax_test_module
from run.common import jitted_cut_vocoder
from run.common import vocode as jax_vocode
from run.say import do_say as jax_do_say
from run.test import do_test as jax_do_test
from run.test import gate_to_lengths as jax_gate_to_lengths
from run.train_mel_export import do_train_mel_export as jax_do_export
from tacotron2_tpu.audio.griffin_lim import griffin_lim as jax_griffin_lim
from tacotron2_tpu.audio.griffin_lim import mel_to_linear as jax_mel_to_linear
from tacotron2_tpu.config import load_config as jax_load_config
import tacotron2_tpu_torch.run.test as port_test_module
from chip_smoke import choose_gate_bias
from tacotron2_tpu_torch.__main__ import main as port_cli
from tacotron2_tpu_torch.audio.griffin_lim import griffin_lim as port_griffin_lim
from tacotron2_tpu_torch.audio.griffin_lim import mel_to_audio as port_mel_to_audio
from tacotron2_tpu_torch.audio.griffin_lim import mel_to_linear as port_mel_to_linear
from tacotron2_tpu_torch.audio.io import read_wav, write_wav
from tacotron2_tpu_torch.config import load_config
from tacotron2_tpu_torch.convert import to_lightning
from tacotron2_tpu_torch.data.loader import collate
from tacotron2_tpu_torch.data.manifest import manifest_dataset, read_manifest
from tacotron2_tpu_torch.models.hifigan import HiFiGAN, HiFiGANConfig
from tacotron2_tpu_torch.models.tacotron2 import Tacotron2
from tacotron2_tpu_torch.run.say import cut_vocode, griffin_lim_vocode, model_config_from
from tacotron2_tpu_torch.run.test import gate_to_lengths

torch.set_num_threads(1)

CHARS = "!'(),.:;? \\-abcdefghijklmnopqrstuvwxyz"
TEXTS = ["utterance number zero.", "the first one, then", "a third; longer text here, and more",
         "and the fourth", "five", "the sixth utterance of the tiny corpus", "seven, eight",
         "and a ninth to end it"]
HIFIGAN = {"resblock": "1", "upsample_rates": [8, 8, 2, 2],
           "upsample_kernel_sizes": [16, 16, 4, 4], "upsample_initial_channel": 32,
           "resblock_kernel_sizes": [3, 7, 11],
           "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]], "num_mels": 16}
MAX_LEN = 40
GATE_MARGIN = 1e-4  # logits this far apart: a rounding difference moves no row's stop
# Griffin-Lim, held stage by stage on JAX's decoded mel of each kept row:
# mel -> linear within 1e-4 of its max (reads <= 8.5e-7), the phase
# iterations from the same linear magnitude within 1e-3 of the row's peak
# (test_torch_griffin_lim.py's limits; reads <= 1.5e-4, peaks 4.4-6.3,
# above full scale). The WAVs are not held end to end: on these 3-7 frame
# random-weight mels the iterations amplify the two NNLS solutions' float32
# rounding differences far past either stage's, and clip at full scale.
GL_LINEAR_TOL, GL_WAVE_TOL = 1e-4, 1e-3
DECODE_MEL_TOL = 5e-4  # test_torch_decode.py's mels_post limit
FEATURES = ["pitch_norm", "rate_norm"]


def _wav(seed: int, n: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    t = np.arange(n) / 22050
    x = sum(np.sin(2 * np.pi * k * (110 + 30 * seed) * t) / k for k in range(1, 5))
    return (0.2 * x + 0.01 * r.standard_normal(n)).astype(np.float32)


def _manifest(path, rows, controls: bool):
    cols = ["text", "wav"] + (["speaker_id", *FEATURES] if controls else [])
    lines = ["|".join(cols)]
    for i in rows:
        line = [TEXTS[i], f"u{i}.wav"]
        if controls:
            line += [str(i % 3), repr(0.3 * float(np.sin(i))), repr(-0.5 + 0.1 * i)]
        lines.append("|".join(line))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _project(tmp_path, controls: bool):
    """The corpus (8 WAVs; train 0-4, val 3-5, test 2-7), the config, the
    HiFi-GAN file, and the model with its gate bias to be chosen."""
    speech = tmp_path / "speech"
    speech.mkdir()
    for i in range(len(TEXTS)):
        write_wav(str(speech / f"u{i}.wav"), _wav(i, 4000 + 900 * i), 22050)
    ext = ({"speaker_tokens": {"active": True, "num_speakers": 3},
            "controls": {"active": True, "features": FEATURES}} if controls else {})
    raw = {
        "dataset": {"train": _manifest(tmp_path / "train.csv", range(5), controls),
                    "val": _manifest(tmp_path / "val.csv", range(3, 6), controls),
                    "test": _manifest(tmp_path / "test.csv", range(2, 8), controls),
                    "preprocessing": {"allowed_chars": CHARS, "end_token": "^", "num_mels": 16,
                                      "trim": False, "silence": 256, "cache": True,
                                      "expand_abbreviations": True}},
        "training": {"precision": "32-true", "batch_size": 2},
        "model": {"args": {"encoded_dim": 32, "encoder_kernel_size": 5, "prenet_dim": 16,
                           "att_rnn_dim": 32, "att_dim": 16, "rnn_hidden_dim": 32,
                           "postnet_dim": 16, "dropout": 0.0}},
        "extensions": ext,
    }
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(raw))
    torch.manual_seed(3)
    model = Tacotron2(model_config_from(load_config(str(cfg_path)))).eval()
    with torch.no_grad():
        for bn in (m for m in model.modules() if isinstance(m, torch.nn.BatchNorm1d)):
            bn.running_mean.normal_(0.0, 0.1)
            bn.running_var.uniform_(0.5, 1.5)

    hdir = tmp_path / "hifigan"
    hdir.mkdir()
    (hdir / "config.json").write_text(json.dumps(HIFIGAN))
    torch.manual_seed(1)
    g_path = hdir / "g_00000001"
    torch.save({"generator": HiFiGAN(HiFiGANConfig.from_dict(HIFIGAN)).state_dict()}, g_path)
    return str(speech), str(cfg_path), model, str(g_path)


def _gate_bias(model, cfg_path, speech) -> tuple:
    """Probe the test batch with the gate held positive, its row as drawn
    and negated (the tiny decoder settles in a few frames, so a row's logits
    only rise or only fall); -> the bias of ``choose_gate_bias`` for the
    better of the two, whose row the model keeps, and the frame counts it
    gives."""
    best = None
    for sign in (1.0, -1.0):
        with torch.no_grad():
            model.decoder.gate.weight.mul_(sign)
        bias, n = _probe(model, cfg_path, speech)
        score = (len(set(n.tolist()) - {0, MAX_LEN}), sign)
        if best is None or score > best[0]:
            best = (score, bias, n)
        with torch.no_grad():
            model.decoder.gate.weight.mul_(sign)
    with torch.no_grad():
        model.decoder.gate.weight.mul_(best[0][1])
    return best[1], best[2]


def _probe(model, cfg_path, speech) -> tuple:
    cfg = load_config(cfg_path)
    ds = manifest_dataset(cfg, read_manifest(cfg.dataset.test), speech, cache=False)
    b = collate([ds[i] for i in range(len(ds))], bucket_chars=32)
    kw = {}
    if "speaker_id" in b:
        kw = {"speaker_id": torch.as_tensor(b["speaker_id"]),
              "controls": torch.as_tensor(b["controls"])}
    probe = 50.0
    with torch.no_grad():
        model.decoder.gate.bias.fill_(probe)
        out = model.forward_infer_fast(torch.as_tensor(b["chars_idx"]),
                                       torch.as_tensor(b["chars_len"]), MAX_LEN, **kw)
    return choose_gate_bias(out.gates[..., 0].numpy() - probe, margin=GATE_MARGIN)


def _save(model, bias, path) -> str:
    with torch.no_grad():
        model.decoder.gate.bias.fill_(bias)
    torch.save(to_lightning(model.state_dict()), path)
    return str(path)


def test_gate_to_lengths_matches_jax():
    rng = np.random.default_rng(0)
    gates = rng.uniform(0.1, 1.0, (5, 12, 1)).astype(np.float32)
    gates[0, 0] = -1.0  # fires at frame 0
    gates[1, 4] = -0.5  # fires mid-way, and again later
    gates[1, 9] = -0.2
    gates[2, 11] = -3.0  # at the last frame
    gates[3, 6:] = -1000.0  # the masked tail of a stopped row
    # row 4 never fires
    got = gate_to_lengths(gates)
    np.testing.assert_array_equal(got, jax_gate_to_lengths(gates))
    np.testing.assert_array_equal(got, [0, 4, 11, 6, 12])


def _pcm(path):
    wav, sr = read_wav(path)
    assert sr == 22050
    return np.round(wav * 32768).astype(np.int64)


def _bucketed_vocode(mel_post, hifigan, hifi_params, sample_rate):
    """JAX's vocode of one row as its ``say`` and server vocode it
    (``jitted_cut_vocoder``: the row in a 128-frame bucket past its
    receptive field, the frames past its end zeroed), PCM16."""
    if hifigan is None:
        return jax_vocode(mel_post, hifigan, hifi_params, sample_rate)
    n = mel_post.shape[0]
    Tb = -(-(n + hifigan.mel_receptive_field()) // 128) * 128
    pcm = jitted_cut_vocoder(hifigan)(hifi_params, jnp.asarray(mel_post[None]),
                                      jnp.asarray([0], jnp.int32), jnp.asarray([n], jnp.int32),
                                      Tb)
    return np.asarray(pcm)[0, :n * 256]


@pytest.mark.parametrize("controls", [False, True], ids=["vanilla", "controls"])
@pytest.mark.parametrize("vocoder", ["hifigan", "griffin_lim"])
def test_test_matches_jax(tmp_path, monkeypatch, vocoder, controls):
    """With HiFi-GAN the port vocodes a batch's rows in one bucket (as the
    JAX ``say`` and server do), the JAX ``test`` each row alone at its exact
    length, where every layer's zero padding starts at the row's end: the
    samples within the generator's receptive field of the end differ (by up
    to 9,095 LSB on these random weights; these rows of 3-7 frames lie
    wholly within it). So the WAVs are held against JAX's ``test`` with its
    vocode made the bucketed one of its own ``say`` (``jitted_cut_vocoder``)."""
    speech, cfg_path, model, g_path = _project(tmp_path, controls)
    bias, want = _gate_bias(model, cfg_path, speech)
    ckpt = _save(model, bias, tmp_path / "model.ckpt")
    g = ["--hifi-gan-checkpoint", g_path] if vocoder == "hifigan" else []
    port_mels = []

    def gl_spy(mel_post, sr):
        port_mels.append(mel_post.numpy().copy())
        return griffin_lim_vocode(mel_post, sr)

    def cut_spy(hifigan, mels_post, rows, cuts, Tb):
        port_mels.extend(mels_post[r, :c].numpy().copy() for r, c in zip(rows, cuts))
        return cut_vocode(hifigan, mels_post, rows, cuts, Tb)

    monkeypatch.setattr(port_test_module, "griffin_lim_vocode", gl_spy)
    monkeypatch.setattr(port_test_module, "cut_vocode", cut_spy)
    res = port_cli(["test", "--config", cfg_path, "--speech-dir", speech, "--checkpoint", ckpt,
                    "--results-dir", str(tmp_path / "port"), "--max-len-override",
                    str(MAX_LEN), "--device", "cpu"] + g)
    jax_mels = []

    def jax_vocode_spy(mel_post, *a):
        jax_mels.append(np.array(mel_post))
        return _bucketed_vocode(mel_post, *a)

    monkeypatch.setattr(jax_test_module, "vocode", jax_vocode_spy)
    jax_do_test(jax_load_config(cfg_path), 0, speech, ckpt,
                g_path if vocoder == "hifigan" else None, results_dir=str(tmp_path / "jax"),
                max_len_override=MAX_LEN)
    assert res["lengths"] == list(want) and res["vocoder"] == vocoder
    assert {0, MAX_LEN} & set(want) and len(set(want) - {0, MAX_LEN}) >= 2, want
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    fails = (tmp_path / "port" / "failures.csv").read_text()
    assert fails == (tmp_path / "jax" / "failures.csv").read_text()
    assert [int(x.split("|")[0]) for x in fails.splitlines()] == [
        i for i, n in enumerate(want) if n in (0, MAX_LEN)]
    kept = [i for i, n in enumerate(want) if 0 < n < MAX_LEN]
    wavs = [n for n in names if n.endswith(".wav")]
    assert sorted(wavs) == sorted(f"{i}.wav" for i in kept)
    assert len(port_mels) == len(jax_mels) == len(kept)
    for i, a, b in zip(kept, port_mels, jax_mels):
        assert a.shape == b.shape == (want[i], 16)
        np.testing.assert_allclose(a, b, rtol=0, atol=DECODE_MEL_TOL)
        pa, pb = _pcm(tmp_path / "port" / f"{i}.wav"), _pcm(tmp_path / "jax" / f"{i}.wav")
        assert len(pa) == len(pb) == (want[i] if vocoder == "hifigan" else want[i] - 1) * 256
        if vocoder == "hifigan":
            assert np.abs(pa - pb).max() <= 2, i
            continue
        # the driver wrote Griffin-Lim of exp(its decoded mel), cut to n hops
        again = port_mel_to_audio(torch.exp(torch.as_tensor(a)), 22050).numpy()
        write_wav(str(tmp_path / "again.wav"), again[:want[i] * 256], 22050)
        assert (tmp_path / "again.wav").read_bytes() == \
            (tmp_path / "port" / f"{i}.wav").read_bytes(), i
        lin_ref = np.array(jax_mel_to_linear(np.exp(b)))
        lin = port_mel_to_linear(torch.exp(torch.as_tensor(b))).numpy()
        assert np.abs(lin - lin_ref).max() <= GL_LINEAR_TOL * np.abs(lin_ref).max(), i
        wave_ref = jax_griffin_lim(lin_ref)
        wave = port_griffin_lim(torch.as_tensor(lin_ref)).numpy()
        assert wave.shape == wave_ref.shape == ((want[i] - 1) * 256,)
        assert np.abs(wave - wave_ref).max() <= GL_WAVE_TOL * np.abs(wave_ref).max(), i


def _test_cli(tmp_path, vocoder):
    speech, cfg_path, model, g_path = _project(tmp_path, False)
    bias, want = _gate_bias(model, cfg_path, speech)
    ckpt = _save(model, bias, tmp_path / "model.ckpt")
    g = ["--hifi-gan-checkpoint", g_path] if vocoder == "hifigan" else []
    return want, ["test", "--config", cfg_path, "--speech-dir", speech, "--checkpoint", ckpt,
                  "--results-dir", str(tmp_path / "port"), "--max-len-override", str(MAX_LEN),
                  "--device", "cpu"] + g


def test_test_raises_when_hifigan_raises(tmp_path, monkeypatch):
    """An error of the batch's HiFi-GAN call (a kernel that fails to build
    or launch, a CUDA fault) ends ``test``; it does not turn the batch's
    rows into failures."""
    _, argv = _test_cli(tmp_path, "hifigan")

    def broken(*a, **kw):
        raise RuntimeError("vocoder kernel failed")

    monkeypatch.setattr(port_test_module, "cut_vocode", broken)
    with pytest.raises(RuntimeError, match="vocoder kernel failed"):
        port_cli(argv)
    assert not (tmp_path / "port" / "failures.csv").exists()


def test_test_griffin_lim_error_is_a_failure(tmp_path, monkeypatch):
    """As JAX's ``test``: a row whose Griffin-Lim raises (degenerate input)
    is a failure, and the other rows are written."""
    want, argv = _test_cli(tmp_path, "griffin_lim")
    kept = [i for i, n in enumerate(want) if 0 < n < MAX_LEN]
    calls = []

    def flaky(mel_post, sr):
        calls.append(len(calls))
        if len(calls) == 1:
            raise ValueError("degenerate mel")
        return griffin_lim_vocode(mel_post, sr)

    monkeypatch.setattr(port_test_module, "griffin_lim_vocode", flaky)
    res = port_cli(argv)
    assert len(calls) == len(kept) >= 2
    lost = kept[0]
    assert [i for i, _ in res["failures"]] == sorted(
        [i for i, n in enumerate(want) if n in (0, MAX_LEN)] + [lost])
    assert sorted(p.name for p in (tmp_path / "port").glob("*.wav")) == sorted(
        f"{i}.wav" for i in kept[1:])


@pytest.mark.parametrize("controls", [False, True], ids=["vanilla", "controls"])
def test_train_mel_export_matches_jax(tmp_path, controls):
    speech, cfg_path, model, _ = _project(tmp_path, controls)
    ckpt = _save(model, 0.5, tmp_path / "model.ckpt")
    res = port_cli(["train_mel_export", "--config", cfg_path, "--speech-dir", speech,
                    "--checkpoint", ckpt, "--results-dir", str(tmp_path / "port"),
                    "--device", "cpu"])
    jax_do_export(jax_load_config(cfg_path), 0, speech, ckpt, results_dir=str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [f"u{i}.npy" for i in range(6)]
    assert [len(res[s]["files"]) for s in ("train", "val")] == [5, 3]
    for name in names:
        a, b = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert a.shape == b.shape and a.shape[1] == 16 and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=3e-5 * float(np.abs(b).max()) + 1e-6,
                                   err_msg=name)


def test_train_mel_export_names_flac_rows(tmp_path):
    """A ``.flac`` row keeps its name and gets ``.npy`` added, as JAX's."""
    from tests.flac_encoder import encode_flac

    speech, cfg_path, model, _ = _project(tmp_path, False)
    (tmp_path / "speech" / "u1.flac").write_bytes(
        encode_flac((_wav(1, 4900) * 32000).astype(np.int64)))
    raw = json.loads(open(cfg_path).read())
    for split in ("train", "val"):
        (tmp_path / f"{split}_flac.csv").write_text(f"text|wav\n{TEXTS[1]}|u1.flac\n")
        raw["dataset"][split] = str(tmp_path / f"{split}_flac.csv")
    (tmp_path / "cfg.json").write_text(json.dumps(raw))
    ckpt = _save(model, 0.5, tmp_path / "model.ckpt")
    res = port_cli(["train_mel_export", "--config", cfg_path, "--speech-dir", speech,
                    "--checkpoint", ckpt, "--results-dir", str(tmp_path / "port"),
                    "--device", "cpu"])
    jax_do_export(jax_load_config(cfg_path), 0, speech, ckpt, results_dir=str(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        "u1.flac.npy"]
    assert res["val"]["files"] == [str(tmp_path / "port" / "u1.flac.npy")]
    a, b = np.load(tmp_path / "port" / "u1.flac.npy"), np.load(tmp_path / "jax" / "u1.flac.npy")
    np.testing.assert_allclose(a, b, rtol=0, atol=3e-5 * float(np.abs(b).max()) + 1e-6)


@pytest.mark.parametrize("controls", [False, True], ids=["vanilla", "controls"])
def test_say_export_mel_matches_jax(tmp_path, controls):
    speech, cfg_path, model, g_path = _project(tmp_path, controls)
    ckpt = _save(model, 3.0, tmp_path / "model.ckpt")
    cond = (["--speaker-id", "2", "--controls", "0.3,-0.4"] if controls else [])
    out = tmp_path / "port.wav"
    res = port_cli(["say", "--config", cfg_path, "--checkpoint", ckpt, "--hifi-gan-checkpoint",
                    g_path, "--text", TEXTS[2], "--out", str(out), "--random-seed", "7",
                    "--max-len-override", "24", "--export-mel", "--device", "cpu"] + cond)
    jax_do_say(jax_load_config(cfg_path), 0, ckpt, TEXTS[2], str(tmp_path / "jax.wav"),
               hifi_gan_checkpoint=g_path, random_seed=7, max_len_override=24,
               export_mel=True, speaker_id=2 if controls else None,
               controls="0.3,-0.4" if controls else None)
    a, b = np.load(str(out) + ".npy"), np.load(tmp_path / "jax.wav.npy")
    assert a.shape == b.shape == (16, res["cut"]) == (16, 23)
    np.testing.assert_allclose(a, b, rtol=0, atol=5e-4)
    assert np.abs(_pcm(out) - _pcm(tmp_path / "jax.wav")).max() <= 2


def test_mel_export_keeps_no_residuals():
    """Under ``no_grad`` (``train_mel_export``) the teacher-forced decode
    keeps none of the residual stacks K4 would read once it has returned:
    at B=64, T=896 they hold ~1 GB."""
    import gc
    import weakref

    from tacotron2_tpu_torch.models.tacotron2 import Tacotron2Config
    from tacotron2_tpu_torch.ops import train_decode as td

    torch.manual_seed(0)
    dec = Tacotron2(Tacotron2Config(num_chars=20, encoded_dim=32, prenet_dim=16, att_rnn_dim=32,
                                    att_dim=16, rnn_hidden_dim=32, postnet_dim=16,
                                    num_mels=16)).decoder
    kept, forward = [], td.teacher_forward

    def spy(*a):
        mel_gate, res = forward(*a)
        kept.extend(weakref.ref(t) for name, t in res._asdict().items() if name != "al")
        return mel_gate, res

    ones = torch.ones(12, 2, 32)
    args = (torch.randn(12, 2, 16), torch.randn(2, 7, 32), torch.randn(2, 7, 16),
            torch.tensor([7, 5]), ones, ones, torch.float32)
    td.teacher_forward = spy
    try:
        with torch.no_grad():
            mels, gates, aligns = td.teacher_decode(dec, *args)
        gc.collect()
        assert kept and all(r() is None for r in kept)
        mels_grad = td.teacher_decode(dec, *args)[0]  # with autograd the backward keeps them
        assert mels_grad.requires_grad and all(r() is not None for r in kept[-5:])
    finally:
        td.teacher_forward = forward
    assert mels.shape == (12, 2, 16) and gates.shape == (12, 2) and aligns.shape == (12, 2, 7)
