"""The port's training input pipeline and ``train`` command on the CPU, at a
tiny config (dims 16-32, ``num_mels`` 16):

- the port's log-mel against the JAX package's numpy mel on the same WAV
  (1e-5);
- the port's dataset items and ``collate`` against the JAX ``TTSDataset`` and
  ``collate`` (equal arrays);
- ``python -m tacotron2_tpu_torch train`` for 3 steps on a 4-WAV corpus, then
  ``--resume-ckpt`` to step 5; ``final.ckpt`` holds the optimizer state, the
  schedule and the step, the scalars are logged under their JAX names, and
  ``say --device cpu --max-len-override 8`` loads the checkpoint.
"""

import json

import numpy as np
import pytest
import torch

from tacotron2_tpu.audio.mel import TacotronMelSpectrogram as JaxMel
from tacotron2_tpu.data.dataset import TTSDataset as JaxDataset
from tacotron2_tpu.data.loader import collate as jax_collate
from tacotron2_tpu_torch.__main__ import main as cli
from tacotron2_tpu_torch.audio.io import read_wav, write_wav
from tacotron2_tpu_torch.audio.mel import TacotronMelSpectrogram
from tacotron2_tpu_torch.data.dataset import TTSDataset
from tacotron2_tpu_torch.data.loader import collate
from tacotron2_tpu_torch.models.hifigan import HiFiGAN, HiFiGANConfig

torch.set_num_threads(1)

CHARS = "!'(),.:;? \\-abcdefghijklmnopqrstuvwxyz"
TEXTS = ["utterance number zero.", "the first one, then", "a third; longer text here",
         "and the fourth"]
HIFIGAN = {"resblock": "1", "upsample_rates": [8, 8, 2, 2],
           "upsample_kernel_sizes": [16, 16, 4, 4], "upsample_initial_channel": 32,
           "resblock_kernel_sizes": [3, 7, 11],
           "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]], "num_mels": 16}


def _wav(seed: int, n: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    t = np.arange(n) / 22050
    f0 = 120 + 40 * seed
    x = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 5))
    return (0.2 * x + 0.01 * r.standard_normal(n)).astype(np.float32)


def _corpus(tmp_path):
    speech = tmp_path / "speech"
    speech.mkdir()
    for i in range(4):
        write_wav(str(speech / f"u{i}.wav"), _wav(i, 5000 + 700 * i), 22050)
    csv = tmp_path / "manifest.csv"
    csv.write_text("text|wav\n" + "".join(f"{t}|u{i}.wav\n" for i, t in enumerate(TEXTS)))
    raw = {
        "dataset": {"train": str(csv), "val": str(csv),
                    "preprocessing": {"allowed_chars": CHARS, "end_token": "^", "num_mels": 16,
                                      "trim": True, "silence": 512, "cache": False,
                                      "expand_abbreviations": True}},
        "training": {"lr": 1e-3, "batch_size": 2, "weight_decay": 1e-6,
                     "precision": "32-true", "name": "tiny", "args": {"max_steps": 3}},
        "model": {"scheduler_milestones": [0.5, 0.75],
                  "args": {"encoded_dim": 32, "encoder_kernel_size": 5, "prenet_dim": 16,
                           "att_rnn_dim": 32, "att_dim": 16, "rnn_hidden_dim": 32,
                           "postnet_dim": 16, "dropout": 0.1}},
        "extensions": {},
    }
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(raw))
    return speech, csv, str(cfg)


@pytest.mark.parametrize("n_mels,n", [(16, 5000), (80, 22050)])
def test_mel_matches_jax_numpy(n_mels, n):
    wav = _wav(3, n)
    ref = JaxMel(n_mels=n_mels)(wav, backend="numpy")
    got = TacotronMelSpectrogram(n_mels=n_mels)(wav)
    assert got.shape == ref.shape == (1 + n // 256, n_mels)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_dataset_and_collate_match_jax(tmp_path):
    speech, _, _ = _corpus(tmp_path)
    files = [f"u{i}.wav" for i in range(4)]
    kw = dict(allowed_chars=CHARS, end_token="^", silence=512, trim=True, num_mels=16,
              expand_abbreviations=True)
    port = TTSDataset(files, TEXTS, str(speech), **kw)
    ref = JaxDataset(files, TEXTS, str(speech), **kw)
    items, ref_items = [port[i] for i in range(4)], [ref[i] for i in range(4)]
    for (d, m, _), (rd, rm, _) in zip(items, ref_items):
        np.testing.assert_array_equal(d["chars_idx"], rd["chars_idx"])
        np.testing.assert_array_equal(d["gate"], rd["gate"])
        np.testing.assert_allclose(d["mel_spectrogram"], rd["mel_spectrogram"], atol=1e-5, rtol=0)
        assert m == rm
    for buckets in ((None, None), (32, 128)):
        got, want = collate(ref_items, *buckets), jax_collate(ref_items, *buckets)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _hifigan(tmp_path) -> str:
    hdir = tmp_path / "hifigan"
    hdir.mkdir()
    (hdir / "config.json").write_text(json.dumps(HIFIGAN))
    torch.manual_seed(1)
    g_path = hdir / "g_00000001"
    torch.save({"generator": HiFiGAN(HiFiGANConfig.from_dict(HIFIGAN)).state_dict()}, g_path)
    return str(g_path)


def test_train_resume_and_say(tmp_path):
    speech, _, cfg = _corpus(tmp_path)
    base = ["train", "--config", cfg, "--speech-dir", str(speech), "--device", "cpu"]
    first = cli(base + ["--results-dir", str(tmp_path / "r1")])
    assert first["step"] == 3 and [s["step"] for s in first["steps"]] == [1, 2, 3]
    assert all(np.isfinite(s["loss"]) for s in first["steps"])
    assert {s["decode_frames"] for s in first["steps"]} == {128}
    ckpt = torch.load(first["checkpoint"], map_location="cpu", weights_only=False)
    assert ckpt["global_step"] == 3
    assert all(k.startswith("tacotron2.") for k in ckpt["state_dict"])
    n_params = sum(1 for k in ckpt["state_dict"] if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked")))
    state = ckpt["optimizer_states"][0]["state"]
    assert len(state) == n_params and all(int(s["step"]) == 3 for s in state.values())
    assert ckpt["lr_schedulers"][0]["last_epoch"] == 3
    assert ckpt["hyper_parameters"]["training"]["name"] == "tiny"

    second = cli(base + ["--results-dir", str(tmp_path / "r2"), "--resume-ckpt",
                         first["checkpoint"], "--max-steps", "5"])
    assert second["step"] == 5 and [s["step"] for s in second["steps"]] == [4, 5]
    resumed = torch.load(second["checkpoint"], map_location="cpu", weights_only=False)
    assert resumed["global_step"] == 5
    assert all(int(s["step"]) == 5 for s in resumed["optimizer_states"][0]["state"].values())
    # the first run's milestones (0.5 and 0.75 of 3 steps: steps 1 and 2)
    # took lr to 1e-5; the resumed run's (steps 2 and 3 of 5) lie behind it
    assert resumed["optimizer_states"][0]["param_groups"][0]["lr"] == pytest.approx(1e-5)

    rows = [json.loads(x) for x in (tmp_path / "r1" / "lightning_logs" / "tiny" /
                                    "metrics.jsonl").read_text().splitlines()]
    names = set().union(*rows)
    for k in ("training_gate_loss", "training_mel_loss", "training_mel_post_loss",
              "training_tacotron_loss", "training_loss", "training_grad_norm", "lr",
              "mel_frames_per_sec", "val_loss", "val_mel_loss"):
        assert k in names, k

    out = str(tmp_path / "say.wav")
    res = cli(["say", "--config", cfg, "--checkpoint", second["checkpoint"],
               "--hifi-gan-checkpoint", _hifigan(tmp_path), "--text", "hello there",
               "--out", out, "--random-seed", "3", "--max-len-override", "8",
               "--device", "cpu"])
    wav, sr = read_wav(out)
    assert sr == 22050 and len(wav) == res["samples"] == res["cut"] * 256
    assert np.isfinite(wav).all()
