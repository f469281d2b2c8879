"""The port's small numpy modules against the JAX package's, on the same
inputs:

- ``utils/diagnostics.py``: ``alignment_metrics`` and ``gate_accuracy`` on
  random and on deliberately broken (padding-attending, uniform) batches,
  equal to JAX's within 1e-12; ``tb_scalar_series`` reading the port's
  ``TrainLogger`` event file as JAX's (tensorboard's ``EventAccumulator``)
  reads it;
- ``data/prosody_dataset.py``: ``ProsodyDataset`` draws JAX's segments from
  the same seed and files (with and without trim, a clip shorter than a
  segment too): the wav segment and the features equal, the mel segment
  within 1e-5 (the two mel frontends' f32 sums);
- ``utils/speaker_ids.py``: ``SpeakerIdEncoder`` and ``get_encoder`` equal
  to JAX's, ``transform`` / ``inverse_transform`` round trips.
"""

import numpy as np
import pytest

from tacotron2_tpu.data.prosody_dataset import ProsodyDataset as JaxProsodyDataset
from tacotron2_tpu.utils import diagnostics as jdiag
from tacotron2_tpu.utils import speaker_ids as jspk
from tacotron2_tpu_torch.audio.io import write_wav
from tacotron2_tpu_torch.data.prosody_dataset import ProsodyDataset
from tacotron2_tpu_torch.training.logging import TrainLogger
from tacotron2_tpu_torch.utils import diagnostics, speaker_ids


def _batch(kind, seed=0, B=4, T=30, L=12):
    r = np.random.default_rng(seed)
    chars_len = np.array([12, 9, 5, 0])
    mel_len = np.array([30, 22, 0, 10])
    a = r.random((B, T, L))
    if kind == "masked":  # a correct mask: nothing on the padded chars
        a = a * (np.arange(L)[None, None, :] < chars_len[:, None, None])
    elif kind == "uniform":
        a = np.ones((B, T, L))
    a /= np.maximum(a.sum(-1, keepdims=True), 1e-12)
    gates = r.standard_normal((B, T, 1))
    target = (r.random((B, T, 1)) > 0.3).astype(np.float32)
    return a.astype(np.float32), chars_len, mel_len, gates, target


@pytest.mark.parametrize("kind", ["masked", "broken", "uniform"])
def test_diagnostics_match_jax(kind):
    a, cl, ml, gates, target = _batch(kind)
    got, ref = diagnostics.alignment_metrics(a, cl, ml), jdiag.alignment_metrics(a, cl, ml)
    assert set(got) == set(ref) == {"pad_mass", "diagonality", "entropy"}
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-12, k
    if kind == "masked":
        assert got["pad_mass"] == 0.0
    else:
        assert got["pad_mass"] > 0.1
    assert diagnostics.gate_accuracy(gates, target, ml) == jdiag.gate_accuracy(gates, target, ml)


def test_tb_scalar_series_matches_jax(tmp_path):
    logger = TrainLogger(str(tmp_path / "logs"), "run")
    for step, loss in ((1, 2.5), (50, 1.25), (100, 0.5)):
        logger.scalars({"training_loss": loss, "lr": 1e-3}, step)
    logger.close()
    pattern = str(tmp_path / "logs" / "*")
    got = diagnostics.tb_scalar_series(pattern, "training_loss")
    assert got == jdiag.tb_scalar_series(pattern, "training_loss")
    assert got == [(1, 2.5), (50, 1.25), (100, 0.5)]
    with pytest.raises(FileNotFoundError):
        diagnostics.tb_scalar_series(str(tmp_path / "none*"), "training_loss")


def _clips(tmp_path):
    rng = np.random.default_rng(0)
    names = []
    for i, secs in enumerate((1.0, 0.2, 2.3)):  # the second is shorter than a segment
        t = np.arange(int(secs * 22050)) / 22050
        wav = np.concatenate([np.zeros(3000), 0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t)
                              + 0.01 * rng.standard_normal(len(t)), np.zeros(2000)])
        write_wav(str(tmp_path / f"c{i}.wav"), wav.astype(np.float32), 22050)
        names.append(f"c{i}.wav")
    return names


@pytest.mark.parametrize("trim", [False, True])
def test_prosody_dataset_draws_jax_segments(tmp_path, trim):
    names = _clips(tmp_path)
    mine = ProsodyDataset(names, str(tmp_path), trim=trim, seed=3)
    ref = JaxProsodyDataset(names, str(tmp_path), trim=trim, seed=3)
    assert len(mine) == len(ref) == 3
    for i in (0, 1, 2, 0, 2):  # the draws continue one stream
        got, want = mine[i], ref[i]
        assert got["mel_segment"].shape == (64, 80)
        assert got["wav_segment"].shape == ((64 * 256,) if i != 1 else want["wav_segment"].shape)
        np.testing.assert_array_equal(got["wav_segment"], want["wav_segment"])
        np.testing.assert_allclose(got["mel_segment"], want["mel_segment"], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(got["features"], want["features"])
        assert got["features"].shape == (18,) and np.isfinite(got["features"]).all()


def test_speaker_id_encoder_matches_jax(tmp_path):
    ids = ["92", "6097", "92", "9017", "1", "6097"]
    mine, ref = speaker_ids.SpeakerIdEncoder(ids), jspk.SpeakerIdEncoder(ids)
    assert mine.classes_ == ref.classes_ == ["1", "6097", "9017", "92"]
    assert mine.transform(ids) == ref.transform(ids)
    assert mine.inverse_transform(mine.transform(ids)) == ids
    f = tmp_path / "speakers.txt"
    f.write_text("\n".join(ids) + "\n\n")
    enc = speaker_ids.get_encoder(str(f))
    assert enc is speaker_ids.get_encoder(str(f))
    assert enc.classes_ == jspk.get_encoder(str(f)).classes_
    with pytest.raises(KeyError):
        enc.transform(["7"])
