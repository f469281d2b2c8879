"""The port's ``test_correlation`` (``run/test_correlation.py``, on the
CPU) against the JAX package's ``run.test_correlation``, on
tests/test_torch_eval_drivers.py's tiny controllable project (3 speakers,
two control columns, a HiFi-GAN of 32 channels, ``32-true``, the gate's bias
chosen from a probe decode so that rows stop at frames between 0 and
``MAX_LEN``).

- ``control_overrides`` equals JAX's, the same tuples and directory names;
- the rows: ``sample_rows`` equals the pandas selection of JAX's driver
  (``g.sample(min(len(g), k), random_state=9001)`` per ``speaker_id``
  group, concatenated) over three voices of uneven size for k = 1, 2, 5,
  200, and ``df.sample`` without a speaker column;
- the sweep: the override directories, the WAV names in each (the rows
  kept: 0 < n < max_len) and their lengths equal JAX's, the WAVs within 2
  PCM16 LSB (the say tests' limit) with JAX's vocode made the bucketed one
  of its own ``say`` (``jitted_cut_vocoder``: the port vocodes a batch's
  rows in one bucket, see tests/test_torch_eval_drivers.py);
- ``analyze_correlations`` of the same sweep directory equals JAX's: the
  same (control, feature, n) rows, every r within 1e-4 and NaN where JAX's
  is NaN (the features come from the same C++ extractor,
  tests/test_torch_preprocess.py holds them to 1e-12); on the sweep above
  (its WAVs too short for the extractor: a header alone) and on a
  directory of 0.6 s tones that follow the overrides.
"""

import csv
import os

import numpy as np
import pandas as pd
import pytest
import torch

import run.test_correlation as jax_tc
from run.test_correlation import analyze_correlations as jax_analyze
from run.test_correlation import control_overrides as jax_overrides
from run.test_correlation import do_test_correlation as jax_do_test_correlation
from tacotron2_tpu.config import load_config as jax_load_config
from tacotron2_tpu_torch.__main__ import main as port_cli
from tacotron2_tpu_torch.audio.io import read_wav
from tacotron2_tpu_torch.run.test_correlation import (analyze_correlations,
                                                      control_overrides, sample_rows)
from tests.test_torch_eval_drivers import (FEATURES, MAX_LEN, _bucketed_vocode, _gate_bias,
                                           _project, _save)

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [1, 2, 5])
def test_control_overrides_equal_jax(n):
    got = control_overrides(n)
    assert got == jax_overrides(n)
    assert [str(o) for o in got] == [str(o) for o in jax_overrides(n)]
    assert len(got) == 10 * n + 1 and all(type(v) is float for o in got for v in o)


def _rows(seed=0):
    r = np.random.default_rng(seed)
    spk = [7] * 9 + [2] * 3 + [11] * 6
    r.shuffle(spk)
    return [{"text": f"t{i}", "wav": f"w{i}.wav", "speaker_id": str(s)}
            for i, s in enumerate(spk)]


@pytest.mark.parametrize("k", [1, 2, 5, 200])
def test_sample_rows_equal_pandas(k):
    rows = _rows()
    df = pd.DataFrame(rows).astype({"speaker_id": int})
    ref = pd.concat([g.sample(min(len(g), k), random_state=9001)
                     for _, g in df.groupby("speaker_id")], ignore_index=True)
    assert [r["wav"] for r in sample_rows(rows, k)] == list(ref.wav)
    flat = [{k_: v for k_, v in r.items() if k_ != "speaker_id"} for r in rows]
    ref = pd.DataFrame(flat).sample(min(len(flat), k), random_state=9001)
    assert [r["wav"] for r in sample_rows(flat, k)] == list(ref.wav)


def _wavs(root):
    return {d: sorted(f for f in os.listdir(os.path.join(root, d)) if f.endswith(".wav"))
            for d in sorted(os.listdir(root)) if os.path.isdir(os.path.join(root, d))}


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f, delimiter="|"))


def test_test_correlation_matches_jax(tmp_path, monkeypatch):
    speech, cfg_path, model, g_path = _project(tmp_path, True)
    bias, _ = _gate_bias(model, cfg_path, speech)
    ckpt = _save(model, bias, tmp_path / "model.ckpt")
    res = port_cli(["test_correlation", "--config", cfg_path, "--speech-dir", speech,
                    "--checkpoint", ckpt, "--hifi-gan-checkpoint", g_path, "--results-dir",
                    str(tmp_path / "port"), "--max-len-override", str(MAX_LEN),
                    "--device", "cpu"])
    monkeypatch.setattr(jax_tc, "vocode", _bucketed_vocode)
    jax_do_test_correlation(jax_load_config(cfg_path), 0, speech, ckpt, g_path,
                            results_dir=str(tmp_path / "jax"), max_len_override=MAX_LEN,
                            analyze=False)
    port, ref = _wavs(tmp_path / "port"), _wavs(tmp_path / "jax")
    assert list(port) == sorted(str(o) for o in control_overrides(2)) == list(ref)
    assert port == ref
    assert res["rows"] == 6 and len(res["overrides"]) == 21
    kept = sum(len(v) for v in port.values())
    assert 0 < kept < 21 * 6, "some rows stop in range and some do not"
    for d, names in port.items():
        want = [w for w in res["overrides"][d]["wavs"]]
        assert sorted(f"{i}.wav" for i in want) == names
        for name in names:
            a, sr = read_wav(str(tmp_path / "port" / d / name))
            b, _ = read_wav(str(tmp_path / "jax" / d / name))
            assert sr == 22050 and len(a) == len(b)
            lsb = np.abs(np.round(a * 32768) - np.round(b * 32768)).max()
            assert lsb <= 2, (d, name, lsb)
    # these 3-7 frame WAVs are too short for the extractor: a header alone
    got = _csv_rows(res["correlations"])
    assert got == _csv_rows(jax_analyze(str(tmp_path / "port"), FEATURES))


def _same_correlations(got, want):
    assert len(got) == len(want) and got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert (g[0], g[1], g[3]) == (w[0], w[1], w[3])
        if w[2] == "nan":
            assert g[2] == "nan"
        else:
            assert abs(float(g[2]) - float(w[2])) <= 1e-4, (g, w)


def _tone(f0: float, seed: int, sr: int = 22050, dur: float = 0.6) -> np.ndarray:
    r = np.random.default_rng(seed)
    t = np.arange(int(sr * dur)) / sr
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
    x = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6)) * env
    return (0.25 * x + 0.003 * r.standard_normal(len(t))).astype(np.float32)


def test_analyze_correlations_matches_jax(tmp_path):
    """A sweep directory of 0.6 s harmonic tones whose pitch and loudness
    follow the override, with the directories JAX skips (a stale width, a
    two-hot override, a name that is no tuple, a file beside them)."""
    from tacotron2_tpu_torch.audio.io import write_wav

    root = tmp_path / "sweep"
    for o in control_overrides(2):
        d = root / str(o)
        d.mkdir(parents=True)
        for i in range(3):
            wav = _tone(140.0 * (1.0 + 0.3 * o[0]) + 7 * i, i) * (1.0 + 0.4 * o[1])
            write_wav(str(d / f"{i}.wav"), wav, 22050)
    for skipped in ("(0.2,)", "(0.2, 0.4)", "notes"):
        (root / skipped).mkdir()
        write_wav(str(root / skipped / "0.wav"), _tone(300.0, 9), 22050)
    (root / "readme.txt").write_text("x")
    got = _csv_rows(analyze_correlations(str(root), FEATURES))
    want = _csv_rows(jax_analyze(str(root), FEATURES))
    assert len(got) > 1 + 18  # both controls, every feature
    _same_correlations(got, want)
    pitch = [r for r in got if r[0] == "pitch_norm" and r[1] == "pitch_mean"]
    assert pitch and float(pitch[0][2]) > 0.9 and pitch[0][3] == str(33)  # 11 values x 3 WAVs
