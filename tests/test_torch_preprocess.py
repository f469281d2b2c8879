"""The port's data preparation against the JAX package's, on the CPU:

- ``read_flac`` / ``load_audio`` (the port's own build of ``native/``) against
  JAX's on ``tests/flac_encoder.py`` streams: every subframe mode, stereo,
  several blocks, equal sample for sample; malformed files raise;
- the prosody extractors (numpy and native) equal to JAX's on speech-like
  signals, and None on degenerate audio; ``preprocess`` raises when the
  native library fails to build;
- ``preprocess`` (LJSpeech and Hi-Fi TTS layouts, the port's process pool
  too) and every splits command against JAX's outputs read through pandas:
  the same rows in the same order, the same columns, values within 1e-12,
  NaN where JAX has NaN;
- the native library is built under ``build/native/``, and nothing is
  written into ``native/``; ``preprocess`` never imports torch.
"""

import csv
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from preprocessing import hifi_tts as jax_hifi
from preprocessing import ljspeech as jax_lj
from preprocessing import splits as jax_splits
from tacotron2_tpu.audio import prosody as jax_prosody
from tacotron2_tpu.audio.flac import read_flac as jax_read_flac
from tacotron2_tpu.audio.io import load_audio as jax_load_audio
from tacotron2_tpu_torch.__main__ import main as port_cli
from tacotron2_tpu_torch.audio import prosody
from tacotron2_tpu_torch.audio.flac import read_flac
from tacotron2_tpu_torch.audio.io import load_audio, write_wav
from tacotron2_tpu_torch.data.dataset import TTSDataset
from tacotron2_tpu_torch.ops import native
from tacotron2_tpu_torch.preprocessing import splits
from tests.flac_encoder import encode_flac
from tests.test_flac_and_preprocessing import _speechlike

ROOT = Path(__file__).resolve().parent.parent
FEATURES = prosody.FEATURE_NAMES


@pytest.fixture(scope="module")
def tone16():
    t = np.arange(22050 // 2)
    return (np.sin(2 * np.pi * 440 * t / 22050) * 12000).astype(np.int64)


def _flac(tmp_path, name, samples, **kw) -> str:
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(encode_flac(samples, **kw))
    return p


@pytest.mark.parametrize("mode,block_size", [("verbatim", 4096), ("fixed0", 4096),
                                             ("fixed1", 4096), ("fixed2", 4096),
                                             ("lpc2", 4096), ("fixed2", 1000)])
def test_read_flac_matches_jax(tmp_path, tone16, mode, block_size):
    p = _flac(tmp_path, "a.flac", tone16, subframe_mode=mode, block_size=block_size)
    wav, sr = read_flac(p)
    ref, sr_ref = jax_read_flac(p)
    assert sr == sr_ref == 22050 and wav.dtype == np.float32
    np.testing.assert_array_equal(wav, ref)
    np.testing.assert_allclose(wav, tone16 / 32768.0, atol=1e-6)


def test_read_flac_constant_and_stereo_match_jax(tmp_path, tone16):
    p = _flac(tmp_path, "c.flac", np.full(5000, 123, dtype=np.int64), subframe_mode="constant")
    np.testing.assert_array_equal(read_flac(p)[0], jax_read_flac(p)[0])
    p = _flac(tmp_path, "s.flac", np.stack([tone16, -tone16 // 2], axis=1),
              subframe_mode="fixed1", sample_rate=44100)
    for mono in (False, True):
        wav, sr = read_flac(p, mono=mono)
        ref, _ = jax_read_flac(p, mono=mono)
        assert sr == 44100 and wav.shape == ref.shape
        np.testing.assert_array_equal(wav, ref)
    assert read_flac(p, mono=False)[0].shape == (len(tone16), 2)


MALFORMED = {
    "truncated_header": lambda good: good[:20],
    "truncated_frames": lambda good: good[: len(good) // 2],
    "not_flac": lambda good: b"RIFFxxxxWAVE" + b"\x00" * 100,
    "empty": lambda good: b"",
    "garbage": lambda good: bytes(range(256)) * 8,
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_read_flac_refuses_malformed(tmp_path, tone16, case):
    p = tmp_path / f"{case}.flac"
    p.write_bytes(MALFORMED[case](encode_flac(tone16)))
    with pytest.raises(ValueError):
        read_flac(str(p))
    with pytest.raises(ValueError):
        jax_read_flac(str(p))
    with pytest.raises(FileNotFoundError):
        read_flac(str(tmp_path / "missing.flac"))


def test_load_audio_dispatch_matches_jax(tmp_path, tone16):
    p = _flac(tmp_path, "a.flac", tone16)
    w = str(tmp_path / "a.wav")
    write_wav(w, tone16 / 32768.0, 22050)
    for f in (p, w):
        wav, sr = load_audio(f)
        ref, sr_ref = jax_load_audio(f)
        assert sr == sr_ref and len(wav) == len(tone16)
        np.testing.assert_array_equal(wav, ref)


def test_dataset_reads_flac(tmp_path, tone16):
    """A .flac row gives the mel of the same samples as a .wav row."""
    _flac(tmp_path, "a.flac", tone16)
    write_wav(str(tmp_path / "a.wav"), tone16 / 32768.0, 22050)
    kw = dict(trim=False, allowed_chars="abcdefghijklmnopqrstuvwxyz ", end_token="^")
    flac = TTSDataset(["a.flac"], ["hello"], str(tmp_path), **kw)[0][0]["mel_spectrogram"]
    wav = TTSDataset(["a.wav"], ["hello"], str(tmp_path), **kw)[0][0]["mel_spectrogram"]
    assert flac.shape == (1 + len(tone16) // 256, 80)
    np.testing.assert_array_equal(flac, wav)


@pytest.mark.parametrize("seed,f0,dur", [(0, 120.0, 0.8), (1, 200.0, 1.0), (2, 330.0, 0.6)])
def test_extract_features_match_jax(seed, f0, dur):
    """Both backends equal JAX's (the same numpy code; the same C++ source,
    built by each package), and the native one within 2% of the numpy one,
    the JAX package's own limit."""
    wav = _speechlike(f0=f0, dur=dur, seed=seed)
    a = prosody._extract_features_numpy(wav, 22050)
    b = prosody.extract_features_native(wav, 22050)
    assert a == jax_prosody._extract_features_numpy(wav, 22050)
    assert b == jax_prosody.extract_features_native(wav, 22050)
    assert list(a) == list(b) == FEATURES
    assert a == jax_prosody.extract_features(wav, 22050, backend="numpy")
    assert b == jax_prosody.extract_features(wav, 22050, backend="native")
    for k in FEATURES:
        assert abs(a[k] - b[k]) <= 0.02 * max(abs(a[k]), 1e-3), (k, a[k], b[k])


PORT_EXTRACTORS = {"native": prosody.extract_features_native,
                   "numpy": prosody._extract_features_numpy}


@pytest.mark.parametrize("backend", sorted(PORT_EXTRACTORS))
def test_extract_features_degenerate(backend):
    for wav in (np.zeros(22050, np.float32), np.zeros(10, np.float32),
                _speechlike(dur=0.04)):
        assert PORT_EXTRACTORS[backend](wav, 22050) is None
        assert jax_prosody.extract_features(wav, 22050, backend=backend) is None


def _read(p):
    return pd.read_csv(p, delimiter="|", quoting=csv.QUOTE_NONE)


def _assert_frames_equal(port_csv, jax_csv):
    a, b = _read(port_csv), _read(jax_csv)
    assert list(a.columns) == list(b.columns)
    assert len(a) == len(b)
    for c in b.columns:
        x, y = a[c], b[c]
        if pd.api.types.is_numeric_dtype(y) and pd.api.types.is_numeric_dtype(x):
            xv, yv = x.to_numpy(np.float64), y.to_numpy(np.float64)
            np.testing.assert_array_equal(np.isnan(xv), np.isnan(yv), err_msg=c)
            np.testing.assert_allclose(xv, yv, rtol=0, atol=1e-12, err_msg=c)
        else:
            assert x.fillna("").astype(str).tolist() == y.fillna("").astype(str).tolist(), c


def _lj_layout(root: Path, n: int = 5) -> Path:
    """An LJSpeech layout: ``metadata.csv`` and ``wavs/``; clip 3 is silence
    (its features are None, so the row is dropped) and one row's clip is
    missing."""
    (root / "wavs").mkdir(parents=True)
    rows = []
    for i in range(n):
        wav = (_speechlike(f0=110 + 30 * i, dur=0.5 + 0.1 * i, seed=i) if i != 3
               else np.zeros(11025, np.float32))
        write_wav(str(root / "wavs" / f"LJ{i:03d}.wav"), np.pad(wav, (2000, 2000)), 22050)
        rows.append(f"LJ{i:03d}|Text {i}, raw.|text {i} normalized")
    rows.append("LJ999|Missing.|missing")
    (root / "metadata.csv").write_text("\n".join(rows) + "\n")
    return root


@pytest.mark.parametrize("trim,n_jobs", [(False, 1), (True, 2)])
def test_preprocess_ljspeech_matches_jax(tmp_path, trim, n_jobs):
    speech = _lj_layout(tmp_path / "LJ")
    out = port_cli(["preprocess", "--dataset", "ljspeech", "--speech-dir", str(speech),
                    "--out-dir", str(tmp_path), "--out-postfix", "port", "--n-jobs",
                    str(n_jobs)] + (["--trim", "--trim-top-db", "40"] if trim else []))
    port_wavs = {p.name: p.read_bytes() for p in (speech / "wavs_trimmed").glob("*.wav")}
    ref = jax_lj.do_preprocess(str(speech), str(tmp_path), "jax", n_jobs=1, trim=trim,
                               trim_top_db=40.0)
    assert out["outputs"] == str(tmp_path / "ljspeech-port.csv")
    _assert_frames_equal(out["outputs"], ref)
    df = _read(ref)
    assert len(df) == 4 and list(df.columns) == FEATURES + ["text", "wav"]
    if trim:  # the JAX run wrote the same trimmed files over the port's
        assert len(port_wavs) == 5
        assert port_wavs == {p.name: p.read_bytes()
                             for p in (speech / "wavs_trimmed").glob("*.wav")}


def _hifi_layout(root: Path) -> Path:
    """A Hi-Fi TTS layout: FLAC at 44.1 kHz under ``audio/``, one manifest
    of JSON lines per speaker and set; speaker 9017's dev set is empty."""
    (root / "audio").mkdir(parents=True)
    for s_i, spk in enumerate(["6097", "92", "9017"]):
        for set_name, n in (("train", 3), ("dev", 1), ("test", 2)):
            n = 0 if (spk, set_name) == ("9017", "dev") else n
            entries = []
            for j in range(n):
                rel = f"audio/{spk}/{set_name}_{j}.flac"
                (root / "audio" / spk).mkdir(exist_ok=True)
                wav = _speechlike(sr=44100, f0=100 + 50 * s_i + 7 * j, dur=0.5, seed=j)
                if (spk, set_name, j) == ("92", "train", 2):
                    wav = wav * 6  # peaks past 0.99 after resampling: rescaled
                pcm = (np.clip(wav, -1, 1) * 32000).astype(np.int64)
                (root / rel).write_bytes(encode_flac(pcm, sample_rate=44100,
                                                     subframe_mode="fixed2"))
                entries.append({"audio_filepath": rel, "text_normalized": f"clip {spk} {j}",
                                "duration": 0.5})
            (root / f"{spk}_manifest_clean_{set_name}.json").write_text(
                "".join(json.dumps(e) + "\n" for e in entries))
    return root


def test_preprocess_hifi_tts_matches_jax(tmp_path):
    speech = _hifi_layout(tmp_path / "hifi")
    outs = port_cli(["preprocess", "--dataset", "hifi-tts", "--speech-dir", str(speech),
                     "--out-dir", str(tmp_path), "--out-postfix", "port", "--n-jobs", "2"])
    port_wavs = {p: p.read_bytes() for p in (speech / "audio_22050").rglob("*.wav")}
    jax_hifi.do_preprocess(str(speech), str(tmp_path), "jax", n_jobs=1)
    assert port_wavs and port_wavs == {p: p.read_bytes()
                                       for p in (speech / "audio_22050").rglob("*.wav")}
    for name, n in (("train", 9), ("val", 2), ("test", 6)):
        port = tmp_path / f"hifi-tts-{name}-port.csv"
        assert str(port) in outs["outputs"]
        _assert_frames_equal(port, tmp_path / f"hifi-tts-{name}-jax.csv")
        df = _read(port)
        assert len(df) == n and sorted(set(df.speaker_id)) == sorted(
            {"6097": 1, "92": 0, "9017": 2}[str(s)] for s in set(df.speaker_id_dataset))
        assert df.wav.str.startswith("audio_22050/").all()


def _feature_rows(rng, n, nan_every=0):
    rows = []
    for i in range(n):
        f = {k: rng.normal(loc=j, scale=1 + 0.1 * j) for j, k in enumerate(FEATURES)}
        if nan_every and i % nan_every == 1:
            f[FEATURES[i % len(FEATURES)]] = np.nan
        rows.append(f)
    return rows


def _write(rows, p):
    pd.DataFrame(rows).to_csv(p, sep="|", quoting=csv.QUOTE_NONE, index=None)
    return str(p)


def test_split_ljspeech_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    rows = [dict(f, text=f"utterance {i}", wav=f"wavs/{i}.wav")
            for i, f in enumerate(_feature_rows(rng, 60, nan_every=7))]
    src = _write(rows, tmp_path / "lj.csv")
    outs = {side: [str(tmp_path / f"{side}_{s}.csv") for s in ("train", "val", "test")]
            for side in ("port", "jax")}
    splits.main(["ljspeech", "--csv-in", src, "--train-out", outs["port"][0], "--val-out",
                 outs["port"][1], "--test-out", outs["port"][2], "--val-size", "5",
                 "--test-size", "9", "--random_state", "9001"])
    jax_splits.split_ljspeech(src, *outs["jax"], val_size=5, test_size=9, random_state=9001)
    for a, b in zip(outs["port"], outs["jax"]):
        _assert_frames_equal(a, b)
    assert [len(_read(p)) for p in outs["port"]] == [46, 5, 9]
    assert _read(outs["port"][0])[splits.FEATURES_ALL_SPEAKER_NORM].isna().any().any()


def _hifi_rows(rng, spec, nan_every=0):
    """spec: {speaker_id_dataset: rows}; speaker ids 0..2 in HIFI_GENDER's
    key order."""
    rows = []
    for s_idx, (spk, n) in enumerate(spec.items()):
        for i, f in enumerate(_feature_rows(rng, n, nan_every)):
            rows.append(dict(f, speaker_id_dataset=spk, text=f"utt {spk} {i}",
                             wav=f"audio_22050/{spk}/{i}.wav", speaker_id=s_idx))
    return rows


def _hifi_split(tmp_path, rng, tag, val_size, test_size):
    ins = [_write(_hifi_rows(rng, spec, nan_every=5), tmp_path / f"{tag}_in_{s}.csv")
           for s, spec in (("train", {92: 14, 6097: 12, 9017: 13}),
                           ("val", {92: 2, 6097: 4, 9017: 3}),
                           ("test", {92: 3, 6097: 2, 9017: 5}))]
    outs = {side: [str(tmp_path / f"{tag}_{side}_{s}.csv") for s in ("train", "val", "test")]
            for side in ("port", "jax")}
    splits.main(["hifi", "--train-in", ins[0], "--val-in", ins[1], "--test-in", ins[2],
                 "--train-out", outs["port"][0], "--val-out", outs["port"][1],
                 "--test-out", outs["port"][2], "--speaker-val-size", str(val_size),
                 "--speaker-test-size", str(test_size), "--random_state", "9001"])
    jax_splits.split_hifi(*ins, *outs["jax"], speaker_val_size=val_size,
                          speaker_test_size=test_size, random_state=9001)
    return outs


def test_split_hifi_matches_jax(tmp_path):
    outs = _hifi_split(tmp_path, np.random.default_rng(1), "h", 3, 4)
    for a, b in zip(outs["port"], outs["jax"]):
        _assert_frames_equal(a, b)
    val = _read(outs["port"][1])
    assert val.groupby("speaker_id").size().tolist() == [3, 4, 3]
    assert len(_read(outs["port"][0])) == 39 - 1 - 1 - 2  # rows borrowed by val and test
    assert (_read(outs["port"][0]).speaker_id_dataset.dtype == np.int64)


def test_split_lj_hifi_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    hifi = _hifi_split(tmp_path, rng, "h", 3, 4)["jax"]
    lj = [_write([dict(f, text=f"lj {i}", wav=f"wavs/{i}.wav")
                  for i, f in enumerate(_feature_rows(rng, n, nan_every=6))],
                 tmp_path / f"lj_{s}.csv") for s, n in (("train", 20), ("val", 3), ("test", 4))]
    outs = {side: [str(tmp_path / f"m_{side}_{s}.csv") for s in ("train", "val", "test")]
            for side in ("port", "jax")}
    splits.main(["lj-hifi", "--hifi-train-in", hifi[0], "--hifi-val-in", hifi[1],
                 "--hifi-test-in", hifi[2], "--lj-train-in", lj[0], "--lj-val-in", lj[1],
                 "--lj-test-in", lj[2], "--train-out", outs["port"][0], "--val-out",
                 outs["port"][1], "--test-out", outs["port"][2]])
    jax_splits.split_lj_hifi(*hifi, *lj, *outs["jax"])
    for a, b in zip(outs["port"], outs["jax"]):
        _assert_frames_equal(a, b)
    m = _read(outs["port"][0])
    assert m[m.wav.str.startswith("LJSpeech-1.1")].speaker_id.unique().tolist() == [3]

    # a Hi-Fi speaker with fewer val rows than LJSpeech's: both refuse
    big_val = _write([dict(f, text=f"lj {i}", wav=f"wavs/{i}.wav")
                      for i, f in enumerate(_feature_rows(rng, 5))], tmp_path / "lj_val5.csv")
    for split in (splits.split_lj_hifi, jax_splits.split_lj_hifi):
        with pytest.raises(ValueError, match="fewer than LJSpeech's 5"):
            split(*hifi, lj[0], big_val, lj[2], *outs["port"])


def test_train_test_split_is_sklearns():
    from sklearn.model_selection import train_test_split as sk_split

    rows = list(range(37))
    for n, r in ((5, 9001), (1, 0), (36, 7)):
        assert list(splits.train_test_split(rows, n, r)) == [list(x) for x in sk_split(
            rows, test_size=n, random_state=r)]
    with pytest.raises(ValueError):
        splits.train_test_split(rows, 37, 0)


def test_libritts_index_matches_jax(tmp_path):
    root = tmp_path / "libritts"
    for spk, ch, utt, dur in (("84", "121", "a", 0.3), ("84", "121", "b", 0.5),
                              ("1034", "7", "c", 0.4)):
        d = root / "dev-clean" / spk / ch
        d.mkdir(parents=True, exist_ok=True)
        write_wav(str(d / f"{utt}.wav"), _speechlike(dur=dur), 22050)
        if utt != "b" or spk != "84":
            (d / f"{utt}.normalized.txt").write_text(f"text of {utt}\n")
    dur_csv = tmp_path / "durations.csv"
    dur_csv.write_text("path,seconds\ndev-clean/1034/7/c.wav,12.5\n")
    for side in ("port", "jax"):
        (tmp_path / side).mkdir()
    splits.main(["libritts-index", "--libritts-dir", str(root), "--out-dir",
                 str(tmp_path / "port"), "--durations-csv", str(dur_csv)])
    jax_splits.index_libritts(str(root), str(tmp_path / "jax"), str(dur_csv))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for n in names:
        assert (tmp_path / "port" / n).read_text() == (tmp_path / "jax" / n).read_text()
    assert (tmp_path / "port" / "libritts-dev-clean.csv").read_text().count("\n") == 2


def test_native_library_is_built_under_build(tmp_path, monkeypatch):
    """The port builds its own copy under build/native (here a temporary
    directory in its place), never in native/, under a lock."""
    assert native.BUILD_DIR == ROOT / "build" / "native"
    assert native.library_path().parent == native.BUILD_DIR
    before = sorted(p.name for p in (ROOT / "native").iterdir() if p.name != "build")
    calls = []
    real_run = subprocess.run

    def run(cmd, **kw):
        calls.append(cmd)
        return real_run(cmd, **kw)

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native_build")
    monkeypatch.setattr(native.subprocess, "run", run)
    out = native.build()
    assert out.parent == tmp_path / "native_build" and out.exists()
    assert len(calls) == 1 and "make" not in calls[0]
    target = Path(calls[0][calls[0].index("-o") + 1])
    assert target.parent == tmp_path / "native_build"
    assert native.build() == out and len(calls) == 1  # built once
    assert sorted(p.name for p in (ROOT / "native").iterdir() if p.name != "build") == before


def test_native_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "nb")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        native.build()


def test_preprocess_raises_when_native_build_fails(tmp_path, monkeypatch):
    """``preprocess`` extracts features with the native library alone: a
    failed build raises, with no numpy fallback that would write other
    values."""
    speech = _lj_layout(tmp_path / "LJ", n=3)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "nb")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        port_cli(["preprocess", "--dataset", "ljspeech", "--speech-dir", str(speech),
                  "--out-dir", str(tmp_path), "--out-postfix", "p", "--n-jobs", "1"])
    assert not (tmp_path / "ljspeech-p.csv").exists()


def test_preprocess_imports_no_torch(tmp_path):
    """``preprocess`` and the splits run on the host alone: a process that
    runs both never imports torch, so it cannot initialise CUDA."""
    speech = _lj_layout(tmp_path / "LJ", n=3)
    code = (
        "import sys\n"
        "from tacotron2_tpu_torch.__main__ import main\n"
        "from tacotron2_tpu_torch.preprocessing import splits\n"
        f"out = main(['preprocess', '--dataset', 'ljspeech', '--speech-dir', {str(speech)!r},"
        f" '--out-dir', {str(tmp_path)!r}, '--out-postfix', 'p', '--n-jobs', '2'])\n"
        "splits.main(['ljspeech', '--csv-in', out['outputs'], '--train-out', 'a.csv',"
        " '--val-out', 'b.csv', '--test-out', 'c.csv', '--val-size', '1', '--test-size', '1'])\n"
        "assert 'torch' not in sys.modules, 'torch imported'\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(_read(tmp_path / "a.csv")) == 1
