"""The port's training logs (``training/logging.py``: TensorBoard event
files written without ``tensorboardX``), its trace (``utils/profiling.py``)
and ``eval_step``'s first row, on the CPU:

- CRC-32C of ``b"123456789"`` is the check value 0xE3069283, and a frame's
  masked CRCs are TFRecord's;
- the event file reads back with ``tensorboard``'s ``EventAccumulator``:
  scalars, images and histograms under their tags and steps;
- scalars equal, tag by tag and step by step, to what the JAX package's
  ``TrainLogger`` (tensorboardX) writes for the same dicts;
- a histogram equal field by field to ``tensorboardX.summary.histogram``
  with tensorboardX's default bins (``bins="tensorflow"``), also as the
  encoded protobuf;
- the four validation images decode to PNGs of the arrays' shapes (mels
  up, frames across, origin lower), the colormap's ends at the array's
  min and max;
- ``eval_step``'s first-row tensors against JAX ``make_eval_step``'s
  (dropout 0, within 3e-5 of each tensor's max), and the arrays the
  images show against those the JAX logger plots from JAX's;
- a CLI ``train`` with ``TACOTRON2_TRACE_DIR`` set and the histogram
  interval at 2: histograms at steps 2 and 4, four images at each
  validation, the same scalars in ``metrics.jsonl``, and a Chrome trace.
"""

import json
import struct
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.training.logging import TrainLogger as JaxTrainLogger
from tacotron2_tpu.training.step import make_eval_step
from tacotron2_tpu_torch.__main__ import main as cli
from tacotron2_tpu_torch.run import train as train_mod
from tacotron2_tpu_torch.training import logging as tl
from tacotron2_tpu_torch.training import step
from tests.test_torch_train_cli import _corpus
from tests.test_torch_training import _batch, _jax_model, _port_model

torch.set_num_threads(1)
event_accumulator = pytest.importorskip("tensorboard.backend.event_processing.event_accumulator")

IMAGE_TAGS = ("val_mel_spectrogram", "val_mel_spectrogram_predicted", "val_alignment",
              "val_gate")


def _accumulate(path) -> "event_accumulator.EventAccumulator":
    acc = event_accumulator.EventAccumulator(str(path), size_guidance={
        event_accumulator.SCALARS: 0, event_accumulator.IMAGES: 0,
        event_accumulator.HISTOGRAMS: 0})
    acc.Reload()
    return acc


def _decode_png(data: bytes) -> np.ndarray:
    """8-bit RGB PNG, filter 0 on every row (as ``tl.png`` writes) -> (H, W, 3)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(kind + body)
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, color) == (8, 2)
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 3 * w)
    assert not raw[:, 0].any()
    return raw[:, 1:].reshape(h, w, 3)


def test_crc32c_check_value_and_masks():
    assert tl.crc32c(b"123456789") == 0xE3069283
    assert tl.crc32c(b"") == 0
    rec = b"some event bytes"
    f = tl.frame(rec)
    assert struct.unpack("<Q", f[:8])[0] == len(rec) and f[12:-4] == rec
    c = tl.crc32c(rec)
    assert struct.unpack("<I", f[-4:])[0] == ((((c >> 15) | (c << 17)) & 0xFFFFFFFF)
                                              + 0xA282EAD8) & 0xFFFFFFFF


def _firsts(T=40, L=12, M=16, seed=0):
    r = np.random.default_rng(seed)
    gate = np.ones((T, 1), np.float32)
    gate[30:] = 0.0
    return {"mel_spectrogram": r.standard_normal((T, M)).astype(np.float32),
            "mel_spectrogram_pred": r.standard_normal((T, M)).astype(np.float32),
            "alignment": r.uniform(0, 1, (T, L)).astype(np.float32),
            "gate": gate,
            "gate_pred": np.concatenate([r.normal(2, 1, (30, 1)),
                                         np.full((10, 1), -1000.0)]).astype(np.float32)}


def test_event_file_reads_back(tmp_path):
    log = tl.TrainLogger(str(tmp_path), "run")
    log.scalars({"training_loss": 1.5, "lr": 1e-3}, 1)
    log.scalars({"training_loss": 0.75, "lr": 1e-4}, 7)
    log.validation_images(_firsts(), 30, 10, 7)
    w = torch.arange(-6.0, 6.0).reshape(3, 4)
    log.histograms([("decoder.w", w), ("zeros", torch.zeros(5))], 1000)
    log.close()
    acc = _accumulate(log.events_path)
    tags = acc.Tags()
    assert set(tags["scalars"]) == {"training_loss", "lr"}
    assert set(tags["images"]) == set(IMAGE_TAGS)
    assert set(tags["histograms"]) == {"decoder.w", "zeros"}
    assert [(e.step, e.value) for e in acc.Scalars("training_loss")] == [(1, 1.5), (7, 0.75)]
    assert [e.step for e in acc.Scalars("lr")] == [1, 7]
    h = acc.Histograms("decoder.w")[0]
    assert h.step == 1000 and h.histogram_value.num == 12 and h.histogram_value.min == -6
    assert acc.Images("val_alignment")[0].step == 7
    assert Path(log.path).read_text().count("\n") == 2


def test_scalars_equal_the_jax_logger(tmp_path):
    rows = [({"training_loss": 2.25, "training_grad_norm": 3.1, "lr": 1e-3,
              "mel_frames_per_sec": 12345.6}, 1),
            ({"val_loss": 0.123456789, "val_mel_loss": 0.123456789}, 1),
            ({"training_loss": 1.0 / 3.0, "lr": 1e-4, "training_style_loss": 7e-5}, 50)]
    jax_log, port_log = JaxTrainLogger(str(tmp_path / "jax"), "n"), tl.TrainLogger(
        str(tmp_path / "port"), "n")
    for metrics, at in rows:
        jax_log.scalars(metrics, at)
        port_log.scalars(metrics, at)
    jax_log.close()
    port_log.close()
    want, got = _accumulate(tmp_path / "jax" / "n"), _accumulate(port_log.events_path)
    assert sorted(got.Tags()["scalars"]) == sorted(want.Tags()["scalars"])
    for tag in want.Tags()["scalars"]:
        assert [(e.step, e.value) for e in got.Scalars(tag)] == \
               [(e.step, e.value) for e in want.Scalars(tag)], tag


@pytest.mark.parametrize("case", ["normal", "wide", "constant", "zeros", "positive", "int"])
def test_histogram_equals_tensorboardx(case, tmp_path):
    from tensorboard.compat.proto.summary_pb2 import Summary
    from tensorboardX import SummaryWriter
    from tensorboardX.summary import histogram

    r = np.random.default_rng(5)
    values = {"normal": r.standard_normal(1000) * 0.05,
              "wide": np.concatenate([r.standard_normal(300) * 1e3, r.standard_normal(300)
                                      * 1e-9, [0.0, -0.0]]),
              "constant": np.full(17, 0.25),
              "zeros": np.zeros(9),
              "positive": r.uniform(1, 2, 64),
              "int": np.arange(-20, 21)}[case].astype(np.float32)
    writer = SummaryWriter(str(tmp_path))
    bins = writer.default_bins
    writer.close()
    np.testing.assert_array_equal(tl.DEFAULT_BINS, np.asarray(bins))
    want = histogram("t", values, bins).value[0].histo
    got = tl.histogram(values)
    for f in ("min", "max", "num", "sum", "sum_squares"):
        assert got[f] == getattr(want, f), f
    assert got["bucket_limit"] == list(want.bucket_limit)
    assert got["bucket"] == list(want.bucket)
    parsed = Summary.Value.FromString(tl.histogram_value("t", values))
    assert parsed.tag == "t" and parsed.histo.SerializeToString() == want.SerializeToString()


def test_validation_images_are_pngs_of_the_arrays(tmp_path):
    log = tl.TrainLogger(str(tmp_path), "run")
    f = _firsts()
    log.validation_images(f, 30, 10, 3)
    log.close()
    acc = _accumulate(log.events_path)
    shapes = {"val_mel_spectrogram": (16, 30), "val_mel_spectrogram_predicted": (16, 30),
              "val_alignment": (10, 30), "val_gate": (tl.GATE_HEIGHT, 40)}
    for tag, (h, w) in shapes.items():
        ev = acc.Images(tag)[0]
        img = _decode_png(ev.encoded_image_string)
        assert img.shape == (h, w, 3) and (ev.height, ev.width) == (h, w), tag
        if tag == "val_mel_spectrogram":  # origin lower: the bottom row is mel bin 0
            np.testing.assert_array_equal(img, tl.colormap(f["mel_spectrogram"][:30].T[::-1]))
    spec = np.array([[0.0, 1.0], [2.0, 4.0]])
    c = tl.colormap(spec)
    assert (c[0, 0] == tl._VIRIDIS[0]).all() and (c[1, 1] == tl._VIRIDIS[-1]).all()
    gate = _decode_png(acc.Images("val_gate")[0].encoded_image_string)
    assert (gate[0, 0] == (0, 160, 0)).all()  # target 1 at the top
    assert (gate[-1, 35] == (220, 0, 0)).all()  # the masked logits' 0 at the bottom


def test_eval_step_first_row_matches_jax():
    """JAX ``make_eval_step`` and the port's ``eval_step`` on the same
    weights and batch (dropout 0): each first-row tensor within 3e-5 of its
    max (+1e-6), the loss within 1e-5 relative; then the arrays the port's
    images show against those the JAX logger plots from JAX's tensors."""
    jm, params, state = _jax_model("32-true")
    b = _batch()
    jmetrics, jfirst = make_eval_step(jm)(params, state, {k: jnp.asarray(v) for k, v in b.items()},
                                          jax.random.PRNGKey(0))
    model = _port_model(params, state, "32-true")
    metrics, first = step.eval_step(model, step.to_device(b, "cpu"))
    assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]), rel=1e-5)
    assert set(first) == set(jfirst)
    for k, ref in jfirst.items():
        ref = np.asarray(ref)
        got = first[k].numpy()
        assert got.shape == ref.shape, k
        np.testing.assert_allclose(got, ref, atol=3e-5 * np.abs(ref).max() + 1e-6, err_msg=k)
    mel_len, chars_len = int(b["mel_len"][1]), int(b["chars_len"][1])
    got = tl.validation_arrays({k: v.numpy() for k, v in first.items()}, mel_len, chars_len)
    j = {k: np.asarray(v) for k, v in jfirst.items()}
    logits = j["gate_pred"].squeeze()
    want = {"val_mel_spectrogram": j["mel_spectrogram"][:mel_len].T,
            "val_mel_spectrogram_predicted": j["mel_spectrogram_pred"][:mel_len].T,
            "val_alignment": j["alignment"][:mel_len, :chars_len].T,
            "gate": j["gate"].squeeze(),
            "gate_pred": np.where(logits >= 0,
                                  1.0 / (1.0 + np.exp(-np.clip(logits, 0, None))),
                                  np.exp(np.clip(logits, None, 0))
                                  / (1.0 + np.exp(np.clip(logits, None, 0))))}
    for k, ref in want.items():
        assert got[k].shape == ref.shape, k
        np.testing.assert_allclose(got[k], ref, atol=3e-5 * np.abs(ref).max() + 1e-6, err_msg=k)


def test_train_cli_writes_events_and_a_trace(tmp_path, monkeypatch):
    speech, _, cfg = _corpus(tmp_path)
    monkeypatch.setattr(train_mod, "HISTOGRAM_EVERY", 2)
    monkeypatch.setenv("TACOTRON2_TRACE_DIR", str(tmp_path / "trace"))
    out = cli(["train", "--config", cfg, "--speech-dir", str(speech), "--device", "cpu",
               "--results-dir", str(tmp_path / "r"), "--max-steps", "4"])
    assert out["step"] == 4
    logdir = tmp_path / "r" / "lightning_logs" / "tiny"
    (events,) = logdir.glob("events.out.tfevents.*")
    acc = _accumulate(events)
    tags = acc.Tags()
    sd = torch.load(out["checkpoint"], map_location="cpu", weights_only=False)["state_dict"]
    names = [k[len("tacotron2."):] for k in sd
             if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
    assert set(tags["histograms"]) == set(names)
    assert {e.step for e in acc.Histograms(names[0])} == {2, 4}
    # two steps an epoch: validation after steps 2 and 4, and at the end
    for tag in IMAGE_TAGS:
        assert [e.step for e in acc.Images(tag)] == [2, 4, 4], tag
    rows = [json.loads(x) for x in (logdir / "metrics.jsonl").read_text().splitlines()]
    for tag in tags["scalars"]:
        assert [(e.step, e.value) for e in acc.Scalars(tag)] == [
            (r["step"], pytest.approx(r[tag], rel=1e-6)) for r in rows if tag in r], tag
    (trace,) = (tmp_path / "trace").glob("trace_*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    assert out["phases"]["histograms"]["n"] == 2 and out["phases"]["validation"]["n"] == 2
