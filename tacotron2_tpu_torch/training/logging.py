"""Training logs: TensorBoard event files and JSON lines.

Counterpart of ``tacotron2_tpu/training/logging.py``, written without
``tensorboardX`` and ``matplotlib``: the event file is framed and its
protobufs encoded here, the images rendered in numpy and encoded as PNG
with ``zlib``. Into ``<log_dir>/<name>/`` go

- ``events.out.tfevents.<time>.<host>.<pid>``: TFRecord framing (length,
  masked CRC-32C of the length, the ``Event`` bytes, masked CRC-32C of
  them); a ``file_version`` event first, then one event per summary value;
- ``metrics.jsonl``: each ``scalars`` call as one object ``{"step": n,
  "<tag>": value, ...}``.

Scalars keep the JAX tags and steps (``training_{gate,mel,mel_post,
tacotron}_loss``, ``training_loss``, ``training_grad_norm``,
``training_style_loss``, ``lr``, ``mel_frames_per_sec``, ``val_loss``,
``val_mel_loss``; ``train_prosody``'s ``train_loss``, ``val_loss`` and one
CCC per feature). Histograms have the buckets of ``tensorboardX``'s default
(``bins="tensorflow"``: +-1e-12 * 1.1^k up to 1e20 and 0), trimmed to
their support as ``tensorboardX.summary.make_histogram`` trims them; their
tags are the port's ``state_dict`` names (``decoder.att_rnn.weight_ih``),
not JAX's tree paths (``decoder/att_rnn/w_ih``). The four validation
images show the arrays the JAX logger plots, each pixel one value: the
target and predicted mels (mels up, frames across, origin lower, a fixed
viridis-like colormap over the array's range), the alignment (chars up),
and the gate (target green, sigmoid of the logits red, on 0..1). Unlike
the JAX images they have no axes, labels or colorbar.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time
import zlib
from typing import Dict, Mapping

import numpy as np

# ---------------------------------------------------------------------------
# TFRecord framing


def _crc32c_table() -> np.ndarray:
    table = np.zeros(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table[i] = c
    return table


_CRC32C = _crc32c_table().tolist()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as TFRecord frames use it."""
    c, table = 0xFFFFFFFF, _CRC32C
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def frame(record: bytes) -> bytes:
    """One TFRecord: length, its masked CRC, the record, its masked CRC."""
    n = struct.pack("<Q", len(record))
    return (n + struct.pack("<I", masked_crc(n)) + record
            + struct.pack("<I", masked_crc(record)))


# ---------------------------------------------------------------------------
# protobuf encoding of Event / Summary / Image / HistogramProto


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _double(field: int, x: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", x)


def _int_field(field: int, n: int) -> bytes:
    return _key(field, 0) + _varint(n)


def _packed_doubles(field: int, xs) -> bytes:
    return _bytes_field(field, np.asarray(xs, "<f8").tobytes())


def _event(step: int, summary_value: bytes = b"", file_version: str = "") -> bytes:
    ev = _double(1, time.time()) + _int_field(2, int(step))
    if file_version:
        ev += _bytes_field(3, file_version.encode())
    if summary_value:
        ev += _bytes_field(5, _bytes_field(1, summary_value))  # Summary.value
    return ev


def scalar_value(tag: str, x: float) -> bytes:
    """Summary.Value{tag, simple_value}."""
    return _bytes_field(1, tag.encode()) + _key(2, 5) + struct.pack("<f", float(x))


def image_value(tag: str, png: bytes, height: int, width: int) -> bytes:
    """Summary.Value{tag, image: {height, width, colorspace 3 (RGB), PNG}}."""
    img = (_int_field(1, height) + _int_field(2, width) + _int_field(3, 3)
           + _bytes_field(4, png))
    return _bytes_field(1, tag.encode()) + _bytes_field(4, img)


def _default_bins() -> np.ndarray:
    v, pos = 1e-12, []
    while v < 1e20:
        pos.append(v)
        v *= 1.1
    return np.asarray([-x for x in pos[::-1]] + [0.0] + pos)


DEFAULT_BINS = _default_bins()


def histogram(values) -> dict:
    """The fields of ``tensorboardX.summary.make_histogram(values,
    DEFAULT_BINS)``: min, max, num, sum, sum_squares, bucket_limit, bucket."""
    values = np.asarray(values, np.float64).reshape(-1)
    if values.size == 0:
        raise ValueError("a histogram of no values")
    counts, limits = np.histogram(values, bins=DEFAULT_BINS)
    cum = np.cumsum(counts > 0)
    start, end = np.searchsorted(cum, [0, cum[-1] - 1], side="right")
    start, end = int(start), int(end) + 1
    counts = counts[start - 1:end] if start > 0 else np.concatenate([[0], counts[:end]])
    return {"min": float(values.min()), "max": float(values.max()), "num": float(values.size),
            "sum": float(values.sum()), "sum_squares": float(values.dot(values)),
            "bucket_limit": limits[start:end + 1].tolist(),
            "bucket": counts.astype(np.float64).tolist()}


def histogram_value(tag: str, values) -> bytes:
    h = histogram(values)
    histo = (_double(1, h["min"]) + _double(2, h["max"]) + _double(3, h["num"])
             + _double(4, h["sum"]) + _double(5, h["sum_squares"])
             + _packed_doubles(6, h["bucket_limit"]) + _packed_doubles(7, h["bucket"]))
    return _bytes_field(1, tag.encode()) + _bytes_field(5, histo)


# ---------------------------------------------------------------------------
# images

# viridis at 0, 1/8, ..., 1 (matplotlib's default colormap), interpolated
_VIRIDIS = np.array([[68, 1, 84], [71, 44, 122], [59, 81, 139], [44, 113, 142],
                     [33, 144, 141], [39, 173, 129], [92, 200, 99], [170, 220, 50],
                     [253, 231, 37]], np.float64)


def colormap(a: np.ndarray) -> np.ndarray:
    """(H, W) values -> (H, W, 3) uint8 over the array's own range."""
    a = np.asarray(a, np.float64)
    lo, hi = (float(a.min()), float(a.max())) if a.size else (0.0, 1.0)
    x = (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)
    x = np.nan_to_num(x) * (len(_VIRIDIS) - 1)
    i = np.clip(np.floor(x).astype(int), 0, len(_VIRIDIS) - 2)
    f = (x - i)[..., None]
    return np.round(_VIRIDIS[i] * (1 - f) + _VIRIDIS[i + 1] * f).astype(np.uint8)


def png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (8-bit RGB, no filter, zlib)."""
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def spectrogram_image(spec: np.ndarray) -> np.ndarray:
    """(rows, frames) -> an image with row 0 at the bottom (origin lower)."""
    return colormap(np.asarray(spec)[::-1])


GATE_HEIGHT = 64  # pixels of the gate image, 0 at the bottom and 1 at the top


def gate_image(target: np.ndarray, predicted: np.ndarray) -> np.ndarray:
    """Target (green) and predicted (red) gate values in [0, 1] per frame
    on a white (GATE_HEIGHT, frames) image."""
    n = len(target)
    img = np.full((GATE_HEIGHT, max(n, 1), 3), 255, np.uint8)
    cols = np.arange(n)
    for values, color in ((target, (0, 160, 0)), (predicted, (220, 0, 0))):
        v = np.clip(np.nan_to_num(np.asarray(values, np.float64)), 0.0, 1.0)
        rows = GATE_HEIGHT - 1 - np.round(v * (GATE_HEIGHT - 1)).astype(int)
        img[rows, cols] = color
    return img


def stable_sigmoid(logits: np.ndarray) -> np.ndarray:
    """sigmoid without overflow (masked logits are -1000), as the JAX logger."""
    x = np.asarray(logits, np.float64)
    e = np.exp(np.clip(x, None, 0))
    return np.where(x >= 0, 1.0 / (1.0 + np.exp(-np.clip(x, 0, None))), e / (1.0 + e))


def validation_arrays(firsts: Mapping[str, np.ndarray], mel_len: int, chars_len: int
                      ) -> Dict[str, np.ndarray]:
    """The arrays the JAX logger plots, from ``eval_step``'s first row:
    target and predicted mel (M, mel_len), the alignment cropped to
    (mel_len, chars_len) and transposed, the gate target and its predicted
    probability over the padded frames."""
    f = {k: np.asarray(v, np.float64) for k, v in firsts.items()}
    return {"val_mel_spectrogram": f["mel_spectrogram"][:mel_len].T,
            "val_mel_spectrogram_predicted": f["mel_spectrogram_pred"][:mel_len].T,
            "val_alignment": f["alignment"][:mel_len, :chars_len].T,
            "gate": f["gate"].reshape(-1), "gate_pred": stable_sigmoid(f["gate_pred"]).reshape(-1)}


# ---------------------------------------------------------------------------


class TrainLogger:
    """Scalars, validation images and parameter histograms of one run."""

    def __init__(self, log_dir: str, name: str):
        self.dir = os.path.join(log_dir, name)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "metrics.jsonl")
        self.events_path = os.path.join(
            self.dir, f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}."
                      f"{os.getpid()}")
        self._events = open(self.events_path, "ab")
        self._events.write(frame(_event(0, file_version="brain.Event:2")))
        self._events.flush()

    def _write(self, step: int, values) -> None:
        self._events.write(b"".join(frame(_event(step, v)) for v in values))
        self._events.flush()

    def scalars(self, metrics: Dict[str, float], step: int) -> None:
        row = {"step": int(step), **{k: float(v) for k, v in metrics.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
        self._write(step, [scalar_value(k, v) for k, v in row.items() if k != "step"])

    def validation_images(self, firsts: Mapping[str, np.ndarray], mel_len: int,
                          chars_len: int, step: int) -> None:
        """The first validation batch's four images (JAX ``validation_images``)."""
        a = validation_arrays(firsts, mel_len, chars_len)
        images = {k: spectrogram_image(a[k]) for k in (
            "val_mel_spectrogram", "val_mel_spectrogram_predicted", "val_alignment")}
        images["val_gate"] = gate_image(a["gate"], a["gate_pred"])
        self._write(step, [image_value(k, png(img), img.shape[0], img.shape[1])
                           for k, img in images.items()])

    def histograms(self, named_tensors, step: int) -> None:
        """One histogram per ``(name, tensor)``, e.g. ``model.named_parameters()``."""
        self._write(step, [histogram_value(k, v.detach().float().cpu().numpy())
                           for k, v in named_tensors])

    def close(self) -> None:
        self._events.close()
