"""Training-health diagnostics: cheap numeric checks of a teacher-forced
batch that gradient-agreement tests cannot catch (wrong data, masking or
schedule all give self-consistent gradients).

Counterpart of ``tacotron2_tpu/utils/diagnostics.py`` (numpy, no torch):
``alignment_metrics`` (pad mass, diagonality, entropy), ``gate_accuracy``
and ``tb_scalar_series``, which reads an event file's scalars with the
port's own TFRecord reader (the JAX module uses tensorboard's
``EventAccumulator``, which the port does not import). ``chip_smoke.py``
holds a GST model's teacher-forced batch to a pad-mass limit with it.
"""

from __future__ import annotations

import glob
import os
import struct

import numpy as np


def alignment_metrics(alignments, chars_len, mel_len) -> dict:
    """Health metrics of a teacher-forced batch: ``alignments`` (B, T, L)
    attention weights, ``chars_len`` / ``mel_len`` (B,) valid lengths ->

    - ``pad_mass``: the mean attention mass on padded chars over valid
      frames; the char mask forces it to ~0, trained or not;
    - ``diagonality``: the mean absolute deviation of the expected attended
      position (normalized to [0, 1]) from the linear time ramp: ~0 for a
      clean monotone alignment, ~0.25 for uniform attention;
    - ``entropy``: the mean per-frame attention entropy in nats (uniform
      attention: log(chars_len)).
    """
    alignments = np.asarray(alignments, np.float64)
    chars_len, mel_len = np.asarray(chars_len), np.asarray(mel_len)
    B, T, L = alignments.shape
    pos = np.arange(L)
    pad_masses, diags, ents = [], [], []
    for b in range(B):
        cl, ml = int(chars_len[b]), min(int(mel_len[b]), T)
        if ml == 0 or cl == 0:
            continue
        w = alignments[b, :ml]
        pad_masses.append(float(w[:, cl:].sum() / ml))
        valid = np.clip(w[:, :cl], 1e-12, None)
        valid = valid / valid.sum(axis=1, keepdims=True)
        expected = (valid * pos[:cl]).sum(axis=1) / max(cl - 1, 1)
        ramp = np.arange(ml) / max(ml - 1, 1)
        diags.append(float(np.abs(expected - ramp).mean()))
        ents.append(float(-(valid * np.log(valid)).sum(axis=1).mean()))
    mean = lambda xs: float(np.mean(xs)) if xs else 0.0
    return {"pad_mass": mean(pad_masses), "diagonality": mean(diags), "entropy": mean(ents)}


def gate_accuracy(gates, gate_target, mel_len) -> float:
    """The share of valid frames whose gate logit's sign matches the target
    (target 1: logit >= 0, target 0: logit < 0)."""
    gates, gate_target, mel_len = np.asarray(gates), np.asarray(gate_target), np.asarray(mel_len)
    total = correct = 0
    T = gates.shape[1]
    for b in range(gates.shape[0]):
        ml = min(int(mel_len[b]), T)
        if ml == 0:
            continue
        g, t = gates[b, :ml].reshape(-1), gate_target[b, :ml].reshape(-1)
        correct += int(((g >= 0) == (t >= 0.5)).sum())
        total += ml
    return correct / max(total, 1)


def _fields(buf: bytes) -> dict:
    """A protobuf message -> {field number: [values]}: varints as ints,
    fixed32 / fixed64 / length-delimited as bytes."""
    out: dict = {}
    pos = 0

    def varint():
        nonlocal pos
        n = shift = 0
        while True:
            b = buf[pos]
            pos += 1
            n |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return n

    while pos < len(buf):
        key = varint()
        field, wire = key >> 3, key & 7
        if wire == 0:
            v = varint()
        elif wire in (1, 5):
            size = 8 if wire == 1 else 4
            v, pos = buf[pos:pos + size], pos + size
        elif wire == 2:
            n = varint()
            v, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError(f"protobuf wire type {wire} is not read")
        out.setdefault(field, []).append(v)
    return out


def _event_scalars(path: str, tag: str):
    """The (step, value) pairs of scalar ``tag`` in one event file (Event:
    step 2, summary 5; Summary.Value: tag 1, simple_value 2)."""
    with open(path, "rb") as f:
        data = f.read()
    pos, out = 0, []
    while pos + 12 <= len(data):
        n = struct.unpack("<Q", data[pos:pos + 8])[0]
        ev = _fields(data[pos + 12:pos + 12 + n])
        pos += 16 + n
        step = ev.get(2, [0])[0]
        for summary in ev.get(5, []):
            for value in _fields(summary).get(1, []):
                v = _fields(value)
                if v.get(1, [b""])[0].decode() == tag and 2 in v:
                    out.append((step, struct.unpack("<f", v[2][0])[0]))
    return out


def tb_scalar_series(logdir_glob: str, tag: str):
    """[(step, value), ...] of a TensorBoard scalar tag in the first run
    directory matching ``logdir_glob``, its event files in name order."""
    dirs = sorted(glob.glob(logdir_glob))
    if not dirs:
        raise FileNotFoundError(f"no TB run dir matches {logdir_glob}")
    files = sorted(glob.glob(os.path.join(dirs[0], "events.out.tfevents.*")))
    return [pair for f in files for pair in _event_scalars(f, tag)]
