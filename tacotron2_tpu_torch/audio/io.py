"""Audio file I/O: WAV in pure numpy (RIFF parser/writer), FLAC through the
native decoder (``load_audio``).

The reference reads audio with torchaudio (datasets/tts_dataset.py:189) and
writes with soundfile (run/say.py:173). Neither is available here, and audio
decode is host-side IO — a small self-contained RIFF codec keeps the
pipeline dependency-free. Supports PCM 8/16/24/32-bit and
IEEE float32/64, mono or multi-channel (averaged to mono like
``wav.squeeze(0)`` on torchaudio's mono loads).
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav(path: str, mono: bool = True) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 samples in [-1, 1], sample_rate).

    Matches torchaudio's normalized float output: PCM ints are scaled by
    2**(bits-1).
    """
    with open(path, "rb") as f:
        data = f.read()

    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            if fmt[0] == _WAVE_FORMAT_EXTENSIBLE and chunk_size >= 40:
                # real format lives in the extension's SubFormat GUID
                (sub_format,) = struct.unpack_from("<H", body, 24)
                fmt = (sub_format,) + fmt[1:]
        elif chunk_id == b"data":
            raw = body
        pos += 8 + chunk_size + (chunk_size & 1)  # chunks are word-aligned

    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")

    audio_format, num_channels, sample_rate, _, _, bits = fmt

    if audio_format == _WAVE_FORMAT_PCM:
        if bits == 8:
            samples = (raw_arr := np.frombuffer(raw, dtype=np.uint8)).astype(np.float32)
            samples = (samples - 128.0) / 128.0
        elif bits == 16:
            samples = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            as_int = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            as_int = np.where(as_int & 0x800000, as_int - 0x1000000, as_int)
            samples = as_int.astype(np.float32) / 8388608.0
        elif bits == 32:
            samples = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        dtype = "<f4" if bits == 32 else "<f8"
        samples = np.frombuffer(raw, dtype=dtype).astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported WAV format tag {audio_format:#x}")

    if num_channels > 1:
        samples = samples.reshape(-1, num_channels)
        if mono:
            samples = samples.mean(axis=1)
    return np.ascontiguousarray(samples, dtype=np.float32), int(sample_rate)


def load_audio(path: str, mono: bool = True) -> Tuple[np.ndarray, int]:
    """WAV through the numpy codec, FLAC through the native decoder
    (``audio/flac.py``), by the file's extension (JAX ``load_audio``)."""
    if path.lower().endswith(".flac"):
        from tacotron2_tpu_torch.audio.flac import read_flac

        return read_flac(path, mono=mono)
    return read_wav(path, mono=mono)


def write_wav(path: str, wav: np.ndarray, sample_rate: int, subtype: str = "PCM_16") -> None:
    """Write a WAV file. Default PCM_16 matches soundfile's WAV default
    (run/say.py:173 writes float data through soundfile)."""
    wav = np.asarray(wav)
    if wav.ndim == 1:
        wav = wav[:, None]
    num_channels = wav.shape[1]

    if subtype == "PCM_16":
        if wav.dtype == np.int16:
            # already quantized on the device (run/say.py applies this
            # exact clip/scale before the copy to the host)
            payload = wav.astype("<i2", copy=False).tobytes()
        else:
            clipped = np.clip(wav, -1.0, 1.0 - 1.0 / 32768.0)
            payload = (clipped * 32768.0).astype("<i2").tobytes()
        bits, fmt_tag = 16, _WAVE_FORMAT_PCM
    elif subtype == "FLOAT":
        payload = wav.astype("<f4").tobytes()
        bits, fmt_tag = 32, _WAVE_FORMAT_IEEE_FLOAT
    else:
        raise ValueError(f"unsupported subtype {subtype}")

    byte_rate = sample_rate * num_channels * bits // 8
    block_align = num_channels * bits // 8
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(payload)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, fmt_tag, num_channels, sample_rate, byte_rate, block_align, bits))
        f.write(b"data")
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)
