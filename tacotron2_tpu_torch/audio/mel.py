"""Log-mel spectrogram on the host (numpy), with torchaudio's numerics.

Counterpart of the numpy backend of ``tacotron2_tpu/audio/mel.py``
(``TacotronMelSpectrogram``): n_fft 1024, window 1024, hop 256, f_min 0,
f_max 8000, magnitude (power 1), slaney mel scale and norm, then
log(clamp(min=1e-5)), (frames, n_mels). As torchaudio: centered frames with
reflect padding of n_fft // 2, a periodic Hann window, a one-sided rFFT, and
1 + len(wav) // hop frames.

The numpy backend is the default: the input pipeline runs on the host.
``backend="torch"`` is the counterpart of the JAX package's device backend
(``backend="jax"``): the frames padded to a bucket of 128, the log-mel
computed with stock torch ops (``torch.fft.rfft`` over framed windows) on
the card unless the caller asks for the CPU; ``stft_magnitude_torch`` is
``stft_magnitude_jax``'s in-graph magnitude STFT. torch is imported inside
them only (``preprocess`` never imports it).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = math.log(6.4) / 27.0


def hz_to_mel_slaney(hz):
    hz = np.asarray(hz, dtype=np.float64)
    log_mel = _MIN_LOG_MEL + np.log(np.maximum(hz, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP
    return np.where(hz >= _MIN_LOG_HZ, log_mel, hz / _F_SP)


def mel_to_hz_slaney(mel):
    mel = np.asarray(mel, dtype=np.float64)
    log_hz = _MIN_LOG_HZ * np.exp(_LOGSTEP * (mel - _MIN_LOG_MEL))
    return np.where(mel >= _MIN_LOG_MEL, log_hz, mel * _F_SP)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, f_min: float = 0.0,
                   f_max: Optional[float] = None) -> np.ndarray:
    """Slaney-normalized triangular filters, (n_fft // 2 + 1, n_mels) f32."""
    if f_max is None:
        f_max = sample_rate / 2.0
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1, dtype=np.float64)
    mel_pts = np.linspace(hz_to_mel_slaney(f_min), hz_to_mel_slaney(f_max), n_mels + 2)
    hz_pts = mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.T.astype(np.float32)


def hann_window_periodic(win_length: int) -> np.ndarray:
    """torch.hann_window(win_length, periodic=True)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))).astype(np.float32)


class TacotronMelSpectrogram:
    """``__call__``: 1-D waveform -> (frames, n_mels) f32 log-mel."""

    CLAMP_MIN = 1e-5
    BUCKET_FRAMES = 128  # the device backend's frame buckets (JAX's compile granularity)

    def __init__(self, n_mels: int = 80, sample_rate: int = 22050, n_fft: int = 1024,
                 win_length: int = 1024, hop_length: int = 256, f_min: float = 0.0,
                 f_max: float = 8000.0):
        self.n_fft, self.hop_length = n_fft, hop_length
        window = hann_window_periodic(win_length)
        pad = (n_fft - win_length) // 2  # torch centers a short window in n_fft
        self.window = np.pad(window, (pad, n_fft - win_length - pad))
        self.fbanks = mel_filterbank(sample_rate, n_fft, n_mels, f_min, f_max)
        self._on_device: dict = {}  # device -> (window, fbanks) as torch tensors

    def num_frames(self, num_samples: int) -> int:
        return 1 + num_samples // self.hop_length

    def __call__(self, wav: np.ndarray, backend: str = "numpy", device=None) -> np.ndarray:
        """``backend`` "numpy" (the default, on the host) or "torch" (on
        ``device``: the card unless the caller asks for the CPU; the frames
        padded to a multiple of ``BUCKET_FRAMES`` and cut back after)."""
        wav = np.asarray(wav, dtype=np.float32).reshape(-1)
        n = self.num_frames(len(wav))
        padded = np.pad(wav, (self.n_fft // 2, self.n_fft // 2), mode="reflect")
        if backend == "torch":
            return self._torch_log_mel(padded, n, device)
        if backend != "numpy":
            raise ValueError(f"unknown mel backend {backend!r} (numpy or torch)")
        from scipy.fft import rfft

        need = (n - 1) * self.hop_length + self.n_fft
        if len(padded) < need:
            padded = np.pad(padded, (0, need - len(padded)))
        idx = (np.arange(n)[:, None] * self.hop_length + np.arange(self.n_fft)[None, :])
        spec = np.abs(rfft(padded[idx] * self.window[None, :], axis=-1)).astype(np.float32)
        return np.log(np.clip(spec @ self.fbanks, self.CLAMP_MIN, None)).astype(np.float32)

    def _tensors(self, device):
        """The window and the filterbank on ``device``, made once."""
        import torch

        key = str(device)
        if key not in self._on_device:
            self._on_device[key] = (torch.as_tensor(self.window, device=device),
                                    torch.as_tensor(self.fbanks, device=device))
        return self._on_device[key]

    def _torch_log_mel(self, padded: np.ndarray, n: int, device) -> np.ndarray:
        import torch

        from tacotron2_tpu_torch.models.layers import resolve_device

        dev = resolve_device(device)
        bucket = -(-n // self.BUCKET_FRAMES) * self.BUCKET_FRAMES
        need = (bucket - 1) * self.hop_length + self.n_fft
        if len(padded) < need:
            padded = np.pad(padded, (0, need - len(padded)))
        x = torch.as_tensor(padded[:need], device=dev)
        mel = self.stft_magnitude_torch(x) @ self._tensors(dev)[1]  # (bucket, n_mels)
        return torch.log(torch.clamp(mel, min=self.CLAMP_MIN))[:n].cpu().numpy()

    def stft_magnitude_torch(self, padded):
        """The magnitude STFT (frames, n_fft // 2 + 1) of an already
        reflect-padded signal (a tensor, or numpy put on the CPU): frames of
        n_fft every hop, windowed, one-sided rFFT, f32."""
        import torch

        x = torch.as_tensor(padded, dtype=torch.float32)
        window = self._tensors(x.device)[0]
        frames = x.unfold(-1, self.n_fft, self.hop_length) * window
        return torch.fft.rfft(frames, dim=-1).abs()
