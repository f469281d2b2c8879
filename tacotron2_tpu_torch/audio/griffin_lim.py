"""Griffin-Lim mel inversion in torch: the vocoder-free synthesis path.

Counterpart of ``tacotron2_tpu/audio/griffin_lim.py`` (the reference's
``librosa.feature.inverse.mel_to_audio``): log-mel -> linear magnitude by
non-negative least squares (projected gradient, 80 iterations), then 32
Griffin-Lim iterations with momentum 0.99 from random initial phases. The
phases come from ``numpy.random.default_rng(seed)`` as in the JAX package,
so one seed gives both the same start. It runs on the device of its input:
``torch.stft`` / ``torch.istft`` with the periodic Hann window, centred
frames zero-padded by n_fft // 2 (the JAX package pads the rebuilt signal
with zeros, not by reflection).
"""

from __future__ import annotations

import numpy as np
import torch

from tacotron2_tpu_torch.audio.mel import hann_window_periodic, mel_filterbank


N_FFT, HOP = 1024, 256  # the JAX defaults, which its callers keep
F_MIN, F_MAX = 0.0, 8000.0
NNLS_ITERS, GL_ITERS, MOMENTUM = 80, 32, 0.99


def mel_to_linear(mel_magnitude: torch.Tensor, sample_rate: int = 22050) -> torch.Tensor:
    """Linear mel magnitude (frames, n_mels) -> linear STFT magnitude
    (frames, N_FFT // 2 + 1): min ||S fb - mel||^2 over S >= 0, projected
    gradient with step 1 / ||fb||_2^2 from the transpose-trick start."""
    mel = mel_magnitude.float()
    fb = torch.as_tensor(mel_filterbank(sample_rate, N_FFT, mel.shape[1], F_MIN, F_MAX),
                         device=mel.device)
    s = (mel / fb.sum(dim=0, keepdim=True).clamp_min(1e-10)) @ fb.t()
    step = 1.0 / (torch.linalg.matrix_norm(fb, ord=2) ** 2).clamp_min(1e-10)
    s = s.clamp_min(0.0)
    for _ in range(NNLS_ITERS):
        s = (s - step * ((s @ fb - mel) @ fb.t())).clamp_min(0.0)
    return s


def griffin_lim(magnitude: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Fast Griffin-Lim: ``magnitude`` (frames, N_FFT // 2 + 1) -> waveform of
    (frames - 1) * HOP samples."""
    mag = magnitude.float().t()  # (freqs, frames), torch.stft's layout
    length = (mag.shape[1] - 1) * HOP
    window = torch.as_tensor(hann_window_periodic(N_FFT), device=mag.device)
    phase = np.random.default_rng(seed).uniform(-np.pi, np.pi, size=magnitude.shape)
    angles = torch.as_tensor(np.exp(1j * phase.astype(np.float32)).astype(np.complex64).T,
                             device=mag.device)

    def istft(angles):
        return torch.istft(mag * angles, N_FFT, HOP, window=window, center=True, length=length)

    def stft(y):
        return torch.stft(y, N_FFT, HOP, window=window, center=True, pad_mode="constant",
                          return_complex=True)

    tprev = torch.zeros_like(angles)
    for _ in range(GL_ITERS):
        rebuilt = stft(istft(angles))
        update = rebuilt - (MOMENTUM / (1.0 + MOMENTUM)) * tprev
        angles = update / update.abs().clamp_min(1e-16)
        tprev = rebuilt
    return istft(angles)


def mel_to_audio(mel_magnitude: torch.Tensor, sample_rate: int = 22050,
                 seed: int = 0) -> torch.Tensor:
    """Linear (exp'd) mel magnitude (frames, n_mels) -> waveform, as
    ``librosa.feature.inverse.mel_to_audio`` with power 1."""
    return griffin_lim(mel_to_linear(mel_magnitude, sample_rate), seed)
