"""The port's Griffin-Lim (``tacotron2_tpu_torch/audio/griffin_lim.py``, torch
on the CPU) against the JAX package's (``tacotron2_tpu/audio/griffin_lim.py``,
its jitted CPU path) on the same mel and seed.

Limits: the linear spectrogram within 1e-4 of its max (readings 3.1e-7
and 5.9e-7); the waveform within 1e-3 of its max (readings 4.9e-5 and
9.5e-5 for the two seeds). Griffin-Lim iterates 32 times through an FFT
pair whose rounding differs between the two libraries, and renormalises
the phase of every bin each time, so the waveforms drift apart more than
the NNLS output does.
"""

import numpy as np
import pytest
import torch

from tacotron2_tpu.audio.griffin_lim import mel_to_audio as jax_mel_to_audio
from tacotron2_tpu.audio.griffin_lim import mel_to_linear as jax_mel_to_linear
from tacotron2_tpu_torch.audio import griffin_lim as gl

torch.set_num_threads(1)


def _mel(frames, n_mels, seed=0):
    """A smooth log-mel with a moving formant-like ridge, exp'd."""
    rng = np.random.default_rng(seed)
    t = np.arange(frames)[:, None]
    m = np.arange(n_mels)[None, :]
    ridge = n_mels * (0.3 + 0.2 * np.sin(t / 7.0))
    log_mel = -4.0 + 3.0 * np.exp(-((m - ridge) ** 2) / 20.0) + 0.2 * rng.standard_normal(
        (frames, n_mels))
    return np.exp(log_mel).astype(np.float32)


@pytest.mark.parametrize("n_mels,frames", [(80, 24), (16, 10)])
def test_mel_to_linear_matches_jax(n_mels, frames):
    mel = _mel(frames, n_mels)
    ref = np.asarray(jax_mel_to_linear(mel))
    got = gl.mel_to_linear(torch.as_tensor(mel)).numpy()
    assert got.shape == ref.shape == (frames, 513)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("seed", [0, 5])
def test_mel_to_audio_matches_jax(seed):
    mel = _mel(24, 80, seed)
    ref = np.asarray(jax_mel_to_audio(mel, seed=seed))
    got = gl.mel_to_audio(torch.as_tensor(mel), seed=seed).numpy()
    assert got.shape == ref.shape == (23 * 256,)
    assert np.isfinite(got).all() and np.abs(ref).max() > 0
    assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()


def test_seed_sets_the_initial_phases():
    mel = torch.as_tensor(_mel(12, 80))
    a, b, c = (gl.mel_to_audio(mel, seed=s) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
