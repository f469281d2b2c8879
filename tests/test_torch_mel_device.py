"""The port's device mel backend (``TacotronMelSpectrogram.__call__(wav,
backend="torch")``, ``stft_magnitude_torch``) on the CPU against the JAX
package's device backend (``backend="jax"``, ``stft_magnitude_jax``) and the
numpy backends, at the JAX tests' own tolerances (``tests/test_audio.py``):
the log-mel within 5e-3 (f32 FFT noise near the clamp), the magnitude STFT
within atol 2e-3, rtol 1e-4."""

import numpy as np
import pytest
import torch

from tacotron2_tpu.audio.mel import TacotronMelSpectrogram as JaxMel
from tacotron2_tpu_torch.audio.mel import TacotronMelSpectrogram

torch.set_num_threads(1)


def _tone(freq=440.0, sr=22050, dur=0.7, amp=0.5):
    t = np.arange(int(sr * dur)) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _speechlike(seed, n):
    """Harmonics of a gliding f0 under noise: energy in every mel band."""
    r = np.random.default_rng(seed)
    t = np.arange(n) / 22050
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.7 * t)
    ph = 2 * np.pi * np.cumsum(f0) / 22050
    wav = sum(np.sin(k * ph) / k for k in range(1, 12)) * 0.2
    return (wav + 0.01 * r.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("wav", [_tone(740.0, dur=0.4), _tone(dur=1.0), _speechlike(0, 37_000),
                                 _speechlike(1, 256 * 127)],
                         ids=["tone-0.4s", "tone-1s", "speech-37k", "speech-127-hops"])
def test_torch_backend_matches_jax_and_numpy(wav):
    mel = TacotronMelSpectrogram()
    got = mel(wav, backend="torch", device="cpu")
    ref = JaxMel()(wav, backend="jax")
    host = mel(wav)
    assert got.dtype == np.float32 and got.shape == ref.shape == host.shape
    assert got.shape == (1 + len(wav) // 256, 80)
    np.testing.assert_allclose(got, ref, atol=5e-3)
    np.testing.assert_allclose(got, host, atol=5e-3)


def test_stft_magnitude_matches_jax_and_torch_stft():
    rng = np.random.default_rng(0)
    wav = rng.standard_normal(5000).astype(np.float32)
    padded = np.pad(wav, (512, 512), mode="reflect")
    got = TacotronMelSpectrogram().stft_magnitude_torch(torch.as_tensor(padded))
    ref = np.asarray(JaxMel().stft_magnitude_jax(padded))
    assert tuple(got.shape) == ref.shape == (1 + len(wav) // 256, 513)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-3, rtol=1e-4)
    stft = torch.stft(torch.tensor(wav), n_fft=1024, hop_length=256, win_length=1024,
                      window=torch.hann_window(1024, periodic=True), center=True,
                      pad_mode="reflect", onesided=True, return_complex=True).abs().T
    np.testing.assert_allclose(got.numpy(), stft.numpy(), atol=2e-3, rtol=1e-4)
    # numpy in, the CPU's tensor out
    np.testing.assert_array_equal(TacotronMelSpectrogram().stft_magnitude_torch(padded).numpy(),
                                  got.numpy())


def test_bucketing_keeps_the_leading_frames():
    """Two lengths in one 128-frame bucket give the same leading frames (the
    last three read the differing reflect pad), and a length across a bucket
    edge the same as the numpy backend."""
    mel = TacotronMelSpectrogram()
    wav = _tone(dur=1.0)
    a = mel(wav, backend="torch", device="cpu")
    b = mel(wav[:len(wav) - 256], backend="torch", device="cpu")
    assert a.shape[0] == b.shape[0] + 1 and -(-a.shape[0] // 128) == -(-b.shape[0] // 128)
    n = b.shape[0] - 3
    np.testing.assert_allclose(a[:n], b[:n], atol=1e-5)
    edge = _speechlike(2, 256 * 128)  # 129 frames: the second bucket, one frame in it
    c = mel(edge, backend="torch", device="cpu")
    assert c.shape == (129, 80)
    np.testing.assert_allclose(c, mel(edge), atol=5e-3)


def test_unknown_backend_and_cuda_without_a_card():
    mel = TacotronMelSpectrogram()
    with pytest.raises(ValueError, match="backend"):
        mel(_tone(), backend="jax")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mel(_tone(), backend="torch")
