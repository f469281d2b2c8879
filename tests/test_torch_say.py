"""The port's ``say`` (``python -m tacotron2_tpu_torch say``, on the CPU)
against the JAX package's ``run.say.do_say`` on the same files: one tiny
config with ``dropout: 0.0`` (both frameworks then use all-ones prenet
masks) and precision ``32-true``, one reference-format Lightning ``.ckpt``
and one HiFi-GAN ``g_*`` file (weight-normed convs) with its
``config.json``, all written to ``tmp_path``. On the CPU the port's
vocoder runs f32, as the JAX ``say``'s does. The WAV lengths must be equal
and the PCM16 samples within 2 LSB."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from run.common import load_hifigan as jax_load_hifigan
from run.say import do_say as jax_do_say
from tacotron2_tpu.config import load_config as jax_load_config
from tacotron2_tpu_torch.__main__ import main as port_cli
from tacotron2_tpu_torch.audio.io import read_wav
from tacotron2_tpu_torch.config import load_config
from tacotron2_tpu_torch.convert import to_lightning
from tacotron2_tpu_torch.models.hifigan import HiFiGAN, HiFiGANConfig
from tacotron2_tpu_torch.models.layers import F32, Policy
from tacotron2_tpu_torch.models.tacotron2 import Tacotron2
from tacotron2_tpu_torch.run.say import load_hifigan, model_config_from

torch.set_num_threads(1)

HIFIGAN = {  # UNIVERSAL_V1's strides (hop 256) at narrow widths
    "resblock": "1", "upsample_rates": [8, 8, 2, 2], "upsample_kernel_sizes": [16, 16, 4, 4],
    "upsample_initial_channel": 32, "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]], "num_mels": 16,
}
TEXT = "Hello world, this is the port."


def _files(tmp_path, gate_bias):
    raw = {
        "dataset": {"preprocessing": {
            "allowed_chars": "!'(),.:;? \\-abcdefghijklmnopqrstuvwxyz", "end_token": "^",
            "num_mels": 16, "sample_rate": 22050, "trim": False}},
        "training": {"precision": "32-true", "batch_size": 2},
        "model": {"args": {"encoded_dim": 32, "encoder_kernel_size": 5, "prenet_dim": 16,
                           "att_rnn_dim": 32, "att_dim": 16, "rnn_hidden_dim": 32,
                           "postnet_dim": 16, "dropout": 0.0}},
        "extensions": {},
    }
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(raw))
    torch.manual_seed(0)
    model = Tacotron2(model_config_from(load_config(str(cfg_path))))
    with torch.no_grad():
        model.decoder.gate.bias.fill_(gate_bias)
        for bn in (m for m in model.modules() if isinstance(m, torch.nn.BatchNorm1d)):
            bn.running_mean.normal_(0.0, 0.1)
            bn.running_var.uniform_(0.5, 1.5)
    ckpt = tmp_path / "model.ckpt"
    torch.save(to_lightning(model.state_dict()), ckpt)

    hdir = tmp_path / "hifigan"
    hdir.mkdir()
    (hdir / "config.json").write_text(json.dumps(HIFIGAN))
    sd = {}
    for k, v in HiFiGAN(HiFiGANConfig.from_dict(HIFIGAN)).state_dict().items():
        if k.endswith(".weight"):  # store weight norm, as upstream g_* files do
            base = k[: -len(".weight")]
            norm = v.pow(2).sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
            sd[base + ".weight_g"] = norm * 1.5
            sd[base + ".weight_v"] = v.clone()
        else:
            sd[k] = v
    g_path = hdir / "g_00000001"
    torch.save({"generator": sd}, g_path)
    return str(cfg_path), str(ckpt), str(g_path)


@pytest.mark.parametrize("gate_bias,max_len", [(3.0, 32), (-3.0, 5000)])
def test_say_matches_jax(tmp_path, gate_bias, max_len):
    cfg_path, ckpt, g_path = _files(tmp_path, gate_bias)
    out_port, out_jax = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    res = port_cli(["say", "--config", cfg_path, "--checkpoint", ckpt,
                    "--hifi-gan-checkpoint", g_path, "--text", TEXT, "--out", out_port,
                    "--random-seed", "7", "--max-len-override", str(max_len),
                    "--device", "cpu"])
    jax_do_say(jax_load_config(cfg_path), 0, ckpt, TEXT, out_jax,
               hifi_gan_checkpoint=g_path, random_seed=7, max_len_override=max_len)
    port_wav, sr = read_wav(out_port)
    jax_wav, sr_jax = read_wav(out_jax)
    assert sr == sr_jax == 22050
    assert len(port_wav) == len(jax_wav) == res["cut"] * 256 == res["samples"]
    lsb = np.abs(np.round(port_wav * 32768) - np.round(jax_wav * 32768)).max()
    assert lsb <= 2, f"PCM16 samples differ by {lsb} LSB"
    assert np.abs(jax_wav).max() > 0
    if gate_bias < 0:
        assert res["n_frames"] == 1 and res["cut"] == 1 and res["samples"] == 256
    else:
        assert res["n_frames"] == max_len and res["cut"] == max_len - 1


@pytest.mark.parametrize("vocoder,quantize", [("griffin_lim", False), ("hifigan", True)])
def test_say_modes_match_jax(tmp_path, vocoder, quantize):
    """``say`` without a HiFi-GAN checkpoint (Griffin-Lim on both sides) and
    ``say --quantize-int8`` (the int8 decode on both sides), gate forced
    positive so both decode 24 frames. Limits: PCM16 within 2 LSB with
    HiFi-GAN; with Griffin-Lim within 1e-3 of the waveform's max, the limit
    of tests/test_torch_griffin_lim.py."""
    cfg_path, ckpt, g_path = _files(tmp_path, 3.0)
    out_port, out_jax = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    g = [] if vocoder == "griffin_lim" else ["--hifi-gan-checkpoint", g_path]
    res = port_cli(["say", "--config", cfg_path, "--checkpoint", ckpt, "--text", TEXT,
                    "--out", out_port, "--random-seed", "7", "--max-len-override", "24",
                    "--device", "cpu"] + g + (["--quantize-int8"] if quantize else []))
    jax_do_say(jax_load_config(cfg_path), 0, ckpt, TEXT, out_jax,
               hifi_gan_checkpoint=None if vocoder == "griffin_lim" else g_path,
               random_seed=7, max_len_override=24, quantize_int8=quantize)
    port_wav, jax_wav = read_wav(out_port)[0], read_wav(out_jax)[0]
    assert res["vocoder"] == vocoder and res["quantize_int8"] == quantize
    cut = 23  # Griffin-Lim's waveform is one hop shorter
    assert len(port_wav) == len(jax_wav) == (cut if vocoder == "hifigan" else cut - 1) * 256
    diff = np.abs(port_wav - jax_wav).max()
    if vocoder == "hifigan":
        assert diff * 32768 <= 2
    else:
        assert diff <= 1e-3 * np.abs(jax_wav).max()


def test_vocoder_policy_follows_the_device(tmp_path):
    """The commands' generator (``load_hifigan``, the one ``say``, the
    server, ``test`` and ``test_correlation`` build) is F32, on the card (K2's
    f32 mode) as on the CPU, the policy of the generator JAX's
    ``run/common.py::load_hifigan`` builds from the same ``g_*`` file,
    whatever the Tacotron config's precision; K2's bf16 mode is reached
    only through an explicit bf16 policy."""
    _, _, g_path = _files(tmp_path, 3.0)
    jax_model, _ = jax_load_hifigan(g_path)
    assert jax_model.policy.compute_dtype == jnp.float32
    port = load_hifigan(g_path, torch.device("cpu"))
    assert port.policy == F32 and port.policy.compute_dtype == torch.float32
    assert next(port.parameters()).device.type == "cpu"
    bf16 = load_hifigan(g_path, torch.device("cpu"), Policy(torch.bfloat16))
    assert bf16.policy.compute_dtype == torch.bfloat16
    assert all(torch.equal(a, b) for a, b in zip(port.state_dict().values(),
                                                 bf16.state_dict().values()))
