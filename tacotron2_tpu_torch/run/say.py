"""``say``: text -> WAV on the port.

Counterpart of ``run/say.py`` of the JAX package (and its helpers in
``run/common.py``) for the vanilla configuration, its speaker tokens,
controls, description embeddings and Global Style Tokens (``--speaker-id``,
``--controls``, ``--description`` with ``--bert-checkpoint``,
``--gst-reference``): text frontend (no abbreviation expansion) -> encoder
(fused with the speaker's embedding, the memory widened by the
description's BERT pooler embedding, zeros without a description, then by
a GST model's style: the reference WAV's log-mel through the GST, or the
neutral style without one) -> free-running decode through kernel K1 (or,
with ``--quantize-int8``, K5 for the int8 LSTM cells), the controls through
their rows of the decoder cell and the heads, with early stop
-> postnet -> cut at the first fired gate -> HiFi-GAN over a 128-frame
bucket with a receptive-field margin (kernel K2) -> PCM16 WAV; without a
HiFi-GAN checkpoint, Griffin-Lim on exp(mel).

``--random-seed`` seeds the torch.Generator that draws the prenet's
AlwaysDropout masks, so one seed reproduces the audio on one device.

The vocoder runs at the JAX package's precision, f32, on every device and
whatever the Tacotron config (see ``load_hifigan``).
"""

from __future__ import annotations

import secrets
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tacotron2_tpu_torch.audio.griffin_lim import mel_to_audio
from tacotron2_tpu_torch.audio.io import read_wav, write_wav
from tacotron2_tpu_torch.audio.mel import TacotronMelSpectrogram
from tacotron2_tpu_torch.config import Config
from tacotron2_tpu_torch.convert import (load_hifigan_checkpoint, load_strict,
                                         load_tacotron2_checkpoint)
from tacotron2_tpu_torch.models.hifigan import HiFiGAN, HiFiGANConfig
from tacotron2_tpu_torch.models.layers import F32, Policy, resolve_device, use_f32_math
from tacotron2_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from tacotron2_tpu_torch.text.cleaners import normalize_text
from tacotron2_tpu_torch.text.encoder import CharEncoder

MAX_LEN = 5000  # frames cap
VOCODE_BUCKET = 128  # vocoder input frames are a multiple of this
NO_BERT = ("--description needs --bert-checkpoint (a local BERT directory or state-dict file): "
           "the port never downloads BERT")


def model_config_from(cfg: Config) -> Tacotron2Config:
    """The model of a config: vanilla, with speaker tokens, controls,
    description embeddings and GST (JAX ``run/common.py::model_config_from``)."""
    ext = cfg.extensions
    m = cfg.model
    return Tacotron2Config(
        num_chars=cfg.num_chars, encoded_dim=m.encoded_dim,
        encoder_kernel_size=m.encoder_kernel_size,
        num_mels=cfg.dataset.preprocessing.num_mels, prenet_dim=m.prenet_dim,
        att_rnn_dim=m.att_rnn_dim, att_dim=m.att_dim, rnn_hidden_dim=m.rnn_hidden_dim,
        postnet_dim=m.postnet_dim, dropout=m.dropout,
        speaker_tokens=ext.speaker_tokens.active, num_speakers=ext.speaker_tokens.num_speakers,
        controls=ext.controls.active, controls_dim=cfg.controls_dim,
        description_embeddings=m.description_embeddings,
        description_embeddings_dim=m.description_embeddings_dim,
        gst=ext.gst.active, gst_token_embedding_size=ext.gst.token_embedding_size,
    )


def refuse_descriptions(cfg: Config, command: str) -> None:
    """Raise for a description model in a command whose JAX counterpart
    passes no description embeddings to the model (``server``, ``test``,
    ``train_mel_export``): JAX's fails deep in ``_encode``; the port stops
    at start and says why."""
    if cfg.model.description_embeddings:
        raise NotImplementedError(
            f"{command} takes no description model: its JAX counterpart passes no description "
            "embeddings to the model there (only say --description and train do)")


def description_embedding(cfg: Config, description: Optional[str],
                          bert_checkpoint: Optional[str], device) -> Tuple[torch.Tensor, float]:
    """A description model's (1, dim) embedding of ``description`` (JAX
    ``bert_description_embedding``): BERT's pooler output on ``device`` from
    the local weights of ``bert_checkpoint``, zeros without a description;
    -> (the embedding, the host seconds of BERT's encode, ending in a
    device sync)."""
    dim = cfg.model.description_embeddings_dim
    if description is None:
        return torch.zeros(1, dim), 0.0
    if bert_checkpoint is None:
        raise ValueError(NO_BERT)
    from tacotron2_tpu_torch.run.embed_descriptions import BertEmbedder

    embedder = BertEmbedder.from_local(bert_checkpoint, device)
    _sync(embedder.device)
    t0 = time.perf_counter()
    emb = torch.as_tensor(embedder.embed([description]))
    return emb, time.perf_counter() - t0


def gst_reference_mel(cfg: Config, gst_reference: str) -> torch.Tensor:
    """``--gst-reference``'s WAV -> its log-mel (1, frames, M) by the
    port's numpy frontend (JAX ``run/say.py``): the config must have GST and
    the WAV its sample rate."""
    if not cfg.extensions.gst.active:
        raise ValueError("--gst-reference given, but extensions.gst is not active in this "
                         "config.")
    prep = cfg.dataset.preprocessing
    wav, sr = read_wav(gst_reference)
    if sr != prep.sample_rate:
        raise ValueError(f"--gst-reference sample rate {sr} != configured {prep.sample_rate}")
    mel = TacotronMelSpectrogram(n_mels=prep.num_mels, sample_rate=prep.sample_rate)(wav)
    return torch.as_tensor(mel)[None]


def conditioning(cfg: Config, speaker_id: Optional[int] = None,
                 controls: Optional[str] = None) -> dict:
    """``say``'s ``speaker_id`` and ``controls`` (comma-separated numbers)
    -> the decode's keyword arguments for a batch of one, checked against
    the model as the JAX ``say`` and ``_check_controls`` check them: a
    multi-speaker model needs a speaker id in range, a controllable model
    exactly ``controls_dim`` numbers; a model without either takes none
    (voice 0 stands for none)."""
    spk, dim = cfg.extensions.speaker_tokens, cfg.controls_dim
    kw: dict = {}
    if spk.active:
        if speaker_id is None:
            raise ValueError("--speaker-id is required: this is a multi-speaker model "
                             "(extensions.speaker_tokens.active).")
        if not 0 <= int(speaker_id) < spk.num_speakers:
            raise ValueError(f"speaker_id {speaker_id} out of range [0, {spk.num_speakers})")
        kw["speaker_id"] = torch.tensor([int(speaker_id)])
    elif speaker_id not in (None, 0):
        raise ValueError("model is single-speaker, but a speaker id was passed")
    controls = [float(x) for x in controls.split(",")] if controls else None
    if dim:
        if controls is None:
            raise ValueError(f"Controls are enabled: --controls needs {dim} comma-separated "
                             "numbers")
        if len(controls) != dim:
            raise ValueError(f"--controls needs {dim} numbers, got {len(controls)}")
        kw["controls"] = torch.tensor([controls], dtype=torch.float32)
    elif controls:
        raise ValueError("Controls are disabled, but a control vector was passed!")
    return kw


def load_tacotron(cfg: Config, checkpoint: str, device) -> Tacotron2:
    model = Tacotron2(model_config_from(cfg), Policy.from_string(cfg.training.precision))
    load_strict(model, load_tacotron2_checkpoint(checkpoint)[0])
    return model.to(device).eval()


def load_hifigan(checkpoint: str, device, policy: Policy = F32) -> HiFiGAN:
    """The ``g_*`` generator on ``device``, built under F32 as the JAX
    package's ``load_hifigan`` builds every vocoder, whatever the Tacotron
    config: on the card its MRF stages run K2's f32 mode
    (``csrc/mrf_f32.cu``). ``Policy(torch.bfloat16)`` builds K2's bf16 mode
    instead, as the TPU kernels' ``bf16=True``; no command asks for it."""
    h, sd = load_hifigan_checkpoint(checkpoint)
    model = HiFiGAN(HiFiGANConfig.from_dict(h), policy)
    load_strict(model, sd)
    return model.to(device).eval()


def vocode_bucket(hifigan: HiFiGAN, cut: int) -> int:
    """Frames the vocoder sees for rows cut at up to ``cut`` frames: a
    multiple of 128 at least ``cut`` plus the receptive field, so no kept
    sample's receptive field reaches the bucket's end."""
    return -(-(cut + hifigan.mel_receptive_field()) // VOCODE_BUCKET) * VOCODE_BUCKET


def cut_vocode(hifigan: HiFiGAN, mels_post: torch.Tensor, row_idx: Sequence[int],
               cuts: Sequence[int], Tb: int, plain: bool = False) -> torch.Tensor:
    """Rows ``row_idx`` of ``mels_post`` (B, T, M), each cut at its ``cuts``
    frames, through one HiFi-GAN call -> int16 PCM (len(row_idx), Tb * hop)
    on the device (JAX ``run/common.py::jitted_cut_vocoder``).

    The rows are gathered, padded or cut to the bucket of ``Tb`` frames
    (``vocode_bucket``), and the frames at or past each row's cut zeroed; a
    row with cut 0 is all zero (the server's padding rows). Row i's first
    cuts[i] * hop samples are its audio, the same whatever bucket and rows
    it shares the call with. The clip to [-1, 1 - 1/32768] and the x32768
    int16 cast truncate toward zero, as the WAV writer does. ``plain``:
    the vocoder's plain reference route (see ``HiFiGAN.apply``)."""
    dev = mels_post.device
    m = mels_post[torch.as_tensor(list(row_idx), device=dev), :Tb]
    if m.shape[1] < Tb:
        m = torch.nn.functional.pad(m, (0, 0, 0, Tb - m.shape[1]))
    keep = torch.arange(Tb, device=dev)[None, :] < torch.as_tensor(list(cuts), device=dev)[:, None]
    wav = hifigan.apply(m * keep[..., None], plain)
    return (wav.clamp(-1.0, 1.0 - 1.0 / 32768.0) * 32768.0).to(torch.int16)


def griffin_lim_vocode(mel_post: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """One row's log-mel (frames, M) -> float waveform through Griffin-Lim
    on exp(mel), on the mel's device (JAX ``run/common.py::vocode`` without
    a vocoder)."""
    return mel_to_audio(torch.exp(mel_post), sample_rate=sample_rate)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def do_say(cfg: Config, checkpoint: str, text: str, output: str,
           hifi_gan_checkpoint: Optional[str] = None,
           random_seed: Optional[int] = None, max_len_override: int = MAX_LEN,
           device: Optional[str] = None, quantize_int8: bool = False,
           speaker_id: Optional[int] = None, controls: Optional[str] = None,
           export_mel: bool = False, description: Optional[str] = None,
           bert_checkpoint: Optional[str] = None, gst_reference: Optional[str] = None) -> dict:
    """Synthesize ``text`` into ``output``; returns what ran and how long
    each phase took on the host clock (each phase ends in a device sync).
    ``quantize_int8``: decode with int8 LSTM weights (kernel K5), the JAX
    package's approximate ``--quantize-int8`` mode. ``speaker_id`` and
    ``controls``: the voice of a multi-speaker model and the controls of a
    controllable one (``conditioning``). Without a HiFi-GAN checkpoint the
    mel goes through Griffin-Lim. ``export_mel``: also save the vocoded mel,
    (M, cut), with ``np.save(output, ...)``, so ``o.wav`` gives ``o.wav.npy``.
    ``description`` and ``bert_checkpoint``: a description model's style
    text and the local BERT that embeds it (``description_embedding``); a
    model without description embeddings ignores them, as JAX's ``say``
    does. ``gst_reference``: a WAV whose style a GST model takes
    (``gst_reference_mel``); without it, the neutral style."""
    cond = conditioning(cfg, speaker_id, controls)
    if gst_reference is not None:
        cond["gst_reference_mel"] = gst_reference_mel(cfg, gst_reference)
    with_desc = cfg.model.description_embeddings
    if with_desc and description is not None and bert_checkpoint is None:
        raise ValueError(NO_BERT)  # before anything loads
    dev = resolve_device(device)
    if dev.type == "cuda":
        use_f32_math()
    bert_s = 0.0
    if with_desc:
        cond["description_embeddings"], bert_s = description_embedding(
            cfg, description, bert_checkpoint, dev)
    prep = cfg.dataset.preprocessing
    if random_seed is None:
        random_seed = secrets.randbelow(2**31)

    norm = normalize_text(text, prep.allowed_chars, prep.end_token, False)
    chars_idx, chars_len = CharEncoder(prep.allowed_chars, prep.end_token).encode_batch([norm])
    model = load_tacotron(cfg, checkpoint, dev)
    hifigan = (None if hifi_gan_checkpoint is None
               else load_hifigan(hifi_gan_checkpoint, dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(random_seed))

    _sync(dev)
    t0 = time.perf_counter()
    out = model.forward_infer_fast(torch.as_tensor(chars_idx, device=dev),
                                   torch.as_tensor(chars_len, device=dev),
                                   max_len_override, generator=gen, quantize=quantize_int8,
                                   **{k: v.to(dev) for k, v in cond.items()})
    _sync(dev)
    t1 = time.perf_counter()
    n = int(out.n_frames)
    cut = max(n - 1, 1)  # drop the frame whose gate fired
    if hifigan is None:
        wav = griffin_lim_vocode(out.mels_post[0, :cut], prep.sample_rate).cpu().numpy()
    else:
        pcm = cut_vocode(hifigan, out.mels_post, [0], [cut], vocode_bucket(hifigan, cut))
        wav = pcm[0, :cut * hifigan.cfg.total_upsample].cpu().numpy()
    t2 = time.perf_counter()
    write_wav(output, wav, prep.sample_rate)
    if export_mel:
        np.save(output, out.mels_post[0, :cut].T.cpu().numpy())
    print(f"wrote {output}: {len(wav) / prep.sample_rate:.2f}s "
          f"({n} frames, seed {random_seed}, {dev.type}"
          f"{', int8' if quantize_int8 else ''})")
    return {
        "output": output, "n_frames": n, "cut": cut, "samples": int(len(wav)),
        "chars": int(chars_len[0]), "seed": int(random_seed), "device": str(dev),
        "quantize_int8": quantize_int8, "vocoder": "griffin_lim" if hifigan is None else "hifigan",
        "speaker_id": speaker_id if "speaker_id" in cond else None,
        "controls": cond["controls"][0].tolist() if "controls" in cond else None,
        "description": description if with_desc else None, "bert_s": bert_s,
        "gst_reference": gst_reference,
        "decode_s": t1 - t0, "vocode_s": t2 - t1, "say_s": t2 - t0,
        "audio_s": len(wav) / prep.sample_rate,
    }
