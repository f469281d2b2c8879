"""``test``: synthesize a config's test split on the port.

Counterpart of ``run/test.py::do_test`` of the JAX package: the test
manifest's rows (``force_speaker``'s speaker only, the first ``limit``) in
batches of 8, unshuffled, chars bucketed to 32 -> the free-running decode
(kernel K1) with each row's speaker id and controls from the manifest where
the config has them, early stop, one generator a batch seeded by the running
row count -> each row's frame count ``n``, the first frame whose gate logit
is negative -> the rows with 0 < n < max_len vocoded together in one
HiFi-GAN call (kernel K2), each cut at its ``n`` frames, and written as
``{row}.wav`` of n x 256 samples; without a HiFi-GAN checkpoint,
Griffin-Lim a row. A GST model decodes with the neutral style, as JAX's
``test`` passes no reference. A description model is refused at start: JAX's ``test``
passes no description embeddings. A row whose gate fires at frame 0 or never, or whose
Griffin-Lim raises, is a failure: ``failures.csv`` gets ``row|text``. An
error of the HiFi-GAN call raises.

JAX's ``test`` vocodes each row alone at its exact length; the port's
rows share one bucket of 128 frames (``say.vocode_bucket``), whose first
n x 256 samples of a row are that row's audio whatever it shares the call
with (``say.cut_vocode``).
"""

from __future__ import annotations

import os
import time
from os import path
from typing import Optional

import numpy as np
import torch

from tacotron2_tpu_torch.audio.io import write_wav
from tacotron2_tpu_torch.config import Config
from tacotron2_tpu_torch.data.loader import TTSDataLoader
from tacotron2_tpu_torch.data.manifest import manifest_dataset, read_manifest, select_rows
from tacotron2_tpu_torch.models.layers import resolve_device, use_f32_math
from tacotron2_tpu_torch.run.say import (MAX_LEN, _sync, cut_vocode, griffin_lim_vocode,
                                         load_hifigan, load_tacotron, refuse_descriptions,
                                         vocode_bucket)
from tacotron2_tpu_torch.training.step import to_device


def gate_to_lengths(gates: np.ndarray) -> np.ndarray:
    """(B, T, 1) gate logits -> frame counts: the first index whose gate is
    negative, T where none is."""
    fired = gates[..., 0] < 0.0
    return np.where(fired.any(axis=1), fired.argmax(axis=1), gates.shape[1])


def write_rows(hifigan, mels_post, ns, kept, sr: int, out_dir: str, first: int,
               gl_failures: bool = True) -> list:
    """Rows ``kept`` of ``mels_post`` (B, T, M), row b cut at ``ns[b]``
    frames, as ``out_dir/{first + b}.wav`` of ns[b] x 256 samples: the rows
    through one HiFi-GAN call (``cut_vocode`` over one bucket; its errors, a
    kernel that fails to build or launch or a CUDA fault, raise), or without
    a vocoder Griffin-Lim a row. -> the rows whose Griffin-Lim raised: a
    failure of ``test`` (JAX's ``test`` catches them); without
    ``gl_failures`` the error raises."""
    bad = []
    if hifigan is None:
        for b in kept:
            try:
                wav = griffin_lim_vocode(mels_post[b, :ns[b]], sr).cpu().numpy()
            except Exception as e:
                if not gl_failures:
                    raise
                print(f"Griffin-Lim of row {first + b} raised {e!r}")
                bad.append(b)
                continue
            write_wav(path.join(out_dir, f"{first + b}.wav"), wav[:ns[b] * 256], sr)
    elif kept:
        cuts = [ns[b] for b in kept]
        wavs = cut_vocode(hifigan, mels_post, kept, cuts,
                          vocode_bucket(hifigan, max(cuts))).cpu().numpy()
        for b, wav in zip(kept, wavs):
            write_wav(path.join(out_dir, f"{first + b}.wav"), wav[:ns[b] * 256], sr)
    return bad


def do_test(cfg: Config, speech_dir: str, checkpoint: str,
            hifi_gan_checkpoint: Optional[str] = None, results_dir: str = "results_test",
            batch_size: int = 8, max_len_override: int = MAX_LEN, limit: Optional[int] = None,
            device: Optional[str] = None) -> dict:
    """Synthesize the test split into ``results_dir``; returns what ran: the
    rows, each row's ``n``, the failures, and per batch its shape, executed
    decode frames and the host-clock seconds of its decode and its vocode
    (each ends in a device sync)."""
    refuse_descriptions(cfg, "test")
    dev = resolve_device(device)
    if dev.type == "cuda":
        use_f32_math()
    rows = select_rows(cfg, read_manifest(cfg.dataset.test))
    if limit:
        rows = rows[:limit]
    dataset = manifest_dataset(cfg, rows, speech_dir, cache=False, include_text=True)
    loader = TTSDataLoader(dataset, batch_size=batch_size, shuffle=False, drop_last=False,
                           bucket_chars=32)
    model = load_tacotron(cfg, checkpoint, dev)
    hifigan = (None if hifi_gan_checkpoint is None
               else load_hifigan(hifi_gan_checkpoint, dev))
    sr = cfg.dataset.preprocessing.sample_rate
    os.makedirs(results_dir, exist_ok=True)
    failures, lengths, batches = [], [], []
    i = 0
    for batch in loader:
        b_dev = to_device(batch, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(i)
        _sync(dev)
        t0 = time.perf_counter()
        out = model.forward_infer_fast(b_dev["chars_idx"], b_dev["chars_len"], max_len_override,
                                       generator=gen, speaker_id=b_dev.get("speaker_id"),
                                       controls=b_dev.get("controls"))
        ns = [int(n) for n in gate_to_lengths(out.gates.cpu().numpy())]
        t1 = time.perf_counter()
        texts = batch["text"]
        kept = [b for b, n in enumerate(ns) if 0 < n < max_len_override]
        bad = [b for b in range(len(ns)) if b not in kept]
        bad += write_rows(hifigan, out.mels_post, ns, kept, sr, results_dir, i)
        t2 = time.perf_counter()
        failures += [(i + b, texts[b]) for b in sorted(bad)]
        lengths += ns
        batches.append({"rows": len(ns), "chars": int(batch["chars_idx"].shape[1]),
                        "decode_frames": int(out.n_frames), "vocoded": len(kept),
                        "decode_s": t1 - t0, "vocode_s": t2 - t1})
        i += len(ns)

    if failures:
        with open(path.join(results_dir, "failures.csv"), "a") as f:
            for idx, text in failures:
                f.write(f"{idx}|{text}\n")
    print(f"test: wrote {i - len(failures)} wavs, {len(failures)} failures -> {results_dir}")
    return {"results_dir": results_dir, "rows": i, "lengths": lengths, "failures": failures,
            "batches": batches, "device": str(dev),
            "vocoder": "griffin_lim" if hifigan is None else "hifigan"}
