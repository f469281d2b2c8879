"""``train_mel_export``: teacher-forced mels of the train and val splits.

Counterpart of ``run/train_mel_export.py::do_train_mel_export`` of the JAX
package: per split (train, then val), the manifest's rows in batches of 64,
unshuffled, chars bucketed to 32 and frames to 128 -> ``forward_teacher``
in eval mode (BatchNorm on running statistics, no LSTM dropout, the prenet's
AlwaysDropout from a generator seeded by the split's running row count)
under ``torch.no_grad``: the teacher-forced decode is kernel K3 alone (an
F32 model's the stock-op scan's forward, ``Tacotron2.teacher_route``) ->
``mels_post[b, :mel_len]`` as ``results_dir/<basename>.npy``, the ``.wav``
of the file name replaced (a ``.flac`` row keeps its name and gets ``.npy``
added, as ``np.save`` does). These are the mels a HiFi-GAN is fine-tuned on.
A GST model's style is each batch's own teacher-forced one: the GST over
the batch's ground-truth mel, BatchNorm on its running statistics.
A description model is refused at start: JAX's export passes no description
embeddings.
"""

from __future__ import annotations

import os
import time
from os import path
from typing import Optional

import numpy as np
import torch

from tacotron2_tpu_torch.config import Config
from tacotron2_tpu_torch.data.loader import TTSDataLoader
from tacotron2_tpu_torch.data.manifest import manifest_dataset, read_manifest
from tacotron2_tpu_torch.models.layers import resolve_device, use_f32_math
from tacotron2_tpu_torch.run.say import _sync, load_tacotron, refuse_descriptions
from tacotron2_tpu_torch.training.step import to_device


def do_train_mel_export(cfg: Config, speech_dir: str, checkpoint: str,
                        results_dir: str = "results_mel_export", batch_size: int = 64,
                        device: Optional[str] = None) -> dict:
    """Export the mels; returns per split the files written and per batch
    its shape and the host-clock seconds of its forward (ending in the
    copy to the host)."""
    refuse_descriptions(cfg, "train_mel_export")
    dev = resolve_device(device)
    if dev.type == "cuda":
        use_f32_math()
    model = load_tacotron(cfg, checkpoint, dev)
    os.makedirs(results_dir, exist_ok=True)
    record: dict = {"results_dir": results_dir, "device": str(dev)}
    for split in ("train", "val"):
        rows = read_manifest(getattr(cfg.dataset, split))
        dataset = manifest_dataset(cfg, rows, speech_dir, cache=False, include_filename=True)
        loader = TTSDataLoader(dataset, batch_size=batch_size, shuffle=False, drop_last=False,
                               bucket_chars=32, bucket_frames=128)
        count, files, batches = 0, [], []
        for batch in loader:
            b_dev = to_device(batch, dev)
            gen = torch.Generator(device=dev)
            gen.manual_seed(count)
            _sync(dev)
            t0 = time.perf_counter()
            with torch.no_grad():
                out = model.forward_teacher(
                    b_dev["chars_idx"], b_dev["chars_len"], b_dev["mel"], b_dev["mel_len"],
                    train=False, generator=gen, speaker_id=b_dev.get("speaker_id"),
                    controls=b_dev.get("controls"))
            mels_post = out.mels_post.cpu().numpy()
            batches.append({"rows": len(batch["filename"]),
                            "chars": int(batch["chars_idx"].shape[1]),
                            "frames": int(batch["mel"].shape[1]),
                            "mel_frames": int(batch["mel_len"].sum()),
                            "s": time.perf_counter() - t0})
            for b, fname in enumerate(batch["filename"]):
                out_name = path.join(results_dir, path.basename(fname).replace(".wav", ".npy"))
                np.save(out_name, mels_post[b, :int(batch["mel_len"][b])])
                files.append(out_name if out_name.endswith(".npy") else out_name + ".npy")
                count += 1
        print(f"{split}: exported {count} mels")
        record[split] = {"files": files, "batches": batches}
    return record
