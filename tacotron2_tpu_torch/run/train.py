"""``train``: the port's training driver.

Counterpart of ``run/train.py::do_train`` of the JAX package for the
vanilla configuration and its speaker tokens and controls: pipe-separated
manifests (with ``force_speaker`` their rows of that speaker only) ->
datasets with the manifests' ``speaker_id`` column and the config's
``extensions.controls.features`` columns, and loaders (chars bucketed to 32,
frames to 128) -> a new model from ``--seed`` or the weights of
``--resume-ckpt`` -> Adam + MultiStepLR (milestones at the config's
fractions of ``max_steps``), restored with the step on resume -> the loop,
logging every ``LOG_EVERY`` steps with the real-frame throughput ->
validation every ``val_check_interval`` (Lightning's meaning; once an epoch
by default) and at the end -> ``final.ckpt`` (and ``last.ckpt`` every 5,000
steps), in the reference's Lightning layout.

Not ported: finetuning and its freeze masks (the speaker embedding's
among them), description embeddings, GST and the prosody style loss
(``train`` refuses their configs, ``check_trainable``), multi-device
training and the device prefetcher, TensorBoard images and histograms.
"""

from __future__ import annotations

import datetime
import os
import time
from os import path
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from tacotron2_tpu_torch.config import Config
from tacotron2_tpu_torch.data.loader import TTSDataLoader
from tacotron2_tpu_torch.data.manifest import manifest_dataset, read_manifest, select_rows
from tacotron2_tpu_torch.models.layers import Policy, resolve_device, use_f32_math
from tacotron2_tpu_torch.models.tacotron2 import Tacotron2
from tacotron2_tpu_torch.run.say import _sync, model_config_from
from tacotron2_tpu_torch.training import checkpoint as ckpt_lib
from tacotron2_tpu_torch.training.logging import TrainLogger
from tacotron2_tpu_torch.training.optimizer import make_optimizer
from tacotron2_tpu_torch.training.step import eval_step, to_device, train_step

VAL_BATCH = 64
LOG_EVERY = 50
SAVE_EVERY = 5000


def _endless(loader) -> Iterator[Dict[str, np.ndarray]]:
    while True:
        n = 0
        for batch in loader:
            n += 1
            yield batch
        if n == 0:
            raise ValueError("the training manifest gives no full batch")


def check_trainable(cfg: Config) -> None:
    """Raise for a config the port cannot train yet: GST and description
    embeddings need their auxiliary models, and the prosody model's style
    loss its predictor (ROADMAP A6, A7). Speaker tokens and controls train."""
    ext = cfg.extensions
    if ext.gst.active or cfg.model.description_embeddings or ext.prosody_model.active:
        raise NotImplementedError(
            "the port trains the vanilla configuration and its speaker tokens and controls; "
            "GST, description embeddings and the prosody model's style loss come after their "
            "auxiliary models (ROADMAP A6, A7)")


def do_train(cfg: Config, raw_config: dict, speech_dir: str, results_dir: Optional[str] = None,
             resume_ckpt: Optional[str] = None, seed: int = 0,
             max_steps_override: Optional[int] = None, device: Optional[str] = None) -> dict:
    """Train; returns the final checkpoint's path, the step reached, and a
    record per train step (loss, decode frames T, real mel frames, host
    seconds ending in a device sync) and per validation batch (T)."""
    check_trainable(cfg)
    dev = resolve_device(device)
    if dev.type == "cuda":
        use_f32_math()
    if results_dir is None:
        results_dir = f"results_{cfg.training.name} {datetime.datetime.now()}"
    os.makedirs(results_dir, exist_ok=True)
    cache_dir = path.join(results_dir, "mel_cache")
    train_set = manifest_dataset(cfg, select_rows(cfg, read_manifest(cfg.dataset.train)),
                                 speech_dir, cache_dir=cache_dir)
    val_set = manifest_dataset(cfg, select_rows(cfg, read_manifest(cfg.dataset.val)),
                               speech_dir, cache_dir=cache_dir)
    batch_size = cfg.training.batch_size
    train_loader = TTSDataLoader(train_set, batch_size=batch_size, shuffle=True, drop_last=True,
                                 seed=seed, bucket_chars=32, bucket_frames=128)
    val_loader = TTSDataLoader(val_set, batch_size=VAL_BATCH, shuffle=False, drop_last=False,
                               bucket_chars=32, bucket_frames=128)

    max_steps = max_steps_override or cfg.training.max_steps
    milestones = [int(x * max_steps) for x in cfg.model.scheduler_milestones]
    torch.manual_seed(seed)
    model = Tacotron2(model_config_from(cfg), Policy.from_string(cfg.training.precision))
    if resume_ckpt is not None:
        ckpt_lib.load_model_state(resume_ckpt, model)
    model.to(dev)
    opt, sched = make_optimizer(model.parameters(), cfg.training.lr, cfg.training.weight_decay,
                                milestones)
    step = 0 if resume_ckpt is None else ckpt_lib.load_train_state(resume_ckpt, opt, sched)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1 + step)  # dropout bits; a resumed run draws new ones
    logger = TrainLogger(path.join(results_dir, "lightning_logs"), cfg.training.name)

    steps_per_epoch = max(1, len(train_loader))
    interval = cfg.training.val_check_interval
    if interval is None:
        val_every = steps_per_epoch
    elif isinstance(interval, float):
        val_every = max(1, int(steps_per_epoch * interval))
    else:
        val_every = int(interval)
    record: dict = {"steps": [], "val_decode_frames": []}

    def run_validation(at: int) -> Optional[float]:
        losses = []
        for batch in val_loader:
            losses.append(eval_step(model, to_device(batch, dev), gen)["loss"])
            record["val_decode_frames"].append(int(batch["mel"].shape[1]))
        if not losses:
            return None
        mean = float(torch.stack(losses).mean())
        logger.scalars({"val_loss": mean, "val_mel_loss": mean}, at)
        return mean

    print(f"train: {len(train_set)} utts, {steps_per_epoch} steps/epoch, max_steps {max_steps}, "
          f"batch {batch_size}, start step {step}, {dev}")
    t_log, frames_log = time.perf_counter(), 0
    stop_threshold = cfg.training.stopping_val_loss_threshold
    for batch in _endless(train_loader):
        if step >= max_steps:
            break
        t0 = time.perf_counter()
        metrics = train_step(model, opt, sched, to_device(batch, dev), gen)
        _sync(dev)
        frames = int(batch["mel_len"].sum())
        step += 1
        record["steps"].append({"step": step, "loss": float(metrics["loss"]),
                                "decode_frames": int(batch["mel"].shape[1]),
                                "mel_frames": frames, "s": time.perf_counter() - t0})
        frames_log += frames
        if step % LOG_EVERY == 0 or step == 1:
            names = sorted(metrics)
            vals = torch.stack([metrics[k].float() for k in names]).tolist()
            m = {f"training_{k}": v for k, v in zip(names, vals)}
            m["lr"] = sched.get_last_lr()[0]
            m["mel_frames_per_sec"] = frames_log / max(time.perf_counter() - t_log, 1e-9)
            t_log, frames_log = time.perf_counter(), 0
            logger.scalars(m, step)
            print(f"step {step}: loss {m['training_loss']:.4f} "
                  f"({m['mel_frames_per_sec']:.0f} frames/s)")
        if step % val_every == 0:
            val_loss = run_validation(step)
            if stop_threshold is not None and val_loss is not None and val_loss <= stop_threshold:
                print(f"early stop: val_loss {val_loss:.4f} <= {stop_threshold}")
                break
        if step % SAVE_EVERY == 0:
            ckpt_lib.save_checkpoint(path.join(results_dir, "last.ckpt"), model, opt, sched,
                                     step, raw_config)
    run_validation(step)
    out = ckpt_lib.save_checkpoint(path.join(results_dir, "final.ckpt"), model, opt, sched, step,
                                   raw_config)
    print(f"saved {out}")
    return {"checkpoint": out, "step": step, **record}
