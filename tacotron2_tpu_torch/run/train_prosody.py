"""``train_prosody``: the prosody predictor's training driver.

Counterpart of the JAX package's ``run/train_prosody.py`` (the reference's
``ProsodyPredictorLightning``): the config's manifests -> datasets whose
targets are the feature columns (``DEFAULT_FEATURES``, the reference
wrapper's seven ``*_norm_clip`` columns, or
``extensions.prosody_model.features``; not the controls' list) -> loaders
(frames bucketed to 128) -> a ``ProsodyPredictor`` from ``seed`` -> MSE
regression with Adam at ``lr`` (1e-5), no weight decay and no clip, and
MultiStepLR at epoch 65 (x 0.1, stepped per step) -> train loss, lr and
each feature's CCC logged every ``LOG_EVERY`` steps, validation loss and
CCC once an epoch and at the end -> ``prosody_last.ckpt`` every
``SAVE_EVERY`` steps and ``prosody_final.ckpt``, with the hyperparameters
``train --prosody-model-checkpoint`` rebuilds the predictor from. Logs go to ``<results>/lightning_logs/prosody/``. Runs on the card
unless ``device`` is "cpu".
"""

from __future__ import annotations

import datetime
import os
import time
from os import path
from typing import Dict, Optional

import numpy as np
import torch

from tacotron2_tpu_torch.config import Config
from tacotron2_tpu_torch.data.dataset import TTSDataset
from tacotron2_tpu_torch.data.loader import TTSDataLoader
from tacotron2_tpu_torch.data.manifest import read_manifest
from tacotron2_tpu_torch.models.layers import resolve_device, use_f32_math
from tacotron2_tpu_torch.models.prosody import ProsodyPredictor
from tacotron2_tpu_torch.run.say import _sync
from tacotron2_tpu_torch.training.checkpoint import save_prosody_checkpoint
from tacotron2_tpu_torch.training.logging import TrainLogger
from tacotron2_tpu_torch.training.losses import ccc_per_feature, mse
from tacotron2_tpu_torch.training.step import to_device as step_to_device

# the reference wrapper's targets (prosody_detector.py:167-175)
DEFAULT_FEATURES = [
    "pitch_mean_norm_clip",
    "pitch_range_norm_clip",
    "intensity_mean_norm_clip",
    "jitter_norm_clip",
    "shimmer_norm_clip",
    "nhr_norm_clip",
    "rate_norm_clip",
]
LOG_EVERY = 50
SAVE_EVERY = 5000
LR_MILESTONE_EPOCH = 65


def _dataset(cfg: Config, rows, features, speech_dir: str) -> TTSDataset:
    """The JAX driver's dataset arguments: the preprocessing's chars, trim
    and mels, the constructor's defaults for the rest (no cache)."""
    p = cfg.dataset.preprocessing
    return TTSDataset([r["wav"] for r in rows], [r["text"] for r in rows], speech_dir,
                      features=[[float(r[f]) if r[f] else float("nan") for f in features]
                                for r in rows],
                      allowed_chars=p.allowed_chars, end_token=p.end_token, trim=p.trim,
                      trim_top_db=p.trim_top_db, trim_frame_length=p.trim_frame_length,
                      num_mels=p.num_mels, sample_rate=p.sample_rate)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The batch on ``device``, its targets (the collate's ``controls``) as
    ``features`` (JAX ``_collate_key_fixup``)."""
    b = step_to_device(batch, device)
    b["features"] = b.pop("controls")
    return b


def prosody_train_step(predictor: ProsodyPredictor, opt, sched, batch: Dict[str, torch.Tensor],
                       generator: Optional[torch.Generator] = None):
    """One step of MSE(pred, features) (JAX ``make_prosody_train_step``);
    -> (loss, pred), device tensors."""
    opt.zero_grad(set_to_none=True)
    with torch.enable_grad():
        pred = predictor(batch["mel"], batch["mel_len"], train=True, generator=generator)[0]
        loss = mse(pred, batch["features"])
        loss.backward()
    opt.step()
    sched.step()
    return loss.detach(), pred.detach()


def _ccc_scalars(prefix: str, features, pred: torch.Tensor, target: torch.Tensor) -> dict:
    ccc = ccc_per_feature(pred.float(), target.float()).tolist()
    return {f"{prefix}_{name}": c for name, c in zip(features, ccc)}


def do_train_prosody(cfg: Config, raw_config: dict, speech_dir: str,
                     results_dir: Optional[str] = None, steps: int = 10_000, lr: float = 1e-5,
                     batch_size: int = 32, seed: int = 0, device: Optional[str] = None) -> dict:
    """Train the predictor; -> the final checkpoint's path, the features,
    and a record per step (loss, host seconds ending in a sync) and per
    validation (loss, CCC per feature)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        use_f32_math()
    if results_dir is None:
        results_dir = f"results_prosody_{cfg.training.name} {datetime.datetime.now()}"
    os.makedirs(results_dir, exist_ok=True)
    features = cfg.extensions.prosody_model.features or DEFAULT_FEATURES
    train_rows, val_rows = read_manifest(cfg.dataset.train), read_manifest(cfg.dataset.val)
    missing = [f for f in features if not train_rows or f not in train_rows[0]]
    if missing:
        raise ValueError(f"prosody feature columns missing from {cfg.dataset.train}: {missing}")
    train_set = _dataset(cfg, train_rows, features, speech_dir)
    val_set = _dataset(cfg, val_rows, features, speech_dir)
    train_loader = TTSDataLoader(train_set, batch_size=batch_size, shuffle=True, drop_last=True,
                                 seed=seed, bucket_chars=32, bucket_frames=128)
    val_loader = TTSDataLoader(val_set, batch_size=batch_size, shuffle=False, drop_last=False,
                               bucket_chars=32, bucket_frames=128)

    torch.manual_seed(seed)
    predictor = ProsodyPredictor(num_features=len(features),
                                 num_mels=cfg.dataset.preprocessing.num_mels).to(dev)
    steps_per_epoch = max(1, len(train_loader))
    opt = torch.optim.Adam(predictor.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.MultiStepLR(opt, [LR_MILESTONE_EPOCH * steps_per_epoch],
                                                 0.1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    logger = TrainLogger(path.join(results_dir, "lightning_logs"), "prosody")
    hparams = {**predictor.hparams(), "features": list(features)}
    record: dict = {"steps": [], "val": []}

    @torch.no_grad()
    def run_validation(at: int) -> Optional[float]:
        losses, preds, ys = [], [], []
        for batch in val_loader:
            b = to_device(batch, dev)
            pred = predictor(b["mel"], b["mel_len"])[0]
            losses.append(mse(pred, b["features"]))
            preds.append(pred)
            ys.append(b["features"])
        if not losses:
            return None
        scalars = {"val_loss": float(torch.stack(losses).mean()),
                   **_ccc_scalars("val", features, torch.cat(preds), torch.cat(ys))}
        logger.scalars(scalars, at)
        record["val"].append({"step": at, **scalars})
        return scalars["val_loss"]

    print(f"train_prosody: {len(train_set)} utts, {steps_per_epoch} steps/epoch, {steps} steps, "
          f"features {features}, {dev}")
    step = 0
    while step < steps:
        for batch in train_loader:
            if step >= steps:
                break
            t0 = time.perf_counter()
            b = to_device(batch, dev)
            loss, pred = prosody_train_step(predictor, opt, sched, b, gen)
            _sync(dev)
            step += 1
            record["steps"].append({"step": step, "loss": float(loss),
                                    "rows": int(batch["mel"].shape[0]),
                                    "frames": int(batch["mel"].shape[1]),
                                    "s": time.perf_counter() - t0})
            if step % LOG_EVERY == 0 or step == 1:
                scalars = {"train_loss": float(loss), "lr": sched.get_last_lr()[0],
                           **_ccc_scalars("train", features, pred, b["features"])}
                logger.scalars(scalars, step)
                print(f"prosody step {step}: loss {scalars['train_loss']:.4f}")
            if step % steps_per_epoch == 0:
                run_validation(step)
            if step % SAVE_EVERY == 0:
                save_prosody_checkpoint(path.join(results_dir, "prosody_last.ckpt"), predictor,
                                        hparams, raw_config)
    run_validation(step)
    out = save_prosody_checkpoint(path.join(results_dir, "prosody_final.ckpt"), predictor,
                                  hparams, raw_config)
    logger.close()
    print(f"saved {out}")
    return {"checkpoint": out, "step": step, "features": list(features), **record}
