"""Checkpoints in the reference's Lightning ``.ckpt`` layout.

Counterpart of ``tacotron2_tpu/training/checkpoint.py`` (whose checkpoints
are Orbax directories; the port neither reads nor writes those). One file
holds what a Lightning trainer saves and resumes from:

- ``state_dict``: the model's, keys prefixed ``tacotron2.`` (so the port's
  ``say`` and the JAX package's converter both load it);
- ``optimizer_states``: ``[Adam.state_dict()]``;
- ``lr_schedulers``: ``[MultiStepLR.state_dict()]``;
- ``global_step``, and ``hyper_parameters`` (the raw config).
"""

from __future__ import annotations

from typing import Optional

import torch

from tacotron2_tpu_torch.convert import load_strict, load_tacotron2_checkpoint, to_lightning


def _cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_cpu(v) for v in x)
    return x


def save_checkpoint(path: str, model: torch.nn.Module, opt=None, sched=None, step: int = 0,
                    hparams: Optional[dict] = None) -> str:
    ckpt = to_lightning(_cpu(model.state_dict()), hparams)
    ckpt["global_step"] = int(step)
    if opt is not None:
        ckpt["optimizer_states"] = [_cpu(opt.state_dict())]
    if sched is not None:
        ckpt["lr_schedulers"] = [sched.state_dict()]
    torch.save(ckpt, path)
    return path


def load_model_state(path: str, model: torch.nn.Module) -> None:
    """The checkpoint's weights and BatchNorm statistics into ``model``."""
    load_strict(model, load_tacotron2_checkpoint(path)[0])


def load_train_state(path: str, opt, sched) -> int:
    """Restore the optimizer and schedule in place; -> the saved step, or 0
    for a checkpoint without optimizer state (weights only). The schedule
    keeps the milestones it was built with (the JAX driver derives them from
    the current config's ``max_steps`` too)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if not ckpt.get("optimizer_states"):
        return 0
    opt.load_state_dict(ckpt["optimizer_states"][0])
    if ckpt.get("lr_schedulers"):
        milestones = sched.milestones
        sched.load_state_dict(ckpt["lr_schedulers"][0])
        sched.milestones = milestones
    return int(ckpt["global_step"])
