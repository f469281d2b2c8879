"""Training scalars as JSON lines.

Counterpart of ``tacotron2_tpu/training/logging.py``'s scalars, with the
same names: ``training_{gate,mel,mel_post,tacotron}_loss``, ``training_loss``,
``training_grad_norm``, ``lr``, ``mel_frames_per_sec``, ``val_loss`` and
``val_mel_loss``. They go to ``<log_dir>/<name>/metrics.jsonl``, one object
per call: ``{"step": n, "<scalar>": value, ...}``. The validation images and
parameter histograms of the JAX logger are not ported.
"""

from __future__ import annotations

import json
import os
from typing import Dict


class TrainLogger:
    def __init__(self, log_dir: str, name: str):
        os.makedirs(os.path.join(log_dir, name), exist_ok=True)
        self.path = os.path.join(log_dir, name, "metrics.jsonl")

    def scalars(self, metrics: Dict[str, float], step: int) -> None:
        row = {"step": int(step), **{k: float(v) for k, v in metrics.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
