"""Checkpoints in the reference's Lightning ``.ckpt`` layout.

Counterpart of ``tacotron2_tpu/training/checkpoint.py``, whose checkpoints
are Orbax directories: the port reads those too (``training/orbax.py``,
where ``tensorstore`` is installed; ``convert.lightning_from_orbax`` maps
them onto this layout, and ``python -m tacotron2_tpu_torch convert`` writes
it) but writes only its own. One file holds what a Lightning trainer saves
and resumes from:

- ``state_dict``: the model's, keys prefixed ``tacotron2.`` (so the port's
  ``say`` and the JAX package's converter both load it);
- ``optimizer_states``: ``[Adam.state_dict()]``;
- ``lr_schedulers``: ``[MultiStepLR.state_dict()]``;
- ``global_step``, and ``hyper_parameters`` (the raw config).

Every file is written to a temporary name beside it and moved into place
(``os.replace``), so a write cut off midway leaves the previous file whole.
``AsyncSaver`` is the train loop's periodic save (JAX ``AsyncSaver``): it
snapshots on the caller's thread and writes in the background. The prosody
predictor's checkpoint (``save_prosody_checkpoint``) holds its
``state_dict`` and the hyperparameters that rebuild it.
"""

from __future__ import annotations

import copy
import os
import threading
from typing import Optional

import torch

from tacotron2_tpu_torch.convert import (lightning_from_orbax, load_strict,
                                         load_tacotron2_checkpoint, prosody_from_jax_params,
                                         to_lightning)


def _cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_cpu(v) for v in x)
    return x


def _clone(x):
    """A copy of every tensor of a state tree, on its own device."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    return copy.deepcopy(x)


def _write(path: str, obj) -> str:
    """``torch.save`` to ``path + ".tmp"``, then move it onto ``path``."""
    tmp = path + ".tmp"
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _lightning(model_sd, opt_sd, sched_sd, step: int, hparams: Optional[dict]) -> dict:
    ckpt = to_lightning(_cpu(model_sd), hparams)
    ckpt["global_step"] = int(step)
    if opt_sd is not None:
        ckpt["optimizer_states"] = [_cpu(opt_sd)]
    if sched_sd is not None:
        ckpt["lr_schedulers"] = [sched_sd]
    return ckpt


def save_checkpoint(path: str, model: torch.nn.Module, opt=None, sched=None, step: int = 0,
                    hparams: Optional[dict] = None) -> str:
    return _write(path, _lightning(model.state_dict(), opt and opt.state_dict(),
                                   sched and sched.state_dict(), step, hparams))


class AsyncSaver:
    """The train loop's periodic save, written in the background.

    ``save`` snapshots the model's, the optimizer's and the schedule's state
    on the caller's thread, by copies on their device, before it returns:
    ``opt.step()`` updates the parameters and Adam's moments in place, so a
    snapshot by reference would be written half old, half new. On the card
    a CUDA event recorded after the copies lets the writer wait for them
    and nothing else. A non-daemon thread then moves the copies to the host
    on a CUDA stream of its own (behind no later train step) and writes
    them through ``_write``: an interpreter exit lets it finish, and a
    write cut off midway leaves the previous file whole. Saves
    serialize: a ``save`` first joins the one before. A writer's error is
    raised on the next ``save`` or ``wait``; the loop calls ``wait`` in a
    ``finally``.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, model: torch.nn.Module, opt=None, sched=None, step: int = 0,
             hparams: Optional[dict] = None) -> None:
        self.wait()
        snap = (_clone(model.state_dict()), opt and _clone(opt.state_dict()),
                sched and copy.deepcopy(sched.state_dict()))
        done = None
        if any(t.is_cuda for t in snap[0].values()):
            done = torch.cuda.Event()
            done.record()

        def run():
            try:
                if done is None:
                    ckpt = _lightning(*snap, step, hparams)
                else:  # the copies to the host on a stream of their own, which
                    done.synchronize()  # waits for no later train step
                    with torch.cuda.stream(torch.cuda.Stream()):
                        ckpt = _lightning(*snap, step, hparams)
                _write(path, ckpt)
            except BaseException as exc:  # raised again on the loop's thread
                self._error = exc

        self._thread = threading.Thread(target=run, name="checkpoint-writer", daemon=False)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def load_model_state(path: str, model: torch.nn.Module) -> None:
    """The checkpoint's weights and BatchNorm statistics into ``model``."""
    load_strict(model, load_tacotron2_checkpoint(path)[0])


def load_train_state(path: str, opt, sched) -> int:
    """Restore the optimizer and schedule in place; -> the saved step, or 0
    for a checkpoint without optimizer state (weights only). The schedule
    keeps the milestones it was built with (the JAX driver derives them from
    the current config's ``max_steps`` too). An Orbax directory's optimizer
    state goes through ``convert.lightning_from_orbax``: one that is not the
    plain chain's gets JAX's warning, and the run goes on from step 0 with
    the weights alone, as JAX's does."""
    ckpt = (lightning_from_orbax(path) if os.path.isdir(path)
            else torch.load(path, map_location="cpu", weights_only=False))
    if not ckpt.get("optimizer_states"):
        return 0
    opt.load_state_dict(ckpt["optimizer_states"][0])
    if ckpt.get("lr_schedulers"):
        milestones = sched.milestones
        sched.load_state_dict(ckpt["lr_schedulers"][0])
        sched.milestones = milestones
    return int(ckpt["global_step"])


def save_prosody_checkpoint(path: str, predictor: torch.nn.Module, hparams: dict,
                            source_config: Optional[dict] = None) -> str:
    """``train_prosody``'s checkpoint: the predictor's ``state_dict`` and
    ``hyper_parameters`` = {"prosody_predictor": the constructor's arguments
    and the feature names, "source_config": the raw config} (JAX
    ``run/train_prosody.py``'s ``config.json``)."""
    return _write(path, {"state_dict": _cpu(predictor.state_dict()),
                         "hyper_parameters": {"prosody_predictor": dict(hparams),
                                              "source_config": source_config}})


def prosody_from_orbax(ckpt_dir: str) -> dict:
    """JAX ``train_prosody``'s Orbax directory -> ``save_prosody_checkpoint``'s
    layout: ``prosody_from_jax_params`` of ``model/``'s params, the
    hyperparameters of its ``config.json``."""
    from tacotron2_tpu_torch.training import orbax

    params, _, saved = orbax.load_model(ckpt_dir)
    return {"state_dict": prosody_from_jax_params(params),
            "hyper_parameters": {"prosody_predictor": dict(saved["prosody_predictor"]),
                                 "source_config": saved.get("source_config")}}


def load_prosody_checkpoint(path: str):
    """-> a frozen ``ProsodyPredictor`` from ``save_prosody_checkpoint``'s
    file or JAX ``train_prosody``'s Orbax directory (JAX
    ``run/common.py::load_prosody_checkpoint``): f32, no parameter
    requiring a gradient."""
    from tacotron2_tpu_torch.models.prosody import ProsodyPredictor

    ckpt = (prosody_from_orbax(path) if os.path.isdir(path)
            else torch.load(path, map_location="cpu", weights_only=False))
    h = dict(ckpt["hyper_parameters"]["prosody_predictor"])
    h.pop("features", None)
    predictor = ProsodyPredictor(**h)
    load_strict(predictor, ckpt["state_dict"])
    return predictor.requires_grad_(False)


def convert_orbax(ckpt_dir: str, out: str) -> dict:
    """``python -m tacotron2_tpu_torch convert``: a JAX ``train`` checkpoint
    directory -> the port's Lightning ``.ckpt`` (model, optimizer state,
    schedule, step), a ``train_prosody`` one -> ``save_prosody_checkpoint``'s
    layout. -> what was written."""
    from tacotron2_tpu_torch.training import orbax

    if "prosody_predictor" in orbax.read_config(ckpt_dir):
        _write(out, prosody_from_orbax(ckpt_dir))
        kind = "prosody"
        step = None
    else:
        ckpt = lightning_from_orbax(ckpt_dir)
        _write(out, ckpt)
        kind = "tacotron2" + ("" if ckpt.get("optimizer_states") else " (weights only)")
        step = ckpt.get("global_step")
    print(f"converted {ckpt_dir} -> {out} ({kind}{f', step {step}' if step is not None else ''})")
    return {"out": out, "kind": kind, "step": step}
