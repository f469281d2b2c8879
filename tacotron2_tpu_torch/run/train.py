"""``train``: the port's training driver.

Counterpart of ``run/train.py::do_train`` of the JAX package for the
vanilla configuration, its speaker tokens, controls, description
embeddings and GST (the style of each batch's ground-truth mel, the GST's
BatchNorm statistics updated by every train step), and the prosody-model
configs: pipe-separated manifests (with
``force_speaker`` their rows of that speaker only) -> datasets with the
manifests' ``speaker_id`` column, the config's
``extensions.controls.features`` columns and the description embeddings
that ``select_descriptions`` picks, and loaders (chars bucketed to 32, frames to 128) -> a new model
from ``--seed`` or the weights of ``--resume-ckpt`` -> Adam + MultiStepLR
(milestones at the config's fractions of ``max_steps``), restored with the
step on resume -> the loop, logging every ``LOG_EVERY`` steps with the
real-frame throughput and parameter histograms every ``HISTOGRAM_EVERY``
-> validation every ``val_check_interval`` (Lightning's meaning; once an
epoch by default) and at the end, with the first batch's images ->
``final.ckpt`` (and ``last.ckpt`` every ``SAVE_EVERY`` steps, written in
the background by ``AsyncSaver``), in the reference's Lightning layout.
Logs go to ``<results>/lightning_logs/<name>/`` (``training/logging.py``).

Finetuning (``finetune``, JAX :136-143, :194-214, :395): the weights of
``resume_ckpt`` with a fresh optimizer and schedule from step 0;
``max_steps += finetune_steps``, lr / 10, batch x 2, validation once an
epoch; the encoder (the character embedding inside it) and the speaker
embedding frozen (``FINETUNE_FROZEN``; their BatchNorm statistics still
update, as JAX's model state does; a GST trains, as in JAX); ``finetuned.ckpt`` at the end.

The prosody-model configs (``extensions.prosody_model.active``, JAX
:234-251): the frozen predictor of ``prosody_model_checkpoint`` (a
``train_prosody`` checkpoint) adds ``style_loss`` to the loss from step
``int(max_steps * active_after)`` on.

With ``TACOTRON2_TRACE_DIR`` set the loop runs under ``device_trace``
(``utils/profiling.py``), as JAX's does.

Data parallel (JAX :209-227, one sharded step on the global batch): under
torchrun (``WORLD_SIZE`` in the environment; NCCL on the card, gloo on the
CPU), or in a process group the caller initialized,
every rank runs the same seeded loader over the global batch and trains on
its rows (``parallel/mesh.py``: global BatchNorm statistics, CCC moments
and dropout masks, gradients all-reduced), rank 0's weights broadcast at
start; ranks beyond the degree that divides the batch leave. Only rank 0
logs, validates (then its dropout generator's state and the early-stop
decision go to every rank) and saves; the others wait. The finetune, the
style-loss phase and GST run the same way. The batches reach the device
through ``parallel/prefetch.py``'s ``DirectStream``, or its
``DevicePrefetcher`` (a staging thread, a CUDA stream of its own) with
``TACOTRON2_DEVICE_PREFETCH=1``, each rank staging its rows only.
"""

from __future__ import annotations

import csv
import datetime
import os
import time
from os import path
from typing import List, Optional

import torch
import torch.distributed as dist

from tacotron2_tpu_torch.config import Config
from tacotron2_tpu_torch.data.loader import TTSDataLoader
from tacotron2_tpu_torch.data.manifest import manifest_dataset, read_manifest, select_rows
from tacotron2_tpu_torch.models.layers import Policy, resolve_device, use_f32_math
from tacotron2_tpu_torch.models.tacotron2 import UNEQUAL_TRAIN, Tacotron2
from tacotron2_tpu_torch.parallel import mesh
from tacotron2_tpu_torch.parallel.prefetch import DevicePrefetcher, DirectStream, use_device_prefetch
from tacotron2_tpu_torch.run.say import _sync, model_config_from
from tacotron2_tpu_torch.training import checkpoint as ckpt_lib
from tacotron2_tpu_torch.training.logging import TrainLogger
from tacotron2_tpu_torch.training.optimizer import make_optimizer, trainable
from tacotron2_tpu_torch.training.step import eval_step, to_device, train_step
from tacotron2_tpu_torch.utils.profiling import PhaseTimer, device_trace

VAL_BATCH = 64
LOG_EVERY = 50
SAVE_EVERY = 5000
HISTOGRAM_EVERY = 1000
FINETUNE_FROZEN = ("encoder.", "speaker_embedding.")


def check_trainable(cfg: Config, prosody_model_checkpoint: Optional[str] = None) -> None:
    """Raise for a config the port cannot train: the prosody model's style
    loss needs its predictor's checkpoint; a model whose two decoder LSTMs
    differ in width has no train step, in the JAX package either
    (``Tacotron2.forward_teacher``)."""
    if cfg.extensions.prosody_model.active and prosody_model_checkpoint is None:
        raise ValueError("Prosody model extension is active, but no prosody model checkpoint "
                         "was given!")
    if cfg.model.att_rnn_dim != cfg.model.rnn_hidden_dim:
        raise ValueError(UNEQUAL_TRAIN.format(cfg.model.att_rnn_dim, cfg.model.rnn_hidden_dim))


def _augmented_ids(speech_dir: str) -> set:
    """The first column of ``<speech_dir>/augmented_ids.csv`` (no header)."""
    with open(path.join(speech_dir, "augmented_ids.csv"), newline="") as f:
        return {r[0] for r in csv.reader(f) if r}


def select_descriptions(cfg: Config, train_rows: List[dict], val_rows: List[dict],
                        speech_dir: str, finetune: bool) -> tuple:
    """JAX :111-129 -> (train rows, their description paths, the val rows'
    paths, augment). A finetuneable config's finetune keeps the train rows
    whose ``id`` is in ``augmented_ids.csv`` and picks among their
    augmentations; its pretraining reads blank embeddings (zeros); else the
    manifests' ``description_embedding`` column (an empty field: zeros).
    Paths are None without ``extensions.descriptions.bert_embeddings``."""
    d = cfg.extensions.descriptions
    augment = d.finetuneable and finetune
    if augment:
        ids = _augmented_ids(speech_dir)
        train_rows = [r for r in train_rows if r["id"] in ids]
    if not d.bert_embeddings:
        return train_rows, None, None, augment

    def column(rows):
        if rows and "description_embedding" not in rows[0]:
            raise ValueError("the manifest has no description_embedding column: make it with "
                             "python -m tacotron2_tpu_torch embed_descriptions")
        return [r["description_embedding"] or None for r in rows]

    if not d.finetuneable or finetune:
        return train_rows, column(train_rows), column(val_rows), augment
    return train_rows, [None] * len(train_rows), [None] * len(val_rows), augment


def do_train(cfg: Config, raw_config: dict, speech_dir: str, results_dir: Optional[str] = None,
             resume_ckpt: Optional[str] = None, seed: int = 0,
             max_steps_override: Optional[int] = None, device: Optional[str] = None,
             finetune: bool = False, finetune_steps: Optional[int] = None,
             prosody_model_checkpoint: Optional[str] = None) -> dict:
    """Train; returns the final checkpoint's path, the step reached, a
    record per train step (loss, ``style_loss`` in the style phase, the
    global batch's rows, decode frames T and real mel frames, host seconds
    of the step ending in a device sync, host seconds waiting for the
    batch) and per validation batch (T), the host seconds of the loop's
    validations, histograms and saves (``phases``), this process's rank
    and the ranks' count (1 without a process group) and whether the
    batches were prefetched."""
    check_trainable(cfg, prosody_model_checkpoint)
    if finetune and finetune_steps is None:
        raise ValueError("If finetuning, --finetune-steps is required!")
    if finetune and resume_ckpt is None:
        raise ValueError("If finetuning, --resume-ckpt is required!")
    dev = resolve_device(device)
    if dev.type == "cuda":
        use_f32_math()
    own_group = not dist.is_initialized() and "WORLD_SIZE" in os.environ
    if own_group:  # torchrun's environment
        _, _, local_rank = mesh.init_data_parallel("nccl" if dev.type == "cuda" else "gloo")
        if dev.type == "cuda":
            torch.cuda.set_device(local_rank % torch.cuda.device_count())
    try:
        return _train(cfg, raw_config, speech_dir, results_dir, resume_ckpt, seed,
                      max_steps_override, dev, finetune, finetune_steps, prosody_model_checkpoint)
    finally:
        if own_group:
            dist.destroy_process_group()


def _train(cfg, raw_config, speech_dir, results_dir, resume_ckpt, seed, max_steps_override,
           dev, finetune, finetune_steps, prosody_model_checkpoint) -> dict:
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if results_dir is None:
        results_dir = f"results_{cfg.training.name} {datetime.datetime.now()}"
    cache_dir = path.join(results_dir, "mel_cache")
    lr, batch_size = cfg.training.lr, cfg.training.batch_size
    max_steps = max_steps_override or cfg.training.max_steps
    interval = cfg.training.val_check_interval
    if finetune:
        max_steps += finetune_steps
        lr /= 10
        interval = 1.0
        batch_size *= 2
    dp = mesh.make_data_parallel(batch_size) if dist.is_initialized() else None
    if dist.is_initialized() and dp is None:
        print(f"rank {dist.get_rank()}: no rows of a batch of {batch_size}; leaving")
        return {"checkpoint": None, "step": 0, "steps": [], "rank": dist.get_rank(), "ranks": 0}
    lead = dp is None or dp.lead
    say = print if lead else (lambda *a, **k: None)
    if lead:
        os.makedirs(results_dir, exist_ok=True)
    val_rows = select_rows(cfg, read_manifest(cfg.dataset.val))
    train_rows, desc_train, desc_val, augment = select_descriptions(
        cfg, select_rows(cfg, read_manifest(cfg.dataset.train)), val_rows, speech_dir, finetune)
    train_set = manifest_dataset(cfg, train_rows, speech_dir, cache_dir=cache_dir,
                                 descriptions=desc_train, description_augment=augment, seed=seed)
    val_set = manifest_dataset(cfg, val_rows, speech_dir, cache_dir=cache_dir,
                               descriptions=desc_val)
    train_loader = TTSDataLoader(train_set, batch_size=batch_size, shuffle=True, drop_last=True,
                                 seed=seed, bucket_chars=32, bucket_frames=128)
    val_loader = TTSDataLoader(val_set, batch_size=VAL_BATCH, shuffle=False, drop_last=False,
                               bucket_chars=32, bucket_frames=128)

    milestones = [int(x * max_steps) for x in cfg.model.scheduler_milestones]
    torch.manual_seed(seed)
    model = Tacotron2(model_config_from(cfg), Policy.from_string(cfg.training.precision))
    if resume_ckpt is not None:
        ckpt_lib.load_model_state(resume_ckpt, model)
    model.to(dev)
    if dp is not None:  # every rank starts from rank 0's weights
        mesh.broadcast_state(model, dp)
    opt, sched = make_optimizer(trainable(model, FINETUNE_FROZEN if finetune else ()), lr,
                                cfg.training.weight_decay, milestones)
    # finetuning starts a fresh optimizer and schedule at step 0 (JAX's
    # TrainState.create; it does not call load_train then)
    step = 0 if resume_ckpt is None or finetune else ckpt_lib.load_train_state(
        resume_ckpt, opt, sched)
    style, style_after = None, None
    if cfg.extensions.prosody_model.active:
        style = (ckpt_lib.load_prosody_checkpoint(prosody_model_checkpoint).to(dev),
                 cfg.extensions.prosody_model.loss or "mse")
        style_after = int(max_steps * cfg.extensions.prosody_model.active_after)
        say(f"prosody model: style loss activates at step {style_after}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1 + step)  # dropout bits; a resumed run draws new ones
    logger = TrainLogger(path.join(results_dir, "lightning_logs"), cfg.training.name) if lead \
        else None

    steps_per_epoch = max(1, len(train_loader))
    if interval is None:
        val_every = steps_per_epoch
    elif isinstance(interval, float):
        val_every = max(1, int(steps_per_epoch * interval))
    else:
        val_every = int(interval)
    record: dict = {"steps": [], "val_decode_frames": []}
    timer = PhaseTimer()

    def run_validation(at: int) -> Optional[float]:
        """Rank 0 validates; with data parallel its dropout generator's
        state (which the validation advanced) and the loss then reach every
        rank, so the ranks' generators stay the one-process one."""
        val_loss = _validate(at) if lead else None
        if dp is not None:
            val_loss, state = mesh.broadcast_object((val_loss, gen.get_state()), dp)
            gen.set_state(state)
        return val_loss

    def _validate(at: int) -> Optional[float]:
        losses, firsts, lens = [], None, None
        for batch in val_loader:
            metrics, f = eval_step(model, to_device(batch, dev), gen)
            losses.append(metrics["loss"])
            if firsts is None:
                firsts = f
                lens = (int(batch["mel_len"][0]), int(batch["chars_len"][0]))
            record["val_decode_frames"].append(int(batch["mel"].shape[1]))
        if not losses:
            return None
        mean = float(torch.stack(losses).mean())
        logger.scalars({"val_loss": mean, "val_mel_loss": mean}, at)
        logger.validation_images({k: v.float().cpu().numpy() for k, v in firsts.items()}, *lens,
                                 at)
        return mean

    prefetch = use_device_prefetch()
    say(f"train: {len(train_set)} utts, {steps_per_epoch} steps/epoch, max_steps {max_steps}, "
        f"batch {batch_size}, lr {lr}, start step {step}, {dev}"
        + (f", {dp.n} data-parallel ranks of {batch_size // dp.n} rows" if dp else "")
        + (", batches prefetched" if prefetch else "")
        + (f", finetuning with {FINETUNE_FROZEN} frozen" if finetune else ""))
    t_log, frames_log = time.perf_counter(), 0
    stop_threshold = cfg.training.stopping_val_loss_threshold
    saver = ckpt_lib.AsyncSaver()
    select = (lambda b: mesh.shard_rows(b, dp.rank, dp.n)) if dp is not None else (lambda b: b)
    stream = (DevicePrefetcher(train_loader, dev, 2, select) if prefetch
              else DirectStream(train_loader, dev, select))
    batches = iter(stream)
    with device_trace(os.environ.get("TACOTRON2_TRACE_DIR") if lead else None,
                      dev.type == "cuda"):
        try:
            while step < max_steps:
                t_wait = time.perf_counter()
                device_batch, batch = next(batches)
                t0 = time.perf_counter()
                metrics = train_step(
                    model, opt, sched, device_batch, gen,
                    style=style if style_after is not None and step >= style_after else None,
                    dp=dp)
                _sync(dev)
                frames = int(batch["mel_len"].sum())
                step += 1
                rec = {"step": step, "loss": float(metrics["loss"]),
                       "rows": int(batch["mel"].shape[0]),
                       "decode_frames": int(batch["mel"].shape[1]), "mel_frames": frames,
                       "s": time.perf_counter() - t0, "wait_s": t0 - t_wait}
                if "style_loss" in metrics:
                    rec["style_loss"] = float(metrics["style_loss"])
                record["steps"].append(rec)
                frames_log += frames
                if lead and (step % LOG_EVERY == 0 or step == 1):
                    names = sorted(metrics)
                    vals = torch.stack([metrics[k].float() for k in names]).tolist()
                    m = {f"training_{k}": v for k, v in zip(names, vals)}
                    m["lr"] = sched.get_last_lr()[0]
                    m["mel_frames_per_sec"] = frames_log / max(time.perf_counter() - t_log, 1e-9)
                    t_log, frames_log = time.perf_counter(), 0
                    logger.scalars(m, step)
                    print(f"step {step}: loss {m['training_loss']:.4f} "
                          f"({m['mel_frames_per_sec']:.0f} frames/s)")
                if lead and step % HISTOGRAM_EVERY == 0:
                    with timer.phase("histograms"):
                        logger.histograms(model.named_parameters(), step)
                if step % val_every == 0:
                    with timer.phase("validation"):
                        val_loss = run_validation(step)
                    if (stop_threshold is not None and val_loss is not None
                            and val_loss <= stop_threshold):
                        say(f"early stop: val_loss {val_loss:.4f} <= {stop_threshold}")
                        break
                if lead and step % SAVE_EVERY == 0:
                    with timer.phase("save"):
                        saver.save(path.join(results_dir, "last.ckpt"), model, opt, sched, step,
                                   raw_config)
        finally:
            batches.close()
            stream.close()
            saver.wait()
    run_validation(step)
    out = path.join(results_dir, "finetuned.ckpt" if finetune else "final.ckpt")
    if lead:
        ckpt_lib.save_checkpoint(out, model, opt, sched, step, raw_config)
        logger.close()
        print(f"saved {out}")
    if dp is not None:  # the others wait for the file
        dist.barrier(group=dp.group)
    record["phases"] = {k: {"s": timer.totals[k], "n": timer.counts[k]} for k in timer.totals}
    return {"checkpoint": out, "step": step, "rank": dp.rank if dp else 0,
            "ranks": dp.n if dp else 1, "prefetch": prefetch, **record}
