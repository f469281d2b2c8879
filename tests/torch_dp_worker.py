"""The rank processes of ``tests/test_torch_parallel.py``: spawned over gloo
with a ``file://`` store, each runs one function of this module and saves
its result with ``torch.save``. Imports no JAX (the ranks start faster)."""

from __future__ import annotations

import os
import traceback
from pathlib import Path

import torch

from tacotron2_tpu_torch.models import layers
from tacotron2_tpu_torch.models.layers import Policy
from tacotron2_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from tacotron2_tpu_torch.parallel import mesh
from tacotron2_tpu_torch.training import losses, optimizer, step

JOIN_S = 240  # each rank's join; a hung rank fails its test instead of the suite's limit


def launch(n: int, fn: str, spec: dict, tmp: Path) -> list:
    """Run ``fn(rank, n, spec)`` in ``n`` spawned ranks of one gloo group;
    -> their results in rank order. A rank that raises, dies or outlives
    ``JOIN_S`` fails the caller."""
    ctx = torch.multiprocessing.get_context("spawn")
    tmp.mkdir(parents=True, exist_ok=True)
    store = tmp / "store"
    procs = [ctx.Process(target=_entry, args=(r, n, fn, spec, str(store), str(tmp)))
             for r in range(n)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errors = [(tmp / f"rank{r}.err").read_text() for r in range(n)
              if (tmp / f"rank{r}.err").exists()]
    if errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"ranks' exit codes {[p.exitcode for p in procs]}: "
                             + "\n".join(errors))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(n)]


def _entry(rank, n, fn, spec, store, tmp):
    torch.set_num_threads(1)
    try:
        mesh.init_data_parallel("gloo", f"file://{store}", rank, n)
        out = globals()[fn](rank, n, spec)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        torch.distributed.destroy_process_group()
    except BaseException:
        Path(tmp, f"rank{rank}.err").write_text(f"rank {rank}:\n{traceback.format_exc()}")
        raise


def _dp(rank, n):
    return mesh.DataParallel(rank, n) if torch.distributed.is_initialized() else None


def train_steps(rank: int, n: int, spec: dict) -> list:
    """One train step per global batch of ``spec["batches"]`` of a model of
    ``spec["cfg"]`` (weights from ``spec["state"]``, a state-dict file, or
    ``torch.manual_seed(0)``), each on this rank's rows, the dropout generator seeded
    ``spec["gen_seed"]``, the LSTM masks ``spec["masks"][i]`` (global) if
    given, the parameters under ``spec["frozen"]`` left out of the
    optimizer. In one process without a group: the one-process steps. With
    ``spec["model_parallel"]`` m > 1 the ranks form a grid of n / m data by
    m model ranks (``mesh.make_data_parallel``), each holding its slices
    (``mesh.shard_parameters``); ``spec["defect"]`` plants one ("local_clip":
    the clip's norm over this rank's slices; "dxh": d(xh) left un-reduced
    over the model group). -> per step the metrics, every gradient (after
    the clip) and the state dict after the step, whole (gathered over the
    model group), and under tensor parallelism ``local``: this rank's own
    state dict."""
    m = spec.get("model_parallel", 1)
    if m > 1:
        dp = mesh.make_data_parallel(int(spec["batches"][0]["mel"].shape[0]), m)
        _plant(spec.get("defect"))
    else:
        dp = _dp(rank, n)
    torch.manual_seed(0)
    model = Tacotron2(Tacotron2Config(**spec["cfg"]), Policy.from_string(spec["policy"]))
    if spec.get("state"):
        model.load_state_dict(torch.load(spec["state"]))
    if dp is not None:
        mesh.broadcast_state(model, dp if m == 1 else mesh.DataParallel(rank, n))
    if m > 1:
        mesh.shard_parameters(model, dp)
    opt, sched = optimizer.make_optimizer(
        optimizer.trainable(model, spec.get("frozen", ())), spec["lr"], spec["wd"],
        spec.get("milestones", ()))
    gen = torch.Generator().manual_seed(spec["gen_seed"])
    out = []
    for i, batch in enumerate(spec["batches"]):
        rows = mesh.shard_rows(batch, dp.rank, dp.n) if dp is not None else batch
        masks = spec["masks"][i] if spec.get("masks") else None
        masks = masks and tuple(torch.as_tensor(x) for x in masks)
        metrics = step.train_step(model, opt, sched, step.to_device(rows, "cpu"), gen,
                                  lstm_masks=masks, dp=dp)
        split = getattr(model, "tp_split", {})
        out.append({"metrics": {k: float(v) for k, v in metrics.items()},
                    "grads": {k: (mesh.gather_units(p.grad, split[k], dp.model) if k in split
                                  else p.grad.clone())
                              for k, p in model.named_parameters() if p.grad is not None},
                    "state": {k: v.clone() for k, v in mesh.gather_state_dict(model, dp).items()}})
        if m > 1:
            out[-1]["local"] = {k: v.clone() for k, v in model.state_dict().items()}
    return out


def train_runs(rank: int, n: int, spec: dict) -> dict:
    """``train_steps`` once per entry (name, defect or None, steps, spec
    changes) of ``spec["runs"]`` in this rank, each with its defect planted
    and then taken out. -> {name: its result}."""
    out = {}
    for name, defect, steps, changes in spec["runs"]:
        run = {**spec, **changes, "defect": defect, "batches": spec["batches"][:steps]}
        saved = (optimizer.global_norm, _train_scan().reduce_dxh)
        try:
            out[name] = train_steps(rank, n, run)
        finally:
            optimizer.global_norm, _train_scan().reduce_dxh = saved
    return out


def _train_scan():
    from tacotron2_tpu_torch.ops import train_scan

    return train_scan


def _plant(defect) -> None:
    """A defect of the tensor-parallel step, in this rank's modules."""
    if defect == "local_clip":
        def local_norm(grads, split, mp):
            return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                         for g in grads]))
        optimizer.global_norm = local_norm
    elif defect == "dxh":
        _train_scan().reduce_dxh = lambda x, mp: x
    elif defect is not None:
        raise ValueError(defect)


def batchnorm(rank: int, n: int, spec: dict) -> dict:
    """``layers.batchnorm`` over channels-last (B, T, C) and
    ``layers.batchnorm2d`` over NCHW in train mode on this rank's rows of
    ``spec["x1"]`` / ``spec["x2"]``; each rank backpropagates its share of
    sum(y * w) (w ``spec["w1"]`` / ``spec["w2"]``), the BNs' weight and
    bias gradients summed over the ranks. -> outputs, input gradients,
    parameter gradients and running statistics."""
    dp = _dp(rank, n)
    out = {}
    for key, bn, fn in (("1", torch.nn.BatchNorm1d(spec["x1"].shape[-1]), layers.batchnorm),
                        ("2", torch.nn.BatchNorm2d(spec["x2"].shape[1]), layers.batchnorm2d)):
        torch.manual_seed(3)
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.uniform_(-0.5, 0.5)
        x = torch.as_tensor(spec["x" + key])
        w = torch.as_tensor(spec["w" + key])
        if dp is not None:
            x, w = (mesh.shard_rows({"mel": x, "w": w}, rank, n)[k] for k in ("mel", "w"))
        x = x.clone().requires_grad_()
        with mesh.active(dp):
            y = fn(x, bn, True)
        (y * w).sum().backward()
        pg = torch.cat([bn.weight.grad, bn.bias.grad])
        if dp is not None:
            torch.distributed.all_reduce(pg)
        out[key] = {"y": y.detach(), "dx": x.grad, "dparams": pg,
                    "running": torch.cat([bn.running_mean, bn.running_var])}
    return out


def ccc(rank: int, n: int, spec: dict) -> dict:
    """The CCC style loss of this rank's rows of ``spec["pred"]`` against
    ``spec["target"]``; each rank backpropagates its 1 / n share of the
    (replicated) global loss. -> the loss and the prediction's gradient."""
    dp = _dp(rank, n)
    pred, target = torch.as_tensor(spec["pred"]), torch.as_tensor(spec["target"])
    if dp is not None:
        rows = mesh.shard_rows({"mel": pred, "t": target}, rank, n)
        pred, target = rows["mel"], rows["t"]
    pred = pred.clone().requires_grad_()
    with mesh.active(dp):
        loss = losses.concordance_correlation_coefficient_loss(pred, target)
    (loss / (dp.n if dp else 1)).backward()
    return {"loss": loss.detach(), "dpred": pred.grad}


def train_cli(rank: int, n: int, spec: dict) -> dict:
    """``python -m tacotron2_tpu_torch train`` with ``spec["argv"]`` in this
    rank (the group is already joined). -> its record."""
    from tacotron2_tpu_torch.__main__ import main as cli

    return {"record": cli(spec["argv"])}

