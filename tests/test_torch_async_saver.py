"""The background save of the train loop (``training/checkpoint.py``:
``AsyncSaver``, the atomic ``_write``) on the CPU:

- the snapshot is taken when ``save`` returns: parameters, Adam's moments
  and the schedule changed in place while the write is held back do not
  reach the file;
- the writer is a non-daemon thread, and a later ``save`` joins it first;
- a write cut off midway (``torch.save`` raising after half the bytes)
  leaves the previous ``last.ckpt`` whole and no temporary file;
- the writer's error is raised on the next ``save`` or ``wait``, once;
- ``train`` raises a failed background save, and its ``last.ckpt``, saved
  after the last step, equals ``final.ckpt`` tensor for tensor.
"""

import threading

import pytest
import torch

from tacotron2_tpu_torch.__main__ import main as cli
from tacotron2_tpu_torch.run import train as train_mod
from tacotron2_tpu_torch.training import checkpoint as ckpt_lib
from tacotron2_tpu_torch.training.optimizer import make_optimizer
from tests.test_torch_train_cli import _corpus

torch.set_num_threads(1)


def _trained():
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.BatchNorm1d(3))
    opt, sched = make_optimizer(model.parameters(), 1e-2, 1e-6, [1])
    _step(model, opt, sched)
    return model, opt, sched


def _step(model, opt, sched):
    opt.zero_grad()
    model(torch.randn(8, 4)).square().sum().backward()
    opt.step()
    sched.step()


def _tensors(ckpt: dict) -> dict:
    out = {f"sd.{k}": v for k, v in ckpt["state_dict"].items()}
    for i, s in ckpt["optimizer_states"][0]["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in s.items()})
    return out


def _assert_same(a: dict, b: dict) -> None:
    ta, tb = _tensors(a), _tensors(b)
    assert set(ta) == set(tb)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert a["lr_schedulers"] == b["lr_schedulers"] and a["global_step"] == b["global_step"]


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=False)


def test_snapshot_survives_in_place_updates(tmp_path, monkeypatch):
    model, opt, sched = _trained()
    want = ckpt_lib._lightning(model.state_dict(), opt.state_dict(), sched.state_dict(), 1,
                               {"a": 1})
    want = {**want, "state_dict": {k: v.clone() for k, v in want["state_dict"].items()},
            "optimizer_states": [{**want["optimizer_states"][0], "state": {
                i: {k: v.clone() for k, v in s.items()}
                for i, s in want["optimizer_states"][0]["state"].items()}}]}
    release, holding = threading.Event(), threading.Event()
    write = ckpt_lib._write

    def held(path, obj):
        holding.set()
        assert release.wait(30)
        return write(path, obj)

    monkeypatch.setattr(ckpt_lib, "_write", held)
    saver = ckpt_lib.AsyncSaver()
    path = str(tmp_path / "last.ckpt")
    saver.save(path, model, opt, sched, 1, {"a": 1})
    assert holding.wait(30)
    assert saver._thread.daemon is False
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    for _ in range(2):  # Adam's moments, its step and the schedule move on
        _step(model, opt, sched)
    release.set()
    saver.wait()
    _assert_same(_load(path), want)
    assert not torch.equal(_load(path)["state_dict"]["tacotron2.0.weight"], model[0].weight)


def test_cut_off_write_keeps_the_previous_file(tmp_path, monkeypatch):
    model, opt, sched = _trained()
    path = str(tmp_path / "last.ckpt")
    saver = ckpt_lib.AsyncSaver()
    saver.save(path, model, opt, sched, 1)
    saver.wait()
    first = _load(path)
    _step(model, opt, sched)
    save = torch.save

    def cut_off(obj, f):
        save(obj, f)
        with open(f, "r+b") as fh:  # half the bytes, then the writer dies
            fh.truncate(fh.seek(0, 2) // 2)
        raise OSError("disk gone")

    monkeypatch.setattr(torch, "save", cut_off)
    saver.save(path, model, opt, sched, 2)
    with pytest.raises(OSError, match="disk gone"):
        saver.wait()
    saver.wait()  # raised once
    _assert_same(_load(path), first)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["last.ckpt"]


def test_error_is_raised_on_the_next_save(tmp_path, monkeypatch):
    model, opt, sched = _trained()
    path = str(tmp_path / "last.ckpt")
    monkeypatch.setattr(ckpt_lib, "_write", lambda p, obj: (_ for _ in ()).throw(
        RuntimeError("write failed")))
    saver = ckpt_lib.AsyncSaver()
    saver.save(path, model, opt, sched, 1)
    with pytest.raises(RuntimeError, match="write failed"):
        saver.save(path, model, opt, sched, 2)
    monkeypatch.undo()
    saver.save(path, model, opt, sched, 3)
    saver.wait()
    assert _load(path)["global_step"] == 3


def test_train_raises_a_failed_background_save(tmp_path, monkeypatch):
    speech, _, cfg = _corpus(tmp_path)
    monkeypatch.setattr(train_mod, "SAVE_EVERY", 1)
    write = ckpt_lib._write

    def fail_last(path, obj):
        if path.endswith("last.ckpt"):
            raise OSError("no room for last.ckpt")
        return write(path, obj)

    monkeypatch.setattr(ckpt_lib, "_write", fail_last)
    with pytest.raises(OSError, match="no room"):
        cli(["train", "--config", cfg, "--speech-dir", str(speech), "--device", "cpu",
             "--results-dir", str(tmp_path / "r"), "--max-steps", "2"])
    assert not (tmp_path / "r" / "final.ckpt").exists()


def test_last_save_equals_final_checkpoint(tmp_path, monkeypatch):
    speech, _, cfg = _corpus(tmp_path)
    monkeypatch.setattr(train_mod, "SAVE_EVERY", 2)
    out = cli(["train", "--config", cfg, "--speech-dir", str(speech), "--device", "cpu",
               "--results-dir", str(tmp_path / "r"), "--max-steps", "4"])
    last, final = _load(tmp_path / "r" / "last.ckpt"), _load(out["checkpoint"])
    assert final["global_step"] == 4
    _assert_same(last, final)
    assert last["hyper_parameters"] == final["hyper_parameters"]
