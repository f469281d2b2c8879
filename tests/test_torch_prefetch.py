"""The port's train input staging (``tacotron2_tpu_torch/parallel/prefetch.py``)
on the CPU, the cases of ``tests/test_prefetch.py``: order and epoch
chaining, the join on an early break, the loader's error, an empty loader,
the staging policy, the bounded close and the late error; the
staged batch against ``to_device`` of the selected rows (the train loop's
rank shard); and ``train`` with the prefetcher against inline."""

import threading
import time

import numpy as np
import pytest
import torch

from tacotron2_tpu_torch.parallel.mesh import shard_rows
from tacotron2_tpu_torch.parallel.prefetch import DevicePrefetcher, DirectStream, use_device_prefetch

torch.set_num_threads(1)


class ListLoader:
    """Epoch-iterable as ``TTSDataLoader``: its batches each epoch."""

    def __init__(self, batches):
        self.batches = batches
        self.epochs = 0

    def __iter__(self):
        self.epochs += 1
        yield from self.batches


def _batches(n, batch=4):
    out = []
    for i in range(n):
        out.append({
            "chars_idx": np.full((batch, 5), i + 1, np.int64),
            "chars_len": np.full((batch,), 5, np.int64),
            "mel": np.full((batch, 8, 3), float(i), np.float32),
            "mel_len": np.full((batch,), i + 1, np.int64),
            "gate": np.ones((batch, 8, 1), np.float32),
            "speaker_id": np.arange(batch),
            "meta": f"batch-{i}",  # not staged: only the step's fields are
        })
    return out


def _alive_prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "device-prefetch" and t.is_alive()]


STREAMS = [lambda loader, **kw: DevicePrefetcher(loader, "cpu", depth=2, **kw),
           lambda loader, **kw: DirectStream(loader, "cpu", **kw)]


@pytest.mark.parametrize("make_stream", STREAMS, ids=["prefetcher", "direct"])
def test_prefetch_order_content_and_epoch_chaining(make_stream):
    loader = ListLoader(_batches(3))
    pf = make_stream(loader, select=lambda b: shard_rows(b, 1, 2))
    got = []
    for device_batch, host_batch in pf:
        assert set(device_batch) == {"chars_idx", "chars_len", "mel", "mel_len", "gate",
                                     "speaker_id"}
        for k, v in device_batch.items():  # rank 1's rows of the host batch
            np.testing.assert_array_equal(v.numpy(), host_batch[k][2:])
        got.append(host_batch["meta"])
        if len(got) == 7:  # two whole epochs and one batch: the epochs chain
            break
    pf.close()
    assert got == [f"batch-{i % 3}" for i in range(7)]
    assert loader.epochs >= 3
    assert not _alive_prefetch_threads()


def test_prefetch_early_break_joins_thread():
    pf = DevicePrefetcher(ListLoader(_batches(8)), "cpu", depth=2)
    for _ in pf:
        break  # the consumer leaves at once; the generator's finally closes
    deadline = time.time() + 5
    while _alive_prefetch_threads() and time.time() < deadline:
        time.sleep(0.02)
    assert not _alive_prefetch_threads()


def test_prefetch_propagates_loader_error():
    class BoomLoader:
        def __iter__(self):
            yield _batches(1)[0]
            raise ValueError("decode failed")

    pf = DevicePrefetcher(BoomLoader(), "cpu", depth=2)
    it = iter(pf)
    next(it)
    with pytest.raises(ValueError, match="decode failed"):
        for _ in range(4):  # the error may come after the queue drains
            next(it)
    pf.close()


@pytest.mark.parametrize("make_stream", STREAMS, ids=["prefetcher", "direct"])
def test_prefetch_empty_loader_raises(make_stream):
    pf = make_stream(ListLoader([]))
    with pytest.raises(RuntimeError, match="no batches"):
        next(iter(pf))
    pf.close()


def test_staging_policy_core_count_adaptive(monkeypatch):
    """The port has no core-count rule (JAX's prefetches at 4 cores and
    more): the staging thread's loader work slows the launch-bound step
    thread on the card's 8-core host (PERF.md, PR 16), so ``train`` stages
    inline unless ``TACOTRON2_DEVICE_PREFETCH`` asks for the prefetcher."""
    assert use_device_prefetch(env=None) is False
    assert use_device_prefetch(env="") is False
    assert use_device_prefetch(env="1") is True
    assert use_device_prefetch(env="on") is True
    assert use_device_prefetch(env="0") is False
    assert use_device_prefetch(env="off") is False
    monkeypatch.delenv("TACOTRON2_DEVICE_PREFETCH", raising=False)
    assert use_device_prefetch() is False
    monkeypatch.setenv("TACOTRON2_DEVICE_PREFETCH", "true")
    assert use_device_prefetch() is True


def test_prefetch_close_join_is_bounded():
    """``close()`` does not wait forever for a thread stuck in the loader:
    after the bounded join it leaves the daemon thread behind."""
    release = threading.Event()

    class StuckLoader:
        def __iter__(self):
            yield _batches(1)[0]
            release.wait(30)  # a stuck read

    pf = DevicePrefetcher(StuckLoader(), "cpu", depth=1)
    it = iter(pf)
    next(it)
    t0 = time.time()
    pf.close(join_timeout=0.3)
    assert time.time() - t0 < 5.0
    release.set()


def test_prefetch_late_error_recorded_not_dropped():
    """An error raised after the consumer stopped is kept and raised by
    ``close()``."""
    entered = threading.Event()

    class LateBoomLoader:
        def __iter__(self):
            yield _batches(1)[0]
            entered.set()
            time.sleep(0.2)  # the consumer stops first
            raise ValueError("late transfer failure")

    pf = DevicePrefetcher(LateBoomLoader(), "cpu", depth=1)
    it = iter(pf)
    next(it)
    entered.wait(5)
    pf._stop.set()  # the consumer has gone: the error tuple finds no taker
    deadline = time.time() + 5
    while pf.error is None and time.time() < deadline:
        time.sleep(0.02)
    with pytest.raises(ValueError, match="late transfer failure"):
        pf.close()


def test_train_prefetched_matches_inline(tmp_path, monkeypatch):
    """``train`` on the CPU stages inline by default and through the
    prefetcher with ``TACOTRON2_DEVICE_PREFETCH=1``: the same losses bit
    for bit."""
    from tacotron2_tpu_torch.__main__ import main as cli
    from tests.test_torch_train_cli import _corpus

    speech, _, cfg = _corpus(tmp_path)
    argv = ["train", "--config", cfg, "--speech-dir", str(speech), "--device", "cpu"]
    monkeypatch.delenv("TACOTRON2_DEVICE_PREFETCH", raising=False)
    inline = cli(argv + ["--results-dir", str(tmp_path / "inline")])
    monkeypatch.setenv("TACOTRON2_DEVICE_PREFETCH", "1")
    staged = cli(argv + ["--results-dir", str(tmp_path / "staged")])
    assert (inline["prefetch"], staged["prefetch"]) == (False, True)
    assert len(inline["steps"]) == 3
    assert [s["loss"] for s in staged["steps"]] == [s["loss"] for s in inline["steps"]]
