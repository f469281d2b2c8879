"""Training input staging: an endless ``(device_batch, host_batch)`` stream.

Counterpart of ``tacotron2_tpu/parallel/prefetch.py``:

- ``DirectStream``: each batch moved to the device on the loop's thread
  when the loop asks for it;
- ``DevicePrefetcher``: a background thread takes the next ``depth``
  batches from the loader, stages their arrays in pinned host memory and
  copies them to the card on a CUDA stream of its own, so the loader's
  decode and collate and the copy overlap the train steps. Each batch
  carries an event recorded after its copies; the consumer's stream waits
  on it, and ``record_stream`` keeps the allocator from reusing the
  batch's memory while the consumer's stream may still read it. On the
  CPU it stages on the thread without streams.

``use_device_prefetch`` chooses between them: ``DirectStream`` unless the
environment asks for the prefetcher. Both chain the loader's
epochs endlessly (the loader reshuffles per epoch) and raise on a loader
that gives no batch. ``select`` maps a host batch to what is staged (the
training loop passes this rank's rows, ``mesh.shard_rows``);
``host_batch`` is the loader's batch, whole. Staged are the arrays that
``training/step.py::to_device`` moves, ``speaker_id`` left on the host.
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

from tacotron2_tpu_torch.training.step import stage_keys, to_device

NO_BATCHES = "loader produced no batches (empty dataset or batch_size > len(dataset) with drop_last)"


def use_device_prefetch(env: Optional[str] = None) -> bool:
    """``TACOTRON2_DEVICE_PREFETCH`` (1 / true / yes / on) asks for the
    prefetcher; otherwise ``train`` stages inline. JAX's rule (prefetch on
    hosts of 4 cores and more) is not kept: a port step is thousands of
    launches from the host, and the staging thread's loader work slows them
    (PERF.md, PR 16)."""
    if env is None:
        env = os.environ.get("TACOTRON2_DEVICE_PREFETCH", "")
    return env.strip().lower() in ("1", "true", "yes", "on")


def _identity(batch):
    return batch


class DirectStream:
    """The stream staged inline on the caller's thread."""

    def __init__(self, loader, device, select: Callable = _identity):
        self.loader, self.device, self.select = loader, torch.device(device), select

    def __iter__(self) -> Iterator[Tuple[Dict[str, torch.Tensor], dict]]:
        while True:
            n = 0
            for batch in self.loader:
                yield to_device(self.select(batch), self.device), batch
                n += 1
            if n == 0:
                raise RuntimeError(f"DirectStream: {NO_BATCHES}")

    def close(self) -> None:  # the same interface as DevicePrefetcher
        pass


class DevicePrefetcher:
    """The stream staged ``depth`` batches ahead on a background thread.

    It never ends on its own: the consumer stops by ``break`` (the
    generator's ``finally`` closes the thread) or ``close()``. An error of
    the loader or the copy is raised on the consumer's thread at its next
    ``next()``; one raised after the consumer has gone is kept and raised
    by ``close()``."""

    def __init__(self, loader, device, depth: int = 2, select: Callable = _identity):
        if depth < 1:
            raise ValueError(f"depth must be at least 1, got {depth}")
        self.loader, self.device, self.select = loader, torch.device(device), select
        self._cuda = self.device.type == "cuda"
        self._side = torch.cuda.Stream(self.device) if self._cuda else None
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    # -- producer -----------------------------------------------------------
    def _stage(self, batch):
        host = self.select(batch)
        if not self._cuda:
            return to_device(host, self.device), batch, None
        staged = {}
        with torch.cuda.stream(self._side):
            for k in stage_keys(host):
                t = torch.as_tensor(host[k])
                staged[k] = t if k == "speaker_id" else t.pin_memory().to(self.device,
                                                                         non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._side)
        return staged, batch, done

    def _put(self, item) -> bool:
        # a bounded put that gives up once the consumer is gone (a blocking
        # put would keep this thread alive forever)
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _work(self) -> None:
        try:
            while not self._stop.is_set():
                n = 0
                for batch in self.loader:
                    if self._stop.is_set():
                        return
                    if not self._put((self._stage(batch), None)):
                        return
                    n += 1
                if n == 0:
                    raise RuntimeError(f"DevicePrefetcher: {NO_BATCHES}")
        except BaseException as e:  # raised again on the consumer's thread
            if not self._put((None, e)):
                self.error = e  # the consumer has gone: close() raises it
                print(f"DevicePrefetcher: error during shutdown: {e!r}", file=sys.stderr)

    # -- consumer -----------------------------------------------------------
    def __iter__(self) -> Iterator[Tuple[Dict[str, torch.Tensor], dict]]:
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._work, name="device-prefetch",
                                            daemon=True)
            self._thread.start()
        try:
            while True:
                item, err = self._q.get()
                if err is not None:
                    raise err
                staged, batch, done = item
                if done is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(done)
                    for t in staged.values():
                        if t.is_cuda:
                            t.record_stream(stream)
                yield staged, batch
        finally:
            self.close()

    def close(self, join_timeout: float = 5.0) -> None:
        """Stop the thread and drop the staged batches (idempotent). The
        join is bounded: a thread stuck in the loader or a copy is left
        behind (a daemon) after ``join_timeout`` seconds, with a message."""
        self._stop.set()
        t = self._thread
        if t is None:
            return
        deadline = time.monotonic() + join_timeout
        while t.is_alive():
            try:  # wake a producer blocked on a full queue
                self._q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.1)
            if t.is_alive() and time.monotonic() > deadline:
                print(f"DevicePrefetcher.close(): the staging thread is still alive after "
                      f"{join_timeout:.1f} s; leaving it behind", file=sys.stderr)
                break
        self._thread = None
        if self.error is not None:
            err, self.error = self.error, None
            raise err
