"""Tracing and per-phase wall time.

Counterpart of ``tacotron2_tpu/utils/profiling.py``: ``PhaseTimer`` as
there, and ``device_trace``, which records a ``torch.profiler`` trace of
host and CUDA activity (the JAX package's ``jax.profiler`` trace) and
writes it as a Chrome trace (``trace_<pid>.json``) into ``log_dir``.
``train`` wraps its loop in it when ``TACOTRON2_TRACE_DIR`` is set.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


class PhaseTimer:
    """Accumulates wall time per named phase; cheap enough to leave on."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1


def trace_path(log_dir: str) -> str:
    return os.path.join(log_dir, f"trace_{os.getpid()}.json")


@contextlib.contextmanager
def device_trace(log_dir: Optional[str], cuda: bool = True) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block's host activity, and with
    ``cuda`` of the card's, written to ``trace_path(log_dir)`` on exit.
    No-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(trace_path(log_dir))
