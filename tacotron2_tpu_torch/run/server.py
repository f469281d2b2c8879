"""Demo TTS web server of the port, on the standard library alone.

Counterpart of the JAX package's ``run/server.py``, for the vanilla
configuration, its speaker tokens and controls (``multi_speaker`` and
``controllable`` entries; a request's ``voice`` and ``controls``, or the
reference page's named sliders) and GST models, which serve the neutral
style (a request carries no reference audio, as in JAX's server). Routes: ``GET /`` (the repo's ``web/index.html``),
``GET /config`` (the model registry), ``GET /stats``, ``POST /generate``
(text -> WAV path, with the reference client's alias fields) and static
``/web_generated``. The server config is the JAX server's: ``models``
(name, config, checkpoint, hifi_gan_checkpoint, quantize_int8, max_len,
multi_speaker, controllable, num_voices), ``batching`` (enabled, window_ms,
max_batch, depth) and ``warmup``.

Two modes:

- ``warm``: each model loads once, its decoder packed once (int8 when the
  entry sets ``quantize_int8``), a GST model's neutral style computed
  once from one row (every row of a window takes it: a GRU over 1 and over
  16 rows may sum in another order). A ``MicroBatcher`` gathers the requests
  for one model that arrive within ``window_ms`` (up to ``max_batch``)
  into one batched decode (kernels K1, or K5 for int8) and one batched
  HiFi-GAN call (K2), with up to ``depth`` windows in flight, each on its
  own thread and CUDA stream. Every request keeps its own prenet-dropout
  stream (a torch.Generator from its seed), voice and controls, and the
  kernels' rows are independent, so a request's audio does not depend on
  what shares its window. Rows pad to a power of two by repeating row 0
  (with generators of their own, row 0's voice and controls), chars to a
  multiple of 128; the encoder runs every
  window at the largest window's rows, since its bf16 products may sum in
  another order at another shape.
- ``subprocess``: one ``python -m tacotron2_tpu_torch say`` per request, as
  the reference server shells out to its CLI.

The data mesh (the server config's ``mesh: {"data": N}``, JAX's sharded
decode): each model loads one replica per shard device (its model, packed
decoder, vocoder and GST neutral style), and a window's rows, padded to a
power of two and then to a multiple of N, split into N contiguous shards
(``parallel/mesh.py::shard_rows``'s split). Each shard runs its rows'
decode (K1, or K5 for an int8 entry) and vocode (K2) on its own device, on
a thread and CUDA stream of its own; the cuts and the audio gather back in
request order, and ``BATCH_CALLS`` counts the window once. Each shard
encodes at the meshless server's ``encode_rows`` and cuts each row at its
own first gate fire. So a row that never fires reads the same audio at any
N; a row that fires can differ from its meshless window by the postnet's
look-past (it reads up to 10 frames past the cut, and each shard decodes to
its own horizon), as JAX's sharded server does (its test allows 1e-3).
Shard i runs on ``cuda:i``; a mesh wider than the cards present raises, as
JAX's does; ``device="cpu"`` puts every shard on the CPU. ``App``,
``ModelRegistry`` and ``make_server`` also take an explicit list of shard
devices (``shard_devices``): the tests' CPU shards, and two shards on one
card (``["cuda:0", "cuda:0"]``), which is how one card shows the split.

``http.server.ThreadingHTTPServer`` answers each connection on a thread of
its own; ``/generate`` blocks that thread on the request's future.
An entry of a description model is refused at start: JAX's server passes no
description embeddings (a request carries no description), so such an
entry fails every request there. A request is checked against its model
(``validate_request``, the JAX ``_validate_request``): a 400 for controls
of another count, or for a model without controls, and for a voice out of
range, or nonzero for a single-speaker model.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import uuid
from http import HTTPStatus
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple
from urllib.parse import unquote, urlparse

import numpy as np
import torch

from tacotron2_tpu_torch.audio.io import write_wav
from tacotron2_tpu_torch.config import Config, load_config
from tacotron2_tpu_torch.models.hifigan import HiFiGAN
from tacotron2_tpu_torch.models.layers import resolve_device, use_f32_math
from tacotron2_tpu_torch.models.tacotron2 import Tacotron2
from tacotron2_tpu_torch.ops.decoder_loop import PackedDecoder
from tacotron2_tpu_torch.run.say import (MAX_LEN, cut_vocode, griffin_lim_vocode, load_hifigan,
                                         load_tacotron, refuse_descriptions,
                                         vocode_bucket)
from tacotron2_tpu_torch.text.cleaners import normalize_text
from tacotron2_tpu_torch.text.encoder import CharEncoder

PACKAGE_ROOT = Path(__file__).resolve().parents[2]
WEB_DIR = PACKAGE_ROOT / "web"
GENERATED_DIR = "web_generated"
CHAR_BUCKET = 128
SEED_RANGE = (-(2**63), 2**64 - 1)  # what torch.Generator.manual_seed takes
SHUTDOWN = "server shutting down"
# the reference page's slider fields, in the order of the controls
# (web/index.html; the JAX server's default when its config names none)
CONTROL_SLIDERS = ("pitch", "pitch_range", "intensity", "nhr", "rate")

# [decode launches, decoded rows]: /stats shows rows per launch, the
# batching factor the micro-batcher reached
BATCH_CALLS = [0, 0]
_BATCH_LOCK = threading.Lock()


class Bundle(NamedTuple):
    cfg: Config
    model: Tacotron2
    hifigan: Optional[HiFiGAN]
    packed: PackedDecoder
    entry: Dict[str, Any]
    gst_embedding: Optional[torch.Tensor] = None  # a GST model's neutral style (1, S)
    # a data mesh's replicas, one per shard device (the first on this
    # bundle's device); empty without a mesh
    shards: Tuple["Bundle", ...] = ()


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def mesh_devices(mesh: Optional[Dict[str, Any]], device: Optional[str] = None,
                 shard_devices: Optional[Sequence[str]] = None) -> Optional[List[str]]:
    """The shard devices of a server config's ``mesh`` (``{"data": N}``):
    ``shard_devices`` where given (N of them); else for N > 1 ``cuda:0``
    .. ``cuda:N-1``, or N times the CPU with ``device="cpu"``; None without
    a mesh (N = 1). A mesh wider than the cards present raises, as JAX's
    server does."""
    n = int((mesh or {}).get("data", 1))
    if shard_devices is not None:
        devs = [str(d) for d in shard_devices]
        if len(devs) != max(n, 1):
            raise ValueError(f"server mesh wants data={n} devices, the list names {len(devs)}")
        for d in devs:
            resolve_device(d)
        return devs
    if n <= 1:
        return None
    if resolve_device(device).type == "cpu":
        return ["cpu"] * n
    have = torch.cuda.device_count()
    if n > have:
        raise ValueError(f"server mesh wants data={n} devices, only {have} available")
    return [f"cuda:{i}" for i in range(n)]


class ModelRegistry:
    def __init__(self, entries: List[Dict[str, Any]], device: Optional[str] = None,
                 shard_devices: Optional[Sequence[str]] = None):
        for e in entries:
            try:  # description models (JAX's server passes no description) are
                # refused at start
                refuse_descriptions(load_config(e["config"]), "the server")
            except NotImplementedError as exc:
                raise NotImplementedError(f"model {e.get('name')!r}: {exc}") from None
            except Exception:
                pass  # a bad entry fails its own requests, at load
        self.entries = entries
        self.device = device
        self.shard_devices = list(shard_devices) if shard_devices else None
        # per shard: [decodes, rows, decode steps], what /stats shows of the mesh
        self.shard_counts = [[0, 0, 0] for _ in self.shard_devices or ()]
        self._pool = None
        if self.shard_devices and len(self.shard_devices) > 1:
            # room for a few windows in flight, each with a task per shard
            self._pool = concurrent.futures.ThreadPoolExecutor(
                4 * len(self.shard_devices), thread_name_prefix="shard")
        self._loaded: Dict[int, Bundle] = {}
        self._lock = threading.Lock()

    def close(self, wait: bool = False) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=wait, cancel_futures=True)

    def describe(self) -> List[Dict[str, Any]]:
        return [{"name": e.get("name", f"model-{i}"),
                 "multi_speaker": e.get("multi_speaker", False),
                 "controllable": e.get("controllable", False),
                 "num_voices": e.get("num_voices", 1)}
                for i, e in enumerate(self.entries)]

    def loaded(self) -> List[int]:
        return sorted(self._loaded)

    def load(self, idx: int) -> Bundle:
        """The model, its vocoder, its decoder packed once (int8 with
        ``quantize_int8``) and a GST model's neutral style, loaded at the
        first call and kept; with a mesh, one replica of each per shard
        device (``Bundle.shards``)."""
        with self._lock:
            if idx in self._loaded:
                return self._loaded[idx]
            entry = self.entries[idx]
            cfg = load_config(entry["config"])
            reps = [self._replica(cfg, entry, resolve_device(d))
                    for d in self.shard_devices or [self.device]]
            bundle = reps[0]._replace(shards=tuple(reps)) if len(reps) > 1 else reps[0]
            self._loaded[idx] = bundle
            return bundle

    @staticmethod
    def _replica(cfg: Config, entry: Dict[str, Any], dev: torch.device) -> Bundle:
        with _on_device(dev):
            model = load_tacotron(cfg, entry["checkpoint"], dev)
            hifigan = None
            if entry.get("hifi_gan_checkpoint"):
                hifigan = load_hifigan(entry["hifi_gan_checkpoint"], dev)
            packed = model.make_packed_decoder(bool(entry.get("quantize_int8")))
            with torch.no_grad():
                gst = model.gst_embedding(1)
            if dev.type == "cuda":  # the windows' streams read these weights
                torch.cuda.synchronize(dev)
        return Bundle(cfg, model, hifigan, packed, entry, gst)


def validate_request(cfg: Config, req: Dict[str, Any]) -> None:
    """A request's own errors against its model, found before it shares a
    window (JAX ``_validate_request``): a controllable model needs a list of
    exactly ``controls_dim`` numbers (coerced here, so that a bad entry
    fails this request alone), another model none; a multi-speaker model's
    voice must be in range, a single-speaker model's None or 0."""
    dim = cfg.controls_dim
    controls = req.get("controls")
    if dim:
        if controls is None:
            raise ValueError(f"model has controls enabled: a {dim}-dim 'controls' vector is "
                             "required (the UI's neutral position is all zeros)")
        if not isinstance(controls, (list, tuple)):
            raise ValueError(f"'controls' must be a list, got {type(controls).__name__}")
        if len(controls) != dim:
            raise ValueError(f"'controls' must have {dim} entries, got {len(controls)}")
        try:
            req["controls"] = [float(c) for c in controls]
        except (TypeError, ValueError):
            raise ValueError(f"'controls' entries must be numbers, got {controls!r}")
    elif controls:
        raise ValueError("model has controls disabled, but 'controls' passed")
    spk = cfg.extensions.speaker_tokens
    sid = req.get("speaker_id")
    if spk.active and sid is not None and not 0 <= int(sid) < spk.num_speakers:
        raise ValueError(f"speaker_id {sid} out of range [0, {spk.num_speakers})")
    if not spk.active and sid not in (None, 0):
        raise ValueError("model is single-speaker, but 'voice' passed")


_TLS = threading.local()


def _thread_stream(device: torch.device):
    """A CUDA stream of this thread's own on ``device``: two windows in
    flight, or two shards of one, run on two threads, and their kernels
    must not interleave on one stream."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    streams = getattr(_TLS, "streams", None)
    if streams is None:
        streams = _TLS.streams = {}
    key = torch.cuda.current_device() if device.index is None else device.index
    if key not in streams:
        streams[key] = torch.cuda.Stream(device)
    return torch.cuda.stream(streams[key])


@contextlib.contextmanager
def _on_device(device: torch.device):
    """``device`` the current CUDA device and this thread's stream on it."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device), _thread_stream(device):
        yield


def synthesize_batch(bundle: Bundle, reqs: List[Dict[str, Any]],
                     encode_rows: Optional[int] = None,
                     registry: Optional[ModelRegistry] = None) -> List[str]:
    """One window of validated requests -> their WAV paths, through one
    batched decode and one batched HiFi-GAN call per shard (one without a
    mesh).

    Chars pad to a multiple of 128 and rows to a power of two (row 0
    repeated, with a generator of its own seeded as row 0's), then with a
    mesh of N shards to a multiple of N, split contiguously over the shards
    (``_shard_rows``, each on a thread of ``registry``'s pool: a mesh
    bundle needs its registry). The window counts once in ``BATCH_CALLS``."""
    cfg = bundle.cfg
    prep = cfg.dataset.preprocessing
    with _BATCH_LOCK:
        BATCH_CALLS[0] += 1
        BATCH_CALLS[1] += len(reqs)
    encoder = CharEncoder(prep.allowed_chars, prep.end_token)
    chars, lens = encoder.encode_batch(
        [normalize_text(r["text"], prep.allowed_chars, prep.end_token, False) for r in reqs])
    B, L = chars.shape
    Lb = max(CHAR_BUCKET, -(-L // CHAR_BUCKET) * CHAR_BUCKET)
    shards = bundle.shards or (bundle,)
    n = len(shards)
    Bb = _pow2(B)
    if n > 1:  # every shard takes as many rows (JAX run/server.py:211-218)
        Bb = -(-max(Bb, n) // n) * n
    rows = list(range(B)) + [0] * (Bb - B)
    chars = np.pad(chars, ((0, 0), (0, Lb - L)))[rows]
    lens = lens[rows]
    per = Bb // n
    parts = [slice(s * per, (s + 1) * per) for s in range(n)]
    # a shard without a request (one past the window's rows) does not run
    jobs = [(s, part) for s, part in enumerate(parts) if part.start < B]

    def job(s: int, part: slice):
        with _on_device(next(shards[s].model.parameters()).device):
            return _shard_rows(shards[s], reqs, rows[part], min(part.stop, B) - part.start,
                               chars[part], lens[part], encode_rows)

    if n == 1:
        results = [job(*jobs[0])]
    else:  # each shard on a thread of the registry's pool
        if registry is None:
            raise ValueError("a mesh bundle's window runs on its registry's pool")
        results = [f.result() for f in [registry._pool.submit(job, *j) for j in jobs]]
    wavs: Dict[int, np.ndarray] = {}
    for (s, part), (got, steps) in zip(jobs, results):
        wavs.update(got)
        if registry is not None and registry.shard_counts:
            with _BATCH_LOCK:
                c = registry.shard_counts[s]
                c[0], c[1], c[2] = c[0] + 1, c[1] + part.stop - part.start, c[2] + steps
    paths = []
    for b, r in enumerate(reqs):
        write_wav(r["out_path"], wavs[b], prep.sample_rate)
        paths.append(r["out_path"])
    return paths


def _shard_rows(shard: Bundle, reqs: List[Dict[str, Any]], rows: List[int], real: int,
                chars: np.ndarray, lens: np.ndarray, encode_rows: Optional[int]) -> tuple:
    """One shard's rows (``rows``: request indices; the first ``real`` are
    the window's, the rest padding) through its replica: the encoder at
    ``encode_rows`` rows (``forward_infer_fast``), each row cut at its first
    gate fire (a row's cut does not depend on longer rows in the window; at
    one row it is ``say``'s n - 1), then the rows with a vocoder through
    ``cut_vocode`` in a power-of-two row bucket and a 128-frame bucket past
    the receptive field, PCM16 on the device; the others through
    Griffin-Lim. Each row brings its own generator, seeded by its request
    and made on the shard's device, its voice (0 where a multi-speaker
    model's request names none) and controls; a GST model's rows the
    replica's neutral style. -> ({request index: wav}, decode steps)."""
    cfg, model, hifigan, packed, entry, gst = shard[:6]
    prep = cfg.dataset.preprocessing
    dev = next(model.parameters()).device
    gens = [torch.Generator(device=dev).manual_seed(int(reqs[b].get("seed") or 0)) for b in rows]
    cond = {}
    if cfg.extensions.speaker_tokens.active:
        cond["speaker_id"] = torch.tensor([int(reqs[b].get("speaker_id") or 0) for b in rows])
    if cfg.controls_dim:
        cond["controls"] = torch.tensor([reqs[b]["controls"] for b in rows],
                                        dtype=torch.float32, device=dev)
    if gst is not None:
        cond["gst_embedding"] = gst.expand(len(rows), -1)
    out = model.forward_infer_fast(torch.as_tensor(chars, device=dev),
                                   torch.as_tensor(lens, device=dev),
                                   int(entry.get("max_len", MAX_LEN)), packed=packed,
                                   row_generators=gens, encode_rows=encode_rows, **cond)
    n = int(out.n_frames)
    fired = out.gates[:real, :, 0] < 0.0
    first = torch.where(fired.any(dim=1), fired.int().argmax(dim=1),
                        torch.full((real,), fired.shape[1], device=dev))
    cuts = [max(min(int(f), n - 1), 1) for f in first.tolist()]

    wavs: Dict[int, np.ndarray] = {}
    voc = [i for i in range(real) if reqs[rows[i]].get("use_vocoder", True)
           and hifigan is not None]
    if voc:
        pad = _pow2(len(voc)) - len(voc)
        pcm = cut_vocode(hifigan, out.mels_post, voc + [0] * pad,
                         [cuts[i] for i in voc] + [0] * pad,
                         vocode_bucket(hifigan, max(cuts[i] for i in voc))).cpu().numpy()
        hop = hifigan.cfg.total_upsample
        for j, i in enumerate(voc):
            wavs[rows[i]] = pcm[j, :cuts[i] * hop]
    for i in range(real):
        if rows[i] not in wavs:
            wavs[rows[i]] = griffin_lim_vocode(out.mels_post[i, :cuts[i]],
                                               prep.sample_rate).cpu().numpy()
    return wavs, n


def _settle(fut: concurrent.futures.Future, result=None, exc: Optional[BaseException] = None):
    """Resolve a future unless it is resolved already (``close`` fails the
    pending ones while their window may still be running)."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except concurrent.futures.InvalidStateError:
        pass


class MicroBatcher:
    """Per model, a worker thread gathers the requests that arrive within
    ``window_ms`` of the first (then whatever is already queued, up to
    ``max_batch``) and hands the window to a pool of ``depth`` threads, so
    up to ``depth`` windows are in flight: one decodes while the last one's
    audio is vocoded and written. Every window's encoder runs the rows of
    the largest window (``max_batch`` to a power of two), so a request's
    encoding does not depend on its window. Every failure lands on the
    requests' futures, never on the worker."""

    def __init__(self, registry: ModelRegistry, window_ms: float = 8.0, max_batch: int = 64,
                 depth: int = 2):
        self.registry = registry
        self.window = max(float(window_ms), 0.0) / 1000.0
        self.max_batch = max(int(max_batch), 1)
        self.encode_rows = _pow2(self.max_batch)
        self.depth = max(int(depth), 1)
        self._lock = threading.Lock()
        self._queues: Dict[int, queue.Queue] = {}
        self._pools: Dict[int, concurrent.futures.ThreadPoolExecutor] = {}
        self._pending: set = set()
        self._closed = False

    def submit(self, model_idx: int, req: Dict[str, Any]) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._lock:
            if self._closed:
                fut.set_exception(RuntimeError(SHUTDOWN))
                return fut
            self._pending.add(fut)
            q = self._queues.get(model_idx)
            if q is None:
                q = self._queues[model_idx] = queue.Queue()
                pool = self._pools[model_idx] = concurrent.futures.ThreadPoolExecutor(
                    self.depth, thread_name_prefix=f"window-{model_idx}")
                threading.Thread(target=self._worker, args=(model_idx, q, pool),
                                 name=f"batcher-{model_idx}", daemon=True).start()
            q.put((req, fut))
        fut.add_done_callback(self._done)
        return fut

    def _done(self, fut) -> None:
        with self._lock:
            self._pending.discard(fut)

    def close(self, wait: bool = False) -> None:
        """Stop the workers and fail every request not answered yet, queued
        or in a window still running; with ``wait``, return once the running
        windows have ended (a process must not exit while a window thread
        is still inside torch)."""
        with self._lock:
            self._closed = True
            pending = list(self._pending)
            for q in self._queues.values():
                q.put(None)
        err = RuntimeError(SHUTDOWN)
        for fut in pending:
            _settle(fut, exc=err)
        for pool in self._pools.values():
            pool.shutdown(wait=wait, cancel_futures=True)

    def _worker(self, model_idx: int, q: queue.Queue, pool) -> None:
        slots = threading.BoundedSemaphore(self.depth)
        while True:
            item = q.get()
            if item is None:
                return
            batch = [item]
            deadline = time.monotonic() + self.window
            while len(batch) < self.max_batch:
                timeout = deadline - time.monotonic()
                try:  # once the window has closed, take only what is queued
                    item = q.get(timeout=timeout) if timeout > 0 else q.get_nowait()
                except queue.Empty:
                    break
                if item is None:
                    return
                batch.append(item)
            slots.acquire()
            try:
                pool.submit(self._run_batch, model_idx, batch, slots)
            except RuntimeError:  # the pool was shut down: close() failed the batch
                return

    def _run_batch(self, model_idx: int, batch, slots) -> None:
        try:
            # load inside the try: a bad checkpoint fails these requests,
            # and the worker goes on serving
            bundle = self.registry.load(model_idx)
            good = []
            for req, fut in batch:
                try:
                    validate_request(bundle.cfg, req)
                    good.append((req, fut))
                except Exception as exc:  # this request only
                    _settle(fut, exc=exc)
            if good:
                with _thread_stream(next(bundle.model.parameters()).device):
                    paths = synthesize_batch(bundle, [r for r, _ in good], self.encode_rows,
                                             self.registry)
                for (_, fut), path in zip(good, paths):
                    _settle(fut, path)
        except Exception as exc:
            for _, fut in batch:
                _settle(fut, exc=exc)
        finally:
            slots.release()


def warmup_models(registry: ModelRegistry, encode_rows: Optional[int] = None) -> None:
    """Load every model and synthesize a short request on each of its
    shards (one without a mesh) before the first real one (server config
    ``"warmup": true``), the encoder at the windows' ``encode_rows``; voice
    0 and neutral (zero) controls where the model takes them."""
    for idx in range(len(registry.entries)):
        bundle = registry.load(idx)
        reqs = []
        for s in range(max(len(bundle.shards), 1)):
            req = {"text": "warmup.", "seed": 0, "use_vocoder": True,
                   "out_path": os.path.join(GENERATED_DIR, f"warmup-{idx}-{s}.wav")}
            if bundle.cfg.controls_dim:
                req["controls"] = [0.0] * bundle.cfg.controls_dim
            reqs.append(req)
        synthesize_batch(bundle, reqs, encode_rows, registry)


class App:
    """The routes' state and logic, apart from the HTTP plumbing."""

    def __init__(self, server_config: Dict[str, Any], mode: str = "warm",
                 device: Optional[str] = None, shard_devices: Optional[Sequence[str]] = None):
        """``shard_devices``: the data mesh's devices where the caller names
        them (``mesh_devices``); a subprocess server runs no mesh."""
        if mode not in ("warm", "subprocess"):
            raise ValueError(f"unknown mode {mode!r}")
        shards = mesh_devices(server_config.get("mesh"), device,
                              shard_devices) if mode == "warm" else None
        os.makedirs(GENERATED_DIR, exist_ok=True)
        self.server_config = server_config
        self.mode = mode
        self.device = device
        self.registry = ModelRegistry(server_config.get("models", []), device, shards)
        b = server_config.get("batching", {})
        self.batcher = MicroBatcher(self.registry, b.get("window_ms", 8.0),
                                    b.get("max_batch", 64), b.get("depth", 2)
                                    ) if b.get("enabled", True) else None
        if mode == "warm" and server_config.get("warmup"):
            warmup_models(self.registry, self.batcher and self.batcher.encode_rows)
        self.started = time.time()
        self.counts = {"ok": 0, "failed": 0}
        self._lock = threading.Lock()

    def close(self, wait: bool = False) -> None:
        if self.batcher is not None:
            self.batcher.close(wait)
        self.registry.close(wait)

    def stats(self) -> Dict[str, Any]:
        calls, rows = BATCH_CALLS
        b = self.batcher
        return {
            "uptime_s": round(time.time() - self.started, 1),
            "mode": self.mode,
            "requests": dict(self.counts),
            "batching": None if b is None else {
                "window_ms": b.window * 1000.0, "max_batch": b.max_batch, "depth": b.depth,
                "decode_launches": calls, "decoded_rows": rows,
                "rows_per_launch": round(rows / calls, 2) if calls else None},
            "mesh_devices": len(self.registry.shard_devices or [None]),
            "shards": [{"device": d, "decodes": c[0], "rows": c[1], "decode_steps": c[2]}
                       for d, c in zip(self.registry.shard_devices or (),
                                       self.registry.shard_counts)] or None,
            "mesh_configured": self.server_config.get("mesh") or None,
            "models_loaded": self.registry.loaded(),
        }

    def generate(self, data: Any) -> tuple:
        """-> (HTTP status, JSON body); counts the outcome."""
        try:
            status, body = HTTPStatus.OK, self._generate(data)
        except ValueError as exc:  # the request's own error, as in the JAX server
            status, body = HTTPStatus.BAD_REQUEST, {"error": str(exc)}
        except Exception as exc:
            status = HTTPStatus.INTERNAL_SERVER_ERROR
            body = {"error": f"{type(exc).__name__}: {exc}"}
        with self._lock:
            self.counts["ok" if status == HTTPStatus.OK else "failed"] += 1
        return status, body

    def _request(self, data: Any) -> tuple:
        """Parse a /generate body (the JAX server's fields and the reference
        client's aliases: ``voice`` or ``speaker``, and for a controllable
        entry without ``controls`` the named sliders, in the order of the
        server config's ``controls`` or else ``CONTROL_SLIDERS``, a missing
        one 0) -> (model index, request)."""
        if not isinstance(data, dict):
            raise ValueError("the body must be a JSON object")
        try:
            idx = int(data.get("model", 0) or 0)
        except (TypeError, ValueError):
            raise ValueError(f"model must be an integer index, got {data.get('model')!r}")
        if not 0 <= idx < len(self.registry.entries):
            raise ValueError(f"model index {idx} out of range "
                             f"(0..{len(self.registry.entries) - 1})")
        try:
            seed = data.get("seed", data.get("random_seed"))
            seed = int(seed) if seed not in (None, "") else None
            voice = data.get("voice", data.get("speaker"))
            voice = int(voice) if voice not in (None, "") else None
        except (TypeError, ValueError) as exc:
            raise ValueError(f"seed/voice must be integers: {exc}")
        if seed is not None and not SEED_RANGE[0] <= seed <= SEED_RANGE[1]:
            raise ValueError(f"seed {seed} is out of range {SEED_RANGE}")
        controls = data.get("controls")
        if controls is None and self.registry.entries[idx].get("controllable"):
            names = [c["val"] if isinstance(c, dict) else str(c)
                     for c in self.server_config.get("controls", [])] or list(CONTROL_SLIDERS)
            if any(n in data for n in names):
                try:
                    controls = [float(data.get(n) or 0.0) for n in names]
                except (TypeError, ValueError) as exc:
                    raise ValueError(f"control sliders must be numbers: {exc}")
        return idx, {"text": str(data.get("text", "")), "seed": seed, "speaker_id": voice,
                     "controls": controls,
                     "use_vocoder": bool(data.get("use_vocoder", data.get("vocoder", True)))}

    def _generate(self, data: Any) -> Dict[str, Any]:
        req_id = str(uuid.uuid4())
        with open(os.path.join(GENERATED_DIR, f"{req_id}.json"), "w") as f:
            json.dump(data, f)
        idx, req = self._request(data)
        out_path = os.path.join(GENERATED_DIR, f"{req_id}.wav")
        req["out_path"] = out_path
        if self.mode == "subprocess":
            entry = self.registry.entries[idx]
            cfg = load_config(entry["config"])
            validate_request(cfg, req)
            self._say_subprocess(entry, req, cfg.extensions.speaker_tokens.active)
        elif self.batcher is not None:
            self.batcher.submit(idx, req).result()
        else:
            bundle = self.registry.load(idx)
            validate_request(bundle.cfg, req)
            with _thread_stream(next(bundle.model.parameters()).device):
                synthesize_batch(bundle, [req], registry=self.registry)
        return {"path": out_path, "filename": "/" + out_path}

    def _say_subprocess(self, entry: Dict[str, Any], req: Dict[str, Any],
                        multi_speaker: bool) -> None:
        cmd = [sys.executable, "-m", "tacotron2_tpu_torch", "say", "--config", entry["config"],
               "--checkpoint", entry["checkpoint"], "--text", req["text"],
               "--out", req["out_path"]]
        if req["use_vocoder"] and entry.get("hifi_gan_checkpoint"):
            cmd += ["--hifi-gan-checkpoint", entry["hifi_gan_checkpoint"]]
        if req["seed"] is not None:
            cmd += ["--random-seed", str(req["seed"])]
        if multi_speaker:
            cmd += ["--speaker-id", str(req.get("speaker_id") or 0)]
        if req.get("controls"):
            cmd.append("--controls=" + ",".join(repr(float(c)) for c in req["controls"]))
        if entry.get("max_len"):
            cmd += ["--max-len-override", str(entry["max_len"])]
        if entry.get("quantize_int8"):
            cmd.append("--quantize-int8")
        if self.device is not None:
            cmd += ["--device", str(self.device)]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(PACKAGE_ROOT), env.get("PYTHONPATH")) if p)
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"say exited with {proc.returncode}: {proc.stderr[-2000:]}")


_CONTENT_TYPES = {".wav": "audio/wav", ".json": "application/json"}


class Handler(BaseHTTPRequestHandler):
    server_version = "tacotron2_tpu_torch"
    protocol_version = "HTTP/1.1"

    @property
    def app(self) -> App:
        return self.server.app

    def log_message(self, format, *args):  # no access log on stderr
        pass

    def _send(self, status, body: bytes, content_type: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, status, obj) -> None:
        self._send(status, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        path = urlparse(self.path).path
        if path == "/":
            self._send(HTTPStatus.OK, (WEB_DIR / "index.html").read_bytes(), "text/html")
        elif path == "/config":
            self._json(HTTPStatus.OK, self.app.registry.describe())
        elif path == "/stats":
            self._json(HTTPStatus.OK, self.app.stats())
        elif path.startswith(f"/{GENERATED_DIR}/"):
            name = unquote(path[len(GENERATED_DIR) + 2:])
            file = Path(GENERATED_DIR) / name
            if "/" in name or name.startswith(".") or not file.is_file():
                self._json(HTTPStatus.NOT_FOUND, {"error": f"no file {name!r}"})
            else:
                self._send(HTTPStatus.OK, file.read_bytes(),
                           _CONTENT_TYPES.get(file.suffix, "application/octet-stream"))
        else:
            self._json(HTTPStatus.NOT_FOUND, {"error": f"no route {path}"})

    def do_POST(self):
        path = urlparse(self.path).path
        body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
        if path != "/generate":
            self._json(HTTPStatus.NOT_FOUND, {"error": f"no route {path}"})
            return
        try:
            data = json.loads(body or b"null")
        except ValueError as exc:
            self._json(HTTPStatus.BAD_REQUEST, {"error": f"the body is not JSON: {exc}"})
            return
        self._json(*self.app.generate(data))


class Server(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 256  # a wave of concurrent clients; socketserver's default is 5


def make_server(server_config: Dict[str, Any], mode: str = "warm",
                device: Optional[str] = None, host: str = "0.0.0.0",
                port: int = 8080, shard_devices: Optional[Sequence[str]] = None) -> Server:
    """The HTTP server with its ``App`` (``server.app``); port 0 picks a
    free one (``server.server_address[1]``). Close with ``app.close()``
    and ``server_close()``."""
    app = App(server_config, mode, device, shard_devices)
    httpd = Server((host, port), Handler)
    httpd.app = app
    return httpd


def do_server(port: int, server_config: Optional[Dict[str, Any]] = None, mode: str = "warm",
              device: Optional[str] = None, host: str = "0.0.0.0",
              on_start: Optional[Callable[[Server], None]] = None) -> dict:
    """Serve until SIGINT or SIGTERM (in the main thread) or until
    ``server.shutdown()``; then fail the pending requests and return. A warm
    server asked for CUDA where there is none refuses to start.
    ``on_start`` gets the server once it listens (a caller that runs this
    on a thread of its own stops it with ``shutdown()``)."""
    if mode == "warm":
        dev = resolve_device(device)
        if dev.type == "cuda":
            use_f32_math()
    httpd = make_server(server_config or {}, mode, device, host, port)

    def stop(signum, frame):
        raise KeyboardInterrupt

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, stop)
    bound = httpd.server_address[1]
    print(f"serving on http://{host}:{bound} ({mode})", flush=True)
    if on_start is not None:
        on_start(httpd)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.app.close(wait=True)
        httpd.server_close()
    print("server stopped", flush=True)
    return {"port": bound, "stats": httpd.app.stats()}
