"""The server's data mesh (``mesh: {"data": N}``,
``tacotron2_tpu_torch/run/server.py``) on the CPU, at the tiny sizes of
``tests/test_torch_serve.py``, with N CPU shards:

- three concurrent requests coalesce into one window of 4 rows split over 2
  shards (``BATCH_CALLS`` counts the window once, each shard decodes its 2
  rows on its own replica), and each request's wav equals its solo run on
  the meshless server within 1 PCM16 LSB (the meshless batched test's
  tolerance) with the gate never firing (every row to ``max_len``), bf16 and
  int8; with rows that fire at frames of their own, each row's cut equal
  to alone and its wav within JAX's 1e-3
  (``tests/test_server.py::test_server_mesh_sharded_decode``): the postnet
  reads up to 10 frames past a row's cut, decoded as far as its shard's
  horizon (alone: its own), as in a meshless window;
- every shard encodes at the meshless windows' ``encode_rows``;
- ``/stats`` reports N and each shard's decodes;
- a mesh wider than the cards present raises with JAX's words, and a list
  of shard devices of another length raises.
"""

import copy
import json

import numpy as np
import pytest
import torch

from tacotron2_tpu_torch.audio.io import read_wav
from tacotron2_tpu_torch.config import load_config
from tacotron2_tpu_torch.convert import to_lightning
from tacotron2_tpu_torch.models.tacotron2 import Tacotron2
from tacotron2_tpu_torch.run import server as srv
from tacotron2_tpu_torch.run.say import model_config_from
from tests.test_torch_serve import Client, files  # noqa: F401  (the module's fixture)

torch.set_num_threads(1)

TEXTS = [("shard the first", 5), ("and the second", 6), ("plus a third", 7)]
# with ``_firing_entry``'s gate bias: the first fires at frame 5, the second
# never (to max_len), the third at 14; so the second shard ([third, first's
# padding copy]) stops at its own horizon, before the first shard's
FIRING_TEXTS = [TEXTS[2], TEXTS[0], TEXTS[1]]
FIRING_BIAS = -0.063


@pytest.fixture
def start(tmp_path, monkeypatch):
    """-> start(server_config, shard_devices=None) -> (Client, App)."""
    monkeypatch.chdir(tmp_path)
    started = []

    def run(config, shard_devices=None):
        import threading

        httpd = srv.make_server(config, "warm", device="cpu", host="127.0.0.1", port=0,
                                shard_devices=shard_devices)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        started.append((httpd, thread))
        return Client(httpd.server_address[1]), httpd.app

    yield run
    for httpd, thread in started:
        httpd.shutdown()
        httpd.app.close(wait=True)
        httpd.server_close()
        thread.join(timeout=10)


def _firing_entry(files, tmp_path):  # noqa: F811
    """The tiny entry with the gate's bias at ``FIRING_BIAS``: rows fire at
    frames of their own (its logits fall from ~0.08 to ~0.061 over 16
    frames, each row's a few 1e-4 apart)."""
    entry = copy.deepcopy(files["models"][0])
    torch.manual_seed(0)
    model = Tacotron2(model_config_from(load_config(entry["config"])))
    with torch.no_grad():
        model.decoder.gate.bias.fill_(FIRING_BIAS)
    entry["checkpoint"] = str(tmp_path / "firing.ckpt")
    torch.save(to_lightning(model.state_dict()), entry["checkpoint"])
    return entry


def _in_order(client, payloads):
    """The payloads posted concurrently, each 50 ms after the one before, so
    that one window of 500 ms takes them in this order (its rows' order)."""
    import concurrent.futures
    import time

    def post(i):
        time.sleep(0.05 * i)
        return client.post(payloads[i])

    with concurrent.futures.ThreadPoolExecutor(len(payloads)) as ex:
        return list(ex.map(post, range(len(payloads))))


def _pcm(tmp_path, body):
    return np.round(read_wav(str(tmp_path / body["path"]))[0] * 32768)


@pytest.mark.parametrize("kind", ["never_fires", "fires", "int8"])
def test_sharded_window_equals_solo_runs(files, start, tmp_path, kind):  # noqa: F811
    entry = (_firing_entry(files, tmp_path) if kind == "fires"
             else dict(copy.deepcopy(files["models"][0]), quantize_int8=kind == "int8"))
    batching = {"window_ms": 500, "max_batch": 8}
    mesh_c, mesh_app = start({"models": [entry], "batching": batching, "mesh": {"data": 2}})
    solo_c, _ = start({"models": [entry], "batching": batching})
    bundle = mesh_app.registry.load(0)
    assert len(bundle.shards) == 2 and bundle.shards[0].model is not bundle.shards[1].model
    assert all(str(next(s.model.parameters()).device) == "cpu" for s in bundle.shards)
    if kind == "int8":
        assert all(s.packed.quantized for s in bundle.shards)
    texts = FIRING_TEXTS if kind == "fires" else TEXTS
    calls0 = srv.BATCH_CALLS[0]
    counts0 = [list(c) for c in mesh_app.registry.shard_counts]
    replies = _in_order(mesh_c, [{"text": t, "model": 0, "seed": s} for t, s in texts])
    assert all(status == 200 for status, _ in replies), replies
    assert srv.BATCH_CALLS[0] - calls0 == 1, "the requests did not coalesce"
    counts = [[a - b for a, b in zip(c, c0)]
              for c, c0 in zip(mesh_app.registry.shard_counts, counts0)]
    assert [c[:2] for c in counts] == [[1, 2], [1, 2]]  # 4 rows, 2 a shard
    lengths = set()
    for (t, s), (_, body) in zip(texts, replies):
        status, solo = solo_c.post({"text": t, "model": 0, "seed": s})
        assert status == 200
        a, b = _pcm(tmp_path, body), _pcm(tmp_path, solo)
        assert a.shape == b.shape, (t, a.shape, b.shape)
        limit = 1e-3 * 32768 if kind == "fires" else 1
        assert np.abs(a - b).max() <= limit, f"{t!r}: a sharded row's audio differs from alone"
        lengths.add(len(a))
    if kind == "fires":  # cut n - 1 = 15 frames where a row never fires, hop 8
        assert lengths == {5 * 8, 15 * 8, 14 * 8}, lengths
        assert counts[0][2] == 16 and counts[1][2] == 15  # each shard's own horizon
    st = json.loads(mesh_c.get("/stats")[1])
    assert st["mesh_devices"] == 2 and st["mesh_configured"] == {"data": 2}
    assert [sh["device"] for sh in st["shards"]] == ["cpu", "cpu"]
    assert all(sh["decodes"] >= 1 for sh in st["shards"])


def test_every_shard_encodes_at_the_windows_rows(files, start, monkeypatch):  # noqa: F811
    seen = []
    encode = Tacotron2._encode

    def spy(self, chars_idx, chars_len, train=False, generator=None, rows=None, **kw):
        seen.append((chars_idx.shape[0], rows))
        return encode(self, chars_idx, chars_len, train, generator, rows, **kw)

    monkeypatch.setattr(Tacotron2, "_encode", spy)
    config = dict(copy.deepcopy(files), batching={"window_ms": 500, "max_batch": 6},
                  mesh={"data": 2})
    c, _ = start(config)
    replies = c.post_all([{"text": t, "model": 0, "seed": s} for t, s in TEXTS])
    assert all(status == 200 for status, _ in replies)
    assert sorted(seen) == [(2, 8), (2, 8)]  # each shard's 2 rows at max_batch's power of two


def test_one_request_runs_on_one_shard_and_warmup_on_each(files, start):  # noqa: F811
    config = dict(copy.deepcopy(files), mesh={"data": 2}, warmup=True)
    c, app = start(config, shard_devices=["cpu", "cpu"])
    assert [sc[0] for sc in app.registry.shard_counts] == [1, 1]  # the warm-up's two rows
    assert c.post({"text": "alone", "model": 0, "seed": 3})[0] == 200
    assert [sc[0] for sc in app.registry.shard_counts] == [2, 1]


def test_mesh_devices(monkeypatch):
    assert srv.mesh_devices(None) is None and srv.mesh_devices({"data": 1}) is None
    assert srv.mesh_devices({"data": 3}, "cpu") == ["cpu"] * 3
    assert srv.mesh_devices({"data": 2}, shard_devices=["cpu", "cpu"]) == ["cpu", "cpu"]
    with pytest.raises(ValueError, match="data=2 devices, the list names 3"):
        srv.mesh_devices({"data": 2}, shard_devices=["cpu"] * 3)
    # a card's machine with one card: a mesh of 2 raises as JAX's server does
    monkeypatch.setattr(srv, "resolve_device", lambda d=None: torch.device(d or "cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"server mesh wants data=2 devices, only 1 available"):
        srv.mesh_devices({"data": 2})
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert srv.mesh_devices({"data": 2}) == ["cuda:0", "cuda:1"]


def test_app_refuses_a_mesh_wider_than_the_cards(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(srv, "resolve_device", lambda d=None: torch.device(d or "cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="server mesh wants data=4 devices, only 1 available"):
        srv.App({"models": [], "mesh": {"data": 4}})
    app = srv.App({"models": [], "mesh": {"data": 4}}, mode="subprocess")  # no mesh there
    assert app.stats()["mesh_devices"] == 1
