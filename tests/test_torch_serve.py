"""The port's serving path (``tacotron2_tpu_torch/run/server.py``) on the CPU,
at tiny sizes:

- per-row prenet streams: each row of a batched decode equals its decode
  alone with the same seed (first gate fire equal, mels_post within 1e-6,
  the JAX test's tolerance), in bf16 and int8, dropout on;
- the per-row masks against JAX: a batch of 3 bucketed to 4 with JAX's
  per-row masks (``FusedDecodeLoop._prenet_masks(row_rngs=...)``) injected,
  against ``forward_infer_fused(row_rngs=..., interpret=True)`` (under
  ``32-true``, where the two decodes agree to the tolerances of
  tests/test_torch_decode.py);
- the batched ``cut_vocode``: a row's PCM stays within 1 LSB across vocode
  buckets and row counts (the JAX ``test_vocode_bucket_invariance_and_rf``);
- the server end to end (``urllib`` clients on threads against a server on
  a free port): routes and JSON shapes, concurrent requests coalescing into
  one decode, 400s, a bad checkpoint failing only its requests, an int8
  entry packed once, Griffin-Lim for ``use_vocoder: false``, subprocess
  mode, and shutdown failing pending requests; a multi-speaker and a
  controllable entry served, a GST entry served with the neutral style, a
  description-embedding entry refused at start.
"""

import concurrent.futures
import copy
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.ops.decoder_loop_pallas import T_CHUNK, FusedDecodeLoop
from tacotron2_tpu_torch.__main__ import main as port_cli
from tacotron2_tpu_torch.audio.io import read_wav
from tacotron2_tpu_torch.config import load_config
from tacotron2_tpu_torch.convert import to_lightning
from tacotron2_tpu_torch.models.hifigan import HiFiGAN, HiFiGANConfig
from tacotron2_tpu_torch.models.tacotron2 import Tacotron2
from tacotron2_tpu_torch.models.tacotron2 import Tacotron2
from tacotron2_tpu_torch.ops import decoder_loop
from tacotron2_tpu_torch.run import server as srv
from tacotron2_tpu_torch.run.say import cut_vocode, model_config_from, vocode_bucket
from tests.test_torch_decode import CFG
from tests.test_torch_int8_decode import _models

torch.set_num_threads(1)

LJ_CHARS = "!'(),.:;? \\-abcdefghijklmnopqrstuvwxyz"
HIFIGAN = {"resblock": "1", "upsample_rates": [4, 2], "upsample_kernel_sizes": [8, 4],
           "upsample_initial_channel": 32, "resblock_kernel_sizes": [3, 7],
           "resblock_dilation_sizes": [[1, 3], [1, 3]], "num_mels": 16}
MAX_LEN = 16


def _first_fire(out, b):
    g = out.gates[b, :, 0]
    neg = g < 0.0
    return int(neg.int().argmax()) if bool(neg.any()) else g.shape[0]


def _chars(batch):
    rng = np.random.default_rng(1)
    chars = rng.integers(1, 21, size=(3, 9)).astype(np.int64)
    lens = np.array([9, 6, 8])
    for b, n in enumerate(lens):
        chars[b, n:] = 0
    return torch.as_tensor(chars[:batch]), torch.as_tensor(lens[:batch])


@pytest.mark.parametrize("gate_bias", [3.0, 0.0])
@pytest.mark.parametrize("quantize", [False, True])
def test_row_streams_batch_invariant(quantize, gate_bias):
    *_, tm = _models(gate_bias)  # bf16-mixed; the int8 pack under it
    chars, lens = _chars(2)
    pk = tm.make_packed_decoder(quantize)
    gens = lambda seeds: [torch.Generator().manual_seed(s) for s in seeds]
    batched = tm.forward_infer_fast(chars, lens, 40, packed=pk, row_generators=gens([11, 22]))
    for b, seed in enumerate([11, 22]):
        single = tm.forward_infer_fast(chars[b:b + 1], lens[b:b + 1], 40, packed=pk,
                                       row_generators=gens([seed]))
        cb, cs = _first_fire(batched, b), _first_fire(single, 0)
        assert cb == cs, f"row {b}: first fire {cs} alone, {cb} in the batch"
        cut = max(min(cb, single.n_frames - 1), 1)
        torch.testing.assert_close(batched.mels_post[b, :cut], single.mels_post[0, :cut],
                                   atol=1e-6, rtol=0)
    # a batch of one with a generator per row is say's draw order
    say = tm.forward_infer_fast(chars[:1], lens[:1], 40, packed=pk,
                                generator=torch.Generator().manual_seed(11))
    alone = tm.forward_infer_fast(chars[:1], lens[:1], 40, packed=pk, row_generators=gens([11]))
    assert torch.equal(say.mels_post, alone.mels_post)


def test_row_masks_match_jax_bucketed():
    jm, params, state, tm = _models(3.0, "32-true")
    chars, lens = _chars(3)
    rows = [0, 1, 2, 0]  # the power-of-two bucket repeats row 0
    ci, cl = chars[rows].numpy(), lens[rows].numpy()
    keys = jnp.stack([jax.random.PRNGKey(s) for s in (11, 22, 33, 11)])
    max_len = 70
    ref = jm.forward_infer_fused(params, state, jnp.asarray(ci), jnp.asarray(cl), max_len,
                                 rng=keys[0], row_rngs=keys, interpret=True)
    row_pre = jax.vmap(lambda k: jax.random.split(k, 3)[2])(keys)
    loop = FusedDecodeLoop(num_mels=CFG["num_mels"], encoded_full_dim=CFG["encoded_dim"],
                           att_rnn_dim=CFG["att_rnn_dim"], prenet_dim=CFG["prenet_dim"],
                           att_dim=CFG["att_dim"], max_chars=9, batch=4, dropout=CFG["dropout"])
    m1s, m2s = [], []
    for t0 in range(0, max_len, T_CHUNK):
        m1, m2 = loop._prenet_masks(None, jnp.int32(t0), True, row_rngs=row_pre)
        m1s.append(np.asarray(m1)[:, :4])
        m2s.append(np.asarray(m2)[:, :4])
    masks = tuple(torch.as_tensor(np.concatenate(m)[:max_len]) for m in (m1s, m2s))
    assert torch.equal(masks[0][:, 0], masks[0][:, 3]) and not torch.equal(masks[0][:, 0],
                                                                            masks[0][:, 1])
    out = tm.forward_infer_fast(torch.as_tensor(ci), torch.as_tensor(cl), max_len, masks=masks)
    assert out.n_frames == int(ref.n_frames)
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    n = out.n_frames
    for name, atol in (("mels", 2e-4), ("mels_post", 5e-4), ("gates", 2e-3),
                       ("alignments", 1e-4)):
        np.testing.assert_allclose(getattr(out, name).numpy()[:, :n],
                                   np.asarray(getattr(ref, name))[:, :n], atol=atol, err_msg=name)


def test_cut_vocode_bucket_and_row_invariance():
    """A row's kept samples are the same whatever bucket and rows share its
    call: within 1 LSB here (readings: 1 LSB on 5 of 520 samples), since
    torch's CPU convolutions sum in an order that depends on the shapes,
    where the JAX CPU test reads bit-identical. Without the receptive-field
    margin, a row cut near a bucket's end reads far more."""
    torch.manual_seed(0)
    h = HiFiGAN(HiFiGANConfig.from_dict(HIFIGAN)).eval()
    with torch.no_grad():
        for p in h.parameters():
            p.mul_(3.0)
    rf = h.mel_receptive_field()
    assert 0 < rf < 128
    hop = h.cfg.total_upsample
    mels = torch.randn(5, 140, 16, generator=torch.Generator().manual_seed(1))
    lsb = lambda a, b: int((a.long() - b.long()).abs().max())
    rows, cuts = [0, 2, 3], [20, 7, 38]
    alone = [cut_vocode(h, mels, [b], [c], vocode_bucket(h, c))[0, :c * hop]
             for b, c in zip(rows, cuts)]
    for Tb in (vocode_bucket(h, max(cuts)), 512):
        got = cut_vocode(h, mels, rows + [0], cuts + [0], Tb)
        assert got.dtype == torch.int16 and got.shape == (4, Tb * hop)
        for i, c in enumerate(cuts):
            assert lsb(got[i, :c * hop], alone[i]) <= 1, f"row {i} at Tb={Tb}"
        assert lsb(cut_vocode(h, mels, rows[:2], cuts[:2], Tb)[1, :cuts[1] * hop], alone[1]) <= 1
    cut = 126  # within the receptive field of the 128-frame bucket's end
    margin = cut_vocode(h, mels, [4], [cut], vocode_bucket(h, cut))[0, :cut * hop]
    no_margin = cut_vocode(h, mels, [4], [cut], 128)[0, :cut * hop]
    assert lsb(cut_vocode(h, mels, [4, 1], [cut, 9], 512)[0, :cut * hop], margin) <= 1
    assert lsb(no_margin, margin) > 100


# ---------------------------------------------------------------------------
# the server end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    raw = {
        "dataset": {"preprocessing": {"allowed_chars": LJ_CHARS, "end_token": "^",
                                      "num_mels": 16, "sample_rate": 22050, "trim": False}},
        "training": {"precision": "32-true", "batch_size": 2},
        "model": {"args": {"encoded_dim": 16, "encoder_kernel_size": 5, "prenet_dim": 8,
                           "att_rnn_dim": 16, "att_dim": 8, "rnn_hidden_dim": 16,
                           "postnet_dim": 8, "dropout": 0.5}},
        "extensions": {},
    }
    cfg_path = root / "cfg.json"
    cfg_path.write_text(json.dumps(raw))
    torch.manual_seed(0)
    model = Tacotron2(model_config_from(load_config(str(cfg_path))))
    with torch.no_grad():
        model.decoder.gate.bias.fill_(3.0)
    ckpt = root / "model.ckpt"
    torch.save(to_lightning(model.state_dict()), ckpt)
    hdir = root / "hifigan"
    hdir.mkdir()
    (hdir / "config.json").write_text(json.dumps(HIFIGAN))
    torch.manual_seed(1)
    g_path = hdir / "g_00000001"
    torch.save({"generator": HiFiGAN(HiFiGANConfig.from_dict(HIFIGAN)).state_dict()}, g_path)
    entry = {"name": "tiny", "config": str(cfg_path), "checkpoint": str(ckpt),
             "hifi_gan_checkpoint": str(g_path), "multi_speaker": False,
             "controllable": False, "num_voices": 1, "max_len": MAX_LEN}
    return {"models": [entry]}


class Client:
    def __init__(self, port):
        self.base = f"http://127.0.0.1:{port}"

    def get(self, path):
        with urllib.request.urlopen(self.base + path, timeout=60) as r:
            return r.status, r.read()

    def post(self, payload):
        req = urllib.request.Request(self.base + "/generate", json.dumps(payload).encode(),
                                     {"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def post_all(self, payloads):
        with concurrent.futures.ThreadPoolExecutor(len(payloads)) as ex:
            return list(ex.map(self.post, payloads))


@pytest.fixture
def serve(tmp_path, monkeypatch):
    """-> start(server_config, mode) -> Client; every server stops after."""
    monkeypatch.chdir(tmp_path)
    started = []

    def start(config, mode="warm"):
        httpd = srv.make_server(config, mode, device="cpu", host="127.0.0.1", port=0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        started.append((httpd, thread))
        return Client(httpd.server_address[1])

    yield start
    for httpd, thread in started:
        httpd.shutdown()
        httpd.app.close()
        httpd.server_close()
        thread.join(timeout=10)


def test_server_routes(files, serve, tmp_path):
    c = serve(files)
    status, body = c.get("/")
    assert status == 200 and b"Tacotron" in body
    status, body = c.get("/config")
    assert json.loads(body) == [{"name": "tiny", "multi_speaker": False,
                                 "controllable": False, "num_voices": 1}]
    status, body = c.post({"text": "hello server", "model": 0, "seed": 3})
    assert status == 200 and body["path"].endswith(".wav")
    assert body["filename"] == "/" + body["path"]
    assert (tmp_path / body["path"]).exists()
    assert (tmp_path / body["path"].replace(".wav", ".json")).exists()
    status, data = c.get(body["filename"])
    assert status == 200 and data[:4] == b"RIFF"
    wav, sr = read_wav(str(tmp_path / body["path"]))
    assert sr == 22050 and len(wav) == (MAX_LEN - 1) * 8  # cut n - 1, hop 8
    st = json.loads(c.get("/stats")[1])
    assert st["mode"] == "warm" and st["requests"] == {"ok": 1, "failed": 0}
    assert st["batching"]["decoded_rows"] >= 1 and st["models_loaded"] == [0]
    assert st["mesh_devices"] == 1


def test_server_warmup_loads_every_model(files, serve):
    config = dict(copy.deepcopy(files), warmup=True)
    config["models"].append(dict(config["models"][0], name="int8", quantize_int8=True))
    c = serve(config)
    st = json.loads(c.get("/stats")[1])
    assert st["models_loaded"] == [0, 1] and st["requests"] == {"ok": 0, "failed": 0}


def test_server_rejects_bad_requests(files, serve):
    c = serve(files)
    for payload, word in (({"text": "x", "model": 9}, "out of range"),
                          ({"text": "x", "model": "a"}, "integer"),
                          ({"text": "x", "model": 0, "seed": "abc"}, "seed"),
                          ({"text": "x", "model": 0, "voice": 1}, "single-speaker"),
                          ({"text": "x", "model": 0, "controls": [0.5]}, "controls")):
        status, body = c.post(payload)
        assert status == 400 and word in body["error"], (payload, body)
    st = json.loads(c.get("/stats")[1])
    assert st["requests"] == {"ok": 0, "failed": 5}


def test_server_coalesces_and_rows_keep_their_audio(files, serve, tmp_path):
    config = copy.deepcopy(files)
    config["batching"] = {"window_ms": 500, "max_batch": 8}
    c = serve(config)
    assert c.post({"text": "warm up", "model": 0, "seed": 1})[0] == 200
    texts = [("first request here", 5), ("a second one", 6), ("and the third", 7)]
    calls0, rows0 = srv.BATCH_CALLS
    replies = c.post_all([{"text": t, "model": 0, "seed": s} for t, s in texts])
    assert all(status == 200 for status, _ in replies)
    assert srv.BATCH_CALLS[0] - calls0 == 1, "the requests did not coalesce"
    assert srv.BATCH_CALLS[1] - rows0 == 3
    assert json.loads(c.get("/stats")[1])["batching"]["rows_per_launch"] > 1
    for (t, s), (_, body) in zip(texts, replies):
        status, solo = c.post({"text": t, "model": 0, "seed": s})
        a = read_wav(str(tmp_path / body["path"]))[0]
        b = read_wav(str(tmp_path / solo["path"]))[0]
        assert a.shape == b.shape
        assert np.abs(a - b).max() * 32768 <= 1, "a row's audio changed with its window"


@pytest.mark.parametrize("max_batch,rows", [(8, 8), (6, 8), (1, 1)])
def test_windows_encode_at_the_largest_window(files, serve, monkeypatch, max_batch, rows):
    """Every window's encoder runs ``max_batch`` rows rounded up to a power
    of two, whatever the window holds, so its bf16 products keep one shape."""
    seen = []
    encode = Tacotron2._encode

    def spy(self, chars_idx, chars_len, train=False, generator=None, rows=None, **kw):
        seen.append((chars_idx.shape[0], rows))
        return encode(self, chars_idx, chars_len, train, generator, rows, **kw)

    monkeypatch.setattr(Tacotron2, "_encode", spy)
    config = copy.deepcopy(files)
    config["batching"] = {"window_ms": 1, "max_batch": max_batch}
    c = serve(config)
    assert c.post({"text": "one request", "model": 0, "seed": 4})[0] == 200
    assert seen == [(1, rows)]


def test_server_bad_checkpoint_fails_only_its_requests(files, serve):
    config = copy.deepcopy(files)
    config["models"].append(dict(config["models"][0], name="broken",
                                 checkpoint="missing.ckpt"))
    c = serve(config)
    for _ in range(2):  # the worker of the broken model keeps serving
        status, body = c.post({"text": "x", "model": 1, "seed": 1})
        assert status == 500 and "missing.ckpt" in body["error"]
        assert c.post({"text": "fine", "model": 0, "seed": 1})[0] == 200


def test_server_int8_entry_packs_once(files, serve):
    config = copy.deepcopy(files)
    config["models"][0]["quantize_int8"] = True
    c = serve(config)
    base = decoder_loop.PACK_CALLS[0]
    assert c.post({"text": "first request", "model": 0, "seed": 5})[0] == 200
    assert decoder_loop.PACK_CALLS[0] == base + 1
    assert c.post({"text": "second one", "model": 0, "seed": 6})[0] == 200
    assert decoder_loop.PACK_CALLS[0] == base + 1


def test_server_griffin_lim_without_vocoder(files, serve, tmp_path):
    c = serve(files)
    replies = c.post_all([{"text": "no vocoder", "model": 0, "seed": 2, "use_vocoder": False},
                          {"text": "vocoder", "model": 0, "seed": 2}])
    (s1, gl), (s2, hifi) = replies
    assert s1 == s2 == 200
    cut = MAX_LEN - 1
    wav = read_wav(str(tmp_path / gl["path"]))[0]
    assert len(wav) == (cut - 1) * 256 and np.abs(wav).max() > 0  # Griffin-Lim's hop
    assert len(read_wav(str(tmp_path / hifi["path"]))[0]) == cut * 8


def test_server_subprocess_mode(files, serve, tmp_path):
    c = serve(files, mode="subprocess")
    status, body = c.post({"text": "subprocess mode", "model": 0, "seed": 1})
    assert status == 200, body
    assert (tmp_path / body["path"]).read_bytes()[:4] == b"RIFF"
    assert c.post({"text": "x", "model": 0, "voice": 2})[0] == 400


def test_close_fails_pending_requests(files):
    """Requests queued or in a window that is still running fail at once
    when the batcher closes, instead of leaving their handlers waiting."""
    registry = srv.ModelRegistry(files["models"], device="cpu")
    release = threading.Event()
    registry.load = lambda idx: release.wait(30)  # a load that hangs
    batcher = srv.MicroBatcher(registry, window_ms=1.0, max_batch=1, depth=1)
    futs = [batcher.submit(0, {"text": t, "out_path": "unused.wav"}) for t in ("a", "b", "c")]
    batcher.close()
    for fut in futs:
        with pytest.raises(RuntimeError, match="shutting down"):
            fut.result(timeout=5)
    with pytest.raises(RuntimeError, match="shutting down"):
        batcher.submit(0, {"text": "late"}).result(timeout=5)
    release.set()


def test_launch_counter_loses_no_counts():
    """Windows on several threads count launches through one lock."""
    import sys

    from tacotron2_tpu_torch.ops import build

    table = {"k": 0}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [build.count(table, "k", 3)
                                                    for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert table["k"] == 16 * 2000 * 3


def _extension_entry(files, tmp_path, extension):
    """The tiny entry's config and weights with 3 speakers or 5 controls."""
    entry = copy.deepcopy(files["models"][0])
    raw = json.loads(open(entry["config"]).read())
    raw["extensions"] = ({"speaker_tokens": {"active": True, "num_speakers": 3}}
                         if extension == "multi_speaker" else
                         {"controls": {"active": True, "features": list("abcde")}})
    cfg_path = tmp_path / f"{extension}.json"
    cfg_path.write_text(json.dumps(raw))
    torch.manual_seed(0)
    model = Tacotron2(model_config_from(load_config(str(cfg_path))))
    with torch.no_grad():
        model.decoder.gate.bias.fill_(3.0)
    ckpt = tmp_path / f"{extension}.ckpt"
    torch.save(to_lightning(model.state_dict()), ckpt)
    entry.update(name=extension, config=str(cfg_path), checkpoint=str(ckpt),
                 **{extension: True}, num_voices=3 if extension == "multi_speaker" else 1)
    return entry


@pytest.mark.parametrize("extension", ["multi_speaker", "controllable"])
def test_extension_entries_load_and_serve(files, extension, serve, tmp_path):
    """A multi-speaker and a controllable entry load, warm up (voice 0,
    neutral controls), show in /config and serve their requests: voices and
    controls change the audio, and a request of the other kind is a 400."""
    entry = _extension_entry(files, tmp_path, extension)
    c = serve({"models": [entry], "warmup": True})
    [desc] = json.loads(c.get("/config")[1])
    assert desc["name"] == extension and desc[extension] is True
    if extension == "multi_speaker":
        reqs = [{"text": "a voice", "model": 0, "seed": 3, "voice": v} for v in (0, 2)]
        bad = ({"text": "x", "model": 0, "voice": 3}, "out of range")
    else:
        reqs = [{"text": "a voice", "model": 0, "seed": 3, "controls": [v, 0, 0, -v, 1]}
                for v in (0.0, 2.0)]
        bad = ({"text": "x", "model": 0, "voice": 1, "controls": [0.0] * 5}, "single-speaker")
    wavs = []
    for req in reqs:
        status, body = c.post(req)
        assert status == 200, body
        wavs.append(read_wav(str(tmp_path / body["path"]))[0])
    assert wavs[0].shape == wavs[1].shape and np.abs(wavs[0] - wavs[1]).max() > 0
    status, body = c.post(bad[0])
    assert status == 400 and bad[1] in body["error"]
    st = json.loads(c.get("/stats")[1])
    assert st["models_loaded"] == [0] and st["requests"] == {"ok": 2, "failed": 1}


@pytest.mark.parametrize("extension", ["gst", "descriptions"])
def test_unported_extension_entries_are_refused(files, extension, tmp_path, monkeypatch):
    """An entry whose config has description embeddings (JAX's server passes
    no description, so such an entry would fail every request) stops the
    server at start, with a message that says why. A GST entry is accepted
    now (the name is kept from when it was refused): it loads with its
    neutral style, computed once, and a request's audio is the say's with
    the neutral style."""
    monkeypatch.chdir(tmp_path)
    config = copy.deepcopy(files)
    raw = json.loads(open(config["models"][0]["config"]).read())
    if extension == "gst":
        raw["extensions"] = {"gst": {"active": True, "token_embedding_size": 16}}
    else:
        raw["model"]["args"].update(description_embeddings=True, description_embeddings_dim=8)
    cfg_path = tmp_path / f"{extension}.json"
    cfg_path.write_text(json.dumps(raw))
    config["models"][0]["config"] = str(cfg_path)
    if extension != "gst":
        with pytest.raises(NotImplementedError, match="passes no description"):
            srv.App(config, device="cpu")
        return
    torch.manual_seed(0)
    model = Tacotron2(model_config_from(load_config(str(cfg_path))))
    with torch.no_grad():
        model.decoder.gate.bias.fill_(3.0)
    torch.save(to_lightning(model.state_dict()), tmp_path / "gst.ckpt")
    config["models"][0].update(checkpoint=str(tmp_path / "gst.ckpt"), max_len=40)
    app = srv.App(config, device="cpu")
    try:
        status, body = app.generate({"text": "a style", "seed": 5})
        assert status == 200, body
        bundle = app.registry.load(0)
        assert torch.equal(bundle.gst_embedding, model.gst.neutral()[:, 0])
    finally:
        app.close(wait=True)
    served = read_wav(str(tmp_path / body["path"]))[0]
    say = port_cli(["say", "--config", str(cfg_path), "--checkpoint", str(tmp_path / "gst.ckpt"),
                    "--text", "a style", "--out", str(tmp_path / "say.wav"), "--random-seed",
                    "5", "--max-len-override", "40", "--device", "cpu",
                    "--hifi-gan-checkpoint", config["models"][0]["hifi_gan_checkpoint"]])
    alone = read_wav(say["output"])[0]
    assert served.shape == alone.shape and np.abs(served - alone).max() <= 1 / 32768
