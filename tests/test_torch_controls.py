"""The port's controllable, multi-speaker serving path (speaker tokens and
the controls rows of kernels K1 and K5; plain versions on the CPU) against
the JAX package on the same weights, at tiny sizes.

Weights come from the JAX ``init`` at ``PRNGKey(0)`` with 3 speakers and 5
controls, as ``tests/test_fused_decoder.py::test_fused_with_controls_and_
speaker`` makes them, through ``convert.from_jax_params``.

- the pack: the port's bf16 and int8 packs equal JAX's
  ``pack_decoder_params(controls_dim=5)``: the decoder LSTM's controls
  columns padded to 16 with zeros, the heads' controls columns, the gate's
  zero there;
- the decode: B=2 with speakers 0 and 2, their own controls, a padded
  second row, 66 frames (past one 64-frame chunk), against JAX
  ``forward_infer_fused(interpret=True)`` in bf16 and int8 and JAX
  ``forward_infer_fast`` (on the CPU its XLA while_loop), with n_frames and
  lengths exact and the tolerances of tests/test_torch_decode.py (mels
  2e-4, mels_post 5e-4, gates 2e-3, aligns 1e-4); controls of about +-1 and
  of about +-3, larger than the state, so that int8's row scale is the
  controls'. Under ``32-true`` in every mode. Under ``bf16-mixed`` int8 at
  66 frames; bf16 over 24 frames: there the two frameworks' f32 sums differ
  by ~1e-8, and from about frame 16 a one-ulp flip of a bf16 operand that
  this tips is amplified by the recurrence, in the vanilla model too (its
  port reads 1.6e-4 mels_post and 1.9e-4 aligns against JAX at 66 frames,
  a case tests/test_torch_decode.py does not hold);
- ``quantize_xh_plain`` with the controls equals JAX's ``_quantize_xh`` on
  the concatenated row;
- the controls reach the mels and not the gate: the heads of one step with
  two control vectors give other mels and the same gate logits, bit for
  bit; two decodes other mels;
- launches: ``decode_chunk`` of a controllable pack (meta tensors, a fake
  library) counts 5 launches a step (7 in int8) and passes the controls'
  slots and columns;
- ``say --speaker-id --controls`` against JAX ``do_say``, and its refusals;
- the server's per-model request checks, and two controllable requests with
  other voices and controls sharing a window, each with its audio alone;
- ``model_config_from`` takes every model config in ``config/``, the
  description-embedding one too (since the port has BERT); ``train`` takes
  them too, the prosody-model ones only with a predictor's checkpoint (their
  style loss); a GST config too (its memory 256 columns wider, the neutral
  style one row for every row); the teacher pass refuses missing or mis-shaped speaker ids and
  controls.
"""

import copy
import dataclasses
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from run.say import do_say as jax_do_say
from tacotron2_tpu.config import load_config as jax_load_config
from tacotron2_tpu.models.layers import Policy as JaxPolicy
from tacotron2_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from tacotron2_tpu.models.tacotron2 import Tacotron2Config as JaxConfig
from tacotron2_tpu.ops.decoder_loop_pallas import pack_decoder_params
from tacotron2_tpu_torch.__main__ import main as port_cli
from tacotron2_tpu_torch.audio.io import read_wav
from tacotron2_tpu_torch.config import config_from_dict, load_config
from tacotron2_tpu_torch.convert import from_jax_params, to_lightning
from tacotron2_tpu_torch.models.layers import Policy
from tacotron2_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from tacotron2_tpu_torch.ops import decoder_loop as dl
from tacotron2_tpu_torch.run import server as srv
from tacotron2_tpu_torch.run.say import model_config_from
from tacotron2_tpu_torch.run.train import check_trainable
from tests.test_torch_decode import CFG, _inputs
from tests.test_torch_decode_cells import A, D, H, K, L, M, P, _meta, _meta_pack, fake  # noqa: F401
from tests.test_torch_say import _files as _say_files

torch.set_num_threads(1)

EXT = dict(speaker_tokens=True, num_speakers=3, controls=True, controls_dim=5)
SPEAKERS = np.array([0, 2])
DECODE_TOL = {"mels": 2e-4, "mels_post": 5e-4, "gates": 2e-3, "alignments": 1e-4}
CONFIG_DIR = Path(__file__).resolve().parents[1] / "config"


@functools.lru_cache(maxsize=None)
def _models(precision="32-true"):
    jm = JaxTacotron2(JaxConfig(**CFG, **EXT), JaxPolicy.from_string(precision))
    params, state = jm.init(jax.random.PRNGKey(0))
    params["decoder"]["gate"]["b"] = jnp.full_like(params["decoder"]["gate"]["b"], 3.0)
    tm = Tacotron2(Tacotron2Config(**CFG, **EXT), Policy.from_string(precision))
    tm.load_state_dict(from_jax_params(params, state))
    return jm, params, state, tm.eval()


def _controls(scale: float) -> np.ndarray:
    return (np.random.default_rng(3).uniform(-1, 1, size=(2, 5)) * scale).astype(np.float32)


def _models_vanilla_pack(quantize):
    from tests.test_torch_int8_decode import _models as vanilla

    return vanilla(3.0)[3].make_packed_decoder(quantize)


@pytest.mark.parametrize("quantize", [False, True])
def test_controls_pack_equals_jax(quantize):
    """JAX holds both LSTMs in one (R2, 8H) stream, gates as columns; the
    decoder LSTM's rows are [att_h | ctx | controls padded to 16 | rnn_h],
    and the heads' (H + D + 16, 128) has the gate's controls rows zero."""
    jm, params, _, tm = _models("bf16-mixed")
    H, D, P, M = CFG["att_rnn_dim"], CFG["encoded_dim"], CFG["prenet_dim"], CFG["num_mels"]
    jp = pack_decoder_params(params, M, D, H, H, P, 5, dtype=jnp.bfloat16, quantize=quantize,
                             resident_cols=0)
    pk = tm.make_packed_decoder(quantize)
    assert pk.controls_cols == 16
    as_np = lambda t: t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    ws = np.asarray(jp.w_stream.astype(jnp.float32) if not quantize else jp.w_stream)
    R1 = P + D + H
    np.testing.assert_array_equal(as_np(pk.w_att), ws[:R1, :4 * H].T)
    np.testing.assert_array_equal(as_np(pk.w_dec), ws[:, 4 * H:].T)
    assert pk.w_dec.shape == (4 * H, 2 * H + D + 16)
    assert not ws[H + D + 5:H + D + 16, 4 * H:].any()  # the controls' padding
    assert ws[H + D:H + D + 5, 4 * H:].any()
    if quantize:
        scales = np.asarray(jp.w_scales)[0]
        np.testing.assert_array_equal(pk.s_att.numpy(), scales[:4 * H])
        np.testing.assert_array_equal(pk.s_dec.numpy(), scales[4 * H:])
    w_out = np.asarray(jp.w_out.astype(jnp.float32))
    np.testing.assert_array_equal(as_np(pk.w_out), w_out[:, :M + 1].T)
    assert not as_np(pk.w_out)[M, H + D:].any()  # the gate reads [rnn_h | ctx]
    assert not as_np(pk.w_out)[:, H + D + 5:].any()
    np.testing.assert_array_equal(pk.b_out.numpy(), np.asarray(jp.b_out)[0, :M + 1])


def test_vanilla_pack_has_no_controls_columns():
    from tests.test_torch_int8_decode import _models as vanilla

    *_, tm = vanilla(3.0)
    for q in (False, True):
        pk = tm.make_packed_decoder(q)
        H, D = CFG["att_rnn_dim"], CFG["encoded_dim"]
        assert pk.controls_cols == 0 and pk.w_dec.shape[1] == 2 * H + D
        assert pk.w_out.shape[1] == H + D
        assert dl.stage_controls(pk, None, 2, "cpu") == (None, None)
        with pytest.raises(ValueError, match="no controls"):
            dl.stage_controls(pk, torch.zeros(2, 5), 2, "cpu")


# (JAX function, int8, controls scale, precision, frames)
DECODES = [(fn, q, scale, "32-true", 66) for fn, q in (("forward_infer_fused", False),
                                                       ("forward_infer_fused", True),
                                                       ("forward_infer_fast", False))
           for scale in (1.0, 3.0)] + [
    ("forward_infer_fused", True, 1.0, "bf16-mixed", 66),
    ("forward_infer_fused", True, 3.0, "bf16-mixed", 66),
    ("forward_infer_fused", False, 1.0, "bf16-mixed", 24),
    ("forward_infer_fused", False, 3.0, "bf16-mixed", 24),
]


@pytest.mark.parametrize("jax_fn,quantize,scale,precision,frames", DECODES)
def test_controls_decode_matches_jax(jax_fn, quantize, scale, precision, frames):
    jm, params, state, tm = _models(precision)
    chars, lens = _inputs(2)
    ctl = _controls(scale)
    kw = {"interpret": True, "quantize": quantize} if jax_fn == "forward_infer_fused" else {}
    ref = getattr(jm, jax_fn)(params, state, jnp.asarray(chars), jnp.asarray(lens), frames,
                              rng=jax.random.PRNGKey(7), prenet_dropout=False,
                              speaker_id=jnp.asarray(SPEAKERS), controls=jnp.asarray(ctl), **kw)
    out = tm.forward_infer_fast(torch.as_tensor(chars), torch.as_tensor(lens), frames,
                                prenet_dropout=False, quantize=quantize,
                                speaker_id=torch.as_tensor(SPEAKERS),
                                controls=torch.as_tensor(ctl))
    assert int(out.n_frames) == int(ref.n_frames) == frames
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    for name, atol in DECODE_TOL.items():
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=atol, rtol=0, err_msg=name)


def test_reference_decode_takes_the_controls():
    """The port's per-step reference decode (``Decoder.step``) equals its
    chunked decode with the same voices and controls."""
    *_, tm = _models()
    chars, lens = (torch.as_tensor(a) for a in _inputs(2))
    kw = dict(prenet_dropout=False, speaker_id=torch.as_tensor(SPEAKERS),
              controls=torch.as_tensor(_controls(3.0)))
    ref, fast = tm.forward_infer(chars, lens, 40, **kw), tm.forward_infer_fast(chars, lens, 40, **kw)
    assert fast.n_frames == ref.n_frames and torch.equal(fast.lengths, ref.lengths)
    for name in ("mels", "mels_post", "gates", "alignments"):
        torch.testing.assert_close(getattr(fast, name), getattr(ref, name), atol=1e-5, rtol=0)


def test_quantize_xh_plain_with_controls_equals_jax():
    """K5's operand of the decoder cell: the row's scale is over [att_h |
    ctx | controls | rnn_h], so controls of +-3 beside a state within +-1
    set it; as the JAX kernel's ``_quantize_xh`` on its xh."""
    g = np.random.default_rng(5)
    att_h, ctx, rnn_h = (g.uniform(-1, 1, size=(3, n)).astype(np.float32) for n in (32, 16, 32))
    ctl = np.zeros((3, 16), np.float32)
    ctl[:, :5] = g.uniform(-3, 3, size=(3, 5))
    q, sx = dl.quantize_xh_plain(*(torch.as_tensor(a) for a in (att_h, ctx, rnn_h)),
                                 ctl=torch.as_tensor(ctl))
    xh = jnp.concatenate([att_h, ctx, ctl, rnn_h], axis=1)
    jsx = jnp.maximum(jnp.max(jnp.abs(xh), axis=1, keepdims=True), 1e-12) / 127.0
    jq = jnp.clip(jnp.round(xh / jsx), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx)[:, 0])
    assert (np.abs(np.asarray(jq)[:, 48:53]) == 127).any(axis=1).all()  # the controls' max


def test_controls_reach_the_mels():
    """Two control vectors: other mels from the heads of one step (the
    plain heads through their wrapper) and from two decodes, in both
    packs."""
    *_, tm = _models()
    B, M = 2, CFG["num_mels"]
    g = torch.Generator().manual_seed(6)
    for q in (False, True):
        pk = tm.make_packed_decoder(q)
        rnn_h = torch.randn(B, CFG["att_rnn_dim"], generator=g)
        ctx = torch.randn(B, CFG["encoded_dim"], generator=g)
        (c1, _), (c2, _) = (dl.stage_controls(pk, torch.as_tensor(_controls(s)), B, "cpu")
                            for s in (1.0, -2.0))
        a, b = (dl.heads(pk.w_out, pk.b_out, rnn_h, ctx, c) for c in (c1, c2))
        assert (a[:, :M] - b[:, :M]).abs().max() > 1e-2
    chars, lens = (torch.as_tensor(x) for x in _inputs(2))
    runs = [tm.forward_infer_fast(chars, lens, 8, prenet_dropout=False,
                                  speaker_id=torch.as_tensor(SPEAKERS),
                                  controls=torch.as_tensor(_controls(s))) for s in (1.0, -2.0)]
    assert (runs[0].mels - runs[1].mels).abs().max() > 1e-2


def test_gate_ignores_the_controls_bit_for_bit():
    """The gate row's controls weights are zero, so its logit is the same
    sum whatever the controls, in both packs' heads."""
    *_, tm = _models("bf16-mixed")
    g = torch.Generator().manual_seed(7)
    M = CFG["num_mels"]
    for q in (False, True):
        pk = tm.make_packed_decoder(q)
        rnn_h, ctx = torch.randn(4, CFG["att_rnn_dim"], generator=g), torch.randn(
            4, CFG["encoded_dim"], generator=g)
        outs = [dl.heads_plain(pk.w_out, pk.b_out, rnn_h, ctx, dl.ACT_INT8 if q else None,
                               dl.stage_controls(pk, torch.full((4, 5), v), 4, "cpu")[0])
                for v in (0.0, 3.0, -1.5)]
        for o in outs[1:]:
            assert torch.equal(o[:, M], outs[0][:, M])
            assert not torch.equal(o[:, :M], outs[0][:, :M])


def test_stage_controls_pads_and_refuses():
    *_, tm = _models()
    for q in (False, True):
        pk = tm.make_packed_decoder(q)
        c32, cbf = dl.stage_controls(pk, torch.ones(3, 5), 3, "cpu")
        assert c32.shape == (3, 16) and c32.dtype == torch.float32
        assert torch.equal(c32[:, :5], torch.ones(3, 5)) and not c32[:, 5:].any()
        assert (cbf is None) if q else (cbf.dtype == torch.bfloat16 and torch.equal(
            cbf.float(), c32))
        with pytest.raises(ValueError, match="controls"):
            dl.stage_controls(pk, None, 3, "cpu")
        with pytest.raises(ValueError, match="controls"):
            dl.stage_controls(pk, torch.ones(3, 17), 3, "cpu")
    chars, lens = (torch.as_tensor(x) for x in _inputs(2))
    for bad, match in ((None, "no control vector"), (torch.ones(2, 4), "shape")):
        with pytest.raises(ValueError, match=match):
            tm.forward_infer_fast(chars, lens, 4, controls=bad,
                                  speaker_id=torch.as_tensor(SPEAKERS))
    with pytest.raises(ValueError, match="speaker_id"):
        tm.forward_infer_fast(chars, lens, 4, controls=torch.zeros(2, 5))
    with pytest.raises(ValueError, match="out of range"):
        tm.forward_infer_fast(chars, lens, 4, controls=torch.zeros(2, 5),
                              speaker_id=torch.tensor([0, 3]))
    for q in (False, True):
        with pytest.raises(ValueError, match="controls"):
            tm.forward_infer_fast(chars, lens, 4, speaker_id=torch.as_tensor(SPEAKERS),
                                  controls=torch.zeros(2, 5), packed=_models_vanilla_pack(q))


# ---------------------------------------------------------------------------
# what the chunk passes to the library (meta tensors, a fake library)
# ---------------------------------------------------------------------------

E = 16  # the controls columns of the meta packs


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("B,n", [(1, 64), (16, 4), (64, 1)])
def test_controls_chunk_counts_what_it_launches(fake, quantize, B, n):
    """A controllable pack's chunk launches what the vanilla one does, five
    kernels a step (seven in int8), and passes E = 16 and the staged
    controls (the f32 copy, and the bf16 operand in bf16 mode) in slots 44
    and 45; a missing one raises before anything launches."""
    pk = _meta_pack(quantize, E)
    assert pk.controls_cols == E
    s = dl.StepState(_meta(B, M), _meta(B, H), _meta(B, H), _meta(B, D), _meta(B, L),
                     _meta(B, L), _meta(B, H), _meta(B, H))
    args = (pk, _meta(B, L, D, dtype=torch.bfloat16), _meta(B, L, A),
            _meta(B, dtype=torch.int32), s, _meta(n, B, P), _meta(n, B, P))
    c32, cbf = torch.zeros(B, E), torch.zeros(B, E, dtype=torch.bfloat16)
    before, before_ctl = dict(dl.LAUNCHES), dict(dl.CONTROLS_LAUNCHES)
    with pytest.raises(ValueError, match="controls"):
        dl.decode_chunk(*args)
    assert dl.LAUNCHES == before and fake.calls == []
    dl.decode_chunk(*args, c32, None if quantize else cbf)
    grown = {k: dl.LAUNCHES[k] - before[k] for k in dl.LAUNCHES}
    assert sum(grown.values()) == (7 if quantize else 5) * n
    cell = "lstm_cell_int8" if quantize else "lstm_cell"
    assert grown[cell] == 2 * n
    # of those, the decoder cell (its quantize_xh) and the heads read the controls
    ctl = {k: dl.CONTROLS_LAUNCHES[k] - before_ctl[k] for k in dl.CONTROLS_LAUNCHES}
    assert ctl == {"lstm_cell": 0, "quantize_xh": 0, "lstm_cell_int8": 0, cell: n,
                   "heads": n, **({"quantize_xh": n} if quantize else {})}
    [(kind, ptrs, dims)] = fake.calls
    assert kind == "chunk" and dims[:2] == [n, B] and dims[9] == int(quantize)
    assert len(dims) == 12 and dims[11] == E
    assert ptrs[44] == c32.data_ptr()
    assert ptrs[45] == (None if quantize else cbf.data_ptr())


@pytest.mark.parametrize("quantize", [False, True])
def test_cell_wrappers_pass_the_controls(fake, quantize):
    B = 3
    pk = _meta_pack(quantize, E)
    ctl = torch.zeros(B, E)
    xs = (_meta(B, H), _meta(B, D), _meta(B, H))
    if quantize:
        dl.lstm_cell_int8(pk.w_dec, pk.s_dec, pk.b_dec, *xs, _meta(B, H), pk.wt_dec, ctl=ctl)
        (_, q_args), (_, c_args) = fake.calls
        assert q_args[4:6] == (ctl.data_ptr(), E)  # quantize_xh: [x1 | x2 | ctl | x3]
        assert c_args[5:9] == (H, D, E, H)
    else:
        dl.lstm_cell(pk.w_dec, pk.b_dec, *xs, _meta(B, H), pk.wt_dec, ctl=ctl.bfloat16())
        [(_, c_args)] = fake.calls
        assert c_args[7] == E and c_args[9] == H


def test_heads_wrapper_passes_the_controls(fake):
    B = 2
    pk = _meta_pack(False, E)
    ctl = torch.zeros(B, E)
    seen = []
    fake.t2_heads = lambda *a: seen.append(a) or 0
    dl.heads(pk.w_out, pk.b_out, _meta(B, H), _meta(B, D), ctl, wt=pk.wt_out)
    dl.heads(pk.w_out[:, :H + D], pk.b_out, _meta(B, H), _meta(B, D),
             wt=_meta(*dl.heads_tiled_shape(M + 1, H + D), dtype=torch.bfloat16))
    assert seen[0][6:8] == (ctl.data_ptr(), E) and seen[1][6:8] == (None, 0)


# ---------------------------------------------------------------------------
# say, the server, the configs
# ---------------------------------------------------------------------------

CONTROLS = "0.3,-0.5,0.1,0.8,-0.2"


def _controllable_files(tmp_path, gate_bias=3.0):
    """test_torch_say's tiny files with 3 speakers and 5 controls."""
    cfg_path, ckpt, g_path = _say_files(tmp_path, gate_bias)
    raw = json.loads(Path(cfg_path).read_text())
    raw["extensions"] = {"speaker_tokens": {"active": True, "num_speakers": 3},
                         "controls": {"active": True, "features": [f"c{i}" for i in range(5)]}}
    Path(cfg_path).write_text(json.dumps(raw))
    torch.manual_seed(2)
    model = Tacotron2(model_config_from(load_config(cfg_path)))
    with torch.no_grad():
        model.decoder.gate.bias.fill_(gate_bias)
    torch.save(to_lightning(model.state_dict()), ckpt)
    return cfg_path, ckpt, g_path


@pytest.mark.parametrize("quantize", [False, True])
def test_say_with_speaker_and_controls_matches_jax(tmp_path, quantize):
    cfg_path, ckpt, g_path = _controllable_files(tmp_path)
    out_port, out_jax = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    res = port_cli(["say", "--config", cfg_path, "--checkpoint", ckpt, "--hifi-gan-checkpoint",
                    g_path, "--text", "Hello there.", "--out", out_port, "--random-seed", "7",
                    "--max-len-override", "24", "--speaker-id", "2", "--controls", CONTROLS,
                    "--device", "cpu"] + (["--quantize-int8"] if quantize else []))
    jax_do_say(jax_load_config(cfg_path), 0, ckpt, "Hello there.", out_jax,
               hifi_gan_checkpoint=g_path, random_seed=7, max_len_override=24, speaker_id=2,
               controls=CONTROLS, quantize_int8=quantize)
    port_wav, jax_wav = read_wav(out_port)[0], read_wav(out_jax)[0]
    assert res["speaker_id"] == 2 and res["controls"] == pytest.approx(
        [float(x) for x in CONTROLS.split(",")])
    assert len(port_wav) == len(jax_wav) == 23 * 256
    lsb = np.abs(np.round(port_wav * 32768) - np.round(jax_wav * 32768)).max()
    assert lsb <= 2, f"PCM16 samples differ by {lsb} LSB"
    other = port_cli(["say", "--config", cfg_path, "--checkpoint", ckpt, "--hifi-gan-checkpoint",
                      g_path, "--text", "Hello there.", "--out", out_port, "--random-seed", "7",
                      "--max-len-override", "24", "--speaker-id", "0", "--controls", CONTROLS,
                      "--device", "cpu"])
    assert other["speaker_id"] == 0 and np.abs(read_wav(out_port)[0] - port_wav).max() > 0


@pytest.mark.parametrize("argv,match", [
    (["--controls", CONTROLS], "--speaker-id is required"),
    (["--speaker-id", "3", "--controls", CONTROLS], "out of range"),
    (["--speaker-id", "1", "--controls", "0.3,0.1"], "needs 5 numbers"),
    (["--speaker-id", "1"], "Controls are enabled"),
])
def test_say_refuses_missing_or_wrong_conditioning(tmp_path, argv, match):
    cfg_path, ckpt, _ = _controllable_files(tmp_path)
    with pytest.raises(ValueError, match=match):
        port_cli(["say", "--config", cfg_path, "--checkpoint", ckpt, "--text", "x", "--out",
                  str(tmp_path / "o.wav"), "--device", "cpu"] + argv)


def _raw_config(**ext):
    return {"dataset": {"preprocessing": {"allowed_chars": "abc ", "end_token": "^",
                                          "num_mels": 16}},
            "training": {"precision": "32-true"}, "model": {"args": {}}, "extensions": ext}


@pytest.mark.parametrize("req,match", [
    ({"controls": [0.1, 0.2]}, "must have 5 entries"),
    ({"controls": [0.1, "x", 0, 0, 0]}, "must be numbers"),
    ({"controls": "0.1"}, "must be a list"),
    ({}, "controls enabled"),
    ({"controls": [0.0] * 5, "speaker_id": 3}, "out of range"),
    ({"controls": [0.0] * 5, "speaker_id": -1}, "out of range"),
])
def test_validate_request_checks_against_the_model(req, match):
    cfg = config_from_dict(_raw_config(
        speaker_tokens={"active": True, "num_speakers": 3},
        controls={"active": True, "features": [f"c{i}" for i in range(5)]}))
    with pytest.raises(ValueError, match=match):
        srv.validate_request(cfg, dict(req))
    ok = {"controls": [1, "2", 0, 0, 0], "speaker_id": 2}
    srv.validate_request(cfg, ok)
    assert ok["controls"] == [1.0, 2.0, 0.0, 0.0, 0.0]
    vanilla = config_from_dict(_raw_config())
    for bad, word in (({"controls": [0.5]}, "controls disabled"),
                      ({"speaker_id": 1}, "single-speaker")):
        with pytest.raises(ValueError, match=word):
            srv.validate_request(vanilla, bad)
    srv.validate_request(vanilla, {"speaker_id": 0})


def test_controllable_rows_keep_their_audio(tmp_path, monkeypatch):
    """Two requests with other voices and controls (and a third by the
    reference page's named sliders) share one window; each row's audio
    equals its audio alone, and the voices and controls change it."""
    from tests.test_torch_serve import Client
    import threading

    cfg_path, ckpt, g_path = _controllable_files(tmp_path)
    monkeypatch.chdir(tmp_path)
    entry = {"name": "ctl", "config": cfg_path, "checkpoint": ckpt, "hifi_gan_checkpoint": g_path,
             "multi_speaker": True, "controllable": True, "num_voices": 3, "max_len": 12}
    config = {"models": [entry], "batching": {"window_ms": 500, "max_batch": 8}, "warmup": True}
    httpd = srv.make_server(config, "warm", device="cpu", host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        c = Client(httpd.server_address[1])
        reqs = [{"text": "first voice", "model": 0, "seed": 5, "voice": 0,
                 "controls": [0.5, -1.0, 0.2, 3.0, 0.0]},
                {"text": "first voice", "model": 0, "seed": 5, "speaker": 2,
                 "controls": [-2.0, 0.5, 1.0, -0.3, 0.7]},
                {"text": "sliders", "model": 0, "seed": 6, "voice": 1, "pitch": 1.5,
                 "rate": "-0.5"}]
        calls0, rows0 = srv.BATCH_CALLS
        replies = c.post_all(reqs)
        assert all(status == 200 for status, _ in replies), replies
        assert srv.BATCH_CALLS[0] - calls0 == 1 and srv.BATCH_CALLS[1] - rows0 == 3
        wavs = [read_wav(str(tmp_path / body["path"]))[0] for _, body in replies]
        for req, wav in zip(reqs, wavs):
            status, solo = c.post(req)
            assert status == 200
            alone = read_wav(str(tmp_path / solo["path"]))[0]
            assert alone.shape == wav.shape
            assert np.abs(alone - wav).max() * 32768 <= 1, "a row's audio changed with its window"
        assert np.abs(wavs[0] - wavs[1]).max() > 0
        status, body = c.post({"text": "x", "model": 0, "voice": 1, "controls": [0.1]})
        assert status == 400 and "5 entries" in body["error"]
        status, body = c.post({"text": "x", "model": 0, "voice": 1})
        assert status == 400 and "controls enabled" in body["error"]
    finally:
        httpd.shutdown()
        httpd.app.close()
        httpd.server_close()
        thread.join(timeout=10)


MODEL_CONFIGS = sorted(p.name for p in CONFIG_DIR.glob("*.json")
                       if p.name not in ("server.json", "descriptions-libritts.json"))


def test_model_configs_are_fifteen():
    assert len(MODEL_CONFIGS) == 15


@pytest.mark.parametrize("name", MODEL_CONFIGS)
def test_model_config_from_accepts(name):
    cfg = load_config(str(CONFIG_DIR / name))
    mc = model_config_from(cfg)
    ext = cfg.extensions
    assert mc.speaker_tokens == ext.speaker_tokens.active
    assert mc.num_speakers == ext.speaker_tokens.num_speakers
    assert mc.controls == ext.controls.active and mc.controls_dim == cfg.controls_dim
    if ext.prosody_model.active:  # trained with its predictor's checkpoint only
        with pytest.raises(ValueError, match="no prosody model checkpoint"):
            check_trainable(cfg)
        check_trainable(cfg, "prosody_final.ckpt")
    else:
        check_trainable(cfg)


@pytest.mark.parametrize("raw", [
    _raw_config(gst={"active": True}),
    dict(_raw_config(), model={"args": {"description_embeddings": True,
                                        "description_embeddings_dim": 8}}),
])
def test_gst_and_descriptions_are_refused(raw):
    """GST and description embeddings are both accepted now (the port has
    the GST and BERT; this test's name is kept from when both were
    refused): a GST model's memory is 256 columns wider and it decodes with
    the neutral style, one row of it for every row of a batch."""
    cfg = config_from_dict(copy.deepcopy(raw))
    if cfg.extensions.gst.active:
        mc = model_config_from(cfg)
        assert mc.gst and mc.gst_token_embedding_size == 256
        assert mc.encoded_full_dim == mc.encoded_dim + 256
        check_trainable(cfg)
        model = Tacotron2(dataclasses.replace(mc, encoded_dim=16, prenet_dim=8, att_rnn_dim=16,
                                              att_dim=8, rnn_hidden_dim=16, postnet_dim=8))
        neutral = model.gst_embedding(3)
        assert neutral.shape == (3, 256) and torch.equal(neutral[0], neutral[2])
        assert torch.equal(neutral[:1], model.gst.neutral()[:, 0])
        return
    mc = model_config_from(cfg)
    assert mc.description_embeddings and mc.description_embeddings_dim == 8
    assert mc.encoded_full_dim == mc.encoded_dim + 128
    check_trainable(cfg)


def test_descriptions_config_is_refused():
    """``descriptions-libritts.json`` is accepted now (the name is kept from
    when it was refused): 562 voices, a 768-wide description, D = 640."""
    cfg = load_config(str(CONFIG_DIR / "descriptions-libritts.json"))
    mc = model_config_from(cfg)
    assert (mc.speaker_tokens, mc.num_speakers) == (True, 562)
    assert (mc.description_embeddings, mc.description_embeddings_dim) == (True, 768)
    assert mc.encoded_full_dim == 640
    check_trainable(cfg)


def test_teacher_pass_refuses_the_extensions():
    """The teacher pass of a multi-speaker, controllable model wants both
    conditionings, each of the batch's shape."""
    *_, tm = _models()
    chars, lens = (torch.as_tensor(a) for a in _inputs(2))
    args = (chars, lens, torch.zeros(2, 4, CFG["num_mels"]), torch.tensor([4, 4]))
    spk, ctl = torch.tensor([0, 2]), torch.as_tensor(_controls(1.0))
    for kw, match in ((dict(controls=ctl), "speaker_id tensor required"),
                      (dict(speaker_id=spk), "no control vector"),
                      (dict(speaker_id=spk, controls=ctl[:1]), "shape"),
                      (dict(speaker_id=spk[:1], controls=ctl), "speaker ids")):
        with pytest.raises(ValueError, match=match):
            tm.forward_teacher(*args, **kw)


def test_subprocess_mode_passes_voice_and_controls(tmp_path, monkeypatch):
    """Subprocess mode hands a request's voice and controls (a negative
    first one too) to ``say``'s ``--speaker-id`` and ``--controls``."""
    from tests.test_torch_serve import Client
    import threading

    cfg_path, ckpt, g_path = _controllable_files(tmp_path)
    monkeypatch.chdir(tmp_path)
    entry = {"name": "ctl", "config": cfg_path, "checkpoint": ckpt, "hifi_gan_checkpoint": g_path,
             "multi_speaker": True, "controllable": True, "num_voices": 3, "max_len": 8}
    httpd = srv.make_server({"models": [entry]}, "subprocess", device="cpu", host="127.0.0.1",
                            port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        c = Client(httpd.server_address[1])
        status, body = c.post({"text": "sub", "model": 0, "seed": 1, "voice": 2,
                               "controls": [-0.5, 0.25, 1.0, 0.0, 2.0]})
        assert status == 200, body
        assert (tmp_path / body["path"]).read_bytes()[:4] == b"RIFF"
        assert c.post({"text": "x", "model": 0, "voice": 2})[0] == 400
    finally:
        httpd.shutdown()
        httpd.app.close()
        httpd.server_close()
        thread.join(timeout=10)
