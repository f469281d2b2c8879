"""Tacotron 2 models whose two decoder LSTMs differ in width (``att_rnn_dim
!= rnn_hidden_dim``), on the CPU, against the JAX package.

JAX runs such a model where its XLA routes take it: ``forward_infer_fast``
sends it to the XLA ``forward_infer`` (``fused_ok`` false), which ``say``,
``test``, ``test_correlation`` and the server run; ``forward_teacher(train=
False)`` (``train_mel_export``, validation) runs its XLA scan. Its train
step (``forward_teacher(dw_hoist=True)``) draws both LSTM masks at att_h's
shape and fails, and its int8 pack asserts one width. The port takes the
same routes on stock ops (``Tacotron2.forward_infer``, ``ops/train_scan.py``
with the two widths apart) and raises ValueError where JAX fails.

Widths 48 and 32 (JAX's probe), other dims small; dropout off in the
compared passes (the frameworks' random bits differ); weights from JAX's
``init`` through ``convert.from_jax_params``; inputs from numpy.
"""

import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.models.layers import Policy as JaxPolicy
from tacotron2_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from tacotron2_tpu.models.tacotron2 import Tacotron2Config as JaxConfig
from tacotron2_tpu_torch.config import load_config
from tacotron2_tpu_torch.convert import from_jax_params
from tacotron2_tpu_torch.models import tacotron2 as t2
from tacotron2_tpu_torch.models.layers import Policy
from tacotron2_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from tacotron2_tpu_torch.ops import decoder_loop, train_decode, train_scan
from tacotron2_tpu_torch.run.train import check_trainable

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
H1, H2 = 48, 32
CFG = dict(num_chars=20, encoded_dim=32, encoder_kernel_size=5, num_mels=16, prenet_dim=16,
           att_rnn_dim=H1, att_dim=16, rnn_hidden_dim=H2, postnet_dim=16, dropout=0.0)
POLICIES = ["32-true", "bf16-mixed"]
# f32: tests/test_torch_decode.py's tolerances (the XLA while_loop's)
F32_TOL = {"mels": 2e-4, "mels_post": 5e-4, "gates": 2e-3, "alignments": 1e-4}


@functools.lru_cache(maxsize=None)
def _models(policy: str, gate_bias: float):
    jm = JaxTacotron2(JaxConfig(**CFG), JaxPolicy.from_string(policy))
    params, state = jm.init(jax.random.PRNGKey(0))
    params["decoder"]["gate"]["b"] = jnp.full_like(params["decoder"]["gate"]["b"], gate_bias)
    tm = Tacotron2(Tacotron2Config(**CFG), Policy.from_string(policy))
    tm.load_state_dict(from_jax_params(params, state))
    return jm, params, state, tm.eval()


def _chars():
    rng = np.random.default_rng(0)
    chars = rng.integers(1, 21, size=(2, 9)).astype(np.int64)
    chars[1, 6:] = 0
    return chars, np.array([9, 6], dtype=np.int64)


@functools.lru_cache(maxsize=None)
def _jax_decode(policy: str, gate_bias: float, max_len: int):
    jm, params, state, _ = _models(policy, gate_bias)
    chars, lens = _chars()
    return jm.forward_infer_fast(params, state, jnp.asarray(chars), jnp.asarray(lens), max_len,
                                 rng=jax.random.PRNGKey(7), prenet_dropout=False)


def _close(got, ref, atol, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol, rtol=0, err_msg=what)


@pytest.mark.parametrize("gate_bias,max_len", [(3.0, 40), (-3.0, 64)])
@pytest.mark.parametrize("policy", POLICIES)
def test_decode_matches_jax(policy, gate_bias, max_len, monkeypatch):
    """``forward_infer_fast`` (what ``say``, ``test``, ``test_correlation``
    and the server call) runs ``forward_infer`` on stock ops, counted as
    ``decode_stock``, never K1's decode, against JAX's ``forward_infer_fast``
    (its XLA ``forward_infer`` here): every frame run (gate bias +3) and an
    early stop (-3, one frame). Steps and lengths exact; f32 within
    tests/test_torch_decode.py's tolerances; bf16 within the distance of
    JAX's own bf16 decode from its f32 decode, plus 1e-6."""
    monkeypatch.setattr(decoder_loop, "decode", lambda *a, **k: pytest.fail("K1's decode"))
    ref = _jax_decode(policy, gate_bias, max_len)
    *_, tm = _models(policy, gate_bias)
    chars, lens = _chars()
    before = t2.STOCK_ROUTES["decode_stock"]
    out = tm.forward_infer_fast(torch.as_tensor(chars), torch.as_tensor(lens), max_len,
                                prenet_dropout=False)
    assert t2.STOCK_ROUTES["decode_stock"] == before + 1
    assert int(out.n_frames) == int(ref.n_frames) == (max_len if gate_bias > 0 else 1)
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    n = int(ref.n_frames)
    for name, tol in F32_TOL.items():
        r = np.asarray(getattr(ref, name))[:, :n]
        if policy != "32-true":
            gap = np.abs(r - np.asarray(getattr(_jax_decode("32-true", gate_bias, max_len),
                                                name))[:, :n]).max()
            tol = float(gap) + 1e-6
        _close(getattr(out, name)[:, :n], r, tol, name)


@functools.lru_cache(maxsize=None)
def _jax_teacher(policy: str):
    jm, params, state, _ = _models(policy, 0.0)
    b = _batch()
    return jm.forward_teacher(params, state, *(jnp.asarray(x) for x in b),
                              rng=jax.random.PRNGKey(3), train=False)[0]


def _batch():
    r = np.random.default_rng(1)
    chars, lens = _chars()
    mel = (r.standard_normal((2, 20, 16)) * 0.5).astype(np.float32)
    mel[1, 14:] = 0.0
    return chars, lens, mel, np.array([20, 14])


@pytest.mark.parametrize("policy", POLICIES)
def test_teacher_eval_matches_jax(policy, monkeypatch):
    """``forward_teacher(train=False)`` (``train_mel_export``, validation)
    on the stock-op scan, counted as ``teacher_scan``, never K3 (its masks
    ones at each cell's width, H1 and H2 apart in ``teacher_steps``),
    against JAX's ``forward_teacher(train=False)``: f32 within 3e-5 of each
    output's max (tests/test_torch_training.py's), bf16 within the distance
    of JAX's bf16 pass from its f32 pass, plus 1e-6."""
    monkeypatch.setattr(train_decode, "teacher_decode", lambda *a, **k: pytest.fail("K3"))
    *_, tm = _models(policy, 0.0)
    before = train_scan.STOCK_ROUTES["teacher_scan"]
    with torch.no_grad():
        out = tm.forward_teacher(*(torch.as_tensor(x) for x in _batch()), train=False)
    assert train_scan.STOCK_ROUTES["teacher_scan"] == before + 1
    ref = _jax_teacher(policy)
    for name in ("mels", "mels_post", "gates", "alignments"):
        r = np.asarray(getattr(ref, name))
        if policy == "32-true":
            tol = 3e-5 * float(np.abs(r).max()) + 1e-6
        else:
            tol = float(np.abs(r - np.asarray(getattr(_jax_teacher("32-true"), name))).max()) + 1e-6
        _close(getattr(out, name), r, tol, name)


@pytest.mark.parametrize("policy", POLICIES)
def test_train_step_raises_in_both(policy):
    """A train step: JAX's ``forward_teacher(train=True, dw_hoist=True)`` (its
    step's) fails on the masks' widths; the port's ``forward_teacher(train=
    True)`` and ``train``'s check at start raise ValueError naming it."""
    jm, params, state, tm = _models(policy, 0.0)
    b = _batch()
    with pytest.raises(TypeError):
        jm.forward_teacher(params, state, *(jnp.asarray(x) for x in b),
                           rng=jax.random.PRNGKey(3), train=True, dw_hoist=True)
    with pytest.raises(ValueError, match="att_rnn_dim .48. and rnn_hidden_dim .32. differ"):
        tm.forward_teacher(*(torch.as_tensor(x) for x in b), train=True)
    cfg = load_config(str(ROOT / "config" / "vanilla-ljspeech-stop.json"))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, rnn_hidden_dim=768))
    with pytest.raises(ValueError, match="train step"):
        check_trainable(cfg)


def test_int8_raises_in_both():
    """The int8 decode packs both cells at one width: JAX's
    ``make_packed_decoder(quantize=True)`` asserts, the port's raises
    ValueError, and so does ``forward_infer_fast(quantize=True)``; without
    ``quantize`` the port packs nothing (the stock decode takes no pack),
    and a pack passed in is refused."""
    jm, params, state, tm = _models("bf16-mixed", 3.0)
    with pytest.raises(AssertionError):
        jm.make_packed_decoder(params, quantize=True)
    with pytest.raises(ValueError, match="differ"):
        tm.make_packed_decoder(True)
    assert tm.make_packed_decoder(False) is None
    chars, lens = (torch.as_tensor(a) for a in _chars())
    with pytest.raises(ValueError, match="differ"):
        tm.forward_infer_fast(chars, lens, 8, quantize=True)
    even = Tacotron2(Tacotron2Config(**{**CFG, "rnn_hidden_dim": H1}))
    with pytest.raises(ValueError, match="differ"):
        tm.forward_infer_fast(chars, lens, 8, packed=even.make_packed_decoder(False))


def test_served_rows_equal_alone():
    """The server's call (``row_generators``, ``encode_rows``) on the stock
    decode: each row's prenet masks from its own generator (JAX
    ``row_rngs``), so a row of a 3-row window with dropout on equals the
    row decoded alone with its seed."""
    tm = Tacotron2(Tacotron2Config(**{**CFG, "dropout": 0.5}))
    tm.load_state_dict(_models("32-true", 3.0)[3].state_dict())
    tm.eval()
    rng = np.random.default_rng(4)
    chars = torch.as_tensor(rng.integers(1, 21, size=(3, 9)))
    lens = torch.tensor([9, 7, 5])
    gens = lambda seeds: [torch.Generator().manual_seed(s) for s in seeds]
    seeds = (11, 12, 13)
    batch = tm.forward_infer_fast(chars, lens, 24, row_generators=gens(seeds), encode_rows=4)
    for r in range(3):
        alone = tm.forward_infer_fast(chars[r:r + 1], lens[r:r + 1], 24,
                                      row_generators=gens(seeds[r:r + 1]), encode_rows=4)
        for name in ("mels_post", "gates", "alignments"):
            torch.testing.assert_close(getattr(batch, name)[r:r + 1], getattr(alone, name),
                                       atol=1e-5, rtol=0)


@pytest.mark.parametrize("controls_dim,E", [(0, 0), (5, 16)])
def test_packed_dims_take_the_widths_apart(controls_dim, E):
    """``packed_dims`` of the decoder's packed weights: (H1, H2, E), the
    controls' columns E padded to a multiple of 16 beyond [att_h | ctx |
    rnn_h]; with a model group of 2 its cells' rows are a rank's half."""
    cfg = Tacotron2Config(**{**CFG, "controls": controls_dim > 0, "controls_dim": controls_dim})
    tm = Tacotron2(cfg)
    named = dict(tm.decoder.named_parameters())
    params = [named[k] for k in train_decode.DECODER_PARAMS]
    w = train_decode.pack_weights(params, torch.float32, controls_dim)
    assert train_decode.packed_dims(w, CFG["encoded_dim"]) == (H1, H2, E)

    class Group:
        n = 2

    half = w._replace(w2=w.w2[:2 * H2])
    assert train_decode.packed_dims(half, CFG["encoded_dim"], Group()) == (H1, H2, E)
