"""The port's int8 decode (``pack_decoder(quantize=True)``, kernel K5's plain
version on the CPU) against the JAX package's int8 mode of the fused decode,
``forward_infer_fused(quantize=True, interpret=True)``, which reaches the
Pallas kernel ``_decode_chunk_kernel`` with int8 weights.

- the int8 pack equals ``pack_decoder_params(quantize=True)`` exactly;
- the decode equals JAX's, n_frames and lengths exactly, in the cases of
  tests/test_torch_decode.py (B=2 with a padded row, dropout with JAX's
  masks injected, early stop, B=1):
  - under ``32-true`` at that file's tolerances (mels 2e-4, mels_post 5e-4,
    gates 2e-3, aligns 1e-4; readings <= 3.1e-6). The JAX kernel takes
    every product outside the LSTM cells with bf16 activations whatever the
    policy (its prenet and heads weights stay in the policy's type, the
    attention's go bf16, the query rounds to bf16), and so does the port;
  - under ``bf16-mixed`` at the same tolerances. Readings: mels 1.8e-5,
    mels_post 6.1e-5, gates 3.6e-6, aligns 5.1e-7, now that the port's
    encoder rounds as JAX's under this policy (its BiLSTM's operands and its
    convs' sums to bf16). Before, the encoder's output differed by 1.6e-4,
    the int8 rounding boundaries turned that into steps of one quantum
    (mels 3.4e-4, aligns 2.0e-4), and mels and aligns were held only to
    5e-4 and 4e-4;
- the int8 mode stays within the JAX package's gate of the f32 decode
  (``tests/test_fused_decoder.py::test_fused_int8_close_to_f32``): mean
  relative mels_post error < 1%, gate drift < 0.05;
- K5's wrapper refuses a tensor that is not on the CPU instead of running
  its plain version.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.models.layers import Policy as JaxPolicy
from tacotron2_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from tacotron2_tpu.models.tacotron2 import Tacotron2Config as JaxConfig
from tacotron2_tpu.ops.decoder_loop_pallas import pack_decoder_params
from tacotron2_tpu_torch.convert import from_jax_params
from tacotron2_tpu_torch.models.layers import Policy
from tacotron2_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from tacotron2_tpu_torch.ops import decoder_loop
from tests.test_torch_decode import CASES, CFG, _inputs, _jax_masks

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _models(gate_bias, precision="bf16-mixed"):
    jm = JaxTacotron2(JaxConfig(**CFG), JaxPolicy.from_string(precision))
    params, state = jm.init(jax.random.PRNGKey(0))
    params["decoder"]["gate"]["b"] = jnp.full_like(params["decoder"]["gate"]["b"], gate_bias)
    tm = Tacotron2(Tacotron2Config(**CFG), Policy.from_string(precision))
    tm.load_state_dict(from_jax_params(params, state))
    return jm, params, state, tm.eval()


def test_int8_pack_equals_jax():
    """The JAX pack holds both LSTMs in one (R2, 8H) stream, gates as
    columns: the attention LSTM's rows zero-padded from R1 to R2, the
    decoder LSTM's with 16 zero rows for the controls after [att_h | ctx].
    Both quantise from the f32 weights, one scale per gate."""
    jm, params, _, tm = _models(3.0)
    H, D, P = CFG["att_rnn_dim"], CFG["encoded_dim"], CFG["prenet_dim"]
    jp = pack_decoder_params(params, CFG["num_mels"], D, H, H, P, 0, quantize=True,
                             resident_cols=0)
    pk = tm.make_packed_decoder(quantize=True)
    ws = np.asarray(jp.w_stream)
    assert ws.dtype == np.int8 and pk.w_att.dtype == torch.int8 and pk.w_dec.dtype == torch.int8
    R1 = P + D + H
    att, dec = ws[:, :4 * H], ws[:, 4 * H:]
    np.testing.assert_array_equal(pk.w_att.numpy(), att[:R1].T)
    assert not att[R1:].any()
    E = 16  # the controls rows, zero for the vanilla model
    np.testing.assert_array_equal(pk.w_dec.numpy(),
                                  np.concatenate([dec[:H + D], dec[H + D + E:]]).T)
    assert not dec[H + D:H + D + E].any()
    scales = np.asarray(jp.w_scales)[0]
    np.testing.assert_array_equal(pk.s_att.numpy(), scales[:4 * H])
    np.testing.assert_array_equal(pk.s_dec.numpy(), scales[4 * H:])
    for name in ("wp1_t", "wp2_t", "wq", "w_loc", "wv", "w_out"):
        assert getattr(pk, name).dtype == torch.bfloat16, name


DECODE_TOL = {"mels": 2e-4, "mels_post": 5e-4, "gates": 2e-3, "alignments": 1e-4}


def _compare(out, ref, tol):
    assert int(out.n_frames) == int(ref.n_frames)
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    n = int(ref.n_frames)
    for name, atol in tol.items():
        np.testing.assert_allclose(getattr(out, name).numpy()[:, :n],
                                   np.asarray(getattr(ref, name))[:, :n], atol=atol,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("precision", ["bf16-mixed", "32-true"])
@pytest.mark.parametrize("case", list(CASES))
def test_int8_decode_matches_jax(case, precision):
    gate_bias, max_len, dropout, batch = CASES[case]
    jm, params, state, tm = _models(gate_bias, precision)
    chars, lens = _inputs(batch)
    rng = jax.random.PRNGKey(7)
    ref = jm.forward_infer_fused(params, state, jnp.asarray(chars), jnp.asarray(lens), max_len,
                                 rng=rng, prenet_dropout=dropout, interpret=True, quantize=True)
    masks = _jax_masks(rng, batch, max_len) if dropout else None
    out = tm.forward_infer_fast(torch.as_tensor(chars), torch.as_tensor(lens), max_len,
                                prenet_dropout=dropout, masks=masks, quantize=True)
    _compare(out, ref, DECODE_TOL)


def test_int8_close_to_f32_decode():
    """The JAX package's gate on the int8 mode, on the port alone."""
    *_, tm = _models(3.0, "32-true")
    chars, lens = (torch.as_tensor(a) for a in _inputs(2))
    ref = tm.forward_infer(chars, lens, 70, prenet_dropout=False)
    q = tm.forward_infer_fast(chars, lens, 70, prenet_dropout=False, quantize=True)
    assert q.n_frames == ref.n_frames
    n = ref.n_frames
    a, b = ref.mels_post[:, :n], q.mels_post[:, :n]
    rel = float((a - b).abs().mean() / a.abs().mean().clamp_min(1e-9))
    assert rel < 0.01, f"int8 divergence {rel:.3%}"
    drift = float((ref.gates[:, :n] - q.gates[:, :n]).abs().max())
    assert drift < 0.05, f"int8 gate drift {drift}"


def test_packed_decoder_carries_its_mode():
    """A pack made once decodes as the per-call pack of its mode."""
    *_, tm = _models(3.0)
    chars, lens = (torch.as_tensor(a) for a in _inputs(2))
    pk = tm.make_packed_decoder(quantize=True)
    a = tm.forward_infer_fast(chars, lens, 20, prenet_dropout=False, packed=pk)
    b = tm.forward_infer_fast(chars, lens, 20, prenet_dropout=False, quantize=True)
    assert torch.equal(a.mels_post, b.mels_post)


def test_quantize_rows_rounds_half_to_even():
    x = torch.tensor([[127.0, 2.5, -2.5, 3.5, 0.5, -127.0]])
    q, sx = decoder_loop.quantize_rows(x)
    assert float(sx) == 1.0
    assert q.tolist() == [[127.0, 2.0, -2.0, 4.0, 0.0, -127.0]]
    w, s = decoder_loop.quantize_weights(torch.tensor([[254.0, 1.0, -3.0], [0.0, 0.0, 0.0]]))
    assert w.tolist() == [[127, 0, -2], [0, 0, 0]] and s.tolist()[1] == pytest.approx(1e-12)


def test_int8_cell_refuses_non_cpu_tensors(monkeypatch):
    """A CUDA request (here a tensor on the meta device, as no card is
    present) goes to the kernel path, which raises; the plain version is
    not reached and no launch is counted."""
    def plain_called(*a, **k):
        raise AssertionError("plain version reached with a non-CPU tensor")

    monkeypatch.setattr(decoder_loop, "lstm_cell_int8_plain", plain_called)
    meta = lambda *s, dtype=torch.float32: torch.empty(*s, device="meta", dtype=dtype)
    before = dict(decoder_loop.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        decoder_loop.lstm_cell_int8(meta(64, 32, dtype=torch.int8), meta(64), meta(64),
                                    meta(1, 8), meta(1, 8), meta(1, 16), meta(1, 16))
    assert decoder_loop.LAUNCHES == before
