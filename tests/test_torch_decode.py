"""The port's decode (tacotron2_tpu_torch, plain versions on the CPU)
against two JAX functions on the same weights: ``Tacotron2.forward_infer``
(the XLA while_loop) and ``forward_infer_fused(..., interpret=True)``, the
function that reaches the fused Pallas decode kernel. Weights come from the
JAX ``init`` through ``convert.from_jax_params``; inputs from numpy.

Cases: no dropout (gate bias +3, every frame runs), dropout with the prenet
masks injected from ``FusedDecodeLoop._prenet_masks``, early stop (gate bias
-3, ``n_frames == 1``, mels 0 and gates -1000 past it), all at B=2 with a
padded second row, plus B=1. Tolerances are those of
tests/test_fused_decoder.py: n_frames and lengths exact, mels 2e-4,
mels_post 5e-4, gates 2e-3, aligns 1e-4."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from tacotron2_tpu.models.tacotron2 import Tacotron2Config as JaxConfig
from tacotron2_tpu.ops.decoder_loop_pallas import T_CHUNK, FusedDecodeLoop
from tacotron2_tpu_torch.convert import from_jax_params
from tacotron2_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config

torch.set_num_threads(1)

CFG = dict(
    num_chars=20, encoded_dim=64, encoder_kernel_size=5, num_mels=16,
    prenet_dim=32, att_rnn_dim=128, att_dim=32, rnn_hidden_dim=128,
    postnet_dim=16, dropout=0.5,
)
CASES = {  # name -> (gate bias, max_len, prenet dropout, batch)
    "no_dropout": (3.0, 80, False, 2),
    "dropout_masks": (3.0, 70, True, 2),
    "early_stop": (-3.0, 128, False, 2),
    "batch1": (3.0, 40, False, 1),
}


@functools.lru_cache(maxsize=None)
def _models(gate_bias):
    jm = JaxTacotron2(JaxConfig(**CFG))
    params, state = jm.init(jax.random.PRNGKey(0))
    params["decoder"]["gate"]["b"] = jnp.full_like(params["decoder"]["gate"]["b"], gate_bias)
    tm = Tacotron2(Tacotron2Config(**CFG))
    tm.load_state_dict(from_jax_params(params, state))
    return jm, params, state, tm.eval()


def _inputs(batch):
    rng = np.random.default_rng(0)
    chars = rng.integers(1, 21, size=(2, 9)).astype(np.int64)
    lens = np.array([9, 6], dtype=np.int64)
    chars[1, 6:] = 0
    return chars[:batch], lens[:batch]


def _jax_masks(rng, batch, max_len):
    """JAX's prenet masks for every frame, (T, B, P) x 2, drawn exactly as
    the fused kernel's driver draws them (bit-matching Tacotron2._prenet)."""
    pre_rng = jax.random.split(rng, 3)[2]
    loop = FusedDecodeLoop(num_mels=CFG["num_mels"], encoded_full_dim=CFG["encoded_dim"],
                           att_rnn_dim=CFG["att_rnn_dim"], prenet_dim=CFG["prenet_dim"],
                           att_dim=CFG["att_dim"], max_chars=9, batch=batch,
                           dropout=CFG["dropout"])
    m1s, m2s = [], []
    for t0 in range(0, max_len, T_CHUNK):
        m1, m2 = loop._prenet_masks(pre_rng, jnp.int32(t0), True)
        m1s.append(np.asarray(m1)[:, :batch])
        m2s.append(np.asarray(m2)[:, :batch])
    return (torch.as_tensor(np.concatenate(m1s)[:max_len]),
            torch.as_tensor(np.concatenate(m2s)[:max_len]))


def _compare(out, ref):
    assert int(out.n_frames) == int(ref.n_frames)
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    n = int(ref.n_frames)
    for name, atol in (("mels", 2e-4), ("mels_post", 5e-4), ("gates", 2e-3),
                       ("alignments", 1e-4)):
        np.testing.assert_allclose(getattr(out, name).numpy()[:, :n],
                                   np.asarray(getattr(ref, name))[:, :n], atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("jax_fn", ["forward_infer", "forward_infer_fused"])
@pytest.mark.parametrize("case", list(CASES))
def test_decode_matches_jax(case, jax_fn):
    gate_bias, max_len, dropout, batch = CASES[case]
    jm, params, state, tm = _models(gate_bias)
    chars, lens = _inputs(batch)
    rng = jax.random.PRNGKey(7)
    kw = {"interpret": True} if jax_fn == "forward_infer_fused" else {}
    ref = getattr(jm, jax_fn)(params, state, jnp.asarray(chars), jnp.asarray(lens), max_len,
                              rng=rng, prenet_dropout=dropout, **kw)
    masks = _jax_masks(rng, batch, max_len) if dropout else None
    out = tm.forward_infer_fast(torch.as_tensor(chars), torch.as_tensor(lens), max_len,
                                prenet_dropout=dropout, masks=masks)
    _compare(out, ref)
    if case == "early_stop":
        assert out.n_frames == 1
        assert not bool(out.mels[:, 1:].any())
        assert bool((out.gates[:, 1:] == -1000.0).all())


@pytest.mark.parametrize("case", ["dropout_masks", "early_stop"])
def test_fast_decode_equals_reference_decode(case):
    """The chunked decode (early stop checked once per 64 frames, then the
    step bookkeeping) equals the per-step reference decode of the port, with
    masks drawn from one generator seed in both."""
    gate_bias, max_len, dropout, batch = CASES[case]
    *_, tm = _models(gate_bias)
    chars, lens = (torch.as_tensor(a) for a in _inputs(batch))
    outs = []
    for fn in (tm.forward_infer, tm.forward_infer_fast):
        g = torch.Generator().manual_seed(3)
        outs.append(fn(chars, lens, max_len, generator=g, prenet_dropout=dropout))
    ref, fast = outs
    assert fast.n_frames == ref.n_frames
    assert torch.equal(fast.lengths, ref.lengths)
    for name in ("mels", "mels_post", "gates", "alignments"):
        torch.testing.assert_close(getattr(fast, name), getattr(ref, name), atol=1e-5, rtol=0)
