"""The port's ``EmbeddingEncoder`` (``models/embedding_encoder.py``, a BiGRU
stack with attention pooling) against JAX ``EmbeddingEncoder.apply`` on the
same weights, with ragged lengths, within 2e-5 (the GST's f32 bound); its
state dict read back by JAX's ``convert_embedding_encoder_state_dict``; its
dropout between layers in train mode only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.convert import convert_embedding_encoder_state_dict
from tacotron2_tpu.models.embedding_encoder import EmbeddingEncoder as JaxEncoder
from tacotron2_tpu_torch.convert import embedding_encoder_from_jax_params
from tacotron2_tpu_torch.models.embedding_encoder import EmbeddingEncoder

torch.set_num_threads(1)

TOL = 2e-5
ARGS = dict(embedding_dim=12, encoder_out_dim=16, encoder_num_layers=2, encoder_dropout=0.3,
            attention_dim=10)


def _models(seed=0):
    je = JaxEncoder(**ARGS)
    params = je.init(jax.random.PRNGKey(seed))
    te = EmbeddingEncoder(**ARGS)
    te.load_state_dict(embedding_encoder_from_jax_params(params))
    return je, params, te


@pytest.mark.parametrize("lengths", [(9, 9, 9), (9, 5, 1)])
def test_embedding_encoder_matches_jax(lengths):
    je, params, te = _models()
    x = np.random.default_rng(1).standard_normal((3, 9, 12)).astype(np.float32)
    ref_pooled, ref_scores = je.apply(params, jnp.asarray(x), jnp.asarray(lengths))
    pooled, scores = te(torch.as_tensor(x), torch.as_tensor(lengths))
    assert pooled.shape == (3, 16) and scores.shape == (3, 9, 1)
    np.testing.assert_allclose(pooled.detach().numpy(), np.asarray(ref_pooled), atol=TOL, rtol=0)
    np.testing.assert_allclose(scores.detach().numpy(), np.asarray(ref_scores), atol=TOL, rtol=0)
    # past a row's length the scores are 0, and each row's sum to 1
    if lengths[2] < 9:
        assert float(scores[2, lengths[2]:].abs().max()) == 0.0
    np.testing.assert_allclose(scores.detach().sum(dim=1).numpy(), 1.0, atol=1e-6)


def test_embedding_encoder_dropout_in_train_mode_only():
    _, _, te = _models(2)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((2, 7, 12)).astype(np.float32))
    lens = torch.tensor([7, 4])
    eval1, eval2 = te(x, lens)[0], te(x, lens)[0]
    assert torch.equal(eval1, eval2)
    g = torch.Generator().manual_seed(0)
    train = te(x, lens, train=True, generator=g)[0]
    assert float((train - eval1).abs().max()) > 1e-4


def test_embedding_encoder_state_dict_read_back_by_jax():
    _, params, te = _models(4)
    back = convert_embedding_encoder_state_dict(te.state_dict(), ARGS["encoder_num_layers"])
    assert jax.tree.structure(jax.tree.map(np.asarray, params)) == jax.tree.structure(back)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert set(te.state_dict()) == {f"encoder.{n}_l{i}{d}" for n in
                                    ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
                                    for i in range(2) for d in ("", "_reverse")} | {
        "attention.history.weight", "attention.context.weight", "attention.v.weight"}
