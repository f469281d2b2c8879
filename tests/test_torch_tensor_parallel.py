"""Tensor parallelism over a "model" axis (``tacotron2_tpu_torch/parallel/
mesh.py``, ``ops/train_scan.py``) on the CPU: ranks are spawned processes of
one gloo group (``tests/torch_dp_worker.py``), a grid of 2 data by 2 model
ranks.

- ``param_shardings`` names the same split tensors as JAX's
  ``param_shardings`` on ``make_mesh(model_parallel=m)`` of the suite's
  virtual devices, mapped through ``convert``, for the models of the
  vanilla, controllable, GST and prosody-model configs (their structure at
  small widths) and the prosody predictor (GRU and LSTM);
- ``unit_slice`` / ``gather_units`` split and rebuild a tensor by unit;
- the grid's step from JAX's weights, JAX's dropout masks injected,
  against ``make_sharded_train_step`` on ``make_mesh(4, model_parallel=2)``
  (JAX's XLA scan there), one step, within the bounds of
  ``test_torch_parallel.py::test_two_ranks_match_jax_sharded_step``;
- the same grid against the port's one-process step with the same masks:
  the replicated weights the same bits across each model group,
  ``gather_state_dict`` within the bounds of
  ``test_two_ranks_match_one_process``; two planted defects (the clip over
  a rank's slices, d(xh) left un-reduced over the model group) read at
  least 10x outside them; a finetune step keeps the frozen encoder's
  slices bit for bit (one launch of the four ranks runs all four);
- ``data_parallel_degree(model_parallel=2)`` against
  ``make_mesh_for_batch(model_parallel=2)``.
"""

import json
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from run.common import build_model as jax_build_model
from tacotron2_tpu.config import load_config as jax_load_config
from tacotron2_tpu.models.prosody import ProsodyPredictor as JaxPredictor
from tacotron2_tpu.ops import train_scan
from tacotron2_tpu.parallel import make_mesh, make_mesh_for_batch, param_shardings
from tacotron2_tpu_torch.config import load_config
from tacotron2_tpu_torch.convert import from_jax_params, prosody_from_jax_params
from tacotron2_tpu_torch.models.prosody import ProsodyPredictor
from tacotron2_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from tacotron2_tpu_torch.parallel import mesh
from tacotron2_tpu_torch.run.say import model_config_from
from tacotron2_tpu_torch.run.train import FINETUNE_FROZEN
from tests import torch_dp_worker as worker
from tests.test_torch_parallel import B4, JAX_RNG, T, _batch, _jax_model, hold_to_jax_steps
from tests.test_torch_training import CFG, H, LR, NOISE_GRAD

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SMALL = {"encoded_dim": 32, "att_rnn_dim": 32, "rnn_hidden_dim": 32, "prenet_dim": 16,
         "att_dim": 16, "postnet_dim": 16}


def _config(tmp_path, name, gst=False):
    """A config of ``config/`` at ``SMALL`` widths (GST: the vanilla HiFi
    config with ``extensions.gst``, as the smoke and the GST tests make it)."""
    raw = json.loads((ROOT / "config" / name).read_text())
    raw["model"]["args"].update(SMALL)
    if gst:
        raw.setdefault("extensions", {})["gst"] = {"active": True, "token_embedding_size": 32}
    path = tmp_path / f"{name[:-5]}{'-gst' if gst else ''}.json"
    path.write_text(json.dumps(raw))
    return str(path)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """-> models(name, gst) -> (the config's path at small widths, its JAX
    params' shapes), each made once."""
    tmp, made = tmp_path_factory.mktemp("configs"), {}

    def get(name, gst):
        if (name, gst) not in made:
            path = _config(tmp, name, gst)
            made[name, gst] = path, jax.eval_shape(jax_build_model(jax_load_config(path)).init,
                                                   jax.random.PRNGKey(0))[0]
        return made[name, gst]

    return get


def _jax_split(params, m, convert):
    """The names, after ``convert``, of the tensors JAX's ``param_shardings``
    splits over "model" on ``make_mesh(model_parallel=m)`` (``params``: the
    tree's arrays or their shapes)."""
    specs = param_shardings(make_mesh(model_parallel=m), params)
    marks = jax.tree.map(lambda p, s: np.full(np.shape(p), float("model" in s.spec), np.float32),
                         params, specs)
    return {k for k, v in convert(marks).items() if v.numel() and bool(v.all())}


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name,gst", [("vanilla-lj-hifi-stop.json", False),
                                      ("controllable-lj-hifi-stop-speaker.json", False),
                                      ("vanilla-lj-hifi-stop.json", True),
                                      ("controllable-lj-hifi-stop-speaker-prosody-model.json",
                                       False)],
                         ids=["vanilla", "controls", "gst", "prosody-model"])
def test_param_shardings_match_jax(models, name, gst, m):
    path, params = models(name, gst)
    want = _jax_split(params, m, lambda t: from_jax_params(t, None))
    model = Tacotron2(model_config_from(load_config(path)))
    got = mesh.param_shardings(model, m)
    assert set(got) == {k for k, _ in model.named_parameters()}
    assert {k for k, g in got.items() if g} == want
    assert {k for k, g in got.items() if g == 4} >= {"decoder.att_rnn.weight_ih",
                                                     "decoder.lstm.bias_hh",
                                                     "encoder.lstm.weight_hh_l0_reverse"}
    if gst:
        assert got["gst.reference_encoder.gru.weight_ih_l0"] == 3


@pytest.mark.parametrize("use_lstm", [False, True], ids=["gru", "lstm"])
def test_param_shardings_match_jax_prosody_predictor(use_lstm):
    jp = JaxPredictor(num_mels=16, rnn_in_dim=24, use_lstm=use_lstm, num_features=3)
    want = _jax_split(jp.init(jax.random.PRNGKey(1)), 2, prosody_from_jax_params)
    p = ProsodyPredictor(num_mels=16, rnn_in_dim=24, use_lstm=use_lstm, num_features=3)
    got = mesh.param_shardings(p, 2)
    assert {k for k, g in got.items() if g} == want and want
    assert set(filter(None, got.values())) == {4 if use_lstm else 3}


def test_unit_slices_rebuild_the_tensor():
    full = torch.arange(4 * 6 * 3, dtype=torch.float32).reshape(24, 3)
    parts = [mesh.unit_slice(full, 4, r, 3) for r in range(3)]
    assert parts[1].shape == (8, 3)
    # rank 1 holds units 2-3 of each of the four gate blocks
    assert torch.equal(parts[1][:2], full[2:4]) and torch.equal(parts[1][6:], full[20:22])
    assert torch.equal(torch.cat([p.reshape(4, 2, 3) for p in parts], dim=1).reshape(24, 3), full)
    with pytest.raises(ValueError, match="do not split"):
        mesh.param_shardings(torch.nn.LSTM(8, 6), 4)  # 4H = 24 divides, H = 6 does not


def _tp_masks(rng, i):
    """The LSTM masks of JAX's TP step i at the global shape (T, B, H): the
    XLA scan draws each step's from its key at the whole batch's shape."""
    scan_rng = jax.random.split(jax.random.fold_in(rng, i), 5)[3]
    keys = jax.random.split(scan_rng, T)
    return tuple(np.asarray(x) for x in jax.vmap(
        lambda k: train_scan._dropout_masks(k, (B4, H), True))(keys))


def _grid_spec(path):
    """JAX's weights (saved to ``path``), two global batches and JAX's TP
    masks for each step."""
    _, params, state = _jax_model()
    torch.save(from_jax_params(params, state), path)
    rng = jax.random.PRNGKey(JAX_RNG)
    return {"cfg": CFG, "policy": "32-true", "state": str(path), "gen_seed": 0, "lr": LR,
            "wd": 1e-6, "batches": [_batch(0), _batch(1)], "model_parallel": 2,
            "masks": [_tp_masks(rng, i) for i in range(2)]}


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """One launch of a 2 x 2 grid over ``_grid_spec``: its two steps, then
    one step with each planted defect, then a finetune step (the encoder
    out of the optimizer). -> (the spec, {run: the ranks' results}), the
    runs named None, "local_clip", "dxh" and "finetune"."""
    tmp = tmp_path_factory.mktemp("grid")
    spec = _grid_spec(tmp / "state.pt")
    runs = [(None, None, 2, {}), ("local_clip", "local_clip", 1, {}), ("dxh", "dxh", 1, {}),
            ("finetune", None, 1, {"frozen": FINETUNE_FROZEN})]
    ranks = worker.launch(4, "train_runs", {**spec, "runs": runs}, tmp / "ranks")
    return spec, {d: [r[d] for r in ranks] for d in ranks[0]}


def test_grid_matches_jax_tp_step(grid):
    """The grid's first step against ``make_sharded_train_step`` on a 2 x 2
    ("data", "model") mesh (JAX's XLA scan): ``hold_to_jax_steps``'s bounds
    (losses and ``grad_norm`` 1e-4 relative, gradients 1e-4 of their max,
    weights 5e-5, near-zero Adam inputs 2 lr, BatchNorm statistics 1e-5).
    Every rank reports the same metrics and gathers the same state."""
    spec, runs = grid
    got = runs[None]
    for r in got[1:]:
        for i in range(2):
            assert r[i]["metrics"] == got[0][i]["metrics"]
            assert all(torch.equal(v, got[0][i]["state"][k]) for k, v in r[i]["state"].items())
    hold_to_jax_steps(got[0][:1], spec["batches"][:1],
                      make_mesh(n_devices=4, model_parallel=2), pallas_train=None)


@pytest.fixture(scope="module")
def readings(grid):
    """-> readings(grid steps, **spec changes): the worst readings of a
    grid's steps against one process's of the grid's spec with the changes
    (each run once): loss and ``grad_norm`` (relative), each gradient
    against its max (``NOISE_GRAD``'s against their conv weight's),
    weights, statistics."""
    spec, ones = grid[0], {}

    def read(rank_steps, **changes):
        key = tuple(sorted(changes))
        if key not in ones:
            ones[key] = worker.train_steps(0, 1, {**{k: v for k, v in spec.items()
                                                     if k != "model_parallel"}, **changes})
        return _worst(ones[key], rank_steps)

    return read


def _worst(one, rank_steps):
    w = {"loss": 0.0, "grad_norm": 0.0, "grads": 0.0, "weights": 0.0, "bn": 0.0}
    for i, a in enumerate(rank_steps):
        for k in ("loss", "grad_norm"):
            ref = one[i]["metrics"][k]
            w[k] = max(w[k], abs(a["metrics"][k] - ref) / abs(ref))
        for k, v in one[i]["state"].items():
            if v.is_floating_point():
                key = "bn" if "running" in k else "weights"
                if key == "weights" or i == 0:
                    w[key] = max(w[key], float((a["state"][k] - v).abs().max()))
        if i == 0:  # a BatchNorm-fed conv bias's gradient (zero in exact arithmetic,
            # rounding noise on each side) against its conv weight's
            scale = lambda k, g: max(float((one[i]["grads"][k[:-4] + "weight"] if k in NOISE_GRAD
                                            else g).abs().max()), 1e-3)
            w["grads"], w["grads_at"] = max(
                (float((a["grads"][k] - g).abs().max()) / scale(k, g), k)
                for k, g in one[i]["grads"].items())
    return w


# test_two_ranks_match_one_process's bounds
ONE_PROCESS_TOL = {"loss": 1e-5, "grad_norm": 1e-5, "grads": 2e-5, "weights": 3e-3, "bn": 1e-6}


def test_grid_matches_one_process(grid, readings):
    """Two steps of the grid against one process of the global batch with
    the same masks: within ``ONE_PROCESS_TOL``; after each step the
    replicated weights the same bits on the two ranks of each model group,
    each rank's slices those of its data group's other rank."""
    ranks = grid[1][None]
    split = {k for k, g in mesh.param_shardings(Tacotron2(Tacotron2Config(**CFG)), 2).items()
             if g}
    for i in range(2):
        for a, b in ((0, 1), (2, 3)):  # model groups
            for k, v in ranks[a][i]["local"].items():
                if k not in split:
                    assert torch.equal(v, ranks[b][i]["local"][k]), (i, k)
        for a, b in ((0, 2), (1, 3)):  # data groups: the same slices
            assert all(torch.equal(v, ranks[b][i]["local"][k])
                       for k, v in ranks[a][i]["local"].items()), i
        assert ranks[0][i]["local"]["decoder.att_rnn.weight_ih"].shape[0] == 4 * H // 2
    w = readings(ranks[0])
    assert all(w[k] <= tol for k, tol in ONE_PROCESS_TOL.items()), w


@pytest.mark.parametrize("defect", ["local_clip", "dxh"])
def test_planted_defects_read_far_outside(grid, readings, defect):
    """The clip over a rank's slices reports another ``grad_norm`` (and,
    where the norm passes 1, scales by another factor); d(xh) left
    un-reduced breaks every gradient upstream of the decoder: at least one
    reading 10x above ``ONE_PROCESS_TOL``."""
    w = readings(grid[1][defect][0])
    assert max(w[k] / tol for k, tol in ONE_PROCESS_TOL.items()) >= 10, w


def test_grid_finetune_step_keeps_frozen_slices(grid, readings):
    """A finetune step on the grid (``FINETUNE_FROZEN`` out of the
    optimizer): the encoder's parameters, its split BiLSTM included, equal
    before and after bit for bit on every rank; every other one moved, and
    the step within ``ONE_PROCESS_TOL`` of the one-process finetune step."""
    spec, runs = grid
    init = torch.load(spec["state"])
    for r in runs["finetune"]:
        state = r[0]["state"]
        frozen = [k for k in init if k.startswith(FINETUNE_FROZEN) and "running" not in k
                  and not k.endswith("num_batches_tracked")]
        assert "encoder.lstm.weight_hh_l0" in frozen
        assert all(torch.equal(state[k], init[k]) for k in frozen)
        assert all(not torch.equal(state[k], v) for k, v in init.items()
                   if not k.startswith(FINETUNE_FROZEN) and "running" not in k
                   and not k.endswith("num_batches_tracked"))
    w = readings(runs["finetune"][0], frozen=FINETUNE_FROZEN)
    assert all(w[k] <= tol for k, tol in ONE_PROCESS_TOL.items()), w


@pytest.mark.parametrize("batch", [31, 32, 64])
def test_degree_matches_make_mesh_for_batch(batch, monkeypatch):
    devices = jax.devices()
    for k in range(2, 9):
        monkeypatch.setattr(jax, "devices", lambda *a, k=k: devices[:k])
        with warnings.catch_warnings(record=True) as ref_w:
            warnings.simplefilter("always")
            want = make_mesh_for_batch(batch, model_parallel=2).shape["data"]
        with warnings.catch_warnings(record=True) as got_w:
            warnings.simplefilter("always")
            got = mesh.data_parallel_degree(batch, k, model_parallel=2)
        assert got == want, (batch, k)
        assert [str(w.message) for w in got_w] == [str(w.message) for w in ref_w], (batch, k)
