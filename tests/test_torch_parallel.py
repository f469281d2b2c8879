"""The port's data-parallel training (``tacotron2_tpu_torch/parallel/mesh.py``)
on the CPU: ranks are spawned processes of one gloo group with a ``file://``
store (``tests/torch_dp_worker.py``; each join has its own timeout).

- two ranks of B / 2 rows against one process of B rows at one seed, with
  dropout on: JAX's own DP tolerances (``tests/test_parallel.py::
  test_dp_train_step_matches_single_device``), the BatchNorm statistics
  within 1e-6, the ranks' weights equal bit for bit;
- the 2-rank step against JAX's ``make_sharded_train_step`` on a 2-device
  mesh (``pallas_train=True``, interpret mode), weights and LSTM masks
  carried across, under the two-step test's tolerances;
- the global BatchNorm (1-D and the GST's 2-D) and the CCC style loss on
  two ranks against one process, gradients included;
- ``data_parallel_degree`` against ``make_mesh_for_batch``;
- ``train`` on two ranks: rank 0 alone writes; a finetune step keeps the
  frozen parameters bit for bit.
"""

import functools
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from tacotron2_tpu.models.tacotron2 import Tacotron2Config as JaxConfig
from tacotron2_tpu.ops import train_scan
from tacotron2_tpu.parallel import (make_mesh, make_mesh_for_batch, make_sharded_train_step,
                                    place_params, place_replicated, shard_batch)
from tacotron2_tpu.training.losses import tacotron2_loss as jax_loss
from tacotron2_tpu.training.optimizer import make_optimizer as jax_optimizer
from tacotron2_tpu.training.train_state import TrainState
from tacotron2_tpu_torch.convert import from_jax_params
from tacotron2_tpu_torch.parallel.mesh import data_parallel_degree, shard_rows
from tacotron2_tpu_torch.run.train import FINETUNE_FROZEN
from tests import torch_dp_worker as worker
from tests.test_torch_train_cli import _corpus
from tests.test_torch_training import CFG, H, INPUTS, LR, NOISE_GRAD, _close

torch.set_num_threads(1)

B4, L, T = 4, 9, 24


def _batch(seed):
    """Four rows: two full, two cut (chars and frames), so each rank's
    shard holds a padded row."""
    r = np.random.default_rng(seed)
    chars = r.integers(1, 16, size=(B4, L)).astype(np.int64)
    chars[1, 6:], chars[2, 4:] = 0, 0
    mel = (r.standard_normal((B4, T, 16)) * 0.5).astype(np.float32)
    mel[1, T - 6:], mel[3, T - 9:] = 0.0, 0.0
    gate = np.ones((B4, T, 1), np.float32)
    gate[0, -1], gate[2, -1], gate[1, T - 7:], gate[3, T - 10:] = 0.0, 0.0, 0.0, 0.0
    return {"chars_idx": chars, "chars_len": np.array([L, 6, 4, L]), "mel": mel,
            "mel_len": np.array([T, T - 6, T, T - 9]), "gate": gate}


def _spec(**kw):
    return {"cfg": {**CFG, "dropout": 0.5}, "policy": "32-true", "gen_seed": 5, "lr": LR,
            "wd": 1e-6, "batches": [_batch(0), _batch(1)], **kw}


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-3)


@functools.lru_cache(maxsize=None)
def _one_process():
    return worker.train_steps(0, 1, _spec())


def test_shard_rows_split_the_global_batch():
    b = _batch(0)
    parts = [shard_rows(b, r, 2) for r in range(2)]
    for k, v in b.items():
        np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]), v)
        assert parts[1][k].shape[1:] == v.shape[1:]  # the global padding stays
    with pytest.raises(ValueError, match="does not split"):
        shard_rows(b, 0, 3)


def test_two_ranks_match_one_process(tmp_path):
    """The first step: the loss within rtol 1e-5, every gradient within
    2e-5 of its tensor's max, the weights within 3e-3 (Adam's g / sqrt(v)
    scales reduction-order noise on near-zero gradients up to steps of
    ~lr) and the BatchNorm statistics within 1e-6. The second step starts
    from weights that differ by that noise: its loss within 1e-5, its
    weights within 3e-3. Every step leaves the ranks' weights and
    statistics equal bit for bit."""
    one = _one_process()
    two = worker.launch(2, "train_steps", _spec(), tmp_path)
    for i in range(2):
        a, b = two[0][i], two[1][i]
        for k in a["state"]:
            assert torch.equal(a["state"][k], b["state"][k]), (i, k)
        assert a["metrics"] == b["metrics"]
        for k, v in one[i]["metrics"].items():
            assert a["metrics"][k] == pytest.approx(v, rel=1e-5), (i, k)
        for k, v in one[i]["state"].items():
            atol = 1e-6 if "running" in k and i == 0 else 3e-3
            if "running" not in k or i == 0:
                _close(a["state"][k].double(), v.double().numpy(), atol, f"step {i} {k}")
        if i == 0:
            for k, g in one[i]["grads"].items():
                assert _rel(a["grads"][k], g) <= 2e-5, k


# --- against JAX's sharded step --------------------------------------------

JAX_RNG = 11


@functools.lru_cache(maxsize=None)
def _jax_model():
    jm = JaxTacotron2(JaxConfig(**CFG))
    params, state = jm.init(jax.random.PRNGKey(0))
    return jm, params, state


def _shard_masks(rng, i, n=2):
    """The LSTM masks of JAX's 2-shard step i at the global shape (T, B, H):
    each shard folds its index into the step keys
    (``Tacotron2._shard_mapped_pallas_scan``)."""
    scan_rng = jax.random.split(jax.random.fold_in(rng, i), 5)[3]
    keys = jax.random.split(scan_rng, T)
    parts = []
    for s in range(n):
        ks = jax.vmap(lambda k: jax.random.fold_in(k, s))(keys)
        parts.append(jax.vmap(lambda k: train_scan._dropout_masks(k, (B4 // n, H), True))(ks))
    return tuple(np.concatenate([np.asarray(p[j]) for p in parts], axis=1) for j in range(2))


def test_two_ranks_match_jax_sharded_step(tmp_path):
    """Two steps against ``make_sharded_train_step`` on ``make_mesh(2)``
    (``pallas_train=True``, interpret mode), within ``hold_to_jax_steps``'s
    bounds. The global batch's BatchNorm statistics are JAX's."""
    _, params, state = _jax_model()
    sd = tmp_path / "state.pt"
    torch.save(from_jax_params(params, state), sd)
    batches = [_batch(0), _batch(1)]
    rng = jax.random.PRNGKey(JAX_RNG)
    got = worker.launch(2, "train_steps", {
        "cfg": CFG, "policy": "32-true", "state": str(sd), "gen_seed": 0, "lr": LR,
        "wd": 1e-6, "batches": batches,
        "masks": [_shard_masks(rng, i) for i in range(2)]}, tmp_path / "ranks")[0]
    hold_to_jax_steps(got, batches, make_mesh(n_devices=2), pallas_train=True)


def hold_to_jax_steps(got, batches, mesh, pallas_train):
    """A rank's steps ``got`` (``worker.train_steps``'s, from JAX's weights,
    JAX's LSTM masks injected) against ``make_sharded_train_step`` on
    ``mesh`` (``pallas_train`` as JAX's forward takes it): the losses and
    ``grad_norm`` within 1e-4 relative, every gradient within 1e-4 of its
    tensor's max (those of ``NOISE_GRAD`` below 1e-6 on both sides), every
    weight within 5e-5 (the biases of ``NOISE_GRAD`` within two steps of lr)
    and the BatchNorm statistics within 1e-5, the encoder's running means
    within 0.2 lr: ``test_two_train_steps_match_jax``'s tolerances. The
    weights whose Adam input is within 100 eps of zero are held to two
    steps of lr, as ``NOISE_GRAD``'s (see below)."""
    jm, params, state = _jax_model()
    tx, _ = jax_optimizer(LR, 1e-6, scheduler_milestones=[])
    ts = TrainState.create(place_params(params, mesh), place_replicated(state, mesh), tx)
    jstep = make_sharded_train_step(jm, tx, mesh, donate=False, pallas_train=pallas_train)
    rng = jax.random.PRNGKey(JAX_RNG)

    @jax.jit
    def jgrad(p, s, batch, key):
        def f(p):
            out, _ = jm.forward_teacher(p, s, *(batch[k] for k in INPUTS), rng=key, train=True,
                                        dw_hoist=True, pallas_train=pallas_train,
                                        shard_mesh=mesh)
            return jax_loss(out.mels, out.mels_post, out.gates, batch["mel"], batch["gate"])[0]
        return jax.grad(f)(p)

    prev = from_jax_params(params, state)  # the weights each step starts from
    near = {}  # per weight, its elements whose Adam input came near zero
    for i, b in enumerate(batches):
        jb = shard_batch({k: jnp.asarray(v) for k, v in b.items()}, mesh)
        g_ref = from_jax_params(jax.tree.map(np.asarray, jgrad(
            ts.params, ts.model_state, jb, jax.random.fold_in(rng, i))), None)
        ts, ref = jstep(ts, jb, rng)
        m = got[i]["metrics"]
        for k in ("loss", "gate_loss", "mel_loss", "mel_post_loss", "grad_norm"):
            _close(torch.tensor(m[k]), float(ref[k]), 1e-4 * abs(float(ref[k])) + 1e-7,
                   f"step {i} {k}")
        unclip = max(1.0, m["grad_norm"] + 1e-6)  # clip_grad_norm_ scaled p.grad
        sd_ref = from_jax_params(jax.tree.map(np.asarray, ts.params),
                                 jax.tree.map(np.asarray, ts.model_state))
        for k, v in sd_ref.items():
            mine = got[i]["state"][k]
            if k.endswith("num_batches_tracked"):
                continue
            if "running" in k:
                atol = 0.2 * LR if k.startswith("encoder.") and k.endswith("mean") else 1e-5
                _close(mine, v.numpy(), atol, f"step {i} {k}")
                continue
            g = g_ref[k].numpy()
            if k in NOISE_GRAD:
                assert max(np.abs(g).max(), float(got[i]["grads"][k].abs().max())) < 1e-6, k
            else:
                _close(got[i]["grads"][k] * unclip, g, 1e-4 * float(np.abs(g).max()) + 1e-8,
                       f"step {i} grad {k}")
            if k in NOISE_GRAD:
                _close(mine, v.numpy(), 2 * LR, f"step {i} {k}")
                continue
            # Adam's first steps take lr * g / (|g| + eps) of g = the clipped
            # gradient + wd * w: where that is within 100 eps of 0 the step
            # turns on f32 noise of the gradient, in JAX as in the port (an
            # element of encoder.lstm.weight_ih_l0 here: 5.3e-5 from JAX in
            # one process too), and such elements (at this step or the one
            # before) are held to two steps of lr
            near[k] = near.get(k, False) | ((got[i]["grads"][k] + 1e-6 * prev[k]).abs()
                                            < 100 * 1e-8).numpy()
            d = (mine - v).abs().numpy()
            assert d[~near[k]].max(initial=0.0) <= 5e-5, (i, k, d.max())
            assert d[near[k]].max(initial=0.0) <= 2 * LR, (i, k)
        prev = {k: got[i]["state"][k] for k in sd_ref}


# --- the global-batch pieces ----------------------------------------------


def _tol(ref, name):
    """1e-6; for the gradients, sums over the batch of O(10), 1e-6 of
    their max (f32 sums in another order)."""
    return 1e-6 * max(1.0, float(ref.abs().max())) if name.startswith("d") else 1e-6


def test_global_batchnorm_matches_one_batch(tmp_path):
    """Outputs and the running statistics within 1e-6 of one BatchNorm over
    the concatenated rows (1-D channels-last and the GST's 2-D), the input,
    weight and bias gradients within 1e-6 of their max."""
    r = np.random.default_rng(2)
    spec = {"x1": r.standard_normal((4, 7, 6)).astype(np.float32) * 2 + 1,
            "w1": r.standard_normal((4, 7, 6)).astype(np.float32),
            "x2": r.standard_normal((4, 3, 5, 6)).astype(np.float32) - 0.5,
            "w2": r.standard_normal((4, 3, 5, 6)).astype(np.float32)}
    one = worker.batchnorm(0, 1, spec)
    two = worker.launch(2, "batchnorm", spec, tmp_path)
    for key in ("1", "2"):
        for name in ("y", "dx"):
            both = torch.cat([two[0][key][name], two[1][key][name]])
            _close(both, one[key][name].numpy(), _tol(one[key][name], name), f"{key} {name}")
        for name in ("dparams", "running"):
            assert torch.equal(two[0][key][name], two[1][key][name]), (key, name)
            _close(two[0][key][name], one[key][name].numpy(), _tol(one[key][name], name),
                   f"{key} {name}")


def test_global_ccc_loss_matches_one_process(tmp_path):
    """The CCC style loss of the global batch (not a mean of the ranks'
    CCCs) within 1e-6, its gradient within 1e-6 of its max."""
    r = np.random.default_rng(4)
    target = r.standard_normal((4, 10, 8)).astype(np.float32)
    target[2:] += 1.5  # the halves differ: per-rank CCCs would not average to it
    spec = {"pred": (0.7 * target + 0.4 * r.standard_normal(target.shape)).astype(np.float32),
            "target": target}
    one = worker.ccc(0, 1, spec)
    two = worker.launch(2, "ccc", spec, tmp_path)
    for rk in two:
        assert float(rk["loss"]) == pytest.approx(float(one["loss"]), abs=1e-6)
    scale = float(one["dpred"].abs().max())
    _close(torch.cat([two[0]["dpred"], two[1]["dpred"]]), one["dpred"].numpy(), 1e-6 * scale,
           "dpred")


@pytest.mark.parametrize("batch", [31, 32, 64])
def test_degree_matches_make_mesh_for_batch(batch, monkeypatch):
    devices = jax.devices()
    for k in range(1, 9):
        monkeypatch.setattr(jax, "devices", lambda *a, k=k: devices[:k])
        with warnings.catch_warnings(record=True) as ref_w:
            warnings.simplefilter("always")
            want = make_mesh_for_batch(batch).size
        with warnings.catch_warnings(record=True) as got_w:
            warnings.simplefilter("always")
            got = data_parallel_degree(batch, k)
        assert got == want, (batch, k)
        assert [str(w.message) for w in got_w] == [str(w.message) for w in ref_w], (batch, k)


# --- train on two ranks -----------------------------------------------------


def test_train_on_two_ranks_rank0_writes(tmp_path):
    """``train`` on two ranks (a batch of 2: one row each): one event file
    and one metrics row per logged step, ``final.ckpt`` from rank 0; both
    ranks report the same losses, which equal a one-process run's (the
    first within rtol 1e-5, the next, from weights a step of Adam apart,
    within 1e-3), and the saved weights are rank 0's."""
    speech, _, cfg = _corpus(tmp_path)
    argv = ["train", "--config", cfg, "--speech-dir", str(speech), "--device", "cpu"]
    ranks = worker.launch(2, "train_cli", {"argv": argv + ["--results-dir",
                                                           str(tmp_path / "dp")]},
                          tmp_path / "ranks")
    recs = [r["record"] for r in ranks]
    assert [r["rank"] for r in recs] == [0, 1] and {r["ranks"] for r in recs} == {2}
    assert [s["loss"] for s in recs[0]["steps"]] == [s["loss"] for s in recs[1]["steps"]]
    assert {s["rows"] for s in recs[0]["steps"]} == {2}  # the global batch's
    from tacotron2_tpu_torch.__main__ import main as cli

    one = cli(argv + ["--results-dir", str(tmp_path / "one")])
    losses = [s["loss"] for s in recs[0]["steps"]]
    want = [s["loss"] for s in one["steps"]]
    assert losses[0] == pytest.approx(want[0], rel=1e-5)
    assert losses == pytest.approx(want, rel=1e-3)
    logs = list((tmp_path / "dp" / "lightning_logs").rglob("events.out.tfevents.*"))
    assert len(logs) == 1
    rows = [json.loads(x) for x in next((tmp_path / "dp" / "lightning_logs").rglob(
        "metrics.jsonl")).read_text().splitlines()]
    logged = [r["step"] for r in rows if "training_loss" in r]
    assert logged == sorted(set(logged)) == [1]
    final = torch.load(tmp_path / "dp" / "final.ckpt", weights_only=False)
    assert final["global_step"] == 3 and recs[1]["checkpoint"] == recs[0]["checkpoint"]


def test_finetune_step_keeps_frozen_parameters(tmp_path):
    """A finetune step on two ranks (the optimizer over the trainable
    parameters, ``FINETUNE_FROZEN`` out of it): the encoder's parameters
    equal before and after bit for bit; the others move and match the
    one-process finetune step within 3e-3."""
    spec = _spec(frozen=FINETUNE_FROZEN, batches=[_batch(0)])
    torch.manual_seed(0)
    from tacotron2_tpu_torch.models.layers import Policy
    from tacotron2_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config

    init = Tacotron2(Tacotron2Config(**spec["cfg"]), Policy.from_string("32-true")).state_dict()
    two = worker.launch(2, "train_steps", spec, tmp_path)
    one = worker.train_steps(0, 1, spec)
    frozen = [k for k in init if k.startswith(FINETUNE_FROZEN) and "running" not in k
              and not k.endswith("num_batches_tracked")]
    assert frozen
    for k in frozen:
        assert torch.equal(two[0][0]["state"][k], init[k]), k
        assert torch.equal(two[1][0]["state"][k], init[k]), k
    moved = [k for k in init if not k.startswith(FINETUNE_FROZEN) and "running" not in k
             and not k.endswith("num_batches_tracked")]
    assert all(not torch.equal(two[0][0]["state"][k], init[k]) for k in moved)
    for k in moved:
        _close(two[0][0]["state"][k], one[0]["state"][k].numpy(), 3e-3, k)
    assert two[0][0]["metrics"]["loss"] == pytest.approx(one[0]["metrics"]["loss"], rel=1e-5)
