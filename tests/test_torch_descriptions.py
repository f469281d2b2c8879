"""The port's description-conditioned model (``descriptions-libritts.json``'s
path: the memory widened by tanh(Linear(description, 128)) over every char,
plain versions of K1, K3 and K4 on the CPU) against the JAX package, at
tiny sizes.

- the decode: B=2 with speakers 0 and 2, each row its own description
  (dim 24), 66 frames, against JAX ``forward_infer_fused(interpret=True)``
  (bf16 and int8 modes under 32-true) and ``forward_infer_fast``, with
  tests/test_torch_controls.py's ``DECODE_TOL`` (mels 2e-4, mels_post 5e-4,
  gates 2e-3, aligns 1e-4; readings <= 3.3e-7) and n_frames / lengths
  exact. The int8 mode reads 0 up to row 1's third frame, where an int8
  rounding of the two frameworks' f32 sums lands one quantum apart and the
  recurrence carries it (mels 7.9e-4, mels_post 7.9e-4, gates 4.4e-4,
  aligns 1.5e-4 at most; the draws of seeds 6 and 5 x 0.1 read 0 over 12
  frames): ``INT8_TOL``, about twice that; the port's
  per-step reference decode equals its chunked one (1e-5); the description
  reaches the mels;
- training: ``forward_teacher`` in train mode with JAX's LSTM masks within
  3e-5 of each output's max (test_torch_training.py's 32-true limit); two
  train steps against JAX ``build_train_step`` with test_torch_training.py's
  limits, the description linear's gradients included;
- weights: a reference-layout Lightning checkpoint with
  ``description_embeddings_linear.0.*`` loads strictly, and JAX's own
  converter reads the port's state dict back to JAX's tree;
- data: the dataset and ``collate`` with description files (``.npy`` and
  ``.pt``, None for zeros) equal JAX's; with augmentation every pick is one
  of the files on disk, the picks follow the seed, and JAX's picks come from
  the same set; ``train``'s three description selections (pretraining
  blanks, finetuning the ``augmented_ids.csv`` rows with augmentation, a
  config that is not finetuneable) against JAX's pandas lines; a mel cache
  file is never read half-written by a second loader thread;
- drivers: ``embed_descriptions`` -> ``train`` (pretraining) -> ``train
  --finetune`` of a tiny description config through the CLI, the frozen
  parameters bit for bit and the description linear moved; ``say
  --description --bert-checkpoint`` against JAX ``do_say`` (PCM16 within 2
  LSB, the say tests' limit), the blank say other; the refusals: a
  description without ``--bert-checkpoint``, and ``test`` /
  ``train_mel_export`` / the server of a description model, whose JAX
  counterparts pass no description;
- K3 / K4's attention cluster at the corpus' long texts: ``attention_cluster``
  doubles the one-wave S where K4's block would pass 227 KB of shared memory
  (B = 128, L = 224 / 256: S = 2), and the wrappers pass it (a fake library
  on meta tensors); the mirrored plan is held against the library's on the
  card (``chip_smoke.py`` phase 4h).
"""

import copy
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

transformers = pytest.importorskip("transformers")

from run.say import do_say as jax_do_say  # noqa: E402
from tacotron2_tpu.config import load_config as jax_load_config  # noqa: E402
from tacotron2_tpu.convert import convert_tacotron2_state_dict  # noqa: E402
from tacotron2_tpu.data.dataset import TTSDataset as JaxDataset  # noqa: E402
from tacotron2_tpu.data.loader import collate as jax_collate  # noqa: E402
from tacotron2_tpu.models.layers import Policy as JaxPolicy  # noqa: E402
from tacotron2_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2  # noqa: E402
from tacotron2_tpu.models.tacotron2 import Tacotron2Config as JaxConfig  # noqa: E402
from tacotron2_tpu.ops import train_scan  # noqa: E402
from tacotron2_tpu.training.losses import tacotron2_loss as jax_loss  # noqa: E402
from tacotron2_tpu.training.optimizer import make_optimizer as jax_optimizer  # noqa: E402
from tacotron2_tpu.training.step import build_train_step  # noqa: E402
from tacotron2_tpu.training.train_state import TrainState  # noqa: E402
from tacotron2_tpu_torch.__main__ import main as port_cli  # noqa: E402
from tacotron2_tpu_torch.audio.io import read_wav, write_wav  # noqa: E402
from tacotron2_tpu_torch.config import config_from_dict, load_config  # noqa: E402
from tacotron2_tpu_torch.convert import (from_jax_params, load_strict,  # noqa: E402
                                         load_tacotron2_checkpoint, to_lightning)
from tacotron2_tpu_torch.data.dataset import TTSDataset  # noqa: E402
from tacotron2_tpu_torch.data.loader import collate  # noqa: E402
from tacotron2_tpu_torch.models.layers import Policy  # noqa: E402
from tacotron2_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config  # noqa: E402
from tacotron2_tpu_torch.run import server as srv  # noqa: E402
from tacotron2_tpu_torch.run.say import model_config_from  # noqa: E402
from tacotron2_tpu_torch.run.train import select_descriptions  # noqa: E402
from tacotron2_tpu_torch.training import optimizer, step  # noqa: E402
from tests.test_torch_controls import DECODE_TOL  # noqa: E402
from tests.test_torch_decode import CFG as DEC_CFG  # noqa: E402
from tests.test_torch_decode import _inputs  # noqa: E402
from tests.test_torch_say import _files as _say_files  # noqa: E402
from tests.test_torch_train_cli import CHARS, TEXTS, _wav  # noqa: E402
from tests.test_torch_training import CFG as TRAIN_CFG  # noqa: E402
from tests.test_torch_training import LR, NOISE_GRAD, _bn_state_close, _close  # noqa: E402

torch.set_num_threads(1)

DIM = 24  # the description embeddings' width in these tests
EXT = dict(speaker_tokens=True, num_speakers=3, description_embeddings=True,
           description_embeddings_dim=DIM)
SPEAKERS = np.array([0, 2])
INT8_TOL = {"mels": 1.6e-3, "mels_post": 1.6e-3, "gates": 2e-3, "alignments": 3e-4}
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "calm", "voice", "fast", "angry",
         "speaker", "slow", "happy", "##s", "the", "in", "tone", "deep", ",", "."]
DESCS = ["a calm voice", "fast angry speaker, in the tone", "", "slow happy voices",
         "a deep tone."]


def _descs(seed=5, n=2):
    return np.random.default_rng(seed).standard_normal((n, DIM)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _decode_models():
    jm = JaxTacotron2(JaxConfig(**DEC_CFG, **EXT))
    params, state = jm.init(jax.random.PRNGKey(0))
    params["decoder"]["gate"]["b"] = jnp.full_like(params["decoder"]["gate"]["b"], 3.0)
    tm = Tacotron2(Tacotron2Config(**DEC_CFG, **EXT))
    tm.load_state_dict(from_jax_params(params, state))
    return jm, params, state, tm.eval()


@pytest.mark.parametrize("jax_fn,quantize", [("forward_infer_fused", False),
                                             ("forward_infer_fused", True),
                                             ("forward_infer_fast", False)])
def test_description_decode_matches_jax(jax_fn, quantize):
    jm, params, state, tm = _decode_models()
    assert tm.cfg.encoded_full_dim == DEC_CFG["encoded_dim"] + 128
    chars, lens = _inputs(2)
    kw = {"interpret": True, "quantize": quantize} if jax_fn == "forward_infer_fused" else {}
    ref = getattr(jm, jax_fn)(params, state, jnp.asarray(chars), jnp.asarray(lens), 66,
                              rng=jax.random.PRNGKey(7), prenet_dropout=False,
                              speaker_id=jnp.asarray(SPEAKERS),
                              description_embeddings=jnp.asarray(_descs()), **kw)
    out = tm.forward_infer_fast(torch.as_tensor(chars), torch.as_tensor(lens), 66,
                                prenet_dropout=False, quantize=quantize,
                                speaker_id=torch.as_tensor(SPEAKERS),
                                description_embeddings=torch.as_tensor(_descs()))
    assert int(out.n_frames) == int(ref.n_frames) == 66
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    for name, atol in (INT8_TOL if quantize else DECODE_TOL).items():
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=atol, rtol=0, err_msg=name)


def test_reference_decode_takes_the_description_and_it_reaches_the_mels():
    *_, tm = _decode_models()
    chars, lens = (torch.as_tensor(a) for a in _inputs(2))
    kw = dict(prenet_dropout=False, speaker_id=torch.as_tensor(SPEAKERS))
    d = torch.as_tensor(_descs())
    ref = tm.forward_infer(chars, lens, 40, description_embeddings=d, **kw)
    fast = tm.forward_infer_fast(chars, lens, 40, description_embeddings=d, **kw)
    assert fast.n_frames == ref.n_frames and torch.equal(fast.lengths, ref.lengths)
    for name in ("mels", "mels_post", "gates", "alignments"):
        torch.testing.assert_close(getattr(fast, name), getattr(ref, name), atol=1e-5, rtol=0)
    blank = tm.forward_infer_fast(chars, lens, 40, description_embeddings=torch.zeros(2, DIM),
                                  **kw)
    assert (blank.mels - fast.mels).abs().max() > 1e-3
    # a padded empty row (the server's ``encode_rows``) reads a zero description
    rows = tm.forward_infer_fast(chars, lens, 40, description_embeddings=d, encode_rows=4, **kw)
    torch.testing.assert_close(rows.mels, fast.mels, atol=1e-6, rtol=0)


def test_encode_wants_the_description():
    *_, tm = _decode_models()
    chars, lens = (torch.as_tensor(a) for a in _inputs(2))
    with pytest.raises(ValueError, match="description tensor required"):
        tm.forward_infer_fast(chars, lens, 4, speaker_id=torch.as_tensor(SPEAKERS))
    with pytest.raises(ValueError, match="description embeddings of shape"):
        tm.forward_infer_fast(chars, lens, 4, speaker_id=torch.as_tensor(SPEAKERS),
                              description_embeddings=torch.zeros(2, DIM + 1))


# ---------------------------------------------------------------------------
# training

B, L, T, H = 2, 9, 24, 32
INPUTS = ("chars_idx", "chars_len", "mel", "mel_len")


def _batch(seed=0):
    r = np.random.default_rng(seed)
    chars = r.integers(1, 16, size=(B, L)).astype(np.int64)
    chars[1, 6:] = 0
    mel = (r.standard_normal((B, T, 16)) * 0.5).astype(np.float32)
    mel[1, T - 6:] = 0.0
    gate = np.ones((B, T, 1), np.float32)
    gate[0, -1], gate[1, T - 7:] = 0.0, 0.0
    return {"chars_idx": chars, "chars_len": np.array([L, 6]), "mel": mel,
            "mel_len": np.array([T, T - 6]), "gate": gate,
            "speaker_id": np.array([2, seed], np.int64),
            "description_embeddings": _descs(seed + 11)}


def _masks(rng):
    """The LSTM masks JAX's forward_teacher draws from ``rng``."""
    keys = jax.random.split(jax.random.split(rng, 5)[3], T)
    m = jax.vmap(lambda k: train_scan._dropout_masks(k, (B, H), True))(keys)
    return tuple(torch.as_tensor(np.array(a)) for a in m)


@functools.lru_cache(maxsize=None)
def _train_models():
    jm = JaxTacotron2(JaxConfig(**TRAIN_CFG, **EXT), JaxPolicy.from_string("32-true"))
    params, state = jm.init(jax.random.PRNGKey(0))
    return jm, params, state


def _port(params, state):
    m = Tacotron2(Tacotron2Config(**TRAIN_CFG, **EXT), Policy.from_string("32-true"))
    m.load_state_dict(from_jax_params(params, state))
    return m


def test_forward_teacher_with_descriptions_matches_jax():
    jm, params, state = _train_models()
    b = _batch()
    ref, new_state = jm.forward_teacher(
        params, state, *(jnp.asarray(b[k]) for k in INPUTS), rng=jax.random.PRNGKey(3),
        train=True, speaker_id=jnp.asarray(b["speaker_id"]),
        description_embeddings=jnp.asarray(b["description_embeddings"]), dw_hoist=True,
        pallas_train=True)
    model = _port(params, state)
    with torch.no_grad():
        out = model.forward_teacher(
            *(torch.as_tensor(b[k]) for k in INPUTS), train=True,
            lstm_masks=_masks(jax.random.PRNGKey(3)), speaker_id=torch.as_tensor(b["speaker_id"]),
            description_embeddings=torch.as_tensor(b["description_embeddings"]))
    for name in ("mels", "mels_post", "gates", "alignments"):
        r = np.asarray(getattr(ref, name))
        _close(getattr(out, name), r, 3e-5 * float(np.abs(r).max()) + 1e-6, name)
    _bn_state_close(model, new_state, 1e-5)


def test_two_train_steps_with_descriptions_match_jax():
    """tests/test_torch_training.py::test_two_train_steps_match_jax on a
    model with 3 speakers and description embeddings, with its limits; the
    description linear gets a gradient and moves."""
    jm, params, state = _train_models()
    tx, _ = jax_optimizer(LR, 1e-6, scheduler_milestones=[])
    ts = TrainState.create(params, state, tx)
    jstep = jax.jit(build_train_step(jm, tx, pallas_train=True))

    @jax.jit
    def jgrad(p, s, batch, rng):
        def f(p):
            out, _ = jm.forward_teacher(p, s, *(batch[k] for k in INPUTS), rng=rng, train=True,
                                        speaker_id=batch["speaker_id"],
                                        description_embeddings=batch["description_embeddings"],
                                        dw_hoist=True, pallas_train=True)
            return jax_loss(out.mels, out.mels_post, out.gates, batch["mel"], batch["gate"])[0]
        return jax.grad(f)(p)

    rng = jax.random.PRNGKey(11)
    model = _port(params, state)
    w0 = model.description_embeddings_linear[0].weight.detach().clone()
    opt, sched = optimizer.make_optimizer(model.parameters(), LR, 1e-6)
    for i, b in enumerate([_batch(0), _batch(1)]):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        g_ref = from_jax_params(jax.tree.map(np.asarray, jgrad(ts.params, ts.model_state, jb,
                                                               jax.random.fold_in(rng, i))), None)
        ts, ref = jstep(ts, jb, rng)
        got = step.train_step(model, opt, sched, step.to_device(b, "cpu"),
                              lstm_masks=_masks(jax.random.fold_in(rng, i)))
        for k in ("loss", "gate_loss", "mel_loss", "mel_post_loss", "grad_norm"):
            _close(got[k], ref[k], 1e-4 * abs(float(ref[k])) + 1e-7, f"step {i} {k}")
        unclip = max(1.0, float(got["grad_norm"]) + 1e-6)
        named = dict(model.named_parameters())
        sd = from_jax_params(jax.tree.map(np.asarray, ts.params), None)
        assert "description_embeddings_linear.0.weight" in sd
        for k, v in sd.items():
            g = g_ref[k].numpy()
            if k in NOISE_GRAD:
                assert max(np.abs(g).max(), float(named[k].grad.abs().max())) < 1e-6, k
            else:
                _close(named[k].grad * unclip, g, 1e-4 * float(np.abs(g).max()) + 1e-8,
                       f"step {i} grad {k}")
            _close(named[k], v.numpy(), 2 * LR if k in NOISE_GRAD else 5e-5, f"step {i} {k}")
        _bn_state_close(model, jax.tree.map(np.asarray, ts.model_state), 1e-5, 0.2 * LR)
    assert (model.description_embeddings_linear[0].weight.detach() - w0).abs().max() > 0


def test_reference_layout_checkpoint_loads_strictly(tmp_path):
    _, params, state = _train_models()
    sd = from_jax_params(params, state)
    assert {"description_embeddings_linear.0.weight",
            "description_embeddings_linear.0.bias"} <= set(sd)
    torch.save(to_lightning(sd), tmp_path / "m.ckpt")
    model = Tacotron2(Tacotron2Config(**TRAIN_CFG, **EXT))
    load_strict(model, load_tacotron2_checkpoint(str(tmp_path / "m.ckpt"))[0])
    model.load_state_dict(sd)  # strict: every name is the reference's
    back, _ = convert_tacotron2_state_dict(to_lightning(model.state_dict())["state_dict"])
    for k in ("w", "b"):
        np.testing.assert_array_equal(np.asarray(back["description_linear"][k]),
                                      np.asarray(params["description_linear"][k]))
    with pytest.raises(ValueError, match="missing"):
        load_strict(Tacotron2(Tacotron2Config(**TRAIN_CFG, **EXT)),
                    {k: v for k, v in sd.items() if "description" not in k})


# ---------------------------------------------------------------------------
# data and the train driver's selection


def _embedding_files(speech):
    """Row 0: a .npy with two augmentations; row 1: a .pt; row 2: none."""
    d = speech / "description_embeddings"
    (d / "u0_augmentations").mkdir(parents=True)
    r = np.random.default_rng(9)
    np.save(d / "u0.npy", r.standard_normal((1, DIM)).astype(np.float32))
    for k in range(2):
        np.save(d / "u0_augmentations" / f"aug{k}.npy",
                r.standard_normal((1, DIM)).astype(np.float32))
    torch.save(torch.as_tensor(r.standard_normal((1, DIM)).astype(np.float32)), d / "u1.pt")
    return [os.path.join("description_embeddings", "u0.npy"),
            os.path.join("description_embeddings", "u1.pt"), None]


def _small_corpus(tmp_path):
    speech = tmp_path / "speech"
    speech.mkdir()
    for i in range(3):
        write_wav(str(speech / f"u{i}.wav"), _wav(i, 4000 + 500 * i), 22050)
    return speech


def test_dataset_and_collate_with_descriptions_match_jax(tmp_path):
    speech = _small_corpus(tmp_path)
    descs = _embedding_files(speech)
    files = [f"u{i}.wav" for i in range(3)]
    kw = dict(allowed_chars=CHARS, end_token="^", trim=False, num_mels=16,
              description_embeddings=descs, description_embeddings_dim=DIM)
    port = TTSDataset(files, TEXTS[:3], str(speech), **kw)
    ref = JaxDataset(files, TEXTS[:3], str(speech), **kw)
    items, refs = [port[i] for i in range(3)], [ref[i] for i in range(3)]
    for (_, m, _), (_, mr, _) in zip(items, refs):
        np.testing.assert_array_equal(m["description_embeddings"], mr["description_embeddings"])
        assert m["description_embeddings"].shape == (1, DIM)
    assert not items[2][1]["description_embeddings"].any()
    got, want = collate(items, 32, 128), jax_collate(refs, 32, 128)
    assert got["description_embeddings"].shape == (3, DIM)
    np.testing.assert_array_equal(got["description_embeddings"], want["description_embeddings"])


def test_augmented_picks_come_from_the_files_on_disk(tmp_path):
    speech = _small_corpus(tmp_path)
    descs = _embedding_files(speech)
    files = [f"u{i}.wav" for i in range(3)]
    kw = dict(allowed_chars=CHARS, end_token="^", trim=False, num_mels=16,
              description_embeddings=descs, description_embeddings_dim=DIM,
              description_embeddings_augment=True)
    d = speech / "description_embeddings"
    on_disk = {np.load(p).tobytes() for p in (d / "u0.npy", d / "u0_augmentations/aug0.npy",
                                              d / "u0_augmentations/aug1.npy")}

    def picks(ds, n=24):
        return [ds[0][1]["description_embeddings"].tobytes() for _ in range(n)]

    a, b = picks(TTSDataset(files, TEXTS[:3], str(speech), seed=4, **kw)), \
        picks(TTSDataset(files, TEXTS[:3], str(speech), seed=4, **kw))
    assert a == b and set(a) == on_disk  # the seed's sequence; every file picked
    assert a != picks(TTSDataset(files, TEXTS[:3], str(speech), seed=5, **kw))
    ref = JaxDataset(files, TEXTS[:3], str(speech), **kw)
    assert {ref[0][1]["description_embeddings"].tobytes() for _ in range(24)} <= on_disk
    # a row without augmentations reads its own file every time
    one = TTSDataset(files, TEXTS[:3], str(speech), seed=4, **kw)
    assert len({one[1][1]["description_embeddings"].tobytes() for _ in range(4)}) == 1


def _selection_config(finetuneable: bool, tmp_path):
    rows = "id|text|wav|description_embedding\n" + "".join(
        f"{100 + i}|{TEXTS[i]}|u{i}.wav|{'' if i == 2 else f'description_embeddings/u{i}.npy'}\n"
        for i in range(4))
    for name in ("train", "val"):
        (tmp_path / f"{name}.csv").write_text(rows)
    (tmp_path / "augmented_ids.csv").write_text("101\n103\n")
    return config_from_dict({
        "dataset": {"train": str(tmp_path / "train.csv"), "val": str(tmp_path / "val.csv"),
                    "preprocessing": {"allowed_chars": CHARS}},
        "model": {"args": {"description_embeddings": True, "description_embeddings_dim": DIM}},
        "extensions": {"descriptions": {"bert_embeddings": True,
                                        "finetuneable": finetuneable}}})


def _jax_selection(cfg, speech_dir, finetune):
    """JAX's run/train.py lines 111-129, on its pandas manifests."""
    from run.common import read_manifest as jax_read

    ext = cfg.extensions
    train_df, val_df = jax_read(cfg.dataset.train), jax_read(cfg.dataset.val)
    augment = False
    if ext.descriptions.finetuneable and finetune:
        ids = set(pd.read_csv(os.path.join(speech_dir, "augmented_ids.csv"), header=None)[0])
        train_df = train_df[train_df.id.isin(ids)]
        augment = True
    if not ext.descriptions.finetuneable or finetune:
        desc_t = [x if isinstance(x, str) else None for x in train_df.description_embedding]
        desc_v = [x if isinstance(x, str) else None for x in val_df.description_embedding]
    else:
        desc_t, desc_v = [None] * len(train_df), [None] * len(val_df)
    return list(train_df.wav), desc_t, desc_v, augment


@pytest.mark.parametrize("finetuneable,finetune", [(True, False), (True, True), (False, False)],
                         ids=["pretraining_blanks", "finetune_augmented", "not_finetuneable"])
def test_train_description_selection_matches_jax(tmp_path, finetuneable, finetune):
    from tacotron2_tpu_torch.data.manifest import read_manifest

    cfg = _selection_config(finetuneable, tmp_path)
    rows, desc_t, desc_v, augment = select_descriptions(
        cfg, read_manifest(cfg.dataset.train), read_manifest(cfg.dataset.val), str(tmp_path),
        finetune)
    wavs, ref_t, ref_v, ref_aug = _jax_selection(jax_load_config_from(cfg, tmp_path),
                                                 str(tmp_path), finetune)
    assert [r["wav"] for r in rows] == wavs
    assert (desc_t, desc_v, augment) == (ref_t, ref_v, ref_aug)
    if finetune:
        assert wavs == ["u1.wav", "u3.wav"] and augment
    elif finetuneable:
        assert desc_t == [None] * 4
    else:
        assert desc_t[2] is None and desc_t[0] == "description_embeddings/u0.npy"


def jax_load_config_from(cfg, tmp_path):
    """The JAX config of ``_selection_config``'s raw dict."""
    from tacotron2_tpu.config import config_from_dict as jax_config_from_dict

    return jax_config_from_dict({
        "dataset": {"train": cfg.dataset.train, "val": cfg.dataset.val,
                    "preprocessing": {"allowed_chars": CHARS}},
        "model": {"args": {"description_embeddings": True, "description_embeddings_dim": DIM}},
        "extensions": {"descriptions": {
            "bert_embeddings": True,
            "finetuneable": cfg.extensions.descriptions.finetuneable}}})


# ---------------------------------------------------------------------------
# the drivers


def _bert_files(tmp_path, hidden=16, seed=2):
    """A tiny random BERT saved as a state-dict file with vocab.txt beside it."""
    d = tmp_path / "bert"
    d.mkdir()
    (d / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    cfg = transformers.BertConfig(vocab_size=len(VOCAB), hidden_size=hidden,
                                  num_hidden_layers=1, num_attention_heads=2,
                                  intermediate_size=2 * hidden, max_position_embeddings=32)
    torch.manual_seed(seed)
    torch.save(transformers.BertModel(cfg).state_dict(), d / "bert.pt")
    return str(d / "bert.pt")


def _description_files(tmp_path, gate_bias=3.0):
    """test_torch_say's tiny files as a description model (3 speakers,
    description dim 16: the tiny BERT's width)."""
    cfg_path, ckpt, g_path = _say_files(tmp_path, gate_bias)
    raw = json.loads(open(cfg_path).read())
    raw["model"]["args"].update(description_embeddings=True, description_embeddings_dim=16)
    raw["extensions"] = {"speaker_tokens": {"active": True, "num_speakers": 3},
                         "descriptions": {"bert_embeddings": True}}
    open(cfg_path, "w").write(json.dumps(raw))
    torch.manual_seed(2)
    model = Tacotron2(model_config_from(load_config(cfg_path)))
    with torch.no_grad():
        model.decoder.gate.bias.fill_(gate_bias)
        model.description_embeddings_linear[0].weight.mul_(8.0)
    torch.save(to_lightning(model.state_dict()), ckpt)
    return cfg_path, ckpt, g_path


def test_say_description_matches_jax(tmp_path):
    cfg_path, ckpt, g_path = _description_files(tmp_path)
    bert = _bert_files(tmp_path)
    out_port, out_jax = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    common = ["say", "--config", cfg_path, "--checkpoint", ckpt, "--hifi-gan-checkpoint", g_path,
              "--text", "Hello there.", "--random-seed", "7", "--max-len-override", "24",
              "--speaker-id", "2", "--device", "cpu"]
    res = port_cli(common + ["--out", out_port, "--description", "a calm deep voice",
                             "--bert-checkpoint", bert])
    jax_do_say(jax_load_config(cfg_path), 0, ckpt, "Hello there.", out_jax,
               hifi_gan_checkpoint=g_path, random_seed=7, max_len_override=24, speaker_id=2,
               description="a calm deep voice", bert_checkpoint=bert)
    port_wav, jax_wav = read_wav(out_port)[0], read_wav(out_jax)[0]
    assert res["description"] == "a calm deep voice" and res["bert_s"] > 0
    assert len(port_wav) == len(jax_wav) == 23 * 256
    lsb = np.abs(np.round(port_wav * 32768) - np.round(jax_wav * 32768)).max()
    assert lsb <= 2, f"PCM16 samples differ by {lsb} LSB"
    blank = port_cli(common + ["--out", str(tmp_path / "blank.wav")])
    assert blank["description"] is None and blank["bert_s"] == 0.0
    assert np.abs(read_wav(str(tmp_path / "blank.wav"))[0] - port_wav).max() > 0


def test_say_description_needs_a_local_bert(tmp_path):
    cfg_path, ckpt, _ = _description_files(tmp_path)
    argv = ["say", "--config", cfg_path, "--checkpoint", ckpt, "--text", "x", "--out",
            str(tmp_path / "o.wav"), "--speaker-id", "1", "--device", "cpu",
            "--description", "a calm voice"]
    with pytest.raises(ValueError, match="--bert-checkpoint"):
        port_cli(argv)
    with pytest.raises(FileNotFoundError, match="never downloads"):
        port_cli(argv + ["--bert-checkpoint", "google-bert/bert-base-uncased"])
    assert not (tmp_path / "o.wav").exists()
    # a model without description embeddings ignores a description, as JAX's say
    (tmp_path / "v").mkdir()
    vanilla, v_ckpt, _ = _say_files(tmp_path / "v", 3.0)
    res = port_cli(["say", "--config", vanilla, "--checkpoint", v_ckpt, "--text", "x", "--out",
                    str(tmp_path / "v.wav"), "--max-len-override", "4", "--device", "cpu",
                    "--description", "a calm voice"])
    assert res["description"] is None


def _finetune_corpus(tmp_path):
    speech = tmp_path / "speech"
    speech.mkdir()
    lines = ["id|text|wav|speaker_id|description"]
    for i in range(8):
        write_wav(str(speech / f"u{i}.wav"), _wav(i, 4000 + 300 * i), 22050)
        lines.append(f"{200 + i}|{TEXTS[i % 4]}|u{i}.wav|{i % 3}|{DESCS[i % 5]}")
    csv = tmp_path / "m.csv"
    csv.write_text("\n".join(lines) + "\n")
    (speech / "augmented_ids.csv").write_text("".join(f"{200 + i}\n" for i in range(0, 8, 2)))
    return speech, str(csv)


def test_embed_train_finetune_cli(tmp_path):
    """embed_descriptions (2 augmentations) -> train (pretraining: blank
    embeddings) -> train --finetune (the augmented ids' rows, picking among
    their augmentations): the encoder and the speaker embedding bit for
    bit, the description linear and every other parameter moved."""
    speech, csv = _finetune_corpus(tmp_path)
    bert = _bert_files(tmp_path)
    out = port_cli(["embed_descriptions", "--csv", csv, "--speech-dir", str(speech), "--bert",
                    bert, "--augmentations", "2", "--device", "cpu"])["out_csv"]
    assert out.endswith("-embedded.csv")
    raw = {
        "dataset": {"train": out, "val": out,
                    "preprocessing": {"allowed_chars": CHARS, "end_token": "^", "num_mels": 16,
                                      "trim": False, "cache": False}},
        "training": {"lr": 1e-2, "batch_size": 2, "weight_decay": 1e-6,
                     "precision": "32-true", "name": "desc", "args": {"max_steps": 2}},
        "model": {"scheduler_milestones": [],
                  "args": {"encoded_dim": 32, "encoder_kernel_size": 5, "prenet_dim": 16,
                           "att_rnn_dim": 32, "att_dim": 16, "rnn_hidden_dim": 32,
                           "postnet_dim": 16, "dropout": 0.1, "description_embeddings": True,
                           "description_embeddings_dim": 16}},
        "extensions": {"speaker_tokens": {"active": True, "num_speakers": 3},
                       "descriptions": {"bert_embeddings": True, "finetuneable": True}},
    }
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(raw))
    base = ["train", "--config", str(cfg), "--speech-dir", str(speech), "--device", "cpu"]
    pre = port_cli(base + ["--results-dir", str(tmp_path / "pre")])
    ft = port_cli(base + ["--results-dir", str(tmp_path / "ft"), "--resume-ckpt",
                          pre["checkpoint"], "--finetune", "--finetune-steps", "2"])
    assert ft["checkpoint"].endswith("finetuned.ckpt") and ft["step"] == 4
    assert all(r["rows"] == 4 for r in ft["steps"])  # batch x 2: the 4 augmented rows
    a = load_tacotron2_checkpoint(pre["checkpoint"])[0]
    b = load_tacotron2_checkpoint(ft["checkpoint"])[0]
    for k in a:
        frozen = k.startswith(("encoder.", "speaker_embedding.")) and "running_" not in k \
            and "num_batches" not in k
        if frozen:
            assert torch.equal(a[k], b[k]), k
        elif k.endswith(("weight", "bias")) and not k.startswith("encoder."):
            assert not torch.equal(a[k], b[k]), k
    assert all(np.isfinite(r["loss"]) for r in pre["steps"] + ft["steps"])


@pytest.mark.parametrize("command", ["test", "train_mel_export"])
def test_eval_drivers_refuse_a_description_model(tmp_path, command):
    cfg_path, ckpt, _ = _description_files(tmp_path)
    raw = json.loads(open(cfg_path).read())
    raw["dataset"].update(train="unused.csv", val="unused.csv", test="unused.csv")
    open(cfg_path, "w").write(json.dumps(raw))
    with pytest.raises(NotImplementedError, match="passes no description"):
        port_cli([command, "--config", cfg_path, "--speech-dir", str(tmp_path), "--checkpoint",
                  ckpt, "--results-dir", str(tmp_path / "r"), "--device", "cpu"])
    assert not (tmp_path / "r").exists()


def test_server_refuses_a_description_entry(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg_path, ckpt, _ = _description_files(tmp_path)
    config = {"models": [{"name": "desc", "config": cfg_path, "checkpoint": ckpt}],
              "batching": {"max_batch": 4}}
    with pytest.raises(NotImplementedError, match="'desc'.*passes no description"):
        srv.App(copy.deepcopy(config), device="cpu")


# ---------------------------------------------------------------------------
# K3 / K4's attention cluster at the corpus' long texts (L = 256)


@pytest.mark.parametrize("B,L,S", [(32, 256, 4), (64, 256, 2), (128, 192, 1), (128, 224, 2),
                                   (128, 256, 2), (128, 512, 4)])
def test_attention_cluster_fits_long_texts(B, L, S):
    """``cluster_size``'s one-wave S, doubled while K4's attention block
    would need more than 227 KB: at B = 128 (the description finetune) S =
    1 takes L <= 216 at the configs' widths (H 1024, A 128, K 31), so L =
    224 and 256 run at S = 2; the one-wave S where it fits."""
    from tacotron2_tpu_torch.ops import train_decode as td

    dims = (1024, 128, 640, 31)
    assert td.attention_cluster(B, 132, L, *dims) == S
    assert td.att_smem_bytes(True, L, S, 1024, 128, 640, 31) <= td.SMEM_LIMIT
    assert S == td.cluster_size(B, 132) or \
        td.att_smem_bytes(True, L, S // 2, 1024, 128, 640, 31) > td.SMEM_LIMIT
    # K3's block is smaller than K4's, and both grow with L / S
    assert td.att_smem_bytes(False, L, S, *dims[:2], 640, 31) < \
        td.att_smem_bytes(True, L, S, *dims[:2], 640, 31)
    assert td.att_smem_bytes(True, L + 32, S, *dims[:2], 640, 31) > \
        td.att_smem_bytes(True, L, S, *dims[:2], 640, 31)


def test_teacher_wrappers_launch_the_grown_cluster(monkeypatch):
    """K3 and K4 on meta tensors with a fake library at B = 128, L = 256,
    D = 640: both calls get S = 2 in their dims (slots 9 and 10)."""
    from tacotron2_tpu_torch.ops import build
    from tacotron2_tpu_torch.ops import train_decode as td

    calls = []

    class Fake:
        def t2_teacher_forward(self, ptrs, dims, stream):
            calls.append(list(dims))
            return 0

        def t2_teacher_backward(self, ptrs, dims, stream):
            calls.append(list(dims))
            return 0

    monkeypatch.setattr(td, "_lib", lambda: Fake())
    monkeypatch.setattr(td, "_stream", lambda: 0)
    monkeypatch.setattr(td, "_sms", lambda dev: 132)
    monkeypatch.setattr(build, "require", lambda *a, **k: None)
    meta = lambda *s, dtype=torch.float32: torch.empty(*s, device="meta", dtype=dtype)
    bf = torch.bfloat16
    Bm, Lm, Tm, Hm, Dm, Pm, Am, Km, Nm = 128, 256, 2, 1024, 640, 256, 128, 31, 81
    w = td.TrainWeights(meta(4 * Hm, Pm + Dm + Hm, dtype=bf), meta(4 * Hm),
                        meta(4 * Hm, 2 * Hm + Dm, dtype=bf), meta(4 * Hm),
                        meta(Am, Hm, dtype=bf), meta(Am, 2, Km, dtype=bf), meta(Am, dtype=bf),
                        meta(Nm, Hm + Dm, dtype=bf), meta(Nm))
    enc, att = meta(Bm, Lm, Dm, dtype=bf), meta(Bm, Lm, Am)
    lens, dm = meta(Bm, dtype=torch.int32), meta(Tm, Bm, Hm)
    _, res = td.teacher_forward(w, meta(Tm, Bm, Pm), enc, att, lens, dm, dm)
    td.teacher_backward(w, res, enc, att, lens, dm, dm, meta(Tm, Bm, Nm), meta(Tm, Bm, Lm))
    (fd, bd) = calls
    assert fd[4] == bd[4] == Dm and fd[5] == bd[5] == Lm
    assert fd[9] == 2 and bd[10] == 2  # S: K3's dims[9], K4's dims[10] (after SX)


def test_mel_cache_is_never_read_half_written(tmp_path, monkeypatch):
    """A row twice in a batch (a manifest's rows repeated) is fetched by two
    loader threads at once: one writes the row's mel cache while the other
    looks for it. The cache file is written under another name and renamed
    into place, so the second thread finds it whole or not at all; with
    ``np.save`` straight to the cache path it reads a part (``Failed to
    read all data`` in a finetune whose manifest repeats its rows)."""
    import io
    import threading
    import time

    import tacotron2_tpu_torch.data.dataset as ds_mod

    speech = _small_corpus(tmp_path)
    ds = TTSDataset(["u0.wav"], TEXTS[:1], str(speech), allowed_chars=CHARS, trim=False,
                    num_mels=16, cache=True, cache_dir=str(tmp_path / "cache"))
    save = np.save

    def slow_save(f, arr):  # half the bytes, a pause, the rest
        buf = io.BytesIO()
        save(buf, arr)
        data = buf.getvalue()
        fh = open(f, "wb") if isinstance(f, (str, os.PathLike)) else f
        fh.write(data[:len(data) // 2])
        fh.flush()
        halfway.set()
        time.sleep(0.3)
        fh.write(data[len(data) // 2:])
        if fh is not f:
            fh.close()

    halfway = threading.Event()
    monkeypatch.setattr(ds_mod.np, "save", slow_save)
    out, errors = [], []

    def fetch():
        try:
            out.append(ds[0][0]["mel_spectrogram"])
        except Exception as e:  # noqa: BLE001 - the failure under test
            errors.append(e)

    first = threading.Thread(target=fetch)
    first.start()
    assert halfway.wait(60)  # the first thread is inside its write
    fetch()
    first.join()
    assert not errors, errors
    np.testing.assert_array_equal(out[0], out[1])
    assert [p.name.endswith(".npy") for p in (tmp_path / "cache").iterdir()] == [True]
