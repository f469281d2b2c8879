"""The port's BERT (``models/bert.py``), its WordPiece tokenizer
(``text/wordpiece.py``), its weight reader (``convert.load_bert``,
``read_safetensors``) and ``embed_descriptions`` against Hugging Face's
``BertTokenizer`` / ``BertModel`` and the JAX package, on random weights (no
downloads).

- WordPiece: the ids equal ``BertTokenizer.encode(text, truncation=True,
  max_length=...)``'s exactly, lowercasing both ways, over accents, CJK,
  punctuation (ASCII and Unicode), control characters and odd whitespace,
  a 101-character word, [UNK] pieces, special tokens in the text, and
  truncation at 512; ``tokenizer_config.json``'s ``do_lower_case``; a
  ``hypothesis`` case over mixed text;
- ``Bert`` against JAX ``Bert.apply`` on the same weights
  (``convert_bert_state_dict``), with tests/test_bert.py's limits: the tiny
  config within 2e-5 (padding masked, token types), bert-base's shapes
  (12 x 768, 12 heads, 30,522 entries) within 2e-4;
- the layouts: a ``bert.``-prefixed checkpoint with ``cls.*`` heads, the old
  ``LayerNorm.gamma`` / ``.beta`` names, the ``position_ids`` buffer, a
  Lightning wrapper, an HF directory with ``model.safetensors`` (F32 and
  BF16) or ``pytorch_model.bin`` all give the tensors of a plain
  ``BertModel.state_dict()``; a name that is not a local path raises;
- ``do_embed_descriptions`` against JAX's on a tiny BERT: the same files
  and manifest column, base and augmented rows within 2e-4 (one seed gives
  both the same [MASK] draws).
"""

import json
import os

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

from run.embed_descriptions import BertEmbedder as JaxEmbedder  # noqa: E402
from run.embed_descriptions import do_embed_descriptions as jax_embed  # noqa: E402
from tacotron2_tpu.models.bert import Bert as JaxBert  # noqa: E402
from tacotron2_tpu.models.bert import convert_bert_state_dict  # noqa: E402
from tacotron2_tpu_torch.convert import load_bert, read_safetensors  # noqa: E402
from tacotron2_tpu_torch.models.bert import bert_from_state_dict, normalize_state_dict  # noqa: E402
from tacotron2_tpu_torch.run.embed_descriptions import BertEmbedder  # noqa: E402
from tacotron2_tpu_torch.run.embed_descriptions import do_embed_descriptions  # noqa: E402
from tacotron2_tpu_torch.text.wordpiece import WordPiece, load_vocab  # noqa: E402

torch.set_num_threads(1)

WORDS = ["a", "calm", "voice", "fast", "angry", "speaker", "slow", "happy", "the", "in", "tone",
         "deep", "un", "cafe", "école", "中", "文", "[", "]", "un", "é", "Caf"]
VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + list("abcdefghijklmnopqrstuvwxyz")
         + list(".,!?'\"-;:()¿’") + WORDS + ["##s", "##ing", "##believ", "##able", "##a", "##b",
                                             "##e", "##fe", "##ly"])
TEXTS = [
    "The calm voices, speaking slowly!",
    "Café naïve ÉCOLE über",
    "中文字 mixed中a text",
    "ctrl\x00\x07chars​ here\tand\r\nthere too　x",
    "a" * 101 + " b",
    "a" * 100,
    "unbelievable unbelievablez unbelievably",
    "hello[MASK]world [CLS] [mask] [SEP]",
    "ΟΔΟΣ Σ x’s ¿que? —dash—",
    "",
    "İstanbul �x éte",
    "semi;colon:(paren) \"quote\" 'tick' a-b_c~d{e}f|g",
]


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    p.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    return str(p)


@pytest.mark.parametrize("lower", [True, False], ids=["lower", "cased"])
@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
def test_wordpiece_ids_equal_hf(vocab_file, text, lower):
    hf = transformers.BertTokenizer(vocab_file, do_lower_case=lower)
    wp = WordPiece(load_vocab(vocab_file), do_lower_case=lower)
    assert wp.encode(text, 512) == hf.encode(text, truncation=True, max_length=512)


@pytest.mark.parametrize("max_length", [512, 16, 3])
def test_wordpiece_truncation_equals_hf(vocab_file, max_length):
    text = " ".join(["the calm voice, unbelievably slow"] * 200)
    hf = transformers.BertTokenizer(vocab_file)
    ids = WordPiece(load_vocab(vocab_file)).encode(text, max_length)
    assert ids == hf.encode(text, truncation=True, max_length=max_length)
    assert len(ids) == max_length


def test_wordpiece_special_ids_and_config(vocab_file, tmp_path):
    wp = WordPiece(load_vocab(vocab_file))
    hf = transformers.BertTokenizer(vocab_file)
    assert wp.mask_token_id == hf.mask_token_id
    assert sorted(wp.all_special_ids) == sorted(hf.all_special_ids)
    d = tmp_path / "tok"
    d.mkdir()
    (d / "vocab.txt").write_text(open(vocab_file, encoding="utf-8").read(), encoding="utf-8")
    assert WordPiece.from_dir(str(d)).do_lower_case  # BertTokenizer's default
    (d / "tokenizer_config.json").write_text(json.dumps({"do_lower_case": False}))
    cased = WordPiece.from_dir(str(d))
    assert not cased.do_lower_case
    assert cased.encode("Café ÉCOLE") == transformers.BertTokenizer(
        vocab_file, do_lower_case=False).encode("Café ÉCOLE")
    (d / "vocab.txt").write_text("a\nb\n")
    with pytest.raises(ValueError, match="special tokens"):
        WordPiece.from_dir(str(d))


hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

_HF = {}


@settings(max_examples=150, deadline=None)
@given(st.lists(st.sampled_from(list("abcdeflnotuvy ÉéüÇ中文.,!?¿’'-\t\n \x07[]MASK")
                                + ["[MASK]", "calm", "voice", "un", "ing", "e\u0301"]),
                max_size=40).map("".join),
       st.booleans())
def test_wordpiece_equals_hf_on_mixed_text(tmp_path_factory, text, lower):
    if "vocab" not in _HF:
        p = tmp_path_factory.mktemp("hyp") / "vocab.txt"
        p.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
        _HF["vocab"] = str(p)
    vocab = _HF["vocab"]
    if lower not in _HF:
        _HF[lower] = (transformers.BertTokenizer(vocab, do_lower_case=lower),
                      WordPiece(load_vocab(vocab), do_lower_case=lower))
    hf, wp = _HF[lower]
    assert wp.encode(text, 32) == hf.encode(text, truncation=True, max_length=32)


# ---------------------------------------------------------------------------
# the model


def _hf_bert(seed, **kw):
    cfg = transformers.BertConfig(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                                  **kw)
    torch.manual_seed(seed)
    return transformers.BertModel(cfg).eval()


TINY = dict(vocab_size=100, hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
            intermediate_size=128, max_position_embeddings=32, type_vocab_size=2)
BASE = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
            intermediate_size=3072, max_position_embeddings=512, type_vocab_size=2)


def test_tiny_bert_matches_jax():
    m = _hf_bert(0, **TINY)
    sd = m.state_dict()
    params, jcfg = convert_bert_state_dict(sd, num_attention_heads=4)
    port = bert_from_state_dict(sd, num_attention_heads=4)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 100, size=(2, 10)).astype(np.int64)
    mask = np.ones((2, 10), np.int64)
    mask[0, 7:], mask[1, 5:] = 0, 0
    tt = np.zeros((2, 10), np.int64)
    tt[:, 4:] = 1
    h_ref, p_ref = JaxBert(jcfg).apply(params, jnp.asarray(ids), jnp.asarray(mask),
                                       jnp.asarray(tt))
    with torch.no_grad():
        h, p = port(torch.as_tensor(ids), torch.as_tensor(mask), torch.as_tensor(tt))
    for b, n in ((0, 7), (1, 5)):
        np.testing.assert_allclose(h[b, :n].numpy(), np.asarray(h_ref)[b, :n], atol=2e-5)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), atol=2e-5)


def test_bert_base_shapes_match_jax():
    m = _hf_bert(1, **BASE)
    params, jcfg = convert_bert_state_dict(m.state_dict())
    port = bert_from_state_dict(m.state_dict())
    c = port.cfg
    assert (c.num_hidden_layers, c.hidden_size, c.num_attention_heads, c.vocab_size,
            c.max_position_embeddings) == (12, 768, 12, 30522, 512)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 30522, size=(2, 64)).astype(np.int64)
    mask = np.ones((2, 64), np.float32)
    mask[1, 40:] = 0
    h_ref, p_ref = JaxBert(jcfg).apply(params, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        h, p = port(torch.as_tensor(ids), torch.as_tensor(mask))
    np.testing.assert_allclose(h[0].numpy(), np.asarray(h_ref)[0], atol=2e-4)
    np.testing.assert_allclose(h[1, :40].numpy(), np.asarray(h_ref)[1, :40], atol=2e-4)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), atol=2e-4)


def _legacy(sd):
    """A BertForPreTraining-style file: ``bert.`` prefix, ``cls.*`` heads,
    gamma / beta LayerNorm names and the position_ids buffer."""
    out = {}
    for k, v in sd.items():
        if k.endswith("LayerNorm.weight"):
            k = k[:-len("weight")] + "gamma"
        elif k.endswith("LayerNorm.bias"):
            k = k[:-len("bias")] + "beta"
        out["bert." + k] = v
    out["bert.embeddings.position_ids"] = torch.arange(32)[None]
    out["cls.predictions.bias"] = torch.zeros(100)
    return out


def test_weight_layouts_give_the_same_tensors(tmp_path):
    from safetensors.torch import save_file

    m = _hf_bert(3, **TINY)
    plain = {k: v for k, v in m.state_dict().items() if not k.endswith("position_ids")}
    vocab = "\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"w{i}" for i in range(95)])
    cases = {}
    for name, sd in (("plain", plain), ("legacy", _legacy(plain)),
                     ("lightning", {"state_dict": plain})):
        d = tmp_path / name
        d.mkdir()
        torch.save(sd, d / "bert.pt")
        (d / "vocab.txt").write_text(vocab + "\n")
        cases[name] = str(d / "bert.pt")
    for name, dtype in (("hf_st", torch.float32), ("hf_st_bf16", torch.bfloat16)):
        d = tmp_path / name
        m.to(dtype).save_pretrained(str(d), safe_serialization=True)
        m.float()
        (d / "vocab.txt").write_text(vocab + "\n")
        cases[name] = str(d)
    d = tmp_path / "hf_bin"
    d.mkdir()
    torch.save(_legacy(plain), d / "pytorch_model.bin")
    (d / "config.json").write_text(json.dumps({"num_attention_heads": 4}))
    (d / "vocab.txt").write_text(vocab + "\n")
    cases["hf_bin"] = str(d)
    st_raw = read_safetensors(os.path.join(cases["hf_st"], "model.safetensors"))
    assert set(st_raw) >= {k for k in plain if not k.endswith("position_ids")}
    save_file({"x": torch.arange(6, dtype=torch.int64).reshape(2, 3),
               "h": torch.randn(4).half()}, str(tmp_path / "x.safetensors"))
    x = read_safetensors(str(tmp_path / "x.safetensors"))
    assert x["x"].tolist() == [[0, 1, 2], [3, 4, 5]] and x["h"].dtype == torch.float16
    for name, path in cases.items():
        model, wp = load_bert(path)
        got = model.state_dict()
        assert set(got) == set(plain), name
        for k, v in plain.items():
            ref = v.to(torch.bfloat16).float() if name == "hf_st_bf16" else v
            assert torch.equal(got[k], ref), (name, k)
        assert wp.mask_token_id == 4
        heads = model.cfg.num_attention_heads
        assert heads == (4 if name.startswith("hf") else 1), name  # config.json, else hidden/64
    assert set(normalize_state_dict(_legacy(plain))) == set(plain)


def test_load_bert_never_downloads(tmp_path):
    with pytest.raises(FileNotFoundError, match="never downloads"):
        load_bert("google-bert/bert-base-uncased")
    torch.save(_hf_bert(0, **TINY).state_dict(), tmp_path / "bert.pt")
    with pytest.raises(FileNotFoundError, match="vocab"):
        load_bert(str(tmp_path / "bert.pt"))


# ---------------------------------------------------------------------------
# embed_descriptions

EMB_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "calm", "voice", "fast",
             "angry", "speaker", "slow", "happy", "##s", "the", "in", "tone", ","]


def _emb_corpus(tmp_path):
    d = tmp_path / "corpus"
    d.mkdir()
    descs = ["a calm voice", "fast angry speaker, in the tone", "", "slow happy voices", "NA"]
    rows = [f"utterance {i}|sub/d{i}.wav|{x}|{i % 2}" for i, x in enumerate(descs)]
    (d / "train.csv").write_text("text|wav|description|speaker_id\n" + "\n".join(rows) + "\n")
    bert = tmp_path / "bert"
    bert.mkdir()
    (bert / "vocab.txt").write_text("\n".join(EMB_VOCAB) + "\n")
    m = _hf_bert(0, vocab_size=len(EMB_VOCAB), hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=64, max_position_embeddings=32)
    torch.save(m.state_dict(), bert / "bert.pt")
    return d, str(bert / "bert.pt")


def test_embed_descriptions_matches_jax(tmp_path):
    from run.common import read_manifest as jax_read

    corpus, bert = _emb_corpus(tmp_path)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    for d in (jdir, pdir):
        d.mkdir()
    csv = str(corpus / "train.csv")
    j_out = jax_embed(csv, str(jdir), out_csv=str(jdir / "m.csv"), augmentations=2, seed=3,
                      batch_size=2, embedder=JaxEmbedder.from_local(bert))
    p_out = do_embed_descriptions(csv, str(pdir), out_csv=str(pdir / "m.csv"), augmentations=2,
                                  seed=3, batch_size=2, bert=bert, device="cpu")
    ref, got = jax_read(j_out), jax_read(p_out)
    assert list(got.columns) == list(ref.columns)
    col = [x if isinstance(x, str) else "" for x in got.description_embedding]
    assert col == [x if isinstance(x, str) else "" for x in ref.description_embedding]
    assert col[2] == col[4] == "" and col[0] == os.path.join("description_embeddings", "d0.npy")
    files = lambda root: sorted(os.path.relpath(os.path.join(a, f), root)
                                for a, _, fs in os.walk(root) for f in fs if f.endswith(".npy"))
    assert files(pdir) == files(jdir) and len(files(pdir)) == 9  # 3 rows x (1 + 2)
    for f in files(pdir):
        a, b = np.load(pdir / f), np.load(jdir / f)
        assert a.shape == (1, 32)
        np.testing.assert_allclose(a, b, atol=2e-4, err_msg=f)
    base = np.load(pdir / "description_embeddings" / "d1.npy")
    aug = np.load(pdir / "description_embeddings" / "d1_augmentations" / "aug0.npy")
    assert np.abs(aug - base).max() > 1e-5  # the masks changed the text


def test_embedder_draws_jax_masks(tmp_path):
    """One Generator state, one [MASK] draw per non-special token in JAX's
    order: the port's and JAX's augmented rows are the same (2e-4), and
    other than the unmasked ones."""
    _, bert = _emb_corpus(tmp_path)
    texts = ["a calm voice , slow", "fast angry speakers in the tone"]
    port, ref = BertEmbedder.from_local(bert, "cpu"), JaxEmbedder.from_local(bert)
    runs = {}
    for drop in (0.0, 0.5):
        runs[drop] = port.embed(texts, drop, np.random.default_rng(5))
        np.testing.assert_allclose(runs[drop], ref.embed(texts, drop, np.random.default_rng(5)),
                                   atol=2e-4)
    assert np.abs(runs[0.5] - runs[0.0]).max() > 1e-5
    with pytest.raises(ValueError, match="Generator"):
        port.embed(texts, 0.5)
