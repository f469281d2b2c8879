"""Weights in and out of the port.

- ``from_jax_params`` / ``hifigan_from_jax_params`` /
  ``prosody_from_jax_params`` / ``gst_from_jax_params`` /
  ``embedding_encoder_from_jax_params``: the JAX package's parameter trees
  (numpy arrays) -> the port's ``state_dict`` (the reference's names and torch
  layouts). The tests use them to run both
  frameworks on the same weights.
- ``load_tacotron2_checkpoint``: the reference's Lightning ``.ckpt``
  (``state_dict`` keys prefixed ``tacotron2.``), a raw state dict, or the
  JAX package's Orbax directory (``lightning_from_orbax``: the weights of
  ``model/`` through ``from_jax_params``, ``config.json`` as the
  hyperparameters, and for a resume ``train/``'s Adam moments, step and
  schedule through ``adam_from_jax_state``; read by ``training/orbax.py``,
  which needs ``tensorstore``).
- ``load_hifigan_checkpoint``: the upstream HiFi-GAN ``g_*`` file
  (``{"generator": state_dict}``) with its ``config.json`` beside it; weight
  norm (``weight_g``, ``weight_v``) is folded into plain weights at load.
- ``load_bert``: BERT's weights and WordPiece vocabulary from local files
  (JAX ``BertEmbedder.from_local``), safetensors read by ``read_safetensors``;
  nothing is ever downloaded.

Layouts, JAX -> torch: Linear (in, out) -> (out, in); Conv1d (W, I, O) ->
(O, I, W); ConvTranspose1d (W, I, O) -> (I, O, W); LSTM (in, 4H) -> (4H, in),
with ``b_ih`` and ``b_hh`` kept apart as in torch.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

LIGHTNING_PREFIX = "tacotron2."


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _linear(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        sd[f"{prefix}.bias"] = _t(p["b"])


def _conv1d(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["w"]).transpose(2, 1, 0))
    if "b" in p:
        sd[f"{prefix}.bias"] = _t(p["b"])


def _bn(sd, prefix, p, s):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    if s is None:
        return
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _lstm(sd, prefix, p, suffix=""):
    sd[f"{prefix}.weight_ih{suffix}"] = _t(np.asarray(p["w_ih"]).T)
    sd[f"{prefix}.weight_hh{suffix}"] = _t(np.asarray(p["w_hh"]).T)
    sd[f"{prefix}.bias_ih{suffix}"] = _t(p["b_ih"])
    sd[f"{prefix}.bias_hh{suffix}"] = _t(p["b_hh"])


def _conv2d(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["w"]).transpose(3, 2, 0, 1))  # (KH, KW, I, O)
    if "b" in p:
        sd[f"{prefix}.bias"] = _t(p["b"])


def gst_from_jax_params(params: dict, state: Optional[dict],
                        prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX ``GST`` (params, state) -> the port's ``GST`` state_dict (keys
    after ``prefix``), the reference's names: ``reference_encoder.convs.{i}``
    / ``.bns.{i}`` / ``.gru`` (``_l0``) and ``stl.embed`` /
    ``stl.attention.W_query`` / ``W_key`` / ``W_value``. Without ``state``
    the BatchNorm statistics are left out (a gradient tree)."""
    sd: Dict[str, torch.Tensor] = {}
    ref = params["reference_encoder"]
    for i, conv in enumerate(ref["convs"]):
        _conv2d(sd, f"{prefix}reference_encoder.convs.{i}", conv)
        _bn(sd, f"{prefix}reference_encoder.bns.{i}", ref["bns"][i],
            state and state["reference_encoder"]["bns"][i])
    _lstm(sd, f"{prefix}reference_encoder.gru", ref["gru"], "_l0")  # GRU: the same four fields
    sd[f"{prefix}stl.embed"] = _t(params["stl"]["embed"])
    for name in ("query", "key", "value"):
        _linear(sd, f"{prefix}stl.attention.W_{name}", params["stl"]["attention"][f"w_{name}"])
    return sd


def embedding_encoder_from_jax_params(params: dict) -> Dict[str, torch.Tensor]:
    """JAX ``EmbeddingEncoder`` params -> the port's state_dict: each layer's
    ``fwd`` / ``bwd`` GRU -> ``encoder``'s ``_l{n}`` / ``_l{n}_reverse``, the
    attention's three bias-free linears."""
    sd: Dict[str, torch.Tensor] = {}
    for n, layer in enumerate(params["gru"]):
        _lstm(sd, "encoder", layer["fwd"], f"_l{n}")
        _lstm(sd, "encoder", layer["bwd"], f"_l{n}_reverse")
    for name in ("history", "context", "v"):
        _linear(sd, f"attention.{name}", params["attention"][name])
    return sd


def decoder_from_jax(dec: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The JAX decoder subtree -> the port's ``Decoder`` state_dict (keys
    after ``prefix``). It also maps a gradient tree of the same structure."""
    sd: Dict[str, torch.Tensor] = {}
    _lstm(sd, f"{prefix}att_rnn", dec["att_rnn"])
    att = dec["attention"]
    _linear(sd, f"{prefix}attention.query_layer", att["query"])
    _linear(sd, f"{prefix}attention.v", att["v"])
    _conv1d(sd, f"{prefix}attention.location_conv", att["location_conv"])
    _linear(sd, f"{prefix}attention.location_dense", att["location_dense"])
    _lstm(sd, f"{prefix}lstm", dec["lstm"])
    _linear(sd, f"{prefix}mel_out", dec["mel_out"])
    _linear(sd, f"{prefix}gate", dec["gate"])
    return sd


def from_jax_params(params: dict, state: Optional[dict]) -> Dict[str, torch.Tensor]:
    """JAX Tacotron 2 (params, state) -> the port's state_dict: the vanilla
    configuration, its speaker embedding (``speaker_embedding.table``), its
    controls (the decoder LSTM's and the mel head's inputs widened by
    them, whose JAX layouts map as the vanilla ones do) and its description
    linear (``description_linear`` -> ``description_embeddings_linear.0``)
    and its GST (``gst.``, ``gst_from_jax_params``). With ``state`` None the BatchNorm running statistics are left out, so a
    gradient tree of the params' structure maps too."""
    sd: Dict[str, torch.Tensor] = {}
    enc = params["encoder"]
    sd["encoder.embedding.weight"] = _t(enc["embedding"]["table"])
    for i in range(3):
        _conv1d(sd, f"encoder.convolutions.{4 * i}", enc["convs"][i])
        _bn(sd, f"encoder.convolutions.{4 * i + 1}", enc["bns"][i],
            state and state["encoder"]["bns"][i])
    _lstm(sd, "encoder.lstm", enc["lstm_fwd"], "_l0")
    _lstm(sd, "encoder.lstm", enc["lstm_bwd"], "_l0_reverse")
    _linear(sd, "prenet.0", params["prenet"]["fc1"])
    _linear(sd, "prenet.3", params["prenet"]["fc2"])
    _linear(sd, "att_encoder", params["att_encoder"])
    if "speaker_embedding" in params:
        sd["speaker_embedding.weight"] = _t(params["speaker_embedding"]["table"])
    if "description_linear" in params:
        _linear(sd, "description_embeddings_linear.0", params["description_linear"])
    if "gst" in params:
        sd.update(gst_from_jax_params(params["gst"], state and state["gst"], "gst."))
    sd.update(decoder_from_jax(params["decoder"], "decoder."))
    post = params["postnet"]
    for i in range(len(post["convs"])):
        _conv1d(sd, f"postnet.postnet.{4 * i}", post["convs"][i])
        _bn(sd, f"postnet.postnet.{4 * i + 1}", post["bns"][i],
            state and state["postnet"]["bns"][i])
    return sd


def prosody_from_jax_params(params: dict) -> Dict[str, torch.Tensor]:
    """JAX ``ProsodyPredictor`` params -> the port's ``ProsodyPredictor``
    state_dict. Conv2d (KH, KW, I, O) -> (O, I, KH, KW); each bidirectional
    RNN layer's ``fwd`` / ``bwd`` cells -> ``rnns.<layer>``'s ``_l0`` /
    ``_l0_reverse`` weights (GRU gates r, z, n and LSTM gates i, f, g, o in
    torch's order on both sides)."""
    sd: Dict[str, torch.Tensor] = {}
    for i, conv in enumerate(params["convs"]):
        sd[f"convs.{i}.weight"] = _t(np.asarray(conv["w"]).transpose(3, 2, 0, 1))
        sd[f"convs.{i}.bias"] = _t(conv["b"])
    _linear(sd, "pre_rnn", params["pre_rnn"])
    for i, layer in enumerate(params["rnn"]):
        _lstm(sd, f"rnns.{i}", layer["fwd"], "_l0")
        _lstm(sd, f"rnns.{i}", layer["bwd"], "_l0_reverse")
    for head in ("frame_weights", "features_out"):
        for fc in ("fc1", "fc2"):
            _linear(sd, f"{head}.{fc}", params[head][fc])
    return sd


def hifigan_from_jax_params(params: dict) -> Dict[str, torch.Tensor]:
    """JAX HiFi-GAN params -> the port's (and the reference generator's,
    with weight norm removed) state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    _conv1d(sd, "conv_pre", params["conv_pre"])
    for i, up in enumerate(params["ups"]):
        sd[f"ups.{i}.weight"] = _t(np.asarray(up["w"]).transpose(1, 2, 0))
        sd[f"ups.{i}.bias"] = _t(up["b"])
    for i, rb in enumerate(params["resblocks"]):
        for name in ("convs1", "convs2", "convs"):
            for j, cp in enumerate(rb.get(name, [])):
                _conv1d(sd, f"resblocks.{i}.{name}.{j}", cp)
    _conv1d(sd, "conv_post", params["conv_post"])
    return sd


def to_lightning(sd: Dict[str, torch.Tensor], hparams: dict | None = None) -> dict:
    """The reference's Lightning checkpoint layout around a state_dict."""
    return {
        "state_dict": {LIGHTNING_PREFIX + k: v for k, v in sd.items()},
        "hyper_parameters": dict(hparams or {}),
    }


def load_tacotron2_checkpoint(path: str) -> Tuple[Dict[str, Any], dict]:
    """Lightning ``.ckpt`` (or raw state dict file), or a JAX Orbax
    directory -> (state_dict, hparams)."""
    if os.path.isdir(path):
        ckpt = lightning_from_orbax(path, with_train=False)
        return ({k[len(LIGHTNING_PREFIX):]: v for k, v in ckpt["state_dict"].items()},
                ckpt["hyper_parameters"])
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    if any(k.startswith(LIGHTNING_PREFIX) for k in sd):
        sd = {k[len(LIGHTNING_PREFIX):]: v for k, v in sd.items()
              if k.startswith(LIGHTNING_PREFIX)}
    return sd, dict(ckpt.get("hyper_parameters", {}))


def _plain_chain(opt_state) -> bool:
    """JAX's ``make_optimizer`` chain without a freeze mask: (clip, decay,
    Adam {count, mu, nu}, the schedule {count}), the empty states None."""
    return (isinstance(opt_state, list) and len(opt_state) == 4
            and opt_state[0] is None and opt_state[1] is None
            and isinstance(opt_state[2], dict) and set(opt_state[2]) == {"count", "mu", "nu"}
            and isinstance(opt_state[3], dict) and set(opt_state[3]) == {"count"})


def adam_from_jax_state(opt_state, model: torch.nn.Module, opt, sched) -> None:
    """JAX's optimizer state (``training/orbax.py::load_train``) into the
    port's ``make_optimizer`` pair over ``model.parameters()``, in place.
    The moments stay on the host (``lightning_from_orbax`` builds the model
    on the meta device; ``load_state_dict`` moves them to the parameters').
    The Adam moments ``mu`` and ``nu`` go through ``from_jax_params`` as the
    weights do (the layouts are transposes), so they map leaf for leaf by
    parameter name; Adam's ``count`` becomes each parameter's ``step``, the
    schedule's ``count`` MultiStepLR's ``last_epoch`` (and the lr it has
    reached). Another structure (a finetune's ``multi_transform`` state) or
    other leaves raise ValueError: the caller loads the weights alone."""
    if not _plain_chain(opt_state):
        raise ValueError("not the plain chain of make_optimizer (clip, decay, Adam, schedule)")
    adam = opt_state[2]
    mu, nu = from_jax_params(adam["mu"], None), from_jax_params(adam["nu"], None)
    named = dict(model.named_parameters())
    if set(mu) != set(named):
        raise ValueError(f"Adam's leaves {sorted(set(mu) ^ set(named))} are not the model's")
    for name, p in named.items():
        if tuple(mu[name].shape) != tuple(p.shape):
            raise ValueError(f"{name}: Adam's moments {tuple(mu[name].shape)} vs "
                             f"{tuple(p.shape)}")
        opt.state[p] = {"step": torch.tensor(float(adam["count"])), "exp_avg": mu[name],
                        "exp_avg_sq": nu[name]}
    count = int(opt_state[3]["count"])
    passed = sum(n for m, n in sched.milestones.items() if m <= count)
    for group, base in zip(opt.param_groups, sched.base_lrs):
        group["lr"] = base * sched.gamma ** passed
    sched.last_epoch, sched._step_count = count, count + 1
    sched._last_lr = [g["lr"] for g in opt.param_groups]


def lightning_from_orbax(ckpt_dir: str, with_train: bool = True) -> dict:
    """A JAX ``train`` checkpoint directory -> the port's Lightning layout
    (``training/checkpoint.py``): ``state_dict`` from ``model/``,
    ``hyper_parameters`` from ``config.json`` (a JAX ``convert`` output's
    ``{"hyper_parameters": ...}`` unwrapped), and with ``with_train`` and a
    ``train/`` item ``global_step`` and, where ``train/`` holds the plain
    chain's state, ``optimizer_states`` and ``lr_schedulers`` (the lr, the
    weight decay and the milestones from the config, as ``train`` builds
    them). Another optimizer state gets JAX's warning and is left out."""
    from tacotron2_tpu_torch.config import config_from_dict
    from tacotron2_tpu_torch.models.layers import Policy
    from tacotron2_tpu_torch.models.tacotron2 import Tacotron2
    from tacotron2_tpu_torch.run.say import model_config_from
    from tacotron2_tpu_torch.training import orbax
    from tacotron2_tpu_torch.training.optimizer import make_optimizer

    params, state, hparams = orbax.load_model(ckpt_dir)
    if set(hparams) == {"hyper_parameters"}:
        hparams = hparams["hyper_parameters"]
    ckpt = to_lightning(from_jax_params(params, state), hparams)
    if not (with_train and orbax.has_train_state(ckpt_dir)):
        return ckpt
    opt_state, step = orbax.load_train(ckpt_dir)
    ckpt["global_step"] = step
    cfg = config_from_dict(hparams)
    with torch.device("meta"):
        model = Tacotron2(model_config_from(cfg), Policy.from_string(cfg.training.precision))
    milestones = [int(x * cfg.training.max_steps) for x in cfg.model.scheduler_milestones]
    opt, sched = make_optimizer(model.parameters(), cfg.training.lr, cfg.training.weight_decay,
                                milestones)
    try:
        adam_from_jax_state(opt_state, model, opt, sched)
    except ValueError as e:
        print(f"warning: optimizer state in {ckpt_dir} does not match the current optimizer; "
              f"starting fresh ({e})")
        return ckpt
    ckpt["optimizer_states"] = [opt.state_dict()]
    ckpt["lr_schedulers"] = [sched.state_dict()]
    return ckpt


def load_strict(module: torch.nn.Module, sd: Dict[str, Any]) -> None:
    """``load_state_dict`` that allows only BatchNorm's
    ``num_batches_tracked`` to be missing."""
    missing, unexpected = module.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"checkpoint does not match the model: missing {missing}, "
                         f"unexpected {unexpected}")


def fold_weight_norm(sd: Dict[str, Any]) -> Dict[str, Any]:
    """w = g * v / ||v||, the norm over every dim but 0 (torch's default)."""
    out = dict(sd)
    for key in list(sd):
        if key.endswith(".weight_v"):
            base = key[: -len(".weight_v")]
            v = sd[key].float()
            g = sd[base + ".weight_g"].float()
            norm = v.pow(2).sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
            out[base + ".weight"] = g * v / norm.clamp_min(1e-12)
            del out[key], out[base + ".weight_g"]
    return out


def load_hifigan_checkpoint(path: str) -> Tuple[dict, Dict[str, Any]]:
    """``g_*`` generator file + sibling ``config.json`` -> (config dict,
    state_dict with weight norm folded)."""
    with open(os.path.join(os.path.dirname(path), "config.json")) as f:
        h = json.load(f)
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if "generator" in sd:
        sd = sd["generator"]
    return h, fold_weight_norm(sd)


# the weights' types, and I64 for a checkpoint's position_ids buffer
SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
                      "I64": torch.int64}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> its tensors on the CPU: an 8-byte
    little-endian header length, a JSON header ({name: {dtype, shape,
    data_offsets}}, "__metadata__"), then the raw little-endian buffers."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + n].decode("utf-8"))
    body = memoryview(data)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, which the "
                             f"reader does not take ({sorted(SAFETENSORS_DTYPES)})")
        begin, end = info["data_offsets"]
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        t = (torch.frombuffer(bytearray(body[begin:end]), dtype=dtype) if end > begin
             else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(info["shape"]).clone()
    return out


def load_bert(path: str):
    """Local BERT weights -> (``models.bert.Bert`` in eval mode on the CPU,
    ``text.wordpiece.WordPiece``). ``path`` is

    - a directory in Hugging Face's layout: ``config.json`` (its
      ``num_attention_heads`` and ``layer_norm_eps``), ``vocab.txt`` (with
      ``tokenizer_config.json``'s lowercasing where there is one) and
      ``model.safetensors`` or ``pytorch_model.bin``; or
    - a torch state-dict file (``.pt`` / ``.bin``, a Lightning-style
      ``{"state_dict": ...}`` wrapper too) with ``vocab.txt`` beside it.

    Any other name raises: the port never downloads (JAX's ``resolve``
    would fall back to ``from_pretrained``)."""
    from tacotron2_tpu_torch.models.bert import bert_from_state_dict
    from tacotron2_tpu_torch.text.wordpiece import WordPiece, load_vocab

    if os.path.isdir(path):
        conf = {}
        if os.path.exists(os.path.join(path, "config.json")):
            with open(os.path.join(path, "config.json")) as f:
                conf = json.load(f)
        st, bin_ = (os.path.join(path, n) for n in ("model.safetensors", "pytorch_model.bin"))
        if os.path.exists(st):
            sd = read_safetensors(st)
        elif os.path.exists(bin_):
            sd = torch.load(bin_, map_location="cpu", weights_only=True)
        else:
            raise FileNotFoundError(f"{path} holds neither model.safetensors nor "
                                    "pytorch_model.bin")
        model = bert_from_state_dict(sd, conf.get("num_attention_heads"),
                                     conf.get("layer_norm_eps", 1e-12))
        return model, WordPiece.from_dir(path)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"BERT weights {path!r} are not a local file or directory: the port reads local "
            "files only and never downloads (give an HF-layout directory or a state-dict "
            "file with vocab.txt beside it)")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd and "pooler.dense.weight" not in sd:
        sd = sd["state_dict"]  # a Lightning-style wrapper
    vocab = os.path.join(os.path.dirname(path) or ".", "vocab.txt")
    if not os.path.exists(vocab):
        raise FileNotFoundError(f"WordPiece vocab not found at {vocab}: place the BERT "
                                "vocab.txt next to the state-dict file")
    return bert_from_state_dict(sd), WordPiece(load_vocab(vocab))
