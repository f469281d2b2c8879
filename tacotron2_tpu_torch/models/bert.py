"""BERT encoder: the description embeddings' backbone.

Counterpart of ``tacotron2_tpu/models/bert.py`` (``BertConfig``, ``Bert``,
``convert_bert_state_dict``): post-LN, learned positions, exact gelu, a
-1e9 bias on padded keys, ``pooler_output = tanh(dense(h[:, 0]))``. The
modules keep Hugging Face ``BertModel``'s names, so its state dict loads
as it is. It runs in f32 (TF32 off on the card, ``layers.use_f32_math``),
as JAX's f32 policy computes it: explicit products and a softmax, not
``scaled_dot_product_attention``, so the rounding follows JAX's. BERT has no
kernel of its own here: JAX runs it under XLA, outside any Pallas kernel.

``bert_from_state_dict`` takes what JAX's converter takes, and normalizes
what ``from_pretrained`` would normalize for it: a ``bert.`` key prefix
(``BertForPreTraining`` / ``BertForMaskedLM`` checkpoints, whose ``cls.*``
heads are dropped), the old ``LayerNorm.gamma`` / ``.beta`` names, and the
``position_ids`` / ``token_type_ids`` buffers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12


def _layer(c: BertConfig) -> nn.ModuleDict:
    H, ln = c.hidden_size, lambda: nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
    return nn.ModuleDict({
        "attention": nn.ModuleDict({
            "self": nn.ModuleDict({k: nn.Linear(H, H) for k in ("query", "key", "value")}),
            "output": nn.ModuleDict({"dense": nn.Linear(H, H), "LayerNorm": ln()}),
        }),
        "intermediate": nn.ModuleDict({"dense": nn.Linear(H, c.intermediate_size)}),
        "output": nn.ModuleDict({"dense": nn.Linear(c.intermediate_size, H), "LayerNorm": ln()}),
    })


class Bert(nn.Module):
    def __init__(self, config: BertConfig = BertConfig()):
        super().__init__()
        c = self.cfg = config
        if c.hidden_size % c.num_attention_heads:
            raise ValueError(f"hidden size {c.hidden_size} is not a multiple of "
                             f"{c.num_attention_heads} heads")
        self.embeddings = nn.ModuleDict({
            "word_embeddings": nn.Embedding(c.vocab_size, c.hidden_size),
            "position_embeddings": nn.Embedding(c.max_position_embeddings, c.hidden_size),
            "token_type_embeddings": nn.Embedding(c.type_vocab_size, c.hidden_size),
            "LayerNorm": nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps),
        })
        self.encoder = nn.ModuleDict({"layer": nn.ModuleList(
            [_layer(c) for _ in range(c.num_hidden_layers)])})
        self.pooler = nn.ModuleDict({"dense": nn.Linear(c.hidden_size, c.hidden_size)})

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None, std: float = 0.02):
        """BertModel's init: N(0, std) weights and embeddings, zero biases,
        LayerNorm 1 / 0."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, std, generator=generator)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        return self

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """ids (B, T), mask (B, T) 1 = real -> (last_hidden (B, T, H),
        pooler_output (B, H))."""
        c, e = self.cfg, self.embeddings
        B, T = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones(B, T, device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        h = (e["word_embeddings"](input_ids) + e["position_embeddings"].weight[None, :T]
             + e["token_type_embeddings"](token_type_ids))
        h = self._ln(e["LayerNorm"], h)
        bias = (1.0 - attention_mask.float())[:, None, None, :] * -1e9
        nh = c.num_attention_heads
        hd = c.hidden_size // nh
        for layer in self.encoder["layer"]:
            sa = layer["attention"]["self"]
            q, k, v = (sa[n](h).reshape(B, T, nh, hd).transpose(1, 2)
                       for n in ("query", "key", "value"))
            scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd) + bias
            ctx = torch.matmul(torch.softmax(scores, dim=-1), v).transpose(1, 2).reshape(B, T, -1)
            out = layer["attention"]["output"]
            h = self._ln(out["LayerNorm"], h + out["dense"](ctx))
            inter = F.gelu(layer["intermediate"]["dense"](h))
            h = self._ln(layer["output"]["LayerNorm"], h + layer["output"]["dense"](inter))
        return h, torch.tanh(self.pooler["dense"](h[:, 0]))

    @staticmethod
    def _ln(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, ln.normalized_shape, ln.weight, ln.bias, ln.eps)


_BUFFERS = ("embeddings.position_ids", "embeddings.token_type_ids")


def normalize_state_dict(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A BERT state dict in any of the layouts above -> ``BertModel``'s
    keys, f32 tensors."""
    if any(k.startswith("bert.") for k in sd):
        sd = {k[len("bert."):]: v for k, v in sd.items() if k.startswith("bert.")}
    out = {}
    for k, v in sd.items():
        if k in _BUFFERS:
            continue
        if k.endswith(".gamma") or k.endswith(".beta"):
            k = k.rsplit(".", 1)[0] + (".weight" if k.endswith(".gamma") else ".bias")
        out[k] = torch.as_tensor(v).detach().to("cpu", torch.float32)
    return out


def config_from_state_dict(sd: Dict[str, torch.Tensor],
                           num_attention_heads: Optional[int] = None,
                           layer_norm_eps: float = 1e-12) -> BertConfig:
    """The config the weights imply; the heads default to hidden / 64, as
    JAX's converter sets them (they are not in the weights)."""
    word = sd["embeddings.word_embeddings.weight"]
    n = 0
    while f"encoder.layer.{n}.attention.self.query.weight" in sd:
        n += 1
    hidden = word.shape[1]
    return BertConfig(
        vocab_size=word.shape[0], hidden_size=hidden, num_hidden_layers=n,
        num_attention_heads=num_attention_heads or max(1, hidden // 64),
        intermediate_size=sd["encoder.layer.0.intermediate.dense.weight"].shape[0],
        max_position_embeddings=sd["embeddings.position_embeddings.weight"].shape[0],
        type_vocab_size=sd["embeddings.token_type_embeddings.weight"].shape[0],
        layer_norm_eps=layer_norm_eps)


def bert_from_state_dict(sd: Dict[str, Any], num_attention_heads: Optional[int] = None,
                         layer_norm_eps: float = 1e-12) -> Bert:
    """The weights (``normalize_state_dict``'s layouts) in a ``Bert``,
    loaded strictly, in eval mode on the CPU."""
    sd = normalize_state_dict(sd)
    model = Bert(config_from_state_dict(sd, num_attention_heads, layer_norm_eps))
    model.load_state_dict(sd)
    return model.eval()
