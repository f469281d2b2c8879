"""Tacotron 2 top module and its free-running decodes.

Counterpart of ``tacotron2_tpu/models/tacotron2.py`` for the vanilla
configuration, its speaker tokens, controls, description embeddings and
Global Style Tokens: encoder -> speaker fusion tanh(encoded + speaker
embedding) where the model has speaker tokens -> a description model's
memory widened by tanh(Linear(description, 128)) broadcast over the chars
-> a GST model's widened by its style embedding (``models/gst.py``)
broadcast over the chars (D = ``encoded_full_dim``, in JAX's order) ->
attention-memory projection -> prenet with
AlwaysDropout (on at
inference) -> free-running decode that stops once every row's gate logit is
negative, the controls of a controllable model in its decoder LSTM's and
mel head's inputs -> postnet residual -> length masking (mels -> 0, gates
-> -1000).

``forward_infer`` is the reference decode, one step at a time through the
model's own modules with a stop check after every step. ``forward_infer_fast``
is the production decode: kernel K1 in 64-frame chunks
(``ops/decoder_loop.py``), with identical outputs by its step bookkeeping,
or in its int8 mode kernel K5 for the LSTM cells (JAX
``forward_infer_fused(quantize=True)``), an approximate mode held to < 1%
mean relative mel error and < 0.05 gate drift against ``forward_infer``.
The GST's embedding comes from a reference mel: in ``forward_teacher``
the batch's ground-truth mel (padded, no lengths; train mode updates the
GST's BatchNorm statistics) unless ``gst_reference_mel`` is given; at
inference ``gst_reference_mel``, or the neutral style of a zeros reference
(``GST.neutral``, one row for the batch).

``forward_teacher`` is training's teacher-forced pass (JAX
``forward_teacher(dw_hoist=True)``), with every conditioning above too:
the decode runs as ``TeacherDecode``, kernels K3 and K4
(``ops/train_decode.py``), under the bf16 policy; under F32, and in a
tensor-parallel step column-parallel, on stock ops (``ops/train_scan.py``,
JAX's XLA scan, which JAX runs there too: ``teacher_route``).

A model whose two decoder LSTMs differ in width (``att_rnn_dim !=
rnn_hidden_dim``) takes JAX's XLA routes, as JAX's ``fused_ok`` sends it
there: its decodes run ``forward_infer`` on stock ops (counted in
``STOCK_ROUTES``), its teacher-forced eval (``train=False``) the stock-op
scan. No train step and no int8 decode exist for it, in the JAX package
either: both raise ValueError (``UNEQUAL_TRAIN``, ``UNEQUAL_INT8``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from tacotron2_tpu_torch.models import decoder as decoder_mod
from tacotron2_tpu_torch.models import layers
from tacotron2_tpu_torch.models.encoder import Encoder
from tacotron2_tpu_torch.models.gst import GST
from tacotron2_tpu_torch.models.layers import F32, Policy
from tacotron2_tpu_torch.models.postnet import Postnet
from tacotron2_tpu_torch.ops import build, decoder_loop, train_decode, train_scan
from tacotron2_tpu_torch.parallel import mesh

GATE_MASK_VALUE = -1000.0
# decodes of a model whose two LSTM widths differ, on stock ops (no K1 launch)
STOCK_ROUTES = {"decode_stock": 0}
UNEQUAL_TRAIN = ("a train step of a model whose att_rnn_dim ({}) and rnn_hidden_dim ({}) differ: "
                 "the JAX package's step (forward_teacher(dw_hoist=True)) draws both LSTM "
                 "dropout masks at att_h's shape and fails (ops/train_scan.py:156); its "
                 "teacher-forced eval (train=False) and its decodes run such a model")
UNEQUAL_INT8 = ("the int8 decode packs both LSTM cells for one width, and att_rnn_dim ({}) and "
                "rnn_hidden_dim ({}) differ (the JAX package asserts att_rnn_dim == "
                "rnn_hidden_dim in pack_decoder_params)")
POSTNET_ROWS = 16  # the row tile of a server's F32 postnet (``_postnet_rows``)
DESCRIPTION_DIM = 128  # the description's columns of the memory (JAX tacotron2.py:71-75)


@dataclasses.dataclass(frozen=True)
class Tacotron2Config:
    num_chars: int
    encoded_dim: int = 512
    encoder_kernel_size: int = 5
    num_mels: int = 80
    prenet_dim: int = 256
    att_rnn_dim: int = 1024
    att_dim: int = 128
    rnn_hidden_dim: int = 1024
    postnet_dim: int = 512
    dropout: float = 0.5
    speaker_tokens: bool = False
    num_speakers: int = 1
    controls: bool = False
    controls_dim: int = 0
    description_embeddings: bool = False
    description_embeddings_dim: int = 0
    gst: bool = False
    gst_token_embedding_size: int = 256

    @property
    def encoded_full_dim(self) -> int:
        """The attention memory's width D: the encoder's, widened by 128 with
        description embeddings and by the style's width with GST."""
        return (self.encoded_dim + (DESCRIPTION_DIM if self.description_embeddings else 0)
                + (self.gst_token_embedding_size if self.gst else 0))


class Tacotron2Output(NamedTuple):
    mels: torch.Tensor  # (B, T, M), 0 past each row's length
    mels_post: torch.Tensor  # (B, T, M)
    gates: torch.Tensor  # (B, T, 1), -1000 past each row's length
    alignments: torch.Tensor  # (B, T, L)
    lengths: torch.Tensor  # (B,) steps whose gate stayed >= 0
    n_frames: int  # executed decode steps


class Tacotron2(nn.Module):
    def __init__(self, config: Tacotron2Config, policy: Policy = F32):
        super().__init__()
        c = config
        self.cfg = c
        self.policy = policy
        self.encoder = Encoder(c.num_chars, c.encoded_dim, c.encoder_kernel_size)
        # Sequential indices 0 and 3 are the linears (reference names)
        self.prenet = nn.Sequential(
            nn.Linear(c.num_mels, c.prenet_dim, bias=False), nn.ReLU(), nn.Dropout(c.dropout),
            nn.Linear(c.prenet_dim, c.prenet_dim, bias=False), nn.ReLU(), nn.Dropout(c.dropout),
        )
        if c.speaker_tokens:  # the reference's name (model/tacotron2.py)
            self.speaker_embedding = nn.Embedding(c.num_speakers, c.encoded_dim)
            with torch.no_grad():  # the reference's init: N(0, 0.5)
                self.speaker_embedding.weight.normal_(0.0, 0.5)
        if c.description_embeddings:  # the reference's name
            self.description_embeddings_linear = nn.Sequential(
                nn.Linear(c.description_embeddings_dim, DESCRIPTION_DIM), nn.Tanh())
        if c.gst:
            self.gst = GST(c.num_mels, c.gst_token_embedding_size)
        self.att_encoder = nn.Linear(c.encoded_full_dim, c.att_dim, bias=False)
        self.decoder = decoder_mod.Decoder(
            c.num_mels, c.encoded_full_dim, c.prenet_dim, c.att_rnn_dim, c.att_dim,
            c.rnn_hidden_dim, c.controls_dim)
        self.postnet = Postnet(c.num_mels, c.postnet_dim)

    # ------------------------------------------------------------------
    def _encode(self, chars_idx, chars_len, train: bool = False, generator=None,
                rows: Optional[int] = None, speaker_id: Optional[torch.Tensor] = None,
                description_embeddings: Optional[torch.Tensor] = None,
                gst_embedding: Optional[torch.Tensor] = None):
        """-> encoded (B, L, D), att_encoded (B, L, A), the padded chars'
        mask. ``rows``: run the encoder and its attention projection on
        this many rows (empty rows after the batch's, dropped after), so
        their products have one shape whatever B is. ``speaker_id`` (B,):
        a multi-speaker model's voices, fused as tanh(encoded + embedding);
        then ``description_embeddings`` (B, description_embeddings_dim): a
        description model's tanh(Linear(.)) concatenated to every char;
        then ``gst_embedding`` (B, S): a GST model's style, concatenated to
        every char (JAX ``_encode``, in its order; a model without
        descriptions or GST ignores them, as JAX's does)."""
        c = self.cfg
        if c.speaker_tokens and speaker_id is None:
            raise ValueError("speaker_id tensor required when speaker tokens are active!")
        if c.description_embeddings and description_embeddings is None:
            raise ValueError("description tensor required when description tokens are active!")
        B = chars_idx.shape[0]
        ci, cl = chars_idx, chars_len
        if rows is not None and rows > B:
            ci = torch.nn.functional.pad(chars_idx, (0, 0, 0, rows - B))
            cl = torch.cat([chars_len, chars_len.new_ones(rows - B)])
        encoded = self.encoder(ci, cl, self.policy, train, self.cfg.dropout, generator)
        if self.cfg.speaker_tokens:
            spk = torch.as_tensor(speaker_id)
            if spk.numel() != B:
                raise ValueError(f"want {B} speaker ids, got shape {tuple(spk.shape)}")
            spk = spk.reshape(B).long().cpu()
            if not bool(((spk >= 0) & (spk < self.cfg.num_speakers)).all()):
                raise ValueError(f"speaker_id {spk.tolist()} out of range "
                                 f"[0, {self.cfg.num_speakers})")
            # empty rows: voice 0; ids on the host reach the card without a sync
            spk = torch.nn.functional.pad(spk, (0, ci.shape[0] - B)).to(ci.device,
                                                                       non_blocking=True)
            encoded = torch.tanh(encoded + self.speaker_embedding.weight[spk][:, None, :])
        if c.description_embeddings:
            desc = torch.as_tensor(description_embeddings).to(ci.device, torch.float32)
            if tuple(desc.shape) != (B, c.description_embeddings_dim):
                raise ValueError(f"want description embeddings of shape ({B}, "
                                 f"{c.description_embeddings_dim}), got {tuple(desc.shape)}")
            desc = torch.nn.functional.pad(desc, (0, 0, 0, ci.shape[0] - B))  # empty rows: 0
            lin = self.description_embeddings_linear[0]
            desc = torch.tanh(layers.linear(desc, lin.weight, lin.bias, self.policy))
            encoded = torch.cat([encoded, desc[:, None, :].expand(-1, encoded.shape[1], -1)
                                 .to(encoded.dtype)], dim=-1)
        if c.gst:
            if gst_embedding is None:
                raise ValueError("style embedding required when GST is active!")
            emb = torch.as_tensor(gst_embedding).to(ci.device, torch.float32)
            if tuple(emb.shape) != (B, c.gst_token_embedding_size):
                raise ValueError(f"want a GST embedding of shape ({B}, "
                                 f"{c.gst_token_embedding_size}), got {tuple(emb.shape)}")
            emb = torch.nn.functional.pad(emb, (0, 0, 0, ci.shape[0] - B))  # empty rows: 0
            encoded = torch.cat([encoded, emb[:, None, :].expand(-1, encoded.shape[1], -1)],
                                dim=-1)
        att_encoded = layers.linear(encoded, self.att_encoder.weight, None, self.policy)
        encoded, att_encoded = encoded[:B], att_encoded[:B]
        char_pos = torch.arange(chars_idx.shape[1], device=chars_idx.device)
        mask = char_pos[None, :] >= chars_len[:, None]
        return encoded, att_encoded, mask

    def gst_embedding(self, B: int, reference_mel: Optional[torch.Tensor] = None,
                      train: bool = False) -> Optional[torch.Tensor]:
        """A GST model's style embedding (B, S), None for another model:
        from ``reference_mel`` (B or 1 rows, (., T, M), no lengths; ``train``
        updates the BatchNorm statistics), else the neutral style of a zeros
        reference (JAX ``_infer_style``), computed on one row and broadcast,
        so that a row's style does not depend on its batch."""
        if not self.cfg.gst:
            return None
        if reference_mel is None:
            emb = self.gst.neutral(self.policy)[:, 0]
        else:
            ref = torch.as_tensor(reference_mel).to(self.gst.stl.embed.device, torch.float32)
            if ref.dim() != 3 or ref.shape[0] not in (1, B) or ref.shape[2] != self.cfg.num_mels:
                raise ValueError(f"want a GST reference mel of shape ({B} or 1, T, "
                                 f"{self.cfg.num_mels}), got {tuple(ref.shape)}")
            emb = self.gst(ref, train=train, policy=self.policy)[:, 0]
        return emb.expand(B, -1)

    def _check_controls(self, controls, B: int) -> None:
        """A controllable model takes controls (B, controls_dim); another
        none (JAX ``_check_controls``, with the shape checked too)."""
        c = self.cfg
        if c.controls and controls is None:
            raise ValueError("Controls are enabled, but no control vector was passed!")
        if not c.controls and controls is not None:
            raise ValueError("Controls are disabled, but a control vector was passed!")
        if controls is not None and tuple(controls.shape) != (B, c.controls_dim):
            raise ValueError(f"want controls of shape ({B}, {c.controls_dim}), got "
                             f"{tuple(controls.shape)}")

    def _prenet(self, x, m1, m2):
        x = torch.relu(layers.linear(x, self.prenet[0].weight, None, self.policy)) * m1
        return torch.relu(layers.linear(x, self.prenet[3].weight, None, self.policy)) * m2

    def _masks(self, n, B, device, generator, prenet_dropout):
        if prenet_dropout and self.cfg.dropout > 0.0:
            return decoder_loop.prenet_masks(n, B, self.cfg.prenet_dim, self.cfg.dropout,
                                             generator, device)
        ones = torch.ones(n, B, self.cfg.prenet_dim, device=device)
        return ones, ones

    def _mask_outputs(self, mels, mels_post, gates, aligns, lengths, n_frames):
        T = mels.shape[1]
        mask = (torch.arange(T, device=mels.device)[None, :] >= lengths[:, None])[..., None]
        return Tacotron2Output(
            mels=mels.masked_fill(mask, 0.0),
            mels_post=mels_post.masked_fill(mask, 0.0),
            gates=gates.masked_fill(mask, GATE_MASK_VALUE),
            alignments=aligns, lengths=lengths, n_frames=n_frames,
        )

    def teacher_decoder_in(self, mel, generator: Optional[torch.Generator] = None):
        """The prenet over the ground-truth mel (B, T, M) shifted by one
        frame, AlwaysDropout on -> the teacher-forced decode's input (T, B, P)."""
        x = torch.nn.functional.pad(mel, (0, 0, 1, 0))[:, :mel.shape[1]]
        for lin in (self.prenet[0], self.prenet[3]):
            x = layers.dropout(torch.relu(layers.linear(x, lin.weight, None, self.policy)),
                               self.cfg.dropout, generator)
        return x.transpose(0, 1).contiguous()

    # ------------------------------------------------------------------
    def forward_teacher(self, chars_idx, chars_len, mel, mel_len, train: bool = True,
                        generator: Optional[torch.Generator] = None,
                        lstm_masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                        speaker_id: Optional[torch.Tensor] = None,
                        controls: Optional[torch.Tensor] = None,
                        description_embeddings: Optional[torch.Tensor] = None,
                        gst_reference_mel: Optional[torch.Tensor] = None
                        ) -> Tacotron2Output:
        """Teacher-forced pass over the ground-truth mel (B, T, M): encode
        (with the speaker fusion of a multi-speaker model) -> prenet over the
        mel shifted by one frame (AlwaysDropout, on in train and eval as in
        the reference) -> the teacher-forced decode (``teacher_route``:
        ``TeacherDecode`` under bf16, a controllable model's controls through
        the controls rows of K3 and K4; the stock-op scan under F32) ->
        postnet -> length masking
        by ``mel_len``. ``train``: BatchNorm on batch statistics, dropout in
        the encoder and postnet, LSTM dropout (keep 0.9); it raises for a
        model whose two LSTM widths differ (``UNEQUAL_TRAIN``). Dropout bits come
        from ``generator``; ``lstm_masks`` (T, B, H) x 2 replaces the LSTM's
        (the tests inject JAX's; in a data-parallel step, ``parallel/mesh.py``,
        the global batch's (T, n B, H), of which this rank takes its rows, as
        it draws every mask). ``speaker_id`` (B,), ``controls`` (B,
        controls_dim) and ``description_embeddings`` (B,
        description_embeddings_dim): each row's voice, controls and
        description (JAX ``forward_teacher``'s). A GST model's style comes
        from ``gst_reference_mel`` or else from ``mel`` itself, padded as
        the batch is, with the GST's BatchNorm in ``train``'s mode."""
        c = self.cfg
        if train and not self.equal_widths:
            raise ValueError(UNEQUAL_TRAIN.format(c.att_rnn_dim, c.rnn_hidden_dim))
        B, T, _ = mel.shape
        dev = mel.device
        self._check_controls(controls, B)
        if controls is not None:
            controls = controls.to(device=dev, dtype=torch.float32)
        gst = self.gst_embedding(B, mel if gst_reference_mel is None else gst_reference_mel,
                                 train)
        encoded, att_encoded, _ = self._encode(chars_idx, chars_len, train, generator,
                                               speaker_id=speaker_id,
                                               description_embeddings=description_embeddings,
                                               gst_embedding=gst)
        decoder_in = self.teacher_decoder_in(mel, generator)
        if lstm_masks is not None:  # a data-parallel step's are the global batch's
            lstm_masks = tuple(mesh.local_rows(m, 1) for m in lstm_masks)
        elif train:
            lstm_masks = train_decode.lstm_masks(T, B, c.att_rnn_dim, generator, dev)
        else:  # ones at each cell's width
            lstm_masks = (torch.ones(T, B, c.att_rnn_dim, device=dev),
                          torch.ones(T, B, c.rnn_hidden_dim, device=dev))
        mels, gates, aligns = self.teacher_route()(
            self.decoder, decoder_in, encoded, att_encoded, chars_len,
            *lstm_masks, self.policy.compute_dtype, controls)
        mels = mels.transpose(0, 1)
        post = self.postnet(mels, self.policy, train, c.dropout, generator)
        return self._mask_outputs(mels, mels + post, gates.transpose(0, 1)[..., None],
                                  aligns.transpose(0, 1), mel_len, T)

    def teacher_route(self):
        """The teacher-forced decode of a train step, chosen as JAX's
        ``forward_teacher`` chooses it (``pallas_train_supported``): kernels
        K3 / K4 (``train_decode.teacher_decode``) under the bf16 policy
        without a model group; else the stock-op scan
        (``train_scan.teacher_decode``, JAX's ``run_decode_scan``): under F32
        (``"32-true"`` / ``"32"``), whose f32 products the kernels do not
        take, in a tensor-parallel step, column-parallel over the model
        group, and for a model whose two LSTM widths differ (JAX's eval runs
        its XLA scan there; the kernels take one width)."""
        if (self.policy.compute_dtype == torch.bfloat16 and mesh.model_parallel() is None
                and self.equal_widths):
            return train_decode.teacher_decode
        return train_scan.teacher_decode

    @property
    def equal_widths(self) -> bool:
        """Whether the two decoder LSTMs have one width, which kernels K1,
        K3 and K4 take (JAX's ``fused_ok`` and ``pack_decoder_params``)."""
        return self.cfg.att_rnn_dim == self.cfg.rnn_hidden_dim

    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward_infer(self, chars_idx, chars_len, max_len: int,
                      generator: Optional[torch.Generator] = None,
                      prenet_dropout: bool = True,
                      masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      speaker_id: Optional[torch.Tensor] = None,
                      controls: Optional[torch.Tensor] = None,
                      description_embeddings: Optional[torch.Tensor] = None,
                      gst_reference_mel: Optional[torch.Tensor] = None,
                      row_generators: Optional[Sequence[torch.Generator]] = None,
                      encode_rows: Optional[int] = None,
                      gst_embedding: Optional[torch.Tensor] = None) -> Tacotron2Output:
        """Reference decode: one step at a time, stop after the step where
        every row's gate has fired. Masks are drawn in 64-frame chunks in
        the same order as ``forward_infer_fast``, so one generator state
        gives both the same audio. ``speaker_id`` (B,), ``controls`` (B,
        controls_dim) and ``description_embeddings`` (B, dim): a
        multi-speaker, a controllable and a description model's, each row
        its own; ``gst_reference_mel``: a GST model's reference (else the
        neutral style, ``gst_embedding``). ``row_generators``,
        ``encode_rows`` and ``gst_embedding`` as ``forward_infer_fast``'s
        (JAX ``forward_infer``'s ``row_rngs``): the route of its decodes of a
        model whose two LSTM widths differ."""
        c = self.cfg
        B, L = chars_idx.shape
        dev = chars_idx.device
        self._check_controls(controls, B)
        if controls is not None:
            controls = controls.to(device=dev, dtype=torch.float32)
        if gst_embedding is None:
            gst_embedding = self.gst_embedding(B, gst_reference_mel)
        if row_generators is not None:
            generator = list(row_generators)
        encoded, att_encoded, mask = self._encode(
            chars_idx, chars_len, rows=encode_rows, speaker_id=speaker_id,
            description_embeddings=description_embeddings, gst_embedding=gst_embedding)
        state = decoder_mod.init_state(B, L, c.att_rnn_dim, c.encoded_full_dim,
                                       c.rnn_hidden_dim, dev)
        mels = torch.zeros(B, max_len, c.num_mels, device=dev)
        gates = torch.full((B, max_len), GATE_MASK_VALUE, device=dev)
        aligns = torch.zeros(B, max_len, L, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        lengths = torch.zeros(B, dtype=torch.int32, device=dev)
        prev = torch.zeros(B, c.num_mels, device=dev)
        t = 0
        while t < max_len:
            if t % decoder_loop.T_CHUNK == 0:
                n = min(decoder_loop.T_CHUNK, max_len - t)
                if masks is not None:
                    m1, m2 = masks[0][t:t + n], masks[1][t:t + n]
                else:
                    m1, m2 = self._masks(n, B, dev, generator, prenet_dropout)
            k = t % decoder_loop.T_CHUNK
            x = self._prenet(prev, m1[k], m2[k])
            mel, gate, state = self.decoder.step(x, state, encoded, att_encoded, mask,
                                                 self.policy, controls)
            g = gate[:, 0]
            mels[:, t], gates[:, t], aligns[:, t] = mel, g, state.att_weights
            done = done | (g < 0.0)
            lengths = lengths + (g >= 0.0).int()
            prev = mel
            t += 1
            if bool(done.all()):
                break
        post = self._postnet_rows(mels, encode_rows is not None)
        return self._mask_outputs(mels, mels + post, gates[..., None], aligns, lengths, t)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward_infer_fast(self, chars_idx, chars_len, max_len: int,
                           generator: Optional[torch.Generator] = None,
                           prenet_dropout: bool = True,
                           masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                           quantize: bool = False,
                           packed: Optional[decoder_loop.PackedDecoder] = None,
                           row_generators: Optional[Sequence[torch.Generator]] = None,
                           encode_rows: Optional[int] = None,
                           speaker_id: Optional[torch.Tensor] = None,
                           controls: Optional[torch.Tensor] = None,
                           description_embeddings: Optional[torch.Tensor] = None,
                           gst_reference_mel: Optional[torch.Tensor] = None,
                           gst_embedding: Optional[torch.Tensor] = None
                           ) -> Tacotron2Output:
        """Production decode through kernel K1 (``ops/decoder_loop.py``), or
        through K5 for an int8 pack: the kernels on the card, their plain
        versions on the CPU. ``quantize``: pack the decoder int8 for this
        call (JAX ``forward_infer_fused(quantize=True)``); ``packed``: a
        pack made once by ``make_packed_decoder``, which carries its own
        mode. ``row_generators``: one generator per row, so each row's
        prenet masks are those of a batch of one seeded alike (the JAX
        ``row_rngs``); it takes the place of ``generator``. ``encode_rows``:
        the rows the encoder runs (``_encode``'s ``rows``): a server that
        passes its largest window makes a row's encoding the same in every
        window (bf16 products of another shape may sum in another order);
        under F32 it also puts the postnet on fixed row tiles
        (``_postnet_rows``). ``speaker_id`` (B,), ``controls`` (B, controls_dim) and
        ``description_embeddings`` (B, dim): each row's voice, controls and
        description, for a multi-speaker, a controllable and a description
        model (the controls go through the controls rows of K1 or K5; a
        description widens the memory the kernels read by 128 columns).
        A GST model's style widens it by S columns: ``gst_embedding`` (B, S)
        where the caller holds it (the server's neutral style, computed at
        load), else from ``gst_reference_mel`` or the neutral style
        (``gst_embedding``). A model whose two LSTM widths differ runs
        ``forward_infer`` on stock ops instead (JAX's ``fused_ok`` false),
        counted as ``decode_stock``; ``quantize`` or a pack raise for it."""
        c = self.cfg
        B = chars_idx.shape[0]
        if not self.equal_widths:
            if quantize or packed is not None:
                raise ValueError(UNEQUAL_INT8.format(c.att_rnn_dim, c.rnn_hidden_dim))
            build.count(STOCK_ROUTES, "decode_stock")
            return self.forward_infer(
                chars_idx, chars_len, max_len, generator=generator, prenet_dropout=prenet_dropout,
                masks=masks, speaker_id=speaker_id, controls=controls,
                description_embeddings=description_embeddings,
                gst_reference_mel=gst_reference_mel, row_generators=row_generators,
                encode_rows=encode_rows, gst_embedding=gst_embedding)
        self._check_controls(controls, B)
        if gst_embedding is None:
            gst_embedding = self.gst_embedding(B, gst_reference_mel)
        encoded, att_encoded, _ = self._encode(chars_idx, chars_len, rows=encode_rows,
                                               speaker_id=speaker_id,
                                               description_embeddings=description_embeddings,
                                               gst_embedding=gst_embedding)
        pk = packed if packed is not None else self.make_packed_decoder(quantize)
        mels, gates, aligns, lengths, n_frames = decoder_loop.decode(
            pk, encoded.to(pk.wq.dtype).contiguous(), att_encoded.contiguous(),
            chars_len.to(torch.int32).contiguous(), max_len, dropout=c.dropout,
            generator=generator if row_generators is None else list(row_generators),
            prenet_dropout=prenet_dropout, masks=masks, controls=controls)
        post = self._postnet_rows(mels, encode_rows is not None)
        return self._mask_outputs(mels, mels + post, gates[..., None], aligns, lengths,
                                  n_frames)

    def _postnet_rows(self, mels, fixed_rows: bool):
        """The inference postnet over mels (B, T, M). With ``fixed_rows``
        under F32 (a server's windows, ``encode_rows``) it runs in tiles of
        POSTNET_ROWS rows, the last one padded: its f32 convs then take one
        shape, and so one order of sums, whatever B, and a row's audio
        equals the row alone. Else at B rows (the served rows of the bf16
        policy read equal to alone at B rows)."""
        if not fixed_rows or self.policy.compute_dtype != torch.float32:
            return self.postnet(mels, self.policy)
        B = mels.shape[0]
        pad = torch.nn.functional.pad(mels, (0, 0, 0, 0, 0, -B % POSTNET_ROWS))
        return torch.cat([self.postnet(t, self.policy)
                          for t in pad.split(POSTNET_ROWS)])[:B]

    def make_packed_decoder(self, quantize: bool = False
                            ) -> Optional[decoder_loop.PackedDecoder]:
        """The decoder in the kernels' layout, int8 with ``quantize``, with
        the controls' columns of a controllable model: a warm server packs
        once at load and passes it to every decode (each decode brings its
        rows' controls). None for a model whose two LSTM widths differ (its
        decodes take no pack), which raises with ``quantize``."""
        if not self.equal_widths:
            if quantize:
                raise ValueError(UNEQUAL_INT8.format(self.cfg.att_rnn_dim,
                                                     self.cfg.rnn_hidden_dim))
            return None
        return decoder_loop.pack_decoder(self.prenet, self.decoder, self.policy.compute_dtype,
                                         quantize)
