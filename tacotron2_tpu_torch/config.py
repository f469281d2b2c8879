"""Config system: the reference's 4-section JSON schema, with validation.

The reference consumes a JSON file with exactly four sections — ``dataset``,
``training``, ``model``, ``extensions`` — positionally forwarded into every
``do_*`` driver (reference: main.py:95-107, run/train.py:21-38). We keep the
same on-disk schema (so reference config files load unchanged) but add:

- schema validation with helpful errors (the reference has none, SURVEY §5.6)
- the ``char_embedding_dim`` → ``encoded_dim`` alias (stale reference configs
  pass ``char_embedding_dim``; current code takes ``encoded_dim`` —
  reference: config/vanilla-ljspeech-stop.json:40 vs model/tts_model.py:24)
- defaults merging so minimal configs work
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# ---------------------------------------------------------------------------
# Dataclasses per section
# ---------------------------------------------------------------------------

# Default allowed characters (reference: datasets/tts_dataset.py:17).
ALLOWED_CHARS = "!'(),.:;? \\-ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"


@dataclass
class PreprocessingConfig:
    """Audio/text preprocessing kwargs (reference: TTSDataset ctor,
    datasets/tts_dataset.py:50-99)."""

    allowed_chars: str = ALLOWED_CHARS
    expand_abbreviations: bool = False
    end_token: Optional[str] = "^"
    silence: int = 0
    trim: bool = True
    trim_top_db: float = 60.0
    trim_frame_length: int = 2048
    num_mels: int = 80
    cache: bool = False
    sample_rate: int = 22050

    def __post_init__(self):
        if self.end_token is not None and self.end_token in self.allowed_chars:
            raise ValueError("end_token cannot be in allowed_chars!")

    @property
    def num_chars(self) -> int:
        """Vocabulary size excluding the padding index
        (reference: run/train.py:218-219)."""
        return len(self.allowed_chars) + (self.end_token is not None)


@dataclass
class DatasetConfig:
    train: Optional[str] = None
    test: Optional[str] = None
    val: Optional[str] = None
    preprocessing: PreprocessingConfig = field(default_factory=PreprocessingConfig)


@dataclass
class TrainingConfig:
    lr: float = 1e-3
    batch_size: int = 32
    weight_decay: float = 1e-6
    precision: str = "bf16-mixed"  # bf16 compute for the reference's "16-mixed"
    name: str = "tacotron2"
    float32_matmul_precision: str = "high"
    stopping_val_loss_threshold: Optional[float] = None
    # present in descriptions-libritts.json at the training level; unread there
    description_embeddings: Optional[bool] = None
    # forwarded trainer args (reference: run/train.py:242 Trainer(**args))
    max_steps: int = 100_000
    val_check_interval: Optional[float] = None
    extra_args: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ModelConfig:
    """Tacotron2 hyperparameters (reference: model/tts_model.py:18-76)."""

    encoded_dim: int = 512
    encoder_kernel_size: int = 5
    prenet_dim: int = 256
    att_rnn_dim: int = 1024
    att_dim: int = 128
    rnn_hidden_dim: int = 1024
    postnet_dim: int = 512
    dropout: float = 0.5
    description_embeddings: bool = False
    description_embeddings_dim: int = 0
    # fractions of max_steps -> absolute steps at build time
    # (reference: run/train.py:210-213)
    scheduler_milestones: List[float] = field(default_factory=lambda: [0.5, 0.75])


@dataclass
class SpeakerTokensConfig:
    active: bool = False
    num_speakers: int = 1
    force_speaker: Optional[int] = None
    # present in some reference configs; unread by the reference code
    # (Tacotron2 hard-wires speaker_token_dim = encoded_dim, model/tacotron2.py:38)
    dim: Optional[int] = None


@dataclass
class ControlsConfig:
    active: bool = False
    features: List[str] = field(default_factory=list)


@dataclass
class DescriptionsConfig:
    bert_embeddings: bool = False
    finetuneable: bool = False
    finetune_args: Dict[str, Any] = field(default_factory=dict)


@dataclass
class GstConfig:
    """Global-style-token conditioning (dormant in the reference,
    model/gst.py — live optional block here)."""

    active: bool = False
    token_embedding_size: int = 256


@dataclass
class ProsodyModelConfig:
    """Frozen-predictor perceptual loss (config surface:
    config/controllable-*-prosody-model.json; commented out in the reference,
    run/train.py:188-208 — live here). ``features`` selects the predictor's
    target columns for ``train_prosody`` (defaults to the reference wrapper's
    7 *_norm_clip names, prosody_detector.py:167-175)."""

    active: bool = False
    active_after: float = 0.5
    loss: Optional[str] = None
    features: Optional[List[str]] = None


@dataclass
class ExtensionsConfig:
    speaker_tokens: SpeakerTokensConfig = field(default_factory=SpeakerTokensConfig)
    controls: ControlsConfig = field(default_factory=ControlsConfig)
    descriptions: DescriptionsConfig = field(default_factory=DescriptionsConfig)
    prosody_model: ProsodyModelConfig = field(default_factory=ProsodyModelConfig)
    gst: GstConfig = field(default_factory=GstConfig)


@dataclass
class Config:
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    extensions: ExtensionsConfig = field(default_factory=ExtensionsConfig)

    # ------------------------------------------------------------------
    @property
    def num_chars(self) -> int:
        return self.dataset.preprocessing.num_chars

    @property
    def controls_dim(self) -> int:
        return len(self.extensions.controls.features) if self.extensions.controls.active else 0

    def scheduler_milestones_steps(self) -> List[int]:
        """Fractional milestones -> absolute steps (reference: run/train.py:210-213)."""
        return [int(x * self.training.max_steps) for x in self.model.scheduler_milestones]


# ---------------------------------------------------------------------------
# JSON loading with aliasing + validation
# ---------------------------------------------------------------------------

_MODEL_ARG_ALIASES = {
    # stale configs use char_embedding_dim; current param is encoded_dim
    # (reference quirk, SURVEY §5.6)
    "char_embedding_dim": "encoded_dim",
}


def _build(dc_type, raw: Dict[str, Any], where: str):
    """Build a dataclass from a raw dict, erroring on unknown keys."""
    fields = {f.name: f for f in dataclasses.fields(dc_type)}
    kwargs = {}
    extra: Dict[str, Any] = {}
    for key, value in raw.items():
        if key not in fields:
            extra[key] = value
            continue
        f = fields[key]
        if dataclasses.is_dataclass(f.type) if isinstance(f.type, type) else False:
            value = _build(f.type, value, f"{where}.{key}")
        kwargs[key] = value
    if extra:
        if "extra_args" in fields:
            kwargs.setdefault("extra_args", {}).update(extra)
        else:
            raise ValueError(
                f"Unknown config keys in {where}: {sorted(extra)} "
                f"(valid: {sorted(fields)})"
            )
    return dc_type(**kwargs)


def config_from_dict(raw: Dict[str, Any]) -> Config:
    """Parse a raw 4-section config dict (the reference's on-disk schema)."""
    raw = dict(raw)

    # dataset ---------------------------------------------------------
    ds_raw = dict(raw.get("dataset", {}))
    prep = _build(PreprocessingConfig, ds_raw.pop("preprocessing", {}), "dataset.preprocessing")
    dataset = DatasetConfig(
        train=ds_raw.pop("train", None),
        test=ds_raw.pop("test", None),
        val=ds_raw.pop("val", None),
        preprocessing=prep,
    )
    if ds_raw:
        raise ValueError(f"Unknown config keys in dataset: {sorted(ds_raw)}")

    # training --------------------------------------------------------
    tr_raw = dict(raw.get("training", {}))
    tr_args = dict(tr_raw.pop("args", {}))
    tr_raw.setdefault("max_steps", tr_args.pop("max_steps", 100_000))
    if "val_check_interval" in tr_args:
        tr_raw["val_check_interval"] = tr_args.pop("val_check_interval")
    if tr_args:
        tr_raw.setdefault("extra_args", {}).update(tr_args)
    # the reference's fp16 AMP string runs as bf16 compute
    if tr_raw.get("precision") == "16-mixed":
        tr_raw["precision"] = "bf16-mixed"
    training = _build(TrainingConfig, tr_raw, "training")

    # model -----------------------------------------------------------
    md_raw = dict(raw.get("model", {}))
    md_args = dict(md_raw.pop("args", {}))
    for alias, canonical in _MODEL_ARG_ALIASES.items():
        if alias in md_args:
            md_args.setdefault(canonical, md_args.pop(alias))
    if "scheduler_milestones" in md_raw:
        md_args["scheduler_milestones"] = md_raw.pop("scheduler_milestones")
    if md_raw:
        raise ValueError(f"Unknown config keys in model: {sorted(md_raw)}")
    model = _build(ModelConfig, md_args, "model.args")

    # extensions ------------------------------------------------------
    ex_raw = dict(raw.get("extensions", {}))
    extensions = ExtensionsConfig(
        speaker_tokens=_build(
            SpeakerTokensConfig, ex_raw.pop("speaker_tokens", {}), "extensions.speaker_tokens"
        ),
        controls=_build(ControlsConfig, ex_raw.pop("controls", {}), "extensions.controls"),
        descriptions=_build(
            DescriptionsConfig, ex_raw.pop("descriptions", {}), "extensions.descriptions"
        ),
        prosody_model=_build(
            ProsodyModelConfig, ex_raw.pop("prosody_model", {}), "extensions.prosody_model"
        ),
        gst=_build(GstConfig, ex_raw.pop("gst", {}), "extensions.gst"),
    )
    if ex_raw:
        raise ValueError(f"Unknown config keys in extensions: {sorted(ex_raw)}")

    cfg = Config(dataset=dataset, training=training, model=model, extensions=extensions)
    _validate(cfg)
    return cfg


def _validate(cfg: Config) -> None:
    ext = cfg.extensions
    if ext.speaker_tokens.force_speaker is not None and ext.speaker_tokens.active:
        raise ValueError("Cannot use speaker tokens with force_speaker parameter!")
    if ext.speaker_tokens.force_speaker is not None and ext.controls.active:
        # reference: run/train.py:53-61
        if not all("speaker_norm" in x for x in ext.controls.features):
            raise ValueError(
                "If force_speaker, all controls must be for speaker-normalized values!"
            )
    if cfg.model.description_embeddings and cfg.model.description_embeddings_dim <= 0:
        raise ValueError("description_embeddings requires description_embeddings_dim > 0")


def load_config(path: str) -> Config:
    with open(path) as infile:
        return config_from_dict(json.load(infile))
