"""Command line of the port.

    python -m tacotron2_tpu_torch say --config config/vanilla-ljspeech-stop.json \\
        --checkpoint X.ckpt [--hifi-gan-checkpoint DIR/g_xxx] \\
        --text "..." --out o.wav --random-seed 7 [--max-len-override N] \\
        [--quantize-int8] [--speaker-id N] [--controls a,b,c,d,e] \\
        [--description "a calm voice" --bert-checkpoint BERT] \\
        [--gst-reference REF.wav] [--device cpu]

    python -m tacotron2_tpu_torch train --config C --speech-dir S --results-dir R \\
        [--resume-ckpt F] [--max-steps N] [--seed K] [--device cpu] \\
        [--finetune --finetune-steps N] [--prosody-model-checkpoint P]
    torchrun --nproc-per-node N -m tacotron2_tpu_torch train ...

    python -m tacotron2_tpu_torch train_prosody --config C --speech-dir S \\
        [--results-dir R] [--steps 10000] [--lr 1e-5] [--batch-size 32] [--device cpu]

    python -m tacotron2_tpu_torch server --config config/server.json \\
        [--port 8080] [--mode warm|subprocess] [--device cpu]

    python -m tacotron2_tpu_torch test --config C --speech-dir S --checkpoint X.ckpt \\
        [--hifi-gan-checkpoint G] [--results-dir R] [--batch-size 8] [--limit N] [--device cpu]

    python -m tacotron2_tpu_torch train_mel_export --config C --speech-dir S \\
        --checkpoint X.ckpt [--results-dir R] [--device cpu]

    python -m tacotron2_tpu_torch test_correlation --config C --speech-dir S \\
        --checkpoint X.ckpt [--hifi-gan-checkpoint G] [--analyze/--no-analyze] [--device cpu]

    python -m tacotron2_tpu_torch embed_descriptions --csv M.csv --speech-dir S \\
        --bert BERT [--out-csv O.csv] [--augmentations 2] [--batch-size 32] [--device cpu]

    python -m tacotron2_tpu_torch preprocess --dataset ljspeech|hifi-tts --speech-dir S \\
        [--out-dir D] [--out-postfix P] [--n-jobs 8] [--trim] [--trim-top-db 60]

    python -m tacotron2_tpu_torch convert ORBAX_DIR OUT.ckpt

The options mirror the JAX package's ``main.py`` commands of the same names
(``say --export-mel`` also saves the vocoded mel, (M, frames), as
``o.wav.npy`` for ``--out o.wav``; ``preprocess``'s manifests are split
by ``python -m tacotron2_tpu_torch.preprocessing.splits``): ``--speaker-id``
picks a multi-speaker model's voice and ``--controls`` gives a controllable
model its controls, one number per feature of the config's
``extensions.controls``; ``--description`` a description model its style
description, embedded by the local BERT of ``--bert-checkpoint`` (an
HF-layout directory, or a state-dict file with ``vocab.txt`` beside it; the
port never downloads), which ``embed_descriptions --bert`` takes too;
``--gst-reference`` a GST model (``extensions.gst.active``) the style of
a reference WAV at the config's sample rate (without it, the neutral style
of a zeros reference); checkpoints are the
reference's Lightning ``.ckpt``
(``train`` writes ``R/final.ckpt``, which ``say`` loads; ``train --finetune``
``R/finetuned.ckpt``; ``train_prosody`` ``R/prosody_final.ckpt``, which
``train --prosody-model-checkpoint`` loads) and the vocoder an
upstream HiFi-GAN ``g_*`` file with its ``config.json`` (Griffin-Lim
without one). ``server``'s config is the JAX server's (``models``,
``batching``, ``warmup``). All run on the card unless ``--device cpu`` is
given; ``preprocess`` runs on the host alone and takes no config, and
``embed_descriptions`` takes none either. ``convert`` (the JAX ``convert``
the other way round) writes a JAX Orbax checkpoint directory as the port's
``.ckpt`` (a ``train`` one with its optimizer state and step, or a
``train_prosody`` one); it needs ``tensorstore``, and wherever that is
installed the commands above also take the directory itself.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tacotron2_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    s = sub.add_parser("say", help="synthesize text to a WAV file")
    s.add_argument("--config", required=True, help="a Tacotron hyperparameter config file")
    s.add_argument("--checkpoint", required=True, help="a trained Tacotron model checkpoint")
    s.add_argument("--text", required=True, help="text to speak")
    s.add_argument("--out", default="out.wav", help="the .wav file to write")
    s.add_argument("--hifi-gan-checkpoint", default=None, help="a HiFi-GAN generator checkpoint")
    s.add_argument("--random-seed", type=int, default=None,
                   help="seed of the prenet dropout; random if not given")
    s.add_argument("--max-len-override", type=int, default=5000,
                   help="cap on decoded frames")
    s.add_argument("--quantize-int8", action="store_true",
                   help="decode with int8 LSTM weights (an approximate, faster mode)")
    s.add_argument("--speaker-id", type=int, default=None,
                   help="a speaker ID to use in inference if using a multi-speaker model")
    s.add_argument("--controls", default=None,
                   help="if controls are enabled, a comma-separated list of values to pass "
                        "into the model")
    s.add_argument("--export-mel", action="store_true", help=argparse.SUPPRESS)
    s.add_argument("--description", default=None,
                   help="a style description, for a model with description embeddings")
    s.add_argument("--bert-checkpoint", default=None,
                   help="local BERT weights that embed --description: an HF-layout directory "
                        "or a state-dict file with vocab.txt beside it")
    s.add_argument("--gst-reference", default=None,
                   help="a reference WAV whose style a GST model takes (the neutral style "
                        "without it)")
    s.add_argument("--device", default=None, help="cuda (default) or cpu")

    t = sub.add_parser("train", help="train a Tacotron 2 model")
    t.add_argument("--config", required=True, help="a Tacotron hyperparameter config file")
    t.add_argument("--speech-dir", required=True, help="the directory the manifests' wav "
                                                       "paths are relative to")
    t.add_argument("--results-dir", default=None, help="where logs and checkpoints go")
    t.add_argument("--resume-ckpt", default=None, help="a checkpoint to resume from")
    t.add_argument("--max-steps", type=int, default=None,
                   help="overrides the config's max_steps")
    t.add_argument("--seed", type=int, default=0, help="seed of the weights and dropout")
    t.add_argument("--device", default=None, help="cuda (default) or cpu")
    t.add_argument("--finetune", action="store_true",
                   help="fine-tune the model of --resume-ckpt; needs --finetune-steps")
    t.add_argument("--finetune-steps", type=int, default=None,
                   help="the number of training steps to fine-tune the model")
    t.add_argument("--prosody-model-checkpoint", default=None,
                   help="a prosody model checkpoint (from train_prosody), the frozen style "
                        "loss of a config with extensions.prosody_model.active")

    q = sub.add_parser("train_prosody", help="train the prosody predictor of the style loss")
    q.add_argument("--config", required=True, help="a Tacotron hyperparameter config file")
    q.add_argument("--speech-dir", required=True, help="the directory the manifests' wav "
                                                       "paths are relative to")
    q.add_argument("--results-dir", default=None, help="where logs and checkpoints go")
    q.add_argument("--steps", type=int, default=10000, help="number of training steps")
    q.add_argument("--lr", type=float, default=1e-5, help="learning rate")
    q.add_argument("--batch-size", type=int, default=32)
    q.add_argument("--seed", type=int, default=0, help="seed of the weights and dropout")
    q.add_argument("--device", default=None, help="cuda (default) or cpu")

    v = sub.add_parser("server", help="serve the demo web UI and /generate")
    v.add_argument("--config", required=True, help="a server config file (its model registry)")
    v.add_argument("--port", type=int, default=8080, help="0 picks a free port")
    v.add_argument("--host", default="0.0.0.0", help="the address to listen on")
    v.add_argument("--mode", choices=("warm", "subprocess"), default="warm",
                   help="warm: models stay loaded and requests are micro-batched; "
                        "subprocess: one say process per request")
    v.add_argument("--device", default=None, help="cuda (default) or cpu")

    e = sub.add_parser("test", help="synthesize the config's test split")
    e.add_argument("--config", required=True, help="a Tacotron hyperparameter config file")
    e.add_argument("--speech-dir", required=True, help="the directory the manifests' wav "
                                                       "paths are relative to")
    e.add_argument("--checkpoint", required=True, help="a trained Tacotron model checkpoint")
    e.add_argument("--hifi-gan-checkpoint", default=None, help="a HiFi-GAN generator checkpoint")
    e.add_argument("--results-dir", default="results_test", help="where the wavs go")
    e.add_argument("--batch-size", type=int, default=8)
    e.add_argument("--limit", type=int, default=None, help="the first N rows only")
    e.add_argument("--max-len-override", type=int, default=5000, help=argparse.SUPPRESS)
    e.add_argument("--device", default=None, help="cuda (default) or cpu")

    m = sub.add_parser("train_mel_export",
                       help="teacher-forced mels of the train and val splits as .npy")
    m.add_argument("--config", required=True, help="a Tacotron hyperparameter config file")
    m.add_argument("--speech-dir", required=True, help="the directory the manifests' wav "
                                                       "paths are relative to")
    m.add_argument("--checkpoint", required=True, help="a trained Tacotron model checkpoint")
    m.add_argument("--results-dir", default="results_mel_export", help="where the mels go")
    m.add_argument("--device", default=None, help="cuda (default) or cpu")

    c = sub.add_parser("test_correlation",
                       help="sweep each control over the test split and correlate it with the "
                            "audio's prosody")
    c.add_argument("--config", required=True, help="a Tacotron hyperparameter config file")
    c.add_argument("--speech-dir", required=True, help="the directory the manifests' wav "
                                                       "paths are relative to")
    c.add_argument("--checkpoint", required=True, help="a trained Tacotron model checkpoint")
    c.add_argument("--hifi-gan-checkpoint", default=None, help="a HiFi-GAN generator checkpoint")
    c.add_argument("--analyze", action=argparse.BooleanOptionalAction, default=True,
                   help="after the sweep, correlate control values with extracted acoustic "
                        "features (correlations.csv)")
    c.add_argument("--results-dir", default="results_correlation", help="where the sweep goes")
    c.add_argument("--max-len-override", type=int, default=5000, help=argparse.SUPPRESS)
    c.add_argument("--device", default=None, help="cuda (default) or cpu")

    d = sub.add_parser("embed_descriptions",
                       help="BERT embeddings of a manifest's descriptions, for training")
    d.add_argument("--csv", required=True,
                   help="a pipe-separated manifest with a 'description' text column")
    d.add_argument("--speech-dir", required=True,
                   help="the dataset root; embeddings go under description_embeddings/")
    d.add_argument("--out-csv", default=None,
                   help="the output manifest (default: <csv>-embedded.csv)")
    d.add_argument("--bert", required=True,
                   help="local BERT weights: an HF-layout directory or a state-dict file with "
                        "vocab.txt beside it")
    d.add_argument("--augmentations", type=int, default=0,
                   help="token-dropout augmented variants per description")
    d.add_argument("--batch-size", type=int, default=32)
    d.add_argument("--device", default=None, help="cuda (default) or cpu")

    r = sub.add_parser("preprocess", help="a corpus -> manifests with prosody features")
    r.add_argument("--dataset", required=True, choices=("ljspeech", "hifi-tts"),
                   help="the name of a dataset to preprocess")
    r.add_argument("--speech-dir", required=True, help="the corpus' directory")
    r.add_argument("--out-dir", default="", help="where the manifests go")
    r.add_argument("--out-postfix", default=None, help="the manifests' postfix; the time if "
                                                      "not given")
    r.add_argument("--n-jobs", type=int, default=8, help="worker processes")
    r.add_argument("--trim", action="store_true", help="trim silence into a copy of the audio")
    r.add_argument("--trim-top-db", type=float, default=60.0)

    o = sub.add_parser("convert", help="a JAX Orbax checkpoint directory -> the port's .ckpt")
    o.add_argument("orbax_dir", help="a checkpoint directory of the JAX package's train or "
                                     "train_prosody")
    o.add_argument("out", help="the .ckpt file to write")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = _parser().parse_args(argv)
    if args.command == "preprocess":
        if args.dataset == "ljspeech":
            from tacotron2_tpu_torch.preprocessing.ljspeech import do_preprocess
        else:
            from tacotron2_tpu_torch.preprocessing.hifi_tts import do_preprocess

        postfix = args.out_postfix if args.out_postfix is not None else str(int(time.time()))
        return {"outputs": do_preprocess(args.speech_dir, args.out_dir, postfix, args.n_jobs,
                                         args.trim, args.trim_top_db)}
    if args.command == "convert":
        from tacotron2_tpu_torch.training import checkpoint as ckpt_lib

        return ckpt_lib.convert_orbax(args.orbax_dir, args.out)
    if args.command == "embed_descriptions":
        from tacotron2_tpu_torch.run.embed_descriptions import do_embed_descriptions

        return {"out_csv": do_embed_descriptions(
            args.csv, args.speech_dir, out_csv=args.out_csv, bert=args.bert,
            augmentations=args.augmentations, batch_size=args.batch_size, device=args.device)}
    from tacotron2_tpu_torch.config import config_from_dict

    with open(args.config) as f:
        raw = json.load(f)
    if args.command == "server":
        from tacotron2_tpu_torch.run.server import do_server

        return do_server(args.port, raw, args.mode, device=args.device, host=args.host)
    cfg = config_from_dict(raw)
    if args.command == "train":
        from tacotron2_tpu_torch.run.train import do_train

        return do_train(cfg, raw, args.speech_dir, args.results_dir, args.resume_ckpt,
                        seed=args.seed, max_steps_override=args.max_steps, device=args.device,
                        finetune=args.finetune, finetune_steps=args.finetune_steps,
                        prosody_model_checkpoint=args.prosody_model_checkpoint)
    if args.command == "train_prosody":
        from tacotron2_tpu_torch.run.train_prosody import do_train_prosody

        return do_train_prosody(cfg, raw, args.speech_dir, args.results_dir, steps=args.steps,
                                lr=args.lr, batch_size=args.batch_size, seed=args.seed,
                                device=args.device)
    if args.command == "test":
        from tacotron2_tpu_torch.run.test import do_test

        return do_test(cfg, args.speech_dir, args.checkpoint, args.hifi_gan_checkpoint,
                       args.results_dir, args.batch_size, args.max_len_override, args.limit,
                       device=args.device)
    if args.command == "test_correlation":
        from tacotron2_tpu_torch.run.test_correlation import do_test_correlation

        return do_test_correlation(cfg, args.speech_dir, args.checkpoint,
                                   args.hifi_gan_checkpoint, args.results_dir,
                                   max_len_override=args.max_len_override,
                                   analyze=args.analyze, device=args.device)
    if args.command == "train_mel_export":
        from tacotron2_tpu_torch.run.train_mel_export import do_train_mel_export

        return do_train_mel_export(cfg, args.speech_dir, args.checkpoint, args.results_dir,
                                   device=args.device)
    from tacotron2_tpu_torch.run.say import do_say

    return do_say(cfg, args.checkpoint, args.text, args.out,
                  hifi_gan_checkpoint=args.hifi_gan_checkpoint,
                  random_seed=args.random_seed, max_len_override=args.max_len_override,
                  device=args.device, quantize_int8=args.quantize_int8,
                  speaker_id=args.speaker_id, controls=args.controls,
                  export_mel=args.export_mel, description=args.description,
                  bert_checkpoint=args.bert_checkpoint, gst_reference=args.gst_reference)


if __name__ == "__main__":
    main(sys.argv[1:])
    if sys.argv[1:2] == ["server"]:
        # the server has closed its windows and its socket; end without
        # torch's static destructors, which can abort (SIGABRT) a process
        # whose worker threads have used torch's CPU thread pools
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)
