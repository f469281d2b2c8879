"""Command line of the port.

    python -m tacotron2_tpu_torch say --config config/vanilla-ljspeech-stop.json \\
        --checkpoint X.ckpt --hifi-gan-checkpoint DIR/g_xxx \\
        --text "..." --out o.wav --random-seed 7 [--max-len-override N] [--device cpu]

The options mirror the JAX package's ``main.py say``; the checkpoint is the
reference's Lightning ``.ckpt`` and the vocoder an upstream HiFi-GAN
``g_*`` file with its ``config.json``. It runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
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
    s.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = _parser().parse_args(argv)
    from tacotron2_tpu_torch.config import load_config
    from tacotron2_tpu_torch.run.say import do_say

    return do_say(load_config(args.config), args.checkpoint, args.text, args.out,
                  hifi_gan_checkpoint=args.hifi_gan_checkpoint,
                  random_seed=args.random_seed, max_len_override=args.max_len_override,
                  device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
