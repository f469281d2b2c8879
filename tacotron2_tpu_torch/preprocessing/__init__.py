"""Offline data preparation of the port: the ``preprocess`` command
(LJSpeech and Hi-Fi TTS corpora -> manifests with prosody features) and the
split / normalization commands (``python -m
tacotron2_tpu_torch.preprocessing.splits``). Numpy, scipy and the ``csv``
module only: nothing here imports torch."""
