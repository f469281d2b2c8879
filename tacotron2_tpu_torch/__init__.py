"""tacotron2_tpu_torch — the PyTorch/CUDA port of tacotron2_tpu for one
NVIDIA H100.

Module names mirror the JAX package (``tacotron2_tpu``), which stays in the
repository as the reference the port is tested against. This package imports
``torch`` and never ``jax``; the host-side modules it needs (config, text,
audio IO) are its own copies. The hand-written CUDA kernels live in
``csrc/`` and are built at first use by ``ops/build.py``.
"""
