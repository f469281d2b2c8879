"""The port's FLOP model (``tacotron2_tpu_torch/utils/flops.py``) against
the JAX package's ``tacotron2_tpu/utils/flops.py``: every function gives
exactly JAX's count for the model of every file in ``config/``, and the
peaks are the H100 SXM data sheet's."""

from pathlib import Path

import pytest

from run.common import model_config_from as jax_model_config
from tacotron2_tpu.config import load_config as jax_load_config
from tacotron2_tpu.utils import flops as jf
from tacotron2_tpu_torch.config import load_config
from tacotron2_tpu_torch.run.say import model_config_from
from tacotron2_tpu_torch.utils import flops

CONFIGS = sorted(p for p in (Path(__file__).resolve().parent.parent / "config").glob("*.json")
                 if p.name != "server.json")


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_counts_equal_jax(path):
    ref = jax_model_config(jax_load_config(str(path)))
    mine = model_config_from(load_config(str(path)))
    assert mine.encoded_full_dim == ref.encoded_full_dim
    for L in (1, 37, 128, 181):
        for post in (True, False):
            assert flops.decode_step_flops(mine, L, post) == jf.decode_step_flops(ref, L, post)
        for fpc in (4.0, 5.5):
            assert flops.train_frame_flops(mine, L, fpc) == jf.train_frame_flops(ref, L, fpc)
    assert flops.postnet_frame_macs(mine) == jf.postnet_frame_macs(ref)
    assert flops.encoder_char_macs(mine) == jf.encoder_char_macs(ref)


def test_mfu_arithmetic_and_peaks():
    per, rate = 3.7e7, 1.25e6
    assert flops.mfu(per, rate, 197.0) == jf.mfu(per, rate, 197.0)
    tf, frac = flops.mfu(per, rate)
    assert tf == per * rate / 1e12 and frac == tf / 989.0
    assert flops.DEVICE == "NVIDIA H100 80GB HBM3"
    assert (flops.H100_BF16_TFLOPS, flops.H100_INT8_TOPS, flops.H100_HBM_TBPS) == (989, 1979, 3.35)
