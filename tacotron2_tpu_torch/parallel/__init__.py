"""Data-parallel training (``mesh``) and the train loop's input staging
(``prefetch``): the counterpart of ``tacotron2_tpu/parallel``."""
