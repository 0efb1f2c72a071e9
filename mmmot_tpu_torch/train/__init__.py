"""Training: the loss, the optimizer chain, the train step and torch
checkpoints (port of ``mmmot_tpu/train``)."""
