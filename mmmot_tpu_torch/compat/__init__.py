"""Weight interchange: with the JAX package (``from_jax``) and with the
original PyTorch mmMOT's checkpoints (``torch_convert``, ``mappings``,
``pretrained``, ``parity_check``)."""
