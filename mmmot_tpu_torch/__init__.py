"""PyTorch/CUDA port of the mmMOT tracker.

A second package beside the JAX reference ``mmmot_tpu``: the same flagship
raw-frames tracking path (compact-first extraction, fused affinity,
integer auction, ID propagation), written with ``torch`` and ``numpy``
only.  The one Pallas TPU kernel of the reference (the fused affinity)
is a hand-written CUDA C++ kernel here (``csrc/affinity.cu``), built with
``nvcc`` on first use and bound through ``ctypes``.

Importing this package never imports JAX, flax, yaml or PIL, and never
compiles anything.
"""
