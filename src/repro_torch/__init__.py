"""PyTorch/CUDA port of the HyDRA reproduction (the JAX package ``repro``
is the reference it is held against).

Layout mirrors ``repro``: ``core/<module>.py`` for the simulator and
``kernels/<name>/`` for the hand-written Hopper kernels.  Entry points run
on the card unless the caller passes ``device="cpu"`` (``device.resolve``).
"""
