"""The port's checkpoints (the JAX package's ``ckpt``)."""
from .manager import CheckpointManager  # noqa: F401
