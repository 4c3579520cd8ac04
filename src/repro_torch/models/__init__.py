"""The model zoo of the port (the JAX package's ``models``), so far the
dense family: ``layers``, ``attention`` (with the flash kernel) and ``lm``.
Parameters are ``nn.Module`` trees named as the JAX parameter dictionaries;
layers run in a Python loop where the JAX package scans."""
from . import attention, layers, lm  # noqa: F401
