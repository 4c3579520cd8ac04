"""The port's data pipeline (the JAX package's ``data``)."""
from .pipeline import DataPipeline, synth_corpus  # noqa: F401
