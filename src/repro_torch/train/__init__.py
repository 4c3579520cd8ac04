"""Step factories of the port (so far the serving ones: prefill and
decode); the training step waits for the training slice (ROADMAP.md Queue 1
item 13)."""
from .step import make_prefill_step, make_serve_step  # noqa: F401
