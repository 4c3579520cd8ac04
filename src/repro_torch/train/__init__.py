"""Step factories of the port (training, prefill and decode) and the
trainer (``train.trainer``)."""
from .step import (make_prefill_step, make_serve_step,  # noqa: F401
                   make_train_step)
