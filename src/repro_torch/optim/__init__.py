"""The optimizer of the port (the JAX package's ``optim``, so far AdamW;
``compress`` is ROADMAP.md Queue 1 item 13b)."""
from .adamw import (OptState, adamw_update, clip_by_global_norm,  # noqa: F401
                    init_opt_state, lr_schedule)
