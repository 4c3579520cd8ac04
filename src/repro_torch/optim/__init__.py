"""The optimizer of the port (the JAX package's ``optim``): AdamW and the
int8 gradient compression of ``compress``."""
from .adamw import (OptState, adamw_update, clip_by_global_norm,  # noqa: F401
                    init_opt_state, lr_schedule)
from .compress import (dequantize, quantize, quantized_psum,  # noqa: F401
                       quantized_psum_tree)
