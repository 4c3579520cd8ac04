"""Yi-9B [arXiv:2403.04652; hf] — llama-arch dense GQA kv=4."""
from .base import FULL_ATTN_SKIP, ModelConfig, register

CONFIG = register(ModelConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv=4, d_head=128,
    d_ff=11008, vocab=64000,
    logical_n_heads=32, logical_vocab=64000,
    rope_theta=5e6,
    skip_shapes=FULL_ATTN_SKIP,
))
