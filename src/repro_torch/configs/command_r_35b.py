"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01] — dense GQA, no bias."""
from .base import FULL_ATTN_SKIP, ModelConfig, register

CONFIG = register(ModelConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv=8, d_head=128,
    d_ff=22528, vocab=256000,
    logical_n_heads=64, logical_vocab=256000,
    rope_theta=8e6,
    skip_shapes=FULL_ATTN_SKIP,
))
