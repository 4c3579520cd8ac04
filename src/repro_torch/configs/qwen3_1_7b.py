"""Qwen3-1.7B [hf:Qwen/Qwen3-*; hf] — dense GQA with per-head qk-norm."""
from .base import FULL_ATTN_SKIP, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv=8, d_head=128,
    d_ff=6144, vocab=152064,  # padded from 151936 to /128
    logical_n_heads=16, logical_vocab=151936,
    qk_norm=True, rope_theta=1e6,
    skip_shapes=FULL_ATTN_SKIP,
))
