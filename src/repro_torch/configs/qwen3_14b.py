"""Qwen3-14B [hf:Qwen/Qwen3-*; hf] — dense GQA, qk-norm.  40 published
heads pad to 48 (multiple of TP=16) for mesh divisibility; the 8 padded
heads are zero-initialized and pruned by wo (DESIGN.md padding policy)."""
from .base import FULL_ATTN_SKIP, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=48, n_kv=8, d_head=128,
    d_ff=17408, vocab=152064,  # padded from 151936 to /128
    logical_n_heads=40, logical_vocab=151936,
    qk_norm=True, rope_theta=1e6,
    skip_shapes=FULL_ATTN_SKIP,
))
