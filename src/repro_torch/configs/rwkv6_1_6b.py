"""RWKV6 (Finch) 1.6B [arXiv:2404.05892] — attention-free, data-dependent
decay; O(1)-state decode => long_500k runs."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv=0, d_head=64,
    d_ff=7168, vocab=65536,
    logical_n_heads=32, logical_vocab=65536,
    ssm_heads=32,
))
