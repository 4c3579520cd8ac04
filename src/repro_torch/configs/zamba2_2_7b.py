"""Zamba2-2.7B [arXiv:2411.15242; hf] — Mamba2 backbone with shared
attention blocks every 6 layers (shared params, Zamba-style)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv=32, d_head=80,
    d_ff=10240, vocab=32000,
    logical_n_heads=32, logical_vocab=32000,
    d_state=64, ssm_heads=32, attn_every=6,
    window=4096,  # shared-attn KV windowed for long-context decode
))
