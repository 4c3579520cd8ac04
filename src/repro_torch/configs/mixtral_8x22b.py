"""Mixtral 8x22B [arXiv:2401.04088; hf] — 8-expert top-2 MoE, GQA, SWA."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv=8, d_head=128,
    d_ff=16384, expert_d_ff=16384, vocab=32768,
    logical_n_heads=48, logical_vocab=32768,
    n_experts=8, top_k=2,
    window=4096,  # sliding-window attention => bounded KV, long_500k runs
    rope_theta=1e6,
))
