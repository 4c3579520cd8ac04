"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B; hf] — 4 shared + 60
routed experts, top-4."""
from .base import FULL_ATTN_SKIP, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv=16, d_head=128,
    d_ff=1408, expert_d_ff=1408, vocab=152064,  # padded from 151936 to /128
    logical_n_heads=16, logical_vocab=151936,
    n_experts=60, top_k=4, n_shared_experts=4,
    skip_shapes=FULL_ATTN_SKIP,
))
