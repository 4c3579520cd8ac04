"""PaliGemma-3B [arXiv:2407.07726; hf] — SigLIP vision frontend is a STUB
(256 precomputed patch embeddings) + gemma-style decoder (GQA kv=1)."""
from .base import FULL_ATTN_SKIP, ModelConfig, register

CONFIG = register(ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv=1, d_head=256,
    d_ff=16384, vocab=257280,  # padded from 257216 to /128
    logical_n_heads=8, logical_vocab=257216,
    prefix_len=256,
    skip_shapes=FULL_ATTN_SKIP,
))
