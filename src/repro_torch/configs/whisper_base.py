"""Whisper base [arXiv:2212.04356] — encoder-decoder; conv audio frontend is
a STUB (input_specs provides precomputed 1500-frame embeddings)."""
from .base import FULL_ATTN_SKIP, ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, d_model=512, n_heads=8, n_kv=8, d_head=64,
    d_ff=2048, vocab=51968,  # padded from 51865 to /128
    logical_n_heads=8, logical_vocab=51865,
    act="gelu", rope_theta=0.0,  # whisper uses learned/sinusoidal positions
    enc_layers=6, enc_seq=1500,
    skip_shapes=FULL_ATTN_SKIP,
))
