"""ModelConfig + the assigned input-shape registry.

Padding policy (recorded per arch): vocab padded to a multiple of 128 and
attention heads padded to a multiple of the TP degree (16) where the
published head count does not divide the mesh — standard MaxText/Megatron
practice; ``logical_*`` fields keep the published values for bookkeeping.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

TP = 16  # "model" mesh axis size (production mesh)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                 # padded to TP multiple where needed
    n_kv: int
    d_head: int
    d_ff: int
    vocab: int                   # padded to 128 multiple
    logical_n_heads: int = 0
    logical_vocab: int = 0
    rope_theta: float = 10000.0
    qk_norm: bool = False
    window: Optional[int] = None          # SWA window (mixtral)
    act: str = "swiglu"                   # swiglu | gelu
    attn_bias: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    expert_d_ff: int = 0
    # SSM / hybrid
    d_state: int = 0
    ssm_heads: int = 0
    attn_every: int = 0                   # hybrid: shared attn cadence
    # encoder-decoder / VLM frontends (stubs provide embeddings)
    enc_layers: int = 0
    enc_seq: int = 0                      # whisper: 1500 frames
    prefix_len: int = 0                   # paligemma: 256 patch tokens
    # which shapes this arch skips (with reason) — DESIGN.md §4
    skip_shapes: tuple = ()

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid") or self.window is not None

    def runs(self, shape: str) -> bool:
        return shape not in dict(self.skip_shapes)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4, n_kv=min(self.n_kv, 2) if self.n_kv > 1 else 1,
            d_head=32, d_ff=256, vocab=512,
            logical_n_heads=4, logical_vocab=512,
            n_experts=min(self.n_experts, 4) or 0,
            top_k=min(self.top_k, 2) or 0,
            n_shared_experts=min(self.n_shared_experts, 1) or 0,
            expert_d_ff=128 if self.n_experts else 0,
            d_state=min(self.d_state, 16) or 0,
            ssm_heads=4 if self.ssm_heads else 0,
            attn_every=min(self.attn_every, 2) or 0,
            enc_layers=min(self.enc_layers, 2) or 0,
            enc_seq=min(self.enc_seq, 16) or 0,
            prefix_len=min(self.prefix_len, 8) or 0,
            window=min(self.window, 32) if self.window else None,
        )

    def param_count(self) -> float:
        """Approximate parameter count (for 6ND roofline bookkeeping)."""
        d, L = self.d_model, self.n_layers
        attn = d * (self.n_heads + 2 * self.n_kv) * self.d_head \
            + self.n_heads * self.d_head * d
        if self.family == "moe":
            ffn = 3 * d * self.expert_d_ff * self.n_experts \
                + 3 * d * self.expert_d_ff * self.n_shared_experts \
                + d * self.n_experts
        elif self.family == "ssm":
            attn = 0
            ffn = 6 * d * d + 2 * d * self.d_ff   # rwkv time+channel mix
        elif self.family == "hybrid":
            d_inner = 2 * d
            ffn = d * (2 * d_inner + 2 * self.d_state + self.ssm_heads) \
                + d_inner * d + d * self.d_ff * 3 // self.n_layers
            attn = attn / max(self.attn_every, 1)
        else:
            mult = 3 if self.act == "swiglu" else 2
            ffn = mult * d * self.d_ff
        emb = self.vocab * d
        enc = (attn + 2 * 2 * d * self.d_ff) * self.enc_layers
        return L * (attn + ffn) + emb + enc

    def active_param_count(self) -> float:
        """Active params per token (MoE: top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        attn = d * (self.n_heads + 2 * self.n_kv) * self.d_head \
            + self.n_heads * self.d_head * d
        ffn = 3 * d * self.expert_d_ff * (self.top_k + self.n_shared_experts)
        return L * (attn + ffn) + self.vocab * d


ARCHS: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ModelConfig:
    return ARCHS[name]


FULL_ATTN_SKIP = (("long_500k", "pure full-attention arch: 512K dense-KV "
                   "decode is quadratic/unbounded — skipped per assignment"),)
