"""Architecture configs (one module per assigned arch) + shape registry.

A copy of the JAX package's ``configs`` (plain data: the port keeps its own
copy rather than import the reference package).
"""
from .base import (ARCHS, SHAPES, ModelConfig, ShapeSpec, get_arch,
                   register)  # noqa: F401
from . import (mixtral_8x22b, qwen2_moe_a2_7b, whisper_base,  # noqa: F401
               paligemma_3b, zamba2_2_7b, rwkv6_1_6b, command_r_35b,
               yi_9b, qwen3_1_7b, qwen3_14b)
