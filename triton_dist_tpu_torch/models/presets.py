"""Named configs of the Qwen3 family (the port's copy of
``triton_dist_tpu.models.presets``). Values follow the public HF configs."""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.models.config import ModelConfig


def qwen3_0_6b(**overrides) -> ModelConfig:
    """Qwen3-0.6B (tied embeddings, like the HF config)."""
    return _build(dict(hidden_size=1024, intermediate_size=3072,
                       num_hidden_layers=28, num_attention_heads=16,
                       num_key_value_heads=8, head_dim=128,
                       tie_word_embeddings=True), overrides)


def qwen3_8b(**overrides) -> ModelConfig:
    """Qwen3-8B."""
    return _build(dict(hidden_size=4096, intermediate_size=12288,
                       num_hidden_layers=36, num_attention_heads=32,
                       num_key_value_heads=8, head_dim=128), overrides)


def qwen3_32b(**overrides) -> ModelConfig:
    """Qwen3-32B."""
    return _build(dict(hidden_size=5120, intermediate_size=25600,
                       num_hidden_layers=64, num_attention_heads=64,
                       num_key_value_heads=8, head_dim=128), overrides)


def qwen3_30b_a3b(**overrides) -> ModelConfig:
    """Qwen3-30B-A3B MoE: 128 experts, top-8, ~3B active params."""
    return _build(dict(hidden_size=2048, intermediate_size=0,
                       num_hidden_layers=48, num_attention_heads=32,
                       num_key_value_heads=4, head_dim=128,
                       num_experts=128, num_experts_per_tok=8,
                       moe_intermediate_size=768), overrides)


def _build(fields: dict, overrides: dict) -> ModelConfig:
    """The family's shared fields, then the preset's, then the caller's
    overrides (any field, e.g. a cut depth or a tiny test width)."""
    base = dict(vocab_size=151936, max_position_embeddings=40960,
                rope_theta=1_000_000.0, dtype=torch.bfloat16)
    base.update(fields)
    base.update(overrides)
    return ModelConfig(**base)


def param_count(cfg: ModelConfig) -> int:
    """Approximate parameter count (``ModelConfig.param_split``)."""
    attn, mlp, embed = cfg.param_split()
    return (attn + mlp) * cfg.num_hidden_layers + embed


PRESETS = {
    "qwen3-0.6b": qwen3_0_6b,
    "qwen3-8b": qwen3_8b,
    "qwen3-32b": qwen3_32b,
    "qwen3-30b-a3b": qwen3_30b_a3b,
}
