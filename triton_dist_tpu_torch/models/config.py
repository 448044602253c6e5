"""Model configuration: the port's copy of ``triton_dist_tpu.models.config``
with a torch dtype in place of the jnp one."""

from __future__ import annotations

import dataclasses
import json
import os

import torch


def _scalar_eos(v) -> int:
    """HF configs store eos_token_id as an int or a list; keep the first
    (generation stops on it; multi-eos callers pass stop_tokens to
    ``Engine.serve``)."""
    if v is None:  # "eos_token_id": null is valid HF JSON
        return -1
    if isinstance(v, (list, tuple)):
        return int(v[0]) if v else -1
    return int(v)


@dataclasses.dataclass
class ModelConfig:
    """Architecture hyperparameters for Qwen3-class decoders."""

    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_hidden_layers: int = 4
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 64
    vocab_size: int = 32000
    max_position_embeddings: int = 4096
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    # MoE (0 experts = dense)
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    norm_topk_prob: bool = True
    model_type: str = "qwen3"
    # Qwen3 applies RMSNorm to q/k heads; Llama-3-class models do not.
    qk_norm: bool = True
    eos_token_id: int = -1  # -1 = no stop token

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def param_split(self) -> tuple[int, int, int]:
        """(attn params/layer, mlp params/layer incl. all experts,
        embedding params). Norm weights are omitted (<0.1%)."""
        h = self.hidden_size
        attn = h * self.head_dim * (2 * self.num_attention_heads
                                    + 2 * self.num_key_value_heads)
        if self.is_moe:
            mlp = 3 * h * self.moe_intermediate_size * self.num_experts
        else:
            mlp = 3 * h * self.intermediate_size
        embed = (1 if self.tie_word_embeddings else 2) * h * self.vocab_size
        return attn, mlp, embed

    @classmethod
    def from_hf_config(cls, path_or_dict) -> "ModelConfig":
        """Build from a HF ``config.json`` (file path, model dir, or dict)."""
        if isinstance(path_or_dict, dict):
            cfg = path_or_dict
        else:
            p = path_or_dict
            if os.path.isdir(p):
                p = os.path.join(p, "config.json")
            with open(p) as f:
                cfg = json.load(f)
        return cls(
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg.get("intermediate_size", 0),
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            num_key_value_heads=cfg.get("num_key_value_heads",
                                        cfg["num_attention_heads"]),
            head_dim=cfg.get("head_dim",
                             cfg["hidden_size"] // cfg["num_attention_heads"]),
            vocab_size=cfg["vocab_size"],
            max_position_embeddings=cfg.get("max_position_embeddings", 4096),
            rope_theta=cfg.get("rope_theta", 1e6),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
            tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            num_experts=cfg.get("num_experts", 0),
            num_experts_per_tok=cfg.get("num_experts_per_tok", 0),
            moe_intermediate_size=cfg.get("moe_intermediate_size", 0),
            norm_topk_prob=cfg.get("norm_topk_prob", True),
            model_type=cfg.get("model_type", "qwen3"),
            qk_norm=cfg.get("model_type", "qwen3").startswith("qwen3"),
            eos_token_id=_scalar_eos(cfg.get("eos_token_id", -1)),
        )
