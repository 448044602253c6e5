"""Models and engine of the port (world = 1).

``AutoLLM`` (the port of JAX ``models/__init__.py:27-64``) builds a
``DenseLLM`` or a ``Qwen3MoE`` from the config's MoE fields and loads a
local HF checkpoint's safetensors.
"""

from __future__ import annotations

import glob
import os

from triton_dist_tpu_torch.models import presets
from triton_dist_tpu_torch.models.config import ModelConfig
from triton_dist_tpu_torch.models.dense import DenseLLM, params_from_jax
from triton_dist_tpu_torch.models.engine import (
    Engine, StreamSession, sample_token)
from triton_dist_tpu_torch.models.kv_cache import KVCacheManager
from triton_dist_tpu_torch.models.qwen_moe import Qwen3MoE

__all__ = ["ModelConfig", "DenseLLM", "Qwen3MoE", "AutoLLM",
           "params_from_jax", "Engine", "StreamSession", "sample_token",
           "KVCacheManager", "presets"]


def _load_safetensors_state(model_dir: str) -> dict:
    """All ``*.safetensors`` shards of ``model_dir`` as one name -> CPU
    tensor dict."""
    from safetensors.torch import load_file

    files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no safetensors under {model_dir}")
    state = {}
    for path in files:
        state.update(load_file(path, device="cpu"))
    return state


class AutoLLM:
    """Builds the model a config names: ``Qwen3MoE`` for an MoE config,
    ``DenseLLM`` otherwise."""

    @staticmethod
    def build(config: ModelConfig, device=None, fwd_mode: str = "ag_rs",
              sp_axis: str | None = None):
        cls = Qwen3MoE if config.is_moe else DenseLLM
        return cls(config, device=device, fwd_mode=fwd_mode, sp_axis=sp_axis)

    @staticmethod
    def from_pretrained(model_dir: str, device=None, fwd_mode: str = "ag_rs",
                        sp_axis: str | None = None, dtype=None):
        """The model of a local HF checkpoint directory (``config.json``
        and ``*.safetensors``) with its weights on ``device``. ``dtype``
        overrides the config's (default bf16). Returns (model, params)."""
        config = ModelConfig.from_hf_config(model_dir)
        if dtype is not None:
            config.dtype = dtype
        model = AutoLLM.build(config, device=device, fwd_mode=fwd_mode,
                              sp_axis=sp_axis)
        params = model.load_hf_state_dict(_load_safetensors_state(model_dir))
        return model, params
