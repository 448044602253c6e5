"""Models and engine of the port.

``AutoLLM`` (the port of JAX ``models/__init__.py:27-64``) builds a
``DenseLLM`` or a ``Qwen3MoE`` from the config's MoE fields and loads a
local HF checkpoint's safetensors. ``moe_parallel`` and ``world`` reach
the MoE model (``world=4``: tensor parallelism of the experts' widths over
four ranks on the one card; ``moe_parallel="ep", world=4``: expert
parallelism); ``world`` reaches a dense model too (tensor parallelism
over the ranks), which has no ``moe_parallel`` but "tp".
``sp_world`` (with ``sp_axis``) splits mode "sp"'s sequence over that
many ranks: ``AutoLLM.build(cfg, sp_axis="sp", sp_world=4)``.
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
              sp_axis: str | None = None, moe_parallel: str = "tp",
              world: int = 1, sp_world: int = 1):
        if config.is_moe:
            return Qwen3MoE(config, device=device, fwd_mode=fwd_mode,
                            sp_axis=sp_axis, moe_parallel=moe_parallel,
                            world=world, sp_world=sp_world)
        if moe_parallel != "tp":
            raise ValueError(f"a dense model has no experts to shard: "
                             f"moe_parallel={moe_parallel!r}")
        return DenseLLM(config, device=device, fwd_mode=fwd_mode,
                        sp_axis=sp_axis, world=world, sp_world=sp_world)

    @staticmethod
    def from_pretrained(model_dir: str, device=None, fwd_mode: str = "ag_rs",
                        sp_axis: str | None = None, dtype=None,
                        moe_parallel: str = "tp", world: int = 1,
                        sp_world: int = 1):
        """The model of a local HF checkpoint directory (``config.json``
        and ``*.safetensors``) with its weights on ``device``. ``dtype``
        overrides the config's (default bf16). Returns (model, params)."""
        config = ModelConfig.from_hf_config(model_dir)
        if dtype is not None:
            config.dtype = dtype
        model = AutoLLM.build(config, device=device, fwd_mode=fwd_mode,
                              sp_axis=sp_axis, moe_parallel=moe_parallel,
                              world=world, sp_world=sp_world)
        params = model.load_hf_state_dict(_load_safetensors_state(model_dir))
        return model, params
