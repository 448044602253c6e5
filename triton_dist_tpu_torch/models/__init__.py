"""Models and engine of the port (world = 1, contiguous caches)."""

from triton_dist_tpu_torch.models import presets
from triton_dist_tpu_torch.models.config import ModelConfig
from triton_dist_tpu_torch.models.dense import DenseLLM, params_from_jax
from triton_dist_tpu_torch.models.engine import (
    Engine, StreamSession, sample_token)
from triton_dist_tpu_torch.models.kv_cache import KVCacheManager

__all__ = ["ModelConfig", "DenseLLM", "params_from_jax", "Engine",
           "StreamSession", "sample_token", "KVCacheManager", "presets"]
