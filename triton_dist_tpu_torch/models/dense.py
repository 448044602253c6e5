"""Qwen3-class dense decoder at world = 1 (the port of
``triton_dist_tpu.models.dense.DenseLLM``).

The module owns the config and the layer objects; the parameters are a
dict shaped like the JAX params pytree, weights in the JAX
``(in, out)`` layout, so :func:`params_from_jax` is a plain copy.
``forward`` updates the KV caches in place (``models.kv_cache``).

LM head: the JAX forward upcasts the (V, H) head to f32 on every call
(``dense.py:185``), which at Qwen3-8B would move 2.5 GB per step in eager
PyTorch. The port keeps one f32 copy, ``params["lm_head_f32"]``, made
once when the params are built or loaded (the same tensor when the model
is already f32). The logits are the same f32 product as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from triton_dist_tpu_torch.layers.common import (
    precompute_rope_cache, rms_norm)
from triton_dist_tpu_torch.layers.tp_attn import TPAttn
from triton_dist_tpu_torch.layers.tp_mlp import TPMLP
from triton_dist_tpu_torch.models.config import ModelConfig
from triton_dist_tpu_torch.runtime.device import default_device


def _unported_sp():
    return NotImplementedError(
        "mode 'sp' (sequence-parallel / paged serving, forward_sp) is not "
        "ported yet (ROADMAP.md, Queue A item 6 and Queue B items 1-2)")


class DenseLLM:
    """Qwen3 decoder. ``device=None`` means the CUDA card (raises when
    there is none); pass ``device="cpu"`` for the plain versions."""

    def __init__(self, config: ModelConfig, device=None,
                 fwd_mode: str = "xla_ar"):
        self.config = config
        self.device = default_device(device)
        self.fwd_mode = fwd_mode
        c = config
        # One module per role, reused across layers (all layers share
        # shapes; params differ per layer).
        self.attn = TPAttn(c.hidden_size, c.num_attention_heads,
                           c.num_key_value_heads, c.head_dim, dtype=c.dtype,
                           fwd_mode=fwd_mode,
                           rms_eps=c.rms_norm_eps, qk_norm=c.qk_norm)
        self.mlp = TPMLP(c.hidden_size, c.intermediate_size, dtype=c.dtype,
                         fwd_mode=fwd_mode)
        self.rope_cache = precompute_rope_cache(
            c.head_dim, c.max_position_embeddings, c.rope_theta,
            device=self.device)

    def set_fwd(self, mode: str):
        """Switch all layers' forward mode."""
        self.fwd_mode = mode
        self.attn.set_fwd(mode)
        self.mlp.set_fwd(mode)

    # -- params ------------------------------------------------------------
    def init(self, seed: int = 0) -> dict:
        """Random params drawn on the model's device from a seeded
        ``torch.Generator`` (scales as in the JAX ``init``)."""
        c, dev = self.config, self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        layers = []
        for _ in range(c.num_hidden_layers):
            layers.append({
                "attn": self.attn.init(gen, dev),
                "mlp": self.mlp.init(gen, dev),
                "ln_attn": torch.ones((c.hidden_size,), dtype=c.dtype,
                                      device=dev),
                "ln_mlp": torch.ones((c.hidden_size,), dtype=c.dtype,
                                     device=dev),
            })

        def table():
            return torch.randn((c.vocab_size, c.hidden_size), generator=gen,
                               device=dev, dtype=c.dtype) * 0.02

        embed = table()
        params = {
            "embed": embed,
            "layers": layers,
            "final_norm": torch.ones((c.hidden_size,), dtype=c.dtype,
                                     device=dev),
            "lm_head": embed if c.tie_word_embeddings else table(),
        }
        return with_f32_head(params)

    # -- forward -----------------------------------------------------------
    def forward(self, params: dict, input_ids: torch.Tensor, kv_caches,
                offset, mode: str | None = None, kv_start=None):
        """input_ids: (B, S) int; kv_caches: [(k, v)] * L, updated in
        place; offset: int write position, or a (B,) tensor of per-row
        positions. Returns (logits (B, S, V) f32, kv_caches).

        ``kv_start``: optional (B,) left-pad boundaries for ragged
        batches: rope positions count from each row's first real token
        and attention never sees the pad prefix."""
        c = self.config
        mode = mode or self.fwd_mode
        if mode == "sp":
            raise _unported_sp()
        b, s = input_ids.shape
        dev = input_ids.device
        steps = torch.arange(s, dtype=torch.int64, device=dev)[None]
        if torch.is_tensor(offset) and offset.dim() == 1:
            offset = offset.to(device=dev, dtype=torch.int64)
            position_ids = offset[:, None] + steps
        else:
            offset = int(offset)
            position_ids = (offset + steps).expand(b, s)
        if kv_start is not None:
            kv_start = torch.as_tensor(kv_start, dtype=torch.int64,
                                       device=dev)
            position_ids = torch.clamp(position_ids - kv_start[:, None],
                                       min=0)

        x = params["embed"][input_ids].reshape(b * s, c.hidden_size)
        for lp, cache in zip(params["layers"], kv_caches):
            h = rms_norm(x, lp["ln_attn"], c.rms_norm_eps)
            a, _ = self.attn(lp["attn"], h, position_ids, self.rope_cache,
                             cache, offset, mode=mode, kv_start=kv_start)
            x = x + a
            h = rms_norm(x, lp["ln_mlp"], c.rms_norm_eps)
            x = x + self.mlp(lp["mlp"], h, mode=mode)

        x = rms_norm(x, params["final_norm"], c.rms_norm_eps)
        logits = x.float() @ params["lm_head_f32"].t()
        return logits.reshape(b, s, c.vocab_size), kv_caches

    # -- HF weights --------------------------------------------------------
    def load_hf_state_dict(self, state: dict) -> dict:
        """Map a HF Qwen3 state dict (name -> tensor or array) to the
        params dict on the model's device."""
        c, dev = self.config, self.device

        def get(name):
            return _to_torch(state[name], c.dtype, dev)

        def lin(name):
            # HF nn.Linear keeps (out, in); the port uses (in, out).
            return get(name).t().contiguous()

        layers = []
        for i in range(c.num_hidden_layers):
            p = f"model.layers.{i}."
            attn = {
                "w_q": lin(p + "self_attn.q_proj.weight"),
                "w_k": lin(p + "self_attn.k_proj.weight"),
                "w_v": lin(p + "self_attn.v_proj.weight"),
                "w_o": lin(p + "self_attn.o_proj.weight"),
            }
            if c.qk_norm:  # absent in Llama-3-class checkpoints
                attn["q_norm"] = get(p + "self_attn.q_norm.weight")
                attn["k_norm"] = get(p + "self_attn.k_norm.weight")
            layers.append({
                "attn": attn,
                "mlp": {
                    "w_gate": lin(p + "mlp.gate_proj.weight"),
                    "w_up": lin(p + "mlp.up_proj.weight"),
                    "w_down": lin(p + "mlp.down_proj.weight"),
                },
                "ln_attn": get(p + "input_layernorm.weight"),
                "ln_mlp": get(p + "post_attention_layernorm.weight"),
            })
        embed = get("model.embed_tokens.weight")
        params = {
            "embed": embed,
            "layers": layers,
            "final_norm": get("model.norm.weight"),
            "lm_head": (embed if c.tie_word_embeddings else
                        get("lm_head.weight")),
        }
        return with_f32_head(params)


def with_f32_head(params: dict) -> dict:
    """Add ``lm_head_f32``, the one f32 copy of the LM head the forward
    multiplies with (the same tensor when the head is already f32)."""
    params["lm_head_f32"] = params["lm_head"].float()
    return params


def _to_torch(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A torch tensor, numpy array (ml_dtypes bfloat16 included) or
    anything ``np.asarray`` takes, as a ``dtype`` tensor on ``device``."""
    if torch.is_tensor(a):
        return a.detach().to(device=device, dtype=dtype)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.uint16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    return t.to(device=device, dtype=dtype)


def params_from_jax(np_tree: dict, config: ModelConfig, device=None) -> dict:
    """The JAX ``DenseLLM`` params pytree, with numpy arrays for leaves,
    as the port's params on ``device`` (default: the CUDA card). Both
    packages use the (in, out) layout, so every leaf is a plain copy."""
    dev = default_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _to_torch(node, config.dtype, dev)

    params = conv(np_tree)
    if config.tie_word_embeddings:
        params["lm_head"] = params["embed"]
    return with_f32_head(params)
