"""Qwen3-MoE decoder (the port of
``triton_dist_tpu.models.qwen_moe.Qwen3MoE``).

Dense attention (``layers.tp_attn``) and the sparse FFN of
``layers.tp_moe.TPMoE``. As in JAX, the forward and the sequence-parallel
forward are the dense model's, with the FFN swapped:

* ``forward`` (modes ``xla_ar``, ``gemm_ar``, ``ag_rs``, ``xla``):
  attention runs the requested mode; the MoE runs ``xla`` for ``xla`` /
  ``xla_ar`` and ``ag_rs`` otherwise (JAX ``qwen_moe.py:160-162``);
* ``forward_sp`` (mode ``sp``, paged or contiguous caches, the
  flash-decode kernels at decode): the FFN is :meth:`Qwen3MoE._sp_ffn`,
  ``topk_routing`` -> ``grouped_expert_ffn`` -> ``topk_reduce`` on the
  grouped-GEMM kernel (gate and up stay f32 and round once after the
  SwiGLU, as JAX's ``grouped_expert_ffn``).

Expert parallelism (``moe_parallel="ep"``, :class:`~triton_dist_tpu_torch.
layers.ep_moe.EPMoE`) over ``world`` ranks on the one device
(``runtime.dist``): the experts are sharded over the ranks, tokens reach
them through the all-to-all (the hand-written kernel on the card), and
attention is TP over the same ranks. The mode choice is JAX's
``forward`` (qwen_moe.py:136-160): the MoE runs EP in every mode, and
attention runs the requested mode, but in mode ``"ep"`` the fused
``ag_rs`` path over the ring kernels, or ``gemm_ar`` where the rows do
not split over the ranks. ``sp_axis`` needs ``moe_parallel="tp"`` and a
tensor-parallel world of 1, as in JAX; mode "sp" runs at a sequence world
of 1 only (``sp_world``).

Tensor parallelism (``moe_parallel="tp"``, the default) over ``world``
ranks on the one device: attention is TP over the ranks in the requested
mode (the ring kernels in ``ag_rs`` / ``gemm_ar``), and
:class:`~triton_dist_tpu_torch.layers.tp_moe.TPMoE` shards every
expert's width over them: its token all-gather runs the world-W
all-gather kernel in MoE mode ``ag_rs`` (model modes ``gemm_ar`` and
``ag_rs``), its grouped products read each rank's expert shard as a
view, and its reduce-scatter is JAX's ring.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.layers.common import precompute_rope_cache
from triton_dist_tpu_torch.layers.ep_moe import EPMoE
from triton_dist_tpu_torch.layers.tp_attn import TPAttn
from triton_dist_tpu_torch.layers.tp_moe import TPMoE
from triton_dist_tpu_torch.models.config import ModelConfig
from triton_dist_tpu_torch.models.dense import (
    DenseLLM, _to_torch, with_f32_head)
from triton_dist_tpu_torch.ops.group_gemm import grouped_expert_ffn
from triton_dist_tpu_torch.ops.moe_utils import topk_reduce, topk_routing
from triton_dist_tpu_torch.runtime.device import default_device
from triton_dist_tpu_torch.runtime.dist import create_rank_group


class Qwen3MoE:
    """Qwen3-MoE decoder. ``device=None`` means the CUDA card (raises when
    there is none); ``sp_axis`` (any name) enables mode "sp";
    ``world`` W shards the attention heads over W ranks on the device, and
    the experts' widths (``moe_parallel="tp"``) or the experts themselves
    (``moe_parallel="ep"``)."""

    def __init__(self, config: ModelConfig, device=None,
                 fwd_mode: str = "ag_rs", impl: str = "pallas",
                 moe_parallel: str = "tp", sp_axis: str | None = None,
                 world: int = 1, sp_world: int = 1):
        if not config.is_moe:
            raise ValueError("Qwen3MoE needs an MoE config (num_experts > "
                             "0); use DenseLLM for dense ones")
        if moe_parallel not in ("tp", "ep"):
            raise ValueError(f"unknown moe_parallel {moe_parallel!r}")
        if sp_axis is not None and (moe_parallel != "tp" or world != 1):
            raise ValueError("mode 'sp' needs moe_parallel='tp' at world 1 "
                             "(JAX: a pure-sp grid; ep x sp is future work)")
        if sp_world != 1:
            raise NotImplementedError(
                f"Qwen3MoE in mode 'sp' at sequence world {sp_world} is not "
                f"ported yet (ROADMAP.md, Queue A item 13)")
        self.config = config
        self.device = default_device(device)
        self.fwd_mode = fwd_mode
        self.moe_parallel = moe_parallel
        self.sp_axis = sp_axis
        self.world = world
        self.group = create_rank_group(world, "tp", self.device)
        DenseLLM._init_sp(self, sp_axis, sp_world)
        c = config
        self.attn = TPAttn(c.hidden_size, c.num_attention_heads,
                           c.num_key_value_heads, c.head_dim, dtype=c.dtype,
                           fwd_mode=fwd_mode, rms_eps=c.rms_norm_eps,
                           qk_norm=c.qk_norm, group=self.group)
        if moe_parallel == "ep":
            self.moe = EPMoE(c.hidden_size, c.moe_intermediate_size,
                             c.num_experts, c.num_experts_per_tok,
                             self.group, dtype=c.dtype, impl=impl,
                             norm_topk_prob=c.norm_topk_prob)
        else:
            self.moe = TPMoE(c.hidden_size, c.moe_intermediate_size,
                             c.num_experts, c.num_experts_per_tok,
                             dtype=c.dtype,
                             fwd_mode=self._moe_mode(fwd_mode), impl=impl,
                             norm_topk_prob=c.norm_topk_prob,
                             group=self.group)
        self.rope_cache = precompute_rope_cache(
            c.head_dim, c.max_position_embeddings, c.rope_theta,
            device=self.device)

    @staticmethod
    def _moe_mode(mode: str) -> str:
        return "xla" if mode in ("xla", "xla_ar") else "ag_rs"

    def set_fwd(self, mode: str):
        self.fwd_mode = mode
        self.attn.set_fwd(mode)
        self.moe.set_fwd(self._moe_mode(mode))

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
                "moe": self.moe.init(gen, dev),
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

    # -- forward: the dense model's, with the MoE FFN ------------------------
    forward = DenseLLM.forward
    decoder_layer = DenseLLM.decoder_layer
    forward_sp = DenseLLM.forward_sp
    _paged_scatter = staticmethod(DenseLLM._paged_scatter)

    def _attn_mode(self, mode: str, rows: int) -> str:
        """Attention's mode in model mode ``mode`` for ``rows`` rows (JAX
        ``forward``, qwen_moe.py:148-160): an EP model's mode "ep" runs
        the fused ``ag_rs`` attention, or ``gemm_ar`` (replicated rows)
        where the rows do not split over the ranks."""
        if self.moe_parallel == "ep" and mode == "ep":
            return "ag_rs" if rows % self.world == 0 else "gemm_ar"
        return mode

    def _ffn(self, lp: dict, h: torch.Tensor, mode: str) -> torch.Tensor:
        """FFN of :meth:`forward` on (M, H) rows: EP in every mode, TP in
        the MoE mode of ``mode``."""
        if self.moe_parallel == "ep":
            return self.moe(lp["moe"], h)
        return self.moe(lp["moe"], h, mode=self._moe_mode(mode))

    def _sp_ffn(self, lp: dict, h: torch.Tensor) -> torch.Tensor:
        """FFN of the sp forward on (B, S, H): every row routed and run
        through the grouped expert FFN on its own (JAX ``_sp_ffn``,
        qwen_moe.py:199-229, with no collective at world = 1)."""
        c = self.config
        mp = lp["moe"]
        k = c.num_experts_per_tok
        rows = h.reshape(-1, h.shape[-1]).contiguous()
        weights, idx = topk_routing(rows.float() @ mp["w_router"], k,
                                    c.norm_topk_prob)
        out = grouped_expert_ffn(rows, mp["w_gate"], mp["w_up"],
                                 mp["w_down"], idx.reshape(-1),
                                 c.num_experts, topk=k)
        red = topk_reduce(out.reshape(rows.shape[0], k, -1), weights)
        return red.reshape(h.shape).to(h.dtype)

    # -- HF weights --------------------------------------------------------
    def load_hf_state_dict(self, state: dict) -> dict:
        """Map a HF Qwen3-MoE state dict (name -> tensor or array) to the
        params dict on the model's device. Per-expert weights
        ``mlp.experts.{e}.{gate,up,down}_proj`` stack into (E, in, out);
        the router ``mlp.gate`` becomes (H, E) f32 after the cast to the
        model dtype, as in JAX."""
        c, dev = self.config, self.device

        def get(name):
            return _to_torch(state[name], c.dtype, dev)

        def lin(name):
            # HF nn.Linear keeps (out, in); the port uses (in, out).
            return get(name).t().contiguous()

        def experts(p, proj):
            return torch.stack([lin(f"{p}mlp.experts.{e}.{proj}.weight")
                                for e in range(c.num_experts)])

        layers = []
        for i in range(c.num_hidden_layers):
            p = f"model.layers.{i}."
            attn = {
                "w_q": lin(p + "self_attn.q_proj.weight"),
                "w_k": lin(p + "self_attn.k_proj.weight"),
                "w_v": lin(p + "self_attn.v_proj.weight"),
                "w_o": lin(p + "self_attn.o_proj.weight"),
            }
            if c.qk_norm:
                attn["q_norm"] = get(p + "self_attn.q_norm.weight")
                attn["k_norm"] = get(p + "self_attn.k_norm.weight")
            layers.append({
                "attn": attn,
                "moe": {
                    "w_router": lin(p + "mlp.gate.weight").float(),
                    "w_gate": experts(p, "gate_proj"),
                    "w_up": experts(p, "up_proj"),
                    "w_down": experts(p, "down_proj"),
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
