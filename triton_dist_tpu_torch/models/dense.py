"""Qwen3-class dense decoder (the port of
``triton_dist_tpu.models.dense.DenseLLM``).

``world`` W > 1 runs tensor parallelism over W ranks on the one card
(``runtime.dist.RankGroup``): the attention heads and the MLP's
intermediate columns shard over the ranks as JAX shards them, every
shard a view of the global parameters, so ``params_from_jax`` and
``init`` are those of world 1. The activation layout follows JAX
(dense.py:133-136): row-sharded in modes ``xla`` / ``ag_rs`` (B * S must
split over the ranks), replicated in ``xla_ar`` / ``gemm_ar``; the fused
modes run the ring kernels.

``sp_world`` W > 1 runs mode ``sp`` with the sequence split over W ranks
on the one card (JAX's ``sp_axis`` of size W, read there from the mesh):
the KV caches split their positions over the ranks, prefill attention
runs the ring over them and decode the world-W flash-decode kernel. The
TP world of such a model stays 1: the 2-D tp x sp model is not ported
yet.

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

import math

import numpy as np
import torch

from triton_dist_tpu_torch.layers.common import (
    apply_rope, precompute_rope_cache, rms_norm)
from triton_dist_tpu_torch.layers.tp_attn import TPAttn, write_cache
from triton_dist_tpu_torch.layers.tp_mlp import TPMLP
from triton_dist_tpu_torch.models.config import ModelConfig
from triton_dist_tpu_torch.models.kv_cache import PagedKVCacheManager
from triton_dist_tpu_torch.ops.flash_decode import (
    create_flash_decode_context, gqa_fwd_batch_decode,
    gqa_fwd_batch_decode_paged)
from triton_dist_tpu_torch.ops.sp_attention import (
    create_sp_attention_context, sp_ag_attention)
from triton_dist_tpu_torch.runtime.device import default_device
from triton_dist_tpu_torch.runtime.dist import create_rank_group


class DenseLLM:
    """Qwen3 decoder. ``device=None`` means the CUDA card (raises when
    there is none); pass ``device="cpu"`` for the plain versions.

    ``sp_axis`` (any name; "sp" by convention) enables mode "sp",
    :meth:`forward_sp`: prefill attention of ``ops.sp_attention`` and
    decode through the flash-decode kernels over contiguous or paged
    caches, the sequence split over ``sp_world`` ranks. ``world`` W
    shards the model over W ranks on the device (tensor parallelism)."""

    def __init__(self, config: ModelConfig, device=None,
                 fwd_mode: str = "ag_rs", sp_axis: str | None = None,
                 world: int = 1, sp_world: int = 1):
        if config.is_moe:
            raise ValueError("DenseLLM needs a dense config; an MoE config "
                             "(num_experts > 0) builds Qwen3MoE (AutoLLM."
                             "build picks it)")
        self.config = config
        self.device = default_device(device)
        self.fwd_mode = fwd_mode
        self.sp_axis = sp_axis
        self.world = world
        self.group = create_rank_group(world, "tp", self.device)
        self._init_sp(sp_axis, sp_world)
        c = config
        # One module per role, reused across layers (all layers share
        # shapes; params differ per layer).
        self.attn = TPAttn(c.hidden_size, c.num_attention_heads,
                           c.num_key_value_heads, c.head_dim, dtype=c.dtype,
                           fwd_mode=fwd_mode,
                           rms_eps=c.rms_norm_eps, qk_norm=c.qk_norm,
                           group=self.group)
        self.mlp = TPMLP(c.hidden_size, c.intermediate_size, dtype=c.dtype,
                         fwd_mode=fwd_mode, group=self.group)
        self.rope_cache = precompute_rope_cache(
            c.head_dim, c.max_position_embeddings, c.rope_theta,
            device=self.device)

    def _init_sp(self, sp_axis: str | None, sp_world: int) -> None:
        """The sp contexts (JAX dense.py:52-63): ring attention for the
        prefill, the flash decode for the decode, over ``sp_world`` ranks
        of the sequence axis."""
        if sp_world > 1 and sp_axis is None:
            raise ValueError("sp_world needs sp_axis")
        self.sp_world = sp_world
        if sp_axis is not None:
            self.sp_group = create_rank_group(sp_world, sp_axis, self.device)
            group = self.sp_group if sp_world > 1 else None
            self.sp_ctx = create_sp_attention_context(
                sp_axis, causal=True, world_size=sp_world, group=group)
            self.fd_ctx = create_flash_decode_context(group)

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
                offset, mode: str | None = None, kv_start=None,
                block_table=None):
        """input_ids: (B, S) int; kv_caches: [(k, v)] * L, updated in
        place; offset: int write position, or a (B,) tensor of per-row
        positions. Returns (logits (B, S, V) f32, kv_caches).

        ``kv_start``: optional (B,) left-pad boundaries for ragged
        batches: rope positions count from each row's first real token
        and attention never sees the pad prefix. ``block_table`` (mode
        "sp" only) switches the caches to paged pools."""
        c = self.config
        mode = mode or self.fwd_mode
        if mode == "sp":
            if kv_start is not None:
                raise ValueError("mode 'sp' has no ragged support")
            return self.forward_sp(params, input_ids, kv_caches, offset,
                                   block_table=block_table)
        if block_table is not None:
            raise ValueError("paged caches need mode 'sp'")
        b, s = input_ids.shape
        attn_mode = self._attn_mode(mode, b * s)
        if attn_mode in ("xla", "ag_rs") and (b * s) % self.world:
            raise ValueError(f"mode {attn_mode!r} shards the {b * s} rows "
                             f"over {self.world} ranks: they must split")
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
            x = self.decoder_layer(lp, x, position_ids, cache, offset, mode,
                                   kv_start)

        x = rms_norm(x, params["final_norm"], c.rms_norm_eps)
        logits = x.float() @ params["lm_head_f32"].t()
        return logits.reshape(b, s, c.vocab_size), kv_caches

    def decoder_layer(self, lp: dict, x: torch.Tensor, position_ids,
                      cache, offset, mode: str, kv_start=None) -> torch.Tensor:
        """One decoder layer of :meth:`forward` on (B * S, H) rows ``x``:
        norm, attention (writing ``cache`` in place at ``offset``),
        residual, norm, FFN in model mode ``mode``, residual. A pipeline
        stage (``layers.p2p.pipeline_forward``) runs its layers through
        this, so it computes what the sequential forward computes."""
        c = self.config
        attn_mode = self._attn_mode(mode, x.shape[0])
        h = rms_norm(x, lp["ln_attn"], c.rms_norm_eps)
        a, _ = self.attn(lp["attn"], h, position_ids, self.rope_cache,
                         cache, offset, mode=attn_mode, kv_start=kv_start)
        x = x + a
        h = rms_norm(x, lp["ln_mlp"], c.rms_norm_eps)
        return x + self._ffn(lp, h, mode)

    # -- sequence-parallel forward (mode "sp") -------------------------------
    def forward_sp(self, params: dict, input_ids: torch.Tensor, kv_caches,
                   offset, block_table=None):
        """The sp forward (JAX ``DenseLLM.forward_sp``, dense.py:190-469)
        with the sequence split over ``sp_world`` ranks.

        * Prefill (S > 1, offset 0; S must split over the ranks): the
          projected K/V are written into the caches (contiguous slice, or
          every page of the rows' tables through :meth:`_paged_scatter`)
          and attention runs the ``ring`` impl over the projected K/V
          (``ops.sp_attention``).
        * Chunked prefill (S > 1, scalar offset > 0: the contiguous
          engine's ``prefill_chunk``, the paged prefix-hit admission):
          only positions offset + [0, S) are written (a whole-table
          scatter would zero shared prefix blocks), then attention runs
          over the cache with q from ``offset`` and kv_len = offset + S:
          a contiguous cache sliced to the live prefix, rounded up to
          ``lcm(t_cache / W, W)`` as JAX slices it (:431-441), a paged
          one through its gathered view.
        * Decode (S == 1, scalar or (B,) offsets): one position per row
          is written, then the flash-decode kernels read the cache with
          kv_len = offset + 1 (at world W the world-W kernel).

        The activations are global tensors computed once: JAX's prefill
        activations are split over S and its decode activations
        replicated, and on one card a replicated tensor is one shared
        tensor, a split one the ranks' views of it. The caches are
        updated in place. ``block_table``: (W, B, n_pages) int32
        switches them to ``PagedKVCacheManager`` pools. Returns (logits
        (B, S, V) f32, kv_caches)."""
        if self.sp_axis is None:
            raise ValueError("build the model with sp_axis=... to use "
                             "mode 'sp'")
        if self.world > 1:
            raise NotImplementedError(
                f"mode 'sp' on a model of tensor-parallel world "
                f"{self.world} (the 2-D tp x sp head_axis) is not ported yet "
                f"(ROADMAP.md, Queue A item 13)")
        c = self.config
        b, s = input_ids.shape
        dev = input_ids.device
        sp_world = self.sp_world
        per_row = torch.is_tensor(offset) and offset.dim() == 1
        if per_row and s > 1:
            raise NotImplementedError(
                "the per-row S > 1 burst of mode 'sp' (the speculative "
                "verify window) is not ported yet (ROADMAP.md, Queue A "
                "item 11)")
        if per_row:
            offset = offset.to(device=dev, dtype=torch.int64)
            pos = offset[:, None]
        else:
            offset = int(offset)
            pos = (offset + torch.arange(s, device=dev))[None].expand(b, s)
        decode = s == 1
        chunked = s > 1 and offset != 0
        hq, hkv = c.num_attention_heads, c.num_key_value_heads
        d = c.head_dim
        cos, sin = self.rope_cache
        eps = c.rms_norm_eps
        if block_table is not None:
            block_table = block_table.to(dev)

        x = params["embed"][input_ids]
        for lp, (ck, cv) in zip(params["layers"], kv_caches):
            a = lp["attn"]
            h = rms_norm(x, lp["ln_attn"], eps)
            q = torch.matmul(h, a["w_q"]).reshape(b, s, hq, d)
            k = torch.matmul(h, a["w_k"]).reshape(b, s, hkv, d)
            v = torch.matmul(h, a["w_v"]).reshape(b, s, hkv, d)
            if c.qk_norm:
                q = rms_norm(q, a["q_norm"], eps)
                k = rms_norm(k, a["k_norm"], eps)
            q = apply_rope(q, cos, sin, pos)
            k = apply_rope(k, cos, sin, pos)
            kc, vc = k.to(ck.dtype), v.to(cv.dtype)
            if block_table is None:
                write_cache(ck, kc, offset)
                write_cache(cv, vc, offset)
            elif decode:
                spd = ck.shape[0] // sp_world
                to_slot = (PagedKVCacheManager.position_to_slot_rows
                           if per_row else
                           PagedKVCacheManager.position_to_slot)
                g, ip = to_slot(block_table, offset, ck.shape[1], spd)
                ck[g, ip] = kc[:, 0]
                cv[g, ip] = vc[:, 0]
            elif chunked:
                spd = ck.shape[0] // sp_world
                posn = offset + torch.arange(s, device=dev)
                g, ip = PagedKVCacheManager.position_to_slot(
                    block_table, posn, ck.shape[1], spd)   # (S, B), (S,)
                ck[g, ip[:, None]] = kc.transpose(0, 1)
                cv[g, ip[:, None]] = vc.transpose(0, 1)
            else:
                self._paged_scatter(ck, kc, block_table)
                self._paged_scatter(cv, vc, block_table)
            if decode:
                if block_table is None:
                    att = gqa_fwd_batch_decode(q[:, 0].contiguous(), ck, cv,
                                               offset + 1, self.fd_ctx)
                else:
                    att = gqa_fwd_batch_decode_paged(
                        q[:, 0].contiguous(), ck, cv, block_table,
                        offset + 1, self.fd_ctx)
                att = att[:, None]
            elif chunked:
                if block_table is not None:
                    ck = PagedKVCacheManager.gathered_view(ck, block_table)
                    cv = PagedKVCacheManager.gathered_view(cv, block_table)
                else:
                    t_live = live_prefix(ck.shape[1], offset + s, sp_world)
                    ck, cv = ck[:, :t_live], cv[:, :t_live]
                att = sp_ag_attention(q, ck, cv, self.sp_ctx,
                                      q_offset=offset, kv_len=offset + s)
            else:
                att = sp_ag_attention(q, k, v, self.sp_ctx)
            att = att.reshape(b, s, hq * d)
            x = x + torch.matmul(att, a["w_o"]).to(x.dtype)
            h = rms_norm(x, lp["ln_mlp"], eps)
            x = x + self._sp_ffn(lp, h)

        x = rms_norm(x, params["final_norm"], eps)
        logits = x.float() @ params["lm_head_f32"].t()
        return logits, kv_caches

    def _attn_mode(self, mode: str, rows: int) -> str:
        """The attention layer's mode in model mode ``mode`` for ``rows``
        rows: the same."""
        return mode

    def _ffn(self, lp: dict, h: torch.Tensor, mode: str) -> torch.Tensor:
        """FFN of :meth:`forward` on (M, H) rows: the MLP in ``mode``."""
        return self.mlp(lp["mlp"], h, mode=mode)

    def _sp_ffn(self, lp: dict, h: torch.Tensor) -> torch.Tensor:
        """FFN of the sp forward on (B, S, H): the MLP's plain products
        (mode "xla_ar"; the JAX sp forward runs no fused GEMM)."""
        b, s, hid = h.shape
        return self.mlp(lp["mlp"], h.reshape(b * s, hid),
                        mode="xla_ar").reshape(b, s, hid)

    @staticmethod
    def _paged_scatter(pool: torch.Tensor, kv: torch.Tensor,
                       table: torch.Tensor) -> None:
        """Write a (B, S, Hkv, D) prefill K/V into the pages of the rows'
        (W, B, n_pages) table in place (JAX ``_paged_scatter``,
        dense.py:481-518): the K/V staged into the position space of the
        W ranks (zeros past S), then rank r's positions [r t_loc,
        (r + 1) t_loc) into its pages (its pool rows r P + table[r]).
        Lanes that all point at a sentinel page leave it holding one of
        their pages' contents, which no live kv_len ever reads."""
        world, _, n_pages = table.shape
        b, s = kv.shape[0], kv.shape[1]
        page = pool.shape[1]
        t_total = page * n_pages * world
        if s > t_total:
            raise ValueError(f"prefill {s} > paged capacity {t_total}")
        staged = kv.new_zeros((b, t_total) + tuple(kv.shape[2:]))
        staged[:, :s] = kv
        pages = staged.reshape(b, world, n_pages, page, *kv.shape[2:])
        base = torch.arange(world, device=table.device)[:, None, None] * (
            pool.shape[0] // world)
        pool[(table.long() + base).reshape(-1)] = pages.transpose(
            0, 1).reshape(world * b * n_pages, page, *kv.shape[2:])

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


def live_prefix(t_cache: int, t_live: int, world: int) -> int:
    """The cache positions a chunked prefill attends over (JAX
    dense.py:431-441): the live prefix rounded up to a multiple of
    lcm(t_cache / W, W), so the slice lands on shard boundaries and
    splits over the W ranks; the whole cache when that reaches it. At
    world 1 the step is t_cache."""
    if t_cache % world:
        return t_cache
    step = math.lcm(t_cache // world, world)
    return min(-(-t_live // step) * step, t_cache)


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


#: Leaves that the JAX models keep in f32 whatever the model dtype: the
#: MoE router (``TPMoE.init``, ``Qwen3MoE.load_hf_state_dict``).
F32_LEAVES = ("w_router",)


def params_from_jax(np_tree: dict, config: ModelConfig, device=None) -> dict:
    """The JAX ``DenseLLM`` or ``Qwen3MoE`` params pytree, with numpy
    arrays for leaves, as the port's params on ``device`` (default: the
    CUDA card). Both packages use the (in, out) layout (experts stacked
    (E, in, out)), so every leaf is a plain copy in ``config.dtype``,
    except the f32 leaves of :data:`F32_LEAVES`: a bf16 router would
    route differently.

    Whatever the JAX model's sharding (TP or EP, any world), its arrays
    hold the global values, and the port's params are those global
    tensors: a world-W model takes each rank's shard as a view when it
    runs, so nothing here depends on ``moe_parallel`` or the world."""
    dev = default_device(device)

    def conv(node, name=None):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        dtype = torch.float32 if name in F32_LEAVES else config.dtype
        return _to_torch(node, dtype, dev)

    params = conv(np_tree)
    if config.tie_word_embeddings:
        params["lm_head"] = params["embed"]
    return with_f32_head(params)
