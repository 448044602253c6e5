"""Parallelism-strategy re-export surface (the port of
``triton_dist_tpu.parallel``).

The implementations live in :mod:`triton_dist_tpu_torch.layers`; this
package groups them by strategy as JAX's does: TP (dense + MoE), EP
(all-to-all dispatch/combine), SP (AG-KV attention + distributed flash
decode) and PP (p2p buffers + pipeline schedule), with the planner.
"""

from triton_dist_tpu_torch.parallel.plan import Plan, plan_parallelism
from triton_dist_tpu_torch.layers.ep_a2a import DispatchHandle, EPAll2AllLayer
from triton_dist_tpu_torch.layers.ep_moe import EPMoE
from triton_dist_tpu_torch.layers.p2p import CommOp
from triton_dist_tpu_torch.layers.sp_flash_decode import (
    SpAttentionLayer,
    SpFlashDecodeLayer,
)
from triton_dist_tpu_torch.layers.tp_attn import TPAttn
from triton_dist_tpu_torch.layers.tp_mlp import TPMLP
from triton_dist_tpu_torch.layers.tp_moe import TPMoE

# Strategy -> layers index.
TP_LAYERS = (TPMLP, TPAttn, TPMoE)
EP_LAYERS = (EPAll2AllLayer, EPMoE)
SP_LAYERS = (SpFlashDecodeLayer, SpAttentionLayer)
PP_LAYERS = (CommOp,)

__all__ = [
    "Plan",
    "plan_parallelism",
    "CommOp",
    "DispatchHandle",
    "EPAll2AllLayer",
    "EPMoE",
    "SpAttentionLayer",
    "SpFlashDecodeLayer",
    "TPAttn",
    "TPMLP",
    "TPMoE",
    "TP_LAYERS",
    "EP_LAYERS",
    "SP_LAYERS",
    "PP_LAYERS",
]
