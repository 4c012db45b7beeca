"""Mixture-of-Experts MLP with sort-based capacity dispatch.

PyTorch counterpart of ``repro/models/moe.py``.  Dispatch is
index-based (a stable sort of the (token, k) assignments by expert),
so it keeps O(tokens) integers and the expert compute at its true cost
2 * E * C * d * ff * n_mats; the expert products are batched matrix
products in x's dtype (cuBLAS on the card).

Every step stays on the device with static shapes (no boolean-mask
indexing, ``nonzero`` or host reads), so a serving work unit that runs
it captures as one CUDA graph.  The reference's out-of-bounds scatter
(``mode="drop"``) and gather (``mode="fill"``) become one extra row of
the flat expert buffer: a discard row for overflow writes, a zero row
for their reads.  The combine adds each token's K contributions in the
order the reference's scatter-add meets them (ascending expert id),
rounding in x's dtype after each add, with no atomics, so a call is
bitwise equal run to run on the card.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import ParamSpec, activation

# capacity rows an expert-compute chunk (the reference's CHUNK)
CHUNK = 4096


def moe_specs(cfg) -> Dict[str, ParamSpec]:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    specs = {
        "router": ParamSpec((d, E), scale=d ** -0.5),
        "w_up": ParamSpec((E, d, f)),
        "w_down": ParamSpec((E, f, d)),
    }
    if cfg.activation == "swiglu":
        specs["w_gate"] = ParamSpec((E, d, f))
    return specs


def capacity(cfg, T: int) -> int:
    """Rows an expert takes in a call of T rows (padding rows count)."""
    C = int(cfg.capacity_factor * T * cfg.top_k / cfg.num_experts)
    return max(8, (C + 7) // 8 * 8)


def route(cfg, p, x_flat: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x_flat: [T, d] -> (gates [T,k], expert_idx [T,k], aux_loss).

    The router product runs in x's dtype, the softmax in float32.  The
    top k come from a stable descending sort, so ties keep the lower
    expert id first, as ``jax.lax.top_k`` does."""
    logits = (x_flat @ p["router"].to(x_flat.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top[:, :cfg.top_k], idx[:, :cfg.top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balancing auxiliary loss
    E = cfg.num_experts
    me = probs.mean(0)                                       # mean prob
    ce = F.one_hot(idx[:, 0], E).float().mean(0)             # top1 frac
    aux = E * torch.sum(me * ce)
    return gates, idx, aux


def _expert_mlp(cfg, p, bc: torch.Tensor) -> torch.Tensor:
    """[E, c, d] -> [E, c, d]: each expert's MLP on its rows, in bc's
    dtype."""
    dt = bc.dtype
    up = torch.bmm(bc, p["w_up"].to(dt))
    gate = torch.bmm(bc, p["w_gate"].to(dt)) if "w_gate" in p else None
    return torch.bmm(activation(cfg, up, gate), p["w_down"].to(dt))


def moe_mlp(cfg, p, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,d] -> ([B,S,d], aux_loss). Sort-based capacity dispatch:
    an expert keeps its first C assignments in (token, k) order and
    drops the rest."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.num_experts, cfg.top_k
    C = capacity(cfg, T)
    dt = x.dtype

    xf = x.reshape(T, d)
    gates, idx, aux = route(cfg, p, xf)

    # (token, k) assignment pairs sorted by expert id, stably
    flat_expert = idx.reshape(-1)                              # [T*K]
    order = torch.sort(flat_expert, stable=True).indices
    sorted_expert = flat_expert[order]
    sorted_token = order // K
    sorted_gate = gates.reshape(-1)[order]

    # position of each assignment within its expert's contiguous run
    seg_start = torch.searchsorted(
        sorted_expert, torch.arange(E, device=x.device))
    pos_in_expert = (torch.arange(T * K, device=x.device)
                     - seg_start[sorted_expert])
    keep = pos_in_expert < C                                   # overflow
    # row of the flat [E*C (+1), d] buffer; overflow goes to row E*C
    slot = torch.where(keep, sorted_expert * C + pos_in_expert,
                       torch.full_like(sorted_expert, E * C))

    buf = xf.new_zeros((E * C + 1, d))
    buf = buf.index_put((slot,), xf[sorted_token])
    buf = buf[:E * C].view(E, C, d)

    # the capacity dim goes through checkpointed chunks, so expert-hidden
    # activations stay O(CHUNK x d_ff) whatever the token count
    if C > CHUNK:
        n_chunks = -(-C // CHUNK)
        buf_p = F.pad(buf, (0, 0, 0, n_chunks * CHUNK - C))
        outs = []
        for c in range(n_chunks):
            bc = buf_p[:, c * CHUNK:(c + 1) * CHUNK]
            if torch.is_grad_enabled():
                outs.append(checkpoint(_expert_mlp, cfg, p, bc,
                                       use_reentrant=False))
            else:
                outs.append(_expert_mlp(cfg, p, bc))
        out = torch.cat(outs, dim=1)[:, :C]
    else:
        out = _expert_mlp(cfg, p, buf)

    # combine: read each assignment's row (a dropped one reads the zero
    # row), weight it by its gate in x's dtype, then add each token's K
    # contributions in ascending expert id: the order in which the
    # reference's scatter-add over the sorted assignments meets them
    out_ext = torch.cat([out.reshape(E * C, d), out.new_zeros((1, d))])
    contrib = out_ext[slot] * (sorted_gate * keep).to(dt)[:, None]
    return combine(contrib, order, K).reshape(B, S, d), aux


def combine(contrib: torch.Tensor, order: torch.Tensor, K: int
            ) -> torch.Tensor:
    """Sum the weighted rows `contrib` [T*K, d] (in the sorted order
    `order`: row j belongs to token order[j] // K) per token, in the
    order of the rows, rounding in contrib's dtype after each add: the
    reference's scatter-add of the same rows into zeros, with no
    atomics.  A token's rows lie in ascending expert id, since the sort
    is by expert."""
    TK, d = contrib.shape
    inv = torch.empty_like(order)
    inv[order] = torch.arange(TK, device=order.device)
    rows = torch.sort(inv.view(TK // K, K), dim=-1).values      # [T, K]
    parts = contrib[rows]                                       # [T,K,d]
    y = parts[:, 0]
    for k in range(1, K):
        y = y + parts[:, k]
    return y


def moe_flops_per_token(cfg) -> float:
    n_mats = 3 if cfg.activation == "swiglu" else 2
    return 2.0 * n_mats * cfg.top_k * cfg.d_model * cfg.d_ff
