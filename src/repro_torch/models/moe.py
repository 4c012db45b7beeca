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

from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import ParamSpec, activation
from repro_torch.sharding.axes import MODEL_AXIS, log_transfer

# capacity rows an expert-compute chunk (the reference's CHUNK)
CHUNK = 4096


def moe_specs(cfg) -> Dict[str, ParamSpec]:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    specs = {
        "router": ParamSpec((d, E), ("embed", "experts"), scale=d ** -0.5),
        "w_up": ParamSpec((E, d, f), ("experts", "embed", "mlp")),
        "w_down": ParamSpec((E, f, d), ("experts", "mlp", "embed")),
    }
    if cfg.activation == "swiglu":
        specs["w_gate"] = ParamSpec((E, d, f), ("experts", "embed", "mlp"))
    return specs


def capacity(cfg, T: int) -> int:
    """Rows an expert takes in a call of T rows (padding rows count)."""
    C = int(cfg.capacity_factor * T * cfg.top_k / cfg.num_experts)
    return max(8, (C + 7) // 8 * 8)


def route_logits(cfg, logits: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """float32 router logits [T, E] -> (gates [T,k], expert_idx [T,k],
    aux_loss).  The softmax runs in float32; the top k come from a
    stable descending sort, so ties keep the lower expert id first, as
    ``jax.lax.top_k`` does."""
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


def route(cfg, p, x_flat: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x_flat: [T, d] -> (gates [T,k], expert_idx [T,k], aux_loss); the
    router product runs in x's dtype (`route_logits`)."""
    return route_logits(cfg, (x_flat @ p["router"].to(x_flat.dtype)).float())


class Dispatch(NamedTuple):
    """Where a call's (token, k) assignments go: `order` sorts them by
    expert id, stably; `token` is each sorted assignment's token,
    `slot` its row of the flat [E*C (+1), d] expert buffer (overflow:
    row E*C) and `weight` its gate, 0 where it was dropped (float32);
    `idx` [T, k] the experts, `keep` the sorted assignments kept."""
    idx: torch.Tensor
    order: torch.Tensor
    token: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    weight: torch.Tensor
    aux: torch.Tensor
    capacity: int


def dispatch(cfg, logits: torch.Tensor) -> Dispatch:
    """Route and dispatch a call of T = logits.shape[0] rows (padding
    rows count): an expert keeps its first C = `capacity(cfg, T)`
    assignments in (token, k) order and drops the rest."""
    T = logits.shape[0]
    E, K = cfg.num_experts, cfg.top_k
    C = capacity(cfg, T)
    gates, idx, aux = route_logits(cfg, logits)
    # (token, k) assignment pairs sorted by expert id, stably
    flat_expert = idx.reshape(-1)                              # [T*K]
    order = torch.sort(flat_expert, stable=True).indices
    sorted_expert = flat_expert[order]
    # position of each assignment within its expert's contiguous run
    dev = logits.device
    seg_start = torch.searchsorted(sorted_expert, torch.arange(E, device=dev))
    pos_in_expert = (torch.arange(T * K, device=dev)
                     - seg_start[sorted_expert])
    keep = pos_in_expert < C                                   # overflow
    slot = torch.where(keep, sorted_expert * C + pos_in_expert,
                       torch.full_like(sorted_expert, E * C))
    return Dispatch(idx, order, order // K, slot, keep,
                    gates.reshape(-1)[order] * keep, aux, C)


def _expert_mlp(cfg, p, bc: torch.Tensor) -> torch.Tensor:
    """[E, c, d] -> [E, c, d]: each expert's MLP on its rows, in bc's
    dtype."""
    dt = bc.dtype
    up = torch.bmm(bc, p["w_up"].to(dt))
    gate = torch.bmm(bc, p["w_gate"].to(dt)) if "w_gate" in p else None
    return torch.bmm(activation(cfg, up, gate), p["w_down"].to(dt))


def expert_compute(cfg, p, buf: torch.Tensor) -> torch.Tensor:
    """[E', C, d] -> [E', C, d]: the experts of `p` (E' of them) on their
    capacity rows.  The capacity dim goes through checkpointed chunks of
    CHUNK rows, so expert-hidden activations stay O(CHUNK x d_ff)
    whatever the token count."""
    C = buf.shape[1]
    if C <= CHUNK:
        return _expert_mlp(cfg, p, buf)
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
    return torch.cat(outs, dim=1)[:, :C]


def fill(r: Dispatch, xf: torch.Tensor, E: int) -> torch.Tensor:
    """[E, C, d]: each expert's capacity rows, the rows of `xf` [T, d]
    its kept assignments take in sorted order, zeros where it has
    fewer."""
    C, d = r.capacity, xf.shape[-1]
    buf = xf.new_zeros((E * C + 1, d)).index_put((r.slot,), xf[r.token])
    return buf[:E * C].view(E, C, d)


def weighted(r: Dispatch, out: torch.Tensor) -> torch.Tensor:
    """[T*K, d]: each sorted assignment's expert output row (a dropped
    one reads a zero row) times its gate, in out's dtype."""
    d = out.shape[-1]
    out_ext = torch.cat([out.reshape(-1, d), out.new_zeros((1, d))])
    return out_ext[r.slot] * r.weight.to(out.dtype)[:, None]


def moe_mlp(cfg, p, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,d] -> ([B,S,d], aux_loss): `dispatch`, `expert_compute`
    and `combine` over the whole [B*S] call."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    r = dispatch(cfg, (xf @ p["router"].to(x.dtype)).float())
    out = expert_compute(cfg, p, fill(r, xf, cfg.num_experts))
    return (combine(weighted(r, out), r.order, cfg.top_k).reshape(B, S, d),
            r.aux)


def combine(contrib: torch.Tensor, order: torch.Tensor, K: int,
            tokens: slice = slice(None)) -> torch.Tensor:
    """Sum the weighted rows `contrib` [T*K, d] (in the sorted order
    `order`: row j belongs to token order[j] // K) per token, in the
    order of the rows, rounding in contrib's dtype after each add: the
    reference's scatter-add of the same rows into zeros, with no
    atomics.  A token's rows lie in ascending expert id, since the sort
    is by expert.  `tokens`: the tokens whose sums are formed."""
    TK = order.shape[0]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(TK, device=order.device)
    rows = torch.sort(inv.view(TK // K, K), dim=-1).values[tokens]
    parts = contrib[rows]                                       # [n,K,d]
    y = parts[:, 0]
    for k in range(1, K):
        y = y + parts[:, k]
    return y


# ----------------------------------------------------------------------
# expert parallelism over a (data, model) mesh (the sharded training step)
# ----------------------------------------------------------------------

def sharded_moe_mlp(cfg, p, groups, hs, read, first: torch.device
                    ) -> Tuple[List[Dict[torch.device, torch.Tensor]],
                               torch.Tensor]:
    """`moe_mlp` over the data groups of one layer, as the reference's
    over its global (micro)batch: `hs[i]` is group i's normed rows [B_i,
    S, d] on each of its devices, `p` the layer's ``Sharded`` leaves,
    `read` the layer's reader (models/transformer.py).

    Routing is global: each group's router logits (each `model` worker
    its expert columns, concatenated in model order) are stacked in
    global token order on `first`, where `dispatch` runs once (capacity
    from the global token count, the drops, the slots, one aux loss).
    Each `model` position of the first group runs `expert_compute` on
    its contiguous block of experts, its capacity rows gathered from
    every group's tokens (the reference's all-to-all; it replicates the
    block over `data`, the port runs it once); experts `model` does not
    split run whole on one position.  The buffer is filled (`fill`) and
    the weighted rows summed (`combine`, ascending expert id) on `first`,
    as `moe_mlp` does.  While the collective log is open
    (sharding/axes.collective_log) each move between positions through
    `first` is logged as an all-to-all.  Returns (each group's MLP
    output on each of its devices, aux on `first`)."""
    E, K, d = cfg.num_experts, cfg.top_k, cfg.d_model
    router = p["router"]
    split = router.split(MODEL_AXIS) is not None
    home = groups[0].workers[0]                  # the position on `first`

    def a2a(x, w, receivers=1):
        """x moved between positions (logged unless `w` is home)."""
        return x if w is home else log_transfer(
            x, "all-to-all", receivers=receivers, back="all-to-all")

    logits = []
    for g, h in zip(groups, hs):
        cols = []
        for w in (g.workers if split else g.workers[:1]):
            x = h[w.device].reshape(-1, d)
            cols.append(a2a(x @ read(router, w).to(x.dtype), w).to(first))
        logits.append(torch.cat(cols, dim=1))
    r = dispatch(cfg, torch.cat(logits).float())
    # the experts' capacity rows, filled once on `first`
    buf = fill(r, torch.cat([a2a(h[g.devices[0]].reshape(-1, d),
                                 g.workers[0]).to(first)
                             for g, h in zip(groups, hs)]), E)
    ep = p["w_up"].split(MODEL_AXIS) == 0        # experts over `model`
    workers = groups[0].workers if ep else groups[0].workers[:1]
    experts = {k: v for k, v in p.items() if k != "router"}
    Ep = E // len(workers)
    outs = []
    for w in workers:
        out = expert_compute(cfg, read.tree(experts, w) if ep
                             else read.whole(experts, w),
                             a2a(buf[w.m * Ep:(w.m + 1) * Ep],
                                 w).to(w.device))
        outs.append(a2a(out, w).to(first))
    contrib = weighted(r, torch.cat(outs))
    ys, lo = [], 0
    for g, h in zip(groups, hs):
        x = h[g.devices[0]]
        n = x.shape[0] * x.shape[1]
        y = combine(contrib, r.order, K, slice(lo, lo + n)).reshape(x.shape)
        # every worker of the group takes the rows in (home has them)
        y = a2a(y, None, len(g.workers) - (g is groups[0]))
        ys.append({e: y.to(e) for e in g.devices})
        lo += n
    return ys, r.aux


def moe_flops_per_token(cfg) -> float:
    n_mats = 3 if cfg.activation == "swiglu" else 2
    return 2.0 * n_mats * cfg.top_k * cfg.d_model * cfg.d_ff
