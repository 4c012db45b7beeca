"""Shared model substrate: param specs, device choice, norms, RoPE, losses.

PyTorch counterpart of ``repro/models/common.py``.  ``ParamSpec``
carries what parameter initialisation needs (shape, init rule, scale)
and the reference's logical axis name per dim; ``partition_specs``
resolves those names to mesh axes under a plan's rules
(sharding/plans.py), which is how a tensor-parallel server splits the
tree (models/convert.shard_params).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.axes import log_transfer


# ----------------------------------------------------------------------
# Parameter specification
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]       # logical axis name per dim
    init: str = "normal"                  # normal | zeros | ones
    scale: Optional[float] = None         # None -> fan_in ** -0.5

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in rank")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def init_leaf(spec: ParamSpec, generator: torch.Generator,
              device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """One parameter by the reference's rule (``_init_leaf``): zeros,
    ones, or a float32 standard normal times ``scale``, where the
    default scale is ``shape[-2] ** -0.5`` (``shape[-1]`` for vectors),
    stacked leading axes included.  Norm scales ("ones") stay float32
    whatever ``dtype`` is: ``rmsnorm`` upcasts them anyway.

    A stacked leaf ``[L, ...]`` is drawn one leading slice at a time,
    so the float32 temporary is one layer's worth, not the whole stack.
    """
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=torch.float32, device=device)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    scale = spec.scale if spec.scale is not None else fan_in ** -0.5
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    rows = out if out.ndim > 2 else out[None]
    for sub in rows:
        sub.copy_(torch.randn(sub.shape, generator=generator,
                              dtype=torch.float32, device=device) * scale)
    return out


def init_params(specs, generator: torch.Generator, device: torch.device,
                dtype: torch.dtype) -> Dict[str, Any]:
    """Walk the spec tree in sorted key order (the order a JAX pytree
    flattens a dict in) and draw every leaf from one generator."""
    if is_spec(specs):
        return init_leaf(specs, generator, device, dtype)
    return {k: init_params(specs[k], generator, device, dtype)
            for k in sorted(specs)}


def abstract_params(specs, dtype: torch.dtype = torch.float32):
    """The parameter tree as meta tensors (shapes and dtypes, no
    storage): the reference's ``ShapeDtypeStruct`` tree.  Leaves take
    `dtype` as ``init_params`` does, norm scales ("ones") float32."""
    if is_spec(specs):
        dt = torch.float32 if specs.init == "ones" else dtype
        return torch.empty(specs.shape, dtype=dt, device="meta")
    return {k: abstract_params(v, dtype) for k, v in specs.items()}


def partition_specs(specs, rules: Dict[str, Any],
                    mesh_sizes: Optional[Dict[str, int]] = None):
    """Resolve every leaf's logical axes to a PartitionSpec under
    `rules` (sharding/axes.resolve): a mesh axis is used at most once a
    leaf (the first logical axis that maps to it wins), and with
    `mesh_sizes` a dim that does not divide its mesh axes stays
    replicated (yi-6b's 4 KV heads over 8 positions, say)."""
    from repro_torch.sharding.axes import resolve
    if is_spec(specs):
        return resolve(specs.axes, rules, dims=specs.shape,
                       mesh_sizes=mesh_sizes)
    return {k: partition_specs(v, rules, mesh_sizes)
            for k, v in specs.items()}


def count_params(specs) -> int:
    if is_spec(specs):
        n = 1
        for d in specs.shape:
            n *= d
        return n
    return sum(count_params(v) for v in specs.values())


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for another device.  With no CUDA device and no explicit choice it
    raises instead of carrying on on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


@torch.library.custom_op("repro_torch::mark", mutates_args=())
def mark(x: torch.Tensor, name: str) -> None:
    """A named point on a path: the reference's ``checkpoint_name`` tag
    without its copy.  The op computes nothing and launches nothing; a
    ``TorchDispatchMode`` (analysis/graph_check) sees it with its name,
    so a work unit's recorded ops show which path its body took."""


@mark.register_fake
def _(x, name):
    return None


def fixed_tree_sum(parts: torch.Tensor, *,
                   tag: Optional[str] = None) -> torch.Tensor:
    """Sum over the leading axis with a FIXED halving tree.

    Pads the axis to a power of two with zeros, then repeatedly adds
    the upper half onto the lower half — the same addition order as
    the reference, fixed by the (padded) group count alone, so the sum
    of per-group partials is the same whether the groups were formed on
    one device or gathered from tensor-parallel shards (`xshard_sum`).

    ``tag`` (convention ``xshard_<site>``) marks the partials
    (``mark``), so the analyzer's JX004 finds every cross-shard
    reduction and checks that it sums float32.
    """
    if tag is not None:
        mark(parts, tag)
    n = parts.shape[0]
    p2 = 1
    while p2 < n:
        p2 *= 2
    if p2 != n:
        parts = torch.cat([parts, parts.new_zeros((p2 - n,)
                                                  + parts.shape[1:])])
    while parts.shape[0] > 1:
        h = parts.shape[0] // 2
        parts = parts[:h] + parts[h:]
    return parts[0]


def replicate(t: torch.Tensor, devices) -> Dict[torch.device, torch.Tensor]:
    """`t` on each of `devices` (distinct physical devices): the tensor
    itself on its own device, one copy on each other."""
    return {d: t if t.device == d else t.to(d, non_blocking=True)
            for d in devices}


def xshard_sum(parts, devices, *, tag: str
               ) -> Dict[torch.device, torch.Tensor]:
    """The cross-shard reduction of tensor parallelism: every shard's
    float32 partials ([g_r, ...], in shard order) gathered on each of
    `devices` into one [sum g_r, ...] tensor and summed there by
    `fixed_tree_sum` (tagged `tag`): the same sums, in the same order,
    as one device's grouped reduction over all the groups.  Every op is
    differentiable, so the sharded training step runs it under autograd
    (the backward hands each shard the gradient of its partials)."""
    if len(parts) > 1:
        # logically each shard's partials reach every other shard
        parts = [log_transfer(p, "all-reduce", receivers=len(parts) - 1,
                              back="all-reduce") for p in parts]
    out = {}
    for d in devices:
        gathered = torch.cat([p if p.device == d else p.to(d) for p in parts])
        out[d] = fixed_tree_sum(gathered, tag=tag)
    return out


# ----------------------------------------------------------------------
# Layers (functional)
# ----------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor], eps: float = 1e-5
              ) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def apply_norm(cfg, x: torch.Tensor, p: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p.get("bias"))
    return rmsnorm(x, p["scale"])


def norm_spec(cfg, d: int) -> Dict[str, ParamSpec]:
    out = {"scale": ParamSpec((d,), ("embed",), init="ones")}
    if cfg.norm == "layernorm":
        out["bias"] = ParamSpec((d,), ("embed",), init="zeros")
    return out


def activation(cfg, x: torch.Tensor,
               gate: Optional[torch.Tensor]) -> torch.Tensor:
    """swiglu: silu(gate) * x; otherwise geglu, gelu(gate) * x, when a
    gate is given, else gelu(x) (zamba2's ungated MLP).  GELU is the
    tanh approximation, ``jax.nn.gelu``'s default."""
    if cfg.activation == "swiglu":
        if gate is None:
            raise ValueError("swiglu needs a gate")
        return F.silu(gate) * x
    if gate is not None:
        return F.gelu(gate, approximate="tanh") * x
    return F.gelu(x, approximate="tanh")


# --- rotary embeddings -------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    # a python-float base: no host-to-device copy (and sync) per call
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq].  Split-half
    rotation in float32, cast back to x.dtype."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)          # [hd/2]
    angles = positions[..., :, None].float() * freqs              # [..,s,hd/2]
    angles = angles[..., None, :]                                 # heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- losses ------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean CE; logits [..., vocab] fp32-stable."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _xent_chunk(xc: torch.Tensor, w_out: torch.Tensor, lc: torch.Tensor,
                mc: torch.Tensor) -> torch.Tensor:
    """Masked NLL sum of one token chunk."""
    logits = (xc @ w_out).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
    return torch.sum((lse - gold) * mc)


def chunked_softmax_xent(x: torch.Tensor, w_out: torch.Tensor,
                         labels: torch.Tensor, *, chunk: int = 8192,
                         mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Cross-entropy without materializing [tokens, vocab] at once.

    The token dim goes through chunks of `chunk` rows, so the live
    logits buffer is [chunk, vocab]; each chunk's logits are recomputed
    in the backward (``torch.utils.checkpoint``, as the reference's
    ``jax.checkpoint`` on its scan step), never stored.  x: [tokens, d];
    w_out: [d, vocab]; labels: [tokens].
    """
    tokens = x.shape[0]
    pad = (-tokens) % chunk
    if mask is None:
        mask = torch.ones((tokens,), dtype=torch.float32, device=x.device)
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    m = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(x.shape[0] // chunk):
        rows = slice(c * chunk, (c + 1) * chunk)
        nll = nll + checkpoint(_xent_chunk, x[rows], w_out, labels[rows],
                               mask[rows], use_reentrant=False)
        m = m + torch.sum(mask[rows])
    return nll / torch.clamp(m, min=1.0)


def _vocab_shard_nll(hs, ws, labels, offsets, device,
                     mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Token-loss sum of one row block over vocab shards (see
    `vocab_parallel_xent_sum`)."""
    ms, ss, gold = [], [], None
    for h, w, lab, off in zip(hs, ws, labels, offsets):
        logits = (h @ w.to(h.dtype)).float()
        m = logits.amax(dim=-1).detach()
        s = torch.exp(logits - m[..., None]).sum(dim=-1)
        local = lab.long() - off
        mine = (local >= 0) & (local < w.shape[-1])
        g = torch.gather(logits, -1,
                         local.clamp(0, w.shape[-1] - 1)[..., None])[..., 0]
        if ms:                         # another shard's sums reach shard 0
            m, s, g = (log_transfer(t, "all-reduce", back="all-reduce")
                       for t in (m, s, g))
        ms.append(m.to(device))
        ss.append(s.to(device))
        g, mine = g.to(device), mine.to(device)
        gold = torch.where(mine, g, 0.0 if gold is None else gold)
    top = ms[0]
    for m in ms[1:]:
        top = torch.maximum(top, m)
    total = None
    for m, s in zip(ms, ss):
        t = s * torch.exp(m - top)
        total = t if total is None else total + t
    nll = top + torch.log(total) - gold
    if mask is not None:
        nll = nll * mask.to(device)
    return nll.sum()


def vocab_parallel_xent_sum(hs, ws, labels, offsets, device, *,
                            chunk: int = 0,
                            mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Sum over tokens of the cross-entropy of logits whose vocab is
    split over shards: shard r holds the hidden rows `hs[r]` [T, d] and
    its columns `ws[r]` [d, V_r] (ids `offsets[r]` + [0, V_r)), on its
    own device.  Each shard forms its logits (in the rows' dtype, read
    in float32, as `cross_entropy`), its row max and its sum of
    exponentials; the sums are combined in shard order on `device`
    (lse = M + log sum_r s_r exp(m_r - M)), and each label's logit comes
    from the shard that owns it.  ``chunk`` > 0 walks the tokens in
    blocks of `chunk` rows, each recomputed in the backward
    (``torch.utils.checkpoint``, as `chunked_softmax_xent`), so the live
    logits are [chunk, V_r] a shard.  `labels[r]` [T] and `mask` [T]
    (float, 1 = counted) are row-aligned with `hs`."""
    T = hs[0].shape[0]
    if not chunk or chunk >= T:
        return _vocab_shard_nll(hs, ws, labels, offsets, device, mask)
    total = None
    for lo in range(0, T, chunk):
        rows = slice(lo, min(T, lo + chunk))
        part = checkpoint(_vocab_shard_nll, [h[rows] for h in hs], ws,
                          [lab[rows] for lab in labels], offsets, device,
                          None if mask is None else mask[rows],
                          use_reentrant=False)
        total = part if total is None else total + part
    return total
