"""Shared model substrate: param specs, device choice, norms, RoPE, losses.

PyTorch counterpart of ``repro/models/common.py``.  ``ParamSpec`` keeps
only what parameter initialisation needs (shape, init rule, scale): the
port has no sharding, so the logical axis names of the reference are
gone.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


# ----------------------------------------------------------------------
# Parameter specification
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"                  # normal | zeros | ones
    scale: Optional[float] = None         # None -> fan_in ** -0.5


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


def fixed_tree_sum(parts: torch.Tensor) -> torch.Tensor:
    """Sum over the leading axis with a FIXED halving tree.

    Pads the axis to a power of two with zeros, then repeatedly adds
    the upper half onto the lower half — the same addition order as
    the reference, fixed by the (padded) group count alone.
    """
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
    out = {"scale": ParamSpec((d,), init="ones")}
    if cfg.norm == "layernorm":
        out["bias"] = ParamSpec((d,), init="zeros")
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
