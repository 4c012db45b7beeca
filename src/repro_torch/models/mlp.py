"""Dense MLP (SwiGLU / GELU); PyTorch counterpart of ``repro/models/mlp.py``."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models.common import ParamSpec, activation, fixed_tree_sum
from repro_torch.te import linear as te_linear


def mlp_specs(cfg, d_model: Optional[int] = None,
              d_ff: Optional[int] = None) -> Dict[str, ParamSpec]:
    d = d_model or cfg.d_model
    f = d_ff or cfg.d_ff
    specs = {
        "w_up": ParamSpec((d, f), ("embed", "mlp")),
        "w_down": ParamSpec((f, d), ("mlp", "embed")),
    }
    if cfg.activation == "swiglu":
        specs["w_gate"] = ParamSpec((d, f), ("embed", "mlp"))
    if cfg.use_bias:
        specs["b_up"] = ParamSpec((f,), ("mlp",), init="zeros")
        specs["b_down"] = ParamSpec((d,), ("embed",), init="zeros")
    return specs


def _hidden(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """The activated hidden layer of x (a shard's columns of it when `p`
    holds a column slice of w_up / w_gate / b_up)."""
    dt = x.dtype
    up = x @ p["w_up"].to(dt)
    if cfg.use_bias:
        up = up + p["b_up"].to(dt)
    gate = x @ p["w_gate"].to(dt) if "w_gate" in p else None
    return activation(cfg, up, gate)


def _down_parts(p, h: torch.Tensor, groups: int, dt) -> torch.Tensor:
    B, S, f = h.shape
    hg = h.reshape(B, S, groups, f // groups).float()
    wg = p["w_down"].to(dt).reshape(groups, f // groups, -1).float()
    return torch.einsum("bsgf,gfd->gbsd", hg, wg)


def mlp_parts(cfg, p, x: torch.Tensor, groups: int) -> torch.Tensor:
    """The grouped float32 partials [groups, B, S, d] of the w_down
    contraction of x [B,S,d] (a shard's: its columns of the hidden
    layer against its rows of w_down, in tensor-parallel serving and,
    under autograd, in the sharded training step); b_down is not
    added."""
    return _down_parts(p, _hidden(cfg, p, x), groups, x.dtype)


def mlp(cfg, p, x: torch.Tensor, *, groups: int = 0) -> torch.Tensor:
    """x: [..., d] -> [..., d].

    Weights are cast to x.dtype at use, as in the reference.  With
    ``groups > 1`` ([B,S,d] inputs only) the w_down contraction is
    formed as per-group float32 partials of the x.dtype operands,
    reduced by ``fixed_tree_sum`` (tagged ``xshard_mlp_down``) — the
    reference's grouped reduction.
    """
    dt = x.dtype
    h = _hidden(cfg, p, x)
    if groups > 1 and h.ndim == 3:
        y = fixed_tree_sum(_down_parts(p, h, groups, dt),
                           tag="xshard_mlp_down").to(dt)
    else:
        y = h @ p["w_down"].to(dt)
    if cfg.use_bias:
        y = y + p["b_down"].to(dt)
    return y


def mlp_fp8(cfg, p, q8, x: torch.Tensor) -> torch.Tensor:
    """fp8 serving variant of `mlp`: the three products through weights
    pre-quantized by te/linear.quantize_serving_params, with per-call
    activation scales; no grouped reduction.  Biases stay in `p`."""
    dt = x.dtype
    up = te_linear.fp8_serving_dot(x, q8["w_up"])
    if cfg.use_bias:
        up = up + p["b_up"].to(dt)
    gate = (te_linear.fp8_serving_dot(x, q8["w_gate"])
            if "w_gate" in q8 else None)
    h = activation(cfg, up, gate)
    y = te_linear.fp8_serving_dot(h, q8["w_down"])
    if cfg.use_bias:
        y = y + p["b_down"].to(dt)
    return y
