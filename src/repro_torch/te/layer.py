"""Fused TE modules: LayerNormMLP and TransformerLayer (paper §III-C-2).

PyTorch counterpart of ``repro/te/layer.py``.  ``te_layernorm_mlp``
fuses the norm and the MLP so the norm -> linear boundary stays in fp8;
``te_transformer_layer`` assembles a whole block the way TE does:
attention stays in bf16 flash attention (TE's DotProductAttention is
not fp8), through ``models/attention.flash_attention`` (on the card the
CUDA kernel B9), while every linear runs through ``te_linear``.  The
fp8 state of all the constituent linears is one tree.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn
from repro_torch.models.common import (activation, apply_norm, apply_rope,
                                       norm_spec)
from repro_torch.te.fp8 import DelayedScalingRecipe
from repro_torch.te.linear import init_state, te_linear, te_linear_specs

Params = Dict[str, Any]


# ----------------------------------------------------------------------
# LayerNormMLP
# ----------------------------------------------------------------------

def layernorm_mlp_specs(cfg) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    specs = {
        "ln": norm_spec(cfg, d),
        "up": te_linear_specs(d, f, bias=cfg.use_bias),
        "down": te_linear_specs(f, d, bias=cfg.use_bias,
                                axes=("mlp", "embed")),
    }
    if cfg.activation == "swiglu":
        specs["gate"] = te_linear_specs(d, f)
    return specs


def layernorm_mlp_state(cfg, recipe: DelayedScalingRecipe,
                        device=None) -> Params:
    st = {"up": init_state(recipe, device), "down": init_state(recipe, device)}
    if cfg.activation == "swiglu":
        st["gate"] = init_state(recipe, device)
    return st


def te_layernorm_mlp(cfg, params: Params, state: Params, x: torch.Tensor,
                     recipe: DelayedScalingRecipe = DelayedScalingRecipe(),
                     ) -> Tuple[torch.Tensor, Params]:
    h = apply_norm(cfg, x, params["ln"])
    up, st_up = te_linear(params["up"], state["up"], h, recipe)
    new_state = {"up": st_up}
    if cfg.activation == "swiglu":
        gate, st_g = te_linear(params["gate"], state["gate"], h, recipe)
        new_state["gate"] = st_g
        act = activation(cfg, up, gate)
    else:
        act = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
    y, st_down = te_linear(params["down"], state["down"], act, recipe)
    new_state["down"] = st_down
    return y, new_state


# ----------------------------------------------------------------------
# TransformerLayer
# ----------------------------------------------------------------------

def transformer_layer_specs(cfg) -> Params:
    d, H, KH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "ln1": norm_spec(cfg, d),
        "wq": te_linear_specs(d, H * hd, axes=("embed", "heads")),
        "wk": te_linear_specs(d, KH * hd, axes=("embed", "kv_heads")),
        "wv": te_linear_specs(d, KH * hd, axes=("embed", "kv_heads")),
        "wo": te_linear_specs(H * hd, d, axes=("heads", "embed")),
        "mlp": layernorm_mlp_specs(cfg),
    }


def transformer_layer_state(cfg, recipe: DelayedScalingRecipe,
                            device=None) -> Params:
    return {
        "wq": init_state(recipe, device), "wk": init_state(recipe, device),
        "wv": init_state(recipe, device), "wo": init_state(recipe, device),
        "mlp": layernorm_mlp_state(cfg, recipe, device),
    }


def te_transformer_layer(cfg, params: Params, state: Params, x: torch.Tensor,
                         recipe: DelayedScalingRecipe = DelayedScalingRecipe(),
                         ) -> Tuple[torch.Tensor, Params]:
    """One encoder block, fp8 linears + bf16 flash attention."""
    B, S, d = x.shape
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = apply_norm(cfg, x, params["ln1"])
    q, st_q = te_linear(params["wq"], state["wq"], h, recipe)
    k, st_k = te_linear(params["wk"], state["wk"], h, recipe)
    v, st_v = te_linear(params["wv"], state["wv"], h, recipe)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KH, hd)
    v = v.reshape(B, S, KH, hd)
    positions = torch.arange(S, device=x.device).expand(B, S)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attn.flash_attention(q, k, v, causal=True)      # bf16, like TE
    o, st_o = te_linear(params["wo"], state["wo"], o.reshape(B, S, H * hd),
                        recipe)
    x = x + o
    y, st_mlp = te_layernorm_mlp(cfg, params["mlp"], state["mlp"], x, recipe)
    return x + y, {"wq": st_q, "wk": st_k, "wv": st_v, "wo": st_o,
                   "mlp": st_mlp}
