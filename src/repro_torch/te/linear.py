"""te_linear: the fp8 linear layer with delayed scaling (paper Figs. 3/4),
and the serving-side fp8 linears.

PyTorch counterpart of ``repro/te/linear.py``.

Training: ``fp8_matmul`` quantizes x and w to e4m3 with the scales of
the amax history (TE's DelayedScaling) and runs the fp8 product; its
backward quantizes the incoming gradient to e5m2 with a just-in-time
scale and reuses the *saved fp8 codes* for dgrad and wgrad, so the
backward's residuals are a quarter of float32 x and w: the TE memory
point the paper measures.  ``te_linear`` returns ``(y, new_state)``;
the state update reads only x and w, not y (this step's amax feeds the
next step's scale).  On the same inputs the codes and the new states
are bitwise the reference's; products agree within their float32 sums'
order.  torch's engine casts a gradient to its input's dtype, where
JAX returns the reference's dx in bf16: the values are the same.

Serving: weights are frozen, so the server quantizes every per-layer
attention and MLP weight of the stacked ``[L, ...]`` parameter tree to
e4m3 once at init, with one scale per layer and tensor, and the hot
path quantizes only the activation (a fresh per-call scale).

Layout: each quantized serving leaf ``{"q", "s"}`` keeps the
reference's shapes (codes ``[L, *w_shape]``, scales ``[L, 1, ...]``)
and the same codes, but the codes of one layer are stored transposed,
``[N, K]`` row-major for the weight's ``[K, N]`` contraction, so that
one layer's ``q[i].reshape(K, N)`` is the column-major operand
``torch._scaled_mm`` takes, with no transpose per call.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.common import ParamSpec
from repro_torch.te import fp8
from repro_torch.te.fp8 import DelayedScalingRecipe

Params = Dict[str, Any]


class _FP8Matmul(torch.autograd.Function):
    """x [M, K] @ w [K, N] with fp8 storage on both operands; saves the
    codes and scales, not x and w."""

    @staticmethod
    def forward(ctx, x, w, sx, sw, recipe):
        xq = fp8.quantize(x, sx, recipe.fwd_dtype)
        wq = fp8.quantize(w, sw, recipe.fwd_dtype)
        ctx.save_for_backward(xq, wq, sx, sw)
        ctx.recipe = recipe
        return fp8.fp8_dot(xq, sx, wq, sw, out_dtype=x.dtype)

    @staticmethod
    def backward(ctx, g):
        xq, wq, sx, sw = ctx.saved_tensors
        recipe = ctx.recipe
        sg = fp8.compute_scale(fp8.amax(g), recipe.bwd_dtype, recipe.margin)
        gq = fp8.quantize(g, sg, recipe.bwd_dtype)
        # dgrad: g @ w^T ; wgrad: x^T @ g, both from the fp8 residuals
        dx = fp8.fp8_dot(gq, sg, wq.t(), sw, out_dtype=torch.bfloat16)
        dw = fp8.fp8_dot(xq.t(), sx, gq, sg, out_dtype=torch.float32)
        return dx, dw, None, None, None


def fp8_matmul(x: torch.Tensor, w: torch.Tensor, sx: torch.Tensor,
               sw: torch.Tensor, recipe: DelayedScalingRecipe
               ) -> torch.Tensor:
    """x [M, K] @ w [K, N] in x.dtype, x and w quantized to
    ``recipe.fwd_dtype`` with the scales sx, sw; the gradient is
    quantized to ``recipe.bwd_dtype``.  No gradient for the scales."""
    return _FP8Matmul.apply(x, w, sx, sw, recipe)


# ----------------------------------------------------------------------
# layer
# ----------------------------------------------------------------------

def te_linear_specs(d_in: int, d_out: int, *, bias: bool = False,
                    axes=("embed", "mlp")) -> Params:
    specs = {"w": ParamSpec((d_in, d_out), axes)}
    if bias:
        specs["b"] = ParamSpec((d_out,), (axes[1],), init="zeros")
    return specs


TENSORS = ("x", "w")


def init_state(recipe: DelayedScalingRecipe, device=None) -> Params:
    return fp8.init_fp8_state(recipe, TENSORS, device)


def te_linear(params: Params, state: Params, x: torch.Tensor,
              recipe: DelayedScalingRecipe = DelayedScalingRecipe(),
              ) -> Tuple[torch.Tensor, Params]:
    """y = x @ w (+ b). Returns (y, new_fp8_state)."""
    w = params["w"]
    sx, sw = state["x"]["scale"], state["w"]["scale"]
    shape = x.shape[:-1] + (w.shape[-1],)
    y = fp8_matmul(x.reshape(-1, x.shape[-1]), w.float(), sx, sw,
                   recipe).reshape(shape)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    new_state = {
        "x": fp8.update_fp8_state(recipe, state["x"], fp8.amax(x),
                                  recipe.fwd_dtype),
        "w": fp8.update_fp8_state(recipe, state["w"], fp8.amax(w),
                                  recipe.fwd_dtype),
    }
    return y, new_state


def linear_reference(params: Params, x: torch.Tensor) -> torch.Tensor:
    """bf16 baseline (what TE replaces)."""
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


# ----------------------------------------------------------------------
# serving-side fp8 linears: weights quantized once, activations per call
# ----------------------------------------------------------------------

# weights of one layer and how many leading dims each contracts over
_ATTN_W = {"wq": 1, "wk": 1, "wv": 1, "wo": 2}
_MLP_W = {"w_up": 1, "w_gate": 1, "w_down": 1}


def _quantize_leaf(w: torch.Tensor, contract_ndim: int = 1) -> Params:
    """e4m3-quantize one stacked weight [L, ...] with a per-layer
    per-tensor scale (shape [L, 1, ...]), one layer at a time so the
    float32 temporaries are one layer's worth."""
    L, shape = w.shape[0], tuple(w.shape[1:])
    K = 1
    for d in shape[:contract_ndim]:
        K *= d
    N = w[0].numel() // K
    codes = torch.empty((L, N, K), dtype=torch.uint8, device=w.device)
    # one 256-byte line per layer's scale: cuBLASLt's fp8 product fails
    # (CUBLAS_STATUS_NOT_SUPPORTED) on a scale pointer that is not
    # aligned, which a packed [L] array gives every layer but the first
    scales = torch.empty((L, 64), dtype=torch.float32, device=w.device)
    scales = scales[:, :1].reshape((L,) + (1,) * len(shape))
    for i in range(L):
        s = fp8.compute_scale(fp8.amax(w[i]), fp8.E4M3)
        q = fp8.quantize(w[i], s, fp8.E4M3).reshape(K, N)
        codes[i].copy_(q.view(torch.uint8).t())
        scales[i] = s
    q = codes.view(fp8.E4M3).transpose(1, 2).view((L,) + shape)
    return {"q": q, "s": scales}


def quantize_serving_params(params: Params) -> Params:
    """Pre-quantize the per-layer attention + MLP weights of a stacked
    transformer param tree for fp8 serving.  Returns {"layers": {...}}
    mirroring params["layers"]; biases and norms stay in the original
    tree."""
    layers = params["layers"]
    with torch.no_grad():
        quant = {"attn": {n: _quantize_leaf(layers["attn"][n], nd)
                          for n, nd in _ATTN_W.items()},
                 "mlp": {n: _quantize_leaf(layers["mlp"][n], nd)
                         for n, nd in _MLP_W.items()
                         if n in layers["mlp"]}}
    return {"layers": quant}


def fp8_serving_dot(x: torch.Tensor, qleaf: Params, *,
                    x_contract_ndim: int = 1,
                    w_contract_ndim: int = 1) -> torch.Tensor:
    """x (trailing `x_contract_ndim` dims) @ pre-quantized weight
    (leading `w_contract_ndim` dims), with a fresh per-call activation
    scale.  qleaf is one per-layer slice of quantize_serving_params
    output: codes [*w_shape], scale broadcastable to a scalar.

    Against the reference on the same inputs: equal activation codes
    and scales; the product agrees within one rounding of the output
    dtype (float32 sums in another order)."""
    wq = qleaf["q"]
    batch = x.shape[:x.ndim - x_contract_ndim]
    k = 1
    for d in wq.shape[:w_contract_ndim]:
        k *= d
    out_dims = wq.shape[w_contract_ndim:]
    sx = fp8.compute_scale(fp8.amax(x), fp8.E4M3)
    xq = fp8.quantize(x.reshape(-1, k), sx, fp8.E4M3)
    y = fp8.fp8_dot(xq, sx, wq.reshape(k, -1), qleaf["s"].reshape(()),
                    out_dtype=x.dtype)
    return y.reshape(batch + out_dims)
