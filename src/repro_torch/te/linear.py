"""Serving-side fp8 linears: weights quantized once, activations per call.

PyTorch counterpart of the serving half of ``repro/te/linear.py``.
Serving weights are frozen, so the server quantizes every per-layer
attention and MLP weight of the stacked ``[L, ...]`` parameter tree to
e4m3 once at init, with one scale per layer and tensor, and the hot
path quantizes only the activation (a fresh per-call scale).  Training's
``te_linear`` with delayed scaling is not ported yet.

Layout: each quantized leaf ``{"q", "s"}`` keeps the reference's shapes
(codes ``[L, *w_shape]``, scales ``[L, 1, ...]``) and the same codes,
but the codes of one layer are stored transposed, ``[N, K]`` row-major
for the weight's ``[K, N]`` contraction, so that one layer's
``q[i].reshape(K, N)`` is the column-major operand ``torch._scaled_mm``
takes, with no transpose per call.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.te import fp8

Params = Dict[str, Any]

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
