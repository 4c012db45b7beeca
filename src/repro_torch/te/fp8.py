"""FP8 numerics: formats, per-tensor scaling, the delayed-scaling recipe.

PyTorch counterpart of ``repro/te/fp8.py``: e4m3 (the forward format)
and e5m2 (the gradient format), the scale rule ``scale = max(amax,
1e-12) * margin / fp8_max``, quantize (divide by the scale, clip to the
format's range, round to the format) and dequantize, per-row scaling,
Transformer Engine's delayed scaling (an amax history per quantized
tensor, the scale from the history's max, threaded through as state),
and the scaled fp8 product.

The operations run in the reference's order on float32 values, so on
the same inputs the codes, the scales and the histories are bitwise
the reference's (``x.to(torch.float8_e4m3fn)`` and ``.to(float8_e5m2)``
round to nearest even, as ``ml_dtypes`` does).  Every result stays a
device tensor: nothing here reads a value back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2
FP8_MAX = {E4M3: 448.0, E5M2: 57344.0}
DEFAULT_MARGIN = 2.0        # keep headroom below fp8_max, like TE margin
# torch._scaled_mm takes K and N that are multiples of this
_MM_ALIGN = 16


def amax(x: torch.Tensor) -> torch.Tensor:
    return x.float().abs().amax()


def compute_scale(amax_val: torch.Tensor, dtype=E4M3,
                  margin: float = DEFAULT_MARGIN) -> torch.Tensor:
    """scale s.t. x/scale fits the fp8 range: scale = amax*margin/fp8_max.

    The divisor is a tensor, not a Python number: on CUDA, PyTorch
    divides by a Python number through its float32 reciprocal, which
    can round one ulp away from the true quotient the reference takes.
    """
    safe = torch.clamp(amax_val, min=1e-12)
    return safe * margin / torch.full_like(safe, FP8_MAX[dtype])


def quantize(x: torch.Tensor, scale: torch.Tensor,
             dtype=E4M3) -> torch.Tensor:
    xs = x.float() / scale
    lim = FP8_MAX[dtype]
    return torch.clamp(xs, -lim, lim).to(dtype)


def dequantize(xq: torch.Tensor, scale: torch.Tensor,
               out_dtype=torch.bfloat16) -> torch.Tensor:
    return (xq.float() * scale).to(out_dtype)


def quantize_rowwise(x: torch.Tensor, dtype=E4M3
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last-dim) scaling: codes like x, scales [..., 1]."""
    scale = compute_scale(x.float().abs().amax(dim=-1, keepdim=True), dtype)
    return quantize(x, scale, dtype), scale


# ----------------------------------------------------------------------
# Delayed scaling (TE recipe): scales come from an amax *history*
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DelayedScalingRecipe:
    history_len: int = 16
    margin: float = DEFAULT_MARGIN
    fwd_dtype: torch.dtype = E4M3
    bwd_dtype: torch.dtype = E5M2


def init_fp8_state(recipe: DelayedScalingRecipe, tensors: Tuple[str, ...],
                   device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """One amax-history row + current scale per quantized tensor."""
    return {name: {"history": torch.zeros((recipe.history_len,),
                                          dtype=torch.float32, device=device),
                   "scale": torch.ones((), dtype=torch.float32,
                                       device=device)}
            for name in tensors}


def update_fp8_state(recipe: DelayedScalingRecipe,
                     st: Dict[str, torch.Tensor], new_amax: torch.Tensor,
                     dtype) -> Dict[str, torch.Tensor]:
    """Roll the history by one, put `new_amax` at its front and take the
    scale from its max (TE 'delayed'); new tensors, the old state stays."""
    hist = torch.cat([new_amax.reshape(1).float(), st["history"][:-1]])
    return {"history": hist,
            "scale": compute_scale(hist.amax(), dtype, recipe.margin)}


# ----------------------------------------------------------------------
# the scaled product
# ----------------------------------------------------------------------

def _round_up(n: int) -> int:
    return -(-n // _MM_ALIGN) * _MM_ALIGN


def _laid_out(t: torch.Tensor, rows: int, cols: int,
              col_major: bool) -> torch.Tensor:
    """fp8 `t` [r, c] as a [rows, cols] operand, zero codes past its
    edge, row-major or column-major; `t` itself where it already is
    one.  The codes move as bytes (uint8 views)."""
    r, c = t.shape
    if (r, c) == (rows, cols) and (t.t() if col_major else t).is_contiguous():
        return t
    out = torch.zeros((cols, rows) if col_major else (rows, cols),
                      dtype=torch.uint8, device=t.device)
    if col_major:
        out = out.t()
    out[:r, :c].copy_(t.view(torch.uint8))
    return out.view(t.dtype)


def scaled_mm_operands(xq: torch.Tensor, wq: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xq [M, K] and wq [K, N] as ``torch._scaled_mm`` takes them: xq
    row-major, wq column-major, K and N zero-padded to multiples of 16.
    Zero codes add nothing to a sum, so the first N columns of the
    padded product are the product."""
    (M, K), N = xq.shape, wq.shape[1]
    Kp, Np = _round_up(K), _round_up(N)
    return _laid_out(xq, M, Kp, False), _laid_out(wq, Kp, Np, True)


def fp8_dot(xq: torch.Tensor, x_scale: torch.Tensor, wq: torch.Tensor,
            w_scale: torch.Tensor, out_dtype=torch.bfloat16
            ) -> torch.Tensor:
    """xq [M, K] @ wq [K, N] (e4m3 or e5m2 codes, any shape and layout)
    -> out_dtype, times x_scale * w_scale (0-dim float32 tensors).

    On CUDA tensors this is cuBLAS's fp8 tensor-core product
    (``torch._scaled_mm``, float32 accumulation, the scales applied in
    its epilogue) on the operands of ``scaled_mm_operands``: a copy only
    where an operand is not in the layout it takes or K or N is not a
    multiple of 16.  cuBLAS takes e4m3 x e4m3, e4m3 x e5m2 and e5m2 x
    e4m3, not e5m2 x e5m2.  The reference's ``fp8_dot`` is a plain
    ``jnp.dot``, not a Pallas kernel, so a library product is its port.
    On CPU tensors it is the plain version: the exact product of the
    codes summed in float32, times (x_scale * w_scale), then cast.
    """
    if xq.device.type == "cpu":
        acc = xq.float() @ wq.float()
        return (acc * (x_scale * w_scale)).to(out_dtype)
    a, b = scaled_mm_operands(xq, wq)
    out = torch._scaled_mm(a, b, scale_a=x_scale, scale_b=w_scale,
                           out_dtype=out_dtype)
    N = wq.shape[1]
    return out if out.shape[1] == N else out[:, :N]
