"""FP8 numerics for serving: e4m3 format, per-tensor and per-row scales.

PyTorch counterpart of the serving subset of ``repro/te/fp8.py``: the
scale rule ``scale = max(amax, 1e-12) * margin / fp8_max``, quantize
(divide by the scale, clip to the format's range, round to e4m3) and
dequantize, per-row scaling, and the scaled fp8 product.  The delayed-
scaling recipe of the training path is not ported yet.

The operations run in the reference's order on float32 values, so on
the same inputs the e4m3 codes and the scales are bitwise the
reference's (``x.to(torch.float8_e4m3fn)`` rounds to nearest even, as
``ml_dtypes`` does).  Every result stays a device tensor: nothing here
reads a value back to the host.
"""

from __future__ import annotations

from typing import Tuple

import torch

E4M3 = torch.float8_e4m3fn
FP8_MAX = {E4M3: 448.0}
DEFAULT_MARGIN = 2.0        # keep headroom below fp8_max, like TE margin


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


def fp8_dot(xq: torch.Tensor, x_scale: torch.Tensor, wq: torch.Tensor,
            w_scale: torch.Tensor, out_dtype=torch.bfloat16
            ) -> torch.Tensor:
    """xq [M, K] e4m3 @ wq [K, N] e4m3 -> out_dtype, times x_scale *
    w_scale (0-dim float32 tensors).

    On CUDA tensors this is cuBLAS's e4m3 tensor-core product
    (``torch._scaled_mm``, float32 accumulation, the scales applied in
    its epilogue); it wants `wq` column-major and K and N multiples of
    16, and raises otherwise.  The reference's ``fp8_dot`` is a plain
    ``jnp.dot``, not a Pallas kernel, so a library product is its port.
    On CPU tensors it is the plain version: the exact product of the
    codes summed in float32, times (x_scale * w_scale), then cast.
    """
    if xq.device.type == "cpu":
        acc = xq.float() @ wq.float()
        return (acc * (x_scale * w_scale)).to(out_dtype)
    K, N = wq.shape
    if K % 16 or N % 16:
        raise ValueError(f"fp8_dot on CUDA takes K and N that are "
                         f"multiples of 16, got K={K}, N={N}")
    return torch._scaled_mm(xq, wq, scale_a=x_scale, scale_b=w_scale,
                            out_dtype=out_dtype)
