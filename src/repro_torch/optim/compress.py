"""Gradient compression with error feedback.

PyTorch counterpart of ``repro/optim/compress.py`` (without its
``compressed_psum``, which waits for the port's tensor parallelism).
Two compressors for a gradient all-reduce over a slow link:

  bf16      2x: cast-reduce-cast (safe default)
  int8_ef   4x: per-tensor int8 with error feedback: the quantization
            residual is carried to the next step, which keeps SGD
            convergence (1-bit Adam / EF-SGD lineage)

`make_ef_state` / `apply_ef` integrate error feedback with any
optimizer, over nested dicts (any tree of core/tree.py) of tensors.
The arithmetic is the reference's in float32, op for op (``torch.round``
rounds half to even, as ``jnp.round``), so the results are its bits.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core.tree import leaves, tree_map, unflatten

Params = Any


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, float32 0-d scale): scale = max(max |x|, 1e-12) / 127,
    codes = clip(round(x / scale), -127, 127).  Both divisions are
    tensor by tensor: on CUDA a division by a Python number is a
    multiplication by its reciprocal, not the correctly rounded
    quotient."""
    top = torch.clamp(x.abs().max(), min=1e-12)
    scale = top / torch.full_like(top, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_residual(x: torch.Tensor, err: torch.Tensor, method: str
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (decompressed-after-compression value, new error)."""
    if method == "bf16":
        y = x.to(torch.bfloat16).to(torch.float32)
        return y, torch.zeros_like(err)
    if method == "int8_ef":
        xe = x + err
        q, s = quantize_int8(xe)
        y = dequantize_int8(q, s)
        return y, xe - y
    return x, torch.zeros_like(err)


def make_ef_state(grads: Params) -> Params:
    """float32 zeros shaped as each gradient leaf, on its device."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def apply_ef(grads: Params, ef: Params, method: str
             ) -> Tuple[Params, Params]:
    """Compress every gradient leaf (as float32) with error feedback.
    Returns (compressed gradients, new error state), both trees shaped
    as `grads`."""
    outs = [compress_residual(g.to(torch.float32), e, method)
            for g, e in zip(leaves(grads), leaves(ef))]
    return (unflatten(grads, [o[0] for o in outs]),
            unflatten(grads, [o[1] for o in outs]))
