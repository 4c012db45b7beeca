"""Gradient compression with error feedback.

PyTorch counterpart of ``repro/optim/compress.py``.  Two compressors
for a gradient all-reduce over a slow link:

  bf16      2x: cast-reduce-cast (safe default)
  int8_ef   4x: per-tensor int8 with error feedback: the quantization
            residual is carried to the next step, which keeps SGD
            convergence (1-bit Adam / EF-SGD lineage)

`make_ef_state` / `apply_ef` integrate error feedback with any
optimizer, over nested dicts (any tree of core/tree.py) of tensors.
`compressed_psum` is the all-reduce itself over one axis of the port's
mesh (sharding/axes.Mesh), moving each rank's compressed payload round
the ring from device to device.
The arithmetic is the reference's in float32, op for op (``torch.round``
rounds half to even, as ``jnp.round``), so the results are its bits.
"""

from __future__ import annotations

from typing import Any, List, Tuple, Union

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


def _ring_devices(mesh, axis: str) -> List[torch.device]:
    """The devices of the ring along `axis`: the mesh positions whose
    other coordinates are 0."""
    i = mesh.axis_names.index(axis)
    index = [0] * len(mesh.axis_names)
    index[i] = slice(None)
    return list(mesh.devices[tuple(index)])


def compressed_psum(x: Union[torch.Tensor, List[torch.Tensor]], mesh,
                    axis: str, method: str = "int8_ef"):
    """All-reduce over the `axis` ring of `mesh`, moving int8 (or bf16)
    payloads from rank to rank.

    `x` is one tensor, replicated on every rank (the reference's
    ``in_specs=P()``), or a list with one tensor a rank of the ring.
    Each rank quantizes its value (``quantize_int8``); every hop moves
    each rank's current payload and scale to the next rank (rank i to
    i + 1, wrapping, ``size - 1`` hops: the reference's ``ppermute``
    order), and each rank adds the dequantized payload it received to
    its float32 sum, so rank r sums its own, then r-1's, r-2's, ... in
    that order.  ``bf16`` moves the bf16 values round the same ring and
    sums them in bf16 in the same order.  Returns the result in x's
    dtype: one tensor (rank 0's, on x's device) for a tensor `x`, else
    one a rank, on its rank's device."""
    size = mesh.shape[axis]
    ring = _ring_devices(mesh, axis)
    single = isinstance(x, torch.Tensor)
    xs = [x.to(d) for d in ring] if single else list(x)
    if len(xs) != size:
        raise ValueError(f"{len(xs)} values for a ring of {size} ranks")
    if size == 1:
        return x
    dtype = xs[0].dtype
    if method == "bf16":
        cur = [v.to(torch.bfloat16) for v in xs]
        acc = list(cur)
        for _ in range(size - 1):
            cur = [cur[(r - 1) % size].to(ring[r]) for r in range(size)]
            acc = [a + c for a, c in zip(acc, cur)]
    else:
        cur = [quantize_int8(v) for v in xs]
        acc = [dequantize_int8(q, s) for q, s in cur]
        for _ in range(size - 1):
            cur = [tuple(t.to(ring[r]) for t in cur[(r - 1) % size])
                   for r in range(size)]
            acc = [a + dequantize_int8(q, s) for a, (q, s) in zip(acc, cur)]
    out = [a.to(dtype) for a in acc]
    return out[0].to(x.device) if single else out
