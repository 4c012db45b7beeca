"""Paged-decode KV traffic model (the serving hot path).

PyTorch port's copy of ``paged_decode_kv_bytes`` and
``paged_decode_speedup`` from ``repro/core/roofline.py``: modeled bytes
of one decode step's K+V read, by read path.  Its modes are the
tracer's ``kv_read_mode`` values: ``kernel`` and ``fp8_kernel`` (the
port's server) and ``gather``.  The rest of the reference module
parses XLA's HLO and waits with ``launch/dryrun.py``.
"""

from __future__ import annotations

from typing import Dict


def paged_decode_kv_bytes(kv_len: int, *, block_size: int,
                          max_blocks: int, kv_heads: int, head_dim: int,
                          kv_dtype_bytes: int = 2, scale_bytes: int = 4,
                          mode: str = "gather") -> int:
    """Modeled HBM bytes moved by the K+V read path of ONE decode step,
    per layer per slot, at a current context of `kv_len` tokens.

    mode="gather" (models/attention.gather_paged_cache + the plain
    attention, the servers' ``kernel=False`` oracle):
    the gather reads the pool rows for all `max_blocks` table entries
    (clamped -1s included), writes the [max_blocks*block_size, KH, hd]
    virtual view, and the attention reads that view again — three
    passes over the slot's FULL virtual extent regardless of how short
    its live prefix is.

    mode="kernel" (kernels/paged_attention, the port's ChunkedServer
    read path): the in-kernel block-table walk loads only the
    ceil(kv_len/block_size) valid blocks, once, into shared memory —
    one pass over the live prefix, zero traffic for unallocated tail
    blocks.

    mode="fp8_kernel": same walk on an e4m3 pool — 1 byte per element
    plus one f32 scale per token-row per kv-head (`scale_bytes`).

    The factor-of-3 gather overhead and the valid-block-only kernel
    traffic are the reference's model, unchanged (the tests hold the
    two copies equal).
    """
    row = kv_heads * head_dim
    if mode == "gather":
        return 3 * max_blocks * block_size * row * kv_dtype_bytes * 2
    valid_tokens = -(-kv_len // block_size) * block_size
    if mode == "kernel":
        return valid_tokens * row * kv_dtype_bytes * 2
    if mode == "fp8_kernel":
        return valid_tokens * kv_heads * (head_dim + scale_bytes) * 2
    raise ValueError(f"unknown mode {mode!r}")


def paged_decode_speedup(kv_len: int, *, block_size: int,
                         max_blocks: int, kv_heads: int, head_dim: int
                         ) -> Dict[str, float]:
    """Byte-traffic ratios of the three paged decode read paths at one
    context length (HBM-bound decode: bytes ~ time)."""
    kw = dict(block_size=block_size, max_blocks=max_blocks,
              kv_heads=kv_heads, head_dim=head_dim)
    gather = paged_decode_kv_bytes(kv_len, mode="gather", **kw)
    kern = paged_decode_kv_bytes(kv_len, mode="kernel", **kw)
    fp8 = paged_decode_kv_bytes(kv_len, mode="fp8_kernel", **kw)
    return {"gather_bytes": float(gather), "kernel_bytes": float(kern),
            "fp8_kernel_bytes": float(fp8),
            "kernel_speedup": gather / kern,
            "fp8_speedup": gather / fp8,
            "fp8_vs_kernel_bytes": fp8 / kern}
