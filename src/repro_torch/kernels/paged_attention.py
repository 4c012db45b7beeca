"""Paged decode/chunk attention: the block-table walk inside a CUDA kernel.

PyTorch wrappers of ``csrc/paged_attention.cu``, which replaces the
Pallas kernels ``paged_decode`` and ``paged_chunk`` of
``repro/kernels/paged_attention.py``: their bf16/float32-pool bodies
(``paged_decode`` / ``paged_chunk`` here) and their e4m3-pool bodies
(``paged_decode_fp8`` / ``paged_chunk_fp8``, which take the float32
scales [NB,bs,KH,1] and dequantize in-tile to q's dtype).  The public
layout is the reference's.

For CUDA tensors a wrapper checks its operands, allocates the output,
launches the kernel on the current stream, raises if the launch failed,
and adds one to its ``launches`` count.  For CPU tensors it computes
the kernel's plain version (``*_plain``: the gathered view, dequantized
for fp8 pools, plus the multiply-and-sum attention of
models/attention.py); it never falls back from CUDA to the plain
version.

Tolerance against the plain version.  The kernel computes the same
function as the plain version but sums scores, softmax denominators
and PV in another order (warp-shuffle trees, fused multiply-adds), so
the two agree to float32 rounding, not bitwise: outputs within 2e-5 on
float32 q and within one bf16 rounding step (2e-2 at |o| <~ 4) on
bf16 q, where a p or an output that sits on a rounding boundary may
round the other way.  On fp8 pools the dequantized K/V values are
bitwise those of the plain version (the same float32 multiply and
rounding), so the same limits hold.  The reference's own claim of
bitwise kernel/gather parity does not carry over, and does not hold
even there: its float32 G=1 decode case differs bitwise from its
gather oracle (ROADMAP, queue C).
"""

from __future__ import annotations

import torch

from repro_torch.models import attention
from repro_torch.te.fp8 import E4M3

SOURCE = "paged_attention.cu"
HEAD_DIMS = (16, 32, 64, 128)
SMEM_LIMIT = 232448          # bytes of shared memory one block may use
_THREADS, _ROW_BATCH = 128, 8  # kThreads, kRowBatch of the source
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(G: int, hd: int, MB: int, bs: int) -> int:
    """Dynamic shared memory of one block: q, whole-row scores, and the
    PV partial sums (float32)."""
    return 4 * (G * hd + G * MB * bs + _THREADS * _ROW_BATCH)


def _per_slot(x, B: int, device) -> torch.Tensor:
    """A scalar or [B] length operand as a contiguous int32 [B] tensor
    on `device`."""
    x = torch.as_tensor(x, device=device)
    return x.to(torch.int32).expand(B).contiguous()


def _check(q, ck, cv, block_table, k_scale=None, v_scale=None):
    """Operands the kernel takes: q float32 or bf16; pools of q's dtype,
    or e4m3 pools with float32 scales [NB,bs,KH,1] (both scales or
    neither); an int32 table; one device; contiguous."""
    B, C, H, hd = q.shape
    NB, bs, KH, hd_k = ck.shape
    if cv.shape != ck.shape or hd_k != hd or H % KH:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(ck.shape)},"
                         f" v {tuple(cv.shape)} do not match")
    if block_table.ndim != 2 or block_table.shape[0] != B:
        raise ValueError(f"block_table {tuple(block_table.shape)} is not "
                         f"[{B}, max_blocks]")
    scales = [s for s in (k_scale, v_scale) if s is not None]
    pool = E4M3 if scales else q.dtype
    if q.dtype not in _DTYPES or ck.dtype != pool or cv.dtype != pool:
        raise TypeError(f"dtypes q {q.dtype}, k {ck.dtype}, v {cv.dtype}: "
                        "the kernel takes float32 or bfloat16 q with pools "
                        "of q's dtype, or e4m3 pools with scales")
    if scales:
        want = (NB, bs, KH, 1)
        for s in (k_scale, v_scale):
            if s is None or s.dtype != torch.float32 or \
                    tuple(s.shape) != want:
                raise TypeError(f"fp8 pools take float32 k_scale and "
                                f"v_scale of shape {want}")
    if block_table.dtype != torch.int32:
        raise TypeError(f"block_table dtype {block_table.dtype} is not int32")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", ck), ("v", cv),
                    ("block_table", block_table), ("k_scale", k_scale),
                    ("v_scale", v_scale)):
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    MB = block_table.shape[1]
    smem = smem_bytes(H // KH, hd, MB, bs)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"{smem} bytes of shared memory for G={H // KH}, "
            f"max_blocks*block_size={MB * bs} exceed the {SMEM_LIMIT}-byte "
            "per-block limit (contexts this long need a split-K kernel)")
    return B, C, H, hd, bs, KH, MB


def _launch(entry: str, q, operands, *dims) -> torch.Tensor:
    """Launch `entry` on q, the device `operands` (pools, scales, table,
    lengths, in the C signature's order) and the int `dims`."""
    from repro_torch.kernels import build
    out = torch.empty_like(q)
    build.launch(SOURCE, entry, q.device, _DTYPES[q.dtype], q.shape[-1],
                 q.data_ptr(), *(t.data_ptr() for t in operands),
                 out.data_ptr(), *dims, float(q.shape[-1] ** -0.5))
    return out


def _chunk_positions(q, pos) -> torch.Tensor:
    """q_positions [B, C] of a chunk whose slots start at `pos`."""
    pos = _per_slot(pos, q.shape[0], q.device)
    return pos[:, None] + torch.arange(q.shape[1], device=q.device,
                                       dtype=torch.int32)[None, :]


def paged_decode_plain(q, ck, cv, block_table, kv_len) -> torch.Tensor:
    kg, vg = attention.gather_paged_cache(ck, cv, block_table)
    return attention.decode_attention(q, kg, vg, kv_len)


def paged_chunk_plain(q, ck, cv, block_table, pos) -> torch.Tensor:
    kg, vg = attention.gather_paged_cache(ck, cv, block_table)
    return attention.chunk_attention(q, kg, vg, _chunk_positions(q, pos))


def _gather_fp8(q, ck, cv, k_scale, v_scale, block_table):
    return attention.gather_paged_cache_fp8(
        {"k": ck, "v": cv, "k_scale": k_scale, "v_scale": v_scale},
        block_table, out_dtype=q.dtype)


def paged_decode_fp8_plain(q, ck, cv, block_table, kv_len, *, k_scale,
                           v_scale) -> torch.Tensor:
    kg, vg = _gather_fp8(q, ck, cv, k_scale, v_scale, block_table)
    return attention.decode_attention(q, kg, vg, kv_len)


def paged_chunk_fp8_plain(q, ck, cv, block_table, pos, *, k_scale,
                          v_scale) -> torch.Tensor:
    kg, vg = _gather_fp8(q, ck, cv, k_scale, v_scale, block_table)
    return attention.chunk_attention(q, kg, vg, _chunk_positions(q, pos))


def paged_decode(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                 block_table: torch.Tensor, kv_len) -> torch.Tensor:
    """One-step paged decode.  q [B,1,H,hd]; pools [NB,bs,KH,hd];
    block_table [B,MB] int32 (-1 = unallocated); kv_len scalar or [B].
    Returns [B,1,H,hd] in q.dtype."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, ck, cv, block_table, kv_len)
    B, C, H, hd, bs, KH, MB = _check(q, ck, cv, block_table)
    if C != 1:
        raise ValueError(f"decode takes one query row per slot, got {C}")
    lens = _per_slot(kv_len, B, q.device)
    out = _launch("paged_decode_fwd", q, (ck, cv, block_table, lens),
                  B, H, KH, bs, MB)
    paged_decode.launches += 1
    return out


def paged_chunk(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                block_table: torch.Tensor, pos) -> torch.Tensor:
    """Paged chunk attention.  q [B,C,H,hd]; `pos` [B] is each slot's
    cache length BEFORE the chunk (row i sits at position pos+i and the
    chunk's k/v must already be scattered).  Rows past a slot's valid
    token count produce garbage rows the caller discards."""
    if q.device.type == "cpu":
        return paged_chunk_plain(q, ck, cv, block_table, pos)
    B, C, H, hd, bs, KH, MB = _check(q, ck, cv, block_table)
    lens = _per_slot(pos, B, q.device)
    out = _launch("paged_chunk_fwd", q, (ck, cv, block_table, lens),
                  B, C, H, KH, bs, MB)
    paged_chunk.launches += 1
    return out


def paged_decode_fp8(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     block_table: torch.Tensor, kv_len, *,
                     k_scale: torch.Tensor, v_scale: torch.Tensor
                     ) -> torch.Tensor:
    """`paged_decode` over e4m3 pools: each K/V element is
    ``(float(code) * scale)`` rounded to q.dtype, with scale
    ``k_scale``/``v_scale`` [NB,bs,KH,1] float32 of its (token, kv
    head) row; p is rounded to q.dtype before PV.  Limits against
    `paged_decode_fp8_plain`: 2e-5 on float32 q, 2e-2 on bf16 q."""
    if q.device.type == "cpu":
        return paged_decode_fp8_plain(q, ck, cv, block_table, kv_len,
                                      k_scale=k_scale, v_scale=v_scale)
    B, C, H, hd, bs, KH, MB = _check(q, ck, cv, block_table, k_scale,
                                     v_scale)
    if C != 1:
        raise ValueError(f"decode takes one query row per slot, got {C}")
    lens = _per_slot(kv_len, B, q.device)
    out = _launch("paged_decode_fp8_fwd", q,
                  (ck, cv, k_scale, v_scale, block_table, lens),
                  B, H, KH, bs, MB)
    paged_decode_fp8.launches += 1
    return out


def paged_chunk_fp8(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                    block_table: torch.Tensor, pos, *,
                    k_scale: torch.Tensor, v_scale: torch.Tensor
                    ) -> torch.Tensor:
    """`paged_chunk` over e4m3 pools, dequantized as in
    `paged_decode_fp8`.  Limits against `paged_chunk_fp8_plain`: 2e-5
    on float32 q, 2e-2 on bf16 q."""
    if q.device.type == "cpu":
        return paged_chunk_fp8_plain(q, ck, cv, block_table, pos,
                                     k_scale=k_scale, v_scale=v_scale)
    B, C, H, hd, bs, KH, MB = _check(q, ck, cv, block_table, k_scale,
                                     v_scale)
    lens = _per_slot(pos, B, q.device)
    out = _launch("paged_chunk_fp8_fwd", q,
                  (ck, cv, k_scale, v_scale, block_table, lens),
                  B, C, H, KH, bs, MB)
    paged_chunk_fp8.launches += 1
    return out


KERNELS = (paged_decode, paged_chunk, paged_decode_fp8, paged_chunk_fp8)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()
