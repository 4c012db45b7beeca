"""Flash-attention forward: the online softmax inside a CUDA kernel.

PyTorch wrapper of ``csrc/flash_attention.cu``, which replaces the
Pallas kernel ``flash_attention`` of ``repro/kernels/flash_attention.py``
(body ``_flash_kernel``) and covers every argument of the reference's
``models/attention.flash_attention``: causal or not, a sliding
``window``, ``q_offset``, Sq != Sk with ragged tails, GQA (H % KH == 0),
head_dim 16/32/64/80/128, float32 or bf16.  ``flash_attention_fwd``
returns the output and the log-sum-exp rows [B,H,Sq] (float32) that the
blockwise backward of models/attention.py reads; ``flash_attention`` is
the reference kernel's interface (the output alone).

The kernel runs one of three bodies, chosen by the rule ``body`` (a
mirror of the source's ``flash_attention_body``; a choice by dtype and
head_dim, never a fallback):

* ``"wgmma"`` — bf16 at head_dim 64 and 128: 128-row query tiles, a
  producer warpgroup loading Q and a ring of 128-key K/V tiles by TMA,
  two consumer warpgroups multiplying with ``wgmma`` (S = Q K^T from
  shared memory, P V with P in registers), the online softmax in exp2;
* ``"mma_sync"`` — bf16 at head_dim 16, 32 and 80: 64-row tiles of
  warp-level ``mma.sync``, K/V staged synchronously;
* ``"fma"`` — float32: fmaf on the CUDA cores.

``flash_attention_fwd`` calls the registered op
``torch.ops.repro_torch.flash_attention_fwd`` (defined with
``torch.library.Library``), which has three implementations; with no
dispatch mode active it calls the CUDA one directly.  For CUDA
tensors (``_flash_cuda``) it checks its operands, allocates the
outputs, launches the kernel on the current stream, raises if the
launch failed, and adds one to the launch count (``launch_counts``),
to its body's (``body_launches``) and to its shape's
(``shape_launches``).  On the meta device (the dry run) it returns the
outputs' shapes and dtypes and computes nothing; ``FlopCounterMode``
counts the kernel's own work there and on the card (``kernel_flops``:
the tile pairs its causal skip runs, not the plain version's
rectangle).  For CPU tensors it computes the plain
version (``flash_attention_fwd_plain``: the blockwise online-softmax
forward of models/attention.py, in the reference's block and pair
order); it never falls back from CUDA to the plain
version.  ``flash_attention_plain`` is the port of the reference's oracle
``ref.flash_attention`` (``attention_reference``).

Tolerance against the plain version: the kernel walks 128- or 64-key
(bf16) or 32-key (float32) tiles where the plain version walks 512-key
chunks, so its sums are grouped and rescaled in another order.  float32
within 1e-4 of o and lse, as the reference's kernel tests hold B9; bf16
o within one bf16 step of max |o| (a p or an output on a rounding
boundary may round the other way), lse within 1e-4 (float32).
"""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.models import attention

SOURCE = "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 80, 128)
WGMMA_HEAD_DIMS = (64, 128)            # whole 128-byte TMA box rows
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BODIES = ("wgmma", "mma_sync", "fma")  # the source's body codes
# launches of the kernel, in all and by body; dicts, not attributes of
# the wrapper, so the counts survive a caller that wraps
# `flash_attention_fwd`
_LAUNCHES = {"flash_attention": 0}
_BODY_LAUNCHES = dict.fromkeys(BODIES, 0)
# launches by (B, Sq, Sk, H, KH, hd, body): the shapes the kernel saw
_SHAPE_LAUNCHES: dict = {}


def body(dtype: torch.dtype, hd: int) -> str:
    """The body the kernel runs for (dtype, head_dim) (`flash_attention_body`
    of the source): "wgmma" for bf16 at head_dim 64 and 128, "mma_sync"
    for bf16 at the other head dims, "fma" for float32."""
    if dtype == torch.float32:
        return "fma"
    return "wgmma" if hd in WGMMA_HEAD_DIMS else "mma_sync"


def _check(q, k, v) -> None:
    """Operands the kernel takes: float32 or bf16, one dtype and one
    device, q [B,Sq,H,hd] and k/v [B,Sk,KH,hd] with H % KH == 0."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape or \
            q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] or \
            q.shape[2] % k.shape[2]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype}: the "
                        "kernel takes float32 or bfloat16, one dtype")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[3]} not in {HEAD_DIMS}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    # b*H + h spans grid.y (65535) times grid.z, an int in the kernel
    if q.shape[0] * q.shape[2] > 2 ** 31 - 1:
        raise ValueError(f"B*H = {q.shape[0] * q.shape[2]} query heads "
                         "exceed 2**31 - 1")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, starting on a 16-byte boundary (the kernel moves rows
    16 bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_fwd_plain(q, k, v, *, causal=True, window=0,
                              q_offset=0, q_chunk=512, kv_chunk=512):
    """(o, lse [B,H,Sq]) of the blockwise forward in torch ops."""
    qc = min(q_chunk, q.shape[1])
    kc = min(kv_chunk, k.shape[1])
    out, lse = attention._attn_fwd(q, k, v, causal, window, qc, kc,
                                   q_offset)
    return out, attention.lse_rows(lse, q.shape[1])


def flash_attention_plain(q, k, v, *, causal=True, window=0, q_offset=0):
    """The reference oracle of B9 (``ref.flash_attention``)."""
    return attention.attention_reference(q, k, v, causal=causal,
                                         window=window, q_offset=q_offset)


# the kernel's tiles by body: (query rows a block, query rows that walk
# the keys together, keys a tile); the wgmma body's two warpgroups of
# 64 rows each skip the key tiles none of their rows attend
KERNEL_TILES = {"wgmma": (128, 64, 128), "mma_sync": (64, 64, 64),
                "fma": (32, 32, 32)}


@functools.lru_cache(maxsize=4096)
def kernel_pairs(Sq: int, Sk: int, body_name: str, causal: bool,
                 window: int, q_offset: int) -> int:
    """(row group, key tile) pairs the kernel computes for one query
    head: the source's `key_range` walk a block, less the tiles the
    wgmma body's warpgroups release untouched (its `dead` rule)."""
    R, Rg, K = KERNEL_TILES[body_name]
    n = 0
    for q0 in range(0, Sq, R):
        rows = min(R, Sq - q0)
        p_lo, p_hi = q_offset + q0, q_offset + q0 + rows - 1
        hi = min(Sk, p_hi + 1) if causal else Sk
        lo = max(0, p_lo - window + 1) if window else 0
        k_first = lo // K * K
        nt = -(-(hi - k_first) // K) if hi > k_first else 0
        if Rg == R:
            n += nt
            continue
        for r_lo in range(q0, q0 + R, Rg):
            g_lo = q_offset + r_lo
            first, last = 0, nt - 1
            if causal:                         # k0 <= the group's last row
                last = min(last, (g_lo + Rg - 1 - k_first) // K)
            if window:                         # k0 + K - 1 > g_lo - window
                first = max(first, -(-(g_lo - window - K + 2 - k_first)
                                     // K))
            n += max(0, last - first + 1)
    return n


def kernel_flops(q_shape, k_shape, dtype: torch.dtype, *, causal: bool,
                 window: int = 0, q_offset: int = 0) -> float:
    """The kernel's own operations for q [B,Sq,H,hd], k [B,Sk,KH,hd]:
    4 * hd a (row, key) of every tile pair it computes (S = Q K^T and
    P V on whole tiles, masked entries and rows past Sq included), not
    the plain version's 512-key rectangle."""
    B, Sq, H, hd = q_shape
    Rg, K = KERNEL_TILES[body(dtype, hd)][1:]
    pairs = kernel_pairs(Sq, k_shape[1], body(dtype, hd), bool(causal),
                         int(window), int(q_offset))
    return 4.0 * hd * Rg * K * pairs * B * H


def _flash_cuda(q, k, v, causal, window, q_offset, q_chunk, kv_chunk):
    """B9 on the card: the hand-written kernel, counted."""
    _check(q, k, v)
    B, Sq, H, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if window < 0 or q_offset < 0 or kv_chunk <= 0:
        raise ValueError(f"window {window} and q_offset {q_offset} must be "
                         f"non-negative, kv_chunk {kv_chunk} positive")
    kc = min(kv_chunk, Sk)
    n_pad_keys = -(-Sk // kc) * kc
    from repro_torch.kernels import build
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    build.launch(SOURCE, "flash_attention_fwd", q.device, _DTYPES[q.dtype],
                 hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), B, Sq, Sk, H, KH,
                 int(bool(causal)), int(window), int(q_offset),
                 int(n_pad_keys), float(hd ** -0.5))
    _LAUNCHES["flash_attention"] += 1
    _BODY_LAUNCHES[body(q.dtype, hd)] += 1
    key = (B, Sq, Sk, H, KH, hd, body(q.dtype, hd))
    _SHAPE_LAUNCHES[key] = _SHAPE_LAUNCHES.get(key, 0) + 1
    return out, lse


def _flash_cpu(q, k, v, causal, window, q_offset, q_chunk, kv_chunk):
    """The plain version."""
    out, lse = flash_attention_fwd_plain(q, k, v, causal=causal,
                                         window=window, q_offset=q_offset,
                                         q_chunk=q_chunk, kv_chunk=kv_chunk)
    return out.contiguous(), lse.contiguous()


def _flash_meta(q, k, v, causal, window, q_offset, q_chunk, kv_chunk):
    """Shapes and dtypes only (the meta device: the dry run)."""
    _check(q, k, v)
    B, Sq, H, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((B, H, Sq), dtype=torch.float32))


# the op, through the dispatcher's own define / impl: a Python
# `custom_op` wraps each call in more Python, a floor that B9's
# launch-bound shapes feel
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
            "int window, int q_offset, int q_chunk, int kv_chunk) "
            "-> (Tensor, Tensor)")
for _key, _impl in (("CUDA", _flash_cuda), ("CPU", _flash_cpu),
                    ("Meta", _flash_meta)):
    _LIB.impl("flash_attention_fwd", _impl, _key)


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd,
                       get_raw=True)
def _flash_flops(q, k, v, causal, window, q_offset, q_chunk, kv_chunk, *args,
                 out_val=None, **kwargs) -> float:
    return kernel_flops(tuple(q.shape), tuple(k.shape), q.dtype,
                        causal=causal, window=window, q_offset=q_offset)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, q_chunk: int = 512,
                        kv_chunk: int = 512):
    """(o [B,Sq,H,hd] in q.dtype, lse [B,H,Sq] float32), the op
    ``torch.ops.repro_torch.flash_attention_fwd``: the kernel for CUDA
    tensors, the plain version for CPU tensors, shapes alone on meta
    (``FlopCounterMode`` counts `kernel_flops`).  A CUDA call with no
    dispatch mode active (nothing to see the op: no FlopCounterMode, no
    fake tensors) launches the op's CUDA implementation without the
    dispatcher's round trip; the same kernel either way.

    `q_chunk`/`kv_chunk` are the plain version's blocks; the kernel
    tiles on its own, and reads `kv_chunk` only for a row that attends
    no key, which the reference averages over all nk*kc positions of
    its padded key chunks."""
    args = (q, k, v, bool(causal), int(window), int(q_offset), int(q_chunk),
            int(kv_chunk))
    if q.is_cuda and not torch._C._len_torch_dispatch_stack():
        return _flash_cuda(*args)
    return torch.ops.repro_torch.flash_attention_fwd(*args)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """The reference kernel's interface: q [B,S,H,hd], k/v [B,S,KH,hd]
    -> [B,S,H,hd]; softmax scale hd**-0.5."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    return flash_attention_fwd(q, k, v, causal=causal)[0]


def reset_launch_counts() -> None:
    _LAUNCHES["flash_attention"] = 0
    _BODY_LAUNCHES.update(dict.fromkeys(BODIES, 0))
    _SHAPE_LAUNCHES.clear()


def launch_counts() -> dict:
    return dict(_LAUNCHES)


def body_launches() -> dict:
    """Launches by body since the last reset."""
    return dict(_BODY_LAUNCHES)


def shape_launches() -> dict:
    """Launches by (B, Sq, Sk, H, KH, hd, body) since the last reset."""
    return dict(_SHAPE_LAUNCHES)
