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

For CUDA tensors ``flash_attention_fwd`` checks its operands, allocates
the outputs, launches the kernel on the current stream, raises if the
launch failed, and adds one to the launch count (``launch_counts``),
to its body's (``body_launches``) and to its shape's
(``shape_launches``).  For CPU tensors it computes the plain
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

import torch

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


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, q_chunk: int = 512,
                        kv_chunk: int = 512):
    """(o [B,Sq,H,hd] in q.dtype, lse [B,H,Sq] float32).

    `q_chunk`/`kv_chunk` are the plain version's blocks; the kernel
    tiles on its own, and reads `kv_chunk` only for a row that attends
    no key, which the reference averages over all nk*kc positions of
    its padded key chunks."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         window=window, q_offset=q_offset,
                                         q_chunk=q_chunk, kv_chunk=kv_chunk)
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
