"""Hand-staged matrix product (the TMA / cp.async analog): wrapper of
csrc/async_pipeline.cu.

``pipelined_matmul`` replaces the Pallas kernel ``pipelined_matmul`` of
``repro/kernels/async_pipeline.py`` (paper Tables XIII/XIV):

  stages=1  — start copy, wait, compute (SyncShare)
  stages>=2 — a ring of `stages` shared-memory buffers, the copies of
              the next slices in flight while one computes (AsyncPipe)

It runs one of two bodies, chosen by the rule ``body`` (a mirror of the
source's ``pipelined_matmul_body``; a documented choice by tile and
operand, never a fallback):

* ``"tma"`` — bm, bn and bk each 16, 32, 64 or 128, and operands TMA can
  read (16-byte-aligned bases, K and N multiples of 4, at most 65535
  column tiles): a producer warp issues TMA loads of each slice into an
  mbarrier ring, and the consumer threads run a register-blocked
  float32 tile (``csrc/fma_tile.cuh``; a tile of at most two warps runs
  as two K groups, ``k_groups``).  stages=1 is one buffer, whose next
  copy starts only once the consumers have released it.
* ``"cp_async"`` — any other tile or operand: 256 threads stage every
  element with plain loads (stages=1) or with cp.async into the ring
  (stages>=2), the compute threads issuing the copies.

float32 operands, float32 accumulation on the CUDA cores (fmaf, not
TF32), float32 out (a.dtype, as the reference's).  The kernel takes
float32 only and stages 1 to 4; other inputs raise on either device.

For CUDA tensors the wrapper checks its operands, allocates the output,
launches on the current stream, raises if the launch failed and adds
one to ``pipelined_matmul.launches`` and to
``pipelined_matmul.body_launches[body]``.  For CPU tensors it computes
the plain version (a float32 product cast to a.dtype).  Tolerance
against it: rtol/atol 1e-4 (the reference's bar; the two sum K in
another order).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import matmul as _mm

SOURCE = "async_pipeline.cu"
MAX_STAGES = 4
BODIES = ("tma", "cp_async")        # the source's body codes
TMA_WIDTHS = (16, 32, 64, 128)      # bm, bn and bk of the tma body
TMA_SLACK = 1024 + 128              # 1024-byte alignment + mbarriers


def tile_body(bm: int, bn: int, bk: int) -> str:
    """The body a tile takes on operands TMA can read."""
    return ("tma" if all(x in TMA_WIDTHS for x in (bm, bn, bk))
            else "cp_async")


def body(M: int, N: int, K: int, bm: int, bn: int, bk: int,
         aligned: bool = True) -> str:
    """The body pipelined_matmul runs (`pipelined_matmul_body` of the
    source): "tma" where the tile is on its grid and TMA can read both
    operands (16-byte-aligned bases, row strides K*4 and N*4 whole 16
    bytes, at most 65535 column tiles), else "cp_async"."""
    if tile_body(bm, bn, bk) == "tma" and _mm.fma_tma_ready(N, K, bm, bn,
                                                           aligned):
        return "tma"
    return "cp_async"


def k_groups(bm: int, bn: int) -> int:
    """K groups of the tma body (`k_groups` of the source): a float32
    tile of one warp, or an 8 x 8 tile of two warps, runs twice per
    block, each copy over half of every stage's K, and the halves are
    added at the end."""
    threads = (bm // 8 if bm >= 64 else 8) * (bn // 8 if bn >= 64
                                              else bn // 4)
    two = threads <= 32 or (bm >= 64 and bn >= 64 and threads <= 64)
    return 2 if two else 1


def smem_bytes(bm: int, bn: int, bk: int, stages: int,
               body_name: str | None = None) -> int:
    """Dynamic shared memory of `body_name` (default: the body the tile
    takes on TMA-readable operands, `pipelined_matmul_smem_bytes` of the
    source): tma, `stages` float32 buffers of an A and a B slice (or,
    with two K groups, the bm x bn partial sums if larger) plus
    alignment and barriers; cp_async, `stages` buffers of an A and a B
    slice of at most a 128 x 256 sub-tile."""
    name = body_name or tile_body(bm, bn, bk)
    if name == "tma":
        ring = stages * 4 * bk * (bm + bn)
        red = 4 * bm * bn if k_groups(bm, bn) > 1 else 0
        return TMA_SLACK + max(ring, red)
    return stages * _mm.smem_bytes(torch.float32, bm, bn, bk)


def pipelined_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() @ b.float()).to(a.dtype)


def pipelined_matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 32,
                     bn: int = 32, bk: int = 32, stages: int = 2
                     ) -> torch.Tensor:
    """C = A @ B with hand-staged copies (stages=1 sync, >=2 a ring)."""
    M, N, K = _mm.check_operands("pipelined_matmul", a, b, (torch.float32,))
    if min(bm, bn, bk) < 1:
        raise ValueError(f"pipelined_matmul: tiles {(bm, bn, bk)} must be "
                         "positive")
    if not 1 <= stages <= MAX_STAGES:
        raise ValueError(f"pipelined_matmul: stages={stages} not in "
                         f"1..{MAX_STAGES}")
    name = body(M, N, K, bm, bn, bk, _mm.aligned(a, b, False))
    _mm.check_smem("pipelined_matmul", smem_bytes(bm, bn, bk, stages, name),
                   f"{(bm, bn, bk)} x {stages} stages")
    if a.device.type == "cpu":
        return pipelined_matmul_plain(a, b)
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    build.launch(SOURCE, "pipelined_matmul_fwd", a.device, a.data_ptr(),
                 b.data_ptr(), out.data_ptr(), M, N, K, bm, bn, bk, stages)
    pipelined_matmul.launches += 1
    pipelined_matmul.body_launches[name] += 1
    return out


KERNELS = (pipelined_matmul,)


def reset_launch_counts() -> None:
    pipelined_matmul.launches = 0
    pipelined_matmul.body_launches = dict.fromkeys(BODIES, 0)


def launch_counts() -> dict:
    return {"pipelined_matmul": pipelined_matmul.launches}


reset_launch_counts()
