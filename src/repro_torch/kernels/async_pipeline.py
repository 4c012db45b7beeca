"""Hand-staged matrix product (the cp.async / TMA analog): wrapper of
csrc/async_pipeline.cu.

``pipelined_matmul`` replaces the Pallas kernel ``pipelined_matmul`` of
``repro/kernels/async_pipeline.py`` (paper Tables XIII/XIV):

  stages=1  — plain loads into shared memory, sync, compute (SyncShare)
  stages>=2 — a ring of `stages` shared-memory buffers filled by
              cp.async, the copies of the next slices in flight while
              one computes (AsyncPipe)

float32 operands, float32 accumulation on the CUDA cores, float32 out
(a.dtype, as the reference's).  The kernel takes float32 only and
stages 1 to 4; other inputs raise on either device.

For CUDA tensors the wrapper checks its operands, allocates the output,
launches on the current stream, raises if the launch failed and adds
one to ``pipelined_matmul.launches``.  For CPU tensors it computes the
plain version (a float32 product cast to a.dtype).  Tolerance against
it: rtol/atol 1e-4 (the reference's bar; the two sum K in another
order).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import matmul as _mm

SOURCE = "async_pipeline.cu"
MAX_STAGES = 4


def smem_bytes(bm: int, bn: int, bk: int, stages: int) -> int:
    """`pipelined_matmul_smem_bytes` of the source: `stages` float32
    buffers of one A and one B slice each."""
    return stages * _mm.smem_bytes(torch.float32, bm, bn, bk)


def pipelined_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() @ b.float()).to(a.dtype)


def pipelined_matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 32,
                     bn: int = 32, bk: int = 32, stages: int = 2
                     ) -> torch.Tensor:
    """C = A @ B with hand-staged copies (stages=1 sync, >=2 cp.async)."""
    M, N, K = _mm.check_operands("pipelined_matmul", a, b, (torch.float32,))
    if min(bm, bn, bk) < 1:
        raise ValueError(f"pipelined_matmul: tiles {(bm, bn, bk)} must be "
                         "positive")
    if not 1 <= stages <= MAX_STAGES:
        raise ValueError(f"pipelined_matmul: stages={stages} not in "
                         f"1..{MAX_STAGES}")
    _mm.check_smem("pipelined_matmul", smem_bytes(bm, bn, bk, stages),
                   f"{(bm, bn, bk)} x {stages} stages")
    if a.device.type == "cpu":
        return pipelined_matmul_plain(a, b)
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    build.launch(SOURCE, "pipelined_matmul_fwd", a.device, a.data_ptr(),
                 b.data_ptr(), out.data_ptr(), M, N, K, bm, bn, bk, stages)
    pipelined_matmul.launches += 1
    return out


KERNELS = (pipelined_matmul,)


def reset_launch_counts() -> None:
    pipelined_matmul.launches = 0


def launch_counts() -> dict:
    return {"pipelined_matmul": pipelined_matmul.launches}


reset_launch_counts()
