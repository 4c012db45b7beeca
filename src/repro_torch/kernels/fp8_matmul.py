"""fp8 matrix product (the paper's QGMMA): wrapper of csrc/fp8_matmul.cu.

``fp8_matmul`` replaces the Pallas kernel ``fp8_matmul`` of
``repro/kernels/fp8_matmul.py``: C = (A_q @ B_q) * sx * sw with e4m3 or
e5m2 operands (one byte an element), a float32 accumulator, the
per-tensor scales read from device memory and applied once in the
epilogue (float32 ``sx * sw``), bf16 out.  Two bodies, chosen by the
tile rule (``matmul.body``, the source's ``fp8_matmul_body``):

* ``"wgmma"`` — tiles on the warpgroup grid (bm 64 or 128, bn 64 or
  128, bk a multiple of 128) and operands TMA can read (16-byte-aligned
  bases, K a multiple of 16): the codes go to shared memory by TMA and
  are multiplied by native e4m3 / e5m2 wgmma, each 128 values of K
  promoted into the float32 accumulator.  wgmma reads 8-bit B only
  K-major, so B is taken as a contiguous [K,N] tensor (copied K-major
  inside the call) or as a column-major [K,N] view (the layout
  ``torch._scaled_mm`` takes, passed as it is).
* ``"mma_sync"`` — any other tile: each code upcast to bf16 while
  staged (exact), bf16 ``mma.sync``; B row-major (a column-major view is
  copied).

For CUDA tensors the wrapper checks its operands, allocates the output,
launches on the current stream, raises if the launch failed and adds
one to ``fp8_matmul.launches`` and ``fp8_matmul.body_launches[body]``.
For CPU tensors it computes the plain version: codes upcast with
``.float()`` (exact), a float32 product, times the float32 ``sx * sw``,
rounded to bf16, as ``repro/kernels/ref.py`` does.  Tolerance against
it: one bf16 rounding step of the output (the two sum K in another
order; the promotion keeps the fp8 wgmma's partial sums within that).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import matmul as _mm

SOURCE = "fp8_matmul.cu"
FORMATS = {torch.float8_e4m3fn: 0, torch.float8_e5m2: 1}


def smem_bytes(bm: int, bn: int, bk: int, body_name: str = "mma_sync",
               dtype: torch.dtype = torch.float8_e4m3fn) -> int:
    """`fp8_matmul_wgmma_smem_bytes` of the source for "wgmma" (one byte
    a code), else `fp8_matmul_smem_bytes` (staged as bf16)."""
    return _mm.smem_bytes(dtype, bm, bn, bk, body_name)


def _scale(s, device) -> torch.Tensor:
    """A per-tensor scale as a one-element float32 tensor on `device`
    (a tensor already there is not read back to the host)."""
    return torch.as_tensor(s, dtype=torch.float32,
                           device=device).reshape(1).contiguous()


def fp8_matmul_plain(aq: torch.Tensor, bq: torch.Tensor, sx, sw,
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    acc = aq.float() @ bq.float()
    scale = _scale(sx, aq.device) * _scale(sw, aq.device)
    return (acc * scale).to(out_dtype)


def fp8_matmul(aq: torch.Tensor, bq: torch.Tensor, sx, sw, *, bm: int = 128,
               bn: int = 128, bk: int = 128) -> torch.Tensor:
    """C = (A_q @ B_q) * sx*sw with fp8 operands, bf16 out.  B is a
    contiguous [K,N] tensor or a column-major [K,N] view."""
    M, N, K = _mm.check_operands("fp8_matmul", aq, bq, FORMATS,
                                 b_col_ok=True)
    if min(bm, bn, bk) < 1:
        raise ValueError(f"fp8_matmul: tiles {(bm, bn, bk)} must be positive")
    layout = _mm.b_layout("fp8_matmul", bq, True)
    name = _mm.body(aq.dtype, M, N, K, bm, bn, bk, layout,
                    _mm.aligned(aq, bq, copied_b=layout == "row"))
    _mm.check_smem("fp8_matmul", smem_bytes(bm, bn, bk, name, aq.dtype),
                   str((bm, bn, bk)))
    if aq.device.type == "cpu":
        return fp8_matmul_plain(aq, bq, sx, sw)
    sx, sw = _scale(sx, aq.device), _scale(sw, aq.device)
    bq, b_kmajor = _mm.operand_b(bq, layout, name)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=aq.device)
    build.launch(SOURCE, "fp8_matmul_fwd", aq.device, FORMATS[aq.dtype],
                 aq.data_ptr(), bq.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                 out.data_ptr(), M, N, K, bm, bn, bk, b_kmajor)
    fp8_matmul.launches += 1
    fp8_matmul.body_launches[name] += 1
    return out


KERNELS = (fp8_matmul,)


def reset_launch_counts() -> None:
    fp8_matmul.launches = 0
    fp8_matmul.body_launches = dict.fromkeys(_mm.BODIES[:2], 0)


def launch_counts() -> dict:
    return {"fp8_matmul": fp8_matmul.launches}


reset_launch_counts()
