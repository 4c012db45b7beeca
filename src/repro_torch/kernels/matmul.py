"""Tiled matrix product on the tensor cores: wrappers of csrc/matmul.cu.

``matmul`` replaces the Pallas kernel ``matmul`` and
``single_tile_matmul`` replaces ``single_tile_matmul`` of
``repro/kernels/matmul.py``.  The CUDA kernel gives each (bm, bn)
output tile a block of 256 threads that walks K in slices of bk staged
through shared memory; bf16 and int8 run through warp-level
``mma.sync`` (m16n8k16 bf16 -> f32, m16n8k32 s8 -> s32), float32 through
fmaf on the CUDA cores (not TF32).  A block holds at most a 128 x 256
output sub-tile in registers and walks a larger tile sub-tile by
sub-tile.  ``single_tile_matmul`` is the same walk in one block over
the whole product.

Outputs, as the reference's: ``matmul`` gives a.dtype for float32 and
bf16 in (the float32 accumulator rounded once) and int32 for int8 in;
``single_tile_matmul`` gives the accumulator's dtype (float32 for
float32 and bf16 in, int32 for int8 in).

For CUDA tensors a wrapper checks its operands, allocates the output,
launches the kernel on the current stream, raises if the launch failed
and adds one to its ``launches`` count.  For CPU tensors it computes
the plain version (``*_plain``): upcast to float32 (integers to int64
on the CPU, float64 on CUDA, exact while K*127*128 < 2**53), multiply,
cast as ``repro/kernels/ref.py`` does.  It never falls back from CUDA
to the plain version.  A tile whose staging needs more than 232448
bytes of shared memory raises ValueError on either device.

Tolerance against the plain version: the kernel sums K in another
order.  float32 within rtol 1e-5 (the reference's bar); bf16 out within
one bf16 rounding step of the output (both round the same float32 sum
but for its last bits); int8 exact.
"""

from __future__ import annotations

import torch

from repro_torch.core import hw
from repro_torch.kernels import build

SOURCE = "matmul.cu"
SMEM_LIMIT = hw.H100_SXM.vmem_bytes  # shared memory one block may use
MAX_SUB_M, MAX_SUB_N = 128, 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_KF = {torch.bfloat16: 16, torch.int8: 32}    # mma.sync fragment depth


def _ru(x: int, m: int) -> int:
    return -(-x // m) * m


def smem_bytes(dtype: torch.dtype, bm: int, bn: int, bk: int) -> int:
    """Shared memory one block stages for (bm, bn, bk): `matmul_smem_bytes`
    of the source.  float32: A and B slices, k-major.  Tensor-core
    dtypes: the slices padded to whole fragments (16 rows, 8 cols, KF
    deep), rows 16 bytes longer."""
    sm, sn = min(bm, MAX_SUB_M), min(bn, MAX_SUB_N)
    if dtype == torch.float32:
        return 4 * bk * (sm + sn)
    elt = dtype.itemsize
    lds = _ru(bk, _KF[dtype]) + 16 // elt
    return (_ru(sm, 16) + _ru(sn, 8)) * lds * elt


def check_smem(fn_name: str, nbytes: int, tiles: str) -> None:
    if nbytes > SMEM_LIMIT:
        raise ValueError(
            f"{fn_name}: tiles {tiles} stage {nbytes} bytes of shared "
            f"memory, over the {SMEM_LIMIT}-byte per-block limit; pass "
            "smaller tiles")


def check_operands(fn_name: str, a, b, dtypes) -> tuple:
    """(M, N, K) of a 2-D [M,K] @ [K,N] pair of one dtype out of
    `dtypes`, on one device, contiguous."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{fn_name}: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} do not make a matrix product")
    if a.dtype != b.dtype or a.dtype not in dtypes:
        raise TypeError(f"{fn_name}: dtypes {a.dtype}, {b.dtype}: the kernel "
                        f"takes two operands of one of {sorted(map(str, dtypes))}")
    if a.device != b.device:
        raise ValueError(f"{fn_name}: operands on {a.device} and {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{fn_name}: operands must be contiguous")
    return a.shape[0], b.shape[1], a.shape[1]


def _wide(t: torch.Tensor) -> torch.Tensor:
    """Exact upcast for the plain product: int64 on the CPU, float64 on
    CUDA (no integer matmul there); float32 for floating inputs."""
    if t.dtype.is_floating_point:
        return t.float()
    return t.to(torch.int64 if t.device.type == "cpu" else torch.float64)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype.is_floating_point else torch.int32


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    out = a.dtype if a.dtype.is_floating_point else torch.int32
    return (_wide(a) @ _wide(b)).to(out)


def single_tile_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (_wide(a) @ _wide(b)).to(_acc_dtype(a.dtype))


def matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
           bn: int = 128, bk: int = 128) -> torch.Tensor:
    """C = A @ B with explicit (bm, bn, bk) tiles (ragged edges masked)."""
    M, N, K = check_operands("matmul", a, b, _DTYPES)
    if min(bm, bn, bk) < 1:
        raise ValueError(f"matmul: tiles {(bm, bn, bk)} must be positive")
    check_smem("matmul", smem_bytes(a.dtype, bm, bn, bk), str((bm, bn, bk)))
    if a.device.type == "cpu":
        return matmul_plain(a, b)
    out = torch.empty((M, N), dtype=a.dtype if a.dtype.is_floating_point
                      else torch.int32, device=a.device)
    build.launch(SOURCE, "matmul_fwd", a.device, _DTYPES[a.dtype],
                 a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, bm, bn,
                 bk)
    matmul.launches += 1
    return out


def single_tile_bk(dtype: torch.dtype, M: int, N: int, K: int) -> int:
    """The K slice of the one-block walk: all of K if it fits, else
    halved until the staging fits."""
    bk = K
    while bk > 16 and smem_bytes(dtype, M, N, bk) > SMEM_LIMIT:
        bk = -(-bk // 2)
    return bk


def single_tile_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The whole [M,K] @ [K,N] product in one thread block (the
    synchronous mma analog of the latency table); output in the
    accumulator's dtype."""
    M, N, K = check_operands("single_tile_matmul", a, b, _DTYPES)
    bk = single_tile_bk(a.dtype, M, N, K)
    check_smem("single_tile_matmul", smem_bytes(a.dtype, M, N, bk),
               f"(whole, bk={bk})")
    if a.device.type == "cpu":
        return single_tile_matmul_plain(a, b)
    out = torch.empty((M, N), dtype=_acc_dtype(a.dtype), device=a.device)
    build.launch(SOURCE, "single_tile_matmul_fwd", a.device,
                 _DTYPES[a.dtype], a.data_ptr(), b.data_ptr(),
                 out.data_ptr(), M, N, K, bk)
    single_tile_matmul.launches += 1
    return out


KERNELS = (matmul, single_tile_matmul)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()
