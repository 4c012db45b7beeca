"""DPX kernels: wrappers of csrc/dpx.cu.

``tropical_matmul`` replaces the Pallas kernel ``tropical_matmul`` and
``smith_waterman`` replaces ``smith_waterman`` of
``repro/kernels/dpx_kernel.py`` (paper §III-D-1); ``dpx_fused`` is the
hardware path of the fused DPX family of ``core/dpx.py``:

  * tropical_matmul — int32 C[i,j] = max(INT_MIN, max_k(A[i,k]+B[k,j])),
    INT_MIN = iinfo(int32).min // 2 (the TPU kernel's accumulator
    start), sums wrapping in int32; one block per (bm, bn) tile, K in bk
    slices through shared memory, inner step ``__viaddmax_s32``.
  * smith_waterman — best local-alignment score per pair of int32
    sequences [B, La], [B, Lb]; one block per pair, anti-diagonal
    wavefront through ``__viaddmax_s32_relu``.
  * dpx_fused — one elementwise kernel per call for viaddmax, viaddmin,
    viaddmax_relu, vimax3, vimax3_relu on int32, or int16 through the
    ``_s16x2`` forms on packed pairs.

For CUDA tensors a wrapper checks its operands, allocates the output,
launches the kernel on the current stream, raises if the launch failed
and adds one to its ``launches`` count.  For CPU tensors it computes the
plain version (``*_plain``).  It never falls back from CUDA to the plain
version.  The results are integers: kernel and plain version agree
exactly.

This module imports nothing of ``core/dpx.py`` (which calls
``dpx_fused``): the plain versions are written out here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import matmul as _mm

SOURCE = "dpx.cu"
INT_MIN = -(2 ** 31) // 2           # iinfo(int32).min // 2
SUB = 64                            # largest sub-tile edge of a block
FUNCTIONS = ("viaddmax", "viaddmin", "viaddmax_relu", "vimax3",
             "vimax3_relu")
_FN_ID = {name: i for i, name in enumerate(FUNCTIONS)}
_DTYPES = {torch.int32: 0, torch.int16: 1}
# rows of A per chunk of a plain (max,+) / (min,+) product: the
# [rows, K, N] temporary stays within 1 GiB
CHUNK_BYTES = 1 << 30


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------

def dpx_fused_plain(name: str, a: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor) -> torch.Tensor:
    """The one-expression form of a fused DPX function."""
    if name == "viaddmax":
        return torch.maximum(a + b, c)
    if name == "viaddmin":
        return torch.minimum(a + b, c)
    if name == "viaddmax_relu":
        return torch.maximum(a + b, c).clamp_min(0)
    if name == "vimax3":
        return torch.maximum(torch.maximum(a, b), c)
    if name == "vimax3_relu":
        return torch.maximum(torch.maximum(a, b), c).clamp_min(0)
    raise ValueError(f"dpx_fused: unknown function {name!r}; one of "
                     f"{FUNCTIONS}")


def semiring_product(a: torch.Tensor, b: torch.Tensor,
                     red=torch.amax) -> torch.Tensor:
    """red_k(a[..., i, k] + b[..., k, j]) with sums in the operands'
    dtype, CHUNK_BYTES of [rows, K, N] temporary at a time."""
    K, N = a.shape[-1], b.shape[-1]
    rows = max(1, CHUNK_BYTES // (a.element_size() * K * N))
    return torch.cat([red(a[..., r0:r0 + rows, :, None] + b[..., None, :, :],
                          dim=-2)
                      for r0 in range(0, a.shape[-2], rows)], dim=-2)


def tropical_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """max(INT_MIN, max_k(a[i,k] + b[k,j])) in int32."""
    return semiring_product(a, b).clamp_min(INT_MIN)


def smith_waterman_plain(seq_a: torch.Tensor, seq_b: torch.Tensor, *,
                         match: int = 2, mismatch: int = -1,
                         gap: int = -1) -> torch.Tensor:
    """The TPU kernel's wavefront over [B, Lb + 1] rows: per anti-diagonal
    d, H[d][j] = max(H[d-2][j-1] + s, H[d-1][j] + gap, H[d-1][j-1] + gap,
    0) on valid cells, 0 elsewhere; the best H per pair."""
    B, la = seq_a.shape
    lb = seq_b.shape[1]
    dev = seq_a.device
    j = torch.arange(lb + 1, device=dev)
    b_g = seq_b[:, (j - 1).clamp(0, lb - 1)]
    m = torch.tensor(match, dtype=torch.int32, device=dev)
    mm = torch.tensor(mismatch, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    h1 = torch.zeros((B, lb + 1), dtype=torch.int32, device=dev)
    h2 = torch.zeros_like(h1)
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    for d in range(1, la + lb + 1):
        i = d - j
        valid = (i >= 1) & (i <= la) & (j >= 1)
        s = torch.where(seq_a[:, (i - 1).clamp(0, la - 1)] == b_g, m, mm)
        diag = h2.roll(1, dims=1)            # H[i-1, j-1]
        left = h1.roll(1, dims=1)            # H[i, j-1]
        h = torch.maximum(diag + s, torch.maximum(h1 + gap, left + gap))
        h = torch.where(valid, h.clamp_min(0), zero)
        h2, h1 = h1, h
        best = torch.maximum(best, h.amax(dim=1))
    return best


# ----------------------------------------------------------------------
# kernels
# ----------------------------------------------------------------------

def tropical_smem_bytes(bm: int, bn: int, bk: int) -> int:
    """`tropical_smem_bytes` of the source: a bk-deep slice of A (rows
    padded by one word) and of B for one sub-tile of at most SUB x SUB."""
    return 4 * bk * (min(bm, SUB) + 1 + min(bn, SUB))


def smith_waterman_smem_bytes(la: int, lb: int) -> int:
    """`smith_waterman_smem_bytes` of the source: both sequences, three
    diagonals of Lb + 1 cells, 32 warp maxima."""
    return 4 * (la + lb + 3 * (lb + 1) + 32)


def dpx_fused(name: str, a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor) -> torch.Tensor:
    """f(a, b, c) elementwise for a fused DPX function `name`, int32 or
    int16, three tensors of one shape."""
    if name not in _FN_ID:
        raise ValueError(f"dpx_fused: unknown function {name!r}; one of "
                         f"{FUNCTIONS}")
    if not (a.shape == b.shape == c.shape):
        raise ValueError(f"dpx_fused: shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)} differ")
    if not (a.dtype == b.dtype == c.dtype) or a.dtype not in _DTYPES:
        raise TypeError(f"dpx_fused: dtypes {a.dtype}, {b.dtype}, {c.dtype}: "
                        "the kernel takes three int32 or three int16 tensors")
    if not (a.device == b.device == c.device):
        raise ValueError("dpx_fused: operands on more than one device")
    if a.device.type == "cpu":
        return dpx_fused_plain(name, a, b, c)
    if not (a.is_contiguous() and b.is_contiguous() and c.is_contiguous()):
        raise ValueError("dpx_fused: operands must be contiguous")
    if a.dtype == torch.int16 and any(t.data_ptr() % 4 for t in (a, b, c)):
        raise ValueError("dpx_fused: int16 operands must start on a 4-byte "
                         "boundary (the kernel reads packed pairs)")
    out = torch.empty_like(a)
    build.launch(SOURCE, "dpx_fused_fwd", a.device, _FN_ID[name],
                 _DTYPES[a.dtype], a.data_ptr(), b.data_ptr(), c.data_ptr(),
                 out.data_ptr(), a.numel())
    dpx_fused.launches += 1
    return out


def tropical_matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 32,
                    bn: int = 32, bk: int = 32) -> torch.Tensor:
    """(max,+) matrix product of int32 [M,K] and [K,N] with (bm, bn, bk)
    tiles that divide the problem, as the TPU kernel requires."""
    M, N, K = _mm.check_operands("tropical_matmul", a, b, (torch.int32,))
    if min(bm, bn, bk) < 1 or M % bm or N % bn or K % bk:
        raise ValueError(f"tropical_matmul: tiles {(bm, bn, bk)} do not "
                         f"divide the problem (M, N, K) = {(M, N, K)}")
    _mm.check_smem("tropical_matmul", tropical_smem_bytes(bm, bn, bk),
                   str((bm, bn, bk)))
    if a.device.type == "cpu":
        return tropical_matmul_plain(a, b)
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    build.launch(SOURCE, "tropical_matmul_fwd", a.device, a.data_ptr(),
                 b.data_ptr(), out.data_ptr(), M, N, K, bm, bn, bk)
    tropical_matmul.launches += 1
    return out


def smith_waterman(seq_a: torch.Tensor, seq_b: torch.Tensor, *,
                   match: int = 2, mismatch: int = -1,
                   gap: int = -1) -> torch.Tensor:
    """Best local-alignment score per pair; seq_a [B, La], seq_b [B, Lb]
    int32 -> [B] int32."""
    if seq_a.ndim != 2 or seq_b.ndim != 2 or seq_a.shape[0] != seq_b.shape[0]:
        raise ValueError(f"smith_waterman: shapes {tuple(seq_a.shape)} and "
                         f"{tuple(seq_b.shape)} are not [B, La] and [B, Lb]")
    if seq_a.dtype != torch.int32 or seq_b.dtype != torch.int32:
        raise TypeError(f"smith_waterman: dtypes {seq_a.dtype}, "
                        f"{seq_b.dtype}; the kernel takes int32")
    if seq_a.device != seq_b.device:
        raise ValueError(f"smith_waterman: operands on {seq_a.device} and "
                         f"{seq_b.device}")
    if not (seq_a.is_contiguous() and seq_b.is_contiguous()):
        raise ValueError("smith_waterman: operands must be contiguous")
    B, la = seq_a.shape
    lb = seq_b.shape[1]
    if min(B, la, lb) < 1:
        raise ValueError("smith_waterman: empty batch or sequence")
    _mm.check_smem("smith_waterman", smith_waterman_smem_bytes(la, lb),
                   f"(La={la}, Lb={lb})")
    if seq_a.device.type == "cpu":
        return smith_waterman_plain(seq_a, seq_b, match=match,
                                    mismatch=mismatch, gap=gap)
    out = torch.empty(B, dtype=torch.int32, device=seq_a.device)
    build.launch(SOURCE, "smith_waterman_fwd", seq_a.device,
                 seq_a.data_ptr(), seq_b.data_ptr(), out.data_ptr(), B, la,
                 lb, match, mismatch, gap)
    smith_waterman.launches += 1
    return out


KERNELS = (tropical_matmul, smith_waterman, dpx_fused)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()
