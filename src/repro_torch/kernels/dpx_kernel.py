"""DPX kernels: wrappers of csrc/dpx.cu.

``tropical_matmul`` replaces the Pallas kernel ``tropical_matmul`` and
``smith_waterman`` replaces ``smith_waterman`` of
``repro/kernels/dpx_kernel.py`` (paper §III-D-1); ``dpx_fused`` is the
hardware path of the fused DPX family of ``core/dpx.py``:

  * tropical_matmul — int32 C[i,j] = max(INT_MIN, max_k(A[i,k]+B[k,j])),
    INT_MIN = iinfo(int32).min // 2 (the TPU kernel's accumulator
    start), sums wrapping in int32, inner step ``__viaddmax_s32``.  Two
    bodies, chosen by the rule ``body(M, N, K, aligned)`` from the
    shapes alone and passed to the launch:

    - ``"tma"`` — 32 divides K, N % 4 == 0 and both operands start on
      16 bytes: ``csrc/fma_pipe.cuh``'s TMA + mbarrier ring over the
      register-blocked tile of ``csrc/fma_tile.cuh`` on int32 (128 x 128
      outputs a block, 8 x 8 a thread, 32-deep K slices, four stages).
      TMA fills zeros past an edge, which is harmless past M and N (never
      stored) but not past K (0 + 0 beats a negative maximum), hence
      the rule on K.  The caller's (bm, bn, bk) do not shape it.
    - ``"staged"`` — any other operands: one block per (bm, bn) tile, K
      in bk slices copied element by element into shared memory.

    The caller's tiles keep the reference's contract on either body:
    they divide the problem, and their staging fits a block's shared
    memory.
  * smith_waterman — best local-alignment score per pair of int32
    sequences [B, La], [B, Lb], linear gap; a register wavefront in
    warps, 32 S columns a warp (S a lane), one row a step, neighbours
    handed on by ``__shfl_up_sync``, two DPX instructions a cell.  The
    plan ``smith_waterman_plan(La, Lb)`` takes the longer sequence as
    the rows (the score is symmetric) and bands across the shorter one,
    and names the body: ``"warp"`` (one band: a warp a pair, four pairs
    a block) or ``"bands"`` (a block a pair, its warps taking the bands
    in turn, each band's right edge handed to the next through a
    scratch tensor allocated here).  Shared memory does not grow with
    the lengths, so any pair runs.
  * dpx_fused — one elementwise kernel per call for viaddmax, viaddmin,
    viaddmax_relu, vimax3, vimax3_relu on int32, or int16 through the
    ``_s16x2`` forms on packed pairs.

For CUDA tensors a wrapper checks its operands, allocates the output,
launches the kernel on the current stream, raises if the launch failed
and adds one to its ``launches`` count (``tropical_matmul`` and
``smith_waterman`` also to ``launches_by_body[body]``).  For CPU tensors
it computes the plain version (``*_plain``).  It never falls back from
CUDA to the plain version, nor from one body to another.  The results
are integers: kernel and plain version agree exactly.

This module imports nothing of ``core/dpx.py`` (which calls
``dpx_fused``): the plain versions are written out here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import matmul as _mm

SOURCE = "dpx.cu"
INT_MIN = -(2 ** 31) // 2           # iinfo(int32).min // 2
SUB = 64                            # largest sub-tile edge of a block
TROPICAL_BODIES = ("tma", "staged")   # the source's codes 0, 1
TMA_TILE = 128                      # the tma body's output tile edge
TMA_BK = 32                         # ... and its K slice
SW_BODIES = ("warp", "bands")
SW_MAX_WARPS = 16                   # bands in flight a pair
SW_PAIRS = 4                        # pairs a block on the warp body
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
    """`tropical_smem_bytes` of the source: the staged body's bk-deep
    slice of A (rows padded by one word) and of B for one sub-tile of at
    most SUB x SUB."""
    return 4 * bk * (min(bm, SUB) + 1 + min(bn, SUB))


def body(M: int, N: int, K: int, aligned: bool = True) -> str:
    """The body tropical_matmul runs: "tma" where TMA_BK divides K and
    TMA can read both operands (16-byte-aligned bases, N a multiple of
    4, at most 65535 column tiles), else "staged".  `aligned`: both
    operands start on 16 bytes."""
    if (aligned and K % TMA_BK == 0 and N % 4 == 0
            and -(-N // TMA_TILE) <= 65535):
        return "tma"
    return "staged"


class SwPlan(NamedTuple):
    """How smith_waterman lays a batch of pairs out on the card."""
    body: str        # "warp" or "bands"
    swap: bool       # seq_b gives the rows (it is the longer one)
    rows: int        # the longer length: one step a row
    cols: int        # the shorter length, banded
    S: int           # columns a lane: a band is 32 S columns
    bands: int
    warps: int       # warps a pair
    pairs: int       # pairs a block
    smem_bytes: int  # dynamic shared memory a block
    scratch: int     # int32 band edges a pair: (bands - 1) x rows


def smith_waterman_plan(la: int, lb: int) -> SwPlan:
    """The plan of a [B, La] x [B, Lb] batch (the only copy of the rule;
    the wrapper passes it to the launch): rows = the longer sequence;
    S the least of 1, 2, 4, 8 whose band covers the shorter one, else 8
    and several bands; a warp a pair, SW_PAIRS a block, when one band
    covers it, else a block a pair of min(bands, SW_MAX_WARPS) warps,
    which the source's `smith_waterman_smem_bytes` sizes."""
    swap = lb > la
    rows, cols = (lb, la) if swap else (la, lb)
    S = next((s for s in (1, 2, 4) if 32 * s >= cols), 8)
    bands = -(-cols // (32 * S))
    warps = min(bands, SW_MAX_WARPS)
    one = bands == 1
    return SwPlan("warp" if one else "bands", swap, rows, cols, S, bands,
                  warps, SW_PAIRS if one else 1,
                  0 if warps == 1 else 12 * warps, (bands - 1) * rows)


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
    tiles that divide the problem, as the TPU kernel requires, on the
    body `body` names (the tiles shape only the staged body's launch)."""
    M, N, K = _mm.check_operands("tropical_matmul", a, b, (torch.int32,))
    if min(bm, bn, bk) < 1 or M % bm or N % bn or K % bk:
        raise ValueError(f"tropical_matmul: tiles {(bm, bn, bk)} do not "
                         f"divide the problem (M, N, K) = {(M, N, K)}")
    _mm.check_smem("tropical_matmul", tropical_smem_bytes(bm, bn, bk),
                   str((bm, bn, bk)))
    if a.device.type == "cpu":
        return tropical_matmul_plain(a, b)
    name = body(M, N, K, _mm.aligned(a, b, False))
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    build.launch(SOURCE, "tropical_matmul_fwd", a.device, a.data_ptr(),
                 b.data_ptr(), out.data_ptr(), M, N, K, bm, bn, bk,
                 TROPICAL_BODIES.index(name))
    tropical_matmul.launches += 1
    tropical_matmul.launches_by_body[name] += 1
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
    if seq_a.device.type == "cpu":
        return smith_waterman_plain(seq_a, seq_b, match=match,
                                    mismatch=mismatch, gap=gap)
    p = smith_waterman_plan(la, lb)
    rseq, cseq = (seq_b, seq_a) if p.swap else (seq_a, seq_b)
    out = torch.empty(B, dtype=torch.int32, device=seq_a.device)
    edge = (torch.empty((B, p.scratch), dtype=torch.int32,
                        device=seq_a.device) if p.scratch else None)
    build.launch(SOURCE, "smith_waterman_fwd", seq_a.device,
                 rseq.data_ptr(), cseq.data_ptr(), out.data_ptr(),
                 edge.data_ptr() if edge is not None else None, B, p.rows,
                 p.cols, p.S, p.warps, p.pairs, match, mismatch, gap)
    smith_waterman.launches += 1
    smith_waterman.launches_by_body[p.body] += 1
    return out


KERNELS = (tropical_matmul, smith_waterman, dpx_fused)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    tropical_matmul.launches_by_body = dict.fromkeys(TROPICAL_BODIES, 0)
    smith_waterman.launches_by_body = dict.fromkeys(SW_BODIES, 0)


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()
