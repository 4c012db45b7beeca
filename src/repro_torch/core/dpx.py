"""The DPX function family (paper §III-D-1, Figs. 6-7) on the H100.

Hopper's DPX instructions fuse min/max with an add or a relu into one
instruction (``__viaddmax_s32``, ``__vimax3_s32_relu``, and the
``_s16x2`` forms on packed int16 pairs), for the inner loops of dynamic
programming (Smith-Waterman, Needleman-Wunsch, Viterbi,
Floyd-Warshall).

Two variants of each function:
  * fused:    on a CUDA tensor one hand-written kernel that calls the
              DPX intrinsic (``kernels/dpx_kernel.dpx_fused``); on a CPU
              tensor the plain one-expression version.
  * emulated: the same math as separate torch ops on either device,
              each op a kernel of its own with its intermediate in
              memory: the sequence of instructions through memory that
              pre-Hopper software emulation runs.  (In torch eager
              ``torch.maximum(a + b, c)`` is two kernels already, which
              is why the fused family needs a kernel of its own.)

The benchmark (benchmarks/dpx.py) sweeps both over int32/int16, as in
Figs. 6/7.  ``tropical_matmul`` and ``smith_waterman`` here are plain
torch oracles for the kernels of ``kernels/dpx_kernel.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.kernels import dpx_kernel as _k


# ----------------------------------------------------------------------
# fused family (names follow CUDA __vi* intrinsics)
# ----------------------------------------------------------------------

def viaddmax(a, b, c):
    """max(a+b, c)  — __viaddmax_s32 / _s16x2."""
    return _k.dpx_fused("viaddmax", a, b, c)


def viaddmin(a, b, c):
    """min(a+b, c)  — __viaddmin_s32."""
    return _k.dpx_fused("viaddmin", a, b, c)


def vibmax(a, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """(max(a,b), a>=b)  — __vibmax_s32 (value + predicate)."""
    pred = a >= b
    return torch.where(pred, a, b), pred


def vibmin(a, b) -> Tuple[torch.Tensor, torch.Tensor]:
    pred = a <= b
    return torch.where(pred, a, b), pred


def vimax3(a, b, c):
    """max(a,b,c)  — __vimax3_s32."""
    return _k.dpx_fused("vimax3", a, b, c)


def vimin3(a, b, c):
    return torch.minimum(torch.minimum(a, b), c)


def viaddmax_relu(a, b, c):
    """max(a+b, c, 0)  — __viaddmax_s32_relu (SW local alignment core)."""
    return _k.dpx_fused("viaddmax_relu", a, b, c)


def vimax3_relu(a, b, c):
    """max(a, b, c, 0)  — __vimax3_s32_relu."""
    return _k.dpx_fused("vimax3_relu", a, b, c)


# ----------------------------------------------------------------------
# software-emulated family (pre-Hopper analog: one op per kernel)
# ----------------------------------------------------------------------

def viaddmax_emulated(a, b, c):
    s = a + b
    return torch.maximum(s, c)


def viaddmin_emulated(a, b, c):
    s = a + b
    return torch.minimum(s, c)


def viaddmax_relu_emulated(a, b, c):
    s = a + b
    m = torch.maximum(s, c)
    return m.clamp_min(0)


def vimax3_emulated(a, b, c):
    m = torch.maximum(a, b)
    return torch.maximum(m, c)


FUSED: Dict[str, Callable] = {
    "viaddmax": viaddmax,
    "viaddmin": viaddmin,
    "viaddmax_relu": viaddmax_relu,
    "vimax3": vimax3,
    "vimax3_relu": vimax3_relu,
}
EMULATED: Dict[str, Callable] = {
    "viaddmax": viaddmax_emulated,
    "viaddmin": viaddmin_emulated,
    "viaddmax_relu": viaddmax_relu_emulated,
    "vimax3": vimax3_emulated,
    "vimax3_relu": lambda a, b, c: vimax3_emulated(a, b, c).clamp_min(0),
}


# ----------------------------------------------------------------------
# DP primitives built on the family
# ----------------------------------------------------------------------

def tropical_matmul(A: torch.Tensor, B: torch.Tensor, *,
                    semiring: str = "max_plus") -> torch.Tensor:
    """(max,+) or (min,+) matrix product — Floyd-Warshall / Viterbi step.

    C[i,j] = max_k (A[i,k] + B[k,j]) (min for "min_plus"), sums in the
    operands' dtype.  Computed a chunk of rows of A at a time, so the
    [rows, K, N] temporary stays within 1 GiB.
    """
    assert A.shape[-1] == B.shape[-2]
    red = torch.amax if semiring == "max_plus" else torch.amin
    return _k.semiring_product(A, B, red)


def smith_waterman(seq_a: torch.Tensor, seq_b: torch.Tensor, *,
                   match: int = 2, mismatch: int = -1, gap: int = -1
                   ) -> torch.Tensor:
    """Local-alignment score matrix via anti-diagonal wavefront.

    Plain-torch oracle for kernels/dpx_kernel.py:
        H[i,j] = max(H[i-1,j-1]+s, H[i-1,j]+gap, H[i,j-1]+gap, 0)
    Returns the full H matrix, int32, shape (len_a+1, len_b+1).
    """
    la, lb = seq_a.shape[0], seq_b.shape[0]
    dev = seq_a.device
    m = torch.tensor(match, dtype=torch.int32, device=dev)
    mm = torch.tensor(mismatch, dtype=torch.int32, device=dev)
    sub = torch.where(seq_a[:, None] == seq_b[None, :], m, mm)
    j = torch.arange(lb + 1, device=dev)
    si_j = (j - 1).clamp(0, lb - 1)
    h_prev2 = torch.zeros(lb + 1, dtype=torch.int32, device=dev)
    h_prev1 = torch.zeros_like(h_prev2)
    diags = []
    for d in range(1, la + lb + 1):
        i = d - j                             # row index per diagonal cell
        valid = (i >= 1) & (i <= la) & (j >= 1)
        s = sub[(i - 1).clamp(0, la - 1), si_j]
        diag = h_prev2.roll(1)                # H[i-1,j-1] at slot j-1
        left = h_prev1.roll(1)                # H[i,j-1] at j-1
        up_left = _k.dpx_fused_plain("viaddmax", h_prev1,
                                     torch.full_like(h_prev1, gap),
                                     left + gap)
        h = _k.dpx_fused_plain("viaddmax_relu", diag, s, up_left)
        h = torch.where(valid, h, torch.zeros_like(h))
        h_prev2, h_prev1 = h_prev1, h
        diags.append(h)
    # Scatter anti-diagonals back to (i, j) layout.
    diags = torch.stack(diags)                # [la+lb, lb+1]
    d_idx = torch.arange(1, la + lb + 1, device=dev)
    ii = d_idx[:, None] - j[None, :]
    jj = j[None, :].expand_as(ii)
    ok = (ii >= 0) & (ii <= la)
    H = torch.zeros((la + 1, lb + 1), dtype=torch.int32, device=dev)
    H.index_put_((ii[ok], jj[ok]), diags[ok])
    return H
