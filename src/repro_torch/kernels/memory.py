"""Memory-hierarchy kernels: wrappers of csrc/memory.cu (paper Tables IV, V).

They replace no TPU kernel.  The reference (``benchmarks/memory.py``)
times the host: a numpy pointer chase and a jitted stream, since a TPU
offers no pointer chase.  On the H100 the paper's levels are the card's
own, and three kernels measure them by the paper's method:

  * pchase — one thread walks a chain of dependent 8-byte loads through
    L1 (``ld.global.ca``), past L1 (``.cg``: L2, or device memory once
    the chain outgrows L2) or through shared memory, timed with
    ``clock64`` and ``%globaltimer``.  It returns the last index, the
    SM cycles and the ns of the timed hops; the last index proves the
    walk: it equals the plain version's exactly.  Bound: latency (one
    load in flight), not bytes or operations.
  * stream — ``y = 2x + 1`` over float32 (the reference's stream), in
    16-byte vectors over every SM, ``passes`` times over the same
    arrays.  Bitwise ``x * 2 + 1`` (2x is exact).  Bound: bytes read and
    written over the device-memory rate.
  * onchip_bw — one block an SM reads a 16 KB array ``reps`` times in
    16-byte vectors from shared memory or from L1, each warp a row that
    moves on every rep (loads of one address every rep would be merged
    by ptxas), keeping a wrapping 32-bit checksum and its cycles (bytes
    a clock an SM).  Bound: 128
    bytes a clock an SM (32 banks x 4 bytes).

``pointer_chain`` builds the reference's chain (``benchmarks/memory.py``
``_pchase_latency_ns``): ``perm = default_rng(0).permutation(n)``,
``nxt[perm] = roll(perm, 1)``, ``n = max(size // 8, 16)``, one cycle
through every entry.

For CUDA tensors a wrapper checks its operands, allocates the outputs,
launches the kernel on the current stream, raises if the launch failed
and adds one to its ``launches`` count.  For CPU tensors it computes
the plain version (``*_plain``), which has no SM clock: the plain chase
times its hops on the host clock (the reference's host rows) and
reports 0 cycles; the plain on-chip read reports 0 cycles.  It never
falls back from CUDA to the plain version.
"""

from __future__ import annotations

import functools
import time
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import build

SOURCE = "memory.cu"
LOADS = {"ca": 0, "cg": 1, "shared": 2}
# the source's constants: kSmemLimit - 16 (a block's shared memory, less
# a sink), kBwWords (16 KB of uint32), kBwUnroll (reps are a multiple)
SHARED_CHAIN_BYTES = 232448 - 16
BW_MODES = {"shared": 0, "l1": 1}
BW_WORDS = 4096
BW_UNROLL = 8


@functools.lru_cache(maxsize=2)
def pointer_chain(size_bytes: int) -> np.ndarray:
    """The reference's chain of ``size_bytes // 8`` int64 entries (16 at
    least): from any entry, n hops visit every entry once.  Read-only
    and kept for the next call of the same size (a 1 GB chain's
    permutation takes seconds); ``torch.tensor(chain)`` copies it."""
    n = max(size_bytes // 8, 16)
    perm = np.random.default_rng(0).permutation(n)
    nxt = np.empty(n, np.int64)
    nxt[perm] = np.roll(perm, 1)
    nxt.setflags(write=False)
    return nxt


def _check_chain(chain: torch.Tensor, load: str, warm: int,
                 iters: int) -> None:
    if chain.ndim != 1 or chain.dtype != torch.int64 or \
            not chain.is_contiguous():
        raise ValueError(f"pchase: chain must be a contiguous 1-D int64 "
                         f"tensor, got {tuple(chain.shape)} {chain.dtype}")
    if load not in LOADS:
        raise ValueError(f"pchase: load {load!r} not one of {sorted(LOADS)}")
    if load == "shared" and chain.numel() * 8 > SHARED_CHAIN_BYTES:
        raise ValueError(f"pchase: a {chain.numel() * 8}-byte chain does not "
                         f"fit a block's shared memory "
                         f"({SHARED_CHAIN_BYTES} bytes)")
    if warm < 0 or not 0 <= iters < 2 ** 31:
        raise ValueError(f"pchase: warm {warm}, iters {iters} out of range")


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------

def pchase_plain(chain: torch.Tensor, warm: int,
                 iters: int) -> torch.Tensor:
    """[3] int64: the index after warm + iters hops from entry 0, 0
    cycles, and the host ns of the `iters` timed hops."""
    nxt = chain.cpu().numpy()
    i = 0
    for _ in range(warm):
        i = nxt[i]
    t0 = time.perf_counter_ns()
    for _ in range(iters):
        i = nxt[i]
    ns = time.perf_counter_ns() - t0
    return torch.tensor([int(i), 0, ns], dtype=torch.int64)


def stream_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2 + 1


def onchip_bw_plain(src: torch.Tensor, reps: int,
                    blocks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(checksums [blocks] int64, cycles [blocks] int64 = 0): every block
    reads every word `reps` times, so each checksum is reps x the sum of
    the words, mod 2**32."""
    words = int((src.cpu().to(torch.int64) & 0xFFFFFFFF).sum())
    total = (reps * words) & 0xFFFFFFFF
    return (torch.full((blocks,), total, dtype=torch.int64),
            torch.zeros((blocks,), dtype=torch.int64))


# ----------------------------------------------------------------------
# kernels
# ----------------------------------------------------------------------

def pchase(chain: torch.Tensor, load: str = "cg", *, iters: int,
           warm: int = 0) -> torch.Tensor:
    """[3] int64 on chain's device: the last index after warm + iters
    dependent loads from entry 0, the SM cycles and the ns of the
    `iters` timed ones."""
    _check_chain(chain, load, warm, iters)
    if chain.device.type == "cpu":
        return pchase_plain(chain, warm, iters)
    out = torch.empty(3, dtype=torch.int64, device=chain.device)
    build.launch(SOURCE, "pchase_fwd", chain.device, LOADS[load],
                 chain.data_ptr(), chain.numel(), warm, iters,
                 out.data_ptr())
    pchase.launches += 1
    return out


def stream(x: torch.Tensor, passes: int = 1) -> torch.Tensor:
    """y = 2x + 1 over a float32 tensor, computed `passes` times."""
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"stream: x must be a contiguous non-empty float32 "
                         f"tensor, got {x.dtype}")
    if passes < 1:
        raise ValueError(f"stream: passes={passes} must be positive")
    if x.device.type == "cpu":
        return stream_plain(x)
    if x.data_ptr() % 16:
        raise ValueError("stream: x must start on a 16-byte boundary")
    y = torch.empty_like(x)
    build.launch(SOURCE, "stream_fwd", x.device, x.data_ptr(), y.data_ptr(),
                 x.numel(), passes)
    stream.launches += 1
    return y


def onchip_bw(src: torch.Tensor, mode: str = "shared", *,
              reps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(checksums, cycles), int64 a block: one block on each SM of the
    card reads the 16 KB `src` (4096 int32 words) `reps` times from
    shared memory or from L1 (the plain version: one block)."""
    if src.shape != (BW_WORDS,) or src.dtype != torch.int32 or \
            not src.is_contiguous():
        raise ValueError(f"onchip_bw: src must be {BW_WORDS} contiguous "
                         f"int32 words, got {tuple(src.shape)} {src.dtype}")
    if mode not in BW_MODES:
        raise ValueError(f"onchip_bw: mode {mode!r} not one of "
                         f"{sorted(BW_MODES)}")
    if reps <= 0 or reps % BW_UNROLL:
        raise ValueError(f"onchip_bw: reps={reps} must be a positive "
                         f"multiple of {BW_UNROLL}")
    if src.device.type == "cpu":
        return onchip_bw_plain(src, reps, 1)
    blocks = torch.cuda.get_device_properties(
        src.device).multi_processor_count
    src2 = torch.cat([src, src])            # the kernel reads it twice over
    sums = torch.empty(blocks, dtype=torch.int32, device=src.device)
    cycles = torch.empty(blocks, dtype=torch.int64, device=src.device)
    build.launch(SOURCE, "onchip_bw_fwd", src.device, BW_MODES[mode],
                 src2.data_ptr(), reps, blocks, sums.data_ptr(),
                 cycles.data_ptr())
    onchip_bw.launches += 1
    return sums.to(torch.int64) & 0xFFFFFFFF, cycles


KERNELS = (pchase, stream, onchip_bw)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()
