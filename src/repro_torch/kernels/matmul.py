"""Tiled matrix product on the tensor cores: wrappers of csrc/matmul.cu.

``matmul`` replaces the Pallas kernel ``matmul`` and
``single_tile_matmul`` replaces ``single_tile_matmul`` of
``repro/kernels/matmul.py``.  ``matmul`` runs one of three bodies,
chosen by the tile rule ``body`` (a mirror of the source's
``matmul_body``; a documented choice by shape, never a fallback):

* ``"wgmma"`` — bf16 and int8 whose (bm, bn, bk) lie on the warpgroup
  grid (bm 64 or 128; bn 64, 128 or 256; bk whole 128-byte rows of a
  TMA box: a multiple of 64 for bf16, at most 256, of 128 for int8)
  and whose operands TMA can read (16-byte-aligned bases, K and, for
  bf16, N a whole number of 16 bytes).  TMA stages in an mbarrier ring,
  a producer warp, one consumer warpgroup per 64 rows, wgmma from
  shared memory (``csrc/wgmma_common.cuh``).  bf16 reads B row-major
  as it lies; int8 wgmma reads B only K-major, so B is taken as a
  contiguous [K,N] tensor (copied K-major inside the call,
  ``b.t().contiguous()``) or as a column-major [K,N] view
  (``b.t().is_contiguous()``, passed as it is).
* ``"mma_sync"`` — bf16 and int8 off that grid: a block of 256 threads
  per tile walks K in slices of bk staged through shared memory, with
  warp-level ``mma.sync`` (m16n8k16 bf16 -> f32, m16n8k32 s8 -> s32).
  A block holds at most a 128 x 256 output sub-tile in registers and
  walks a larger tile sub-tile by sub-tile.
* ``"fma_tma"`` — float32 whose bm and bn are each 16, 32, 64 or 128
  and whose operands TMA can read (16-byte-aligned bases, K and N
  multiples of 4, at most 65535 column tiles): the TMA + mbarrier ring
  of ``pipelined_matmul``'s tma body (``csrc/fma_pipe.cuh``), two
  stages of 64-float K slices (whatever bk is) feeding the
  register-blocked fmaf tile of ``csrc/fma_tile.cuh``.
* ``"fma"`` — every other float32 tile or operand: the mma_sync walk
  in fmaf on the CUDA cores.  Neither float32 body uses TF32.  A
  float32 tile is held to the bytes the fma body stages for (bm, bn,
  bk) on either body, so a tile refused before fma_tma is refused still.

``single_tile_matmul`` computes the whole product in one block, on one
of two bodies chosen by ``single_tile_body`` (a mirror of the source's
``single_tile_matmul_body``; a choice by operand, never a fallback):

* ``"tma"`` — operands TMA can read (16-byte-aligned bases, K and N
  rows whole 16 bytes): a producer warp issues TMA loads of K slices
  128 bytes deep (``single_tile_bk``: 32 float32, 64 bf16, 128 int8
  values) into mbarrier rings; eight consumer warps walk 128 x 256
  (bf16, int8) or 128 x 128 (float32) output sub-tiles with
  ``mma.sync`` fed by ``ldmatrix`` (int8 B transposed in shared memory
  first) or the register-blocked fmaf tile, keeping a column block's B
  in shared memory for all its row blocks where it fits
  (``single_tile_smem_bytes``).
* ``"staged"`` — any other operands: the mma_sync / fma walk with each
  K slice staged element by element (``mma_smem_bytes``).

Outputs, as the reference's: ``matmul`` gives a.dtype for float32 and
bf16 in (the float32 accumulator rounded once) and int32 for int8 in;
``single_tile_matmul`` gives the accumulator's dtype (float32 for
float32 and bf16 in, int32 for int8 in).

For CUDA tensors a wrapper checks its operands, allocates the output,
launches the kernel on the current stream, raises if the launch failed
and adds one to its ``launches`` count and to its
``body_launches[body]``.  For CPU tensors it computes the plain
version (``*_plain``): upcast to float32 (integers to int64 on the CPU,
float64 on CUDA, exact while K*127*128 < 2**53), multiply, cast as
``repro/kernels/ref.py`` does.  It never falls back from CUDA to the
plain version, nor from one body to another.  A tile whose staging
needs more than 232448 bytes of shared memory raises ValueError on
either device.

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
_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)
BODIES = ("wgmma", "mma_sync", "fma", "fma_tma")   # the source's codes
SINGLE_BODIES = ("tma", "staged")             # single_tile_matmul's
# the wgmma body (csrc/wgmma_common.cuh)
WG_BM = (64, 128)                 # one or two consumer warpgroups
WG_BN = (64, 128, 256)            # fp8: 64, 128 (promoted accumulators)
BOX_BYTES = 128                   # one 128-byte-swizzled row of a box
MAX_STAGES = 6
SMEM_SLACK = 1024 + 128           # 1024-byte alignment + mbarriers
FMA_TMA_WIDTHS = (16, 32, 64, 128)   # bm and bn of the fma_tma body


def _ru(x: int, m: int) -> int:
    return -(-x // m) * m


def mma_smem_bytes(dtype: torch.dtype, bm: int, bn: int, bk: int) -> int:
    """Shared memory the mma_sync / fma bodies stage for (bm, bn, bk).
    float32: A and B slices, k-major.  Tensor-core dtypes (fp8 is staged
    as bf16): the slices padded to whole fragments (16 rows, 8 cols, KF
    deep), rows 16 bytes longer."""
    sm, sn = min(bm, MAX_SUB_M), min(bn, MAX_SUB_N)
    if dtype == torch.float32:
        return 4 * bk * (sm + sn)
    if dtype in _FP8:
        dtype = torch.bfloat16
    elt = dtype.itemsize
    lds = _ru(bk, _KF[dtype]) + 16 // elt
    return (_ru(sm, 16) + _ru(sn, 8)) * lds * elt


def wgmma_stages(dtype: torch.dtype, bm: int, bn: int, bk: int) -> int:
    """Stages of the wgmma body's ring: as many as fit, at most
    MAX_STAGES (0: not even one fits)."""
    stage = (bm + bn) * bk * dtype.itemsize
    return min(MAX_STAGES, (SMEM_LIMIT - SMEM_SLACK) // stage)


def wgmma_smem_bytes(dtype: torch.dtype, bm: int, bn: int, bk: int) -> int:
    """The wgmma body's dynamic shared memory: the ring of stages (A and B
    of bk values each) plus alignment and barriers; over the limit when
    not even one stage fits."""
    stage = (bm + bn) * bk * dtype.itemsize
    return SMEM_SLACK + max(1, wgmma_stages(dtype, bm, bn, bk)) * stage


def on_wgmma_grid(dtype: torch.dtype, bm: int, bn: int, bk: int) -> bool:
    """(bm, bn, bk) on the warpgroup grid of `dtype` (bf16, int8, fp8)."""
    if dtype not in (torch.bfloat16, torch.int8) + _FP8:
        return False
    widths = WG_BN[:2] if dtype in _FP8 else WG_BN
    if bm not in WG_BM or bn not in widths:
        return False
    elt = dtype.itemsize
    if bk <= 0 or (bk * elt) % BOX_BYTES:
        return False
    return elt == 1 or bk <= 256


def tma_ready(dtype: torch.dtype, N: int, K: int, bn: int,
              aligned: bool) -> bool:
    """TMA can read the operands: 16-byte-aligned bases, row strides of
    whole 16 bytes (A and K-major B by K, a 16-bit row-major B by N),
    the grid's N extent within 65535 blocks."""
    elt = dtype.itemsize
    if not aligned or (K * elt) % 16:
        return False
    if elt == 2 and (N * elt) % 16:
        return False
    return -(-N // bn) <= 65535


def fma_tma_ready(N: int, K: int, bm: int, bn: int, aligned: bool) -> bool:
    """The TMA ring of csrc/fma_pipe.cuh takes the tile and operands: bm
    and bn on its grid, operands TMA can read (16-byte-aligned bases, K
    and N multiples of 4), the grid's N extent within 65535 blocks (also
    pipelined_matmul's rule, with its bk)."""
    return (bm in FMA_TMA_WIDTHS and bn in FMA_TMA_WIDTHS and aligned
            and K % 4 == 0 and N % 4 == 0 and -(-N // bn) <= 65535)


def body(dtype: torch.dtype, M: int, N: int, K: int, bm: int, bn: int,
         bk: int, b_layout: str = "row", aligned: bool = True) -> str:
    """The body a product runs: "wgmma", "mma_sync", "fma" or "fma_tma"
    (the tile rule, `matmul_body` / `fp8_matmul_body` of the sources).
    `b_layout` is B's layout as given, "row" (contiguous [K,N]) or
    "col" (a column-major view, 8-bit types only); it does not change
    the body, because a row-major 8-bit B is copied K-major for wgmma
    and a column-major one row-major for mma_sync.  `aligned`: the
    operands the kernel receives start on 16 bytes."""
    if b_layout not in ("row", "col"):
        raise ValueError(f"b_layout {b_layout!r}: 'row' or 'col'")
    if b_layout == "col" and dtype.itemsize != 1:
        raise ValueError(f"{dtype}: B must be row-major")
    if dtype == torch.float32:
        return "fma_tma" if fma_tma_ready(N, K, bm, bn, aligned) else "fma"
    if on_wgmma_grid(dtype, bm, bn, bk) and tma_ready(dtype, N, K, bn,
                                                      aligned):
        return "wgmma"
    return "mma_sync"


def smem_bytes(dtype: torch.dtype, bm: int, bn: int, bk: int,
               body_name: str = "mma_sync") -> int:
    """Shared memory one block stages for (bm, bn, bk) on `body_name`:
    `matmul_wgmma_smem_bytes` of the source for "wgmma", else
    `matmul_smem_bytes` (the mma_sync / fma staging, which also holds a
    float32 tile on "fma_tma": its own ring of two 64-deep stages, at
    most 132224 bytes, always fits)."""
    if body_name == "wgmma":
        return wgmma_smem_bytes(dtype, bm, bn, bk)
    return mma_smem_bytes(dtype, bm, bn, bk)


def b_layout(fn_name: str, b: torch.Tensor, col_ok: bool) -> str:
    """"row" for a contiguous B, "col" for a column-major view where the
    kernel takes one (`col_ok`); raises otherwise."""
    if b.is_contiguous():
        return "row"
    if col_ok and b.t().is_contiguous():
        return "col"
    raise ValueError(f"{fn_name}: operands must be contiguous"
                     + (" (B may also be a column-major view)"
                        if col_ok else ""))


def aligned(a: torch.Tensor, b: torch.Tensor, copied_b: bool) -> bool:
    """The operands the kernel receives start on 16 bytes (a B copied
    inside the call is a fresh, aligned allocation)."""
    return a.data_ptr() % 16 == 0 and (copied_b or b.data_ptr() % 16 == 0)


def operand_b(b: torch.Tensor, layout: str, body_name: str
              ) -> tuple:
    """B as the body reads it, and whether that is K-major: the 8-bit
    wgmma body reads [N,K] (a column-major view as it is, a row-major B
    copied); every other body reads row-major [K,N]."""
    if body_name == "wgmma" and b.dtype.itemsize == 1:
        return (b if layout == "col" else b.t().contiguous()), 1
    return (b if layout == "row" else b.contiguous()), 0


def check_smem(fn_name: str, nbytes: int, tiles: str) -> None:
    if nbytes > SMEM_LIMIT:
        raise ValueError(
            f"{fn_name}: tiles {tiles} stage {nbytes} bytes of shared "
            f"memory, over the {SMEM_LIMIT}-byte per-block limit; pass "
            "smaller tiles")


def check_operands(fn_name: str, a, b, dtypes, b_col_ok: bool = False
                   ) -> tuple:
    """(M, N, K) of a 2-D [M,K] @ [K,N] pair of one dtype out of
    `dtypes`, on one device, contiguous (B also column-major where
    `b_col_ok`)."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{fn_name}: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} do not make a matrix product")
    if a.dtype != b.dtype or a.dtype not in dtypes:
        raise TypeError(f"{fn_name}: dtypes {a.dtype}, {b.dtype}: the kernel "
                        f"takes two operands of one of {sorted(map(str, dtypes))}")
    if a.device != b.device:
        raise ValueError(f"{fn_name}: operands on {a.device} and {b.device}")
    if not a.is_contiguous():
        raise ValueError(f"{fn_name}: operands must be contiguous")
    b_layout(fn_name, b, b_col_ok)
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
    """C = A @ B with explicit (bm, bn, bk) tiles (ragged edges masked).
    B is contiguous [K,N]; an int8 B may also be a column-major view."""
    M, N, K = check_operands("matmul", a, b, _DTYPES,
                             b_col_ok=a.dtype == torch.int8)
    if min(bm, bn, bk) < 1:
        raise ValueError(f"matmul: tiles {(bm, bn, bk)} must be positive")
    layout = b_layout("matmul", b, a.dtype == torch.int8)
    name = body(a.dtype, M, N, K, bm, bn, bk, layout,
                aligned(a, b, copied_b=layout == "row"
                        and a.dtype == torch.int8))
    check_smem("matmul", smem_bytes(a.dtype, bm, bn, bk, name),
               str((bm, bn, bk)))
    if a.device.type == "cpu":
        return matmul_plain(a, b)
    b, b_kmajor = operand_b(b, layout, name)
    out = torch.empty((M, N), dtype=a.dtype if a.dtype.is_floating_point
                      else torch.int32, device=a.device)
    build.launch(SOURCE, "matmul_fwd", a.device, _DTYPES[a.dtype],
                 a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, bm, bn,
                 bk, b_kmajor)
    matmul.launches += 1
    matmul.body_launches[name] += 1
    return out


# single_tile_matmul's tma body (csrc/matmul.cu, namespace st)
ST_SUB_M = 128                    # output rows of a sub-tile
ST_STAGES_A, ST_STAGES_B = 4, 4   # A ring; a B ring that streams
ST_SLACK = 1024 + 256             # 1024-byte alignment + mbarriers
ST_ROW = 128                      # bytes of K in a slice, of a box row
ST_EPILOGUE = 8 * 8 * 68 * 4      # bf16/int8: eight warps' staged rows


def single_tile_body(dtype: torch.dtype, M: int, N: int, K: int,
                     aligned: bool = True) -> str:
    """The body single_tile_matmul runs (`single_tile_matmul_body` of the
    source): "tma" where TMA can read both operands (16-byte-aligned
    bases, K and N rows whole 16 bytes), else "staged"."""
    elt = dtype.itemsize
    if aligned and (K * elt) % 16 == 0 and (N * elt) % 16 == 0:
        return "tma"
    return "staged"


def single_tile_smem_bytes(dtype: torch.dtype, M: int, N: int,
                           K: int) -> int:
    """`single_tile_matmul_smem_bytes` of the source: the tma body's four
    A stages ([128][128 bytes]), its B stages ([bk][128 bytes] boxes
    over a 256-wide, float32 128-wide, column block), for int8 the
    transposed B copies, and for bf16 and int8 the epilogue's staged
    output rows.  Where a column block's whole B fits beside the rest
    and there is more than one row block, B is kept (one stage per K
    slice) instead of streamed (four stages; int8: two TMA stages, two
    transposed)."""
    elt = dtype.itemsize
    sub_n = 128 if elt == 4 else 256
    a_bytes = ST_SUB_M * ST_ROW
    b_bytes = (ST_ROW // elt) * ST_ROW * (sub_n * elt // ST_ROW)
    t_bytes = sub_n * ST_ROW if elt == 1 else 0
    nk = -(-K // (ST_ROW // elt))
    fixed = ST_SLACK + ST_STAGES_A * a_bytes + (0 if elt == 4
                                                 else ST_EPILOGUE)
    kept = (2 * b_bytes + nk * t_bytes) if elt == 1 else nk * b_bytes
    resident = -(-M // ST_SUB_M) > 1 and fixed + kept <= SMEM_LIMIT
    sb = 2 if elt == 1 else (nk if resident else ST_STAGES_B)
    ts = (nk if resident else 2) if elt == 1 else 0
    return fixed + sb * b_bytes + ts * t_bytes


def single_tile_bk(dtype: torch.dtype, M: int, N: int, K: int,
                   body_name: str = "tma") -> int:
    """The K slice of the one-block walk: on the tma body 128 bytes of K;
    on the staged body all of K if it fits, else halved until the
    staging fits."""
    if body_name == "tma":
        return ST_ROW // dtype.itemsize
    bk = K
    while bk > 16 and mma_smem_bytes(dtype, M, N, bk) > SMEM_LIMIT:
        bk = -(-bk // 2)
    return bk


def single_tile_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The whole [M,K] @ [K,N] product in one thread block (the
    synchronous mma analog of the latency table); output in the
    accumulator's dtype."""
    M, N, K = check_operands("single_tile_matmul", a, b, _DTYPES)
    name = single_tile_body(a.dtype, M, N, K, aligned(a, b, False))
    bk = single_tile_bk(a.dtype, M, N, K, name)
    nbytes = (single_tile_smem_bytes(a.dtype, M, N, K) if name == "tma"
              else mma_smem_bytes(a.dtype, M, N, bk))
    check_smem("single_tile_matmul", nbytes, f"(whole, bk={bk})")
    if a.device.type == "cpu":
        return single_tile_matmul_plain(a, b)
    out = torch.empty((M, N), dtype=_acc_dtype(a.dtype), device=a.device)
    build.launch(SOURCE, "single_tile_matmul_fwd", a.device,
                 _DTYPES[a.dtype], a.data_ptr(), b.data_ptr(),
                 out.data_ptr(), M, N, K, bk)
    single_tile_matmul.launches += 1
    single_tile_matmul.body_launches[name] += 1
    return out


KERNELS = (matmul, single_tile_matmul)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    matmul.body_launches = dict.fromkeys(BODIES, 0)
    single_tile_matmul.body_launches = dict.fromkeys(SINGLE_BODIES, 0)


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()
