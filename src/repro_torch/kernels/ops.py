"""Public wrappers of the matrix-product kernels, with the reference's
tile policy (``repro/kernels/ops.py``).

Tile shapes default to the tile model's autotuner
(``core/mxu_model.pick_tile`` for ``hw.TARGET``, with ``stages=1``: the
kernels stage one slice at a time; for bf16, int8 and the fp8 formats
its sweep keeps the tiles on the warpgroup grid, so an auto tile runs
``wgmma``) or, where a kernel has fixed
defaults (``pipelined_matmul``, ``tropical_matmul``: 32), to an automatic
``min(default, operand)`` fit.  Tile policy: ``0`` means "auto"; an
explicitly passed tile may be *smaller* than the operand (it is still
divisor-fitted to tile evenly) but a tile strictly larger than its
operand dimension raises ``ValueError`` instead of being silently
clamped.

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it
computes the kernel's plain version.
"""

from __future__ import annotations

import warnings

import torch

from repro_torch.core import hw, mxu_model
from repro_torch.kernels import async_pipeline as _async
from repro_torch.kernels import dpx_kernel as _dpx
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import fp8_matmul as _fp8
from repro_torch.kernels import matmul as _mm


class TileAlignmentWarning(UserWarning):
    """An explicitly-requested tile the kernel pads: it is not a whole
    number of ``mma.sync`` fragments and does not span the full operand
    dimension.  Which grid applies depends on the body the tile rule
    (``matmul.body``) picks.  A bf16, int8 or fp8 tile on the warpgroup
    grid (bm 64 or 128; bn 64, 128 or 256, fp8 at most 128; bk whole
    128-byte rows: a multiple of 64 for bf16, of 128 for 8-bit) runs
    ``wgmma`` where TMA can read the operands; such a tile is always a
    whole number of fragments and never warns.  Every other tile runs
    ``mma.sync`` (float32 runs fmaf on the same staging), whose grid is
    the fragment's, not the TPU's 8 x 128 lanes: 16 rows (bm), 8 columns
    (bn), and a depth (bk) of 32 for int8 (m16n8k32) or 16 otherwise
    (bf16 m16n8k16; fp8 is staged as bf16 on that body; float32 is held
    to the same grid).  The launch is correct (the staged slice is
    zero-padded to whole fragments) but wastes tensor-core work."""


def _fragment(dtype: torch.dtype) -> dict:
    return {"bm": 16, "bn": 8, "bk": 32 if dtype == torch.int8 else 16}


def _check_tiles(fn_name: str, align=None, **tile_vs_dim) -> None:
    """Reject explicitly-requested tiles strictly larger than their
    operand dimension (0 = auto is always fine), and warn when an
    explicit tile is not a multiple of its granularity in `align`
    (a tile spanning the whole operand dimension is exempt — there is
    nothing left to align)."""
    align = align or {}
    for name, (tile, dim) in tile_vs_dim.items():
        if tile and tile > dim:
            raise ValueError(
                f"{fn_name}: requested tile {name}={tile} exceeds the "
                f"operand dimension {dim}; pass {name}=0 (auto) or a "
                f"tile <= {dim}")
        if not tile or tile == dim:
            continue
        if name in align and tile % align[name]:
            warnings.warn(
                f"{fn_name}: tile {name}={tile} is not a multiple of the "
                f"mma.sync fragment's {align[name]} (and not the full "
                f"dimension {dim}); the kernel pads it to whole fragments",
                TileAlignmentWarning, stacklevel=3)


def _fit_tiles(m, n, k, bm, bn, bk):
    """Clamp autotuned tiles to divisors of the problem (even tiling)."""
    def clamp(dim, t):
        t = min(t, dim)
        while dim % t:
            t //= 2
        return max(t, 1)
    return clamp(m, bm), clamp(n, bn), clamp(k, bk)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _on_wgmma_grid(dtype, m, n, k, bm, bn, bk) -> bool:
    """The tile, fitted to (m, n, k), lies on the warpgroup grid of
    `dtype` and the wgmma body's ring holds at least one stage of it."""
    t = _fit_tiles(m, n, k, bm, bn, bk)
    return _mm.on_wgmma_grid(dtype, *t) and _mm.wgmma_stages(dtype, *t) > 0


def _auto_tiles(m, n, k, dtype) -> tuple:
    """The model's tile for (m, n, k) on ``hw.TARGET``, one stage
    (``pick_tile``).  For a dtype with a warpgroup grid (bf16, int8,
    e4m3, e5m2) the same sweep keeps only the candidates on that grid
    (`_on_wgmma_grid`), so the product runs ``wgmma`` and not
    ``mma_sync``; where none is on it (an operand narrower than every
    grid tile), the sweep's best as it is."""
    name = _dtype_name(dtype)
    best = None
    for bm, bn, bk in mxu_model.candidate_tiles(m, n, k):
        t = mxu_model.MatmulModel(m, n, k, bm, bn, bk, name, hw.TARGET, 1)
        if not t.fits_vmem() or not _on_wgmma_grid(dtype, m, n, k, bm, bn,
                                                    bk):
            continue
        if best is None or t.predicted_flops_per_s > \
                best.predicted_flops_per_s:
            best = t
    if best is None:
        best = mxu_model.pick_tile(m, n, k, name, chip=hw.TARGET, stages=1)
    return best.bm, best.bn, best.bk


def product_tiles(m, n, k, dtype, bm: int = 0, bn: int = 0,
                  bk: int = 0) -> tuple:
    """The (bm, bn, bk) that `matmul` / `fp8_matmul` launch for the
    requested tiles (any 0: the model's, `_auto_tiles`), divisor-fitted
    to the problem."""
    if not (bm and bn and bk):
        bm, bn, bk = _auto_tiles(m, n, k, dtype)
    return _fit_tiles(m, n, k, bm, bn, bk)


def matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 0, bn: int = 0,
           bk: int = 0) -> torch.Tensor:
    m, k = a.shape
    n = b.shape[1]
    _check_tiles("matmul", _fragment(a.dtype), bm=(bm, m), bn=(bn, n),
                 bk=(bk, k))
    bm, bn, bk = product_tiles(m, n, k, a.dtype, bm, bn, bk)
    return _mm.matmul(a, b, bm=bm, bn=bn, bk=bk)


def fp8_matmul(aq: torch.Tensor, bq: torch.Tensor, sx, sw, *, bm: int = 0,
               bn: int = 0, bk: int = 0) -> torch.Tensor:
    m, k = aq.shape
    n = bq.shape[1]
    _check_tiles("fp8_matmul", _fragment(aq.dtype), bm=(bm, m), bn=(bn, n),
                 bk=(bk, k))
    bm, bn, bk = product_tiles(m, n, k, aq.dtype, bm, bn, bk)
    return _fp8.fp8_matmul(aq, bq, sx, sw, bm=bm, bn=bn, bk=bk)


def pipelined_tiles(m, n, k, bm: int = 0, bn: int = 0, bk: int = 0,
                    stages: int = 2, aligned: bool = True) -> tuple:
    """The (bm, bn, bk) that `pipelined_matmul` launches: the requested
    tiles (0: 32) divisor-fitted to the problem, then the K slice halved
    (and fitted again) until `stages` slices of the tile fit a block's
    shared memory.  The reference stages its slices in a TPU core's
    16 MiB of VMEM, where a 128^3 tile fits at any stage count; an H100
    block holds 232448 bytes, which two 128-deep slices of a 128 x 128
    tile pass.  The product is the same: each output still sums K in
    order, a slice at a time."""
    bm, bn, bk = _fit_tiles(m, n, k, bm or 32, bn or 32, bk or 32)
    while bk > 1 and _async.smem_bytes(
            bm, bn, bk, stages,
            _async.body(m, n, k, bm, bn, bk, aligned)) > _mm.SMEM_LIMIT:
        bm, bn, bk = _fit_tiles(m, n, k, bm, bn, bk // 2)
    return bm, bn, bk


def pipelined_matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 0,
                     bn: int = 0, bk: int = 0, stages: int = 2
                     ) -> torch.Tensor:
    m, n, k = a.shape[0], b.shape[1], a.shape[1]
    _check_tiles("pipelined_matmul", _fragment(a.dtype), bm=(bm, m),
                 bn=(bn, n), bk=(bk, k))
    bm, bn, bk = pipelined_tiles(m, n, k, bm, bn, bk, stages,
                                 _mm.aligned(a, b, False))
    return _async.pipelined_matmul(a, b, bm=bm, bn=bn, bk=bk, stages=stages)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 0, bk: int = 0
                    ) -> torch.Tensor:
    """bq/bk default 0 = auto ``min(128, S)`` — decode-length inputs
    (S < 128) get an S-sized tile.  The reference's contract on the
    tiles is kept (a tile larger than its operand raises, a tile that
    does not divide S raises as the reference's kernel asserts, an
    explicit tile off the 16-row ``mma.sync`` grid warns), but the tiles
    do not shape the launch: the CUDA kernel's 64 x 64 (bf16) or
    32 x 32 (float32) tile is fixed by its warp layout and masks the
    ragged edge itself, and the results do not depend on bq/bk."""
    Sq, Sk = q.shape[1], k.shape[1]
    _check_tiles("flash_attention", {"bq": 16, "bk": 16}, bq=(bq, Sq),
                 bk=(bk, Sk))
    bq = bq or min(128, Sq)
    bk = bk or min(128, Sk)
    if Sq % bq or Sk % bk:
        raise ValueError(f"flash_attention: tiles bq={bq}, bk={bk} do not "
                         f"divide the sequence lengths {Sq}, {Sk}")
    return _flash.flash_attention(q, k, v, causal=causal)


def tropical_matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 0,
                    bn: int = 0, bk: int = 0) -> torch.Tensor:
    """bm/bn/bk default 0 = auto ``min(32, dim)`` fitted to a divisor.
    The reference's contract on the tiles is kept (a tile larger than
    its operand raises here, one that does not divide the problem raises
    in ``dpx_kernel.tropical_matmul``, and a tile whose staging exceeds
    a block's shared memory raises there), but on the ``tma`` body
    (``dpx_kernel.body``: 32 divides K, N % 4 == 0, operands on 16
    bytes) the tiles do not shape the launch: its 128 x 128 tile and
    32-deep K slices are fixed.  Only the ``staged`` body launches the
    given tiles.  The results are integers, exact whatever the tiling."""
    m, n, k = a.shape[0], b.shape[1], a.shape[1]
    _check_tiles("tropical_matmul", bm=(bm, m), bn=(bn, n), bk=(bk, k))
    bm, bn, bk = _fit_tiles(m, n, k, bm or 32, bn or 32, bk or 32)
    return _dpx.tropical_matmul(a, b, bm=bm, bn=bn, bk=bk)


def smith_waterman(seq_a: torch.Tensor, seq_b: torch.Tensor, *,
                   match: int = 2, mismatch: int = -1, gap: int = -1
                   ) -> torch.Tensor:
    return _dpx.smith_waterman(seq_a, seq_b, match=match, mismatch=mismatch,
                               gap=gap)
