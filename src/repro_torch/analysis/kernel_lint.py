"""Layer 2: launch-plan lint of the hand-written CUDA kernels.

The counterpart of ``repro/analysis/kernel_lint.py``, which spies on
``pl.pallas_call``.  The port's kernels are launched through ctypes
(``kernels/build.launch``) by wrappers whose tiles, bodies, grids and
shared memory follow Python rules that the sources mirror; so each
launch of a workload is planned from those rules, on shapes alone:

* ``ops.product_tiles``, ``matmul.body`` / ``smem_bytes`` (the
  products, fp8 too);
* ``async_pipeline.body`` / ``smem_bytes`` (``pipelined_matmul``);
* ``flash_attention.body`` (B9: its grid and shared memory are the
  source's own, held by the launch match and a ``static_assert``);
* ``dpx_kernel.body`` and ``smith_waterman_plan``;
* ``paged_attention.plan`` and its ``smem_bytes`` (B1-B4).

The sweep is the reference's 13 workloads (`default_workloads`, the
same names and shapes) through ``kernels/ops.py`` and
``kernels/paged_attention.py``.  On the CPU the layer only plans.  On
the card (``device`` cuda) it also runs each workload for real with
``build.launch`` spied on, and holds the plan to the launches: each
planned launch must match exactly one real launch of the planned entry
point with the planned arguments (every argument but the pointers), and
no launch may go unplanned; a mismatch raises ``PlanMismatch``, since
the lint would then be checking something other than what runs.

Rules, on each planned launch:

* **KL001** — a tile larger than its operand extent (the caller's
  tiles, as the reference's contract has them, B9's too; the paged
  kernels, which mask a fixed tile, are held on the positions a split
  walks).
* **KL002** — the grid x tile does not cover the output: rows and
  columns of a product, pairs and columns of Smith-Waterman; for the
  paged kernels, ``splits`` x split length must cover the table's
  context and row groups x ``rows`` each slot's query rows of a kv
  head.
* **KL003** (warning) — a bf16, int8 or fp8 tile off the warpgroup grid
  (``matmul.on_wgmma_grid``) where the operands admit a grid tile, so
  the product falls back to ``mma_sync``.
* **KL004** (warning) — a tile that is neither a multiple of the
  ``mma.sync`` fragment (``ops._fragment``) nor the full dimension.
* **KL005** — dynamic shared memory of a block over
  ``contracts.SMEM_LIMIT``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis import contracts
from repro_torch.analysis.report import Finding, Report
from repro_torch.models.common import resolve_device


class PlanMismatch(RuntimeError):
    """The planned launches of a workload are not the ones it ran."""


@dataclasses.dataclass
class Launch:
    """One planned launch of a kernel wrapper."""
    kernel: str                      # wrapper name
    module: str                      # wrapper's module
    workload: str                    # which sweep entry plans it
    entry: str                       # the C entry point it calls
    body: str                        # the body its rule names
    grid: Tuple[int, ...]
    # name -> (tile, operand extent): KL001, and KL004 where the name
    # has a fragment
    tiles: Dict[str, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)
    fragment: Dict[str, int] = dataclasses.field(default_factory=dict)
    # what -> (covered by grid x tile, needed): KL002
    cover: Dict[str, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)
    smem: int = 0                    # dynamic shared memory a block
    # KL003: whether the tile is on its dtype's warpgroup grid (None: the
    # dtype has none), and whether the operands admit a grid tile
    on_wgmma_grid: Optional[bool] = None
    grid_tile_fits: bool = False
    args: Tuple = ()                 # the launch's non-pointer arguments

    def label(self) -> str:
        return f"{self.module}.{self.kernel} [{self.workload}]"


# ----------------------------------------------------------------------
# checks
# ----------------------------------------------------------------------

def check_launches(records: Sequence[Launch], report: Report) -> None:
    for launch in records:
        d = {"launch": launch.label(), "body": launch.body}
        for name, (tile, extent) in launch.tiles.items():
            if tile > extent:
                report.add(Finding(
                    "KL001",
                    f"{launch.label()}: tile {name}={tile} exceeds its "
                    f"operand extent {extent}",
                    detail={**d, "tile": name, "size": tile,
                            "extent": extent}))
            frag = launch.fragment.get(name)
            if frag and tile != extent and tile % frag:
                report.add(Finding(
                    "KL004",
                    f"{launch.label()}: tile {name}={tile} is neither a "
                    f"multiple of the mma.sync fragment's {frag} nor the "
                    f"full extent {extent}",
                    detail={**d, "tile": name, "size": tile,
                            "fragment": frag, "extent": extent}))
        for what, (covered, needed) in launch.cover.items():
            if covered < needed:
                report.add(Finding(
                    "KL002",
                    f"{launch.label()}: grid {launch.grid} covers "
                    f"{covered} of {needed} {what}",
                    detail={**d, "what": what, "covered": covered,
                            "needed": needed, "grid": list(launch.grid)}))
        if launch.on_wgmma_grid is False and launch.grid_tile_fits:
            report.add(Finding(
                "KL003",
                f"{launch.label()}: tile {_tile_text(launch)} is off the "
                f"warpgroup grid; the product runs {launch.body}, not "
                f"wgmma",
                detail={**d, "tiles": {k: v[0] for k, v in
                                       launch.tiles.items()}}))
        if launch.smem > contracts.SMEM_LIMIT:
            report.add(Finding(
                "KL005",
                f"{launch.label()}: {launch.smem} bytes of dynamic shared "
                f"memory a block, over the {contracts.SMEM_LIMIT}-byte "
                f"limit",
                detail={**d, "bytes": launch.smem}))


def _tile_text(launch: Launch) -> str:
    return "(" + ", ".join(f"{k}={v[0]}" for k, v in launch.tiles.items()) \
        + ")"


# ----------------------------------------------------------------------
# plans, from the wrappers' own rules
# ----------------------------------------------------------------------

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _product_cover(M: int, N: int, bm: int, bn: int) -> tuple:
    grid = (_cdiv(M, bm), _cdiv(N, bn))
    return grid, {"rows": (grid[0] * bm, M), "columns": (grid[1] * bn, N)}


def plan_matmul(workload: str, dtype: torch.dtype, M: int, N: int, K: int,
                bm: int = 0, bn: int = 0, bk: int = 0,
                fp8: bool = False) -> Launch:
    """`ops.matmul` / `ops.fp8_matmul` of contiguous, freshly allocated
    operands (16-byte aligned; B row-major, so an 8-bit B on the wgmma
    body is made K-major in the call)."""
    from repro_torch.kernels import fp8_matmul as f8k
    from repro_torch.kernels import matmul as mmk
    from repro_torch.kernels import ops
    bm, bn, bk = ops.product_tiles(M, N, K, dtype, bm, bn, bk)
    body = mmk.body(dtype, M, N, K, bm, bn, bk, "row", True)
    kmajor = int(body == "wgmma" and dtype.itemsize == 1)
    grid, cover = _product_cover(M, N, bm, bn)
    has_grid = mmk.on_wgmma_grid(dtype, mmk.WG_BM[0], mmk.WG_BN[0],
                                 mmk.BOX_BYTES // dtype.itemsize)
    code = f8k.FORMATS[dtype] if fp8 else mmk._DTYPES[dtype]
    return Launch(
        kernel="fp8_matmul" if fp8 else "matmul",
        module=(f8k if fp8 else mmk).__name__, workload=workload,
        entry="fp8_matmul_fwd" if fp8 else "matmul_fwd", body=body,
        grid=grid, tiles={"bm": (bm, M), "bn": (bn, N), "bk": (bk, K)},
        fragment=ops._fragment(dtype), cover=cover,
        smem=mmk.smem_bytes(dtype, bm, bn, bk, body),
        on_wgmma_grid=(mmk.on_wgmma_grid(dtype, bm, bn, bk) if has_grid
                       else None),
        grid_tile_fits=(M >= min(mmk.WG_BM) and N >= min(mmk.WG_BN)
                        and K >= mmk.BOX_BYTES // dtype.itemsize),
        args=(code, M, N, K, bm, bn, bk, kmajor))


def plan_pipelined(workload: str, M: int, N: int, K: int, bm: int = 0,
                   bn: int = 0, bk: int = 0, stages: int = 2) -> Launch:
    """`ops.pipelined_matmul` (float32)."""
    from repro_torch.kernels import async_pipeline as apk
    from repro_torch.kernels import ops
    bm, bn, bk = ops.pipelined_tiles(M, N, K, bm, bn, bk, stages)
    body = apk.body(M, N, K, bm, bn, bk, True)
    grid, cover = _product_cover(M, N, bm, bn)
    return Launch(
        kernel="pipelined_matmul", module=apk.__name__, workload=workload,
        entry="pipelined_matmul_fwd", body=body, grid=grid,
        tiles={"bm": (bm, M), "bn": (bn, N), "bk": (bk, K)},
        fragment=ops._fragment(torch.float32), cover=cover,
        smem=apk.smem_bytes(bm, bn, bk, stages, body),
        args=(M, N, K, bm, bn, bk, stages))


def plan_flash(workload: str, dtype: torch.dtype, B: int, Sq: int, Sk: int,
               H: int, KH: int, hd: int, causal: bool = True) -> Launch:
    """`ops.flash_attention` (B9's forward with its lse): the caller's
    tiles (auto min(128, S)) keep the reference's contract (KL001,
    KL004).  The source picks its own query tiles, grid and shared
    memory from the launch's arguments, which the launch match holds;
    its ``static_assert`` keeps the shared memory under the limit, so
    the plan carries no cover or shared memory of its own."""
    from repro_torch.kernels import flash_attention as fk
    bq, bk = min(128, Sq), min(128, Sk)
    return Launch(
        kernel="flash_attention_fwd", module=fk.__name__, workload=workload,
        entry="flash_attention_fwd", body=fk.body(dtype, hd), grid=(),
        tiles={"bq": (bq, Sq), "bk": (bk, Sk)},
        fragment={"bq": 16, "bk": 16},
        # n_pad_keys: the plain version's 512-key chunks padded
        args=(fk._DTYPES[dtype], hd, B, Sq, Sk, H, KH, int(causal), 0, 0,
              _cdiv(Sk, min(512, Sk)) * min(512, Sk), float(hd ** -0.5)))


def plan_tropical(workload: str, M: int, N: int, K: int, bm: int = 0,
                  bn: int = 0, bk: int = 0) -> Launch:
    """`ops.tropical_matmul` (int32 (max,+))."""
    from repro_torch.kernels import async_pipeline as apk
    from repro_torch.kernels import dpx_kernel as dk
    from repro_torch.kernels import ops
    bm, bn, bk = ops._fit_tiles(M, N, K, bm or 32, bn or 32, bk or 32)
    body = dk.body(M, N, K, True)
    if body == "tma":       # fma_pipe's ring of 128 x 128 tiles
        t = dk.TMA_TILE
        smem = apk.smem_bytes(t, t, dk.TMA_BK, 4, "tma")
        grid, cover = _product_cover(M, N, t, t)
    else:
        smem = dk.tropical_smem_bytes(bm, bn, bk)
        grid, cover = _product_cover(M, N, bm, bn)
    return Launch(
        kernel="tropical_matmul", module=dk.__name__, workload=workload,
        entry="tropical_matmul_fwd", body=body, grid=grid,
        tiles={"bm": (bm, M), "bn": (bn, N), "bk": (bk, K)}, cover=cover,
        smem=smem,
        args=(M, N, K, bm, bn, bk, dk.TROPICAL_BODIES.index(body)))


def plan_smith_waterman(workload: str, B: int, La: int, Lb: int,
                        match: int = 2, mismatch: int = -1,
                        gap: int = -1) -> Launch:
    """`ops.smith_waterman`: a [B, La] x [B, Lb] batch."""
    from repro_torch.kernels import dpx_kernel as dk
    p = dk.smith_waterman_plan(La, Lb)
    grid = (_cdiv(B, p.pairs),)
    return Launch(
        kernel="smith_waterman", module=dk.__name__, workload=workload,
        entry="smith_waterman_fwd", body=p.body, grid=grid,
        cover={"pairs": (grid[0] * p.pairs, B),
               "columns": (p.bands * 32 * p.S, p.cols)},
        smem=p.smem_bytes,
        args=(B, p.rows, p.cols, p.S, p.warps, p.pairs, match, mismatch,
              gap))


def plan_paged(workload: str, kind: str, dtype: torch.dtype, B: int, C: int,
               H: int, KH: int, hd: int, bs: int, MB: int) -> Launch:
    """`paged_attention.paged_decode` / `paged_chunk` (``kind``; e4m3
    pools take the same plan, by q's dtype), q [B, C, H, hd] over pools
    of `bs`-row blocks through an [B, MB] table."""
    from repro_torch.kernels import paged_attention as pk
    G, T = H // KH, MB * bs
    p = pk.plan(dtype, hd, B, KH, G, C, T)
    decode = kind.startswith("paged_decode")
    dims = ((B, H, KH, bs, MB) if decode else (B, C, H, KH, bs, MB))
    return Launch(
        kernel=kind, module=pk.__name__, workload=workload,
        entry=f"{kind}_fwd", body=p.body,
        grid=(B * KH * p.groups * p.splits,),
        tiles={"split positions": (p.split_len, -(-T // 16) * 16)},
        cover={"context positions": (p.splits * p.split_len, T),
               "query rows of a kv head": (p.groups * p.rows, C * G)},
        smem=p.smem,
        args=(pk._DTYPES[dtype], hd) + dims
        + (p.splits, p.rows, int(p.recompute), float(hd ** -0.5)))


# ----------------------------------------------------------------------
# the reference's workload sweep
# ----------------------------------------------------------------------

@dataclasses.dataclass
class Workload:
    name: str
    plan: Callable[[], List[Launch]]
    run: Callable[[torch.device], Any]     # the real call, on a device


def _randn(g, shape, dtype, device):
    return torch.randn(shape, generator=g, device=device).to(dtype)


def default_workloads() -> List[Workload]:
    """The reference's 13 workloads (`kernel_lint.default_workloads`: the
    same names and shapes), each planned and run through the port's
    wrappers."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pk
    bf16, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    e4m3 = torch.float8_e4m3fn
    B, KH, G, hd, bs, NB, MB, C = 2, 2, 2, 64, 16, 8, 4, 16
    H = KH * G

    def gen(device):
        return torch.Generator(device=device).manual_seed(0)

    def product(M, N, K, dtype, fp8=False, **tiles):
        def run(device):
            g = gen(device)
            a = _randn(g, (M, K), f32, device).to(dtype)
            b = _randn(g, (K, N), f32, device).to(dtype)
            if fp8:
                one = torch.ones((), device=device)
                return ops.fp8_matmul(a, b, one, one, **tiles)
            return ops.matmul(a, b, **tiles)
        return run

    def flash(S):
        def run(device):
            g = gen(device)
            q, k, v = (_randn(g, (2, S, 4, 64), bf16, device)
                       for _ in range(3))
            return ops.flash_attention(q, k, v, causal=True)
        return run

    def tropical(device):
        g = gen(device)
        a, b = (torch.randint(-100, 100, (128, 128), generator=g,
                              device=device, dtype=i32) for _ in range(2))
        return ops.tropical_matmul(a, b, bm=128, bn=128, bk=128)

    def smith_waterman(device):
        g = gen(device)
        a, b = (torch.randint(0, 4, (2, 64), generator=g, device=device,
                              dtype=i32) for _ in range(2))
        return ops.smith_waterman(a, b)

    def pipelined(device):
        g = gen(device)
        a, b = (_randn(g, (128, 128), f32, device) for _ in range(2))
        return ops.pipelined_matmul(a, b, bm=128, bn=128, bk=128)

    def paged(kind, rows, fp8):
        def run(device):
            g = gen(device)
            q = _randn(g, (B, rows, H, hd), bf16, device)
            pool = e4m3 if fp8 else bf16
            k, v = (_randn(g, (NB, bs, KH, hd), f32, device).to(pool)
                    for _ in range(2))
            table = torch.randperm(NB, generator=g, device=device)[
                :B * MB].reshape(B, MB).to(i32)
            lens = torch.tensor([MB * bs - 5, rows], dtype=i32,
                                device=device)
            kw = {}
            if fp8:
                kw = {"k_scale": torch.rand((NB, bs, KH, 1), generator=g,
                                            device=device),
                      "v_scale": torch.rand((NB, bs, KH, 1), generator=g,
                                            device=device)}
            fn = getattr(pk, kind)
            return fn(q, k, v, table, lens if rows == 1 else lens - rows,
                      **kw)
        return run

    def paged_plan(name, kind, rows):
        return lambda: [plan_paged(name, kind, bf16, B, rows, H, KH, hd, bs,
                                   MB)]

    return [
        Workload("matmul_train_auto",
                 lambda: [plan_matmul("matmul_train_auto", bf16, 256, 256,
                                      256)],
                 product(256, 256, 256, bf16)),
        Workload("matmul_explicit_128",
                 lambda: [plan_matmul("matmul_explicit_128", f32, 128, 128,
                                      128, 128, 128, 128)],
                 product(128, 128, 128, f32, bm=128, bn=128, bk=128)),
        Workload("matmul_decode_rows",
                 lambda: [plan_matmul("matmul_decode_rows", bf16, 8, 128,
                                      256)],
                 product(8, 128, 256, bf16)),
        Workload("fp8_matmul_256",
                 lambda: [plan_matmul("fp8_matmul_256", e4m3, 256, 256, 256,
                                      fp8=True)],
                 product(256, 256, 256, e4m3, fp8=True)),
        Workload("flash_attention_train",
                 lambda: [plan_flash("flash_attention_train", bf16, 2, 256,
                                     256, 4, 4, 64)],
                 flash(256)),
        Workload("flash_attention_short",
                 lambda: [plan_flash("flash_attention_short", bf16, 2, 8, 8,
                                     4, 4, 64)],
                 flash(8)),
        Workload("tropical_matmul_128",
                 lambda: [plan_tropical("tropical_matmul_128", 128, 128, 128,
                                        128, 128, 128)],
                 tropical),
        Workload("smith_waterman",
                 lambda: [plan_smith_waterman("smith_waterman", 2, 64, 64)],
                 smith_waterman),
        Workload("pipelined_matmul_128",
                 lambda: [plan_pipelined("pipelined_matmul_128", 128, 128,
                                         128, 128, 128, 128)],
                 pipelined),
        Workload("paged_decode", paged_plan("paged_decode", "paged_decode", 1),
                 paged("paged_decode", 1, False)),
        Workload("paged_decode_fp8",
                 paged_plan("paged_decode_fp8", "paged_decode_fp8", 1),
                 paged("paged_decode_fp8", 1, True)),
        Workload("paged_chunk", paged_plan("paged_chunk", "paged_chunk", C),
                 paged("paged_chunk", C, False)),
        Workload("paged_chunk_fp8",
                 paged_plan("paged_chunk_fp8", "paged_chunk_fp8", C),
                 paged("paged_chunk_fp8", C, True)),
    ]


# ----------------------------------------------------------------------
# the card: real launches against the plans
# ----------------------------------------------------------------------

@contextlib.contextmanager
def spy_launches(records: List[Tuple[str, Tuple]]):
    """Swap ``build.launch`` for a spy that records each launch's entry
    point and its non-pointer arguments, then launches."""
    from repro_torch.kernels import build
    real = build.launch

    def spy(source, entry, device, *args):
        types = build.SIGNATURES[source][entry]
        records.append((entry, tuple(a for a, t in zip(args, types)
                                     if t is not build._P)))
        return real(source, entry, device, *args)

    build.launch = spy
    try:
        yield records
    finally:
        build.launch = real


def match_launches(planned: Sequence[Launch],
                   ran: Sequence[Tuple[str, Tuple]]) -> int:
    """Planned launches matched one for one by real ones; raises
    PlanMismatch on a planned launch with no real one or a real one
    with no plan."""
    left = collections.Counter(ran)
    missing = []
    for p in planned:
        key = (p.entry, tuple(p.args))
        if left[key] > 0:
            left[key] -= 1
        else:
            missing.append(key)
    extra = [k for k, n in left.items() for _ in range(n)]
    if missing or extra:
        raise PlanMismatch(f"planned launches {missing} did not run; "
                           f"launches {extra} were not planned")
    return len(planned)


def run(report: Report, workloads: Optional[List[Workload]] = None,
        device=None) -> None:
    """Plan every workload and check the plans; on a CUDA `device` (the
    default; without one, and without `device="cpu"`, it raises) also
    run each one and match its launches to its plan."""
    workloads = default_workloads() if workloads is None else workloads
    device = resolve_device(device)
    records: List[Launch] = []
    matched = 0
    for w in workloads:
        planned = w.plan()
        records.extend(planned)
        if device.type == "cuda":
            ran: List[Tuple[str, Tuple]] = []
            with spy_launches(ran):
                w.run(device)
            torch.cuda.synchronize(device)
            try:
                matched += match_launches(planned, ran)
            except PlanMismatch as e:
                raise PlanMismatch(f"{w.name}: {e}") from None
    report.extras.setdefault("kernel_launches", []).extend(
        launch.label() for launch in records)
    report.extras["kernel_launches_matched"] = (
        matched if device.type == "cuda" else None)
    check_launches(records, report)
