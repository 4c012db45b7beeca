"""Paged decode/chunk attention: the block-table walk inside a CUDA kernel.

PyTorch wrappers of ``csrc/paged_attention.cu``, which replaces the
Pallas kernels ``paged_decode`` and ``paged_chunk`` of
``repro/kernels/paged_attention.py``: their bf16/float32-pool bodies
(``paged_decode`` / ``paged_chunk`` here) and their e4m3-pool bodies
(``paged_decode_fp8`` / ``paged_chunk_fp8``, which take the float32
scales [NB,bs,KH,1] and dequantize in-tile to q's dtype).  The public
layout is the reference's.

All four run one kernel, one launch a call: a split over the context.
A thread-block cluster of ``splits`` blocks serves a (slot, kv head,
row group); each block streams the K and then the V rows of its share
of the positions through two shared-memory tiles (the next tiles wait
in registers), keeps their scores in shared memory, and the cluster
combines maxima, row sums and partial outputs over distributed shared
memory in rank order, so p is rounded to q's dtype after normalisation,
as the reference rounds it.  Body ``mma_sync`` (bf16 q: mma.sync
m16n8k16, float32 accumulators) or ``fma`` (float32 q: fmaf, never
TF32), by q's dtype (``body``).  The plan (``plan``, the only copy of
the rule: the source lays out and checks the plan it is given) picks
rows per cluster and splits from the shapes alone, never from the
lengths, so one plan serves every step of a server and a CUDA graph can
capture a call; ``splits=`` and ``rows=`` (for a chunk) force a
choice, for tests.  A table longer than the
largest cluster's shared memory holds the scores of
(``held_scores_context``, ~80k positions at bf16 head_dim 128) takes a
plan that recomputes the scores from K in a second pass (K read twice,
V once: 1.5x the bytes); there is no cap on the context.

For CUDA tensors a wrapper checks its operands, allocates the output,
launches the kernel on the current stream, raises if the launch failed
(a cluster the card cannot schedule included), and adds one to its
``launches`` count and to its body's (``body_launches``).  The kernel
also counts the launches it runs on the card (``device_launches``).  For CPU
tensors it computes the kernel's plain version (``*_plain``: the
gathered view, dequantized for fp8 pools, plus the multiply-and-sum
attention of models/attention.py); it never falls back from CUDA to
the plain version.

Tolerance against the plain version.  The kernel computes the same
function as the plain version but sums scores, softmax denominators
and PV in another order (tensor-core or fmaf sums, split partial sums
added in rank order), so the two agree to float32 rounding, not
bitwise: outputs within 2e-5 on float32 q and within one bf16 rounding
step (2e-2 at |o| <~ 4) on bf16 q, where a p or an output that sits on
a rounding boundary may round the other way.  On fp8 pools the
dequantized K/V values are bitwise those of the plain version (the same
float32 multiply and rounding), so the same limits hold.  Repeated
calls are bitwise equal (fixed order, no atomics).  The reference's own
claim of bitwise kernel/gather parity does not carry over, and does not
hold even there: its float32 G=1 decode case differs bitwise from its
gather oracle (ROADMAP, queue C).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.models import attention
from repro_torch.te.fp8 import E4M3

SOURCE = "paged_attention.cu"
HEAD_DIMS = (16, 32, 64, 80, 128)
BODIES = ("mma_sync", "fma")   # the source's body codes
SMEM_LIMIT = 232448            # bytes of shared memory one block may use
TILE = 128                     # positions of a staged tile (kTile)
MAX_ROWS = 128                 # query rows a cluster serves (kMaxRows)
SPLITS = (1, 2, 4, 8, 16)      # cluster sizes; 16 is non-portable
BLOCK_COST = 128               # a block's fixed cost in positions
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class Plan(NamedTuple):
    """One launch's shape: body, blocks a cluster (splits), query rows a
    cluster, shared memory a block (bytes), positions a split, row
    groups of a (slot, kv head), and whether the split's scores are
    recomputed from K (True) or held in shared memory."""
    body: str
    splits: int
    rows: int
    smem: int
    split_len: int
    groups: int
    recompute: bool = False


def body(dtype: torch.dtype) -> str:
    """"mma_sync" for bf16 q, "fma" for float32 q."""
    return "fma" if dtype == torch.float32 else "mma_sync"


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def smem_bytes(dtype: torch.dtype, hd: int, rows: int, split_len: int,
               splits: int, recompute: bool = False) -> int:
    """Shared memory of one block (the source's `Layout`, which refuses
    a plan past SMEM_LIMIT): q rows, the float32 scores (the split's, or
    one tile's when the plan recomputes them), the work region (two
    tiles of q's dtype, later the float32 partial output), four
    float32/int32 values a row and the peers' maxima or sums gathered,
    `splits` a row.  Rows carry 16 bytes of padding."""
    tsz = 4 if dtype == torch.float32 else 2
    q = rows * (hd * tsz + 16)
    scores = rows * ((TILE if recompute else split_len) + 8) * 4
    tiles = 2 * TILE * (hd * tsz + 16)
    return q + scores + max(tiles, rows * hd * 4) + (4 + splits) * rows * 4


def held_scores_context(dtype: torch.dtype, hd: int) -> int:
    """The longest table (max_blocks * block_size) whose scores a plan
    holds in shared memory (8 rows a cluster over 16 splits); longer
    tables take the plan that recomputes them."""
    fixed = smem_bytes(dtype, hd, 8, 0, SPLITS[-1])
    split_len = ((SMEM_LIMIT - fixed) // 32) // 16 * 16
    return 16 * split_len


def wave_clusters(S: int) -> int:
    """Clusters of S blocks the H100 SXM runs at once at one block an SM
    (`paged_attention_max_clusters`, cudaOccupancyMaxActiveClusters, on
    the card): clusters of 4 and 8 reach only 120 of the 132 SMs,
    clusters of 16 only 112."""
    return {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}[S]


@functools.lru_cache(maxsize=None)
def plan(dtype: torch.dtype, hd: int, B: int, KH: int, G: int, C: int,
         T: int, splits: int = 0, rows: int = 0,
         recompute: bool = False) -> Plan:
    """The plan rule for q of `dtype`, head_dim `hd`, B slots, KH kv
    heads, G query heads a kv head, C query rows a slot and T =
    max_blocks * block_size (e4m3 pools take the same plan: they are
    dequantized into tiles of q's dtype).  Of the rows a cluster R
    (min(round_up(C*G, 8), 128), halved down to 8) and splits S (1, 2,
    4, 8, 16, at most the largest power of two <= ceil(T / TILE)) whose
    block fits SMEM_LIMIT holding its split's scores, the pair of least
    cost

        waves * (BLOCK_COST + L * (1 + R / 16)),

    waves = ceil(B*KH*groups / wave_clusters(S)), L the positions of a
    split; ties to the larger R (fewer reads of K/V), then the smaller
    S.  BLOCK_COST stands for a block's fixed chain of loads and cluster
    barriers (~10 us against ~80 ns a position), and each position
    weighs more with its rows' scores.  Where no such block fits (T
    past `held_scores_context`), the same search over plans that
    recompute the scores (one tile of them a block), each position
    weighing 1.5x for its second read of K.  The wrapper passes the
    plan's splits, rows and recompute to the launch.

    `splits` / `rows` (non-zero) / `recompute` force a choice (the
    wrappers force splits and rows for tests; nothing but a test forces
    `recompute`, by patching this function).  Raises
    ValueError when nothing fits (forced rows or splits whose block
    passes SMEM_LIMIT)."""
    if rows and (rows % 8 or not 0 < rows <= MAX_ROWS):
        raise ValueError(f"rows {rows} is not a multiple of 8 in "
                         f"[8, {MAX_ROWS}]")
    if splits and splits not in SPLITS:
        raise ValueError(f"splits {splits} not in {SPLITS}")
    total_rows = C * G
    tiles = -(-T // TILE)
    smax = 1
    while smax * 2 <= SPLITS[-1] and smax * 2 <= tiles:
        smax *= 2

    def search(recomp: bool):
        best, R = None, rows or min(_round_up(total_rows, 8), MAX_ROWS)
        while True:
            groups = -(-total_rows // R)
            for S in SPLITS:
                if S != splits if splits else S > smax:
                    continue
                L = _round_up(-(-T // S), 16)
                smem = smem_bytes(dtype, hd, R, L, S, recomp)
                if smem > SMEM_LIMIT:
                    continue
                waves = -(-(B * KH * groups) // wave_clusters(S))
                weight = L * (16 + R) // 16
                if recomp:
                    weight = weight * 3 // 2
                cost = waves * (BLOCK_COST + weight)
                if best is None or cost < best[0]:
                    best = (cost, Plan(body(dtype), S, R, smem, L, groups,
                                       recomp))
            if R == 8 or rows:
                return best
            R = max(8, _round_up(R // 2, 8))

    best = None if recompute else search(False)
    if best is None:
        best = search(True)
    if best is None:
        raise ValueError(
            f"no plan fits max_blocks*block_size={T} (G={G}, C={C}, "
            f"head_dim {hd}, {dtype}"
            f"{', splits=%d' % splits if splits else ''}"
            f"{', rows=%d' % rows if rows else ''}): a block of "
            f"{'%d rows' % rows if rows else 'the forced plan'} does not "
            f"fit {SMEM_LIMIT} bytes of shared memory")
    return best[1]


def _per_slot(x, B: int, device) -> torch.Tensor:
    """A scalar or [B] length operand as a contiguous int32 [B] tensor
    on `device`."""
    x = torch.as_tensor(x, device=device)
    return x.to(torch.int32).expand(B).contiguous()


def _check(q, ck, cv, block_table, k_scale=None, v_scale=None, *,
           splits: int = 0, rows: int = 0):
    """Operands the kernel takes: q float32 or bf16; pools of q's dtype,
    or e4m3 pools with float32 scales [NB,bs,KH,1] (both scales or
    neither); an int32 table; one device; contiguous; pools on 16-byte
    boundaries (rows move 16 bytes at a time); a plan that fits
    (`plan`, which raises only on forced splits or rows)."""
    B, C, H, hd = q.shape
    NB, bs, KH, hd_k = ck.shape
    if cv.shape != ck.shape or hd_k != hd or H % KH:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(ck.shape)},"
                         f" v {tuple(cv.shape)} do not match")
    if block_table.ndim != 2 or block_table.shape[0] != B:
        raise ValueError(f"block_table {tuple(block_table.shape)} is not "
                         f"[{B}, max_blocks]")
    scales = [s for s in (k_scale, v_scale) if s is not None]
    pool = E4M3 if scales else q.dtype
    if q.dtype not in _DTYPES or ck.dtype != pool or cv.dtype != pool:
        raise TypeError(f"dtypes q {q.dtype}, k {ck.dtype}, v {cv.dtype}: "
                        "the kernel takes float32 or bfloat16 q with pools "
                        "of q's dtype, or e4m3 pools with scales")
    if scales:
        want = (NB, bs, KH, 1)
        for s in (k_scale, v_scale):
            if s is None or s.dtype != torch.float32 or \
                    tuple(s.shape) != want:
                raise TypeError(f"fp8 pools take float32 k_scale and "
                                f"v_scale of shape {want}")
    if block_table.dtype != torch.int32:
        raise TypeError(f"block_table dtype {block_table.dtype} is not int32")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", ck), ("v", cv),
                    ("block_table", block_table), ("k_scale", k_scale),
                    ("v_scale", v_scale)):
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    for name, t in (("k", ck), ("v", cv)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} does not start on a 16-byte boundary")
    MB = block_table.shape[1]
    plan(q.dtype, hd, B, KH, H // KH, C, MB * bs, splits, rows)
    return B, C, H, hd, bs, KH, MB


def _run(fn, entry: str, q, ck, cv, block_table, lens, scales=(), *,
         decode: bool, splits: int, rows: int) -> torch.Tensor:
    """Check, plan and launch `entry` of `fn` on the device operands
    (pools, scales, table, lengths, in the C signature's order); count
    the launch in all and by body."""
    from repro_torch.kernels import build
    B, C, H, hd, bs, KH, MB = _check(q, ck, cv, block_table, *scales,
                                     splits=splits, rows=rows)
    if decode and C != 1:
        raise ValueError(f"decode takes one query row per slot, got {C}")
    p = plan(q.dtype, hd, B, KH, H // KH, C, MB * bs, splits, rows)
    lens = _per_slot(lens, B, q.device)
    if q.data_ptr() % 16:            # q rows move 16 bytes at a time
        q = q.clone()
    dims = ((B, H, KH, bs, MB, p.splits, p.rows, int(p.recompute))
            if decode else
            (B, C, H, KH, bs, MB, p.splits, p.rows, int(p.recompute)))
    out = torch.empty_like(q)
    build.launch(SOURCE, entry, q.device, _DTYPES[q.dtype], hd,
                 q.data_ptr(),
                 *(t.data_ptr() for t in (ck, cv, *scales, block_table,
                                           lens)),
                 out.data_ptr(), *dims, float(hd ** -0.5))
    fn.launches += 1
    fn.body_launches[p.body] += 1
    return out


def _chunk_positions(q, pos) -> torch.Tensor:
    """q_positions [B, C] of a chunk whose slots start at `pos`."""
    pos = _per_slot(pos, q.shape[0], q.device)
    return pos[:, None] + torch.arange(q.shape[1], device=q.device,
                                       dtype=torch.int32)[None, :]


def paged_decode_plain(q, ck, cv, block_table, kv_len) -> torch.Tensor:
    kg, vg = attention.gather_paged_cache(ck, cv, block_table)
    return attention.decode_attention(q, kg, vg, kv_len)


def paged_chunk_plain(q, ck, cv, block_table, pos) -> torch.Tensor:
    kg, vg = attention.gather_paged_cache(ck, cv, block_table)
    return attention.chunk_attention(q, kg, vg, _chunk_positions(q, pos))


def _gather_fp8(q, ck, cv, k_scale, v_scale, block_table):
    return attention.gather_paged_cache_fp8(
        {"k": ck, "v": cv, "k_scale": k_scale, "v_scale": v_scale},
        block_table, out_dtype=q.dtype)


def paged_decode_fp8_plain(q, ck, cv, block_table, kv_len, *, k_scale,
                           v_scale) -> torch.Tensor:
    kg, vg = _gather_fp8(q, ck, cv, k_scale, v_scale, block_table)
    return attention.decode_attention(q, kg, vg, kv_len)


def paged_chunk_fp8_plain(q, ck, cv, block_table, pos, *, k_scale,
                          v_scale) -> torch.Tensor:
    kg, vg = _gather_fp8(q, ck, cv, k_scale, v_scale, block_table)
    return attention.chunk_attention(q, kg, vg, _chunk_positions(q, pos))


def paged_decode(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                 block_table: torch.Tensor, kv_len, *,
                 splits: int = 0) -> torch.Tensor:
    """One-step paged decode.  q [B,1,H,hd]; pools [NB,bs,KH,hd];
    block_table [B,MB] int32 (-1 = unallocated); kv_len scalar or [B].
    Returns [B,1,H,hd] in q.dtype.  `splits` (tests) forces the plan's
    cluster size."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, ck, cv, block_table, kv_len)
    return _run(paged_decode, "paged_decode_fwd", q, ck, cv, block_table,
                kv_len, decode=True, splits=splits, rows=0)


def paged_chunk(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                block_table: torch.Tensor, pos, *, splits: int = 0,
                rows: int = 0) -> torch.Tensor:
    """Paged chunk attention.  q [B,C,H,hd]; `pos` [B] is each slot's
    cache length BEFORE the chunk (row i sits at position pos+i and the
    chunk's k/v must already be scattered).  Rows past a slot's valid
    token count produce garbage rows the caller discards.  `splits` /
    `rows` (tests) force the plan's cluster size / query rows a
    cluster."""
    if q.device.type == "cpu":
        return paged_chunk_plain(q, ck, cv, block_table, pos)
    return _run(paged_chunk, "paged_chunk_fwd", q, ck, cv, block_table, pos,
                decode=False, splits=splits, rows=rows)


def paged_decode_fp8(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     block_table: torch.Tensor, kv_len, *,
                     k_scale: torch.Tensor, v_scale: torch.Tensor,
                     splits: int = 0) -> torch.Tensor:
    """`paged_decode` over e4m3 pools: each K/V element is
    ``(float(code) * scale)`` rounded to q.dtype, with scale
    ``k_scale``/``v_scale`` [NB,bs,KH,1] float32 of its (token, kv
    head) row; p is rounded to q.dtype before PV.  Limits against
    `paged_decode_fp8_plain`: 2e-5 on float32 q, 2e-2 on bf16 q."""
    if q.device.type == "cpu":
        return paged_decode_fp8_plain(q, ck, cv, block_table, kv_len,
                                      k_scale=k_scale, v_scale=v_scale)
    return _run(paged_decode_fp8, "paged_decode_fp8_fwd", q, ck, cv,
                block_table, kv_len, (k_scale, v_scale), decode=True,
                splits=splits, rows=0)


def paged_chunk_fp8(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                    block_table: torch.Tensor, pos, *,
                    k_scale: torch.Tensor, v_scale: torch.Tensor,
                    splits: int = 0, rows: int = 0) -> torch.Tensor:
    """`paged_chunk` over e4m3 pools, dequantized as in
    `paged_decode_fp8`.  Limits against `paged_chunk_fp8_plain`: 2e-5
    on float32 q, 2e-2 on bf16 q."""
    if q.device.type == "cpu":
        return paged_chunk_fp8_plain(q, ck, cv, block_table, pos,
                                     k_scale=k_scale, v_scale=v_scale)
    return _run(paged_chunk_fp8, "paged_chunk_fp8_fwd", q, ck, cv,
                block_table, pos, (k_scale, v_scale), decode=False,
                splits=splits, rows=rows)


KERNELS = (paged_decode, paged_chunk, paged_decode_fp8, paged_chunk_fp8)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
        fn.body_launches = dict.fromkeys(BODIES, 0)


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def launches_by_body() -> dict:
    """{kernel name: {body: launches}} since the last reset."""
    return {fn.__name__: dict(fn.body_launches) for fn in KERNELS}


def device_launches(device) -> int:
    """Launches of the kernel that `device` (a CUDA device) has run,
    all four wrappers together, since the library was loaded, as the
    kernel counts them itself (the grid's first thread adds one to a
    device counter).  Graph replays are in it as they run; the wrappers'
    `launches` add a replay's captured launches on the host
    (`runtime/graphs.py`).  Synchronizes the device."""
    from repro_torch.kernels import build
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"device_launches reads a CUDA device, not "
                         f"{device}")
    n = ctypes.c_ulonglong(0)
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        err = build.load(SOURCE).paged_attention_device_launches(
            ctypes.byref(n))
    if err != 0:
        raise build.LaunchError("paged_attention_device_launches", err)
    return n.value


reset_launch_counts()
