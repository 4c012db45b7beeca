"""The port's DPX layer (core/dpx.py, kernels/dpx_kernel.py, kernels/ops.py)
on the CPU against the reference's, exactly.

Inputs are made once with numpy and handed to both packages.  The
reference's kernels run as tests/test_kernels.py runs them
(``repro.kernels.ops``, Pallas in interpret mode on the CPU); the port's
wrappers compute their plain versions on CPU tensors.  All results are
integers and must be equal.
"""

import warnings

import benchmarks.dpx as ref_bench_dpx
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dpx as ref_dpx
from repro.core.timer import Timing as RefTiming
from repro.kernels import ops as ref_ops
from repro_torch.benchmarks import dpx as bench_dpx
from repro_torch.core import dpx
from repro_torch.kernels import dpx_kernel as dk
from repro_torch.kernels import ops


def _ints(rng, shape, dtype, lo=None, hi=None):
    """Integers over [lo, hi) (the whole dtype by default, its limits
    among them, so sums wrap)."""
    info = np.iinfo(dtype)
    lo = info.min if lo is None else lo
    hi = info.max + 1 if hi is None else hi
    x = rng.integers(lo, hi, shape).reshape(-1)
    if lo == info.min:
        edge = [info.min, info.max, info.min + 1, info.max - 1, 0, -1, 1]
        x[:len(edge)] = edge[:x.size]
    return x.reshape(shape).astype(dtype)


def _equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def _ref(fn, *args, **kwargs):
    """A reference call with its TPU tile-alignment warnings silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


@pytest.mark.parametrize("family", ["FUSED", "EMULATED"])
@pytest.mark.parametrize("name", sorted(ref_dpx.FUSED))
@pytest.mark.parametrize("dtype", [np.int32, np.int16])
def test_dpx_functions_match_reference(family, name, dtype):
    rng = np.random.default_rng(23)
    a, b, c = (_ints(rng, 257, dtype) for _ in range(3))
    want = getattr(ref_dpx, family)[name](*map(jnp.asarray, (a, b, c)))
    got = getattr(dpx, family)[name](*map(torch.from_numpy, (a, b, c)))
    _equal(got, want)


@pytest.mark.parametrize("name", dk.FUNCTIONS)
def test_dpx_fused_plain_is_the_reference_expression(name):
    rng = np.random.default_rng(5)
    a, b, c = (_ints(rng, (4, 33), np.int32) for _ in range(3))
    got = dk.dpx_fused_plain(name, *map(torch.from_numpy, (a, b, c)))
    _equal(got, ref_dpx.FUSED[name](*map(jnp.asarray, (a, b, c))))


@pytest.mark.parametrize("fn", ["vibmax", "vibmin"])
@pytest.mark.parametrize("dtype", [np.int32, np.int16])
def test_vibmax_vibmin_match_reference(fn, dtype):
    rng = np.random.default_rng(29)
    a = _ints(rng, 129, dtype, -5, 5)
    b = _ints(rng, 129, dtype, -5, 5)
    val, pred = getattr(dpx, fn)(torch.from_numpy(a), torch.from_numpy(b))
    rval, rpred = getattr(ref_dpx, fn)(jnp.asarray(a), jnp.asarray(b))
    _equal(val, rval)
    _equal(pred, rpred)


def test_vimin3_matches_reference():
    rng = np.random.default_rng(31)
    a, b, c = (_ints(rng, 65, np.int32) for _ in range(3))
    _equal(dpx.vimin3(*map(torch.from_numpy, (a, b, c))),
           ref_dpx.vimin3(*map(jnp.asarray, (a, b, c))))


@pytest.mark.parametrize("semiring", ["max_plus", "min_plus"])
@pytest.mark.parametrize("shape", [(8, 8, 8), (17, 5, 23)])
def test_core_tropical_matmul_matches_reference(semiring, shape):
    M, N, K = shape
    rng = np.random.default_rng(M * N)
    A = _ints(rng, (M, K), np.int32, -40, 40)
    B = _ints(rng, (K, N), np.int32, -40, 40)
    want = ref_dpx.tropical_matmul(jnp.asarray(A), jnp.asarray(B),
                                   semiring=semiring)
    _equal(dpx.tropical_matmul(torch.from_numpy(A), torch.from_numpy(B),
                               semiring=semiring), want)


def test_core_tropical_matmul_chunks_rows(monkeypatch):
    """A chunk smaller than M gives the same product."""
    rng = np.random.default_rng(1)
    A = torch.from_numpy(_ints(rng, (9, 6), np.int32, -40, 40))
    B = torch.from_numpy(_ints(rng, (6, 7), np.int32, -40, 40))
    whole = dpx.tropical_matmul(A, B)
    monkeypatch.setattr(dk, "CHUNK_BYTES", 4 * 6 * 7 * 2)
    assert torch.equal(dpx.tropical_matmul(A, B), whole)


@pytest.mark.parametrize("la,lb", [(6, 6), (4, 3), (9, 13), (1, 5)])
@pytest.mark.parametrize("scores", [(2, -1, -1), (3, -2, -2)])
def test_core_smith_waterman_matches_reference(la, lb, scores):
    rng = np.random.default_rng(la * 100 + lb)
    a = rng.integers(0, 4, la).astype(np.int32)
    b = rng.integers(0, 4, lb).astype(np.int32)
    match, mismatch, gap = scores
    want = ref_dpx.smith_waterman(jnp.asarray(a), jnp.asarray(b),
                                  match=match, mismatch=mismatch, gap=gap)
    got = dpx.smith_waterman(torch.from_numpy(a), torch.from_numpy(b),
                             match=match, mismatch=mismatch, gap=gap)
    _equal(got, want)


@pytest.mark.parametrize("m,n,k", [(32, 32, 32), (64, 96, 64)])
@pytest.mark.parametrize("tile", [0, 16, 32])
def test_tropical_matmul_kernel_matches_pallas(m, n, k, tile):
    rng = np.random.default_rng(m + n + tile)
    a = _ints(rng, (m, k), np.int32, -50, 50)
    b = _ints(rng, (k, n), np.int32, -50, 50)
    want = _ref(ref_ops.tropical_matmul, jnp.asarray(a), jnp.asarray(b),
                bm=tile, bn=tile, bk=tile)
    got = ops.tropical_matmul(torch.from_numpy(a), torch.from_numpy(b),
                              bm=tile, bn=tile, bk=tile)
    _equal(got, want)


@pytest.mark.parametrize("values", ["wrap", "floor"])
def test_tropical_matmul_kernel_overflow_matches_pallas(values):
    """Sums past int32 wrap as JAX's do; results under the kernel's
    INT_MIN accumulator start read as INT_MIN."""
    rng = np.random.default_rng(7)
    lo, hi = ((2 ** 31 - 100, 2 ** 31 - 1) if values == "wrap"
              else (-2 ** 29 - 200, -2 ** 29 + 50))
    a = rng.integers(lo, hi, (32, 64)).astype(np.int32)
    b = rng.integers(lo, hi, (64, 32)).astype(np.int32)
    want = _ref(ref_ops.tropical_matmul, jnp.asarray(a), jnp.asarray(b))
    got = ops.tropical_matmul(torch.from_numpy(a), torch.from_numpy(b))
    _equal(got, want)
    if values == "floor":
        assert (got == dk.INT_MIN).any() and (got > dk.INT_MIN).any()
    else:
        assert (got < 0).any()                 # wrapped sums


@pytest.mark.parametrize("B,la,lb", [(2, 16, 16), (4, 24, 20), (1, 40, 8),
                                     (3, 7, 31)])
def test_smith_waterman_kernel_matches_pallas(B, la, lb):
    rng = np.random.default_rng(B * la * lb)
    sa = rng.integers(0, 4, (B, la)).astype(np.int32)
    sb = rng.integers(0, 4, (B, lb)).astype(np.int32)
    want = ref_ops.smith_waterman(jnp.asarray(sa), jnp.asarray(sb))
    got = ops.smith_waterman(torch.from_numpy(sa), torch.from_numpy(sb))
    _equal(got, want)


@pytest.mark.parametrize("scores", [(3, -2, -2), (1, -3, -1), (2, 0, 1)])
def test_smith_waterman_kernel_scores_match_pallas(scores):
    rng = np.random.default_rng(11)
    sa = rng.integers(0, 4, (3, 18)).astype(np.int32)
    sb = rng.integers(0, 4, (3, 13)).astype(np.int32)
    match, mismatch, gap = scores
    kw = dict(match=match, mismatch=mismatch, gap=gap)
    want = ref_ops.smith_waterman(jnp.asarray(sa), jnp.asarray(sb), **kw)
    got = ops.smith_waterman(torch.from_numpy(sa), torch.from_numpy(sb), **kw)
    _equal(got, want)


def test_smith_waterman_best_is_the_max_of_full_h():
    rng = np.random.default_rng(13)
    sa = torch.from_numpy(rng.integers(0, 4, (1, 21)).astype(np.int32))
    sb = torch.from_numpy(rng.integers(0, 4, (1, 17)).astype(np.int32))
    best = dk.smith_waterman(sa, sb)
    assert int(best[0]) == int(dpx.smith_waterman(sa[0], sb[0]).max())


def test_oversize_tiles_raise_value_error():
    a = torch.zeros((32, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds"):
        ops.tropical_matmul(a, a, bm=64)
    with pytest.raises(ValueError, match="exceeds"):
        ops.tropical_matmul(a, a, bk=33)
    with pytest.raises(ValueError, match="divide"):
        dk.tropical_matmul(a, a, bm=24)
    # auto tiles fit to divisors: 48 -> 16
    b = torch.zeros((48, 48), dtype=torch.int32)
    assert ops._fit_tiles(48, 48, 48, 32, 32, 32) == (16, 16, 16)
    assert torch.equal(ops.tropical_matmul(b, b), torch.zeros_like(b))


def test_wrappers_check_their_operands_on_the_cpu(monkeypatch):
    i32 = torch.zeros((8, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        dk.tropical_matmul(i32.float(), i32.float())
    # a 30000 x 30000 pair is taken (no shared-memory cap); the plain
    # version is stubbed, since its 60000 diagonals take minutes here
    calls = []
    monkeypatch.setattr(dk, "smith_waterman_plain", lambda a, b, **kw: (
        calls.append((tuple(a.shape), tuple(b.shape), kw))
        or torch.zeros(a.shape[0], dtype=torch.int32)))
    long = torch.zeros((1, 30000), dtype=torch.int32)
    assert dk.smith_waterman(long, long).shape == (1,)
    assert calls == [((1, 30000), (1, 30000),
                      dict(match=2, mismatch=-1, gap=-1))]
    with pytest.raises(ValueError, match="unknown"):
        dk.dpx_fused("vimin7", i32, i32, i32)
    with pytest.raises(TypeError):
        dk.dpx_fused("viaddmax", i32.long(), i32.long(), i32.long())
    assert dk.launch_counts() == {"tropical_matmul": 0, "smith_waterman": 0,
                                  "dpx_fused": 0}
    assert dk.tropical_matmul.launches_by_body == {"tma": 0, "staged": 0}
    assert dk.smith_waterman.launches_by_body == {"warp": 0, "bands": 0}


@pytest.mark.parametrize("M,N,K,aligned,want", [
    (2048, 2048, 2048, True, "tma"),
    (64, 64, 64, True, "tma"),
    (136, 100, 64, True, "tma"),         # M, N ragged against 128
    (64, 96, 32, True, "tma"),
    (64, 96, 48, True, "staged"),        # 32 does not divide K
    (8, 8, 8, True, "staged"),
    (2048, 2048, 2048, False, "staged"),  # an operand off 16 bytes
    (64, 98, 64, True, "staged"),        # N % 4 != 0
    (64, 4 * 65536, 64, True, "tma"),    # 2048 column tiles
])
def test_tropical_body_rule(M, N, K, aligned, want):
    """The tma body only where its 32-deep slices divide K (TMA's zero
    fill is not neutral for (max,+)) and TMA can read the operands."""
    assert dk.body(M, N, K, aligned) == want


@pytest.mark.parametrize("la,lb,S,bands,warps,pairs", [
    (1, 1, 1, 1, 1, dk.SW_PAIRS),
    (255, 255, 8, 1, 1, dk.SW_PAIRS),
    (256, 256, 8, 1, 1, dk.SW_PAIRS),
    (257, 257, 8, 2, 2, 1),
    (30000, 30000, 8, 118, dk.SW_MAX_WARPS, 1),
    (1, 257, 1, 1, 1, dk.SW_PAIRS),      # one column of 257 rows
    (257, 1, 1, 1, 1, dk.SW_PAIRS),
    (255, 30000, 8, 1, 1, dk.SW_PAIRS),  # bands across the shorter
    (30000, 256, 8, 1, 1, dk.SW_PAIRS),
    (256, 30000, 8, 1, 1, dk.SW_PAIRS),
    (257, 30000, 8, 2, 2, 1),
    (40, 64, 2, 1, 1, dk.SW_PAIRS),
    (1500, 1500, 8, 6, 6, 1),
])
def test_smith_waterman_plan(la, lb, S, bands, warps, pairs):
    """Rows are the longer sequence, bands of 32 S columns across the
    shorter; one band is a warp a pair, more a block a pair; shared
    memory does not grow with the lengths; the band edges' scratch."""
    p = dk.smith_waterman_plan(la, lb)
    assert (p.rows, p.cols) == (max(la, lb), min(la, lb))
    assert p.swap == (lb > la)
    assert (p.S, p.bands, p.warps, p.pairs) == (S, bands, warps, pairs)
    assert p.bands == -(-p.cols // (32 * p.S))
    assert p.body == ("warp" if bands == 1 else "bands")
    assert p.smem_bytes == (0 if warps == 1 else 12 * warps) <= 192
    assert p.scratch == (bands - 1) * p.rows
    assert 32 * p.warps * p.pairs <= 1024


@pytest.mark.parametrize("la,lb", [(31, 9), (9, 31), (40, 40)])
def test_smith_waterman_is_symmetric(la, lb):
    """The score of (a, b) is that of (b, a), which lets the kernel take
    the longer sequence as its rows."""
    rng = np.random.default_rng(la * lb)
    sa = torch.from_numpy(rng.integers(0, 3, (3, la)).astype(np.int32))
    sb = torch.from_numpy(rng.integers(0, 3, (3, lb)).astype(np.int32))
    for kw in (dict(), dict(match=1, mismatch=0, gap=1)):
        assert torch.equal(dk.smith_waterman(sa, sb, **kw),
                           dk.smith_waterman(sb, sa, **kw))


@pytest.mark.parametrize("name", ["dpx_functions", "dpx_kernels"])
def test_benchmark_rows_named_as_reference(name, monkeypatch):
    """Run on the CPU, each DPX benchmark's rows are the reference's,
    measured rows prefixed with `measured(cpu)/`, at its sizes."""
    monkeypatch.setattr(ref_bench_dpx, "measure_jitted",
                        lambda f, args, name="", **kw: RefTiming(name, 1.0,
                                                                 0.0, 1))
    want = [t.name for t in getattr(ref_bench_dpx, name)()]
    want = [n if n.startswith("paper/") else f"measured(cpu)/{n}"
            for n in want]
    rows = getattr(bench_dpx, name)("cpu")
    assert [t.name for t in rows] == want
    for t in rows:
        if t.us_per_call > 0 and t.derived is not None:
            assert t.derived_name in ("fused_speedup", "G_DP_cells_per_s")
