"""The port's matrix-product kernels (plain versions on the CPU) against
the reference's Pallas kernels run as tests/test_kernels.py runs them
(``repro.kernels.ops``, interpret mode on the CPU), on that file's
cases and limits.  Inputs are made once with numpy and handed to both
packages bit for bit (``models/convert.to_torch``).
"""

import warnings

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.matmul import single_tile_matmul as ref_single_tile
from repro_torch.kernels import async_pipeline as apk
from repro_torch.kernels import fp8_matmul as f8k
from repro_torch.kernels import matmul as mmk
from repro_torch.kernels import ops
from repro_torch.models.convert import to_torch


def _both(x: np.ndarray, dtype):
    """The same values as a JAX array of `dtype` and as its bit-equal
    torch tensor."""
    j = jnp.asarray(x, dtype)
    return j, to_torch(np.asarray(j))


def _assert_close(got, want, rtol, atol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _same_dtype(got: torch.Tensor, want) -> None:
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)


@pytest.mark.parametrize("m,n,k", [(64, 64, 64), (128, 256, 128),
                                   (96, 64, 160), (32, 512, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_sweep(m, n, k, dtype):
    rng = np.random.default_rng(7)
    ja, ta = _both(rng.standard_normal((m, k)), dtype)
    jb, tb = _both(rng.standard_normal((k, n)), dtype)
    want = ref_ops.matmul(ja, jb, bm=32, bn=32, bk=32)
    got = ops.matmul(ta, tb, bm=32, bn=32, bk=32)
    _same_dtype(got, want)
    bf16 = dtype == "bfloat16"
    _assert_close(got, want, 2e-2 if bf16 else 1e-5, 2e-1 if bf16 else 1e-4)


def test_matmul_int8_exact():
    rng = np.random.default_rng(7)
    ja, ta = _both(rng.integers(-16, 16, (64, 96)), jnp.int8)
    jb, tb = _both(rng.integers(-16, 16, (96, 64)), jnp.int8)
    want = ref_ops.matmul(ja, jb, bm=32, bn=32, bk=32)
    got = ops.matmul(ta, tb, bm=32, bn=32, bk=32)
    assert got.dtype == torch.int32
    _same_dtype(got, want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_matmul_autotuned_tile():
    """No explicit tiles: the port's model picks a tile the kernel can
    stage (float32 256^2: 128^3, 131072 bytes of shared memory)."""
    rng = np.random.default_rng(7)
    ja, ta = _both(rng.standard_normal((256, 256)), jnp.float32)
    jb, tb = _both(rng.standard_normal((256, 256)), jnp.float32)
    want = ref_ops.matmul(ja, jb)
    _assert_close(ops.matmul(ta, tb), want, 1e-4, 1e-3)
    tiles = ops._auto_tiles(256, 256, 256, torch.float32)
    assert tiles == (128, 128, 128)
    # every dtype's auto tile fits the kernel's staging (fp8 is staged
    # as bf16), at the benchmarks' and the full-width shapes
    for shape in ((256, 256, 256), (512, 512, 512), (2048, 11008, 4096),
                  (96, 64, 160)):
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            assert mmk.smem_bytes(dtype, *ops._auto_tiles(*shape, dtype)) \
                <= mmk.SMEM_LIMIT
        for fmt in f8k.FORMATS:
            assert f8k.smem_bytes(*ops._auto_tiles(*shape, fmt)) \
                <= mmk.SMEM_LIMIT


@pytest.mark.parametrize("fp8", ["float8_e4m3fn", "float8_e5m2"])
def test_fp8_matmul(fp8):
    rng = np.random.default_rng(7)
    x, w = rng.standard_normal((64, 128)), rng.standard_normal((128, 64))
    ja, ta = _both(x, getattr(ml_dtypes, fp8))
    jb, tb = _both(w, getattr(ml_dtypes, fp8))
    # the port's own quantization of the same values gives the same codes
    for src, t in ((x, ta), (w, tb)):
        codes = torch.from_numpy(src).to(getattr(torch, fp8))
        assert torch.equal(codes.view(torch.uint8), t.view(torch.uint8))
    sx, sw = jnp.float32(0.37), jnp.float32(1.9)
    want = ref_ops.fp8_matmul(ja, jb, sx, sw, bm=32, bn=32, bk=32)
    got = ops.fp8_matmul(ta, tb, torch.tensor(0.37), torch.tensor(1.9),
                         bm=32, bn=32, bk=32)
    _same_dtype(got, want)
    _assert_close(got, want, 2e-2, 2e-1)


@pytest.mark.parametrize("stages", [1, 2, 3])
def test_async_pipeline_kernel(stages):
    rng = np.random.default_rng(7)
    ja, ta = _both(rng.standard_normal((64, 128)), jnp.float32)
    jb, tb = _both(rng.standard_normal((128, 96)), jnp.float32)
    want = ref_ops.pipelined_matmul(ja, jb, bm=32, bn=32, bk=32,
                                    stages=stages)
    got = ops.pipelined_matmul(ta, tb, bm=32, bn=32, bk=32, stages=stages)
    _same_dtype(got, want)
    _assert_close(got, want, 1e-4, 1e-4)


@pytest.mark.parametrize("dtype,shape", [
    ("float32", (64, 64, 64)), ("bfloat16", (64, 64, 64)),
    ("int8", (64, 96, 64))])
def test_single_tile_mma_analog(dtype, shape):
    """Output in the accumulator's dtype: float32 for bf16 in, int32
    for int8 in, as the reference's."""
    rng = np.random.default_rng(7)
    m, n, k = shape
    if dtype == "int8":
        xa, xb = rng.integers(-8, 8, (m, k)), rng.integers(-8, 8, (k, n))
    else:
        xa, xb = rng.standard_normal((m, k)), rng.standard_normal((k, n))
    ja, ta = _both(xa, dtype)
    jb, tb = _both(xb, dtype)
    want = ref_single_tile(ja, jb)
    got = mmk.single_tile_matmul(ta, tb)
    _same_dtype(got, want)
    if dtype == "int8":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _assert_close(got, want, 1e-4, 1e-4)


def test_matmul_oversize_tile_raises():
    """A tile strictly larger than its operand dimension raises, as in
    the reference (the decode-tile audit)."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal((16, 32))).float()
    b = torch.from_numpy(rng.standard_normal((32, 16))).float()
    with pytest.raises(ValueError, match="exceeds the operand"):
        ops.matmul(a, b, bm=32, bn=16, bk=32)          # bm > m
    with pytest.raises(ValueError, match="exceeds the operand"):
        ops.matmul(a, b, bm=16, bn=16, bk=64)          # bk > k


def test_pipelined_oversize_tile_raises():
    rng = np.random.default_rng(7)
    af = torch.from_numpy(rng.standard_normal((16, 16))).float()
    bf = torch.from_numpy(rng.standard_normal((16, 16))).float()
    with pytest.raises(ValueError, match="exceeds the operand"):
        ops.pipelined_matmul(af, bf, bn=64)


def test_shared_memory_limit_raises_on_either_device():
    """A tile whose staging exceeds the 232448-byte per-block limit is
    refused before any launch, on the CPU too."""
    a = torch.zeros((512, 512))
    with pytest.raises(ValueError, match="shared memory"):
        mmk.matmul(a, a, bm=128, bn=256, bk=512)
    with pytest.raises(ValueError, match="shared memory"):
        apk.pipelined_matmul(a, a, bm=128, bn=128, bk=128, stages=2)
    q = torch.zeros((512, 512), dtype=torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="shared memory"):
        f8k.fp8_matmul(q, q, 1.0, 1.0, bm=128, bn=256, bk=512)
    assert mmk.smem_bytes(torch.float32, 128, 256, 128) == 196608
    assert mmk.smem_bytes(torch.bfloat16, 128, 256, 128) == 104448
    with pytest.raises(ValueError, match="stages"):
        apk.pipelined_matmul(a, a, stages=5)


def test_tile_alignment_warning_rule():
    """The warning fires on an explicit tile that is not a whole number
    of mma.sync fragments (m16, n8, k16; k32 for int8), and not on an
    aligned, full-dimension or auto tile."""
    a = torch.ones((64, 64))
    i8 = torch.ones((64, 64), dtype=torch.int8)
    for kw in (dict(bm=8, bn=16, bk=16), dict(bm=16, bn=4, bk=16),
               dict(bm=16, bn=8, bk=8)):
        with pytest.warns(ops.TileAlignmentWarning):
            ops.matmul(a, a, **kw)
    with pytest.warns(ops.TileAlignmentWarning, match="32"):
        ops.matmul(i8, i8, bm=16, bn=8, bk=16)
    with pytest.warns(ops.TileAlignmentWarning):
        ops.pipelined_matmul(a, a, bm=8, bn=8, bk=8)
    with warnings.catch_warnings():
        warnings.simplefilter("error", ops.TileAlignmentWarning)
        ops.matmul(a, a)
        ops.matmul(a, a, bm=64, bn=64, bk=64)
        ops.matmul(a, a, bm=16, bn=8, bk=16)
        ops.matmul(i8, i8, bm=16, bn=8, bk=32)
        ops.pipelined_matmul(a, a)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    a = torch.ones((8, 8))
    with pytest.raises(TypeError):
        mmk.matmul(a, a.double())
    with pytest.raises(TypeError):
        apk.pipelined_matmul(a.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        mmk.matmul(a.t(), a)
    with pytest.raises(ValueError):
        mmk.matmul(a, torch.ones((4, 8)))


# ----------------------------------------------------------------------
# the tile rule: which body a product runs (csrc/matmul.cu matmul_body,
# csrc/fp8_matmul.cu fp8_matmul_body; tests/test_torch_gpu.py holds the
# sources to this table on the card)
# ----------------------------------------------------------------------

BF16, I8, F32 = torch.bfloat16, torch.int8, torch.float32
E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2
FULL = (2048, 11008, 4096)

RULE_TABLE = [
    # dtype, (M, N, K), (bm, bn, bk), b_layout, aligned, body
    (BF16, FULL, (128, 128, 128), "row", True, "wgmma"),
    (BF16, FULL, (128, 256, 128), "row", True, "wgmma"),
    (BF16, FULL, (128, 256, 64), "row", True, "wgmma"),
    (BF16, FULL, (64, 64, 64), "row", True, "wgmma"),
    (BF16, (512, 512, 512), (128, 256, 128), "row", True, "wgmma"),
    (BF16, (200, 328, 200), (128, 128, 64), "row", True, "wgmma"),
    (BF16, FULL, (128, 128, 32), "row", True, "mma_sync"),     # bk < a box
    (BF16, FULL, (128, 128, 320), "row", True, "mma_sync"),    # B box > 256
    (BF16, FULL, (256, 128, 128), "row", True, "mma_sync"),    # bm > 2 WGs
    (BF16, FULL, (128, 512, 64), "row", True, "mma_sync"),     # bn > 256
    (BF16, FULL, (128, 96, 64), "row", True, "mma_sync"),      # bn width
    (BF16, FULL, (16, 8, 16), "row", True, "mma_sync"),
    (BF16, (200, 330, 200), (128, 128, 64), "row", True, "mma_sync"),  # N*2
    (BF16, (200, 328, 204), (128, 128, 64), "row", True, "mma_sync"),  # K*2
    (BF16, FULL, (128, 128, 128), "row", False, "mma_sync"),   # alignment
    (I8, FULL, (128, 128, 128), "row", True, "wgmma"),
    (I8, FULL, (128, 256, 128), "col", True, "wgmma"),
    (I8, FULL, (64, 128, 256), "row", True, "wgmma"),
    (I8, (200, 330, 208), (128, 128, 128), "row", True, "wgmma"),  # N free
    (I8, FULL, (128, 128, 64), "row", True, "mma_sync"),       # bk < a box
    (I8, (200, 328, 200), (128, 128, 128), "col", True, "mma_sync"),  # K
    (I8, FULL, (8, 8, 8), "row", True, "mma_sync"),
    (E4M3, FULL, (128, 128, 128), "col", True, "wgmma"),
    (E4M3, FULL, (128, 128, 128), "row", True, "wgmma"),
    (E5M2, FULL, (64, 64, 256), "row", True, "wgmma"),
    (E4M3, FULL, (128, 256, 128), "col", True, "mma_sync"),    # promotion
    (E5M2, FULL, (32, 32, 32), "row", True, "mma_sync"),
    (E4M3, FULL, (128, 128, 128), "col", False, "mma_sync"),
    (F32, FULL, (128, 256, 128), "row", True, "fma"),          # bn 256
    (F32, (200, 330, 200), (64, 64, 64), "row", True, "fma"),  # N % 4
    # float32 on the TMA ring (fma_tma): bm, bn each 16/32/64/128, TMA
    # can read the operands; every other float32 tile keeps fma
    (F32, FULL, (128, 128, 128), "row", True, "fma_tma"),
    (F32, FULL, (64, 64, 64), "row", True, "fma_tma"),
    (F32, (512, 512, 512), (128, 128, 128), "row", True, "fma_tma"),
    (F32, (256, 256, 256), (128, 32, 128), "row", True, "fma_tma"),
    (F32, (96, 64, 160), (32, 32, 32), "row", True, "fma_tma"),
    (F32, (200, 332, 516), (16, 128, 8), "row", True, "fma_tma"),  # any bk
    (F32, FULL, (128, 128, 128), "row", False, "fma"),         # alignment
    (F32, (200, 328, 202), (128, 128, 128), "row", True, "fma"),  # K % 4
    (F32, FULL, (16, 8, 16), "row", True, "fma"),              # bn 8
    (F32, FULL, (256, 128, 128), "row", True, "fma"),          # bm 256
    (F32, (64, 16 * 65535, 64), (16, 16, 16), "row", True, "fma_tma"),
    (F32, (64, 16 * 65536, 64), (16, 16, 16), "row", True, "fma"),  # grid
]


@pytest.mark.parametrize("dtype,shape,tiles,layout,aligned,want", RULE_TABLE)
def test_body_rule_table(dtype, shape, tiles, layout, aligned, want):
    assert mmk.body(dtype, *shape, *tiles, layout, aligned) == want
    # the body never depends on B's layout (8-bit B is copied to fit)
    if dtype.itemsize == 1:
        other = "row" if layout == "col" else "col"
        assert mmk.body(dtype, *shape, *tiles, other, aligned) == want


@pytest.mark.parametrize("tiles", [(128, 128, 256), (64, 64, 512),
                                   (128, 64, 512), (16, 128, 1024)])
def test_float32_tma_tiles_keep_the_fma_shared_memory_check(tiles):
    """A float32 tile on the fma_tma grid is held to the bytes the fma
    body stages for (bm, bn, bk): a tile refused before the TMA ring is
    refused still (ValueError before any launch), although the ring's
    own two 64-deep stages would fit."""
    bm, bn, bk = tiles
    M, N, K = 256, 256, 2048
    assert mmk.body(F32, M, N, K, *tiles) == "fma_tma"
    assert mmk.smem_bytes(F32, *tiles, "fma_tma") == \
        mmk.mma_smem_bytes(F32, *tiles) > mmk.SMEM_LIMIT
    a = torch.zeros((M, K))
    with pytest.raises(ValueError, match="shared memory"):
        mmk.matmul(a, torch.zeros((K, N)), bm=bm, bn=bn, bk=bk)


def test_body_rule_refuses_a_column_major_16_bit_b():
    with pytest.raises(ValueError, match="row-major"):
        mmk.body(BF16, *FULL, 128, 128, 128, "col")
    with pytest.raises(ValueError):
        mmk.body(I8, *FULL, 128, 128, 128, "diag")


@pytest.mark.parametrize("dtype,tiles,stages,nbytes", [
    (BF16, (128, 128, 128), 3, 197760),
    (BF16, (128, 256, 128), 2, 197760),
    (BF16, (128, 256, 64), 4, 197760),
    (BF16, (128, 128, 64), 6, 197760),
    (BF16, (64, 64, 64), 6, 99456),
    (BF16, (128, 256, 256), 1, 197760),
    (I8, (128, 128, 128), 6, 197760),
    (I8, (128, 256, 128), 4, 197760),
    (E4M3, (128, 128, 128), 6, 197760),
    (E5M2, (64, 64, 256), 6, 197760),
])
def test_wgmma_shared_memory_count(dtype, tiles, stages, nbytes):
    """The ring holds as many stages of (bm + bn) * bk bytes-per-value as
    fit 232448 bytes with 1152 bytes of alignment and barriers, at most
    six; the count is what the sources allocate (held on the card)."""
    stage = (tiles[0] + tiles[1]) * tiles[2] * dtype.itemsize
    assert mmk.wgmma_stages(dtype, *tiles) == stages
    assert mmk.smem_bytes(dtype, *tiles, "wgmma") == nbytes \
        == mmk.SMEM_SLACK + stages * stage
    assert nbytes <= mmk.SMEM_LIMIT
    if dtype in f8k.FORMATS:
        assert f8k.smem_bytes(*tiles, "wgmma", dtype) == nbytes


@pytest.mark.parametrize("dtype,tiles", [
    (I8, (128, 256, 1024)), (BF16, (128, 256, 512 + 256)),
    (E4M3, (128, 128, 1024))])
def test_wgmma_tiles_over_the_limit_raise(dtype, tiles):
    """On the grid but not one stage fits (the 16-bit B box caps bf16's bk
    at 256, so its row takes the mma_sync staging): ValueError before any
    launch, on the CPU as on the card."""
    M, N, K = 256, 256, 2048
    if dtype in f8k.FORMATS:
        q = torch.zeros((M, K), dtype=dtype)
        with pytest.raises(ValueError, match="shared memory"):
            f8k.fp8_matmul(q, torch.zeros((K, N), dtype=dtype), 1.0, 1.0,
                           bm=tiles[0], bn=tiles[1], bk=tiles[2])
        return
    a = torch.zeros((M, K), dtype=dtype)
    with pytest.raises(ValueError, match="shared memory"):
        mmk.matmul(a, torch.zeros((K, N), dtype=dtype), bm=tiles[0],
                   bn=tiles[1], bk=tiles[2])


def _col_major(t: torch.Tensor) -> torch.Tensor:
    """The same [K,N] values laid out column-major (a view of [N,K])."""
    out = t.t().contiguous().t()
    assert not out.is_contiguous() and out.t().is_contiguous()
    return out


@pytest.mark.parametrize("shape", [(64, 96, 128), (200, 136, 256)])
def test_int8_matmul_column_major_b_vs_reference(shape):
    """The port's int8 matmul (plain version on the CPU) with a
    column-major B against the reference's Pallas kernel in interpret
    mode on the same numpy-seeded values: bit for bit."""
    m, n, k = shape
    rng = np.random.default_rng(13)
    ja, ta = _both(rng.integers(-128, 128, (m, k)), jnp.int8)
    jb, tb = _both(rng.integers(-128, 128, (k, n)), jnp.int8)
    want = ref_ops.matmul(ja, jb, bm=32, bn=32, bk=32)
    got = mmk.matmul(ta, _col_major(tb), bm=128, bn=128, bk=128)
    _same_dtype(got, want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fp8", ["float8_e4m3fn", "float8_e5m2"])
@pytest.mark.parametrize("shape", [(64, 64, 128), (96, 200, 512)])
def test_fp8_matmul_column_major_b_vs_reference(fp8, shape):
    """The port's fp8_matmul (plain version on the CPU) with a
    column-major B against the reference's Pallas kernel in interpret
    mode: within one bf16 rounding step of the output (the two round the
    same float32 sum, taken in another order)."""
    m, n, k = shape
    rng = np.random.default_rng(17)
    ja, ta = _both(rng.standard_normal((m, k)), getattr(ml_dtypes, fp8))
    jb, tb = _both(rng.standard_normal((k, n)), getattr(ml_dtypes, fp8))
    sx, sw = jnp.float32(0.37), jnp.float32(1.9)
    want = np.asarray(ref_ops.fp8_matmul(ja, jb, sx, sw, bm=32, bn=32,
                                         bk=32), np.float32)
    got = f8k.fp8_matmul(ta, _col_major(tb), torch.tensor(0.37),
                         torch.tensor(1.9), bm=128, bn=128, bk=128)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want)
            + 2.0 ** -12 * np.abs(want).max()).all()
    # and equal to the port's own plain product on the row-major B
    np.testing.assert_array_equal(
        got, f8k.fp8_matmul(ta, tb, torch.tensor(0.37),
                            torch.tensor(1.9)).float().numpy())


def test_column_major_b_only_for_the_8_bit_types():
    a = torch.ones((8, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        mmk.matmul(a, _col_major(a))
    i8 = torch.ones((8, 8), dtype=torch.int8)
    assert torch.equal(mmk.matmul(i8, _col_major(i8)), mmk.matmul(i8, i8))


# ----------------------------------------------------------------------
# the TMA bodies' rules (csrc/async_pipeline.cu pipelined_matmul_body,
# csrc/matmul.cu single_tile_matmul_body; tests/test_torch_gpu.py holds
# the sources to these mirrors on the card)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("tile", [16, 32, 64])
@pytest.mark.parametrize("stages", [1, 2, 3, 4])
@pytest.mark.parametrize("K,N", [(4096, 11008), (4098, 11008),
                                 (4096, 11010), (130, 66)])
@pytest.mark.parametrize("aligned", [True, False])
def test_pipelined_body_and_bytes(tile, stages, K, N, aligned):
    """tma where TMA can read both operands (K and N multiples of 4,
    aligned bases), else cp_async; tma stages A [t][t] and B [t][t]
    float32 slices plus 1152 bytes of alignment and barriers, cp_async
    the same slices bare."""
    want = "tma" if K % 4 == 0 and N % 4 == 0 and aligned else "cp_async"
    got = apk.body(2048, N, K, tile, tile, tile, aligned)
    assert got == want
    slices = stages * 2 * tile * tile * 4
    nbytes = apk.smem_bytes(tile, tile, tile, stages, got)
    assert nbytes == (1152 + slices if got == "tma" else slices)
    assert apk.smem_bytes(tile, tile, tile, stages) == 1152 + slices
    # the shared-memory check counts the body the call runs
    a = torch.zeros((8, K))
    b = torch.zeros((K, N))
    if not aligned:
        a = torch.zeros(8 * K + 1)[1:].view(8, K)
    assert apk.pipelined_matmul(a, b, bm=tile, bn=tile, bk=tile,
                                stages=stages).shape == (8, N)


@pytest.mark.parametrize("tiles,body,groups", [
    ((16, 16, 16), "tma", 2), ((32, 16, 64), "tma", 2),
    ((16, 32, 32), "tma", 1), ((32, 32, 32), "tma", 1),
    ((64, 64, 64), "tma", 2), ((64, 32, 16), "tma", 1),
    ((32, 64, 128), "tma", 1), ((128, 128, 128), "tma", 1),
    ((48, 64, 64), "cp_async", None), ((64, 64, 8), "cp_async", None),
    ((128, 256, 64), "cp_async", None), ((7, 9, 33), "cp_async", None)])
def test_pipelined_tile_rule_and_k_groups(tiles, body, groups):
    assert apk.tile_body(*tiles) == body
    assert apk.body(512, 512, 512, *tiles) == body
    if groups is not None:
        assert apk.k_groups(*tiles[:2]) == groups
    # two K groups add their halves through the ring's memory: a stage
    # ring smaller than the bm x bn sums grows to hold them
    bm, bn, bk = tiles
    if body == "tma":
        ring = 4 * bk * (bm + bn)
        red = 4 * bm * bn if groups == 2 else 0
        assert apk.smem_bytes(*tiles, 1) == 1152 + max(ring, red)


def test_pipelined_grid_limit_takes_cp_async():
    """More than 65535 column tiles: not on TMA's grid."""
    assert apk.body(64, 16 * 65535, 64, 16, 16, 16) == "tma"
    assert apk.body(64, 16 * 65536, 64, 16, 16, 16) == "cp_async"


@pytest.mark.parametrize("dtype,shape,body,nbytes", [
    (F32, (128, 128, 128), "tma", 132352),
    (F32, (128, 256, 128), "tma", 132352),
    (F32, (256, 256, 256), "tma", 197888),    # B kept: 8 slices
    (F32, (256, 256, 512), "tma", 132352),    # 16 slices: streamed
    (BF16, (128, 128, 128), "tma", 215296),
    (BF16, (256, 256, 256), "tma", 215296),   # B kept: 4 slices
    (BF16, (384, 256, 320), "tma", 215296),   # 5 do not fit: streamed
    (BF16, (256, 256, 1024), "tma", 215296),  # streamed
    (I8, (128, 256, 128), "tma", 215296),
    (I8, (256, 256, 256), "tma", 215296),     # transposed B kept
    (I8, (256, 256, 384), "tma", 215296),     # 3 do not fit: streamed
    (I8, (256, 64, 1024), "tma", 215296),     # streamed
    (BF16, (64, 96, 66), "staged", None), (I8, (64, 90, 96), "staged", None),
    (F32, (50, 70, 30), "staged", None)])
def test_single_tile_body_and_bytes(dtype, shape, body, nbytes):
    """tma where TMA can read both operands (K and N rows whole 16
    bytes); its shared memory is 1280 bytes of alignment and barriers,
    four 16 KB A stages, 17408 bytes of staged output rows (bf16,
    int8) and either one B stage per K slice (kept for every row block:
    more than one row block and it fits) or four streamed B stages
    (int8: two TMA stages plus two transposed copies, or all transposed
    slices kept)."""
    assert mmk.single_tile_body(dtype, *shape) == body
    assert mmk.single_tile_body(dtype, *shape, aligned=False) == "staged"
    if body == "tma":
        assert mmk.single_tile_smem_bytes(dtype, *shape) == nbytes
        assert mmk.single_tile_bk(dtype, *shape) == 128 // dtype.itemsize
    else:
        assert mmk.single_tile_bk(dtype, *shape, "staged") == shape[2]
