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
