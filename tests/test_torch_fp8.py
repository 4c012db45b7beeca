"""Port vs reference: fp8 numerics, fp8 serving linears, the e4m3 KV pool.

* `te/fp8`: `compute_scale`, `quantize`, `quantize_rowwise` give
  BITWISE the reference's e4m3 codes and float32 scales on the same
  inputs (same float32 operations in the same order, round to nearest
  even); `fp8_dot`'s plain version is within 1e-5 relative.
* `te/linear`: `quantize_serving_params` on bridged reduced yi-6b
  weights gives equal codes and scales; `fp8_serving_dot` is within one
  bf16 step (its float32 sums run in another order).
* attention: `update_paged_cache_fp8` writes equal codes and scales
  (drop rows, -1 tails, scalar pos); `gather_paged_cache_fp8` gives
  equal values; the plain versions of the fp8 kernels match the
  reference's Pallas kernels in interpret mode within the PR 11
  tolerances (float32 1e-5; bf16 2**-7 relative + 1e-6); the COW copy
  carries the scales.
The CUDA kernels are held against the plain versions on the card in
tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.kernels import paged_attention as ref_pk
from repro.models import api as ref_api
from repro.models import attention as ref_attn
from repro.te import fp8 as ref_fp8
from repro.te import linear as ref_linear
from repro_torch.configs import reduced_config
from repro_torch.kernels import paged_attention as pk
from repro_torch.models import api, attention, convert
from repro_torch.models.convert import to_torch
from repro_torch.te import fp8, linear


def _codes(x) -> np.ndarray:
    """e4m3 codes as bytes, from a jax/numpy array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _same(want, got) -> None:
    a = np.asarray(want)
    if a.dtype == ml_dtypes.float8_e4m3fn:
        assert np.array_equal(_codes(a), _codes(got))
    else:
        assert np.array_equal(a.view(np.uint32),
                              got.contiguous().numpy().view(np.uint32))


# ----------------------------------------------------------------------
# te/fp8
# ----------------------------------------------------------------------

def test_compute_scale_and_quantize_bitwise():
    rng = np.random.default_rng(0)
    amaxes = np.concatenate([[0.0, 1e-13, 1e-12, 448.0, 3.0e38],
                             np.abs(rng.standard_normal(200)) * 10.0 **
                             rng.integers(-8, 8, 200)]).astype(np.float32)
    _same(ref_fp8.compute_scale(jnp.asarray(amaxes)),
          fp8.compute_scale(torch.from_numpy(amaxes)))
    x = (rng.standard_normal((64, 96)) * 30).astype(np.float32)
    for s in (np.float32(0.02), np.float32(0.317), np.float32(1.7)):
        _same(ref_fp8.quantize(jnp.asarray(x), jnp.asarray(s)),
              fp8.quantize(torch.from_numpy(x), torch.tensor(s)))
    xq = ref_fp8.quantize(jnp.asarray(x), jnp.float32(0.5))
    _same(ref_fp8.dequantize(xq, jnp.float32(0.5), jnp.float32),
          fp8.dequantize(to_torch(np.asarray(xq)), torch.tensor(0.5),
                         torch.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rowwise_bitwise(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 4, 32)) * rng.uniform(0.01, 50,
                                                         (3, 5, 4, 1))
    x[0, 0, 0] = 0.0                            # all-zero row: 1e-12 floor
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    want_q, want_s = ref_fp8.quantize_rowwise(jx)
    got_q, got_s = fp8.quantize_rowwise(to_torch(np.asarray(jx)))
    _same(want_q, got_q)
    _same(want_s, got_s)


def test_fp8_dot_plain_within_1e5():
    rng = np.random.default_rng(2)
    xq = ref_fp8.quantize(jnp.asarray(rng.standard_normal((24, 64)),
                                      jnp.float32), jnp.float32(0.01))
    wq = ref_fp8.quantize(jnp.asarray(rng.standard_normal((64, 48)),
                                      jnp.float32), jnp.float32(0.01))
    sx, sw = np.float32(0.013), np.float32(0.0021)
    want = np.asarray(ref_fp8.fp8_dot(xq, jnp.asarray(sx), wq,
                                      jnp.asarray(sw), jnp.float32))
    got = fp8.fp8_dot(to_torch(np.asarray(xq)), torch.tensor(sx),
                      to_torch(np.asarray(wq)), torch.tensor(sw),
                      torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 *
                               np.abs(want).max())


# ----------------------------------------------------------------------
# te/linear
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def quantized():
    ref_cfg, cfg = ref_reduced_config("yi-6b"), reduced_config("yi-6b")
    jp = ref_api.init(ref_cfg, jax.random.PRNGKey(0))
    tp = convert.from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                cfg, device="cpu")
    return (ref_linear.quantize_serving_params(jp),
            linear.quantize_serving_params(tp))


def test_quantize_serving_params_equal(quantized):
    want, got = quantized
    for group in ("attn", "mlp"):
        assert set(want["layers"][group]) == set(got["layers"][group])
        for name, leaf in want["layers"][group].items():
            g = got["layers"][group][name]
            assert tuple(g["q"].shape) == leaf["q"].shape, name
            assert tuple(g["s"].shape) == leaf["s"].shape, name
            _same(leaf["q"], g["q"])
            _same(leaf["s"], g["s"])
            # one layer's codes reshape to a column-major [K, N] view,
            # the operand layout of the card's fp8 product
            nd = 2 if name == "wo" else 1
            K = int(np.prod(leaf["q"].shape[1:1 + nd]))
            assert g["q"][0].reshape(K, -1).stride(0) == 1, name
            # and every layer's scale starts a 256-byte line (cuBLASLt
            # refuses an unaligned scale pointer)
            assert all((g["s"][i].data_ptr() - g["s"].data_ptr()) % 256 == 0
                       for i in range(g["s"].shape[0])), name


@pytest.mark.parametrize("name,x_nd", [("wq", 1), ("wk", 1), ("wo", 2),
                                       ("w_up", 1), ("w_down", 1)])
def test_fp8_serving_dot_within_one_bf16_step(quantized, name, x_nd):
    want_tree, got_tree = quantized
    group = "mlp" if name.startswith("w_") else "attn"
    jleaf = jax.tree_util.tree_map(lambda a: a[1],
                                   want_tree["layers"][group][name])
    tleaf = {k: v[1] for k, v in got_tree["layers"][group][name].items()}
    k_shape = jleaf["q"].shape[:x_nd]
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((2, 5) + k_shape), jnp.bfloat16)
    want = np.asarray(ref_linear.fp8_serving_dot(
        x, jleaf, x_contract_ndim=x_nd, w_contract_ndim=x_nd), np.float32)
    got = linear.fp8_serving_dot(to_torch(np.asarray(x)), tleaf,
                                 x_contract_ndim=x_nd,
                                 w_contract_ndim=x_nd)
    assert got.dtype == torch.bfloat16
    assert want.shape == tuple(got.shape)
    assert (np.abs(got.float().numpy() - want)
            <= 2.0 ** -7 * np.abs(want) + 1e-6).all()


# ----------------------------------------------------------------------
# the e4m3 KV pool
# ----------------------------------------------------------------------

def _fp8_layer(NB, bs, KH, hd, rng):
    """A single-layer fp8 cache holding quantized random rows, as
    (jax dict, torch dict) with the same bytes."""
    kf = jnp.asarray(rng.standard_normal((NB, bs, KH, hd)), jnp.bfloat16)
    vf = jnp.asarray(rng.standard_normal((NB, bs, KH, hd)), jnp.bfloat16)
    ck, ks = ref_fp8.quantize_rowwise(kf)
    cv, vs = ref_fp8.quantize_rowwise(vf)
    jl = {"k": ck, "v": cv, "k_scale": ks, "v_scale": vs}
    return jl, {k: to_torch(np.asarray(v)) for k, v in jl.items()}


def test_update_paged_cache_fp8_equal():
    """-1 tails, a write running past the table, an idle slot, ragged
    pos, then a scalar pos: codes and scales equal to the reference's;
    dropped rows land nowhere."""
    B, KH, hd, NB, bs, MB, C = 4, 2, 16, 20, 4, 3, 6
    rng = np.random.default_rng(11)
    jl, tl = _fp8_layer(NB, bs, KH, hd, rng)
    bt = rng.permutation(NB)[:B * MB].reshape(B, MB).astype(np.int32)
    bt[0, 1:] = -1
    bt[2, :] = -1
    for pos in (np.array([2, 9, 0, 5], np.int32), np.int32(3)):
        k1 = jnp.asarray(rng.standard_normal((B, C, KH, hd)) * 3,
                         jnp.bfloat16)
        v1 = jnp.asarray(rng.standard_normal((B, C, KH, hd)), jnp.bfloat16)
        jl = ref_attn.update_paged_cache_fp8(jl, k1, v1, jnp.asarray(pos),
                                             jnp.asarray(bt))
        attention.update_paged_cache_fp8(
            tl, to_torch(np.asarray(k1)), to_torch(np.asarray(v1)),
            torch.as_tensor(pos), torch.from_numpy(bt))
        for key in ("k", "v", "k_scale", "v_scale"):
            _same(jl[key], tl[key])


def test_gather_paged_cache_fp8_equal():
    NB, bs, KH, hd, B, MB = 10, 4, 2, 16, 3, 3
    rng = np.random.default_rng(13)
    jl, tl = _fp8_layer(NB, bs, KH, hd, rng)
    bt = rng.permutation(NB)[:B * MB].reshape(B, MB).astype(np.int32)
    bt[1, 2] = -1
    for jd, td in ((jnp.bfloat16, torch.bfloat16),
                   (jnp.float32, torch.float32)):
        want = ref_attn.gather_paged_cache_fp8(jl, jnp.asarray(bt),
                                               out_dtype=jd)
        got = attention.gather_paged_cache_fp8(tl, torch.from_numpy(bt),
                                               out_dtype=td)
        for w, g in zip(want, got):
            assert g.dtype == td
            assert np.array_equal(np.asarray(w, np.float32),
                                  g.float().numpy())


@jax.jit
def _ref_decode_fp8(q, cl, bt, kv_len):
    return ref_pk.paged_decode(q, cl["k"], cl["v"], bt, kv_len,
                               k_scale=cl["k_scale"], v_scale=cl["v_scale"])


@jax.jit
def _ref_chunk_fp8(q, cl, bt, pos):
    return ref_pk.paged_chunk(q, cl["k"], cl["v"], bt, pos,
                              k_scale=cl["k_scale"], v_scale=cl["v_scale"])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", ["decode", "chunk"])
def test_fp8_plain_vs_pallas(kind, dtype):
    """At the reference's `_mk_fp8` shapes (B=3, H=4, KH=2, hd=32,
    NB=24, bs=8, MB=6; -1 tails, ragged kv_len)."""
    B, H, KH, hd, NB, bs, MB = 3, 4, 2, 32, 24, 8, 6
    C = 1 if kind == "decode" else 4
    rng = np.random.default_rng(23 if kind == "decode" else 29)
    jl, tl = _fp8_layer(NB, bs, KH, hd, rng)
    T = MB * bs
    kv_len = np.array([1, bs + bs // 2 + 1, T], np.int32)
    bt = rng.permutation(NB)[:B * MB].reshape(B, MB).astype(np.int32)
    for b in range(B):
        bt[b, -(-int(kv_len[b]) // bs):] = -1
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    q = jnp.asarray(rng.standard_normal((B, C, H, hd)), jd)
    tq = to_torch(np.asarray(q))
    scales = dict(k_scale=tl["k_scale"], v_scale=tl["v_scale"])
    if kind == "decode":
        want = _ref_decode_fp8(q, jl, bt, kv_len)
        got = pk.paged_decode_fp8(tq, tl["k"], tl["v"], torch.from_numpy(bt),
                                  torch.from_numpy(kv_len), **scales)
    else:
        pos = np.maximum(kv_len - C, 0).astype(np.int32)
        want = _ref_chunk_fp8(q, jl, bt, pos)
        got = pk.paged_chunk_fp8(tq, tl["k"], tl["v"], torch.from_numpy(bt),
                                 torch.from_numpy(pos), **scales)
    a, b = np.asarray(want, np.float32), got.float().numpy()
    assert got.dtype == tq.dtype and a.shape == b.shape
    if dtype == "float32":
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    else:
        assert (np.abs(a - b) <= 2.0 ** -7 * np.abs(a) + 1e-6).all()


def test_fp8_kernel_checks():
    """The launch checks take e4m3 pools only with float32 scales of
    shape [NB,bs,KH,1], and q in float32 or bf16."""
    q = torch.zeros((2, 1, 4, 64), dtype=torch.bfloat16)
    ck = torch.zeros((8, 16, 2, 64), dtype=fp8.E4M3)
    sc = torch.ones((8, 16, 2, 1))
    bt = torch.zeros((2, 4), dtype=torch.int32)
    assert pk._check(q, ck, ck, bt, sc, sc) == (2, 1, 4, 64, 16, 2, 4)
    with pytest.raises(TypeError):                  # e4m3 without scales
        pk._check(q, ck, ck, bt)
    with pytest.raises(TypeError):                  # one scale only
        pk._check(q, ck, ck, bt, sc, None)
    with pytest.raises(TypeError):                  # scale shape
        pk._check(q, ck, ck, bt, sc[..., 0], sc[..., 0])
    with pytest.raises(TypeError):                  # scale dtype
        pk._check(q, ck, ck, bt, sc.bfloat16(), sc.bfloat16())
    with pytest.raises(TypeError):                  # q dtype
        pk._check(q.half(), ck, ck, bt, sc, sc)
    with pytest.raises(TypeError):                  # bf16 pools with scales
        pk._check(q, ck.bfloat16(), ck.bfloat16(), bt, sc, sc)


def test_fp8_cache_layout_and_cow_copy_carries_scales():
    ref_cfg, cfg = ref_reduced_config("yi-6b"), reduced_config("yi-6b")
    want = ref_api.init_cache(ref_cfg, 2, 16, paged=True, block_size=4,
                              num_blocks=6, fp8_kv=True)
    got = api.init_cache(cfg, 2, 16, block_size=4, num_blocks=6,
                         device="cpu", fp8_kv=True)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        _same(want[k], got[k])
    rng = np.random.default_rng(17)
    filled = {k: np.asarray(v) for k, v in want.items()}
    for k in ("k", "v"):
        filled[k] = rng.standard_normal(filled[k].shape).astype(
            ml_dtypes.float8_e4m3fn)
    for k in ("k_scale", "v_scale"):
        filled[k] = rng.uniform(0.01, 1, filled[k].shape).astype(np.float32)
    want = ref_api.cow_copy_block(ref_cfg, jax.tree_util.tree_map(
        jnp.asarray, filled), 4, 1)
    got = api.cow_copy_block(cfg, {k: to_torch(v) for k, v in
                                   filled.items()}, 4, 1)
    for k in want:
        _same(want[k], got[k])
    assert np.array_equal(np.asarray(got["k_scale"][:, 1]),
                          filled["k_scale"][:, 4])
