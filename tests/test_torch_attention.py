"""Port vs reference: paged KV pool and paged attention.

* `update_paged_cache` / `gather_paged_cache` / `copy_paged_block` move
  data without arithmetic, so pools and views must be EQUAL to the
  reference's (-1 tails, writes past the table, ragged positions).
* The plain versions of the two kernels (`paged_decode_plain`,
  `paged_chunk_plain`) against the Pallas kernels `paged_decode` /
  `paged_chunk` run in interpret mode, as tests/test_paged_kernel.py
  runs them, over its CASES, ragged frontiers and poisoned blocks.
  Tolerances: float32 1e-5 (both sum the same float32 products in
  another order); bf16 outputs 2**-7 relative + 1e-6, one bf16 step
  (p and the output are rounded to bf16 on both sides).
The CUDA kernels themselves are held against the plain versions on
the card in tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.kernels import paged_attention as ref_pk
from repro.models import attention as ref_attn
from repro_torch.kernels import paged_attention as pk
from repro_torch.models import attention
from repro_torch.models.convert import to_torch

CASES = [       # tests/test_paged_kernel.py CASES
    # dtype      B  H  KH  hd  NB  bs  MB seed
    ("float32",  3, 4, 2, 32, 24,  8,  6, 0),    # G=2
    ("bfloat16", 3, 4, 2, 32, 24,  8,  6, 1),
    ("float32",  2, 6, 6, 16, 17,  4,  8, 3),    # G=1 matvec, small bs
    ("bfloat16", 4, 8, 2, 64, 32, 16,  4, 5),    # G=4, large bs
    ("float32",  6, 8, 4, 64, 40, 16,  5, 7),
]


def _close(want, got, dtype):
    a = np.asarray(want, np.float32)
    b = got.float().numpy()
    assert a.shape == b.shape
    if dtype == "float32":
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    else:
        assert (np.abs(a - b) <= 2.0 ** -7 * np.abs(a) + 1e-6).all(), \
            np.abs(a - b).max()


def _mk(dtype, B, H, KH, hd, NB, bs, MB, seed, kv_lens=None, C=1):
    """numpy pool + table with -1 tails + ragged kv_len (the reference
    test's generator), as (jax, torch) pairs."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, C, H, hd)).astype(np.float32)
    ck = rng.standard_normal((NB, bs, KH, hd)).astype(np.float32)
    cv = rng.standard_normal((NB, bs, KH, hd)).astype(np.float32)
    T = MB * bs
    if kv_lens is None:
        kv_lens = [1, bs + bs // 2 + 1, T, T // 2 + 1, bs, 2 * bs - 1]
    kv_len = np.minimum(np.asarray(kv_lens[:B]), T).astype(np.int32)
    bt = rng.permutation(NB)[:B * MB].reshape(B, MB).astype(np.int32)
    for b in range(B):
        bt[b, -(-int(kv_len[b]) // bs):] = -1
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx = [jnp.asarray(a, jd) for a in (q, ck, cv)]
    tx = [to_torch(np.asarray(a)) for a in jx]
    return jx, tx, bt, kv_len


@jax.jit
def _ref_decode(q, ck, cv, bt, kv_len):
    return ref_pk.paged_decode(q, ck, cv, bt, kv_len)


@jax.jit
def _ref_chunk(q, ck, cv, bt, pos):
    return ref_pk.paged_chunk(q, ck, cv, bt, pos)


@jax.jit
def _ref_gather_decode(q, ck, cv, bt, kv_len):
    kg, vg = ref_attn.gather_paged_cache(ck, cv, bt)
    return ref_attn.decode_attention(q, kg, vg, kv_len)


# ----------------------------------------------------------------------
# pool writes and reads: equal
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_paged_cache_equal(dtype):
    """-1 tails, a write running past the table, ragged pos: the pool
    after the scatter is equal to the reference's; dropped rows land
    nowhere."""
    B, KH, hd, NB, bs, MB, C = 4, 2, 16, 20, 4, 3, 6
    rng = np.random.default_rng(11)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ck0 = jnp.asarray(rng.standard_normal((NB, bs, KH, hd)), jd)
    cv0 = jnp.asarray(rng.standard_normal((NB, bs, KH, hd)), jd)
    k1 = jnp.asarray(rng.standard_normal((B, C, KH, hd)), jd)
    v1 = jnp.asarray(rng.standard_normal((B, C, KH, hd)), jd)
    bt = rng.permutation(NB)[:B * MB].reshape(B, MB).astype(np.int32)
    bt[0, 1:] = -1              # -1 tail inside the write window
    bt[2, :] = -1               # idle slot: every row dropped
    pos = np.array([2, 9, 0, 5], np.int32)   # slot 1 runs past the table
    want_k, want_v = ref_attn.update_paged_cache(ck0, cv0, k1, v1, pos, bt)
    ck, cv = to_torch(np.asarray(ck0)), to_torch(np.asarray(cv0))
    attention.update_paged_cache(ck, cv, to_torch(np.asarray(k1)),
                                 to_torch(np.asarray(v1)),
                                 torch.from_numpy(pos), torch.from_numpy(bt))
    for want, got in ((want_k, ck), (want_v, cv)):
        assert np.array_equal(np.asarray(want, np.float32),
                              got.float().numpy())


def test_update_paged_cache_all_dropped_and_scalar_pos():
    """A call where no row lands leaves the pool untouched; a scalar
    pos writes every slot at the same frontier."""
    NB, bs, KH, hd = 6, 4, 1, 16
    rng = np.random.default_rng(12)
    ck0 = rng.standard_normal((NB, bs, KH, hd)).astype(np.float32)
    k1 = rng.standard_normal((2, 1, KH, hd)).astype(np.float32)
    ck, cv = torch.from_numpy(ck0.copy()), torch.from_numpy(ck0.copy())
    bt = torch.full((2, 2), -1, dtype=torch.int32)
    attention.update_paged_cache(ck, cv, torch.from_numpy(k1),
                                 torch.from_numpy(k1), 3, bt)
    assert np.array_equal(ck.numpy(), ck0)
    bt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    attention.update_paged_cache(ck, cv, torch.from_numpy(k1),
                                 torch.from_numpy(k1), 5, bt)
    want, _ = ref_attn.update_paged_cache(
        jnp.asarray(ck0), jnp.asarray(ck0), jnp.asarray(k1),
        jnp.asarray(k1), jnp.int32(5), jnp.asarray(bt.numpy()))
    assert np.array_equal(np.asarray(want), ck.numpy())


def test_gather_and_copy_block_equal():
    NB, bs, KH, hd, B, MB = 10, 4, 2, 16, 3, 3
    rng = np.random.default_rng(13)
    ck0 = rng.standard_normal((2, NB, bs, KH, hd)).astype(np.float32)
    cv0 = rng.standard_normal((2, NB, bs, KH, hd)).astype(np.float32)
    bt = rng.permutation(NB)[:B * MB].reshape(B, MB).astype(np.int32)
    bt[1, 2] = -1
    kg, vg = ref_attn.gather_paged_cache(jnp.asarray(ck0[0]),
                                         jnp.asarray(cv0[0]), bt)
    tkg, tvg = attention.gather_paged_cache(
        torch.from_numpy(ck0[0]), torch.from_numpy(cv0[0]),
        torch.from_numpy(bt))
    assert np.array_equal(np.asarray(kg), tkg.numpy())
    assert np.array_equal(np.asarray(vg), tvg.numpy())
    wk, wv = ref_attn.copy_paged_block(jnp.asarray(ck0), jnp.asarray(cv0),
                                       jnp.int32(7), jnp.int32(2))
    ck, cv = torch.from_numpy(ck0.copy()), torch.from_numpy(cv0.copy())
    attention.copy_paged_block(ck, cv, 7, 2)
    assert np.array_equal(np.asarray(wk), ck.numpy())
    assert np.array_equal(np.asarray(wv), cv.numpy())


def test_init_paged_kv_cache_layout():
    want = ref_attn.init_paged_kv_cache(5, 4, 2, 16, layers=3)
    got = attention.init_paged_kv_cache(5, 4, 2, 16, layers=3)
    for k in ("k", "v"):
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == torch.bfloat16
        assert not got[k].any()


# ----------------------------------------------------------------------
# plain versions against the Pallas kernels (interpret mode)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype,B,H,KH,hd,NB,bs,MB,seed", CASES)
def test_decode_plain_vs_pallas(dtype, B, H, KH, hd, NB, bs, MB, seed):
    (q, ck, cv), (tq, tck, tcv), bt, kv_len = _mk(dtype, B, H, KH, hd, NB,
                                                  bs, MB, seed)
    n0 = pk.paged_decode.launches
    got = pk.paged_decode(tq, tck, tcv, torch.from_numpy(bt),
                          torch.from_numpy(kv_len))
    _close(_ref_decode(q, ck, cv, bt, kv_len), got, dtype)
    assert pk.paged_decode.launches == n0     # CPU: plain version


@pytest.mark.parametrize("dtype,B,H,KH,hd,NB,bs,MB,seed", CASES)
def test_chunk_plain_vs_pallas(dtype, B, H, KH, hd, NB, bs, MB, seed):
    C = 4
    (q, ck, cv), (tq, tck, tcv), bt, kv_len = _mk(
        dtype, B, H, KH, hd, NB, bs, MB, seed, C=C)
    pos = np.maximum(kv_len - C, 0).astype(np.int32)
    got = pk.paged_chunk(tq, tck, tcv, torch.from_numpy(bt),
                         torch.from_numpy(pos))
    _close(_ref_chunk(q, ck, cv, bt, pos), got, dtype)


def test_g1_float32_against_both_reference_sides():
    """The reference's own G=1 float32 decode case differs bitwise
    between its Pallas kernel and its gather oracle; the port is held
    to tolerance against both."""
    (q, ck, cv), (tq, tck, tcv), bt, kv_len = _mk("float32", 2, 6, 6, 16,
                                                  17, 4, 8, 3)
    got = pk.paged_decode_plain(tq, tck, tcv, torch.from_numpy(bt),
                                torch.from_numpy(kv_len))
    _close(_ref_decode(q, ck, cv, bt, kv_len), got, "float32")
    _close(_ref_gather_decode(q, ck, cv, bt, kv_len), got, "float32")


@pytest.mark.parametrize("kv", [1, 7, 8, 9, 47, 48])
def test_decode_ragged_frontiers(kv):
    (q, ck, cv), (tq, tck, tcv), bt, kv_len = _mk(
        "float32", 2, 4, 2, 32, 24, 8, 6, 11, kv_lens=[kv, 48])
    got = pk.paged_decode(tq, tck, tcv, torch.from_numpy(bt),
                          torch.from_numpy(kv_len))
    _close(_ref_decode(q, ck, cv, bt, kv_len), got, "float32")


@pytest.mark.parametrize("poison", [1e30, float("nan")])
def test_poisoned_unallocated_block_never_leaks(poison):
    """Block 0, reachable only through -1 entries (clamped to 0), is
    filled with huge or NaN values: the port's output equals the
    clean-pool output, decode and chunk."""
    (q, ck, cv), (tq, tck, tcv), bt, kv_len = _mk(
        "float32", 3, 4, 2, 32, 24, 8, 6, 19, kv_lens=[5, 20, 33], C=1)
    free = [i for i in range(24) if i not in set(bt.ravel())]
    bt[bt == 0] = free.pop()
    tbt, tlen = torch.from_numpy(bt), torch.from_numpy(kv_len)
    clean = pk.paged_decode(tq, tck, tcv, tbt, tlen)
    pck, pcv = tck.clone(), tcv.clone()
    pck[0] = poison
    pcv[0] = poison
    got = pk.paged_decode(tq, pck, pcv, tbt, tlen)
    assert torch.isfinite(got).all()
    assert torch.equal(got, clean)
    _close(_ref_decode(q, ck, cv, bt, kv_len), got, "float32")
    C = 2
    tqc = torch.randn((3, C, 4, 32), generator=torch.Generator().manual_seed(0))
    pos = torch.clamp(tlen - C, min=0)
    assert torch.equal(pk.paged_chunk(tqc, pck, pcv, tbt, pos),
                       pk.paged_chunk(tqc, tck, tcv, tbt, pos))


def test_kernel_checks_raise_on_what_it_does_not_take():
    """The launch checks (run before any CUDA call) refuse head dims
    without an instantiation, mixed dtypes and tables past the
    shared-memory limit."""
    q = torch.zeros((2, 1, 4, 48))
    ck = torch.zeros((8, 16, 2, 48))
    bt = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim"):
        pk._check(q, ck, ck, bt)
    q, ck = torch.zeros((2, 1, 4, 64)), torch.zeros((8, 16, 2, 64))
    with pytest.raises(TypeError):
        pk._check(q, ck.bfloat16(), ck.bfloat16(), bt)
    with pytest.raises(TypeError):
        pk._check(q, ck, ck, bt.long())
    big = torch.zeros((2, 10000), dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        pk._check(q, ck, ck, big)
    assert pk._check(q, ck, ck, bt) == (2, 1, 4, 64, 16, 2, 4)
    # yi-6b at max_len 264: G=8, 17 blocks of 16 fit
    assert pk.smem_bytes(8, 128, 17, 16) <= pk.SMEM_LIMIT


def test_reduced_config_shapes_fit_kernel():
    """The reduced yi-6b config the CPU tests serve has a head_dim the
    kernel is instantiated for, so the same path runs on the card."""
    assert ref_reduced_config("yi-6b").head_dim in pk.HEAD_DIMS
