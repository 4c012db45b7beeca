"""Port vs reference: flash attention, forward and backward.

* `repro_torch.models.attention.flash_attention` (a torch autograd
  function: the blockwise forward, on the CPU its plain version in the
  reference's block and pair order, and the port of the reference's
  blockwise backward) against `jax.vjp` of
  `repro.models.attention.flash_attention` on the same numpy inputs and
  output cotangent.  float32: outputs within 1e-5, lse rows within
  1e-5, gradients within 1e-4 (both sum the same float32 products, in
  another order).  bf16: outputs within one bf16 step of max |o|
  (2**-7 * max|o|: p and o are rounded to bf16 on both sides, and a
  value on a rounding boundary may round the other way), gradients
  within 2**-5 of each one's max |g| (the backward reads the bf16
  output, and its float32 sums end in one bf16 rounding).
* `repro_torch.kernels.ops.flash_attention` (plain on the CPU) against
  `repro.kernels.ops.flash_attention`, the Pallas kernel B9 in interpret
  mode, on the cases of tests/test_kernels.py at its tolerances and at
  head_dim 80, and the tile policy (oversize tile raises, decode-length
  auto tile).
* The body rule of the CUDA kernel (`flash_attention.body`) over a
  table of dtypes and head dims.
The CUDA kernel itself is held against the plain version on the card
in tests/test_torch_gpu.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kernels
from repro.models import attention as ref_attn
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops
from repro_torch.models import attention

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# name: B, Sq, Sk, H, KH, hd, causal, window, q_offset, q_chunk, kv_chunk
CASES = {
    "causal_pairs_G2": (2, 64, 64, 4, 2, 16, True, 0, 0, 16, 16),
    "causal_pairs_G4": (1, 48, 48, 8, 2, 32, True, 0, 0, 16, 16),
    "causal_G1_one_block": (1, 32, 32, 4, 4, 16, True, 0, 0, 32, 32),
    "noncausal_G4": (2, 40, 40, 4, 1, 16, False, 0, 0, 16, 16),
    "window": (1, 64, 64, 4, 2, 16, True, 20, 0, 16, 16),
    "q_offset": (2, 24, 56, 4, 2, 16, True, 0, 32, 8, 16),
    "ragged": (1, 50, 50, 4, 2, 16, True, 0, 0, 16, 16),
    "no_valid_key_rows": (1, 12, 20, 4, 2, 16, False, 4, 24, 8, 8),
    # head_dim 80 (the kernel's mma_sync and fma bodies take it)
    "hd80_causal_G2": (1, 40, 40, 4, 2, 80, True, 0, 0, 16, 16),
    "hd80_window_q_offset": (2, 24, 56, 4, 2, 80, True, 12, 32, 8, 16),
    "hd80_no_valid_key_rows": (1, 12, 20, 2, 1, 80, False, 4, 24, 8, 8),
}


def _inputs(B, Sq, Sk, H, KH, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KH, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KH, hd)).astype(np.float32),
            rng.standard_normal((B, Sq, H, hd)).astype(np.float32))


def _to(x, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _close(want, got, dtype, kind):
    a = np.asarray(want, np.float32)
    b = got.detach().float().numpy()
    assert a.shape == b.shape
    if dtype == "float32":
        tol = 1e-5 if kind == "o" else 1e-4
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol)
    else:
        steps = 2.0 ** -7 if kind == "o" else 2.0 ** -5
        err = np.abs(a - b).max()
        assert err <= steps * np.abs(a).max(), (kind, err, np.abs(a).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attention_vs_reference(name, dtype):
    B, Sq, Sk, H, KH, hd, causal, window, q_offset, qc, kc = CASES[name]
    q, k, v, g = _inputs(B, Sq, Sk, H, KH, hd, seed=len(name))
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = (_to(x, dtype)
                                              for x in (q, k, v, g))
    kw = dict(causal=causal, window=window, q_offset=q_offset)

    def ref_fn(q, k, v):
        return ref_attn.flash_attention(q, k, v, q_chunk=qc, kv_chunk=kc,
                                        **kw)

    @jax.jit
    def ref_fwd_bwd(q, k, v, g):
        o, vjp = jax.vjp(ref_fn, q, k, v)
        return o, vjp(g)

    jo, jgrads = ref_fwd_bwd(jq, jk, jv, jg)
    tq, tk, tv = (x.requires_grad_() for x in (tq, tk, tv))
    to = attention.flash_attention(tq, tk, tv, q_chunk=qc, kv_chunk=kc, **kw)
    assert to.dtype == tq.dtype
    _close(jo, to, dtype, "o")
    tgrads = torch.autograd.grad(to, (tq, tk, tv), tg)
    for want, got in zip(jgrads, tgrads):
        assert got.dtype == tq.dtype
        _close(want, got, dtype, "grad")


@pytest.mark.parametrize("name", ["causal_pairs_G2", "window", "q_offset",
                                  "no_valid_key_rows"])
def test_lse_rows_vs_reference(name):
    """The log-sum-exp rows the backward reads, float32 within 1e-5."""
    B, Sq, Sk, H, KH, hd, causal, window, q_offset, qc, kc = CASES[name]
    q, k, v, _ = _inputs(B, Sq, Sk, H, KH, hd, seed=len(name))
    _, jlse = ref_attn._attn_fwd(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal, window, qc, kc,
                                 q_offset)
    o, rows = kfa.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, q_offset=q_offset, q_chunk=qc,
        kv_chunk=kc)
    assert rows.shape == (B, H, Sq) and rows.dtype == torch.float32
    want = attention.lse_rows(torch.from_numpy(np.array(jlse)), Sq)
    np.testing.assert_allclose(rows.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    # the chunked layout round-trips the real rows exactly
    back = attention.lse_chunks(rows, KH, qc)
    assert torch.equal(attention.lse_rows(back, Sq), rows)


RNG_CASES = [                                  # tests/test_kernels.py:58-63
    (2, 128, 8, 2, 32, True),
    (1, 128, 4, 4, 64, True),
    (2, 256, 8, 1, 32, False),
    (1, 64, 6, 3, 16, True),
]


@pytest.mark.parametrize("B,S,H,KH,hd,causal", RNG_CASES)
def test_ops_flash_attention_vs_pallas(B, S, H, KH, hd, causal):
    q, k, v, _ = _inputs(B, S, S, H, KH, hd, seed=S + H)
    want = ref_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal, bq=64,
                                   bk=64)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal, bq=64,
                              bk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # the plain blockwise forward, the kernel's plain version, too
    fwd, _ = kfa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(fwd.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("B,S,H,KH,causal", [(1, 128, 4, 2, True),
                                               (2, 64, 4, 4, False)])
def test_flash_attention_hd80_vs_pallas(B, S, H, KH, causal):
    """head_dim 80: the port's ops.flash_attention and B9's plain forward
    (which the card's wrapper replaces) against the Pallas kernel in
    interpret mode, at the reference's kernel-test tolerance."""
    q, k, v, _ = _inputs(B, S, S, H, KH, 80, seed=80 + S)
    want = ref_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal, bq=64,
                                   bk=64)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal, bq=64,
                              bk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    fwd, _ = kfa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(fwd.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_ops_flash_attention_bf16_vs_pallas():
    B, S, H, KH, hd = 1, 128, 4, 2, 32
    q, k, v, _ = _inputs(B, S, S, H, KH, hd, seed=11)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    want = ref_ops.flash_attention(*jb, causal=True, bq=64, bk=64)
    got = ops.flash_attention(*tb, causal=True, bq=64, bk=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)


def test_ops_flash_attention_tile_policy():
    B, S, H, KH, hd = 1, 32, 4, 2, 16
    q, k, v, _ = _inputs(B, S, S, H, KH, hd, seed=5)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    with pytest.raises(ValueError, match="exceeds the operand"):
        ops.flash_attention(tq, tk, tv, bq=128)            # bq > S
    with pytest.raises(ValueError, match="exceeds the operand"):
        ops.flash_attention(tq, tk, tv, bk=64)             # bk > S
    with pytest.raises(ValueError, match="do not divide"), \
            pytest.warns(ops.TileAlignmentWarning):
        ops.flash_attention(tq, tk, tv, bq=24)
    with pytest.warns(ops.TileAlignmentWarning):
        ops.flash_attention(tq, tk, tv, bq=8)
    # decode-length S < 128: an S-sized auto tile, no error, right answer
    S = 16
    q, k, v, _ = _inputs(2, S, S, H, KH, 32, seed=6)
    got = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    want = ref_kernels.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


BODY_TABLE = [      # dtype, head_dim, body (csrc/flash_attention.cu's rule)
    (torch.bfloat16, 16, "mma_sync"),
    (torch.bfloat16, 32, "mma_sync"),
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 80, "mma_sync"),
    (torch.bfloat16, 128, "wgmma"),
    (torch.float32, 16, "fma"),
    (torch.float32, 64, "fma"),
    (torch.float32, 80, "fma"),
    (torch.float32, 128, "fma"),
]


@pytest.mark.parametrize("dtype,hd,want", BODY_TABLE)
def test_flash_attention_body_rule(dtype, hd, want):
    """The body B9 runs: wgmma for bf16 at head_dim 64 and 128 (whole
    128-byte TMA box rows), mma_sync for bf16 at 16, 32 and 80, fma for
    float32 (tests/test_torch_gpu.py holds the source to this table)."""
    assert hd in kfa.HEAD_DIMS
    assert kfa.body(dtype, hd) == want
    assert want in kfa.BODIES


def test_flash_attention_body_counts_start_at_zero():
    kfa.reset_launch_counts()
    assert kfa.body_launches() == dict.fromkeys(kfa.BODIES, 0)
    assert kfa.launch_counts() == {"flash_attention": 0}
    # the plain path on the CPU launches nothing
    q = torch.zeros((1, 8, 2, 80))
    kfa.flash_attention_fwd(q, q, q)
    assert sum(kfa.body_launches().values()) == 0


def test_kernel_wrapper_checks_operands():
    """What the card would refuse is refused before a launch, on any
    device (the CPU runs the plain version only for CPU tensors)."""
    q = torch.zeros((1, 8, 4, 24))
    k = torch.zeros((1, 8, 2, 24))
    with pytest.raises(ValueError, match="head_dim"):
        kfa._check(q, k, k)
    with pytest.raises(ValueError, match="head_dim"):
        kfa._check(torch.zeros((1, 8, 4, 96)), torch.zeros((1, 8, 2, 96)),
                   torch.zeros((1, 8, 2, 96)))
    kfa._check(torch.zeros((1, 8, 4, 80)), torch.zeros((1, 8, 2, 80)),
               torch.zeros((1, 8, 2, 80)))
    with pytest.raises(ValueError, match="do not match"):
        kfa._check(q, torch.zeros((1, 8, 3, 24)), torch.zeros((1, 8, 3, 24)))
    with pytest.raises(TypeError, match="dtypes"):
        kfa._check(q.half()[..., :16], k.half()[..., :16],
                   k.half()[..., :16])


def test_more_than_65535_query_heads():
    """B*H = 65536 query heads: the wrapper's checks take them (the
    kernel spreads b*H + h over grid.y and grid.z), and the forward
    matches the reference oracle."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 2, 65536, 16))).float()
    k = torch.from_numpy(rng.standard_normal((1, 2, 65536, 16))).float()
    v = torch.from_numpy(rng.standard_normal((1, 2, 65536, 16))).float()
    kfa._check(q, k, v)
    o, lse = kfa.flash_attention_fwd(q, k, v, causal=True)
    want = kfa.flash_attention_plain(q, k, v, causal=True)
    np.testing.assert_allclose(o.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 16 ** -0.5
    s = s.masked_fill(torch.ones(2, 2).triu(1).bool(), float("-inf"))
    np.testing.assert_allclose(lse.numpy(), s.logsumexp(-1).numpy(),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        kfa._check(q.expand(2 ** 16, 2, 65536, 16), k.expand(2 ** 16, 2,
                   65536, 16), v.expand(2 ** 16, 2, 65536, 16))
