"""The port's sample head (models/sampling.py) against the reference's
(repro/models/sampling.py), on the CPU.

The bar:

* `SamplingParams` validates and prints as the reference's;
* the key path is integer-exact: PRNGKey / fold_in key words and the
  32 random bits of every vocab entry equal ``jax.random``'s, and so
  does the uniform draw (its bits);
* the Gumbel noise -log(-log(u)) is within GUMBEL_ULPS units of
  max(ulp(g), ulp(1)) of JAX's: the logarithms are torch's, not XLA's;
* greedy rows of `sample_tokens` equal the reference's exactly; a
  sampled row equals it too, unless the reference's own draw is
  ambiguous to within those roundings: the top two of z + g lie within
  NOISE_TOL (two noise roundings, and the float32 rounding of z + g at
  its magnitude), or the top-p cut, csum - p against top_p, lies within
  TOP_P_TOL (softmax and cumulative sums taken in another order).  The
  test counts such rows and reports them;
* `ks_two_sample` equals the reference's.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import api as ref_api
from repro.models import sampling as ref_sampling
from repro_torch.models import api, sampling

GUMBEL_ULPS = 2
EPS32 = float(np.finfo(np.float32).eps)
# z + g rounds at its own magnitude; g itself is within GUMBEL_ULPS
NOISE_TOL_ULPS = 2 * GUMBEL_ULPS + 2
# |csum - p - top_p| within this of 0 may cut the nucleus either way
TOP_P_TOL = 64 * EPS32

SEEDS = (0, 1, 2 ** 31 - 1, 7919, -3)
# emission positions the server uses (pos + n_tokens, pos + 1,
# pos + 1 + j) for short and long contexts, and the int32 extremes
INDICES = (0, 1, 5, 17, 63, 264, 4096, 32768, 2 ** 31 - 1)


def _ref_key(seed, index):
    return jax.random.fold_in(jax.random.PRNGKey(jnp.int32(seed)),
                              jnp.int32(index))


def _port_key(seed, index):
    return sampling.fold_in(
        sampling.prng_key(torch.tensor([seed], dtype=torch.int32)),
        torch.tensor([index], dtype=torch.int32))


@pytest.mark.parametrize("kw", [
    dict(), dict(temperature=0.7), dict(temperature=1.0, top_k=1),
    dict(temperature=0.5, top_k=40, seed=3),
    dict(temperature=1.3, top_p=0.9, seed=2 ** 31 - 1),
    dict(temperature=0.25, top_k=5, top_p=0.5, seed=-7),
    dict(temperature=0.0, top_k=3, top_p=0.2)])
def test_sampling_params_match_reference(kw):
    a, b = sampling.SamplingParams(**kw), ref_sampling.SamplingParams(**kw)
    assert str(a) == str(b)
    assert a.is_greedy == b.is_greedy
    assert dataclasses.astuple(a) == dataclasses.astuple(b)


@pytest.mark.parametrize("kw", [dict(temperature=-0.1), dict(top_p=0.0),
                                dict(top_p=1.5), dict(top_k=-1)])
def test_sampling_params_validation_matches_reference(kw):
    with pytest.raises(ValueError) as got:
        sampling.SamplingParams(**kw)
    with pytest.raises(ValueError) as want:
        ref_sampling.SamplingParams(**kw)
    assert str(got.value) == str(want.value)
    assert sampling.GREEDY == sampling.SamplingParams()
    assert str(sampling.GREEDY) == str(ref_sampling.GREEDY) == "greedy"


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_keys_and_bits_equal_jax(seed):
    """Key words, random bits and uniform draws are integer-exact; the
    Gumbel noise is within GUMBEL_ULPS of max(ulp(g), ulp(1))."""
    V = 1001                          # odd: the hash's padding case
    for index in INDICES:
        k = _ref_key(seed, index)
        kd = np.asarray(jax.random.key_data(k)).astype(np.int64)
        pk = _port_key(seed, index)
        assert [int(pk[0][0]), int(pk[1][0])] == kd.tolist(), (seed, index)
        bits = np.asarray(jax.random.bits(k, (V,), jnp.uint32))
        np.testing.assert_array_equal(
            sampling.random_bits(pk, V)[0].numpy(), bits.astype(np.int64))
        u = np.asarray(jax.random.uniform(
            k, (V,), jnp.float32, minval=np.finfo(np.float32).tiny,
            maxval=1.0))
        got_u = sampling.uniform_tiny(pk, V)[0].numpy()
        np.testing.assert_array_equal(got_u.view(np.uint32),
                                      u.view(np.uint32))
        g = np.asarray(jax.random.gumbel(k, (V,), jnp.float32))
        got_g = sampling.gumbel(pk, V)[0].numpy()
        unit = np.maximum(np.spacing(np.abs(g)), np.spacing(np.float32(1)))
        assert (np.abs(got_g - g) <= GUMBEL_ULPS * unit).all(), (seed, index)


def test_vectorized_keys_equal_per_row_keys():
    seeds = torch.tensor(SEEDS, dtype=torch.int32)
    idx = torch.tensor(INDICES[:len(SEEDS)], dtype=torch.int32)
    k = sampling.fold_in(sampling.prng_key(seeds), idx)
    for i, (s, q) in enumerate(zip(SEEDS, INDICES)):
        kd = np.asarray(jax.random.key_data(_ref_key(s, q)))
        assert [int(k[0][i]), int(k[1][i])] == kd.astype(np.int64).tolist()


def _ref_noisy(logits, temp, top_k, top_p, seed, index):
    """The reference's z + g and top-p cut margin for one row, from its
    own formulas (float32 z, JAX's noise): returns (top-2 gap of z + g,
    its magnitude, min |csum - p - top_p| or inf)."""
    x = np.asarray(logits, np.float32)
    V = x.shape[-1]
    z = x / np.float32(temp if temp > 0 else 1.0)
    if 0 < top_k < V:
        kth = np.sort(z)[::-1][top_k - 1]
        z = np.where(z >= kth, z, -np.inf).astype(np.float32)
    cut = math.inf
    if top_p < 1.0:
        e = np.exp(z.astype(np.float64) - z.max())
        p = e / e.sum()
        order = np.argsort(-p, kind="stable")
        csum = np.cumsum(p[order])
        cut = float(np.abs(csum - p[order] - top_p).min())
        keep = np.zeros(V, bool)
        keep[order] = (csum - p[order]) < top_p
        z = np.where(keep, z, -np.inf).astype(np.float32)
    g = np.asarray(jax.random.gumbel(_ref_key(seed, index), (V,),
                                     jnp.float32))
    s = np.sort((z + g)[np.isfinite(z)])
    return float(s[-1] - s[-2]) if s.size > 1 else math.inf, \
        float(abs(s[-1])), cut


def _logits(rng, shape, dtype):
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x[..., 7] = x[..., 3]                     # a tie: first index wins
    jx = jnp.asarray(x)
    tx = torch.from_numpy(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    return jx, tx


# per row: temperature, top_k, top_p (greedy rows first)
ROWS = [(0.0, 0, 1.0), (1.0, 1, 1.0), (0.0, 5, 0.5), (1.0, 0, 1.0),
        (0.5, 0, 1.0), (1.3, 20, 1.0), (0.7, 0, 0.9), (1.0, 8, 0.5),
        (2.0, 256, 0.95), (0.8, 3, 0.3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["BV", "BCV"])
def test_sample_tokens_match_reference(dtype, layout):
    rng = np.random.default_rng(0 if layout == "BV" else 1)
    B, C, V = len(ROWS), 3, 256
    temp = np.array([r[0] for r in ROWS], np.float32)
    top_k = np.array([r[1] for r in ROWS], np.int32)
    top_p = np.array([r[2] for r in ROWS], np.float32)
    ambiguous = rows = 0
    for trial in range(4):
        seed = rng.integers(-2 ** 31, 2 ** 31, B).astype(np.int32)
        shape = (B, V) if layout == "BV" else (B, C, V)
        index = rng.integers(0, 70000, shape[:-1]).astype(np.int32)
        jx, tx = _logits(rng, shape, dtype)
        want = np.asarray(ref_sampling.sample_tokens(
            jx, jnp.asarray(temp), jnp.asarray(top_k), jnp.asarray(top_p),
            jnp.asarray(seed), jnp.asarray(index)))
        got = sampling.sample_tokens(
            tx, torch.from_numpy(temp), torch.from_numpy(top_k),
            torch.from_numpy(top_p), torch.from_numpy(seed),
            torch.from_numpy(index))
        assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
        got = got.numpy()
        lg = np.asarray(jx.astype(jnp.float32)).reshape(B, -1, V)
        for b in range(B):
            for c in range(lg.shape[1]):
                rows += 1
                w, t = want.reshape(B, -1)[b, c], got.reshape(B, -1)[b, c]
                if temp[b] <= 0 or top_k[b] == 1:
                    assert t == w == lg[b, c].argmax(), (b, c)
                    continue
                if t == w:
                    continue
                gap, mag, cut = _ref_noisy(
                    lg[b, c], temp[b], int(top_k[b]), top_p[b], seed[b],
                    index.reshape(B, -1)[b, c])
                tol = NOISE_TOL_ULPS * EPS32 * max(1.0, mag)
                assert gap <= tol or cut <= TOP_P_TOL, (b, c, gap, cut)
                ambiguous += 1
    print(f"{layout} {dtype}: {ambiguous}/{rows} rows drew another token "
          "where the reference's draw is ambiguous within the tolerance")


def test_draw_margins_match_the_reference_noise():
    """`sampling.draw_margins` (the margin chip_smoke.py and the card
    tests allow a parting draw) equals the reference-side margins
    computed with JAX's own noise, within the noise's rounding."""
    rng = np.random.default_rng(7)
    V = 256
    for temp, top_k, top_p in ROWS:
        seed = int(rng.integers(-2 ** 31, 2 ** 31))
        index = int(rng.integers(0, 70000))
        lg = (rng.standard_normal(V) * 3).astype(np.float32)
        sp = sampling.SamplingParams(float(temp), top_k, float(top_p), seed)
        gap, mag, kgap, cut = sampling.draw_margins(torch.from_numpy(lg),
                                                    sp, index)
        if sp.is_greedy:
            top = np.sort(lg)
            assert (gap, mag) == (float(top[-1] - top[-2]),
                                  float(abs(top[-1])))
            continue
        want_gap, want_mag, want_cut = _ref_noisy(lg, temp, top_k, top_p,
                                                  seed, index)
        tol = NOISE_TOL_ULPS * EPS32 * max(1.0, want_mag)
        assert gap == want_gap or abs(gap - want_gap) <= tol
        assert abs(mag - want_mag) <= tol
        assert cut == want_cut or abs(cut - want_cut) <= 1e-12
        z = np.sort(lg / np.float32(temp))[::-1]
        assert kgap == (float(z[top_k - 1] - z[top_k]) if 0 < top_k < V
                        else math.inf)


def test_greedy_is_the_argmax_by_value():
    """temperature 0 or top_k 1 returns the argmax of the original-dtype
    logits whatever the seed and top_p, in one call with sampled rows."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 300)).astype(np.float32))
    x = x.to(torch.bfloat16)
    got = sampling.sample_tokens(
        x, torch.tensor([0.0, 1.0, 0.0, 2.0]),
        torch.tensor([0, 1, 7, 0], dtype=torch.int32),
        torch.tensor([1.0, 0.5, 0.1, 1.0]),
        torch.tensor([1, 2, 3, 4], dtype=torch.int32),
        torch.tensor([9, 9, 9, 9], dtype=torch.int32))
    assert torch.equal(got[:3], x[:3].argmax(-1).to(torch.int32))


@pytest.mark.parametrize("a,b", [
    ([], [1.0]), ([1, 2, 3], [1, 2, 3]), ([0, 1, 2, 3, 4], [5, 6, 7, 8]),
    (list(range(100)), list(range(50, 150))),
    (np.random.default_rng(0).normal(size=400),
     np.random.default_rng(1).normal(size=300))])
def test_ks_two_sample_matches_reference(a, b):
    got, want = sampling.ks_two_sample(a, b), ref_sampling.ks_two_sample(a, b)
    if math.isnan(want[0]):
        assert all(math.isnan(v) for v in got)
    else:
        assert got == want


def test_api_reexports_the_sample_head():
    assert api.GREEDY is sampling.GREEDY
    assert api.SamplingParams is sampling.SamplingParams
    assert api.sample_tokens is sampling.sample_tokens
    assert api.ks_two_sample is sampling.ks_two_sample
    assert {"GREEDY", "SamplingParams", "ks_two_sample",
            "sample_tokens"} <= set(dir(ref_api))
