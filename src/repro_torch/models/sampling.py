"""Stochastic sampling heads for the serving engine.

PyTorch counterpart of ``repro/models/sampling.py``: temperature /
top-k / top-p sampling with per-request seeds, selected per slot by the
operand values so greedy and sampled slots share one code path.

* **Position-keyed noise, as JAX draws it.** The draw for the token
  that will sit at sequence position ``q`` of slot ``b`` uses the key
  ``fold_in(PRNGKey(seed_b), q)`` and the float32 Gumbel noise
  ``gumbel(key, (V,))`` of ``jax.random`` (threefry2x32, with
  ``jax_threefry_partitionable=True``, the default of the JAX the
  reference runs on).  Both are computed here on integer tensors:
  ``PRNGKey(s)`` is the pair ``(0, s mod 2**32)``, ``fold_in(k, q)`` is
  ``threefry2x32(k, (0, q))``, and the 32 random bits of vocab entry
  ``i`` are the xor of the two words of ``threefry2x32(k, (0, i))``.
  uint32 arithmetic runs in int64 with a mask, so the bits are equal to
  JAX's on any device.  The uniform is the mantissa trick of
  ``jax.random.uniform(minval=tiny)`` and ``g = -log(-log(u))``: the
  logarithms are torch's, which may differ from XLA's by an ulp.
* **Greedy by value.** Every call computes the argmax of the
  original-dtype logits and the sampled token, and selects per row
  (``temperature <= 0`` or ``top_k == 1`` is greedy), never by a host
  branch.
* **float32 distribution.** Logits are upcast before temperature
  scaling; the softmax, the top-p cumulative sum and the noise are
  float32.  Top-k keeps the values at or above the k-th largest; top-p
  sorts the probabilities with a stable descending sort, as
  ``jnp.argsort`` is stable.

The draw is gumbel-max: ``argmax(z + g)`` over the masked,
temperature-scaled logits ``z`` is an exact sample from ``softmax(z)``
on the surviving support.

``draw_margins`` says how near one row's draw is to another token
(the margin a check of two roundings of the same logits allows).
``ks_two_sample`` is a scipy-free two-sample Kolmogorov-Smirnov test
(asymptotic p-value, Numerical-Recipes series), used to check the K>0
token distribution of speculative decoding against K=0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_F32_BITS = 0x3F800000
_TINY_F32 = float(np.finfo(np.float32).tiny)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    ``temperature <= 0`` or ``top_k == 1`` selects greedy decoding.
    ``top_k == 0`` means "no top-k truncation"; ``top_p == 1.0`` means
    "no nucleus truncation".  ``seed`` is the per-request RNG seed — two
    requests with the same seed and the same emission positions draw
    the same noise.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {self.temperature}")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0 or self.top_k == 1

    def __str__(self) -> str:
        if self.is_greedy:
            return "greedy"
        parts = [f"t{self.temperature:g}"]
        if self.top_k:
            parts.append(f"k{self.top_k}")
        if self.top_p < 1.0:
            parts.append(f"p{self.top_p:g}")
        parts.append(f"s{self.seed}")
        return ":".join(parts)


GREEDY = SamplingParams()


# ----------------------------------------------------------------------
# jax.random's threefry2x32 key path on int64 tensors holding uint32
# ----------------------------------------------------------------------

def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counts (x0, x1) under
    the key (k0, k1); all int64 tensors holding uint32 values,
    broadcast together.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _MASK32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x0, x1


def prng_key(seed: torch.Tensor):
    """``jax.random.PRNGKey`` of int32 seeds: the key words (0, seed
    mod 2**32), as int64 tensors shaped like `seed`."""
    seed = seed.long() & _MASK32
    return torch.zeros_like(seed), seed


def fold_in(key, data: torch.Tensor):
    """``jax.random.fold_in`` of keys (k0, k1) and integer data
    (taken mod 2**32), elementwise: threefry2x32(key, (0, data))."""
    data = data.long() & _MASK32
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data)


def random_bits(key, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` for keys shaped [...]:
    [..., n] int64 (partitionable layout: entry i hashes the counts
    (0, i), and the bits are the xor of the two output words)."""
    k0, k1 = key[0][..., None], key[1][..., None]
    lo = torch.arange(n, dtype=torch.int64, device=k0.device)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return b0 ^ b1


def uniform_tiny(key, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval=tiny, maxval=1)``:
    the top 23 bits as the mantissa of a float in [1, 2), minus 1, then
    raised to at least the smallest normal."""
    bits = (random_bits(key, n) >> 9) | _ONE_F32_BITS
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # (1 - tiny) rounds to 1.0 in float32: floats * 1.0 + tiny
    return torch.clamp_min(floats + _TINY_F32, _TINY_F32)


def gumbel(key, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (its "low" mode):
    -log(-log(u)), u uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform_tiny(key, n)))


# ----------------------------------------------------------------------
# the sample head
# ----------------------------------------------------------------------

def _sample_rows(logits: torch.Tensor, temp: torch.Tensor,
                 top_k: torch.Tensor, top_p: torch.Tensor,
                 seed: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """`_sample_row` of the reference over N rows at once: logits
    [N, V], every other operand [N].  Returns int32 [N]."""
    V = logits.shape[-1]
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    x = logits.float()
    safe_t = torch.where(temp > 0.0, temp, torch.ones_like(temp))
    z = x / safe_t[:, None]
    # top-k: threshold at the k-th largest scaled logit (ties at the
    # threshold all survive; top_k outside (0, V) disables the mask)
    k_on = (top_k > 0) & (top_k < V)
    sorted_z = torch.sort(z, dim=-1, descending=True).values
    kth = sorted_z.gather(-1, (top_k.long() - 1).clamp(0, V - 1)[:, None])
    keep_k = torch.where(k_on[:, None], z >= kth, True)
    neg_inf = torch.full_like(z, -math.inf)
    z = torch.where(keep_k, z, neg_inf)
    # float32 softmax of the temperature-scaled, top-k-masked logits
    e = torch.exp(z - z.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    # top-p: the smallest prefix of the probability-sorted vocab whose
    # mass reaches top_p (the head of the nucleus always stays); a
    # stable sort of -probs, as jnp.argsort(-probs)
    neg_sorted, order = torch.sort(-probs, dim=-1, stable=True)
    p_sorted = -neg_sorted
    csum = torch.cumsum(p_sorted, dim=-1)
    keep_sorted = (csum - p_sorted) < top_p[:, None]
    keep_p = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    p_on = top_p < 1.0
    z = torch.where(p_on[:, None] & ~keep_p, neg_inf, z)
    # gumbel-max, keyed purely by (seed, position)
    g = gumbel(fold_in(prng_key(seed), index), V)
    sampled = torch.argmax(z + g, dim=-1).to(torch.int32)
    return torch.where((temp <= 0.0) | (top_k == 1), greedy_tok, sampled)


def sample_tokens(logits: torch.Tensor, temp: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor,
                  seed: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Vectorized sample head.

    ``logits`` is ``[B, V]`` (chunk/span heads) or ``[B, C, V]``
    (verify head); ``temp``/``top_p`` are float32 ``[B]``,
    ``top_k``/``seed`` int32 ``[B]``; ``index`` holds the emission
    positions, shaped ``[B]`` or ``[B, C]`` to match.  Returns int32
    tokens shaped like ``index``.
    """
    V = logits.shape[-1]
    shape = index.shape
    if logits.ndim == 3:
        C = logits.shape[1]
        temp, top_k, top_p, seed = (t[:, None].expand(-1, C)
                                    for t in (temp, top_k, top_p, seed))
    return _sample_rows(logits.reshape(-1, V), temp.reshape(-1).float(),
                        top_k.reshape(-1), top_p.reshape(-1).float(),
                        seed.reshape(-1), index.reshape(-1)).reshape(shape)


def draw_margins(logits: torch.Tensor, params: SamplingParams, index: int
                 ) -> Tuple[float, float, float, float]:
    """How near the draw of one row (``logits`` [V]) is to another
    token, for a check that lets two roundings of the logits part
    there: (the top-2 gap of z + g over the support left by the top-k
    and top-p cuts, |max(z + g)|, the gap between the k-th and (k+1)-th
    largest z at the top-k cut, the distance of the top-p cut's ``csum
    - p`` (float64) from ``top_p``), with z = logits / temperature and g
    this module's noise for (seed, index); a cut that is off, or a
    support of one token, gives inf.  Greedy params: the top-2 logit gap and |max
    logit|, no noise, no cuts."""
    x = logits.detach().float().cpu()
    if params.is_greedy:
        top = x.topk(2).values
        return float(top[0] - top[1]), float(top[0].abs()), math.inf, \
            math.inf
    z = x / params.temperature
    kgap = pcut = math.inf
    if 0 < params.top_k < z.shape[-1]:
        desc = z.sort(descending=True).values
        kgap = float(desc[params.top_k - 1] - desc[params.top_k])
        z = torch.where(z >= desc[params.top_k - 1], z,
                        torch.tensor(-math.inf))
    if params.top_p < 1.0:
        p = torch.softmax(z.double(), -1)
        p_sorted, order = torch.sort(-p, stable=True)
        p_sorted = -p_sorted
        before = p_sorted.cumsum(-1) - p_sorted
        pcut = float((before - params.top_p).abs().min())
        keep = torch.zeros_like(p, dtype=torch.bool).scatter(
            -1, order, before < params.top_p)
        z = torch.where(keep, z, torch.tensor(-math.inf))
    key = fold_in(prng_key(torch.tensor([params.seed])),
                  torch.tensor([index]))
    s = (z + gumbel(key, z.shape[-1])[0]).sort().values
    s = s[torch.isfinite(s)]
    gap = float(s[-1] - s[-2]) if s.numel() > 1 else math.inf
    return gap, float(s[-1].abs()), kgap, pcut


def ks_two_sample(a, b):
    """Two-sample Kolmogorov-Smirnov test, scipy-free.

    Returns ``(D, p)`` where ``D`` is the sup-distance between the
    empirical CDFs and ``p`` the asymptotic two-sided p-value via the
    Kolmogorov series ``p = 2 * sum_j (-1)^{j-1} exp(-2 j^2 lam^2)``
    with ``lam = (en + 0.12 + 0.11/en) * D``,
    ``en = sqrt(n*m/(n+m))`` (Numerical Recipes §14.3).  Empty inputs
    return ``(nan, nan)``.
    """
    a = np.sort(np.asarray(a, np.float64))
    b = np.sort(np.asarray(b, np.float64))
    n, m = len(a), len(b)
    if n == 0 or m == 0:
        return float("nan"), float("nan")
    grid = np.concatenate([a, b])
    cdf_a = np.searchsorted(a, grid, side="right") / n
    cdf_b = np.searchsorted(b, grid, side="right") / m
    d = float(np.max(np.abs(cdf_a - cdf_b)))
    en = math.sqrt(n * m / (n + m))
    lam = (en + 0.12 + 0.11 / en) * d
    p = 0.0
    converged = False
    for j in range(1, 101):
        term = 2.0 * (-1.0) ** (j - 1) * math.exp(-2.0 * j * j
                                                  * lam * lam)
        p += term
        if abs(term) < 1e-12:
            converged = True
            break
    if not converged:
        # lam ~ 0 (identical samples): the alternating series never
        # settles; the distribution-function limit there is p = 1
        p = 1.0
    return d, float(min(max(p, 0.0), 1.0))
