"""Port vs reference: norms, RoPE, SwiGLU, fixed_tree_sum, MLP, init.

The same numpy inputs go through `repro.models.common` / `mlp` (JAX on
the CPU) and `repro_torch.models.common` / `mlp` (PyTorch on the CPU).
Tolerances: float32 results may differ by a few float32 roundings
(XLA and PyTorch reduce in other orders): rtol 1e-5 / atol 1e-6.  bf16
results are rounded from float32 values that differ that little, so
they agree to one bf16 step: |a - b| <= 2**-7 * |a| (plus 1e-6).
SwiGLU in bf16 is held to two steps: XLA rounds silu's bf16
intermediate before the product, PyTorch's silu rounds once.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.models import api as ref_api
from repro.models import common as ref_common
from repro.models import mlp as ref_mlp
from repro_torch.configs import reduced_config
from repro_torch.models import api, common, mlp
from repro_torch.models.convert import to_torch

F32 = dict(rtol=1e-5, atol=1e-6)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(a, b, dtype, steps=1):
    a = np.asarray(a, np.float32)
    b = np.asarray(b.float() if isinstance(b, torch.Tensor) else b,
                   np.float32)
    assert a.shape == b.shape
    if dtype == "float32":
        np.testing.assert_allclose(b, a, **F32)
    else:                               # one bf16 step
        assert (np.abs(a - b) <= steps * 2.0 ** -7 * np.abs(a)
                + 1e-6).all(), \
            np.abs(a - b).max()


def _pair(x, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    s = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    _close(ref_common.rmsnorm(jx, jnp.asarray(s)),
           common.rmsnorm(tx, torch.from_numpy(s)), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    jx, tx = _pair(x, dtype)
    _close(ref_common.apply_rope(jx, jnp.asarray(pos), 5e6),
           common.apply_rope(tx, torch.from_numpy(pos), 5e6), dtype)


def test_rope_frequencies():
    for hd, theta in ((16, 1e4), (128, 5e6)):
        np.testing.assert_allclose(
            common.rope_frequencies(hd, theta).numpy(),
            np.asarray(ref_common.rope_frequencies(hd, theta)), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu(dtype):
    cfg = reduced_config("yi-6b")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 128)).astype(np.float32)
    g = rng.standard_normal((4, 128)).astype(np.float32)
    (jx, tx), (jg, tg) = _pair(x, dtype), _pair(g, dtype)
    _close(ref_common.activation(cfg, jx, jg),
           common.activation(cfg, tx, tg), dtype, steps=2)


@pytest.mark.parametrize("n", [1, 3, 4, 5, 16])
def test_fixed_tree_sum_same_order(n):
    """Same halving order, elementwise float32 adds: bitwise equal."""
    rng = np.random.default_rng(n)
    parts = rng.standard_normal((n, 3, 8)).astype(np.float32)
    want = np.asarray(ref_common.fixed_tree_sum(jnp.asarray(parts)))
    got = common.fixed_tree_sum(torch.from_numpy(parts)).numpy()
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("groups", [0, 4])
def test_mlp_float32(groups):
    """Grouped and plain MLP on bridged float32 weights and inputs."""
    cfg = reduced_config("yi-6b")
    rng = np.random.default_rng(3)
    p = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
         for k, s in (("w_up", (64, 128)), ("w_gate", (64, 128)),
                      ("w_down", (128, 64)))}
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    want = ref_mlp.mlp(cfg, {k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), groups=groups)
    got = mlp.mlp(cfg, {k: to_torch(v) for k, v in p.items()},
                  torch.from_numpy(x), groups=groups)
    _close(want, got, "float32")


def test_to_torch_bfloat16_bits():
    """ml_dtypes bf16 arrays cross as their bits."""
    x = np.asarray(jnp.asarray(np.linspace(-3, 3, 17), jnp.bfloat16))
    t = to_torch(x)
    assert t.dtype == torch.bfloat16
    assert (t.view(torch.int16).numpy() == x.view(np.int16)).all()


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_init_follows_reference_specs(kv_heads):
    """Same tree, shapes and per-leaf rules as the reference's init;
    the draws come from a torch.Generator, so only statistics match."""
    ref_cfg = dataclasses.replace(ref_reduced_config("yi-6b"),
                                  num_kv_heads=kv_heads)
    cfg = dataclasses.replace(reduced_config("yi-6b"),
                              num_kv_heads=kv_heads)
    want = ref_api.init(ref_cfg, jax.random.PRNGKey(0))
    got = api.init(cfg, 0, device="cpu")
    flat_w = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {}

    def walk(t, path):
        if isinstance(t, torch.Tensor):
            flat_g[path] = t
        else:
            for k, v in t.items():
                walk(v, path + f"['{k}']")

    walk(got, "")
    assert set(flat_g) == set(flat_w)
    for k, w in flat_w.items():
        g = flat_g[k]
        assert tuple(g.shape) == w.shape, k
        w = np.asarray(w)
        if (w == 1).all():
            assert (g == 1).all(), k
        else:       # normal leaves: same scale rule (std within 10%)
            assert abs(float(g.float().std()) / float(w.std()) - 1) < 0.1, k
    assert cfg.param_count() == ref_cfg.param_count()
    again = api.init(cfg, 0, device="cpu")             # seeded
    assert torch.equal(got["embed"], again["embed"])
    assert torch.equal(got["layers"]["attn"]["wq"],
                       again["layers"]["attn"]["wq"])


def test_full_width_param_count():
    """yi-6b at full width: the 6.06 B parameters the slice serves."""
    from repro.configs import get_config as ref_get
    from repro_torch.configs import get_config
    assert get_config("yi-6b").param_count() == \
        ref_get("yi-6b").param_count()
    assert abs(get_config("yi-6b").param_count() / 1e9 - 6.06) < 0.01
