"""Port vs reference: the Transformer Engine slice (te/fp8 training half,
te/linear's fp8_matmul and te_linear, te/layer).

Same inputs on both sides: parameters drawn by the reference's
``init_params`` and moved across with ``convert.from_reference_tree``,
inputs and cotangents from seeded numpy.
* e4m3 and e5m2 codes and scales BITWISE (values past each format's
  range clip to its max), the delayed-scaling state over a sequence
  with a spike BITWISE;
* ``te_linear``: y within one rounding of the output dtype (float32
  sums of exact fp8 products in another order), new state BITWISE;
* ``fp8_matmul``'s backward on one shared cotangent: the e5m2 gradient
  codes BITWISE, dx and dw within float32 reordering.  Values, not
  dtypes: JAX returns the reference's dx in bf16 for a float32 x,
  torch's engine casts it to x's dtype;
* ``te_layernorm_mlp`` / ``te_transformer_layer`` at ``te_layer_config
  (1024)``, B=2, S=32: nearer the reference's fp8 output than that is
  to the reference's bf16 block on the same weights (ROADMAP C's fp8
  bar: e4m3 turns a one-step bf16 difference into a one-step e4m3
  difference); weight histories BITWISE, activation histories within
  one bf16 step (an activation's amax is one of its bf16 values);
* the reference's own tests/test_te.py checks, on the port;
* ``fp8_dot``'s operands for ``torch._scaled_mm``: zero-padded K and N
  leave the product unchanged.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.llama_te import te_layer_config as ref_te_layer_config
from repro.models import mlp as ref_mlp
from repro.models import transformer as ref_transformer
from repro.models.common import apply_norm as ref_apply_norm
from repro.models.common import init_params as ref_init_params
from repro.te import fp8 as ref_fp8
from repro.te import layer as ref_layer
from repro.te import linear as ref_linear
from repro_torch.configs.llama_te import te_layer_config
from repro_torch.models.convert import from_reference_tree, to_torch
from repro_torch.te import fp8, layer, linear
from repro_torch.te.fp8 import E4M3, E5M2, DelayedScalingRecipe

RECIPE = DelayedScalingRecipe()
REF_RECIPE = ref_fp8.DelayedScalingRecipe()
BF16_STEP = 2.0 ** -7
FORMATS = [(E4M3, ref_fp8.E4M3), (E5M2, ref_fp8.E5M2)]


def _bits(x) -> np.ndarray:
    """The bytes of a jax/numpy array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _same(want, got) -> None:
    assert np.array_equal(_bits(want), _bits(got))


def _same_tree(want, got, path="") -> None:
    if isinstance(want, dict):
        assert set(want) == set(got), path
        for k in want:
            _same_tree(want[k], got[k], f"{path}/{k}")
    else:
        assert np.array_equal(_bits(want), _bits(got)), path


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _within_rounding(want, got, step) -> None:
    """|got - want| within `step` of each value plus 2**-12 of the
    largest: float32 sums in another order may cross a rounding
    boundary of the output dtype."""
    a, b = _f32(want), _f32(got)
    lim = step * np.abs(a) + 2.0 ** -12 * np.abs(a).max()
    assert (np.abs(a - b) <= lim).all(), np.abs(a - b).max()


# ----------------------------------------------------------------------
# te/fp8: formats, scales, delayed scaling, fp8_dot's operands
# ----------------------------------------------------------------------

@pytest.mark.parametrize("fmt,ref_fmt", FORMATS, ids=["e4m3", "e5m2"])
def test_codes_and_scales_bitwise_past_the_range(fmt, ref_fmt):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096))
    x[:8] = [0.0, -0.0, 448.0, 449.0, 57344.0, 6e4, -1e9, 3e38]
    x = x.astype(np.float32)
    for s in (np.float32(1.0), np.float32(0.0173),
              np.asarray(ref_fp8.compute_scale(jnp.asarray(np.abs(x).max()),
                                               ref_fmt))):
        want = ref_fp8.quantize(jnp.asarray(x), jnp.asarray(s), ref_fmt)
        got = fp8.quantize(torch.from_numpy(x), torch.tensor(s), fmt)
        assert got.dtype == fmt
        _same(want, got)
    _same(ref_fp8.compute_scale(jnp.float32(123.5), ref_fmt, 3.0),
          fp8.compute_scale(torch.tensor(123.5), fmt, 3.0))
    assert fp8.FP8_MAX[fmt] == ref_fp8.FP8_MAX[ref_fmt]


def test_delayed_scaling_state_bitwise_over_a_spike():
    rng = np.random.default_rng(1)
    amaxes = np.abs(rng.standard_normal(40)).astype(np.float32)
    amaxes[7] = 1000.0                          # held 16 steps, then gone
    for fmt, ref_fmt in FORMATS:
        want = ref_fp8.init_fp8_state(REF_RECIPE, ("x",))["x"]
        got = fp8.init_fp8_state(RECIPE, ("x",))["x"]
        _same_tree(want, got)
        for a in amaxes:
            want = ref_fp8.update_fp8_state(REF_RECIPE, want, jnp.asarray(a),
                                            ref_fmt)
            got = fp8.update_fp8_state(RECIPE, got, torch.tensor(a), fmt)
            _same_tree(want, got)


def test_recipe_matches_reference():
    assert RECIPE.history_len == REF_RECIPE.history_len
    assert RECIPE.margin == REF_RECIPE.margin
    assert (RECIPE.fwd_dtype, RECIPE.bwd_dtype) == (E4M3, E5M2)


@pytest.mark.parametrize("M,K,N", [(33, 40, 24), (16, 16, 16), (7, 5, 3),
                                   (66, 256, 512)])
def test_scaled_mm_operands_pad_with_zero_codes(M, K, N):
    """The operands _scaled_mm gets: xq row-major, wq column-major, K and
    N rounded up to 16 with zero codes; the first N columns of their
    product are the product.  Integer codes sum exactly, so there it is
    bitwise whatever the order; random codes within float32 order."""
    rng = np.random.default_rng(M * K * N)
    for fmt_x, fmt_w in ((E4M3, E4M3), (E5M2, E4M3), (E4M3, E5M2)):
        for ints in (True, False):
            draw = (lambda s: rng.integers(-8, 9, s)) if ints else \
                (lambda s: rng.standard_normal(s) * 30)
            xq = torch.from_numpy(draw((M, K)).astype(np.float32)).to(fmt_x)
            wq = torch.from_numpy(draw((N, K)).astype(np.float32)).to(
                fmt_w).t()                       # column-major already
            a, b = fp8.scaled_mm_operands(xq, wq)
            Kp, Np = -(-K // 16) * 16, -(-N // 16) * 16
            assert a.shape == (M, Kp) and b.shape == (Kp, Np)
            assert a.is_contiguous() and b.t().is_contiguous()
            assert (a.dtype, b.dtype) == (fmt_x, fmt_w)
            if (Kp, Np) == (K, N):
                assert b.data_ptr() == wq.data_ptr()   # no copy
            assert not a.view(torch.uint8)[:, K:].any()
            assert not b.view(torch.uint8)[K:].any()
            assert not b.view(torch.uint8)[:, N:].any()
            want = xq.float() @ wq.float()
            got = (a.float() @ b.float())[:, :N]
            if ints:
                assert torch.equal(got, want)
            else:
                torch.testing.assert_close(got, want, rtol=1e-6,
                                           atol=1e-6 * want.abs().max())


def test_fp8_dot_mixed_formats_plain():
    rng = np.random.default_rng(3)
    for ref_x, ref_w in ((ref_fp8.E5M2, ref_fp8.E4M3),
                         (ref_fp8.E4M3, ref_fp8.E5M2)):
        xq = ref_fp8.quantize(jnp.asarray(rng.standard_normal((33, 40)),
                                          jnp.float32), jnp.float32(0.01),
                              ref_x)
        wq = ref_fp8.quantize(jnp.asarray(rng.standard_normal((40, 24)),
                                          jnp.float32), jnp.float32(0.02),
                              ref_w)
        want = ref_fp8.fp8_dot(xq, jnp.float32(0.3), wq, jnp.float32(0.7),
                               jnp.float32)
        got = fp8.fp8_dot(to_torch(np.asarray(xq)), torch.tensor(0.3),
                          to_torch(np.asarray(wq)), torch.tensor(0.7),
                          torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


# ----------------------------------------------------------------------
# te/linear: te_linear and fp8_matmul's backward
# ----------------------------------------------------------------------

def _linear_params(d_in, d_out, bias=False, seed=0):
    ref = ref_init_params(ref_linear.te_linear_specs(d_in, d_out, bias=bias),
                          jax.random.PRNGKey(seed))
    port = from_reference_tree(jax.tree_util.tree_map(np.asarray, ref),
                               linear.te_linear_specs(d_in, d_out, bias=bias),
                               "cpu")
    return ref, port


@pytest.mark.parametrize("dtype,bias", [("bfloat16", False),
                                        ("float32", True)])
def test_te_linear_vs_reference(dtype, bias):
    ref_p, p = _linear_params(96, 80, bias)
    rng = np.random.default_rng(4)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref_st = ref_linear.init_state(REF_RECIPE)
    st = linear.init_state(RECIPE)
    _same_tree(ref_st, st)
    for step in range(3):                       # scales warm from step 1
        x = jnp.asarray(rng.standard_normal((2, 11, 96)) * (1 + 5 * step),
                        jdt)
        want, ref_st = ref_linear.te_linear(ref_p, ref_st, x, REF_RECIPE)
        got, st = linear.te_linear(p, st, to_torch(np.asarray(x)), RECIPE)
        assert got.dtype == getattr(torch, dtype) and got.shape == (2, 11, 80)
        _within_rounding(want, got, BF16_STEP if dtype == "bfloat16"
                         else 2.0 ** -20)
        _same_tree(ref_st, st)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fp8_matmul_backward_on_one_cotangent(dtype):
    """M = 66 tokens (not a multiple of 16): wgrad contracts over them."""
    M, K, N = 66, 256, 48
    rng = np.random.default_rng(5)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x = jnp.asarray(rng.standard_normal((M, K)), jdt)
    w = jnp.asarray(rng.standard_normal((K, N)) * K ** -0.5, jnp.float32)
    g = jnp.asarray(rng.standard_normal((M, N)) * 3.0, jdt)
    sx = ref_fp8.compute_scale(ref_fp8.amax(x))
    sw = ref_fp8.compute_scale(ref_fp8.amax(w))
    want, vjp = jax.vjp(lambda a, b: ref_linear.fp8_matmul(
        a, b, sx, sw, REF_RECIPE), x, w)
    want_dx, want_dw = vjp(g)

    tx = to_torch(np.asarray(x)).requires_grad_()
    tw = to_torch(np.asarray(w)).requires_grad_()
    tsx, tsw = to_torch(np.asarray(sx)), to_torch(np.asarray(sw))
    got = linear.fp8_matmul(tx, tw, tsx, tsw, RECIPE)
    tg = to_torch(np.asarray(g))
    got.backward(tg)
    step = BF16_STEP if dtype == "bfloat16" else 2.0 ** -20
    _within_rounding(want, got, step)
    # the gradient's e5m2 codes and scale, from the same cotangent
    sg = ref_fp8.compute_scale(ref_fp8.amax(g), ref_fp8.E5M2)
    tsg = fp8.compute_scale(fp8.amax(tg), E5M2)
    _same(sg, tsg)
    _same(ref_fp8.quantize(g, sg, ref_fp8.E5M2), fp8.quantize(tg, tsg, E5M2))
    assert tx.grad.dtype == tx.dtype and tw.grad.dtype == torch.float32
    _within_rounding(want_dx, tx.grad, BF16_STEP)   # dx ends in bf16
    np.testing.assert_allclose(_f32(tw.grad), _f32(want_dw), rtol=1e-5,
                               atol=1e-5 * np.abs(_f32(want_dw)).max())


def test_backward_saves_codes_not_inputs():
    x = torch.randn(20, 32, requires_grad=True)
    w = torch.randn(32, 16, requires_grad=True)
    y = linear.fp8_matmul(x, w, torch.tensor(0.01), torch.tensor(0.01),
                          RECIPE)
    saved = y.grad_fn.saved_tensors
    assert [t.dtype for t in saved[:2]] == [E4M3, E4M3]
    assert all(t.numel() <= 1 for t in saved[2:])


# ----------------------------------------------------------------------
# te/layer
# ----------------------------------------------------------------------

B, S = 2, 32


@pytest.fixture(scope="module")
def te_block():
    """The TE block at Table II's hidden 1024 on both sides, its input,
    and the reference's bf16 block on the same weights."""
    ref_cfg, cfg = ref_te_layer_config(1024), te_layer_config(1024)
    ref_p = ref_init_params(ref_layer.transformer_layer_specs(ref_cfg),
                            jax.random.PRNGKey(0))
    np_p = jax.tree_util.tree_map(np.asarray, ref_p)
    p = from_reference_tree(np_p, layer.transformer_layer_specs(cfg), "cpu")
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.standard_normal((B, S, 1024)), jnp.bfloat16)
    H, hd = cfg.num_heads, cfg.head_dim
    bf16_p = {"ln1": ref_p["ln1"], "ln2": ref_p["mlp"]["ln"],
              "attn": {"wq": ref_p["wq"]["w"].reshape(1024, H, hd),
                       "wk": ref_p["wk"]["w"].reshape(1024, H, hd),
                       "wv": ref_p["wv"]["w"].reshape(1024, H, hd),
                       "wo": ref_p["wo"]["w"].reshape(H, hd, 1024)},
              "mlp": {"w_up": ref_p["mlp"]["up"]["w"],
                      "w_gate": ref_p["mlp"]["gate"]["w"],
                      "w_down": ref_p["mlp"]["down"]["w"]}}
    return ref_cfg, cfg, ref_p, p, x, bf16_p


def _histories(want, got, weights, path=""):
    """Weight histories bitwise, activation histories within one bf16
    step, over two state trees of linears."""
    if "history" not in want:
        for k in want:
            _histories(want[k], got[k], weights, f"{path}/{k}")
        return
    a, b = np.asarray(want["history"]), got["history"].numpy()
    if path.endswith("/w"):
        weights.append(path)
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), path
    else:
        assert (np.abs(a - b) <= BF16_STEP * np.abs(a)).all(), (path, a, b)


def _fp8_bar(want, got, bf16) -> float:
    diff = np.abs(_f32(want) - _f32(got)).max()
    quant = np.abs(_f32(want) - _f32(bf16)).max()
    assert np.isfinite(_f32(got)).all()
    assert diff < quant, (diff, quant)
    return diff / quant


def test_te_layernorm_mlp_vs_reference(te_block):
    ref_cfg, cfg, ref_p, p, x, bf16_p = te_block
    want, ref_st = ref_layer.te_layernorm_mlp(
        ref_cfg, ref_p["mlp"], ref_layer.layernorm_mlp_state(ref_cfg,
                                                             REF_RECIPE),
        x, REF_RECIPE)
    got, st = layer.te_layernorm_mlp(cfg, p["mlp"],
                                     layer.layernorm_mlp_state(cfg, RECIPE),
                                     to_torch(np.asarray(x)), RECIPE)
    assert got.shape == (B, S, 1024) and got.dtype == torch.bfloat16
    h = ref_apply_norm(ref_cfg, x, ref_p["mlp"]["ln"])
    bf16 = ref_mlp.mlp(ref_cfg, bf16_p["mlp"], h)
    _fp8_bar(want, got, bf16)
    weights = []
    _histories(ref_st, st, weights)
    assert len(weights) == 3


def test_te_transformer_layer_vs_reference(te_block):
    ref_cfg, cfg, ref_p, p, x, bf16_p = te_block
    ref_st = ref_layer.transformer_layer_state(ref_cfg, REF_RECIPE)
    st = layer.transformer_layer_state(cfg, RECIPE)
    tx = to_torch(np.asarray(x))
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    bf16, _ = ref_transformer.layer_fwd(ref_cfg, bf16_p, x, pos)
    for _ in range(2):                          # cold, then warm scales
        want, ref_st = ref_layer.te_transformer_layer(ref_cfg, ref_p, ref_st,
                                                      x, REF_RECIPE)
        got, st = layer.te_transformer_layer(cfg, p, st, tx, RECIPE)
        assert got.shape == (B, S, 1024) and got.dtype == torch.bfloat16
        _fp8_bar(want, got, bf16)
        weights = []
        _histories(ref_st, st, weights)
        assert len(weights) == 7
    assert float(st["wq"]["x"]["history"].max()) > 0   # rolled


# ----------------------------------------------------------------------
# the reference's tests/test_te.py, on the port
# ----------------------------------------------------------------------

def test_quantize_roundtrip_error_bound():
    x = torch.randn(512, generator=torch.Generator().manual_seed(0)) * 10
    scale = fp8.compute_scale(fp8.amax(x), E4M3)
    xd = fp8.dequantize(fp8.quantize(x, scale, E4M3), scale, torch.float32)
    rel = (xd - x).abs() / (x.abs() + 1e-6)
    assert rel.median() < 0.05
    assert rel.max() < 0.3


def test_e5m2_wider_range():
    big, s = torch.tensor([30000.0]), torch.ones(())
    assert torch.isfinite(fp8.dequantize(fp8.quantize(big, s, E5M2), s)).all()
    assert float(fp8.dequantize(fp8.quantize(big, s, E4M3), s)[0]) <= 448.0


def test_delayed_scaling_tracks_amax():
    st = fp8.init_fp8_state(RECIPE, ("x",))["x"]
    for a in (1.0, 2.0, 1000.0, 1.0):
        st = fp8.update_fp8_state(RECIPE, st, torch.tensor(a), E4M3)
    expected = fp8.compute_scale(torch.tensor(1000.0), E4M3)
    assert torch.equal(st["scale"], expected)


def _port_linear(d_in, d_out):
    return _linear_params(d_in, d_out)[1]


def test_te_linear_close_to_bf16():
    p = _port_linear(128, 256)
    st = linear.init_state(RECIPE)
    x = torch.randn(32, 128, generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    _, st = linear.te_linear(p, st, x, RECIPE)     # warm scales
    y, st = linear.te_linear(p, st, x, RECIPE)
    ref = linear.linear_reference(p, x)
    rel = float((y - ref).float().norm() / ref.float().norm())
    assert rel < 0.08, rel


def test_te_linear_grads_flow():
    p = _port_linear(64, 64)
    w = p["w"].requires_grad_()
    st = linear.init_state(RECIPE)
    x = torch.randn(16, 64, generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16).requires_grad_()
    y, _ = linear.te_linear({"w": w}, st, x, RECIPE)
    y.float().square().sum().backward()
    assert torch.isfinite(w.grad).all() and torch.isfinite(x.grad.float()).all()
    assert float(w.grad.abs().sum()) > 0


def test_fp8_grad_close_to_bf16_grad():
    p = _port_linear(64, 64)
    st = linear.init_state(RECIPE)
    x = torch.randn(16, 64, generator=torch.Generator().manual_seed(1))
    w1 = p["w"].clone().requires_grad_()
    linear.te_linear({"w": w1}, st, x, RECIPE)[0].float().square().mean() \
        .backward()
    w2 = p["w"].clone().requires_grad_()
    linear.linear_reference({"w": w2}, x).float().square().mean().backward()
    cos = float((w1.grad * w2.grad).sum()
                / (w1.grad.norm() * w2.grad.norm()))
    assert cos > 0.97, cos


def test_from_reference_tree_checks_keys_and_shapes():
    specs = linear.te_linear_specs(4, 8, bias=True)
    good = {"w": np.zeros((4, 8), np.float32), "b": np.zeros(8, np.float32)}
    out = from_reference_tree(good, specs, "cpu")
    assert out["w"].shape == (4, 8) and out["b"].shape == (8,)
    with pytest.raises(ValueError, match="shape"):
        from_reference_tree({**good, "w": np.zeros((8, 4))}, specs, "cpu")
    with pytest.raises(ValueError, match="keys"):
        from_reference_tree({"w": good["w"]}, specs, "cpu")
