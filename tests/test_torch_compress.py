"""Port vs reference: gradient compression (optim/compress.py).

Every function is held bit for bit against the reference on the same
float32 inputs: random tensors of several magnitudes, all-zero tensors
(the 1e-12 scale floor), values whose scaled quotient is exactly k + 0.5
(``torch.round`` and ``jnp.round`` both round half to even), and the
error-feedback state over steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compress as ref
from repro_torch.core.tree import items_with_path
from repro_torch.optim import compress

METHODS = ("bf16", "int8_ef", "none")


def _cases():
    rng = np.random.default_rng(0)
    return {
        "normal": rng.standard_normal((37, 19)).astype(np.float32) * 3,
        "zeros": np.zeros((5, 4), np.float32),
        # max |x| = 127: scale 1, so x / scale is x, ties at .5
        "ties": np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -127,
                          3.5, -2.5], np.float32),
        "tiny": (rng.standard_normal(1000) * 1e-20).astype(np.float32),
        "large": rng.standard_normal((3, 4, 5)).astype(np.float32) * 1e6,
        "bf16_ties": (np.arange(-64, 64, dtype=np.float32) * 2 ** -8
                      + 2 ** -16).astype(np.float32),
    }


CASES = _cases()


def _bits(x) -> bytes:
    return (x.numpy() if torch.is_tensor(x) else np.asarray(x)).tobytes()


@pytest.mark.parametrize("name", sorted(CASES))
def test_quantize_dequantize_bitwise(name):
    x = CASES[name]
    jq, js = ref.quantize_int8(jnp.asarray(x))
    tq, ts = compress.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert _bits(js) == _bits(ts)
    assert _bits(ref.dequantize_int8(jq, js)) == _bits(
        compress.dequantize_int8(tq, ts))
    if name == "ties":
        assert tq.numpy().tolist()[:10] == [127, 0, 2, 2, 0, -2, 126, -127,
                                            4, -2]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_compress_residual_bitwise(name, method):
    x = CASES[name]
    e = (np.random.default_rng(1).standard_normal(x.shape) * 0.1
         ).astype(np.float32)
    jy, je = ref.compress_residual(jnp.asarray(x), jnp.asarray(e), method)
    ty, te = compress.compress_residual(torch.from_numpy(x),
                                        torch.from_numpy(e), method)
    assert ty.dtype == te.dtype == torch.float32
    assert _bits(jy) == _bits(ty)
    assert _bits(je) == _bits(te)


@pytest.mark.parametrize("method", METHODS)
def test_apply_ef_tree_over_steps_bitwise(method):
    """apply_ef over a nested tree with bf16 and float32 leaves, five
    steps carrying the error state: every leaf of the compressed
    gradients and of the state is the reference's bits."""
    rng = np.random.default_rng(2)
    shapes = {"a": (16,), "b": {"c": (4, 4), "d": (3, 2, 5)}, "z": (6,)}

    def draw(tree):
        if isinstance(tree, dict):
            return {k: draw(v) for k, v in tree.items()}
        return rng.standard_normal(tree).astype(np.float32)

    jef = tef = None
    for step in range(5):
        g = draw(shapes)
        g["z"] = np.zeros(6, np.float32)
        jg = jax.tree_util.tree_map(jnp.asarray, g)
        jg["b"]["c"] = jg["b"]["c"].astype(jnp.bfloat16)
        tg = {"a": torch.from_numpy(g["a"]),
              "b": {"c": torch.from_numpy(g["b"]["c"]).to(torch.bfloat16),
                    "d": torch.from_numpy(g["b"]["d"])},
              "z": torch.from_numpy(g["z"])}
        if step == 0:
            jef, tef = ref.make_ef_state(jg), compress.make_ef_state(tg)
        jy, jef = ref.apply_ef(jg, jef, method)
        ty, tef = compress.apply_ef(tg, tef, method)
        for tree_j, tree_t in ((jy, ty), (jef, tef)):
            flat = dict(("/".join(k.key for k in p), x) for p, x in
                        jax.tree_util.tree_flatten_with_path(tree_j)[0])
            got = dict(items_with_path(tree_t))
            assert sorted(flat) == sorted(got)
            for path, x in got.items():
                assert x.dtype == torch.float32, path
                assert _bits(flat[path]) == _bits(x), (step, path)


def test_error_feedback_bounded_over_steps():
    """The port's EF loop (the reference's test_optim check): the
    residual stays within half a quantization step and the mean applied
    gradient converges to the true one."""
    g_true = torch.from_numpy(np.random.default_rng(0).standard_normal(
        256).astype(np.float32)) * 0.1
    err = torch.zeros(256)
    applied = torch.zeros(256)
    for _ in range(50):
        half_step = (g_true + err).abs().max().item() / 254.0
        y, err = compress.compress_residual(g_true, err, "int8_ef")
        applied = applied + y
        assert err.abs().max().item() <= half_step * (1 + 1e-5)
    assert (applied / 50 - g_true).abs().max().item() < 0.01
