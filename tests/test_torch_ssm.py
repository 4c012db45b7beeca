"""Port vs reference: the ssm family (falcon-mamba-7b, Mamba-1).

Reference weights (`repro.models.api.init`, float32) are bridged with
`convert.from_reference`; the reference's outputs are computed once per
module (`ref`), then the port's are held to them.

Tolerances, from readings on these inputs:

* float32 activations (both packages' embeddings patched to keep
  float32 rows, `_keep_f32_rows`): the same arithmetic up to XLA's
  fused multiply-adds and its reduction orders.  Mixer outputs and
  states within 1e-5 of their max |x| (read: <= 2.5e-7), the loss
  within 1e-5 relative (read: 1e-7), every gradient leaf within 1e-4
  of its max |g| (read: <= 2.2e-6), prefill and decode within
  F32_SERVED bf16 steps (read: <= 1.3e-4 steps, 1.0e-6 of max |x|).
* bf16 activations (the shipped path): XLA rounds each op of
  ``jax.nn.silu`` to bf16 (exp, add, divide, multiply) where torch
  rounds once, so about a third of the silu outputs sit one bf16 step
  apart, and the layers carry that on.  A mixer's outputs and states
  within BF16_STEPS bf16 steps (2**-7 * max |x| each; read: <= 1.03).
  The model's outputs are held against the reference's own bf16
  rounding noise, `noise`: how many bf16 steps its bf16 logits lie from
  its float32 logits on the same weights and tokens (read: 4.33 here,
  33.1 on the chaotic reduced zamba2).  The port's final hidden and
  logits lie within max(MODEL_STEPS, NOISE x noise) steps of the
  reference's float32 ones (read: 2.88 / 3.80 here); its prefill and
  decode logits and states within max(MODEL_STEPS, (NOISE + 1) x noise)
  of the reference's bf16 ones (read: <= 2.45 here).  The loss within
  5e-3 (read: 3.2e-3).  Gradients: each leaf's distance from the
  reference's float32 gradient at most NOISE times the reference's own
  bf16 gradient's distance from it, plus 5% of max |g| (read: ratio <=
  1.62 here, 2.39 on zamba2).
"""

import dataclasses
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import reduced_config as ref_reduced_config
from repro.models import api as ref_api
from repro.models import ssm as ref_ssm
from repro.models import ssm_lm as ref_ssm_lm
from repro.models import transformer as ref_transformer
from repro_torch.configs import reduced_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.tree import items_with_path
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models import api, convert, ssm, ssm_lm, transformer
from repro_torch.runtime.trainer import Trainer, value_and_grad

ARCH = "falcon-mamba-7b"
BF16_STEPS = 4
MODEL_STEPS = 8
NOISE = 3.0
F32_SERVED = 1e-2      # bf16 steps: 7.8e-5 of max |x|
B, S = 2, 20           # S: two chunks of 8 and a padded third (chunk=8)
DECODE_STEPS = 4


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return convert.to_torch(np.asarray(x), "cpu")


def _within_steps(a, b) -> float:
    """|a - b| max over (2**-7 * max |a|): bf16 steps of a's scale."""
    a, b = _np(a), b.float().numpy() if torch.is_tensor(b) else _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / (2.0 ** -7 * np.abs(a).max()))


class _F32Numpy:
    """jax.numpy with `bfloat16` read as float32: the reference's
    decode steps cast the embedding to ``jnp.bfloat16`` inline."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


def _keep_f32_rows(mp, ref_module, port_module):
    """Both packages' embeddings (the forward's and the decode step's)
    keep float32 rows: the whole forward, backward and (with a float32
    cache) serving path then run in float32."""
    mp.setattr(ref_module, "embed_tokens",
               lambda cfg, params, tokens, prefix_embeds=None:
               params["embed"][tokens])
    mp.setattr(ref_module, "jnp", _F32Numpy())
    mp.setattr(port_module, "embed_tokens",
               lambda cfg, params, tokens, prefix_embeds=None:
               F.embedding(tokens.long(), params["embed"]))
    mp.setattr(port_module, "_embed",
               lambda params, tokens: params["embed"][tokens.long()])


def ref_served(ref_cfg, jp, tokens, n_steps, ref_module, port_module):
    """{activations: [(fed token, logits, numpy cache)]} of the
    reference's api.prefill and then `n_steps` greedy api.decode_steps,
    bf16 and float32 (a float32 cache, embeddings patched)."""
    out = {}
    B, S = tokens.shape
    for acts in ("bfloat16", "float32"):
        with pytest.MonkeyPatch.context() as mp:
            if acts == "float32":
                _keep_f32_rows(mp, ref_module, port_module)
            decode = jax.jit(functools.partial(ref_api.decode_step, ref_cfg))
            cache = ref_api.init_cache(ref_cfg, B, S + n_steps,
                                       getattr(jnp, acts))
            pl, cache = ref_api.prefill(ref_cfg, jp, {"tokens": tokens},
                                        cache)
            steps = [(None, _np(pl), jax.tree_util.tree_map(np.asarray,
                                                            cache))]
            tok = _np(pl).argmax(-1).astype(np.int32)
            for i in range(n_steps):
                dl, cache = decode(jp, cache, tok,
                                   jnp.asarray(S + i, jnp.int32))
                steps.append((tok, _np(dl),
                              jax.tree_util.tree_map(np.asarray, cache)))
                tok = _np(dl).argmax(-1).astype(np.int32)
        out[acts] = steps
    return out


def hold_served(cfg, tp, tokens, want, acts, bar, ref_module, port_module):
    """api.prefill, then api.decode_steps fed the reference's tokens:
    logits and every cache leaf within `bar` bf16 steps of the
    reference's (`want`: ref_served) at every step, the cache tree,
    shapes and dtypes the reference's.  Returns the port's cache."""
    B, S = tokens.shape
    steps = want[acts]
    want_sig = tree_signature(steps[0][2])
    with pytest.MonkeyPatch.context() as mp:
        if acts == "float32":
            _keep_f32_rows(mp, ref_module, port_module)
        cache = api.init_cache(cfg, B, S + len(steps) - 1,
                               getattr(torch, acts), device="cpu")
        assert tree_signature(cache) == want_sig
        logits, out = api.prefill(cfg, tp, {"tokens": _t(tokens)}, cache)
        assert out is cache
        for i, (tok, ref_logits, ref_cache) in enumerate(steps):
            if tok is not None:
                logits, cache = api.decode_step(cfg, tp, cache, _t(tok),
                                                S + i - 1)
            assert _within_steps(ref_logits, logits) <= bar, i
            assert tree_signature(cache) == want_sig
            for path, a in items_with_path(ref_cache):
                b = cache
                for k in path.split("/"):
                    b = b[k]
                if np.abs(_np(a)).max():
                    assert _within_steps(a, b) <= bar, (i, path)
                else:                   # untouched: zero on both sides
                    assert not b.any(), (i, path)
    return cache


def ref_float32_and_bf16(ref_cfg, jp, batch, ref_module, port_module):
    """The reference's loss and gradients {activations: (loss, {path:
    grad})}, bf16 and float32 (embeddings patched), paths spelled as the
    port's; its forward's hidden and logits in both; and `noise`, the
    bf16 logits' distance from the float32 ones in bf16 steps."""
    grads, fwd = {}, {}
    for acts in ("bfloat16", "float32"):
        with pytest.MonkeyPatch.context() as mp:
            if acts == "float32":
                _keep_f32_rows(mp, ref_module, port_module)
            loss, g = jax.jit(jax.value_and_grad(
                lambda p: ref_api.loss_fn(ref_cfg, p, batch)))(jp)
            h, _ = jax.jit(lambda p: ref_module.forward(
                ref_cfg, p, batch["tokens"]))(jp)
        flat = jax.tree_util.tree_flatten_with_path(g)[0]
        grads[acts] = (float(loss), {
            "/".join(k.key for k in path): _np(x) for path, x in flat})
        fwd[acts] = (h, ref_transformer.logits_fn(ref_cfg, jp, h))
    noise = _within_steps(fwd["float32"][1], fwd["bfloat16"][1])
    return grads, fwd, noise


def hold_forward(cfg, tp, tokens, fwd, noise, port_module):
    """The port's bf16 final hidden and logits within max(MODEL_STEPS,
    NOISE x noise) bf16 steps of the reference's float32 ones."""
    with torch.no_grad():
        h, aux = port_module.forward(cfg, tp, _t(tokens))
        logits = transformer.logits_fn(cfg, tp, h)
    assert aux.item() == 0.0 and h.dtype == torch.bfloat16
    bar = max(MODEL_STEPS, NOISE * noise)
    h32, logits32 = fwd["float32"]
    assert _within_steps(h32, h) <= bar, (_within_steps(h32, h), bar)
    assert _within_steps(logits32, logits) <= bar


def served_bar(noise) -> float:
    """Bar of the port's serving outputs against the reference's bf16
    ones (each within NOISE x noise of float32 at most)."""
    return max(MODEL_STEPS, (NOISE + 1) * noise)


def hold_loss_and_grads(cfg, tp, batch, want, acts, ref_module,
                        port_module, f32_grad_rel):
    """The port's loss and every gradient leaf against `want`
    (ref_loss_and_grads) by the module docstring's rules."""
    with pytest.MonkeyPatch.context() as mp:
        if acts == "float32":
            _keep_f32_rows(mp, ref_module, port_module)
        loss, grads = value_and_grad(
            cfg, tp, {k: _t(v) for k, v in batch.items()})
    ref_loss, ref_g = want[acts]
    _, ref32 = want["float32"]
    if acts == "float32":
        np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5)
    else:
        assert abs(loss.item() - ref_loss) <= 5e-3, (loss.item(), ref_loss)
    paths = [k for k, _ in items_with_path(grads)]
    assert sorted(paths) == sorted(ref_g)
    for key, g in items_with_path(grads):
        got = g.float().numpy()
        scale = np.abs(ref32[key]).max()
        err = np.abs(got - ref_g[key]).max()
        if acts == "float32":
            assert err <= f32_grad_rel * scale, (key, err / scale)
        else:
            noise = np.abs(ref_g[key] - ref32[key]).max()
            far = np.abs(got - ref32[key]).max()
            assert far <= NOISE * noise + 0.05 * scale, \
                (key, far / scale, noise / scale)


def tree_signature(tree, path=""):
    """{path: (shape, dtype name)} of a nested dict of arrays/tensors."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(tree_signature(tree[k], f"{path}/{k}"))
        return out
    dt = str(tree.dtype).replace("torch.", "")
    return {path: (tuple(tree.shape), dt)}


# ----------------------------------------------------------------------
# the reference, once per module
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    ref_cfg, cfg = ref_reduced_config(ARCH), reduced_config(ARCH)
    jp = ref_api.init(ref_cfg, jax.random.PRNGKey(0))
    tp = convert.from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                cfg, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    grads, fwd, noise = ref_float32_and_bf16(ref_cfg, jp, batch,
                                             ref_ssm_lm, ssm_lm)
    served = ref_served(ref_cfg, jp, batch["tokens"], DECODE_STEPS,
                        ref_ssm_lm, ssm_lm)
    return dict(ref_cfg=ref_cfg, cfg=cfg, jp=jp, tp=tp, batch=batch,
                fwd=fwd, noise=noise, grads=grads, served=served)


# ----------------------------------------------------------------------
# the mixer's pieces
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("L", [2, 20])          # 2 < W-1 = 3
def test_causal_conv1d(L, with_state, dtype):
    """y within one step of the dtype's rounding of max |y| (XLA fuses
    the taps' multiply-adds; read: 0 in bf16, <= 1 float32 ulp), the new
    state (the trailing W-1 inputs, read from the state when L < W-1)
    exactly."""
    rng = np.random.default_rng(L)
    C, W = 24, 4
    jd = getattr(jnp, dtype)
    x = jnp.asarray(rng.standard_normal((B, L, C)), jd)
    w = rng.standard_normal((W, C)).astype(np.float32) * 0.5
    b = rng.standard_normal(C).astype(np.float32)
    st = (jnp.asarray(rng.standard_normal((B, W - 1, C)), jd)
          if with_state else None)
    ry, rs = ref_ssm.causal_conv1d(x, w, b, st)
    ty, ts = ssm.causal_conv1d(_t(x), _t(w), _t(b),
                               None if st is None else _t(st))
    assert ty.dtype == getattr(torch, dtype) and ts.shape == (B, W - 1, C)
    assert np.array_equal(_np(rs), ts.float().numpy())
    step = (2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -23)
    assert np.abs(_np(ry) - ty.float().numpy()).max() \
        <= step * np.abs(_np(ry)).max()


def test_associative_scan_is_the_recurrence():
    """The log-depth scan gives the sequential recurrence h_t = a_t
    h_{t-1} + b_t within float32 rounding at even and odd lengths, and
    the reference's scan within 2 float32 ulps of max |h| (XLA fuses
    a2 * b1 + b2; read: <= 1)."""
    rng = np.random.default_rng(3)
    for n in (1, 2, 3, 6, 7, 16, 17):
        a = rng.uniform(0.5, 1.0, (2, n, 3, 4)).astype(np.float32)
        b = rng.standard_normal((2, n, 3, 4)).astype(np.float32)
        ta, tb = ssm.associative_scan(_t(a), _t(b))
        h = np.zeros((2, 3, 4), np.float32)
        seq = []
        for t in range(n):
            h = a[:, t] * h + b[:, t]
            seq.append(h)
        assert np.allclose(tb.numpy(), np.stack(seq, 1), rtol=1e-5,
                           atol=1e-5), n
        ra, rb = jax.lax.associative_scan(
            lambda e1, e2: (e1[0] * e2[0], e2[0] * e1[1] + e2[1]),
            (jnp.asarray(a), jnp.asarray(b)), axis=1)
        assert np.abs(_np(rb) - tb.numpy()).max() \
            <= 2 * 2.0 ** -23 * np.abs(_np(rb)).max(), n
        assert np.abs(_np(ra) - ta.numpy()).max() \
            <= 2 * 2.0 ** -23 * np.abs(_np(ra)).max(), n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba1_mixer_chunks_padding_and_state(ref, dtype):
    """chunk=8 at L=20 (two full chunks, one padded), from a zero state
    and then from the carried state: y and both state leaves, by the
    module docstring's rules (float32 1e-5 of max |x|; bf16
    BF16_STEPS steps)."""
    ref_cfg, cfg = ref["ref_cfg"], ref["cfg"]
    lp_r = jax.tree_util.tree_map(lambda a: a[0], ref["jp"]["layers"]["mixer"])
    lp_t = {k: v[0] for k, v in ref["tp"]["layers"]["mixer"].items()}
    x = jnp.asarray(np.random.default_rng(1).standard_normal(
        (B, S, cfg.d_model)), getattr(jnp, dtype))
    mixer = jax.jit(functools.partial(ref_ssm.mamba1_mixer, ref_cfg,
                                      chunk=8))
    ry, rst = mixer(lp_r, x)
    ry2, rst2 = mixer(lp_r, x[:, :5], state=rst)
    ty, tst = ssm.mamba1_mixer(cfg, lp_t, _t(x), chunk=8)
    ty2, tst2 = ssm.mamba1_mixer(cfg, lp_t, _t(x)[:, :5], chunk=8,
                                 state=tst)
    for what, a, b in (("y", ry, ty), ("y2", ry2, ty2),
                       ("ssm", rst["ssm"], tst["ssm"]),
                       ("ssm2", rst2["ssm"], tst2["ssm"]),
                       ("conv", rst["conv"], tst["conv"]),
                       ("conv2", rst2["conv"], tst2["conv"])):
        steps = _within_steps(a, b)
        if dtype == "float32":
            assert steps * 2.0 ** -7 <= 1e-5, (what, steps)
        else:
            assert steps <= BF16_STEPS, (what, steps)
    assert tst["ssm"].dtype == torch.float32


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------

def test_forward_and_logits_vs_reference(ref):
    """The final hidden and the logits against the reference's float32
    forward (`hold_forward`)."""
    hold_forward(ref["cfg"], ref["tp"], ref["batch"]["tokens"], ref["fwd"],
                 ref["noise"], ssm_lm)


@pytest.mark.parametrize("acts", ["float32", "bfloat16"])
def test_loss_fn_and_every_gradient_leaf(ref, acts):
    """api.loss_fn and its gradient, leaf by leaf, through
    torch.autograd (module docstring's rules)."""
    hold_loss_and_grads(ref["cfg"], ref["tp"], ref["batch"], ref["grads"],
                        acts, ref_ssm_lm, ssm_lm, f32_grad_rel=1e-4)


@pytest.mark.parametrize("acts", ["float32", "bfloat16"])
def test_prefill_then_decode_vs_reference(ref, acts):
    """api.prefill, then greedy api.decode_steps fed the reference's
    tokens (`hold_served`): float32 within F32_SERVED bf16 steps (read:
    <= 1.3e-4 steps, 1.0e-6 of max |x|), bf16 within `served_bar` (read:
    <= 2.45)."""
    bar = F32_SERVED if acts == "float32" else served_bar(ref["noise"])
    hold_served(ref["cfg"], ref["tp"], ref["batch"]["tokens"],
                ref["served"], acts, bar, ref_ssm_lm, ssm_lm)


def test_prefill_from_zero_state_is_the_forward(ref):
    """api.prefill from a zero state runs forward's arithmetic: its
    logits equal forward + logits_fn at the last position bit for bit."""
    cfg, tp = ref["cfg"], ref["tp"]
    toks = _t(ref["batch"]["tokens"])
    cache = api.init_cache(cfg, B, S, device="cpu")
    logits, _ = api.prefill(cfg, tp, {"tokens": toks}, cache)
    with torch.no_grad():
        h, _ = ssm_lm.forward(cfg, tp, toks)
        want = transformer.logits_fn(cfg, tp, h[:, -1:])[:, 0]
    assert torch.equal(logits, want)


def test_decode_steps_match_the_forward(ref):
    """The port's own step-by-step decode against its full-sequence
    forward (the reference's test_decode_matches_prefill_ssm property):
    the chunked and the one-token scans multiply in other orders, so
    logits within BF16_STEPS bf16 steps (read: 0, equal after the bf16
    rounding; the reference holds its own at 0.2 absolute)."""
    cfg, tp = ref["cfg"], ref["tp"]
    toks = _t(ref["batch"]["tokens"])
    with torch.no_grad():
        h, _ = ssm_lm.forward(cfg, tp, toks)
        full = transformer.logits_fn(cfg, tp, h).float()
    cache = api.init_cache(cfg, B, S, device="cpu")
    for t in range(S):
        logits, cache = api.decode_step(cfg, tp, cache, toks[:, t], t)
        assert _within_steps(full[:, t], logits) <= BF16_STEPS, t


def test_param_count_and_specs_equal_the_reference():
    """api.param_shapes matches the reference's spec tree leaf by leaf
    (so convert.from_reference's walk passes), and active_param_count
    equals the reference's at full width."""
    for name in (ARCH, "zamba2-2.7b"):
        from repro.configs import get_config as ref_get_config
        from repro_torch.configs import get_config
        cfg, ref_cfg = get_config(name), ref_get_config(name)
        assert api.active_param_count(cfg) == \
            ref_api.active_param_count(ref_cfg)
        want = jax.tree_util.tree_map(
            lambda s: tuple(s.shape), ref_api.abstract(ref_cfg))
        got = {k: v.shape for k, v in items_with_path(api.param_shapes(cfg))}
        flat = {"/".join(k.key for k in path): v for path, v in
                jax.tree_util.tree_flatten_with_path(
                    want, is_leaf=lambda x: isinstance(x, tuple))[0]}
        assert got == flat


# ----------------------------------------------------------------------
# the api's refusals for the recurrent families
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", [ARCH, "zamba2-2.7b"])
def test_transformer_only_options_raise_naming_the_family(name):
    cfg = reduced_config(name)
    params = api.init(cfg, 0, device="cpu")
    cache = api.init_cache(cfg, B, 16, device="cpu")
    tok = torch.zeros(B, dtype=torch.int32)
    for call in (
            lambda: api.init_cache(cfg, B, 16, paged=True, device="cpu"),
            lambda: api.init_cache(cfg, B, 16, fp8_kv=True, device="cpu"),
            lambda: api.decode_step(cfg, params, cache, tok, 0, kernel=True),
            lambda: api.decode_step(cfg, params, cache, tok, 0, quant={}),
            lambda: api.decode_step(cfg, params, cache, tok, 0,
                                    torch.zeros((B, 1), dtype=torch.int32)),
            lambda: api.chunk_step(cfg, params, cache, tok[:, None], 0,
                                   torch.ones(B, dtype=torch.int32)),
            lambda: api.verify_step(cfg, params, cache, tok[:, None], 0),
            lambda: api.cow_copy_block(cfg, cache, 0, 1)):
        with pytest.raises(NotImplementedError, match=cfg.family):
            call()
    # paged=False is the family's own layout
    assert tree_signature(api.init_cache(cfg, B, 16, paged=False,
                                         device="cpu")) \
        == tree_signature(cache)


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------

def test_trainer_restart_is_bit_exact():
    """The ssm family through Trainer: a run that fails after step 5
    and restarts from its step-4 checkpoint gives the losses of an
    uninterrupted run bit for bit (steps 5-8), as the dense family's."""
    cfg = dataclasses.replace(reduced_config(ARCH), remat="dots")
    runs = []
    for fail_at in (5, None):
        with tempfile.TemporaryDirectory() as td:
            tr = Trainer(cfg, TrainConfig(total_steps=50, warmup_steps=2,
                                          ckpt_every=2, ckpt_dir=td,
                                          learning_rate=1e-3),
                         data=SyntheticLMData(cfg.vocab_size, 2, 24, seed=0),
                         fail_at_step=fail_at, device="cpu")
            tr.init()
            hist = tr.run(8)
            runs.append(({m.step: m.loss for m in hist}, tr.restarts))
    (a, restarts), (b, _) = runs
    assert restarts == 1 and sorted(a) == list(range(1, 9))
    assert all(np.isfinite(v) for v in a.values())
    for s in range(1, 9):
        assert a[s] == b[s], (s, a[s], b[s])
    assert b[8] < b[1]
