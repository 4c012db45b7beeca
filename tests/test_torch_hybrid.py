"""Port vs reference: the hybrid family (zamba2-2.7b: Mamba-2 layers and
a shared attention block), the GELU activations, and api.prefill's
transformer branch.

Reference weights (`repro.models.api.init`, float32) are bridged with
`convert.from_reference`; the reference's outputs are computed once per
module (`ref`).  The shared block's attention is flash_attention: B9's
plain version on the CPU, the reference's own blockwise forward there.

Tolerances, from readings on these inputs, by test_torch_ssm.py's rules
(its helpers are imported):

* float32 activations: the Mamba-2 mixer within 1e-5 of max |x| (read:
  <= 7.7e-7), the loss within 1e-5 relative, every gradient leaf within
  1e-3 of its max |g| (read: <= 2.9e-4; the flash backward's blockwise
  sums add the most), prefill and decode within F32_SERVED (read: <=
  4.9e-4 bf16 steps, 3.8e-6 of max |x|).
* bf16 activations: a mixer within BF16_STEPS bf16 steps (read: <=
  1.2).  The random reduced zamba2 is chaotic in bf16: the reference's
  own bf16 logits lie `noise` = 33.1 bf16 steps from its float32 logits
  (and its bf16 gradients up to 1.7 x max |g| from its float32 ones),
  so the model's bf16 outputs and gradients are held against that
  noise by test_torch_ssm's rules, loose bars here (read: hidden and
  logits 37.9 / 42.5 steps from the float32 reference, served logits
  and states <= 18.2 from the bf16 reference, gradient ratio <= 2.39);
  the loss within 5e-3 (read: 3.6e-3).  The port's own decode against
  its forward is not chaotic (one bf16 rounding sequence): within
  MODEL_STEPS (read: <= 2.9).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.models import api as ref_api
from repro.models import common as ref_common
from repro.models import hybrid as ref_hybrid
from repro.models import ssm as ref_ssm
from repro_torch.configs import reduced_config
from repro_torch.models import (api, common, convert, hybrid, ssm,
                                transformer)
from test_torch_ssm import (BF16_STEPS, F32_SERVED, MODEL_STEPS, _np, _t,
                            _within_steps, hold_forward,
                            hold_loss_and_grads, hold_served,
                            ref_float32_and_bf16, ref_served, served_bar)

ARCH = "zamba2-2.7b"
B, S = 2, 20
DECODE_STEPS = 3


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
                                             ref_hybrid, hybrid)
    # prefill (the forward; the cache comes back as it came), then
    # greedy decode steps from the untouched cache, as the reference
    served = ref_served(ref_cfg, jp, batch["tokens"], DECODE_STEPS,
                        ref_hybrid, hybrid)
    return dict(ref_cfg=ref_cfg, cfg=cfg, jp=jp, tp=tp, batch=batch,
                fwd=fwd, noise=noise, grads=grads, served=served)


# ----------------------------------------------------------------------
# GELU
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gated", [False, True])
def test_gelu_branches_vs_jax(gated, dtype):
    """activation(cfg with activation="gelu"): gelu(x) without a gate
    (zamba2's MLP), gelu(gate) * x with one (geglu), both the tanh
    approximation of ``jax.nn.gelu``.  float32 within 4 float32 ulps of
    max |y| (read: <= 1); bf16 within one bf16 step of max |y| (XLA
    rounds each op of the formula to bf16, torch once; read: 1)."""
    cfg = reduced_config(ARCH)
    ref_cfg = ref_reduced_config(ARCH)
    assert cfg.activation == ref_cfg.activation == "gelu"
    rng = np.random.default_rng(5)
    jd = getattr(jnp, dtype)
    x = jnp.asarray(rng.standard_normal((4, 1024)) * 3, jd)
    gate = jnp.asarray(rng.standard_normal((4, 1024)) * 3, jd) \
        if gated else None
    want = _np(ref_common.activation(ref_cfg, x, gate))
    got = common.activation(cfg, _t(x), None if gate is None else _t(gate))
    assert got.dtype == getattr(torch, dtype)
    step = 2.0 ** -7 if dtype == "bfloat16" else 4 * 2.0 ** -23
    assert np.abs(want - got.float().numpy()).max() \
        <= step * np.abs(want).max()


def test_swiglu_needs_its_gate():
    with pytest.raises(ValueError, match="gate"):
        common.activation(reduced_config("yi-6b"), torch.ones(2), None)


# ----------------------------------------------------------------------
# Mamba-2
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_mixer_chunks_padding_and_state(ref, dtype):
    """chunk=8 at L=20 (two full chunks, one padded), from a zero state
    and then from the carried state: y and both state leaves (float32
    within 1e-5 of max |x|; bf16 within BF16_STEPS bf16 steps)."""
    ref_cfg, cfg = ref["ref_cfg"], ref["cfg"]
    lp_r = jax.tree_util.tree_map(lambda a: a[0, 0],
                                  ref["jp"]["mamba"]["mixer"])
    lp_t = {k: v[0, 0] for k, v in ref["tp"]["mamba"]["mixer"].items()}
    x = jnp.asarray(np.random.default_rng(1).standard_normal(
        (B, S, cfg.d_model)), getattr(jnp, dtype))
    mixer = jax.jit(functools.partial(ref_ssm.mamba2_mixer, ref_cfg,
                                      chunk=8))
    ry, rst = mixer(lp_r, x)
    ry2, rst2 = mixer(lp_r, x[:, :5], state=rst)
    ty, tst = ssm.mamba2_mixer(cfg, lp_t, _t(x), chunk=8)
    ty2, tst2 = ssm.mamba2_mixer(cfg, lp_t, _t(x)[:, :5], chunk=8,
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
    assert tst["ssm"].shape == (B, cfg.d_inner // cfg.ssm_head_dim,
                                cfg.ssm_head_dim, cfg.ssm_state)


def test_segsum_masks_before_the_exp():
    """_segsum's entries are the sums over (j, i] below the diagonal
    (within float32 rounding of the reference's: rtol 1e-5; read: equal)
    and -inf above it, so exp gives exact zeros there, as the
    reference's."""
    x = torch.tensor([[0.5, -1.0, 2.0, 0.25]])
    got = ssm._segsum(x)
    want = _np(ref_ssm._segsum(jnp.asarray(x.numpy())))
    assert np.array_equal(np.isneginf(want), torch.isneginf(got).numpy())
    fin = np.isfinite(want)
    assert np.allclose(got.numpy()[fin], want[fin])
    assert (torch.exp(got).triu(1) == 0).all()


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------

def test_forward_and_logits_vs_reference(ref):
    """Super-blocks of Mamba-2 layers and the shared block: the final
    hidden and the logits against the reference's float32 forward
    (`hold_forward`)."""
    hold_forward(ref["cfg"], ref["tp"], ref["batch"]["tokens"], ref["fwd"],
                 ref["noise"], hybrid)


@pytest.mark.parametrize("acts", ["float32", "bfloat16"])
def test_loss_fn_and_every_gradient_leaf(ref, acts):
    """api.loss_fn and its gradient, leaf by leaf (the stacked [NS,
    attn_every, ...] Mamba-2 leaves and the shared block's, which sums
    NS uses), through torch.autograd."""
    hold_loss_and_grads(ref["cfg"], ref["tp"], ref["batch"], ref["grads"],
                        acts, ref_hybrid, hybrid, f32_grad_rel=1e-3)


@pytest.mark.parametrize("acts", ["float32", "bfloat16"])
def test_prefill_then_decode_vs_reference(ref, acts):
    """api.prefill (the forward, read at the last position; the cache
    returned as it came, every leaf still zero, as the reference's),
    then greedy api.decode_steps from that cache fed the reference's
    tokens (`hold_served`): float32 within F32_SERVED bf16 steps (read:
    <= 4.9e-4 steps, 3.8e-6 of max |x|), bf16 within `served_bar` (read:
    <= 18.2; the bar is loose here, the float32 case holds the path);
    the cache keeps the reference's tree, shapes and dtypes (no
    "length" leaf)."""
    bar = F32_SERVED if acts == "float32" else served_bar(ref["noise"])
    hold_served(ref["cfg"], ref["tp"], ref["batch"]["tokens"],
                ref["served"], acts, bar, ref_hybrid, hybrid)


def test_decode_steps_match_the_forward(ref):
    """The port's own decode from state zero, token by token (how the
    family is served), against its full-sequence forward: logits within
    MODEL_STEPS bf16 steps at every position (read: <= 2.1)."""
    cfg, tp = ref["cfg"], ref["tp"]
    toks = _t(ref["batch"]["tokens"])
    with torch.no_grad():
        h, _ = hybrid.forward(cfg, tp, toks)
        full = transformer.logits_fn(cfg, tp, h).float()
    cache = api.init_cache(cfg, B, S, device="cpu")
    for t in range(S):
        logits, cache = api.decode_step(cfg, tp, cache, toks[:, t],
                                        torch.tensor(t, dtype=torch.int32))
        assert _within_steps(full[:, t], logits) <= MODEL_STEPS, t


def test_shared_block_runs_flash_attention_once_a_superblock(ref,
                                                             monkeypatch):
    """The forward applies the one shared block after every attn_every
    Mamba-2 layers: flash_attention once a super-block, causal, over
    the shared wq/wk/wv (H = KH, zamba2's layout)."""
    from repro_torch.models import attention
    cfg, tp = ref["cfg"], ref["tp"]
    calls = []
    flash = attention.flash_attention
    monkeypatch.setattr(attention, "flash_attention",
                        lambda q, k, v, **kw: calls.append(
                            (q.shape, k.shape, kw)) or flash(q, k, v, **kw))
    with torch.no_grad():
        hybrid.forward(cfg, tp, _t(ref["batch"]["tokens"]))
    hd = cfg.head_dim
    assert calls == [((B, S, cfg.num_heads, hd), (B, S, cfg.num_kv_heads,
                                                  hd), {"causal": True})] \
        * hybrid.n_superblocks(cfg)


# ----------------------------------------------------------------------
# api.prefill, transformer branch
# ----------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 8])
def test_dense_prefill_vs_reference_transformer_prefill(window):
    """api.prefill of the dense family (a contiguous cache, paged=False)
    against the reference's transformer.prefill on the same weights and
    prompt: last-position logits and the filled k/v within MODEL_STEPS
    bf16 steps (read: <= 1.1), positions past the prompt untouched;
    then a decode step from that cache within MODEL_STEPS too."""
    ref_cfg = dataclasses.replace(ref_reduced_config("yi-6b"),
                                  num_kv_heads=2, sliding_window=window)
    cfg = dataclasses.replace(reduced_config("yi-6b"), num_kv_heads=2,
                              sliding_window=window)
    jp = ref_api.init(ref_cfg, jax.random.PRNGKey(1))
    tp = convert.from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                cfg, device="cpu")
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, 12)).astype(np.int32)
    jc = ref_api.init_cache(ref_cfg, B, 16)
    jl, jc = ref_api.prefill(ref_cfg, jp, {"tokens": toks}, jc)
    tc = api.init_cache(cfg, B, 16, paged=False, device="cpu")
    tl, tc = api.prefill(cfg, tp, {"tokens": _t(toks)}, tc)
    assert sorted(tc) == ["k", "v"]
    assert _within_steps(jl, tl) <= MODEL_STEPS
    for k in ("k", "v"):
        assert _within_steps(jc[k], tc[k]) <= MODEL_STEPS, k
        assert not tc[k][:, :, 12:].any()
    tok = _np(jl).argmax(-1).astype(np.int32)
    jd, _ = ref_api.decode_step(ref_cfg, jp, jc, tok,
                                jnp.asarray(12, jnp.int32))
    td, _ = api.decode_step(cfg, tp, tc, _t(tok), 12)
    assert _within_steps(jd, td) <= MODEL_STEPS
    with pytest.raises(ValueError, match="contiguous"):
        api.prefill(cfg, tp, {"tokens": _t(toks)},
                    api.init_cache(cfg, B, 8, paged=False, device="cpu"))
