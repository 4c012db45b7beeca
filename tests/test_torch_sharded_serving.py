"""Sharded prefill and decode of the transformer families under the
training plans, against the reference's one-device steps.

The port's ``api.prefill(..., mesh=, plan=)`` and ``api.decode_step(...,
mesh=, plan=)`` on a (2, 4) ("data", "model") mesh spread over the CPU
(one process computes every position): parameters ``Sharded`` by the
plan's param rules, the contiguous cache ``Sharded`` by
``plans.cache_pspecs``.  Cases, reduced configs (B rows x S=16 prompt
tokens into a T=24 cache, then one decode step at position S):

* yi-6b under fsdp_tp at its 4 KV heads (heads over `model`) and at 2
  (T over `model`: KH does not divide it), B=4;
* yi-6b under fsdp_tp_sp at B=1 (T over `data`; at 2 KV heads T over
  ("model", "data"));
* moonshot-v1-16b-a3b (moe: routing global over the batch) and
  internvl2-1b (vlm: prefix_embeds; 2 KV heads, T over `model`) under
  fsdp_tp (B=4) and fsdp_tp_sp (B=1).

Bars: against the reference's one-device ``api.prefill`` and
``api.decode_step`` (JAX on the CPU, weights through
``convert.from_reference``), as they run (bf16 activations): logits,
k and v within MODEL_STEPS bf16 steps of the reference's max |x|
(tests/test_torch_hybrid.py's bar for the one-device prefill), greedy
ids equal wherever the reference's top two are more than twice that
apart.  Against the port's own one-device steps as they run: the
prefill's logits and cache bit for bit (the float32 partials round to
the bf16 the one-device products give), the decode logits bit for bit
where the cache's T is whole, else within SPLIT_T_STEPS bf16 steps
(each block rounds its own p to bf16; read: <= 1.21).  With float32
rows (the port's embeddings keep float32 rows) the summation order
differs (float32 partials, a split T's log-sum-exp combine), so within
1e-5 of max |x|.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import reduced_config as ref_reduced_config
from repro.models import api as ref_api
from repro_torch.configs import reduced_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api, convert, transformer
from repro_torch.sharding.plans import get_plan

MODEL_STEPS = 8           # bf16 steps of max |x| (read: <= 1.1)
SPLIT_T_STEPS = 2         # bf16 steps of max |x| (read: <= 1.21)
F32_REL = 1e-5
S, T = 16, 24

CASES = [("yi-6b", "fsdp_tp", 4, None), ("yi-6b", "fsdp_tp", 4, 2),
         ("yi-6b", "fsdp_tp_sp", 1, None), ("yi-6b", "fsdp_tp_sp", 1, 2),
         ("moonshot-v1-16b-a3b", "fsdp_tp", 4, None),
         ("moonshot-v1-16b-a3b", "fsdp_tp_sp", 1, None),
         ("internvl2-1b", "fsdp_tp", 4, None),
         ("internvl2-1b", "fsdp_tp_sp", 1, None)]


def _np(x):
    return np.asarray(x, np.float32)


def _steps(a, b) -> float:
    a, b = _np(a), b.float().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / (2.0 ** -7 * np.abs(a).max()))


@functools.lru_cache(maxsize=None)
def _model(name, kh):
    ref_cfg, cfg = ref_reduced_config(name), reduced_config(name)
    if kh is not None:
        ref_cfg = dataclasses.replace(ref_cfg, num_kv_heads=kh)
        cfg = dataclasses.replace(cfg, num_kv_heads=kh)
    jp = ref_api.init(ref_cfg, jax.random.PRNGKey(0))
    tp = convert.from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                cfg, device="cpu")
    return ref_cfg, jp, cfg, tp


def _batch(cfg, B, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    out = {"tokens": toks}
    if cfg.family == "vlm":
        out["prefix_embeds"] = rng.standard_normal(
            (B, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    return out


def _mesh():
    return make_host_mesh((2, 4), devices=["cpu"] * 8)


def _sharded(cfg, tp, plan_name, B, batch, tok, dtype=torch.bfloat16):
    """The port's sharded prefill then one decode step: (prefill logits,
    decode logits, the cache gathered whole after the prefill and after
    the decode step, the cache's spec)."""
    mesh, plan = _mesh(), get_plan(plan_name)
    sp = convert.shard_params(tp, cfg, mesh, rules=plan.param_rules)
    cache = api.init_cache(cfg, B, T, dtype, mesh=mesh, plan=plan)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    lp, cache = api.prefill(cfg, sp, tb, cache, mesh=mesh, plan=plan)
    pre = {k: v.full() for k, v in cache.items()}
    ld, cache = api.decode_step(cfg, sp, cache, torch.from_numpy(tok), S,
                                mesh=mesh, plan=plan)
    return (lp, ld, pre, {k: v.full() for k, v in cache.items()},
            cache["k"].spec)


def _one_device(cfg, tp, B, batch, tok, dtype=torch.bfloat16):
    cache = api.init_cache(cfg, B, T, paged=False, device="cpu", dtype=dtype)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    lp, cache = api.prefill(cfg, tp, tb, cache)
    pre = {k: v.clone() for k, v in cache.items()}
    ld, cache = api.decode_step(cfg, tp, cache, torch.from_numpy(tok), S)
    return lp, ld, pre, cache


@pytest.mark.parametrize("name,plan_name,B,kh", CASES)
def test_sharded_prefill_and_decode_vs_reference(name, plan_name, B, kh):
    ref_cfg, jp, cfg, tp = _model(name, kh)
    batch = _batch(cfg, B)
    jc = ref_api.init_cache(ref_cfg, B, T)
    jl, jc = ref_api.prefill(ref_cfg, jp, {k: jnp.asarray(v) for k, v
                                           in batch.items()}, jc)
    tok = _np(jl).argmax(-1).astype(np.int32)
    jd, jc = ref_api.decode_step(ref_cfg, jp, jc, jnp.asarray(tok),
                                 jnp.asarray(S, jnp.int32))
    lp, ld, pre, cache, spec = _sharded(cfg, tp, plan_name, B, batch, tok)
    for what, a, b in (("prefill", jl, lp), ("decode", jd, ld),
                       ("k", jc["k"], cache["k"]), ("v", jc["v"], cache["v"])):
        assert _steps(a, b) <= MODEL_STEPS, (what, _steps(a, b))
    for a, b in ((jl, lp), (jd, ld)):
        a = _np(a)
        top = np.sort(a, axis=-1)
        tol = MODEL_STEPS * 2.0 ** -7 * np.abs(a).max()
        clear = top[..., -1] - top[..., -2] > 2 * tol
        assert (a.argmax(-1) == b.float().numpy().argmax(-1))[clear].all()
    # the port's own one-device steps as they run
    op, od, opre, _ = _one_device(cfg, tp, B, batch, tok)
    assert torch.equal(op, lp)
    assert all(torch.equal(opre[k], pre[k]) for k in ("k", "v"))
    if spec[2] is None:                      # T whole
        assert torch.equal(od, ld)
    else:
        gap = _steps(od.float(), ld)
        assert gap <= SPLIT_T_STEPS, gap


def _float32_rows(monkeypatch):
    """The port's embeddings keep float32 rows (training's and
    serving's), so the whole step runs in float32."""
    def rows(cfg, params, tokens, prefix_embeds=None):
        x = F.embedding(tokens.long(), params["embed"])
        if prefix_embeds is None:
            return x
        n = prefix_embeds.shape[1]
        return torch.cat([prefix_embeds, x[:, n:]], dim=1)

    monkeypatch.setattr(transformer, "embed_tokens", rows)
    monkeypatch.setattr(transformer, "_embed", lambda params, tokens:
                        F.embedding(tokens.long(), params["embed"]))


@pytest.mark.parametrize("name,plan_name,B,kh", CASES[:4] + CASES[4::2])
def test_sharded_float32_rows_vs_one_device(name, plan_name, B, kh,
                                            monkeypatch):
    _float32_rows(monkeypatch)
    _, _, cfg, tp = _model(name, kh)
    batch = _batch(cfg, B, seed=2)
    op = _one_device(cfg, tp, B, batch, np.zeros(B, np.int32),
                     dtype=torch.float32)[0]
    tok = op.argmax(-1).numpy().astype(np.int32)
    op, od, _, oc = _one_device(cfg, tp, B, batch, tok, dtype=torch.float32)
    lp, ld, _, cache, _ = _sharded(cfg, tp, plan_name, B, batch, tok,
                                   torch.float32)
    for what, a, b in (("prefill", op, lp), ("decode", od, ld),
                       ("k", oc["k"], cache["k"]), ("v", oc["v"], cache["v"])):
        err = float((a - b).abs().max() / a.abs().max())
        assert err <= F32_REL, (what, err)
    assert torch.equal(ld.argmax(-1), od.argmax(-1))


def test_cache_layouts_of_the_cases():
    """The cases cover each split of the cache: heads over `model`, T
    over `model`, T over `data`, T over ("model", "data")."""
    mesh = _mesh()
    got = set()
    for name, plan_name, B, kh in CASES:
        cfg = _model(name, kh)[2]
        cache = api.init_cache(cfg, B, T, mesh=mesh, plan=get_plan(plan_name))
        got.add(tuple(cache["k"].spec))
    assert (None, "data", None, "model", None) in got
    assert (None, "data", "model", None, None) in got
    assert (None, None, "data", "model", None) in got
    assert (None, None, ("model", "data"), None, None) in got


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "zamba2-2.7b",
                                  "whisper-small"])
def test_other_families_raise_naming_the_next_item(name):
    cfg = reduced_config(name)
    mesh, plan = _mesh(), get_plan("fsdp_tp")
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A"):
        api.init_cache(cfg, 2, T, mesh=mesh, plan=plan)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A"):
        api.prefill(cfg, {}, {"tokens": torch.zeros((2, S), dtype=torch.int32)},
                    {}, mesh=mesh, plan=plan)


def test_paged_and_fp8_options_refuse():
    cfg, tp = _model("yi-6b", None)[2:]
    mesh, plan = _mesh(), get_plan("fsdp_tp")
    with pytest.raises(NotImplementedError, match="paged or fp8"):
        api.init_cache(cfg, 2, T, mesh=mesh, plan=plan, fp8_kv=True)
    with pytest.raises(NotImplementedError, match="paged"):
        api.decode_step(cfg, tp, {}, torch.zeros(2, dtype=torch.int32), 3,
                        kernel=True, mesh=mesh, plan=plan)
    with pytest.raises(ValueError, match="together"):
        api.prefill(cfg, tp, {}, {}, mesh=mesh)
