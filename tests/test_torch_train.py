"""Port vs reference: the training path.

Losses (`cross_entropy`, `chunked_softmax_xent`), `loss_fn` and its
gradients on reduced configs with the reference's weights
(`convert.from_reference`), remat policies, AdamW, the synthetic data
pipeline, the checkpointer, the fault-tolerant `Trainer` and the
microbatched train step of `launch/train.py`.

Tolerances:
* float32 losses and their gradients: 1e-6 / 1e-5 (the same float32
  operations summed in another order);
* `loss_fn` with float32 activations (both embeddings patched to keep
  float32 rows): loss within 1e-5 relative, every gradient within 1e-4
  of its max |g|: the algorithm, held tight;
* `loss_fn` as it runs (bf16 activations): loss within 2e-3, every
  gradient within 0.05 of its norm (||a - b|| <= 0.05 ||a||).  XLA and
  torch round a bf16 value on a boundary another way (LOGIT_STEPS of
  tests/test_torch_transformer.py), the backward carries it through
  every layer, and the reference adds repeated tokens' embedding
  gradients in bf16 where the port adds them in float32;
* AdamW on the same tree: float32 leaves within 1e-6 (bitwise in
  practice), the global norm within 1e-6 relative;
* a 3-step `Trainer` run against the reference's from the same weights
  and data: with float32 activations each loss within 1e-5 relative;
  as it runs (bf16), the first loss within 2e-3 (as `loss_fn`) and the
  later ones within 1e-2: AdamW's normalised step turns a rounding-level
  difference in a near-zero gradient element into a full +-lr step.
Remat policies and microbatching change memory, never numbers: remat
is held bitwise, `n_micro=2` against `n_micro=1` within float32
rounding (float32 activations: 1e-5 relative, the same products summed
over fewer rows at a time).
"""

import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.ckpt import checkpoint as ref_ckpt
from repro.configs import reduced_config as ref_reduced_config
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.data.pipeline import SyntheticLMData as RefData
from repro.models import api as ref_api
from repro.models import common as ref_common
from repro.models import transformer as ref_transformer
from repro.optim import adamw as ref_adamw
from repro.runtime.trainer import Trainer as RefTrainer
from repro_torch.ckpt.checkpoint import Checkpointer, _flatten
from repro_torch.configs import reduced_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.tree import items_with_path, leaves, tree_map
from repro_torch.data.pipeline import Prefetcher, SyntheticLMData
from repro_torch.launch import train as launch_train
from repro_torch.models import api, attention, common, convert, transformer
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.runtime.trainer import Trainer, value_and_grad


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(jax.device_get(x), np.float32)


# ----------------------------------------------------------------------
# losses
# ----------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_vs_reference(masked):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 5, 37))).astype(np.float32)
    labels = rng.integers(0, 37, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32) if masked else None
    want = ref_common.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    None if mask is None else
                                    jnp.asarray(mask))
    got = common.cross_entropy(_t(logits), _t(labels),
                               None if mask is None else _t(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_softmax_xent_vs_reference(masked):
    """45 tokens through chunks of 8 (a padded last chunk): the value
    and the gradients of x and w_out."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((45, 16)).astype(np.float32)
    w = (0.3 * rng.standard_normal((16, 37))).astype(np.float32)
    labels = rng.integers(0, 37, (45,)).astype(np.int32)
    mask = (rng.random(45) > 0.3).astype(np.float32) if masked else None

    def ref_fn(x, w):
        return ref_common.chunked_softmax_xent(
            x, w, jnp.asarray(labels), chunk=8,
            mask=None if mask is None else jnp.asarray(mask))

    want, (gx, gw) = jax.value_and_grad(ref_fn, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    got = common.chunked_softmax_xent(tx, tw, _t(labels), chunk=8,
                                      mask=None if mask is None else _t(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    for a, b in zip((gx, gw), torch.autograd.grad(got, (tx, tw))):
        np.testing.assert_allclose(b.numpy(), _np(a), rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------
# loss_fn and its gradients
# ----------------------------------------------------------------------

def _configs(kv_heads, remat="none"):
    return (dataclasses.replace(ref_reduced_config("yi-6b"),
                                num_kv_heads=kv_heads, remat=remat),
            dataclasses.replace(reduced_config("yi-6b"),
                                num_kv_heads=kv_heads, remat=remat))


def _bridge(ref_params, cfg):
    return convert.from_reference(jax.tree_util.tree_map(np.asarray,
                                                         ref_params),
                                  cfg, device="cpu")


def _batch(seed=0, B=2, S=32, vocab=256):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    toks = toks.astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": _t(toks[:, :-1]), "labels": _t(toks[:, 1:])}
    return jb, tb


def _keep_f32_rows(monkeypatch):
    """Both packages' embeddings keep float32 rows: the whole forward
    and backward then run in float32."""
    monkeypatch.setattr(
        ref_transformer, "embed_tokens",
        lambda cfg, params, tokens, prefix_embeds=None:
        params["embed"][tokens])
    monkeypatch.setattr(
        transformer, "embed_tokens",
        lambda cfg, params, tokens, prefix_embeds=None:
        F.embedding(tokens.long(), params["embed"]))


@pytest.mark.parametrize("activations", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_loss_fn_and_grads_vs_reference(kv_heads, activations, monkeypatch):
    if activations == "float32":
        _keep_f32_rows(monkeypatch)
    ref_cfg, cfg = _configs(kv_heads)
    jp = ref_api.init(ref_cfg, jax.random.PRNGKey(0))
    tp = _bridge(jp, cfg)
    jb, tb = _batch()
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: ref_api.loss_fn(ref_cfg, p, jb)))(jp)
    tl, tg = value_and_grad(cfg, tp, tb)
    if activations == "float32":
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    else:
        assert abs(tl.item() - float(jl)) <= 2e-3, (tl.item(), float(jl))
    paths = [k for k, _ in items_with_path(tp)]
    want = dict(zip(paths, jax.tree_util.tree_leaves(jg)))
    for key, g in items_with_path(tg):
        a, b = _np(want[key]), g.float().numpy()
        assert a.shape == b.shape, key
        if activations == "float32":
            assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max(), key
        else:
            assert np.linalg.norm(a - b) <= 0.05 * np.linalg.norm(a), key


def test_remat_policies_bitwise_equal(monkeypatch):
    """none / full / dots / full_save_attn: equal losses and gradients
    bit for bit; the remat policies recompute the attention forward in
    the backward, once a layer."""
    calls = []
    fwd = attention._attn_fwd
    monkeypatch.setattr(attention, "_attn_fwd",
                        lambda *a: calls.append(1) or fwd(*a))
    _, tb = _batch(seed=3)
    base = None
    for remat in ("none", "full", "dots", "full_save_attn"):
        cfg = dataclasses.replace(reduced_config("yi-6b"), num_kv_heads=2,
                                  remat=remat)
        params = api.init(cfg, 0, device="cpu")
        calls.clear()
        loss, grads = value_and_grad(cfg, params, tb)
        want_calls = cfg.num_layers * (1 if remat == "none" else 2)
        assert len(calls) == want_calls, (remat, len(calls))
        if base is None:
            base = (loss, leaves(grads))
            continue
        assert torch.equal(loss, base[0]), remat
        for a, b in zip(leaves(grads), base[1]):
            assert torch.equal(a, b), remat


def test_big_vocab_switch_goes_through_chunked_xent(monkeypatch):
    """vocab * S * B > 2**28 takes the chunked cross-entropy, as the
    reference does; below it, one logits product."""
    seen = []
    chunked = transformer.chunked_softmax_xent
    monkeypatch.setattr(transformer, "chunked_softmax_xent",
                        lambda *a, **k: seen.append(1) or chunked(*a, **k))
    cfg = reduced_config("yi-6b")
    params = api.init(cfg, 0, device="cpu")
    _, tb = _batch()
    small = transformer.loss_fn(cfg, params, tb)
    assert not seen
    big = dataclasses.replace(cfg, vocab_size=2 ** 28 // 64 + 1)
    transformer.loss_fn(big, params, tb)      # padded vocab columns read
    assert seen
    assert torch.isfinite(small)


# ----------------------------------------------------------------------
# AdamW
# ----------------------------------------------------------------------

def _tree(rng, L=2):
    return {"layers": {"w": rng.standard_normal((L, 6, 5)).astype(np.float32),
                       "scale": rng.standard_normal((L, 5)).astype(np.float32)},
            "bias": rng.standard_normal((7,)).astype(np.float32)}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_adamw_vs_reference(moment_dtype, grad_clip):
    """Four steps on the same tree and gradients.  The stacked [L, d]
    norm scales have ndim >= 2 and are decayed in both (a property of
    the reference, kept)."""
    rng = np.random.default_rng(2)
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=6,
              grad_clip=grad_clip, moment_dtype=moment_dtype)
    jopt, topt = ref_adamw.AdamW(**kw), AdamW(**kw)
    p0 = _tree(rng)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = tree_map(_t, p0)
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts.m["bias"].dtype == getattr(torch, moment_dtype)
    for _ in range(4):
        g = _tree(rng)
        jp, js, jm = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js,
                                 jp)
        tp, ts, tm = topt.update(tree_map(_t, g), ts, tp)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]),
                                   rtol=1e-7)
        for a, b in zip(jax.tree_util.tree_leaves(jp), leaves(tp)):
            np.testing.assert_allclose(b.numpy(), _np(a), rtol=1e-6,
                                       atol=1e-6)
        for a, b in zip(jax.tree_util.tree_leaves((js.m, js.v)),
                        leaves(ts.m) + leaves(ts.v)):
            np.testing.assert_allclose(b.float().numpy(), _np(a),
                                       rtol=1e-6, atol=1e-6)
    assert int(ts.step) == int(js.step) == 4
    assert ts.step.dtype == torch.int32 and ts.step.ndim == 0


def test_adamw_schedule_vs_reference():
    kw = dict(learning_rate=3e-4, warmup_steps=3, total_steps=11)
    jopt, topt = ref_adamw.AdamW(**kw), AdamW(**kw)
    for step in range(14):
        np.testing.assert_allclose(
            topt.schedule(torch.tensor(step, dtype=torch.int32)).item(),
            float(jopt.schedule(jnp.asarray(step, jnp.int32))), rtol=1e-7)


# ----------------------------------------------------------------------
# data, checkpoints
# ----------------------------------------------------------------------

def test_synthetic_data_equals_reference():
    jd, td = RefData(1000, 3, 16, seed=4), SyntheticLMData(1000, 3, 16,
                                                           seed=4)
    jit, tit = jd.batches(5), td.batches(5)
    for _ in range(3):
        a, b = next(jit), next(tit)
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert b[k].dtype == torch.int32
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))
    pf = Prefetcher(td.batches(0), depth=2)
    first = next(pf)
    pf.close()
    np.testing.assert_array_equal(first["tokens"].numpy(),
                                  td._host_batch(0)["tokens"])


def _ckpt_tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.bfloat16),
                  "d": torch.tensor(3, dtype=torch.int32)},
            "opt": AdamWState(step=torch.tensor(2, dtype=torch.int32),
                              m={"w": torch.full((2,), 0.5)},
                              v={"w": torch.full((2,), 0.25)})}


def test_ckpt_roundtrip_exact_and_reference_layout():
    t = _ckpt_tree()
    with tempfile.TemporaryDirectory() as td:
        ck = Checkpointer(td, async_save=False)
        ck.save(7, t)
        step, back = ck.restore(t)
        assert step == 7
        for a, b in zip(leaves(t), leaves(back)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert sorted(os.listdir(os.path.join(td, "step_00000007"))) == [
            "arrays.npz", "manifest.json"]
    # the same keys as the reference's checkpoint of the same tree
    jt = {"a": jnp.zeros((3, 4)),
          "b": {"c": jnp.ones(5, jnp.bfloat16), "d": jnp.asarray(3)},
          "opt": ref_adamw.AdamWState(step=jnp.asarray(2),
                                      m={"w": jnp.zeros(2)},
                                      v={"w": jnp.zeros(2)})}
    assert sorted(_flatten(t)) == sorted(ref_ckpt._flatten(jt))


def test_ckpt_gc_crash_safety_and_async():
    with tempfile.TemporaryDirectory() as td:
        ck = Checkpointer(td, keep=2, async_save=False)
        for s in (1, 2, 3, 4):
            ck.save(s, _ckpt_tree())
        assert ck.all_steps() == [3, 4] and ck.latest_step() == 4
        # a crash mid-save: a stray .tmp directory without a manifest
        os.makedirs(os.path.join(td, "step_00000005.tmp"))
        assert ck.latest_step() == 4
        assert ck.restore(_ckpt_tree())[0] == 4
    with tempfile.TemporaryDirectory() as td:
        ck = Checkpointer(td, async_save=True)
        ck.save(5, _ckpt_tree())
        ck.wait()
        assert ck.latest_step() == 5
        with pytest.raises(FileNotFoundError):
            Checkpointer(os.path.join(td, "empty")).restore(_ckpt_tree())


# ----------------------------------------------------------------------
# the trainer (tests/test_runtime.py:29-77 on the port)
# ----------------------------------------------------------------------

def _trainer(td, fail_at=None, kv_heads=None):
    cfg = reduced_config("yi-6b")
    if kv_heads:
        cfg = dataclasses.replace(cfg, num_kv_heads=kv_heads)
    tcfg = TrainConfig(total_steps=50, warmup_steps=2, ckpt_every=4,
                       ckpt_dir=td, learning_rate=1e-3)
    return Trainer(cfg, tcfg,
                   data=SyntheticLMData(cfg.vocab_size, 4, 32, seed=0),
                   fail_at_step=fail_at, device="cpu"), cfg


def test_trainer_loss_decreases():
    with tempfile.TemporaryDirectory() as td:
        tr, _ = _trainer(td)
        tr.init()
        hist = tr.run(10)
        assert len(hist) == 10
        assert hist[-1].loss < hist[0].loss
        assert all(np.isfinite(m.loss) for m in hist)


def test_trainer_survives_failure_bit_exact():
    with tempfile.TemporaryDirectory() as td:
        tr, _ = _trainer(td, fail_at=6)
        tr.init()
        hist = tr.run(10)
        assert tr.restarts == 1 and tr.step == 10
    with tempfile.TemporaryDirectory() as td:
        tr2, _ = _trainer(td)
        tr2.init()
        h2 = tr2.run(10)
    a = {m.step: m.loss for m in hist}
    b = {m.step: m.loss for m in h2}
    for s in range(5, 11):
        assert a[s] == b[s], (s, a[s], b[s])


def test_trainer_resume_from_checkpoint():
    with tempfile.TemporaryDirectory() as td:
        tr, cfg = _trainer(td)
        tr.init()
        tr.run(8)
        tcfg = TrainConfig(total_steps=50, warmup_steps=2, ckpt_every=4,
                           ckpt_dir=td, learning_rate=1e-3)
        tr2 = Trainer(cfg, tcfg, device="cpu",
                      data=SyntheticLMData(cfg.vocab_size, 4, 32, seed=0))
        assert tr2.resume()
        assert tr2.step == 8
        for a, b in zip(leaves(tr.params), leaves(tr2.params)):
            assert torch.equal(a.detach(), b)
        tr2.run(2)
        assert tr2.step == 10


def test_trainer_straggler_watchdog():
    with tempfile.TemporaryDirectory() as td:
        tr, _ = _trainer(td)
        tr._ewma = 1e-9               # everything looks slow now
        assert tr._watchdog(1.0) is True
        assert tr.straggler_events == 1
        with pytest.raises(RuntimeError, match="init"):
            tr.run(1)


@pytest.mark.parametrize("activations", ["float32", "bfloat16"])
def test_trainer_matches_reference_trainer(activations, monkeypatch):
    """Three steps of both trainers from the reference's weights on the
    same data (GQA, G = 2)."""
    if activations == "float32":
        _keep_f32_rows(monkeypatch)
    with tempfile.TemporaryDirectory() as td:
        ref_cfg = dataclasses.replace(ref_reduced_config("yi-6b"),
                                      num_kv_heads=2)
        rt = RefTrainer(ref_cfg,
                        RefTrainConfig(total_steps=50, warmup_steps=2,
                                       ckpt_every=100, ckpt_dir=td,
                                       learning_rate=1e-3),
                        data=RefData(ref_cfg.vocab_size, 4, 32, seed=0))
        rt.init()
        start = jax.tree_util.tree_map(np.asarray, rt.params)
        want = [m.loss for m in rt.run(3)]
    with tempfile.TemporaryDirectory() as td:
        tr, cfg = _trainer(td, kv_heads=2)
        tr.device = torch.device("cpu")
        tr.params = convert.from_reference(start, cfg, device="cpu")
        tr.opt_state = tr.opt.init(tr.params)
        got = [m.loss for m in tr.run(3)]
    if activations == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        np.testing.assert_allclose(got[0], want[0], atol=2e-3)
        np.testing.assert_allclose(got, want, atol=1e-2)


@pytest.mark.parametrize("acc_dtype", [None, torch.float32])
def test_launch_train_microbatches(acc_dtype, monkeypatch):
    """n_micro = 2 against n_micro = 1: the same gradients and the same
    update within float32 rounding (float32 activations)."""
    _keep_f32_rows(monkeypatch)
    cfg = dataclasses.replace(reduced_config("yi-6b"), num_kv_heads=2)
    _, tb = _batch(seed=5, B=4, S=16)
    outs = []
    for n_micro in (1, 2):
        opt = AdamW(learning_rate=1e-3, warmup_steps=1, total_steps=10)
        params = api.init(cfg, 0, device="cpu")
        step = launch_train.make_train_step(cfg, opt, n_micro=n_micro,
                                            acc_dtype=acc_dtype)
        params, state, metrics = step(params, opt.init(params), tb)
        outs.append((metrics, leaves(params)))
    (m1, p1), (m2, p2) = outs
    np.testing.assert_allclose(m2["loss"].item(), m1["loss"].item(),
                               rtol=1e-5)
    np.testing.assert_allclose(m2["grad_norm"].item(),
                               m1["grad_norm"].item(), rtol=1e-5)
    for a, b in zip(p1, p2):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_launch_train_cli_and_microbatch_estimate():
    with tempfile.TemporaryDirectory() as td:
        hist = launch_train.main(["--device", "cpu", "--steps", "3",
                                  "--batch", "2", "--seq", "16",
                                  "--ckpt-dir", td])
        assert [m.step for m in hist] == [1, 2, 3]
        assert os.listdir(td)
    from repro.configs import get_config as ref_get_config
    from repro.launch import train as ref_launch_train
    from repro_torch.configs import get_config
    for arch in ("yi-6b", "command-r-35b", "llama-te-mini"):
        for tokens in (1e3, 4096 * 8, 4096 * 256):
            assert launch_train.estimate_microbatches(
                get_config(arch), tokens) == \
                ref_launch_train.estimate_microbatches(
                    ref_get_config(arch), tokens)
