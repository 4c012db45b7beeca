"""The port's sharded training step against its own one-device step.

Every training plan (dp, fsdp, tp, fsdp_tp, fsdp_tp_sp, fsdp_tp_spact)
on meshes spread over the CPU: (2, 4), (4, 2), (1, 8) (reduced yi-6b's
4 heads fall back to replicated over 8 `model` positions while its 128
MLP columns split) and a (2, 2, 2) ("pod", "data", "model") mesh under
``plan.with_pod()``; reduced yi-6b (4 heads over 4 KV heads) and
reduced internvl2-1b (4 q heads over 2 KV heads, tied embeddings,
``prefix_embeds``): at model=4 its KV heads fall back to replicated and
each position attends its one q head against its kv head.  B=4, S=32.

Bars (tests/test_torch_train.py's): with float32 rows (both
embeddings' lookups kept float32, so the step runs in float32), the
loss within 1e-5 relative and every gathered gradient within 1e-4 of
its max |g|; as it runs (bf16), every gradient within 5% in L2 norm.

Also: microbatching on the mesh (n_micro=2 against 1), a replicated
norm scale updated once on a spread mesh, the sharded Trainer's
restart bit for bit, a checkpoint saved on one mesh restored onto
another mesh and onto one device (runtime/elastic.remesh), the
vocab-parallel cross-entropy and its chunked loop, the meshes and the
refusals (a family the port does not have).
"""

import dataclasses
import tempfile

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs import reduced_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.tree import items_with_path, leaves
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train as launch_train
from repro_torch.models import api, common, convert, transformer
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime import elastic
from repro_torch.runtime.trainer import Trainer, value_and_grad
from repro_torch.sharding.axes import Sharded
from repro_torch.sharding.plans import batch_placement, get_plan

ARCHS = ("yi-6b", "internvl2-1b")
MESHES = ((2, 4), (4, 2), (1, 8), (2, 2, 2))
PLANS = ("dp", "fsdp", "tp", "fsdp_tp", "fsdp_tp_sp", "fsdp_tp_spact")


def _mesh(shape):
    n = int(np.prod(shape))
    return mesh_mod.make_host_mesh(shape, devices=["cpu"] * n)


def _plan(name, shape):
    return get_plan(name, multi_pod=len(shape) == 3)


def _keep_f32_rows(monkeypatch):
    monkeypatch.setattr(
        transformer, "embed_tokens",
        lambda cfg, params, tokens, prefix_embeds=None:
        F.embedding(tokens.long(), params["embed"]))


def _batch(cfg, B=4, S=32, seed=1):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1))
                            .astype(np.int32))
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        out["prefix_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
        ).to(torch.bfloat16)
    return out


_ONE_DEVICE = {}


def _one_device(arch, rows):
    """(cfg, params, batch, loss, gradients by key) of the one-device
    step (computed once a module)."""
    key = (arch, rows)
    if key not in _ONE_DEVICE:
        cfg = reduced_config(arch)
        params = api.init(cfg, 0, device="cpu")
        batch = _batch(cfg)
        loss, grads = value_and_grad(cfg, params, batch)
        _ONE_DEVICE[key] = (cfg, params, batch, loss.item(),
                            dict(items_with_path(grads)))
    return _ONE_DEVICE[key]


def _check_grads(got_sharded, want, rows):
    full = convert.gather_params(got_sharded)
    keys = [k for k, _ in items_with_path(full)]
    assert sorted(keys) == sorted(want)
    for key, g in items_with_path(full):
        a, b = want[key], g
        assert a.shape == b.shape, key
        if rows == "float32":
            assert (a - b).abs().max() <= 1e-4 * a.abs().max(), key
        else:
            assert torch.linalg.norm(a - b) <= 0.05 * torch.linalg.norm(a), \
                key


@pytest.mark.parametrize("plan_name", PLANS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_plan_equals_the_one_device_step(arch, shape, plan_name,
                                               monkeypatch):
    _keep_f32_rows(monkeypatch)
    cfg, params, batch, want_loss, want = _one_device(arch, "float32")
    mesh, plan = _mesh(shape), _plan(plan_name, shape)
    sharded = convert.shard_params(params, cfg, mesh,
                                   rules=plan.param_rules)
    loss, grads = value_and_grad(cfg, sharded, batch, mesh=mesh, plan=plan)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    _check_grads(grads, want, "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_tp_bf16_equals_the_one_device_step(arch):
    """As it runs (bf16 activations): 5% of each gradient's norm."""
    cfg, params, batch, want_loss, want = _one_device(arch, "bfloat16")
    mesh, plan = _mesh((2, 4)), get_plan("fsdp_tp")
    sharded = convert.shard_params(params, cfg, mesh,
                                   rules=plan.param_rules)
    loss, grads = value_and_grad(cfg, sharded, batch, mesh=mesh, plan=plan)
    assert abs(loss.item() - want_loss) <= 7e-3
    _check_grads(grads, want, "bfloat16")


def test_the_model_axis_splits_the_compute(monkeypatch):
    """Each (data, model) position attends its own heads: B9 (the plain
    forward here) sees [B/data, S, H/model, hd] a call, 8 calls a layer
    on (2, 4), and the partial sums are tagged as cross-shard sums."""
    from repro_torch.models import attention
    shapes, tags = [], []
    fwd = attention._attn_fwd
    monkeypatch.setattr(attention, "_attn_fwd",
                        lambda *a: shapes.append((tuple(a[0].shape),
                                                  a[1].shape[2]))
                        or fwd(*a))
    monkeypatch.setattr(transformer, "xshard_sum", lambda parts, devs, tag:
                        tags.append((tag, len(parts)))
                        or common.xshard_sum(parts, devs, tag=tag))
    cfg, params, batch, _, _ = _one_device("yi-6b", "bfloat16")
    mesh, plan = _mesh((2, 4)), get_plan("fsdp_tp")
    sharded = convert.shard_params(params, cfg, mesh,
                                   rules=plan.param_rules)
    api.loss_fn(cfg, sharded, batch, mesh=mesh, plan=plan)
    assert shapes == [((2, 32, 1, 16), 1)] * (8 * cfg.num_layers)
    assert tags == [("xshard_attn_out", 4), ("xshard_mlp_down", 4)] * (
        2 * cfg.num_layers)


def test_layout_owners_and_the_round_trip():
    """shard_params lays each leaf by the plan's specs, one owner a
    distinct block on the first position holding it; gather_params
    puts them back bit for bit; fsdp_tp puts `embed` on `data` (the
    norm scales too) and heads, kv_heads, mlp and vocab on `model`."""
    cfg = reduced_config("yi-6b")
    params = api.init(cfg, 0, device="cpu")
    mesh = _mesh((2, 4))
    sharded = convert.shard_params(params, cfg, mesh,
                                   rules=get_plan("fsdp_tp").param_rules)
    assert sharded["final_norm"]["scale"].axes == ("data",)
    assert sharded["embed"].axes == ("model", "data")
    assert sharded["layers"]["attn"]["wq"].axes == (None, "data", "model",
                                                    None)
    assert sharded["layers"]["mlp"]["w_down"].axes == (None, "model", "data")
    assert len(sharded["embed"].blocks) == 8
    assert len(sharded["final_norm"]["scale"].blocks) == 2
    assert sharded["embed"].blocks[(0, 1)].shape == (64, 32)
    for a, b in zip(leaves(params), leaves(convert.gather_params(sharded))):
        assert torch.equal(a, b)
    n = sum(b.numel() for b in leaves(sharded))
    assert n == sum(p.numel() for p in leaves(params))
    tp = convert.shard_params(params, cfg, mesh,
                              rules=get_plan("tp").param_rules)
    assert len(tp["final_norm"]["scale"].blocks) == 1
    with pytest.raises(ValueError):
        convert.shard_params(params, cfg, mesh, "data", rules={})


def test_batch_placement():
    plan = get_plan("fsdp_tp")
    place = batch_placement(plan, 4, _mesh((2, 4)))
    assert place.axes == ("data",) and place.rows == ((0, 2), (2, 4))
    assert place.position_rows(_mesh((2, 4))) == [(0, 2)] * 4 + [(2, 4)] * 4
    pod = batch_placement(get_plan("dp", multi_pod=True), 4,
                          _mesh((2, 2, 2)))
    assert pod.axes == ("pod", "data") and len(pod.rows) == 4
    # B=2 over data=4: replicated (batch_pspec's fallback): one group
    assert batch_placement(plan, 2, _mesh((4, 2))).rows == ((0, 2),)


@pytest.mark.parametrize("shape", [(2, 4), (2, 2, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_microbatches_on_the_mesh(shape, monkeypatch):
    """n_micro=2 against n_micro=1 under fsdp_tp: each microbatch takes
    half of every data group's rows; the same loss, norm and update
    within float32 rounding (float32 rows)."""
    _keep_f32_rows(monkeypatch)
    cfg = reduced_config("yi-6b")
    mesh, plan = _mesh(shape), _plan("fsdp_tp", shape)
    batch = _batch(cfg, B=8)
    outs = []
    for n_micro in (1, 2):
        opt = AdamW(learning_rate=1e-3, warmup_steps=1, total_steps=10)
        params = convert.shard_params(api.init(cfg, 0, device="cpu"), cfg,
                                      mesh, rules=plan.param_rules)
        step = launch_train.make_train_step(cfg, opt, n_micro=n_micro,
                                            mesh=mesh, plan=plan)
        params, _, metrics = step(params, opt.init(params), batch)
        outs.append((metrics, leaves(convert.gather_params(params))))
    (m1, p1), (m2, p2) = outs
    np.testing.assert_allclose(m2["loss"].item(), m1["loss"].item(),
                               rtol=1e-5)
    np.testing.assert_allclose(m2["grad_norm"].item(),
                               m1["grad_norm"].item(), rtol=1e-5)
    for a, b in zip(p1, p2):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="microbatches"):
        launch_train.make_train_step(cfg, AdamW(), n_micro=3, mesh=mesh,
                                     plan=plan)(params, None, batch)


def test_replicated_norm_scale_is_updated_once(monkeypatch):
    """On a spread mesh every position holds the replicated norm scales
    (tp puts nothing of them on a mesh axis): one owner tensor, updated
    once a step and counted once in the global norm, so its new value
    is the one-device step's, not moved by 8 updates."""
    _keep_f32_rows(monkeypatch)
    cfg = reduced_config("yi-6b")
    mesh, plan = _mesh((2, 4)), get_plan("tp")
    batch = _batch(cfg)
    lr = 1e-3
    results = []
    for sharded in (False, True):
        opt = AdamW(learning_rate=lr, warmup_steps=1, total_steps=10)
        params = api.init(cfg, 0, device="cpu")
        kw = {}
        if sharded:
            params = convert.shard_params(params, cfg, mesh,
                                          rules=plan.param_rules)
            kw = dict(mesh=mesh, plan=plan)
            assert len(params["layers"]["ln1"]["scale"].blocks) == 1
        step = launch_train.make_train_step(cfg, opt, **kw)
        params, state, metrics = step(params, opt.init(params), batch)
        scale = params["layers"]["ln1"]["scale"]
        results.append((scale.full() if sharded else scale,
                        metrics["grad_norm"].item()))
    (want, n1), (got, n8) = results
    np.testing.assert_allclose(n8, n1, rtol=1e-5)
    # one AdamW step moves each element by ~lr (the first step's update
    # is g / |g| plus the decay): a second update would move it ~lr more
    assert (got - want).abs().max().item() <= 0.01 * lr
    assert (got - 1.0).abs().min().item() >= 0.5 * lr


def _trainer(td, mesh, plan, fail_at=None, ckpt_every=2):
    cfg = reduced_config("yi-6b")
    tcfg = TrainConfig(total_steps=50, warmup_steps=2, ckpt_every=ckpt_every,
                       ckpt_dir=td, learning_rate=1e-3)
    kw = (dict(mesh=mesh, plan=plan) if mesh is not None
          else dict(device="cpu"))
    return Trainer(cfg, tcfg, data=SyntheticLMData(cfg.vocab_size, 4, 32,
                                                   seed=0),
                   fail_at_step=fail_at, **kw)


def test_sharded_trainer_restarts_bit_exact():
    """A (2, 4) fsdp_tp run that fails after its fifth step and restarts
    from its step-4 checkpoint gives the losses of an uninterrupted run
    bit for bit; the losses fall."""
    mesh, plan = _mesh((2, 4)), get_plan("fsdp_tp")
    runs = []
    for fail_at in (5, None):
        with tempfile.TemporaryDirectory() as td:
            tr = _trainer(td, mesh, plan, fail_at=fail_at)
            tr.init()
            hist = tr.run(8)
            runs.append(({m.step: m.loss for m in hist}, tr.restarts))
    (a, restarts), (b, _) = runs
    assert restarts == 1 and sorted(a) == list(range(1, 9))
    assert all(a[s] == b[s] for s in b), (a, b)
    assert b[8] < b[1]


def test_checkpoint_restores_onto_another_mesh_and_one_device(
        monkeypatch):
    """Saved from a (2, 4) fsdp_tp Trainer; restored into a (4, 2) mesh
    from elastic.remesh and into a one-device Trainer: the parameters
    and moments, gathered, equal the saved arrays bit for bit, and two
    more steps on each agree within float32 rounding (float32 rows)."""
    _keep_f32_rows(monkeypatch)
    plan = get_plan("fsdp_tp")
    with tempfile.TemporaryDirectory() as td:
        src = _trainer(td, _mesh((2, 4)), plan, ckpt_every=3)
        src.init()
        src.run(3)
        saved = Checkpointer(td).restore(
            {"params": convert.gather_params(src.params),
             "opt": src.opt_state._replace(
                 m=convert.gather_params(src.opt_state.m),
                 v=convert.gather_params(src.opt_state.v))})[1]
        remeshed = elastic.remesh(["cpu"] * 8, max_model=4, prefer_model=2)
        assert remeshed.shape == {"data": 4, "model": 2}
        losses = []
        for mesh in (remeshed, None):
            tr = _trainer(td, mesh, plan if mesh is not None else None,
                          ckpt_every=100)
            assert tr.resume() and tr.step == 3
            state = {"params": tr.params, "opt": tr.opt_state}
            if mesh is not None:
                assert tr.params["embed"].mesh is remeshed
                state = {"params": convert.gather_params(tr.params),
                         "opt": tr.opt_state._replace(
                             m=convert.gather_params(tr.opt_state.m),
                             v=convert.gather_params(tr.opt_state.v))}
            for (k, a), (_, b) in zip(items_with_path(saved),
                                      items_with_path(state)):
                assert torch.equal(a, b.detach()), k
            losses.append([m.loss for m in tr.run(2)])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "falcon-mamba-7b",
                                  "zamba2-2.7b", "whisper-small"])
def test_other_families_raise(arch):
    """Every family the port has trains sharded (the families' own files,
    tests/test_torch_sharded_{moe,ssm,hybrid,encdec}.py, hold them to
    the reference); a family the port does not have raises, naming it,
    on a mesh as on one device."""
    cfg = reduced_config(arch)
    mesh, plan = _mesh((2, 4)), get_plan("tp")
    Trainer(cfg, TrainConfig(), data=None, mesh=mesh, plan=plan)
    other = dataclasses.replace(cfg, family="retnet")
    with pytest.raises(NotImplementedError,
                       match="family 'retnet' is not ported yet"):
        api.loss_fn(other, {}, {}, mesh=mesh, plan=plan)
    with pytest.raises(NotImplementedError, match="'retnet'"):
        Trainer(other, TrainConfig(), data=None, mesh=mesh, plan=plan)


@pytest.mark.parametrize("chunk", [0, 5, 16])
def test_vocab_parallel_xent(chunk):
    """The cross-entropy over 4 vocab shards (combined in shard order)
    against `cross_entropy` over the whole vocab, and its gradients; the
    chunked loop equals one block."""
    g = torch.Generator().manual_seed(0)
    T, d, V = 24, 8, 32
    h = torch.randn((T, d), generator=g, requires_grad=True)
    w = torch.randn((d, V), generator=g, requires_grad=True)
    labels = torch.randint(0, V, (T,), generator=g)
    want = common.cross_entropy(h @ w, labels) * T
    ws = list(w.split(V // 4, dim=1))
    got = common.vocab_parallel_xent_sum(
        [h] * 4, ws, [labels] * 4, [r * V // 4 for r in range(4)],
        torch.device("cpu"), chunk=chunk)
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-6)
    for a, b in zip(torch.autograd.grad(want, (h, w)),
                    torch.autograd.grad(got, (h, w))):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_host_meshes():
    m = mesh_mod.make_host_mesh((2, 4), spread="cpu")
    assert m.shape == {"data": 2, "model": 4} and m.physical == [
        torch.device("cpu")]
    p = mesh_mod.make_host_mesh((2, 2, 2), spread="cpu")
    assert p.axis_names == ("pod", "data", "model")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="spread"):
            mesh_mod.make_host_mesh((2, 4))
        with pytest.raises(RuntimeError):
            mesh_mod.make_host_mesh((2, 4), spread="cuda")
    with pytest.raises(ValueError):
        mesh_mod.make_host_mesh((2, 4), devices=["cpu"] * 4)
    s = Sharded.from_full(torch.arange(8.0).reshape(2, 4), ("data", "model"),
                          m)
    assert torch.equal(s.at({"data": 1, "model": 0}, "cpu", gather="data"),
                       torch.tensor([[0.0], [4.0]]))


def test_a_mesh_the_plan_does_not_fit_raises():
    cfg = reduced_config("yi-6b")
    params = api.init(cfg, 0, device="cpu")
    tp = mesh_mod.make_tp_mesh(2, spread="cpu")
    with pytest.raises(ValueError, match="not mesh axes"):
        convert.shard_params(params, cfg, tp,
                             rules=get_plan("tp").param_rules)
    plan = get_plan("dp")
    with pytest.raises(ValueError, match="does not fit"):
        api.loss_fn(cfg, convert.shard_params(params, cfg, tp,
                                              rules=plan.param_rules),
                    _batch(cfg), mesh=tp, plan=plan)
    with pytest.raises(ValueError, match="together"):
        api.loss_fn(cfg, params, _batch(cfg), mesh=tp)
