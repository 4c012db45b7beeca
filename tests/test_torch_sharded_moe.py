"""The port's sharded training step for the moe family.

Reduced moonshot-v1-16b-a3b (2 layers, d_model 64, 4 heads over 4 kv
heads, 4 experts top-2, d_ff 128, vocab 256) under the reference's
training plans on meshes spread over the CPU.  Over a mesh the experts
split over `model` and the routing stays the reference's: global over
the (micro)batch (models/moe.sharded_moe_mlp).

Against the reference (tests/test_torch_sharded_train.py's
`family_child`: its fsdp_tp step on a (2, 4) mesh of 8 forced host
devices and on one device, B=2 x S=32, seed 1): float32 rows, the loss
within 1e-5 relative and every gathered gradient within 1e-4 of its
max |g| or 1.5 times the reference's own sharded / one-device distance
for that leaf; bf16 as it runs, the loss within 7e-3 and every gradient
within 5% in L2 norm, each or 1.5 times the reference's own distance.
Against the port's one-device step (float32 rows), every plan on (2, 4)
and tp / fsdp_tp on (4, 2), (1, 8) (4 experts over 8 positions: whole
on one) and a (2, 2, 2) pod mesh: the loss within 1e-5 relative, every
gradient within 1e-4 of its max |g|.

Also: the sharded MoE MLP alone at a capacity factor with drops (the
same expert ids, drops and aux as one device, exactly; the output bit
for bit where the router's column slices round as the whole product,
else within 1e-6 relative), per-group capacity or aux would compute
another function, microbatches of the reference's rows (its
`make_train_step(n_micro=2)`), the shapes each position's experts see,
and a checkpoint restored onto another mesh and one device.
"""

import dataclasses
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs import reduced_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.tree import items_with_path
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api, convert, moe
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime import elastic
from repro_torch.runtime.trainer import Trainer
from repro_torch.sharding.plans import get_plan
from test_torch_sharded_train import (FAMILY_CASES, _unflat, case_id,
                                      equals_one_device, family_child,
                                      family_reference, hold_to_reference,
                                      keep_f32_rows, one_thread)

ARCH = "moonshot-v1-16b-a3b"
# a capacity factor at which experts drop assignments (C = 32 rows of
# the 64 an expert takes on average at T = 128; 16 of 32 at T = 64)
DROPPING = 0.5

# the reference's microbatched step (launch/train.make_train_step,
# n_micro=2) on a B=4 batch, float32 rows, at the dropping capacity
_MICRO = r"""
from repro.launch.train import make_train_step
from repro.optim.adamw import AdamW
mcfg = dataclasses.replace(cfg, capacity_factor=%r)
opt = AdamW(learning_rate=1e-3, warmup_steps=1, total_steps=10)
mb = make_batch(cfg, 4, 2)
step = jax.jit(make_train_step(mcfg, opt, n_micro=2))
new, _, metrics = step(params, opt.init(params), to_jax(mb, jnp.float32))
out.update({"micro/batch/" + k: v for k, v in mb.items()})
out["micro/loss"] = np.asarray(metrics["loss"], np.float32)
out["micro/grad_norm"] = np.asarray(metrics["grad_norm"], np.float32)
""" % DROPPING


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from one_thread()


@pytest.fixture(scope="module")
def child(tmp_path_factory):
    yield from family_child(tmp_path_factory, ARCH, _MICRO)


@pytest.fixture(scope="module")
def reference(child):
    return family_reference(child)


def _mesh(shape):
    return make_host_mesh(shape, devices=["cpu"] * int(np.prod(shape)))


def _layer_inputs(cfg, B=4, S=32):
    params = api.init(cfg, 0, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    return params, x


def _sharded_mlp(cfg, params, x, shape, plan_name="fsdp_tp"):
    """moe.sharded_moe_mlp of layer 0 over `x`'s rows split into the
    plan's data groups: (output, aux, the Dispatch it ran)."""
    mesh, plan = _mesh(shape), get_plan(plan_name,
                                        multi_pod=len(shape) == 3)
    sharded = convert.shard_params(params, cfg, mesh,
                                   rules=plan.param_rules)
    lp = T.layer_list(sharded["layers"], cfg.num_layers)[0]["moe"]
    groups = T._groups(mesh, plan, x.shape[0])
    hs = [{d: x[g.rows[0]:g.rows[1]].to(d) for d in g.devices}
          for g in groups]
    seen = []
    real = moe.dispatch

    def spy(cfg, logits):
        seen.append((logits, real(cfg, logits)))
        return seen[-1][1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "dispatch", spy)
        ys, aux = moe.sharded_moe_mlp(cfg, lp, groups, hs, T._Reader(),
                                      mesh.positions[0])
    out = torch.cat([y[g.devices[0]] for g, y in zip(groups, ys)])
    return out, aux, seen[0]


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (2, 2, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_the_sharded_moe_mlp_routes_globally(shape, child):
    """At a capacity factor with drops: the sharded MLP's router logits
    are the one-device [T, E] in global token order, its dispatch (ids,
    drop mask, slots) and aux equal `moe_mlp`'s on the whole batch
    exactly, and its output equals it bit for bit where the router's
    column slices round as the whole product (the first op that can
    differ: on (2, 4) each position's one router column is a
    matrix-vector product, which rounds its sums another way), else
    within 1e-6 relative."""
    cfg = dataclasses.replace(reduced_config(ARCH),
                              capacity_factor=DROPPING)
    params, x = _layer_inputs(cfg)
    p = T.layer_slice(params["layers"], 0)["moe"]
    want, want_aux = moe.moe_mlp(cfg, p, x)
    logits = (x.reshape(-1, cfg.d_model) @ p["router"]).float()
    r1 = moe.dispatch(cfg, logits)
    assert (~r1.keep).sum() > 0                          # drops occur
    got, aux, (got_logits, r) = _sharded_mlp(cfg, params, x, shape)
    for f in ("idx", "order", "token", "slot", "keep"):
        assert torch.equal(getattr(r, f), getattr(r1, f)), f
    assert r.capacity == r1.capacity == 32
    assert aux.item() == want_aux.item()
    np.testing.assert_allclose(got_logits.numpy(), logits.numpy(),
                               rtol=1e-6, atol=1e-6)
    if torch.equal(got_logits, logits):
        assert torch.equal(got, want)
    else:
        assert shape == (2, 4)
        scale = want.abs().max()
        assert (got - want).abs().max() <= 1e-6 * scale


def test_a_per_group_capacity_or_aux_would_fail():
    """Routing each data group alone (its own capacity from its own
    tokens, its own aux) computes another function: other drops, an
    output further than the bar from the one-device output on the
    whole batch, and a mean of per-group aux losses that is not the one
    global aux."""
    cfg = dataclasses.replace(reduced_config(ARCH),
                              capacity_factor=DROPPING)
    params, x = _layer_inputs(cfg)
    p = T.layer_slice(params["layers"], 0)["moe"]
    want, want_aux = moe.moe_mlp(cfg, p, x)
    halves = [moe.moe_mlp(cfg, p, x[:2]), moe.moe_mlp(cfg, p, x[2:])]
    per_group = torch.cat([y for y, _ in halves])
    assert (per_group - want).abs().max() > 1e-3 * want.abs().max()
    mean_aux = sum(a for _, a in halves) / 2
    assert abs(mean_aux.item() - want_aux.item()) > 1e-6
    got, aux, _ = _sharded_mlp(cfg, params, x, (2, 4))
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    assert aux.item() == want_aux.item()


@pytest.mark.parametrize("case", FAMILY_CASES, ids=case_id)
def test_every_plan_equals_the_one_device_step(case, monkeypatch):
    equals_one_device(ARCH, *case, monkeypatch)


def test_the_model_axis_splits_the_experts(monkeypatch):
    """On (2, 4) fsdp_tp each `model` position of the first data group
    runs its one expert on [1, C, d] (C from the global T = 128: 80),
    once a layer; each data group's positions form the router columns
    of their expert alone ([T/2, 1]); B9 runs each position's heads."""
    from repro_torch.models import attention
    bufs, cols, flash = [], [], []
    real = moe._expert_mlp
    monkeypatch.setattr(moe, "_expert_mlp", lambda cfg, p, bc:
                        bufs.append(tuple(bc.shape)) or real(cfg, p, bc))
    fwd = attention._attn_fwd
    monkeypatch.setattr(attention, "_attn_fwd",
                        lambda *a: flash.append(tuple(a[0].shape))
                        or fwd(*a))
    cfg = reduced_config(ARCH)
    params = api.init(cfg, 0, device="cpu")
    mesh, plan = _mesh((2, 4)), get_plan("fsdp_tp")
    sharded = convert.shard_params(params, cfg, mesh,
                                   rules=plan.param_rules)
    assert sharded["layers"]["moe"]["w_up"].axes == (None, "model", "data",
                                                     None)
    assert sharded["layers"]["moe"]["router"].axes == (None, "data",
                                                       "model")
    real_cat = torch.cat

    def spy_cat(ts, *a, **k):
        if (len(ts) == 4 and all(t.ndim == 2 for t in ts)
                and ts[0].shape == (64, 1)):
            cols.append([tuple(t.shape) for t in ts])
        return real_cat(ts, *a, **k)

    batch = {"tokens": torch.zeros((4, 32), dtype=torch.int32),
             "labels": torch.zeros((4, 32), dtype=torch.int32)}
    monkeypatch.setattr(torch, "cat", spy_cat)
    api.loss_fn(cfg, sharded, batch, mesh=mesh, plan=plan)
    monkeypatch.setattr(torch, "cat", real_cat)
    assert bufs == [(1, 80, 64)] * (4 * cfg.num_layers)
    assert cols == [[(64, 1)] * 4] * (2 * cfg.num_layers)
    assert flash == [(2, 32, 1, 16)] * (8 * cfg.num_layers)


def test_checkpoint_restores_onto_another_mesh_and_one_device():
    """A moe Trainer(mesh=(2, 4), plan=fsdp_tp) checkpoint, restored into
    a (4, 2) mesh from elastic.remesh and into a one-device Trainer:
    parameters and moments, gathered, equal the saved arrays bit for
    bit."""
    cfg = reduced_config(ARCH)
    plan = get_plan("fsdp_tp")

    def trainer(td, mesh, every):
        tcfg = TrainConfig(total_steps=50, warmup_steps=2, ckpt_every=every,
                           ckpt_dir=td, learning_rate=1e-3)
        kw = (dict(mesh=mesh, plan=plan) if mesh is not None
              else dict(device="cpu"))
        return Trainer(cfg, tcfg, data=SyntheticLMData(cfg.vocab_size, 4, 32,
                                                       seed=0), **kw)

    def gathered(tr):
        return {"params": convert.gather_params(tr.params),
                "opt": tr.opt_state._replace(
                    m=convert.gather_params(tr.opt_state.m),
                    v=convert.gather_params(tr.opt_state.v))}

    with tempfile.TemporaryDirectory() as td:
        src = trainer(td, _mesh((2, 4)), 3)
        src.init()
        src.run(3)
        saved = Checkpointer(td).restore(gathered(src))[1]
        remeshed = elastic.remesh(["cpu"] * 8, max_model=4, prefer_model=2)
        assert remeshed.shape == {"data": 4, "model": 2}
        for mesh in (remeshed, None):
            tr = trainer(td, mesh, 100)
            assert tr.resume() and tr.step == 3
            state = (gathered(tr) if mesh is not None
                     else {"params": tr.params, "opt": tr.opt_state})
            for (k, a), (_, b) in zip(items_with_path(saved),
                                      items_with_path(state)):
                assert torch.equal(a, b.detach()), k


@pytest.mark.parametrize("rows", ["float32", "bfloat16"])
def test_fsdp_tp_step_matches_the_references(reference, rows, monkeypatch):
    hold_to_reference(reference[1], ARCH, rows, monkeypatch)


def test_microbatches_take_the_references_rows(reference, monkeypatch):
    """n_micro=2 on a (2, 4) fsdp_tp mesh against the reference's
    `make_train_step(n_micro=2)` on the same B=4 batch (float32 rows,
    capacity factor 0.5: drops in every microbatch): microbatch k is
    the k-th contiguous slice of the global batch, which the sharded
    step then splits over the data groups, so each microbatch's
    capacity, drops and aux loss are the reference's: the loss within
    1e-5 relative, the gradient norm within the gradients' 1e-4."""
    _, ref = reference
    keep_f32_rows(monkeypatch)
    cfg = dataclasses.replace(reduced_config(ARCH),
                              capacity_factor=DROPPING)
    mesh, plan = _mesh((2, 4)), get_plan("fsdp_tp")
    params = convert.shard_params(
        convert.from_reference(_unflat(ref, "param/"), cfg, device="cpu"),
        cfg, mesh, rules=plan.param_rules)
    batch = {k: torch.from_numpy(v) for k, v in
             _unflat(ref, "micro/batch/").items()}
    opt = AdamW(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    step = launch_train.make_train_step(cfg, opt, n_micro=2, mesh=mesh,
                                        plan=plan)
    _, _, metrics = step(params, opt.init(params), batch)
    np.testing.assert_allclose(metrics["loss"].item(),
                               float(ref["micro/loss"]), rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(),
                               float(ref["micro/grad_norm"]), rtol=1e-4)
