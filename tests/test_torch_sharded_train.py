"""The port's sharded training step against the reference's.

The reference's setting is tests/test_distributed.py's: reduced yi-6b
(2 layers, 4 heads, 4 KV heads, d_ff 128, vocab 256) under
``get_plan("fsdp_tp")`` on a (2, 4) ("data", "model") mesh, weights
from ``api.init(PRNGKey(0))``.  A module-scoped child with 8 forced
host devices runs the reference's sharded ``value_and_grad`` of
``api.loss_fn`` on a numpy batch (B=2, S=32, seed 1), as it runs (bf16
activations) and with both embeddings patched to keep float32 rows
(tests/test_torch_train.py's ``_keep_f32_rows``), and saves the losses,
the gradients and their global norms.  The port takes the same weights
(``convert.from_reference``) onto a (2, 4) mesh spread over the CPU
(``make_host_mesh((2, 4), devices=["cpu"] * 8)``; one process computes
every position) and runs its fsdp_tp step.

Bars (tests/test_torch_train.py's): float32 rows, loss within 1e-5
relative and every gathered gradient within 1e-4 of its max |g|, the
grad norm within 1e-5 relative; as it runs (bf16), the loss within
7e-3 (tests/test_distributed.py's bar for the reference's own sharded
loss against one device) and every gradient within 5% in L2 norm, or,
where the reference's own one-device gradient of the step lies further
than that from its sharded one (it does on every layer leaf here:
5.0-6.5%, the bf16 roundings of a random stack), within 1.5 times that
distance.  The port's sharded step against its own one-device step is
held to 5% on every leaf (test_torch_sharded_plans.py).

Also: ``Trainer(mesh=, plan=fsdp_tp)`` for three steps against the
reference's ``Trainer`` from the same weights and data (reduced yi-6b,
2 KV heads), with test_trainer_matches_reference_trainer's bars: float32
rows, each loss within 1e-5 relative; bf16, the first loss within 2e-3
and all within 1e-2.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import reduced_config as ref_reduced_config
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.data.pipeline import SyntheticLMData as RefData
from repro.models import transformer as ref_transformer
from repro.runtime.trainer import Trainer as RefTrainer
from repro_torch.configs import reduced_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.tree import items_with_path
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import convert, transformer
from repro_torch.runtime.trainer import Trainer, value_and_grad
from repro_torch.sharding.plans import get_plan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import sys, json
sys.path.insert(0, os.path.join(%(root)r, "src"))
import numpy as np
import jax, jax.numpy as jnp
assert jax.device_count() >= 8, jax.devices()
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import reduced_config
from repro.launch.mesh import make_host_mesh
from repro.models import api, transformer
from repro.optim.adamw import global_norm
from repro.sharding import axes as axes_mod, plans

def flat(tree):
    items = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(v, np.float32)
            for path, v in items}

cfg = reduced_config("yi-6b")
mesh = make_host_mesh((2, 4), ("data", "model"))
plan = plans.get_plan("fsdp_tp")
params = api.init(cfg, jax.random.PRNGKey(0))
toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 33))
toks = toks.astype(np.int32)
batch = {"tokens": jnp.asarray(toks[:, :-1]),
         "labels": jnp.asarray(toks[:, 1:])}
shardings = jax.tree_util.tree_map(
    lambda s: NamedSharding(mesh, s),
    api.pspecs(cfg, plan.param_rules, dict(mesh.shape)),
    is_leaf=lambda x: isinstance(x, P))
params_sh = jax.device_put(params, shardings)
out = {"tokens": toks}
out.update({"param/" + k: v for k, v in flat(params).items()})
norms = {}
for rows in ("bfloat16", "float32"):
    if rows == "float32":
        transformer.embed_tokens = (
            lambda cfg, params, tokens, prefix_embeds=None:
            params["embed"][tokens])
    vg = jax.jit(jax.value_and_grad(lambda p: api.loss_fn(cfg, p, batch)))
    with mesh, axes_mod.use_rules(mesh, plan.act_rules):
        loss, grads = vg(params_sh)
    out[f"loss/{rows}"] = np.asarray(loss, np.float32)
    out.update({f"grad/{rows}/" + k: v for k, v in flat(grads).items()})
    norms[rows] = float(global_norm(grads))
    if rows == "bfloat16":              # the same step on one device
        loss1, grads1 = vg(params)
        out["loss/one_device"] = np.asarray(loss1, np.float32)
        out.update({"grad/one_device/" + k: v
                    for k, v in flat(grads1).items()})
np.savez(sys.argv[1], **out)
print(json.dumps(norms))
"""


@pytest.fixture(scope="module")
def child(tmp_path_factory):
    """The reference's child, started (not awaited): the file's first
    tests request it so that it runs beside them."""
    path = tmp_path_factory.mktemp("sharded_train") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", _CHILD % {"root": ROOT},
                             str(path)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference(child):
    proc, path = child
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with np.load(path) as f:
        arrays = dict(f)
    return json.loads(out.splitlines()[-1]), arrays


def _keep_f32_rows(monkeypatch):
    """The port's embedding keeps float32 rows (the child patches the
    reference's the same way)."""
    monkeypatch.setattr(
        transformer, "embed_tokens",
        lambda cfg, params, tokens, prefix_embeds=None:
        F.embedding(tokens.long(), params["embed"]))


def _unflat(flat, prefix):
    tree = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        node = tree
        parts = k[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


@pytest.mark.parametrize("rows", ["float32", "bfloat16"])
def test_trainer_on_mesh_matches_reference_trainer(rows, child,
                                                  monkeypatch):
    """Three steps of the port's Trainer(mesh=, plan=fsdp_tp) on a
    (2, 4) CPU mesh against three of the reference's one-device Trainer
    (the reference holds its sharded step to its one-device step)."""
    if rows == "float32":
        _keep_f32_rows(monkeypatch)
        monkeypatch.setattr(
            ref_transformer, "embed_tokens",
            lambda cfg, params, tokens, prefix_embeds=None:
            params["embed"][tokens])
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
        cfg = dataclasses.replace(reduced_config("yi-6b"), num_kv_heads=2)
        tcfg = TrainConfig(total_steps=50, warmup_steps=2, ckpt_every=100,
                           ckpt_dir=td, learning_rate=1e-3)
        tr = Trainer(cfg, tcfg,
                     data=SyntheticLMData(cfg.vocab_size, 4, 32, seed=0),
                     mesh=make_host_mesh((2, 4), devices=["cpu"] * 8),
                     plan=get_plan("fsdp_tp"))
        tr.set_params(convert.from_reference(start, cfg, device="cpu"))
        got = [m.loss for m in tr.run(3)]
    if rows == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        np.testing.assert_allclose(got[0], want[0], atol=2e-3)
        np.testing.assert_allclose(got, want, atol=1e-2)


@pytest.mark.parametrize("rows", ["float32", "bfloat16"])
def test_fsdp_tp_step_matches_the_references(reference, rows, monkeypatch):
    norms, ref = reference
    if rows == "float32":
        _keep_f32_rows(monkeypatch)
    cfg = reduced_config("yi-6b")
    params = convert.from_reference(_unflat(ref, "param/"), cfg,
                                    device="cpu")
    mesh = make_host_mesh((2, 4), devices=["cpu"] * 8)
    plan = get_plan("fsdp_tp")
    sharded = convert.shard_params(params, cfg, mesh,
                                   rules=plan.param_rules)
    toks = torch.from_numpy(ref["tokens"])
    loss, grads = value_and_grad(
        cfg, sharded, {"tokens": toks[:, :-1], "labels": toks[:, 1:]},
        mesh=mesh, plan=plan)
    want = float(ref[f"loss/{rows}"])
    full = convert.gather_params(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g))
                           for _, g in items_with_path(full))).item()
    if rows == "float32":
        np.testing.assert_allclose(loss.item(), want, rtol=1e-5)
        np.testing.assert_allclose(gnorm, norms[rows], rtol=1e-5)
    else:
        assert abs(loss.item() - want) <= 7e-3, (loss.item(), want)
    n = 0
    for key, g in items_with_path(full):
        a, b = ref[f"grad/{rows}/{key}"], g.numpy()
        assert a.shape == b.shape, key
        if rows == "float32":
            assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max(), key
        else:
            # the reference's own one-device gradient of this step lies
            # up to 6.5% from its sharded one (ln2's scale; 5.0-6.5% on
            # every layer leaf): bf16 roundings, which the port's take
            # another way, so the bar is 5% or 1.5 times that distance
            own = np.linalg.norm(ref[f"grad/one_device/{key}"] - a)
            bar = max(0.05 * np.linalg.norm(a), 1.5 * own)
            assert np.linalg.norm(a - b) <= bar, (key, np.linalg.norm(a - b)
                                                  / np.linalg.norm(a))
        n += 1
    assert n == len([k for k in ref if k.startswith(f"grad/{rows}/")])
