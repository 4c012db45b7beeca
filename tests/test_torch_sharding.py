"""The port's sharding layer against the reference's, on the same inputs.

* ``sharding/axes.resolve`` and ``models/common.partition_specs`` /
  ``api.pspecs`` for every assigned config under every plan's param
  rules and the serving plan's at tp 2-16 (the cases of
  tests/test_sharding.py among them);
* ``sharding/plans``: the plans, ``default_plan``, ``batch_pspec``,
  ``input_pspecs`` and ``cache_pspecs`` for every config and shape
  cell, on the production grids (``launch/mesh.make_production_mesh``:
  meta-device positions; the reference's on a stand-in with its mesh's
  ``axis_names`` and ``devices`` shape, as tests/test_sharding.py does);
* ``runtime/elastic``: ``factorizations``, ``best_shape`` and
  ``replan_batch`` (tests/test_elastic.py's cases and a sweep), and
  ``remesh`` over survivor counts 1-8 against the reference's on a
  forced 8-device host;
* ``optim/compress.compressed_psum`` (int8_ef and bf16, rings of 2 and
  4) against the reference's on the same forced host, bitwise: both
  move each rank's payload one hop a step round the same ring and add
  in the same order;
* ``launch/mesh``: the refusal without a spread, the spread and host
  meshes.

The forced-device reference runs once, in a module-scoped subprocess
(as tests/test_distributed.py).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.models import api as ref_api
from repro.models import common as ref_common
from repro.runtime import elastic as ref_elastic
from repro.sharding import axes as ref_axes
from repro.sharding import plans as ref_plans
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import SHAPES
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import api, common
from repro_torch.optim.compress import compressed_psum
from repro_torch.runtime import elastic
from repro_torch.sharding import axes, plans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list_archs()
MESH16 = {"data": 16, "model": 16}


def _t(spec):
    """A PartitionSpec of either package as a plain tuple (a one-axis
    tuple entry as its axis: JAX's PartitionSpec stores it so)."""
    def entry(a):
        if isinstance(a, (tuple, list)):
            return a[0] if len(a) == 1 else tuple(a)
        return a
    return tuple(entry(a) for a in spec)


def _tree(tree):
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    return _t(tree)


def _ref_tree(tree):
    from jax.sharding import PartitionSpec
    import jax
    flat, treedef = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    out = {}
    for path, spec in flat:
        node = out
        keys = [str(getattr(k, "key", k)) for k in path]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = _t(spec)
    return out


RULE_SETS = {
    **{name: plans.get_plan(name).param_rules
       for name in ("dp", "fsdp", "tp", "fsdp_tp", "fsdp_tp_sp")},
    **{f"serving_tp{n}": {ax: "tp" for ax in plans._TP_PARAM}
       for n in (2, 4, 8, 16)},
}


def _sizes(name):
    return {"tp": int(name[len("serving_tp"):])} \
        if name.startswith("serving") else MESH16


@pytest.mark.parametrize("arch", ARCHS)
def test_pspecs_equal_the_references(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert set(plans._TP_PARAM) == set(ref_plans._TP_PARAM)
    for name, rules in RULE_SETS.items():
        for sizes in (_sizes(name), None):
            got = _tree(api.pspecs(cfg, rules, sizes))
            want = _ref_tree(ref_api.pspecs(ref_cfg, rules, sizes))
            assert got == want, (arch, name, sizes)


def test_param_axes_equal_the_references():
    for arch in ARCHS:
        got = api.param_shapes(get_config(arch))
        want = ref_api.param_shapes(ref_get_config(arch))

        def walk(g, w, path):
            if isinstance(g, dict):
                assert set(g) == set(w), path
                for k in g:
                    walk(g[k], w[k], f"{path}/{k}")
            else:
                assert (g.shape, g.axes) == (w.shape, w.axes), path
        walk(got, want, arch)


@pytest.mark.parametrize("names,rules,dims,sizes", [
    (("batch", "heads"), {"batch": "data", "heads": "model"}, (32, 4),
     MESH16),
    (("batch", "heads"), {"batch": "data", "heads": "model"}, None, None),
    (("embed", "vocab"), {"embed": "model", "vocab": "model"}, (256, 256),
     MESH16),
    (("batch", None, "kv_heads"), {"batch": ("pod", "data"),
                                   "kv_heads": "model"},
     (64, 3, 16), {"pod": 2, "data": 16, "model": 16}),
    (("batch", "seq"), {"batch": ("pod", "data")}, (16, 8),
     {"pod": 2, "data": 16}),
    (("heads", "mlp", "experts"), {"heads": "tp", "mlp": "tp",
                                   "experts": "tp"}, (8, 12, 4), {"tp": 4}),
    ((None, "vocab"), {"vocab": "tp"}, (3, 64000), {"tp": 8}),
])
def test_resolve_equals_the_references(names, rules, dims, sizes):
    got = axes.resolve(names, rules, dims=dims, mesh_sizes=sizes)
    want = ref_axes.resolve(names, rules, dims=dims, mesh_sizes=sizes)
    assert _t(got) == _t(want)
    with axes.use_rules(mesh_mod.make_tp_mesh(2, spread="cpu"), rules):
        assert axes.current_rules() is rules
        x = torch.zeros(1)
        assert axes.constrain(x, ("batch",)) is x
    assert axes.current_rules() is None and axes.current_mesh() is None


def test_partition_specs_fallbacks_as_the_reference():
    """tests/test_sharding.py's two partition_specs cases."""
    cases = [(((4096, 4, 128), ("embed", "kv_heads", "head_dim")),
              {"embed": "data", "kv_heads": "model"}),
             (((256, 256), ("embed", "vocab")),
              {"embed": "model", "vocab": "model"})]
    for (shape, ax), rules in cases:
        got = common.partition_specs({"w": common.ParamSpec(shape, ax)},
                                     rules, MESH16)
        want = ref_common.partition_specs(
            {"w": ref_common.ParamSpec(shape, ax)}, rules, MESH16)
        assert _t(got["w"]) == _t(want["w"])


class _RefMesh:
    """The reference's input/cache pspecs read a mesh's axis names and
    device-grid shape only (tests/test_sharding.py's stand-in)."""

    def __init__(self, shape, axis_names):
        self.axis_names = axis_names
        self.devices = np.empty(shape, dtype=object)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plan_pspecs_equal_the_references(shape, multi_pod):
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
    ref_mesh = _RefMesh(mesh.devices.shape, mesh.axis_names)
    assert {d.type for d in mesh.positions} == {"meta"}
    for arch in ARCHS:
        cfg, ref_cfg = get_config(arch), ref_get_config(arch)
        sc, ref_sc = SHAPES[shape], REF_SHAPES[shape]
        plan = plans.default_plan(cfg, sc, multi_pod=multi_pod)
        ref_plan = ref_plans.default_plan(ref_cfg, ref_sc,
                                          multi_pod=multi_pod)
        assert (plan.name, plan.batch_axes, plan.kv_seq_axis) == \
            (ref_plan.name, ref_plan.batch_axes, ref_plan.kv_seq_axis)
        assert plan.param_rules == ref_plan.param_rules
        assert plan.act_rules == ref_plan.act_rules
        got = {k: _t(v) for k, v in
               plans.input_pspecs(cfg, sc, plan, mesh).items()}
        want = {k: _t(v) for k, v in ref_plans.input_pspecs(
            ref_cfg, ref_sc, ref_plan, ref_mesh).items()}
        assert got == want, (arch, shape)
        got = _tree(plans.cache_pspecs(cfg, sc, plan, mesh))
        want = _ref_tree(ref_plans.cache_pspecs(ref_cfg, ref_sc, ref_plan,
                                                ref_mesh))
        assert got == want, (arch, shape)


@pytest.mark.parametrize("name", ["dp", "fsdp", "tp", "fsdp_tp",
                                  "fsdp_tp_sp", "fsdp_tp_spact"])
def test_batch_pspec_equals_the_references(name):
    for multi_pod in (False, True):
        plan = plans.get_plan(name, multi_pod=multi_pod)
        ref_plan = ref_plans.get_plan(name, multi_pod=multi_pod)
        shape = {"pod": 2, "data": 16, "model": 16}
        for b in (1, 2, 8, 16, 24, 32, 48, 256):
            for extra in (0, 2):
                got = plans.batch_pspec(plan, b, shape, extra)
                want = ref_plans.batch_pspec(ref_plan, b, shape, extra)
                assert _t(got) == _t(want), (name, multi_pod, b)


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_serving_plan_equals_the_references(tp):
    cfg, ref_cfg = get_config("yi-6b"), ref_get_config("yi-6b")
    plan = plans.serving_plan(mesh_mod.make_tp_mesh(tp, spread="cpu"))
    assert plan.tp == tp and plans.SERVING_TP_AXIS == "tp"
    rules = {ax: "tp" for ax in ref_plans._TP_PARAM}
    assert plan.param_rules == rules
    assert plan.act_rules == {"heads": "tp", "kv_heads": "tp", "mlp": "tp",
                              "vocab": "tp", "experts": "tp"}
    assert _tree(plan.param_shardings(cfg)) == _ref_tree(
        ref_api.pspecs(ref_cfg, rules, {"tp": tp}))
    kv = "tp" if ref_cfg.num_kv_heads % tp == 0 else None
    assert _t(plan.cache_sharding(cfg)) == (None, None, None, kv, None)
    assert _t(plan.replicated) == ()


# ----------------------------------------------------------------------
# elastic
# ----------------------------------------------------------------------

def test_factorizations_and_replan_equal_the_references():
    for n in range(1, 130):
        assert elastic.factorizations(n) == ref_elastic.factorizations(n)
    for g in (1, 7, 16, 64, 100, 256, 1000):
        for old in (1, 2, 8, 16):
            for new in (1, 3, 6, 7, 8, 12, 15, 16):
                assert elastic.replan_batch(g, old, new) == \
                    ref_elastic.replan_batch(g, old, new)


@pytest.mark.parametrize("n", [1, 2, 7, 8, 12, 16, 31, 64, 96, 255, 256,
                               384, 512])
def test_best_shape_equals_the_references(n):
    for max_model in (None, 1, 4, 8, 16):
        for prefer in (1, 4, 8, 16):
            assert elastic.best_shape(n, max_model=max_model,
                                      prefer_model=prefer) == \
                ref_elastic.best_shape(n, max_model=max_model,
                                       prefer_model=prefer)


# ----------------------------------------------------------------------
# the forced-device reference: remesh and compressed_psum
# ----------------------------------------------------------------------

_CHILD = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import sys, json
sys.path.insert(0, os.path.join(%(root)r, "src"))
import numpy as np
import jax, jax.numpy as jnp
assert jax.device_count() >= 8, jax.devices()
from repro.launch.mesh import make_host_mesh
from repro.optim.compress import compressed_psum
from repro.runtime.elastic import remesh

out = {}
shapes = {}
for n in range(1, 9):
    for mm in (None, 1, 2, 4):
        m = remesh(jax.devices()[:n], max_model=mm, prefer_model=4)
        shapes[f"{n}_{mm}"] = [list(m.devices.shape), list(m.axis_names)]
mesh = make_host_mesh((2, 4), ("data", "model"))
rng = np.random.default_rng(0)
for case, shape in (("a", (64, 33)), ("b", (7,))):
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x[0] = 1e-3                                  # a small element too
    out[f"x_{case}"] = x
    for axis in ("data", "model"):
        for method in ("int8_ef", "bf16"):
            got = compressed_psum(jnp.asarray(x), mesh, axis, method)
            out[f"{case}_{axis}_{method}"] = np.asarray(got)
np.savez(sys.argv[1], **out)
print(json.dumps(shapes))
"""


@pytest.fixture(scope="module")
def forced(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharding") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _CHILD % {"root": ROOT},
                           str(path)], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(path) as f:
        arrays = dict(f)
    return json.loads(proc.stdout.splitlines()[-1]), arrays


def test_remesh_equals_the_references(forced):
    shapes, _ = forced
    for key, (shape, names) in shapes.items():
        n, mm = key.split("_")
        mm = None if mm == "None" else int(mm)
        m = elastic.remesh(["cpu"] * int(n), max_model=mm, prefer_model=4)
        assert (list(m.devices.shape), list(m.axis_names)) == \
            (shape, names), key


@pytest.mark.parametrize("case", ["a", "b"])
@pytest.mark.parametrize("axis", ["data", "model"])
@pytest.mark.parametrize("method", ["int8_ef", "bf16"])
def test_compressed_psum_bitwise_the_references(forced, case, axis,
                                                method):
    _, ref = forced
    mesh = mesh_mod.make_host_mesh((2, 4), ("data", "model"),
                                   devices=["cpu"] * 8)
    x = torch.from_numpy(ref[f"x_{case}"])
    got = compressed_psum(x, mesh, axis, method)
    want = ref[f"{case}_{axis}_{method}"]
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_compressed_psum_per_rank_ring_order():
    """A list input (one value a rank) sums, on rank r, its own value,
    then r-1's, r-2's, ...: each rank's float32 sum of the dequantized
    payloads in that order; a 1-rank ring returns its input."""
    from repro_torch.optim.compress import dequantize_int8, quantize_int8
    mesh = mesh_mod.make_tp_mesh(4, spread="cpu")
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(33, generator=g) for _ in range(4)]
    got = compressed_psum(xs, mesh, "tp")
    deq = [dequantize_int8(*quantize_int8(x)) for x in xs]
    for r in range(4):
        want = deq[r]
        for k in range(1, 4):
            want = want + deq[(r - k) % 4]
        assert torch.equal(got[r], want)
    one = mesh_mod.make_tp_mesh(1, spread="cpu")
    assert compressed_psum(xs[0], one, "tp") is xs[0]


# ----------------------------------------------------------------------
# meshes
# ----------------------------------------------------------------------

def test_tp_mesh_needs_devices_or_an_explicit_spread():
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="spread"):
            mesh_mod.make_tp_mesh(2)
    m = mesh_mod.make_tp_mesh(4, spread="cpu")
    assert m.shape == {"tp": 4} and m.physical == [torch.device("cpu")]
    m = mesh_mod.make_tp_mesh(2, devices=["cpu", "meta"])
    assert m.positions == m.physical == [torch.device("cpu"),
                                         torch.device("meta")]
    with pytest.raises(ValueError):
        mesh_mod.make_tp_mesh(3, devices=["cpu"])
    h = mesh_mod.make_host_mesh(devices=["cpu"] * 8)
    assert h.shape == {"data": 2, "model": 4}
    p = mesh_mod.make_production_mesh(multi_pod=True)
    assert p.shape == {"pod": 2, "data": 16, "model": 16} and p.size == 512
