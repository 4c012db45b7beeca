"""The port's sharded training step for the ssm family.

Reduced falcon-mamba-7b (2 Mamba-1 layers, d_model 64, d_inner 128,
N 8, dt_rank 8, vocab 256) under the reference's training plans on
meshes spread over the CPU.  Over a mesh `model` splits the d_inner
channels (models/ssm.sharded_mamba1): each position reads the x and z
columns of its channels from w_in's blocks, sums its float32 x_proj
partial in model order and scans its channels alone.

Bars (tests/test_torch_sharded_train.py's helpers): against the
reference's fsdp_tp step on (2, 4) (float32 rows: the loss within 1e-5
relative, every gradient within 1e-4 of its max |g| or 1.5 times the
reference's own sharded / one-device distance; bf16: the loss within
7e-3, every gradient within 5% in L2 norm or 1.5 times the reference's
own distance, or 1.5 times the two packages' one-device distance, and
within 5% of the port's one-device step); against the port's one-device
step, float32 rows, every plan on (2, 4), tp / fsdp_tp on (4, 2),
(1, 8), a (2, 2, 2) pod mesh and (1, 3) (d_inner 128 does not split
over 3: the mixer runs once).  The mixer alone at model=4 against the
one-device mixer; a contiguous block read of w_in would be wrong.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api, common, convert, ssm
from repro_torch.models import transformer as T
from repro_torch.sharding.plans import get_plan
from test_torch_sharded_train import (FAMILY_CASES, case_id,
                                      equals_one_device, family_child,
                                      family_reference, hold_to_reference,
                                      one_thread)

ARCH = "falcon-mamba-7b"
CASES = FAMILY_CASES + [((1, 3), p) for p in ("tp", "fsdp_tp")]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from one_thread()


@pytest.fixture(scope="module")
def child(tmp_path_factory):
    yield from family_child(tmp_path_factory, ARCH)


@pytest.fixture(scope="module")
def reference(child):
    return family_reference(child)


def _mixer_case(mixer, arch, shape=(2, 4), B=4, S=32):
    """(one-device output, sharded output) of layer 0's mixer of `arch`
    over a float32 input of B rows, the rows split into fsdp_tp's data
    groups on a CPU mesh of `shape`."""
    cfg = reduced_config(arch)
    params = api.init(cfg, 0, device="cpu")
    key = "layers" if cfg.family == "ssm" else "mamba"
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    p = T.layer_slice(params[key], 0)
    if cfg.family == "hybrid":
        p = T.layer_slice(p, 0)
    one = getattr(ssm, mixer + "_mixer")(cfg, p["mixer"], x)[0]
    mesh = make_host_mesh(shape, devices=["cpu"] * int(np.prod(shape)))
    plan = get_plan("fsdp_tp")
    sh = convert.shard_params(params, cfg, mesh, rules=plan.param_rules)
    lp = T.layer_list(sh[key], 1 if cfg.family == "hybrid" else 2)[0]
    if cfg.family == "hybrid":
        lp = T.layer_list(lp, cfg.attn_every)[0]
    read = T._Reader()
    got = []
    for g in T._groups(mesh, plan, B):
        h = {d: x[g.rows[0]:g.rows[1]].to(d) for d in g.devices}
        y = getattr(ssm, "sharded_" + mixer)(cfg, lp["mixer"], g, h, read)
        got.append(y[g.devices[0]])
    return one, torch.cat(got)


def own_block_w_in(monkeypatch, shape):
    """Make each position read w_in (of `shape`) from its own contiguous
    block alone, the columns it asks for taken modulo the block's width:
    the read a leaf split along one axis gives a position that reads
    only its own block."""
    real = T._Reader.span

    def span(self, leaf, w, dim, lo, hi):
        if tuple(leaf.shape) != tuple(shape):
            return real(self, leaf, w, dim, lo, hi)
        blk = self(leaf, w)
        return blk[:, torch.arange(lo, hi) % blk.shape[1]]

    monkeypatch.setattr(T._Reader, "span", span)


def test_the_sharded_mamba1_mixer(child, monkeypatch):
    """sharded_mamba1 at model=4 within 1e-5 of max |y| of the
    one-device mixer; with w_in read from each position's own block
    alone (its x and z columns lie in two other blocks), far from it."""
    one, got = _mixer_case("mamba1", ARCH)
    scale = one.abs().max()
    assert (got - one).abs().max() <= 1e-5 * scale
    cfg = reduced_config(ARCH)
    own_block_w_in(monkeypatch, (cfg.d_model, 2 * cfg.d_inner))
    _, wrong = _mixer_case("mamba1", ARCH)
    assert (wrong - one).abs().max() > 0.05 * scale


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_every_plan_equals_the_one_device_step(case, monkeypatch):
    equals_one_device(ARCH, *case, monkeypatch)


def test_the_model_axis_splits_the_channels(monkeypatch):
    """On (2, 4) fsdp_tp each position scans its 32 of the 128 channels
    ([B/data, S, 32], 8 scans a layer) and the x_proj and out-projection
    partials are cross-shard sums of 4 partials a data group."""
    scans, tags = [], []
    real = ssm._mamba1_scan
    monkeypatch.setattr(ssm, "_mamba1_scan", lambda xs, *a:
                        scans.append(tuple(xs.shape)) or real(xs, *a))
    monkeypatch.setattr(ssm, "xshard_sum", lambda parts, devs, tag:
                        tags.append((tag, len(parts)))
                        or common.xshard_sum(parts, devs, tag=tag))
    cfg = reduced_config(ARCH)
    mesh = make_host_mesh((2, 4), devices=["cpu"] * 8)
    plan = get_plan("fsdp_tp")
    sharded = convert.shard_params(api.init(cfg, 0, device="cpu"), cfg,
                                   mesh, rules=plan.param_rules)
    assert sharded["layers"]["mixer"]["w_in"].axes == (None, "data",
                                                       "model")
    batch = {"tokens": torch.zeros((4, 32), dtype=torch.int32),
             "labels": torch.zeros((4, 32), dtype=torch.int32)}
    api.loss_fn(cfg, sharded, batch, mesh=mesh, plan=plan)
    assert scans == [(2, 32, 32)] * (8 * cfg.num_layers)
    assert tags == [("xshard_ssm_xproj", 4), ("xshard_ssm_out", 4)] * (
        2 * cfg.num_layers)


@pytest.mark.parametrize("rows", ["float32", "bfloat16"])
def test_fsdp_tp_step_matches_the_references(reference, rows, monkeypatch):
    hold_to_reference(reference[1], ARCH, rows, monkeypatch)
