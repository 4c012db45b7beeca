"""The port's sharded training step for the hybrid family.

Reduced zamba2-2.7b (4 Mamba-2 layers in 2 super-blocks, each followed
by the one shared attention + GELU MLP block; d_model 64, d_inner 128,
8 SSM heads of 16, N 8, 4 attention heads, vocab 256) under the
reference's training plans on meshes spread over the CPU.  Over a mesh
`model` splits the Mamba-2 heads (models/ssm.sharded_mamba2: each
position reads the w_in columns of its z, x and dt heads and all of B
and C, and the gated RMSNorm's mean of squares is a cross-shard sum)
and the shared block's heads and MLP columns (transformer's
`sharded_block`; its leaves are one tree used by both super-blocks).

Bars: tests/test_torch_sharded_ssm.py's, on meshes of the same shapes
((1, 3): the 8 SSM heads, the 4 attention heads and the 128 MLP columns
do not split over 3 and run once).  The reference's own sharded and
one-device steps lie further apart here than elsewhere (bf16: its loss
1.9e-2 apart, its gradients up to 125% of their norm; float32 rows: its
`conv_b` gradient 1.3e-4 of its max |g|), so its own distance sets the
bar where it is the larger.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api, attention, common, convert, ssm
from repro_torch.sharding.plans import get_plan
from test_torch_sharded_ssm import CASES, _mixer_case, own_block_w_in
from test_torch_sharded_train import (case_id, equals_one_device,
                                      family_child, family_reference,
                                      hold_to_reference, one_thread)

ARCH = "zamba2-2.7b"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from one_thread()


@pytest.fixture(scope="module")
def child(tmp_path_factory):
    yield from family_child(tmp_path_factory, ARCH)


@pytest.fixture(scope="module")
def reference(child):
    return family_reference(child)


def test_the_sharded_mamba2_mixer(child, monkeypatch):
    """sharded_mamba2 at model=4 within 1e-5 of max |y| of the
    one-device mixer; with w_in read from each position's own block
    alone (its blocks of 70 of w_in's 280 columns hold none of its heads
    whole), far from it."""
    one, got = _mixer_case("mamba2", ARCH)
    scale = one.abs().max()
    assert (got - one).abs().max() <= 1e-5 * scale
    cfg = reduced_config(ARCH)
    H = cfg.d_inner // cfg.ssm_head_dim
    own_block_w_in(monkeypatch, (cfg.d_model, 2 * cfg.d_inner
                                 + 2 * cfg.ssm_state + H))
    _, wrong = _mixer_case("mamba2", ARCH)
    assert (wrong - one).abs().max() > 0.05 * scale


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_every_plan_equals_the_one_device_step(case, monkeypatch):
    equals_one_device(ARCH, *case, monkeypatch)


def test_the_model_axis_splits_the_heads(monkeypatch):
    """On (2, 4) fsdp_tp each position runs the SSD chunks of its 2 of
    the 8 SSM heads (state [B/data, 2, 16, 8], 8 a layer), the norm's
    sums of squares and the out-projection partials are cross-shard sums
    of 4 partials a data group, and B9 runs each position's one
    attention head of the shared block ([B/data, S, 1, 16], 8 a
    super-block)."""
    states, tags, flash = [], [], []
    real = ssm._ssd_scan
    monkeypatch.setattr(ssm, "_ssd_scan", lambda *a:
                        states.append(tuple(a[5].shape)) or real(*a))
    monkeypatch.setattr(ssm, "xshard_sum", lambda parts, devs, tag:
                        tags.append((tag, len(parts)))
                        or common.xshard_sum(parts, devs, tag=tag))
    fwd = attention._attn_fwd
    monkeypatch.setattr(attention, "_attn_fwd",
                        lambda *a: flash.append(tuple(a[0].shape))
                        or fwd(*a))
    cfg = reduced_config(ARCH)
    mesh = make_host_mesh((2, 4), devices=["cpu"] * 8)
    plan = get_plan("fsdp_tp")
    sharded = convert.shard_params(api.init(cfg, 0, device="cpu"), cfg,
                                   mesh, rules=plan.param_rules)
    assert sharded["mamba"]["mixer"]["a_log"].axes == (None, None, "model")
    batch = {"tokens": torch.zeros((4, 32), dtype=torch.int32),
             "labels": torch.zeros((4, 32), dtype=torch.int32)}
    api.loss_fn(cfg, sharded, batch, mesh=mesh, plan=plan)
    assert states == [(2, 2, 16, 8)] * (8 * cfg.num_layers)
    assert tags == [("xshard_ssm_norm", 4), ("xshard_ssm_out", 4)] * (
        2 * cfg.num_layers)
    assert flash == [(2, 32, 1, 16)] * (8 * cfg.num_layers
                                        // cfg.attn_every)


@pytest.mark.parametrize("rows", ["float32", "bfloat16"])
def test_fsdp_tp_step_matches_the_references(reference, rows, monkeypatch):
    hold_to_reference(reference[1], ARCH, rows, monkeypatch)


def test_the_references_own_distances(reference):
    """The reference's own fsdp_tp and one-device bf16 steps put every
    gradient leaf more than 6.9% of its norm apart (final_norm's scale
    reads 6.97%, the mixer's `conv_b` 81%), while with float32 rows they
    agree within 1e-4 of max |g|: roundings that reduced zamba2-2.7b
    amplifies, not the sharding.  chip_smoke.py's phase 17(a) holds
    zamba2's bf16 leaves at 1.5 x 6.97% (SHARDED_FAMILY_GRAD) and its
    float32 leaves at the rounding floor."""
    ref = reference[1]
    l2 = np.linalg.norm
    own = {}
    for k in ref:
        if k.startswith("grad/bfloat16/"):
            key = k[len("grad/bfloat16/"):]
            a = ref[k]
            own[key] = l2(ref[f"grad/one_device/bfloat16/{key}"] - a) / l2(a)
            f = ref[f"grad/float32/{key}"]
            assert (np.abs(ref[f"grad/one_device/float32/{key}"] - f).max()
                    <= 1e-4 * np.abs(f).max()), key
    print({k: round(float(v), 4) for k, v in sorted(own.items())})
    assert min(own.values()) >= 0.069, own
    assert own["mamba/mixer/conv_b"] > 0.5
