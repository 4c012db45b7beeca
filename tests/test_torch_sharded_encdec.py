"""The port's sharded training step for the encdec family.

Reduced whisper-small (2 encoder and 2 decoder layers, d_model 64,
4 heads over 4 kv heads with q/k/v biases, GELU MLP with biases,
LayerNorm, learned positions, the tied embedding over the padded
vocab 256; 32 frames, 16 decoder tokens) under the reference's training
plans on meshes spread over the CPU.  Over a mesh the frames' and the
tokens' rows split over `data` and `model` splits the heads of the
encoder's self-attention, the decoder's causal self-attention and the
cross-attention (each position's q heads against the k/v its heads
project from the whole encoder output), the MLP columns and the vocab.

Bars: tests/test_torch_sharded_moe.py's (frames bf16 as it runs, and
float32 with float32 rows).  A key bias's gradient is zero in exact
arithmetic, so both sides hold rounding noise: it is held against its
query bias's scale (tests/test_torch_encdec.py's rule).
"""

import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api, attention, convert
from repro_torch.sharding.plans import get_plan
from test_torch_sharded_train import (FAMILY_CASES, case_id,
                                      equals_one_device, family_child,
                                      family_reference, hold_to_reference,
                                      one_thread)

ARCH = "whisper-small"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from one_thread()


@pytest.fixture(scope="module")
def child(tmp_path_factory):
    yield from family_child(tmp_path_factory, ARCH)


@pytest.fixture(scope="module")
def reference(child):
    return family_reference(child)


def test_the_model_axis_splits_the_heads(child, monkeypatch):
    """On (2, 4) fsdp_tp each position attends its one head of the 4 in
    every attention: B9 sees the encoder's [B/data, 32, 1, 16] against
    itself, non-causal, the decoder's [B/data, 16, 1, 16] causal and the
    cross-attention's [B/data, 16, 1, 16] against [B/data, 32, 1, 16],
    non-causal: 8 calls a layer each, a data group's positions after
    the other's."""
    calls = []
    fwd = attention._attn_fwd
    monkeypatch.setattr(attention, "_attn_fwd",
                        lambda *a: calls.append((tuple(a[0].shape),
                                                 tuple(a[1].shape), a[3]))
                        or fwd(*a))
    cfg = reduced_config(ARCH)
    mesh = make_host_mesh((2, 4), devices=["cpu"] * 8)
    plan = get_plan("fsdp_tp")
    sharded = convert.shard_params(api.init(cfg, 0, device="cpu"), cfg,
                                   mesh, rules=plan.param_rules)
    assert sharded["enc_layers"]["attn"]["bq"].axes == (None, "model", None)
    assert sharded["enc_pos"].axes == (None, "data")
    batch = {"tokens": torch.zeros((4, 16), dtype=torch.int32),
             "labels": torch.zeros((4, 16), dtype=torch.int32),
             "frames": torch.zeros((4, 32, cfg.d_model))}
    api.loss_fn(cfg, sharded, batch, mesh=mesh, plan=plan)
    enc = ((2, 32, 1, 16), (2, 32, 1, 16), False)
    self_ = ((2, 16, 1, 16), (2, 16, 1, 16), True)
    cross = ((2, 16, 1, 16), (2, 32, 1, 16), False)
    assert calls == ([enc] * 8 * cfg.enc_layers
                     + ([self_] * 4 + [cross] * 4) * 2 * cfg.dec_layers)


@pytest.mark.parametrize("case", FAMILY_CASES, ids=case_id)
def test_every_plan_equals_the_one_device_step(case, monkeypatch):
    equals_one_device(ARCH, *case, monkeypatch)


@pytest.mark.parametrize("rows", ["float32", "bfloat16"])
def test_fsdp_tp_step_matches_the_references(reference, rows, monkeypatch):
    hold_to_reference(reference[1], ARCH, rows, monkeypatch)
