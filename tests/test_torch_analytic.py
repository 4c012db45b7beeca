"""The port's analytic cost model and roofline against the reference's,
and the step trace's pieces (core/{analytic,roofline,hw}.py, B9's op).

Parity: for every assigned arch x shape x {SINGLE_POD, MULTI_POD} x
{the default plan, dp, fsdp_tp}, plus causal_skip=False on one cell,
every ``CellCost`` field and every ``Roofline`` property equals the
reference's exactly, with the reference's chip and DCN rate passed in
(``chip=hw.TPU_V5E, dcn_gbps=25.0``).  With the port's defaults (the
H100 and a DGX H100 NIC's 50 GB/s) only the chip- and DCN-dependent
seconds differ.  Then ports of tests/test_roofline.py's analytic
checks: the tiny dense config's analytic FLOPs against the port's
forward counted by FlopCounterMode on meta (the reference's 0.5-2x
band), 6ND against train_4k, decode cells memory-bound on the H100,
the row format.  B9 on meta: the op's fake gives the kernel's shapes,
and FlopCounterMode counts its formula, held to closed forms.
"""

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import reduced_shape as ref_reduced_shape
from repro.core import analytic as ref_analytic
from repro.core import hw as ref_hw
from repro.core import roofline as ref_roofline
from repro.models import attention as ref_attention
from repro.models import mlp as ref_mlp
from repro.sharding import plans as ref_plans
from repro_torch.configs import (ASSIGNED, SHAPES, get_config,
                                 reduced_config, reduced_shape)
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import analytic, hw, roofline
from repro_torch.kernels import flash_attention as kfa
from repro_torch.models import api, attention, common, mlp, transformer
from repro_torch.sharding import plans

FIELDS = ("name", "model_flops", "impl_flops_dev", "hbm_bytes_dev",
          "coll_bytes_dev", "coll_bytes_by_kind", "notes")
PROPS = ("name", "mesh_desc", "num_chips", "flops_per_dev", "bytes_per_dev",
         "coll_bytes_per_dev", "compute_s", "memory_s", "collective_s",
         "model_flops_global", "total_coll_bytes", "dominant", "step_s",
         "useful_ratio", "mfu", "roofline_fraction")
SECONDS = ("compute_s", "memory_s", "collective_s", "step_s", "mfu",
           "roofline_fraction", "dominant")


def _ref_mesh(multi_pod):
    return ref_hw.MULTI_POD if multi_pod else ref_hw.SINGLE_POD


def _port_mesh(multi_pod, **kw):
    m = hw.MULTI_POD if multi_pod else hw.SINGLE_POD
    return dataclasses.replace(m, **kw)


def _cells():
    for arch in ASSIGNED:
        for shape in SHAPES:
            for mp in (False, True):
                yield arch, shape, mp


@pytest.mark.parametrize("arch", ASSIGNED)
def test_analyze_cell_and_roofline_equal_the_reference(arch):
    n = 0
    for shape_name in SHAPES:
        for mp in (False, True):
            ref_cfg, cfg = ref_get_config(arch), get_config(arch)
            default = ref_plans.default_plan(ref_cfg, REF_SHAPES[shape_name],
                                             multi_pod=mp).name
            assert default == plans.default_plan(
                cfg, SHAPES[shape_name], multi_pod=mp).name
            rmesh = _ref_mesh(mp)
            pmesh = _port_mesh(mp, chip=hw.TPU_V5E, dcn_gbps=25.0)
            for plan in (default, "dp", "fsdp_tp"):
                rc = ref_analytic.analyze_cell(ref_cfg, REF_SHAPES[shape_name],
                                               rmesh, plan)
                pc = analytic.analyze_cell(cfg, SHAPES[shape_name], pmesh,
                                           plan)
                for f in FIELDS:
                    assert getattr(rc, f) == getattr(pc, f), (shape_name, f)
                rr, pr = rc.roofline(rmesh), pc.roofline(pmesh)
                for f in PROPS:
                    assert getattr(rr, f) == getattr(pr, f), (shape_name, f)
                assert rr.row() == pr.row()
                n += 1
    assert n == len(SHAPES) * 2 * 3


def test_causal_skip_off_equals_the_reference():
    for skip in (True, False):
        rc = ref_analytic.analyze_cell(ref_get_config("yi-6b"),
                                       REF_SHAPES["prefill_32k"],
                                       ref_hw.SINGLE_POD, causal_skip=skip)
        pc = analytic.analyze_cell(get_config("yi-6b"), SHAPES["prefill_32k"],
                                   _port_mesh(False, chip=hw.TPU_V5E,
                                              dcn_gbps=25.0),
                                   causal_skip=skip)
        assert dataclasses.asdict(rc) == dataclasses.asdict(pc)


def test_port_defaults_change_only_the_seconds():
    """The H100 and its NIC rate: the same counts, other seconds."""
    assert hw.SINGLE_POD.chip is hw.TARGET and hw.MULTI_POD.dcn_gbps == 50.0
    for arch in ("yi-6b", "dbrx-132b", "zamba2-2.7b"):
        for mp in (False, True):
            cfg = get_config(arch)
            tpu = _port_mesh(mp, chip=hw.TPU_V5E, dcn_gbps=25.0)
            gpu = _port_mesh(mp)
            a = analytic.analyze_cell(cfg, SHAPES["train_4k"], tpu)
            b = analytic.analyze_cell(cfg, SHAPES["train_4k"], gpu)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            ra, rb = a.roofline(tpu), b.roofline(gpu)
            for f in PROPS:
                if f not in SECONDS:
                    assert getattr(ra, f) == getattr(rb, f), f
            assert rb.chip is hw.TARGET
            assert rb.compute_s == b.impl_flops_dev / hw.TARGET.peak_for("bf16")


def test_mesh_spec_matches_the_reference_formula():
    for name in ("data", "model", "pod"):
        ref = ref_hw.MULTI_POD.axis_bandwidth_gbps(name)
        port = _port_mesh(True, chip=hw.TPU_V5E,
                          dcn_gbps=25.0).axis_bandwidth_gbps(name)
        assert ref == port
    assert hw.MULTI_POD.axis_bandwidth_gbps("pod") == 50.0
    assert hw.SINGLE_POD.axis_bandwidth_gbps("model") == \
        2 * hw.H100_SXM.ici_gbps_per_link
    assert hw.MULTI_POD.num_chips == 512 and hw.SINGLE_POD.axis_size(
        "model") == 16


def test_small_names_equal_the_reference():
    assert mlp.mlp_flops(4096, 11008, True) == \
        ref_mlp.mlp_flops(4096, 11008, True)
    for args in ((2, 64, 64, 8, 16, True), (2, 8, 64, 8, 16, True),
                 (1, 64, 64, 4, 32, False)):
        assert attention.attention_flops(*args) == \
            ref_attention.attention_flops(*args)
    for kind in ("train", "prefill", "decode"):
        assert dataclasses.asdict(reduced_shape(kind)) == \
            dataclasses.asdict(ref_reduced_shape(kind))
    cfg = reduced_config("moonshot-v1-16b-a3b")
    params = api.abstract(cfg)
    specs = api.param_shapes(cfg)

    def walk(p, s):
        if common.is_spec(s):
            assert p.device.type == "meta" and tuple(p.shape) == s.shape
            assert p.dtype == torch.float32
            return
        assert sorted(p) == sorted(s)
        for k in s:
            walk(p[k], s[k])
    walk(params, specs)


def _tiny_cfg():
    return dataclasses.replace(
        reduced_config("yi-6b"), d_model=128, d_ff=256, num_heads=4,
        num_kv_heads=2, head_dim=32, vocab_size=512, num_layers=2,
        remat="none")


def test_analytic_flops_vs_the_forward_counted_on_meta():
    """The analytic forward FLOPs against FlopCounterMode's count of
    the port's forward on meta (B9 by its formula), within the
    reference's 0.5-2x band."""
    cfg = _tiny_cfg()
    B, S = 2, 64
    params = common.abstract_params(transformer.transformer_specs(cfg))
    toks = torch.empty((B, S), dtype=torch.int32, device="meta")
    with FlopCounterMode(display=False) as fc:
        h, _ = transformer.forward(cfg, params, toks)
        transformer.logits_fn(cfg, params, h)
    mesh1 = hw.MeshSpec(shape=(1,), axis_names=("data",))
    cell = analytic.analyze_cell(cfg, ShapeConfig("tiny", S, B, "prefill"),
                                 mesh1, "dp")
    ratio = cell.impl_flops_dev / fc.get_total_flops()
    assert 0.5 < ratio < 2.0, ratio


def test_analytic_cell_full_config_sane():
    cfg = get_config("yi-6b")
    cell = analytic.analyze_cell(cfg, SHAPES["train_4k"], hw.SINGLE_POD)
    six_nd = 6.0 * cfg.param_count() * SHAPES["train_4k"].tokens
    assert 0.8 < cell.model_flops / six_nd < 1.5
    rf = cell.roofline(hw.SINGLE_POD)
    assert rf.compute_s > 0 and rf.memory_s > 0
    assert 0 < rf.mfu <= 1.0
    assert 0 < rf.useful_ratio <= 1.2


@pytest.mark.parametrize("arch", ["yi-6b", "command-r-35b",
                                  "falcon-mamba-7b", "dbrx-132b",
                                  "internvl2-1b"])
def test_decode_cells_memory_bound_on_the_h100(arch):
    for shape in ("decode_32k", "long_500k"):
        for mp in (False, True):
            mesh = hw.MULTI_POD if mp else hw.SINGLE_POD
            cell = analytic.analyze_cell(get_config(arch), SHAPES[shape],
                                         mesh)
            assert cell.roofline(mesh).dominant == "memory", (shape, mp)


def test_roofline_row_format():
    cell = analytic.analyze_cell(get_config("yi-6b"), SHAPES["train_4k"],
                                 hw.SINGLE_POD)
    rf = cell.roofline(hw.SINGLE_POD)
    row = rf.row()
    assert rf.name in row and rf.dominant in row
    assert len(roofline.Roofline.header().split(",")) == \
        len(row.split(","))
    assert roofline.Roofline.header() == ref_roofline.Roofline.header()


# ----------------------------------------------------------------------
# B9 as an op: meta shapes and its FLOP formula
# ----------------------------------------------------------------------

def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 128),
                                      (torch.bfloat16, 80),
                                      (torch.float32, 64)])
def test_b9_op_on_meta_gives_shapes_and_counts_its_formula(dtype, hd):
    B, S, H, KH = 2, 1024, 8, 2
    q, k = _meta(B, S, H, hd, dtype=dtype), _meta(B, S, KH, hd, dtype=dtype)
    with FlopCounterMode(display=False) as fc:
        o, lse = kfa.flash_attention_fwd(q, k, k, causal=True)
    assert o.device.type == "meta" and o.shape == q.shape and \
        o.dtype == dtype
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    R, Rg, K = kfa.KERNEL_TILES[kfa.body(dtype, hd)]
    if Rg < R:
        # wgmma: 64-row groups skip the 128-key tiles past their last row
        n = S // R
        pairs = n * (n + 1)
    else:
        n = S // R
        pairs = n * (n + 1) // 2
    assert fc.get_total_flops() == 4 * hd * Rg * K * pairs * B * H
    with FlopCounterMode(display=False) as fc:
        kfa.flash_attention_fwd(q, k, k, causal=False)
    assert fc.get_total_flops() == 4 * hd * S * S * B * H


def test_b9_formula_walks_the_kernels_tiles():
    """Ragged and windowed walks against a brute-force walk of the
    kernel's rule (every tile pair, `key_range` and `dead`)."""
    def brute(Sq, Sk, body, causal, window, q_offset):
        R, Rg, K = kfa.KERNEL_TILES[body]
        n = 0
        for q0 in range(0, Sq, R):
            rows = min(R, Sq - q0)
            p_lo, p_hi = q_offset + q0, q_offset + q0 + rows - 1
            hi = min(Sk, p_hi + 1) if causal else Sk
            lo = max(0, p_lo - window + 1) if window else 0
            k_first = lo // K * K
            tiles = list(range(k_first, hi, K))
            for g_lo in range(q_offset + q0, q_offset + q0 + R, Rg):
                for k0 in tiles:
                    dead = Rg < R and (
                        (causal and k0 > g_lo + Rg - 1) or
                        (window and k0 + K - 1 <= g_lo - window))
                    n += not dead
        return n
    for body in kfa.BODIES:
        for args in ((1000, 1000, True, 0, 0), (300, 1500, False, 0, 0),
                     (517, 517, True, 200, 0), (64, 700, True, 0, 600),
                     (1, 4096, True, 0, 4095)):
            Sq, Sk, causal, window, off = args
            assert kfa.kernel_pairs(Sq, Sk, body, causal, window, off) == \
                brute(Sq, Sk, body, causal, window, off), (body, args)


def test_b9_op_on_the_cpu_is_the_plain_version():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 40, 4, 16, generator=g)
    k = torch.randn(1, 40, 2, 16, generator=g)
    kfa.reset_launch_counts()
    o, lse = kfa.flash_attention_fwd(q, k, k, causal=True, q_chunk=16,
                                     kv_chunk=16)
    po, plse = kfa.flash_attention_fwd_plain(q, k, k, causal=True,
                                             q_chunk=16, kv_chunk=16)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    assert kfa.launch_counts() == {"flash_attention": 0}


# ----------------------------------------------------------------------
# the step trace
# ----------------------------------------------------------------------

def test_trace_step_and_its_readers():
    from repro_torch.sharding.axes import log_transfer
    x = torch.ones(4, 8)
    with roofline.trace_step(positions=4) as tr:
        y = x @ x.T
        log_transfer(y, "all-gather", receivers=3)
        log_transfer(y, "all-reduce")
    assert tr.flops == 2 * 4 * 8 * 4
    assert roofline.cost_analysis(tr) == {"flops": tr.flops / 4}
    got = roofline.collective_bytes(tr)
    assert got["all-gather"] == 3 * 64 / 4 and got["all-reduce"] == 64 / 4
    assert roofline.count_ops(tr, "all-gather") == 1
    both = tr.combine(tr.scaled(3.0))
    assert both.flops == 4 * tr.flops and \
        both.collectives["all-gather"] == 4 * tr.collectives["all-gather"]
    assert roofline.shape_bytes({"a": _meta(3, 5), "b": [torch.ones(2)]}) \
        == 3 * 5 * 2 + 2 * 4
    rf = roofline.analyze(tr, name="t", mesh_spec=hw.MeshSpec((2, 2),
                                                              ("data", "model")),
                          model_flops_global=tr.flops)
    assert rf.flops_per_dev == tr.flops / 4 and rf.chip is hw.TARGET
    assert rf.useful_ratio == 1.0
