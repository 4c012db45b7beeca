"""The dry run (launch/dryrun.py) on meta meshes, the collective log and
the roofline table.

* ``build_cell`` on a (1, 1) meta mesh for a train, a prefill and a
  decode cell: every argument leaf is on meta, and the step traced on
  meta counts FLOPs > 0 (the reference's
  test_dryrun_build_cell_abstract_only).
* ``run_cell`` on a (2, 4) meta mesh with the reduced configs (B=4 x
  S=32): every shape of the transformer families and every family's
  train cell is ``ok``; the ssm, hybrid and encdec inference cells are
  FAILED with the NotImplementedError naming ROADMAP.md's next item.
  Argument bytes a position equal an independent sum over that
  position's block shapes.  ``trace_cell`` (one microbatch times
  n_micro, at depths 1 and 2 of each unit the family stacks,
  extrapolated) counts what ``trace_whole`` (the whole step) counts, for
  a uniform stack, a hybrid's super-blocks and an encdec's two stacks.
* The collective log of one fsdp_tp layer of reduced yi-6b equals the
  bytes worked out from the specs, exactly; with the log closed the
  sharded train step's loss and gradients are bit for bit those with
  it open (the log adds no work to the numbers).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import (ASSIGNED, SHAPES, reduced_config,
                                 reduced_shape)
from repro_torch.core import roofline
from repro_torch.core.tree import leaves
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api, convert, transformer
from repro_torch.runtime.trainer import value_and_grad
from repro_torch.sharding import plans
from repro_torch.sharding.axes import Sharded, collective_log, spec_axes

FAMILY = {a: reduced_config(a).family for a in ASSIGNED}


@pytest.fixture
def reduced(monkeypatch):
    """run_cell on the reduced configs."""
    monkeypatch.setattr(dryrun, "get_config", reduced_config)


def _meta_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _meta_leaves(v)
    elif isinstance(tree, Sharded):
        yield from tree.blocks.values()
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _meta_leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_build_cell_is_abstract_and_traces(kind):
    cfg = reduced_config("yi-6b")
    mesh = make_host_mesh((1, 1), spread="meta")
    shape = dataclasses.replace(reduced_shape(kind), global_batch=4)
    plan = plans.default_plan(cfg, shape)
    cell = dryrun.build_cell(cfg, shape, mesh, plan)
    got = list(_meta_leaves(cell.args))
    assert got and all(t.device.type == "meta" for t in got)
    with roofline.trace_step(mesh.size) as tr:
        cell.step(*cell.args)
    assert roofline.cost_analysis(tr)["flops"] > 0


@pytest.mark.parametrize("arch", ASSIGNED)
def test_run_cell_on_a_meta_mesh(arch, reduced):
    for shape in SHAPES:
        rec = dryrun.run_cell(arch, shape, mesh_shape="2x4", batch=4,
                              seq=32)
        served = FAMILY[arch] in transformer.FAMILIES
        if shape != "train_4k" and not served:
            assert rec["status"] == "FAILED"
            assert rec["error"].startswith("NotImplementedError")
            assert "ROADMAP.md queue A" in rec["error"]
            continue
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["cost_analysis"]["flops"] > 0
        assert rec["memory_analysis"]["temp_size_in_bytes"] is None
        assert rec["cuts"]["shape"] == (
            f"4 x 32 of {SHAPES[shape].global_batch} x "
            f"{SHAPES[shape].seq_len}")
        for k in ("model_flops", "impl_flops_dev", "step_s", "dominant"):
            assert k in rec["analytic"]
        assert rec["fits_hbm"]


def _block_bytes(shape, spec, dtype, mesh_shape):
    """Bytes of one block of a leaf: each dim over its axes' sizes."""
    n = 1
    for d, a in zip(shape, spec_axes(spec, len(shape))):
        parts = 1
        for x in (() if a is None else ((a,) if isinstance(a, str) else a)):
            parts *= mesh_shape[x]
        n *= d // parts
    return n * torch.empty((), dtype=dtype).element_size()


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
def test_argument_bytes_are_each_positions_blocks(shape_name):
    """Independent sum: the parameters' blocks by api.pspecs, the
    cache's by plans.cache_pspecs, the inputs by plans.input_pspecs."""
    cfg = reduced_config("internvl2-1b")
    shape = dataclasses.replace(SHAPES[shape_name], global_batch=4,
                                seq_len=32)
    mesh = make_host_mesh((2, 4), spread="meta")
    plan = plans.default_plan(cfg, shape)
    cell = dryrun.build_cell(cfg, shape, mesh, plan)
    mem = dryrun.memory_by_position(cell, cfg, shape, plan, mesh)
    ms = mesh.shape
    want = 0
    specs = api.pspecs(cfg, plan.param_rules, ms)
    flat_specs = dict(zip(_paths(specs), _flat(specs)))
    for path, leaf in zip(_paths(api.param_shapes(cfg)),
                          _flat(api.param_shapes(cfg))):
        dt = torch.float32
        want += _block_bytes(leaf.shape, flat_specs[path], dt, ms)
    cache_specs = plans.cache_pspecs(cfg, shape, plan, mesh)
    for k, t in api.cache_specs(cfg, shape).items():
        want += _block_bytes(t.shape, cache_specs[k], torch.bfloat16, ms)
    in_specs = plans.input_pspecs(cfg, shape, plan, mesh)
    for k, t in api.input_specs(cfg, shape).items():
        want += _block_bytes(t.shape, in_specs[k], t.dtype, ms)
    assert mem["argument_size_in_bytes"] == want
    cache = sum(_block_bytes(t.shape, cache_specs[k], torch.bfloat16, ms)
                for k, t in api.cache_specs(cfg, shape).items())
    assert mem["alias_size_in_bytes"] == cache


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                        f"{prefix}/{k}")]
    return [prefix]


# each unit of the family's depth at 3 or 2, so the extrapolation from
# depths 1 and 2 is not the traced step itself
DEPTHS = {"zamba2-2.7b": {"superblocks": 3},
          "whisper-small": {"enc_layers": 3, "dec_layers": 2}}


@pytest.mark.parametrize("arch,shape_name", [("moonshot-v1-16b-a3b",
                                              "train_4k"),
                                             ("moonshot-v1-16b-a3b",
                                              "prefill_32k"),
                                             ("yi-6b", "long_500k"),
                                             ("zamba2-2.7b", "train_4k"),
                                             ("whisper-small", "train_4k"),
                                             ("falcon-mamba-7b", "seq"),
                                             ("zamba2-2.7b", "seq")])
def test_trace_modes_count_what_the_whole_step_counts(arch, shape_name):
    """`trace_cell` (one microbatch, depths 1 and 2 of each unit,
    extrapolated) against `trace_whole`, on the reduced config at 3
    layers (a hybrid's super-blocks, an encdec's two stacks: `DEPTHS`),
    B=4 x S=32 on a (2, 2) mesh, where the train cell takes 2
    microbatches and the moe prefill 2 chunks (both forced).  "seq": an
    ssm or hybrid train cell at depth 1 and 4 x 128 positions, its
    sequence extrapolated from 128, 256 and 384."""
    units = DEPTHS.get(arch, {"layers": 3})
    seq = 32
    if shape_name == "seq":
        shape_name, seq = "train_4k", 4 * dryrun.SEQ_QUANTUM
        units = dict.fromkeys(units, 1)
    cfg = dryrun.at_depth(dataclasses.replace(reduced_config(arch),
                                              remat="full"), units)
    assert dryrun.depth(cfg) == units
    shape = dataclasses.replace(SHAPES[shape_name], global_batch=4,
                                seq_len=seq)
    mesh = make_host_mesh((2, 2), spread="meta")
    plan = plans.default_plan(cfg, shape)
    orig = (dryrun.n_microbatches, dryrun.moe_prefill_chunks)
    try:
        dryrun.n_microbatches = lambda *a: 2
        dryrun.moe_prefill_chunks = lambda c, s: 2 if c.family == "moe" \
            else 1
        got = dryrun.trace_cell(cfg, shape, mesh, plan)
        full = dryrun.trace_whole(dryrun.build_cell(cfg, shape, mesh, plan),
                                  mesh.size)
    finally:
        dryrun.n_microbatches, dryrun.moe_prefill_chunks = orig
    assert full.flops > 0
    assert got.flops == full.flops
    for k, v in full.collectives.items():
        assert got.collectives[k] == v, k


def test_a_fresh_process_counts_b9_in_its_first_trace():
    """FlopCounterMode copies the formula registry when it is made: the
    first trace of a process, before anything imported B9's module,
    still counts B9's formula (a prefill cell runs B9, one a layer)."""
    code = (
        "import dataclasses, sys\n"
        "from repro_torch.configs import reduced_config, reduced_shape\n"
        "from repro_torch.launch import dryrun\n"
        "from repro_torch.launch.mesh import make_host_mesh\n"
        "from repro_torch.sharding import plans\n"
        "assert 'repro_torch.kernels.flash_attention' not in sys.modules\n"
        "cfg = reduced_config('yi-6b')\n"
        "shape = dataclasses.replace(reduced_shape('prefill'), "
        "global_batch=2)\n"
        "mesh = make_host_mesh((1, 1), spread='meta')\n"
        "cell = dryrun.build_cell(cfg, shape, mesh, "
        "plans.default_plan(cfg, shape))\n"
        "tr = dryrun.trace_whole(cell, mesh.size)\n"
        "print(tr.flops_by_op.get('repro_torch.flash_attention_fwd', 0))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(__file__).resolve().parents[1] / "src")]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert float(out.stdout.strip().splitlines()[-1]) > 0


def _layer_case():
    cfg = reduced_config("yi-6b")
    mesh = make_host_mesh((2, 4), devices=["cpu"] * 8)
    plan = plans.get_plan("fsdp_tp")
    params = convert.shard_params(api.init(cfg, 0, device="cpu"), cfg, mesh,
                                  rules=plan.param_rules)
    B, S = 4, 8
    groups = transformer._groups(mesh, plan, B)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, S, cfg.d_model, generator=g).to(torch.bfloat16)
    xs = [{d: x[grp.rows[0]:grp.rows[1]] for d in grp.devices}
          for grp in groups]
    return cfg, mesh, plan, params, groups, xs, (B, S)


def test_collective_log_of_one_fsdp_tp_layer():
    cfg, mesh, plan, params, groups, xs, (B, S) = _layer_case()
    lp = transformer.layer_list(params["layers"], cfg.num_layers)[0]
    with torch.no_grad(), collective_log() as log:
        transformer._sharded_layer(cfg, groups, False, lp, xs)
    D, M = mesh.shape["data"], mesh.shape["model"]
    workers = sum(len(g.workers) for g in groups)
    assert workers == D * M

    def gathered(tree):
        """Each worker takes in the D - 1 other data blocks of every
        leaf split over `data`."""
        if isinstance(tree, dict):
            return sum(gathered(v) for v in tree.values())
        if tree.split("data") is None:
            return 0
        one = next(iter(tree.blocks.values()))
        return workers * (D - 1) * one.numel() * one.element_size()
    want_ag = gathered(lp)
    # two xshard_sums a group (attention out, MLP down): M float32
    # partials [1, B/D, S, d], each taken in by the M - 1 other workers
    part = (B // D) * S * cfg.d_model * 4
    want_ar = len(groups) * 2 * M * (M - 1) * part
    got = log.bytes()
    assert got["all-gather"] == want_ag
    assert got["all-reduce"] == want_ar
    assert got["reduce-scatter"] == got["all-to-all"] == 0
    assert log.ops()["all-reduce"] == len(groups) * 2 * M


def test_the_log_changes_no_number_of_the_train_step():
    cfg = reduced_config("moonshot-v1-16b-a3b")
    mesh = make_host_mesh((2, 4), devices=["cpu"] * 8)
    plan = plans.get_plan("fsdp_tp")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 17))
                            .astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def run(log):
        params = convert.shard_params(api.init(cfg, 0, device="cpu"), cfg,
                                      mesh, rules=plan.param_rules)
        if not log:
            return value_and_grad(cfg, params, batch, mesh=mesh, plan=plan)
        with collective_log() as lg:
            out = value_and_grad(cfg, params, batch, mesh=mesh, plan=plan)
        assert lg.bytes()["reduce-scatter"] > 0 and \
            lg.bytes()["all-to-all"] > 0
        return out
    (l0, g0), (l1, g1) = run(False), run(True)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(leaves(g0), leaves(g1)))


def test_roofline_table_reads_records_and_falls_back(tmp_path, monkeypatch,
                                                     reduced):
    from repro_torch.benchmarks import roofline_table
    rec = dryrun.run_cell("yi-6b", "decode_32k", mesh_shape="2x4", batch=4,
                          seq=32)
    (tmp_path / "yi-6b__decode_32k__pod1.json").write_text(
        json.dumps(rec))
    monkeypatch.setenv("REPRO_TORCH_DRYRUN_DIR", str(tmp_path))
    rows = {r.name: r for r in roofline_table.roofline_table("cpu")}
    assert len(rows) == len(ASSIGNED) * len(SHAPES)
    name = f"yi-6b/decode_32k/{rec['plan']}"
    assert rows[name].us_per_call == rec["analytic"]["step_s"] * 1e6
    assert "yi-6b/train_4k/analytic-only" in rows


def test_cli_writes_a_record(tmp_path, reduced):
    assert dryrun.main(["--arch", "internvl2-1b", "--shape", "decode_32k",
                        "--mesh", "2x4", "--batch", "4", "--seq", "32",
                        "--out", str(tmp_path)]) == 0
    rec = json.loads(
        (tmp_path / "internvl2-1b__decode_32k__2x4.json").read_text())
    assert rec["status"] == "ok" and rec["trace"] == "layers"
    assert dryrun.main(["--arch", "whisper-small", "--shape", "long_500k",
                        "--mesh", "2x4", "--batch", "4", "--seq", "32",
                        "--out", str(tmp_path)]) == 1
