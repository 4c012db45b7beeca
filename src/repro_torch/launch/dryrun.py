"""Multi-pod dry run: build and trace every (arch x shape x mesh) cell.

PyTorch counterpart of ``repro/launch/dryrun.py``.  For each cell this
builds the *production* step with the plan's layouts: the full train
step (loss, gradient and AdamW over ``n_micro`` microbatches, bf16
moments and accumulators when the state passes 4e9 bytes a chip) for
train shapes, the sharded prefill (moe prefill chunked over the batch
past 2^17 tokens) and the sharded decode step for inference shapes, on
the 16x16 single-pod or the 2x16x16 multi-pod mesh.  The reference
lowers and compiles each step with XLA and reads its memory and cost
analyses and the post-SPMD HLO's collectives.  PyTorch has no such
compile, so the port builds the step's arguments as ``Sharded`` trees
on the meta device (every position of ``make_production_mesh`` is
``meta``: shapes, no storage) and traces it there (core/roofline.
trace_step: ``FlopCounterMode`` and the collective log; B9 is a
registered op whose formula counts the kernel's own work):

    memory_analysis   each position's argument / output / alias bytes
                      from its blocks (a replicated block counts on
                      every position that holds it); the largest
                      position's; temp bytes: None on meta, the step's
                      peak allocation on the card
    cost_analysis     {"flops": FLOPs a position}
    collective_bytes  logged bytes a position takes in, by kind

plus the analytic roofline (core/analytic.py).  On meta the counts are
traced at depth 1 in each unit the family stacks (layers; encoder and
decoder layers for encdec; super-blocks of ``attn_every`` layers for
hybrid) and again with each unit at 2, and extrapolated linearly to the
config's depth, each at one microbatch (and one moe prefill chunk)
times n_micro (n_chunks): every unit repeats the same shapes, the
microbatches have equal shapes, and the optimizer update adds no
counted FLOPs or transfers.  An ssm or hybrid train cell, whose Mamba
scans walk the sequence chunk by chunk, is traced so at 128, 256 and
384 positions and extrapolated to its length through the quadratic
those fix (whole chunks and B9 tiles: its counts are a quadratic in
the length).  So the count is the whole step's (the tests hold it to
``trace_whole``, the whole step traced once, which one thread does
slowly at 256 positions: PERF.md §6).

``--device cuda`` runs the cell on the card instead (random weights,
seed 0): the whole step is traced there and timed (wall and CUDA
events), and its temp bytes are the peak allocation over the
arguments.  ``--mesh DxM`` (e.g. 2x4) replaces the production mesh;
``--spread`` lays all its positions on one card.  ``--layers`` (each
stack of an encdec config), ``--batch`` and ``--seq`` cut the cell
(each cut is recorded).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --device meta \\
        --arch yi-6b --shape decode_32k

Artifacts: one JSON a cell under ``--out`` (artifacts/dryrun_torch),
which src/repro_torch/benchmarks/roofline_table.py reads.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ASSIGNED, SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import analytic, hw, roofline
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import api, common, convert
from repro_torch.optim.adamw import AdamW
from repro_torch.sharding import plans as plans_mod
from repro_torch.sharding.axes import (Mesh, Sharded, axes_parts,
                                       mesh_coords, spec_axes)


@dataclasses.dataclass
class Cell:
    """A built cell: the step, its arguments (``Sharded`` trees and
    tensors), the donated argument indices (the reference's), and the
    equal parts a step is made of (`repeat`: microbatches or moe
    prefill chunks) with `part`, a step over one part's arguments."""
    step: Callable
    args: Tuple
    donate: Tuple[int, ...]
    repeat: int = 1
    part: Optional[Tuple[Callable, Tuple]] = None
    out_bytes: Optional[Callable] = None


def _params(cfg: ModelConfig, plan, mesh: Mesh, seed, device):
    """Parameters laid by the plan's param rules: `api.abstract`'s meta
    tensors, or (a seed) random ones from `api.init` on `device`."""
    full = (api.abstract(cfg) if seed is None
            else api.init(cfg, seed, device=device))
    return convert.shard_params(full, cfg, mesh, rules=plan.param_rules)


def _inputs(cfg, shape, seed, device) -> Dict[str, torch.Tensor]:
    if seed is None:
        return api.input_specs(cfg, shape)
    return api.make_batch(cfg, shape, seed, device=device)


def n_microbatches(cfg: ModelConfig, shape: ShapeConfig, plan,
                   mesh_shape: Dict[str, int]) -> int:
    """The reference's rule: `estimate_microbatches` at the tokens a
    data position holds, at most the rows a data position holds."""
    from repro_torch.launch.train import estimate_microbatches
    dp = 1
    for name, size in mesh_shape.items():
        if name != "model":
            dp *= size
    tokens_dev = shape.tokens / min(dp, shape.global_batch)
    seq_shard = (mesh_shape.get("model", 1)
                 if plan.act_rules.get("seq") == "model" else 1)
    n_micro = estimate_microbatches(cfg, tokens_dev, seq_shard=seq_shard)
    return min(n_micro, max(shape.global_batch // dp, 1))


def moe_prefill_chunks(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """The reference's moe prefill chunking: halve the batch while a
    chunk holds more than 2^17 tokens."""
    n = 1
    if cfg.family == "moe":
        while (shape.tokens // n > 1 << 17
               and shape.global_batch % (n * 2) == 0):
            n *= 2
    return n


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, plan, *,
               seed: Optional[int] = None, device=None,
               n_micro: Optional[int] = None) -> Cell:
    """The cell's step and arguments (the reference's `build_cell`):
    ``Sharded`` meta trees (`seed` None) or random ones on the mesh's
    devices.  `n_micro` overrides the microbatch rule (a depth-cut
    trace keeps the full config's)."""
    mesh_shape = mesh.shape
    params = _params(cfg, plan, mesh, seed, device)
    batch = _inputs(cfg, shape, seed, device)

    if shape.kind == "train":
        from repro_torch.launch.train import make_train_step
        n_chips = 1
        for s in mesh_shape.values():
            n_chips *= s
        state_bytes = common.count_params(api.param_shapes(cfg)) * 12 \
            / n_chips
        big = state_bytes > 4e9
        opt = AdamW(moment_dtype="bfloat16" if big else "float32")
        opt_state = opt.init(params)
        if n_micro is None:
            n_micro = n_microbatches(cfg, shape, plan, mesh_shape)
        acc = torch.bfloat16 if big else torch.float32
        step = make_train_step(cfg, opt, n_micro=n_micro, acc_dtype=acc,
                               mesh=mesh, plan=plan)
        rows = shape.global_batch // n_micro
        one = make_train_step(cfg, opt, acc_dtype=acc, mesh=mesh, plan=plan)
        part = (one, (params, opt_state,
                      {k: v[:rows] for k, v in batch.items()}))
        return Cell(step, (params, opt_state, batch), (0, 1), n_micro, part)

    def cache_for(B):
        return api.init_cache(cfg, B, shape.seq_len, mesh=mesh, plan=plan)

    if shape.kind == "prefill":
        n_chunks = moe_prefill_chunks(cfg, shape)

        def prefill_step(params, batch, cache):
            return api.prefill(cfg, params, batch, cache, mesh=mesh,
                               plan=plan)

        if n_chunks == 1:
            return Cell(prefill_step,
                        (params, batch, cache_for(shape.global_batch)),
                        (2,))
        Bs = shape.global_batch // n_chunks

        def chunked_step(params, batch):
            outs = [prefill_step(params, {k: v[c * Bs:(c + 1) * Bs]
                                          for k, v in batch.items()},
                                 cache_for(Bs))
                    for c in range(n_chunks)]
            return (torch.cat([o[0] for o in outs]),
                    [o[1] for o in outs])

        part = (prefill_step, (params, {k: v[:Bs] for k, v in batch.items()},
                               cache_for(Bs)))
        whole = cache_for_specs(cfg, shape, plan, mesh)
        return Cell(chunked_step, (params, batch), (), n_chunks, part,
                    out_bytes=lambda c: _position_bytes(whole, c, mesh, plan))

    # decode
    def serve_step(params, cache, token, pos):
        return api.decode_step(cfg, params, cache, token, pos, mesh=mesh,
                               plan=plan)

    return Cell(serve_step, (params, cache_for(shape.global_batch),
                             batch["token"], batch["pos"]), (1,))


def cache_for_specs(cfg, shape, plan, mesh):
    """The whole cell's cache laid out on meta positions, for its bytes
    a position."""
    meta = Mesh(np.full(mesh.devices.shape, torch.device("meta")),
                mesh.axis_names)
    return api.init_cache(cfg, shape.global_batch, shape.seq_len, mesh=meta,
                          plan=plan)


# ----------------------------------------------------------------------
# bytes a position
# ----------------------------------------------------------------------

def _position_bytes(tree, coord, mesh: Mesh, plan) -> int:
    """The bytes of a tree that position `coord` holds: each Sharded
    leaf's block there; a plain tensor is an input, its rows laid by
    the plan's batch spec (plans.input_pspecs' rule; a scalar whole)."""
    if isinstance(tree, Sharded):
        n = 1
        for s in tree.block_range(tree.block_at(coord)):
            n *= s.stop - s.start
        return n * tree.dtype.itemsize
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_position_bytes(v, coord, mesh, plan) for v in tree)
    parts = 1
    if tree.ndim:
        spec = plans_mod.batch_pspec(plan, tree.shape[0], mesh.shape)
        parts = axes_parts(spec_axes(spec, 1)[0], mesh.shape)
    return tree.numel() * tree.element_size() // parts


def memory_by_position(cell: Cell, cfg, shape, plan, mesh: Mesh
                       ) -> Dict[str, Any]:
    """The largest position's argument, output and alias bytes (the
    reference's memory analysis, from the blocks each position
    holds)."""
    # the logits: [B, vocab] bf16 rows by the batch spec
    logits = (torch.empty((shape.global_batch, cfg.vocab_size),
                          dtype=torch.bfloat16, device="meta")
              if shape.kind != "train" else None)
    best = None
    for c in mesh_coords(mesh):
        arg = _position_bytes(cell.args, c, mesh, plan)
        alias = sum(_position_bytes(cell.args[i], c, mesh, plan)
                    for i in cell.donate)
        out = alias if cell.out_bytes is None else cell.out_bytes(c)
        if logits is not None:
            out += _position_bytes(logits, c, mesh, plan)
        if best is None or arg > best[0]:
            best = (arg, out, alias)
    arg, out, alias = best
    return {"argument_size_in_bytes": int(arg),
            "output_size_in_bytes": int(out),
            "alias_size_in_bytes": int(alias),
            "temp_size_in_bytes": None}


# ----------------------------------------------------------------------
# tracing
# ----------------------------------------------------------------------

def _trace(fn, args, positions: int) -> roofline.StepTrace:
    with roofline.trace_step(positions) as tr:
        fn(*args)
    return tr


def trace_whole(cell: Cell, positions: int) -> roofline.StepTrace:
    """The whole step traced once."""
    return _trace(cell.step, cell.args, positions)


def _trace_part(cell: Cell, positions: int) -> roofline.StepTrace:
    """One part of the step (a microbatch, a moe prefill chunk) traced,
    times the parts."""
    if cell.part is None:
        return trace_whole(cell, positions)
    fn, args = cell.part
    return _trace(fn, args, positions).scaled(cell.repeat)


def depth(cfg: ModelConfig) -> Dict[str, int]:
    """The config's depth in the units its family stacks, each unit one
    set of equal shapes: encoder and decoder layers (encdec),
    super-blocks of `attn_every` layers (hybrid), else layers."""
    if cfg.family == "encdec":
        return {"enc_layers": cfg.enc_layers, "dec_layers": cfg.dec_layers}
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import n_superblocks
        return {"superblocks": n_superblocks(cfg)}
    return {"layers": cfg.num_layers}


def at_depth(cfg: ModelConfig, units: Dict[str, int]) -> ModelConfig:
    """`cfg` at `units` (the keys of `depth`)."""
    if cfg.family == "encdec":
        E, D = units["enc_layers"], units["dec_layers"]
        return dataclasses.replace(cfg, enc_layers=E, dec_layers=D,
                                   num_layers=E + D)
    if cfg.family == "hybrid":
        return dataclasses.replace(
            cfg, num_layers=units["superblocks"] * cfg.attn_every)
    return dataclasses.replace(cfg, num_layers=units["layers"])


# the families whose step walks the sequence in chunks from Python (the
# Mamba scans: 128 positions a chunk for Mamba-1, 64 for Mamba-2), and
# the length whose multiples keep every chunk and B9 tile whole there:
# their train counts are then a quadratic in the sequence length
SEQ_FAMILIES = ("ssm", "hybrid")
SEQ_QUANTUM = 128


def trace_cell(cfg, shape, mesh, plan) -> roofline.StepTrace:
    """The step's counts (module docstring): one part traced at depth 1
    in every unit, and again with each unit of depth > 1 at 2; the
    differences extrapolated to `depth(cfg)`.  The microbatch rule
    keeps the full config's n_micro.  A train cell of `SEQ_FAMILIES`
    at n > 3 multiples of `SEQ_QUANTUM` is traced so at 1, 2 and 3 of
    them and extrapolated to n through the quadratic they fix (a
    sequence walked chunk by chunk traces slowly at 256 positions)."""
    n_micro = (n_microbatches(cfg, shape, plan, mesh.shape)
               if shape.kind == "train" else None)

    def at(units, seq_len):
        cell = build_cell(at_depth(cfg, units),
                          dataclasses.replace(shape, seq_len=seq_len),
                          mesh, plan, n_micro=n_micro)
        return _trace_part(cell, mesh.size)

    def deep(seq_len):
        full = depth(cfg)
        ones = dict.fromkeys(full, 1)
        base = at(ones, seq_len)
        out = base
        for unit, n in full.items():
            if n > 1:
                per_unit = at({**ones, unit: 2}, seq_len).combine(
                    base, 1.0, -1.0)
                out = out.combine(per_unit, 1.0, n - 1.0)
        return out

    q, S = SEQ_QUANTUM, shape.seq_len
    if cfg.family not in SEQ_FAMILIES or shape.kind != "train" or \
            S % q or S <= 3 * q:
        return deep(S)
    n = S // q
    f1, f2, f3 = deep(q), deep(2 * q), deep(3 * q)
    # Newton's forward differences: f1 + (n-1) d1 + (n-1)(n-2)/2 d2
    d1 = f2.combine(f1, 1.0, -1.0)
    d2 = f3.combine(f2, 1.0, -2.0).combine(f1, 1.0, 1.0)
    return f1.combine(d1, 1.0, n - 1.0).combine(
        d2, 1.0, (n - 1) * (n - 2) / 2)


def _cut(cfg: ModelConfig, layers: int) -> Tuple[ModelConfig, str]:
    """`cfg` cut to `layers` (every stack of an encdec config; a
    multiple of `attn_every` for hybrid), and the cut's text."""
    if cfg.family == "encdec":
        return (at_depth(cfg, {"enc_layers": layers, "dec_layers": layers}),
                f"{layers} + {layers} of {cfg.enc_layers} + "
                f"{cfg.dec_layers}")
    return (dataclasses.replace(cfg, num_layers=layers),
            f"{layers} of {cfg.num_layers}")


# ----------------------------------------------------------------------
# one cell
# ----------------------------------------------------------------------

def _mesh(dims, device: str, spread: bool) -> Mesh:
    axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    if device == "meta":
        return make_host_mesh(dims, axes, spread="meta")
    if spread:
        return make_host_mesh(dims, axes, spread=device)
    return make_host_mesh(dims, axes)


@dataclasses.dataclass
class Setup:
    """What a cell's record is made for: the config and shape after the
    cuts, the mesh and its MeshSpec, the plan, the cuts, the device."""
    arch: str
    shape_name: str
    cfg: ModelConfig
    shape: ShapeConfig
    mesh: Mesh
    mesh_spec: hw.MeshSpec
    plan: Any
    cuts: Dict[str, str]
    device: str


def setup_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               plan_name: Optional[str] = None, remat: Optional[str] = None,
               mesh_shape: Optional[str] = None, device: str = "meta",
               spread: bool = False, layers: Optional[int] = None,
               batch: Optional[int] = None, seq: Optional[int] = None
               ) -> Setup:
    """The cell's config, shape, mesh and plan (the arguments of
    `run_cell`)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    cuts = {}
    if layers is not None and layers != cfg.num_layers:
        cfg, cuts["layers"] = _cut(cfg, layers)
    if batch is not None or seq is not None:
        b = batch or shape.global_batch
        s = seq or shape.seq_len
        cuts["shape"] = (f"{b} x {s} of {shape.global_batch} x "
                         f"{shape.seq_len}")
        shape = dataclasses.replace(shape, global_batch=b, seq_len=s)
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    elif shape.kind == "train":
        cfg = dataclasses.replace(cfg, remat="full")
    if mesh_shape:
        dims = tuple(int(x) for x in mesh_shape.split("x"))
        axes = ("data", "model") if len(dims) == 2 else \
            ("pod", "data", "model")
        mesh = _mesh(dims, device, spread)
        mesh_spec = hw.MeshSpec(shape=dims, axis_names=axes)
        multi_pod = len(dims) == 3
    else:
        if device != "meta":
            raise ValueError("the production meshes are meta-only: pass "
                             "mesh_shape= on the card")
        mesh = make_production_mesh(multi_pod=multi_pod)
        mesh_spec = hw.MULTI_POD if multi_pod else hw.SINGLE_POD
    plan = (plans_mod.get_plan(plan_name, multi_pod=multi_pod)
            if plan_name else
            plans_mod.default_plan(cfg, shape, multi_pod=multi_pod))
    return Setup(arch, shape_name, cfg, shape, mesh, mesh_spec, plan, cuts,
                 device)


def record_cell(setup: Setup, cell: Optional[Cell] = None, *,
                seed: int = 0) -> Dict[str, Any]:
    """The cell's record; raises where the cell does.  On meta the
    counts are `trace_cell`'s; on a device the step (`cell`, or one
    built with random weights from `seed`) is traced whole while it
    runs, then run once more and timed (`step_ms`)."""
    cfg, shape, mesh, plan = setup.cfg, setup.shape, setup.mesh, setup.plan
    meta = setup.device == "meta"
    record: Dict[str, Any] = {
        "arch": setup.arch, "shape": setup.shape_name,
        "mesh": "x".join(str(s) for s in mesh.devices.shape),
        "plan": plan.name, "status": "ok", "device": setup.device,
        "cuts": setup.cuts, "trace": "layers" if meta else "whole",
    }
    on_card = torch.device(setup.device).type == "cuda"
    t0 = time.time()
    if cell is None:
        cell = build_cell(cfg, shape, mesh, plan,
                          seed=None if meta else seed,
                          device=None if meta else mesh.positions[0])
        record["build_s"] = time.time() - t0
    mem = memory_by_position(cell, cfg, shape, plan, mesh)
    if meta:
        t1 = time.time()
        tr = trace_cell(cfg, shape, mesh, plan)
    else:
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t1 = time.time()
        with roofline.trace_step(mesh.size) as tr:
            out = cell.step(*cell.args)
        if on_card:
            torch.cuda.synchronize()
            mem["temp_size_in_bytes"] = int(
                torch.cuda.max_memory_allocated() - base)
    record["trace_s"] = time.time() - t1
    tr.memory = mem
    if not meta:
        if shape.kind == "train":
            record["loss"] = float(out[2]["loss"])
        record["step_ms"] = _time_step(cell, on_card)
    coll = roofline.collective_bytes(tr)
    record["memory_analysis"] = roofline.memory_analysis(tr)
    record["cost_analysis"] = roofline.cost_analysis(tr)
    record["flops_by_op"] = {k: v / mesh.size
                             for k, v in tr.flops_by_op.items()}
    record["collective_bytes"] = coll
    record["collective_op_counts"] = {
        k: roofline.count_ops(tr, k) for k in coll}
    total = (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
             + (mem["temp_size_in_bytes"] or 0)
             - mem["alias_size_in_bytes"])
    record["bytes_per_device"] = int(total)
    record["fits_hbm"] = bool(total < setup.mesh_spec.chip.hbm_bytes)
    record["analytic"] = analytic_record(cfg, shape, setup.mesh_spec,
                                         plan.name)
    return record


def run_cell(arch: str, shape_name: str, *, seed: int = 0,
             **kw) -> Dict[str, Any]:
    """Build and trace one cell (`setup_cell`'s keywords: on a mesh of
    `device` meta, cuda, or cpu for the tests); returns its record (the
    reference's keys where they keep their meaning: `build_s` and
    `trace_s` in place of `compile_s`, `collective_bytes` for
    `collective_bytes_hlo`, `fits_hbm` for `fits_16g`).  A cell that
    raises is recorded as FAILED with its error.  `mesh_shape`: "DxM"
    or "PxDxM" in place of the production mesh.  ``device`` meta
    (shapes only) or cuda (random weights from `seed`, the step run and
    timed).  `layers` / `batch` / `seq` cut the cell."""
    record = {"arch": arch, "shape": shape_name,
              "device": kw.get("device", "meta")}
    try:
        setup = setup_cell(arch, shape_name, **kw)
        record.update(mesh="x".join(map(str, setup.mesh.devices.shape)),
                      plan=setup.plan.name, cuts=setup.cuts)
        return record_cell(setup, seed=seed)
    except Exception as e:  # noqa: BLE001
        record.update(status="FAILED", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
        return record


def analytic_record(cfg, shape, mesh_spec, plan_name) -> Dict[str, Any]:
    """The analytic roofline's keys of a record (the reference's)."""
    cell = analytic.analyze_cell(cfg, shape, mesh_spec, plan_name)
    rf = cell.roofline(mesh_spec)
    return {
        "model_flops": cell.model_flops,
        "impl_flops_dev": cell.impl_flops_dev,
        "hbm_bytes_dev": cell.hbm_bytes_dev,
        "coll_bytes_dev": cell.coll_bytes_dev,
        "coll_bytes_by_kind": cell.coll_bytes_by_kind,
        "compute_s": rf.compute_s,
        "memory_s": rf.memory_s,
        "collective_s": rf.collective_s,
        "dominant": rf.dominant,
        "useful_ratio": rf.useful_ratio,
        "mfu": rf.mfu,
        "step_s": rf.step_s,
    }


def _time_step(cell: Cell, on_card: bool = True) -> Dict[str, float]:
    """One more run of the step: wall ms (host clock around the call
    and a sync) and, on the card, device ms (CUDA events)."""
    if not on_card:
        t = time.perf_counter()
        cell.step(*cell.args)
        return {"wall": (time.perf_counter() - t) * 1e3, "device": None}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    start.record()
    cell.step(*cell.args)
    end.record()
    torch.cuda.synchronize()
    return {"wall": (time.perf_counter() - t) * 1e3,
            "device": start.elapsed_time(end)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--plan", default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--mesh", default=None,
                    help="alternative mesh, e.g. 2x4 (overrides pods)")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--device", default="meta", choices=("meta", "cuda"))
    ap.add_argument("--spread", action="store_true",
                    help="lay every mesh position on one card")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    args = ap.parse_args(argv)

    archs = ASSIGNED if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape_name}__" + (
                    args.mesh if args.mesh else ("pod2" if mp else "pod1"))
                rec = run_cell(arch, shape_name, multi_pod=mp,
                               plan_name=args.plan, remat=args.remat,
                               mesh_shape=args.mesh, device=args.device,
                               spread=args.spread,
                               layers=args.layers, batch=args.batch,
                               seq=args.seq)
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
                ok = rec["status"] == "ok"
                failures += 0 if ok else 1
                if ok:
                    print(f"{tag}: OK build={rec['build_s']:.1f}s "
                          f"trace={rec['trace_s']:.1f}s "
                          f"bytes/dev={rec['bytes_per_device'] / 2**30:.2f}GiB"
                          f" fits_hbm={rec['fits_hbm']} "
                          f"dominant={rec['analytic']['dominant']}")
                    print("  memory_analysis:", rec["memory_analysis"])
                    print("  cost_analysis(flops):",
                          rec["cost_analysis"]["flops"], "analytic:",
                          rec["analytic"]["impl_flops_dev"])
                    print("  collectives:", {k: v for k, v in
                                            rec["collective_bytes"].items()
                                            if v})
                else:
                    print(f"{tag}: FAILED {rec['error']}")
    print(f"dry-run complete, failures={failures}")
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
