"""Roofline: the step half (a traced step's three terms) and the
paged-decode KV traffic model.

PyTorch counterpart of ``repro/core/roofline.py``.  The reference
reads a compiled XLA module: ``cost_analysis`` (HLO FLOPs and bytes a
device), ``memory_analysis`` (argument / output / temp / alias bytes)
and collective operand bytes parsed from the post-SPMD HLO text.
PyTorch has no compiled module and no program text, so the port reads
a **step trace** (``StepTrace``, filled by ``trace_step``): one run of
the step under ``torch.utils.flop_counter.FlopCounterMode`` (B9 counted
by its registered formula, kernels/flash_attention.kernel_flops) and
the sharded steps' collective log (sharding/axes.collective_log).  On
the meta device a trace computes nothing; the dry run
(launch/dryrun.py) traces every cell that way and fills the memory
analysis from each position's blocks.  ``Roofline`` is the reference's
three-term report, unchanged but for its default chip (``hw.TARGET``):

    compute    = FLOPs a device          / peak bf16 FLOP/s
    memory     = HBM bytes a device      / HBM GB/s
    collective = wire bytes a device     / link GB/s

``paged_decode_kv_bytes`` / ``paged_decode_speedup``: modeled bytes of
one decode step's K+V read, by read path (the tracer's
``kv_read_mode``: ``kernel`` and ``fp8_kernel``, the port's server, and
``gather``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.core import hw
from repro_torch.sharding.axes import COLLECTIVE_KINDS, collective_log


# ----------------------------------------------------------------------
# the step trace: the port's stand-in for a compiled module and its HLO
# ----------------------------------------------------------------------

@dataclasses.dataclass
class StepTrace:
    """One run of a step over a mesh of `positions`.

    ``flops``: counted over the whole mesh (the port runs once what the
    reference replicates over an axis that splits nothing, so the
    count over positions is an average); ``collectives``: kind ->
    bytes taken in over every receiving position; ``collective_ops``:
    kind -> logged transfers; ``memory``: the largest position's
    argument / output / alias / temp bytes (launch/dryrun.py fills it)."""

    positions: int
    flops: float = 0.0
    flops_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    collectives: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVE_KINDS, 0.0))
    collective_ops: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVE_KINDS, 0.0))
    memory: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def combine(self, other: "StepTrace", a: float = 1.0,
                b: float = 1.0) -> "StepTrace":
        """a * self + b * other, counter by counter (the memory of
        self): a step of equal parts traced once, scaled."""
        out = StepTrace(self.positions, memory=dict(self.memory))
        out.flops = a * self.flops + b * other.flops
        for name in ("flops_by_op", "collectives", "collective_ops"):
            x, y = getattr(self, name), getattr(other, name)
            setattr(out, name, {k: a * x.get(k, 0.0) + b * y.get(k, 0.0)
                                for k in set(x) | set(y)})
        return out

    def scaled(self, n: float) -> "StepTrace":
        return self.combine(self, n, 0.0)


@contextlib.contextmanager
def trace_step(positions: int):
    """Trace what runs inside the block: yields a ``StepTrace`` that is
    filled when the block ends."""
    from torch.utils.flop_counter import FlopCounterMode

    # FlopCounterMode copies the formula registry when it is made: B9's
    # formula must be registered first, or a process's first trace
    # misses the kernel's FLOPs
    import repro_torch.kernels.flash_attention  # noqa: F401
    trace = StepTrace(positions)
    with collective_log() as log, \
            FlopCounterMode(display=False) as counter:
        yield trace
    trace.flops = float(counter.get_total_flops())
    trace.flops_by_op = {str(k): float(v) for k, v in
                         counter.get_flop_counts().get("Global", {}).items()}
    trace.collectives = {k: float(v) for k, v in log.bytes().items()}
    trace.collective_ops = {k: float(v) for k, v in log.ops().items()}


def shape_bytes(tree) -> int:
    """The bytes of every tensor in a tree (dicts, lists, tuples,
    ``Sharded`` leaves: their blocks), meta tensors included: the
    counterpart of the reference's sum over an HLO text's shapes."""
    from repro_torch.sharding.axes import Sharded
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, Sharded):
        return sum(shape_bytes(b) for b in tree.blocks.values())
    if isinstance(tree, dict):
        return sum(shape_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(shape_bytes(v) for v in tree)
    return 0


def collective_bytes(trace: StepTrace) -> Dict[str, float]:
    """Bytes a position takes in, by collective kind (the reference's
    ``collective_bytes`` of the HLO's result shapes): the logged
    logical transfers over the mesh's positions."""
    return {k: trace.collectives.get(k, 0.0) / trace.positions
            for k in COLLECTIVE_KINDS}


def count_ops(trace: StepTrace, opname: str) -> int:
    """Logged transfers of kind `opname` (the reference counts the
    HLO's ops of that name)."""
    return int(trace.collective_ops.get(opname, 0))


def cost_analysis(trace: StepTrace) -> Dict[str, float]:
    """{"flops": FLOPs a position}: FlopCounterMode's count over the
    mesh divided by its positions.  The reference's XLA analysis also
    gives "bytes accessed"; the trace does not count bytes."""
    return {"flops": trace.flops / trace.positions}


def memory_analysis(trace: StepTrace) -> Dict[str, Any]:
    """The largest position's argument / output / alias / temp bytes
    (the reference's XLA memory analysis): computed from each
    position's blocks by launch/dryrun.py; temp is None on meta and
    the card's peak allocation on the card."""
    return dict(trace.memory)


# ----------------------------------------------------------------------
# the roofline report
# ----------------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    name: str
    mesh_desc: str
    num_chips: int
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: Dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_global: float            # 6*N*D (or 6*N_active*D for MoE)
    hbm_bytes_per_dev: Dict[str, int]    # the memory analysis
    chip: hw.ChipSpec = hw.TARGET

    @property
    def total_coll_bytes(self) -> int:
        return sum(self.coll_bytes_per_dev.values())

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Lower-bound step time: resources overlap, the max dominates."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / executed FLOPs (global): the remat and
        redundancy waste metric."""
        hlo_global = self.flops_per_dev * self.num_chips
        return self.model_flops_global / hlo_global if hlo_global else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline-bound step time."""
        if self.step_s <= 0:
            return 0.0
        peak = self.num_chips * self.chip.peak_for("bf16")
        return self.model_flops_global / (self.step_s * peak)

    @property
    def roofline_fraction(self) -> float:
        """compute_term / step time — how close the binding resource lets
        the tensor cores run to their own roofline."""
        return self.compute_s / self.step_s if self.step_s else 0.0

    def row(self) -> str:
        return (
            f"{self.name},{self.mesh_desc},{self.num_chips},"
            f"{self.flops_per_dev:.4g},{self.bytes_per_dev:.4g},"
            f"{self.total_coll_bytes:.4g},"
            f"{self.compute_s:.4g},{self.memory_s:.4g},{self.collective_s:.4g},"
            f"{self.dominant},{self.useful_ratio:.3f},{self.mfu:.3f}"
        )

    @staticmethod
    def header() -> str:
        return ("name,mesh,chips,flops/dev,bytes/dev,coll_bytes/dev,"
                "compute_s,memory_s,collective_s,dominant,useful_ratio,mfu")


def analyze(trace: StepTrace, *, name: str, mesh_spec: hw.MeshSpec,
            model_flops_global: float, bytes_per_dev: float = 0.0,
            collective_axis_gbps: Optional[float] = None) -> Roofline:
    """The three-term roofline of one traced step (the reference's
    ``analyze`` of a compiled module): FLOPs and collective bytes a
    position from the trace; the trace counts no HBM bytes, so the
    memory term takes `bytes_per_dev` (e.g. the analytic model's)."""
    chip = mesh_spec.chip
    flops = cost_analysis(trace)["flops"]
    coll = {k: int(v) for k, v in collective_bytes(trace).items()}
    if collective_axis_gbps is None:
        # conservative: one link per chip serves the collective stream
        collective_axis_gbps = chip.ici_gbps_per_link
    return Roofline(
        name=name,
        mesh_desc="x".join(str(s) for s in mesh_spec.shape),
        num_chips=mesh_spec.num_chips,
        flops_per_dev=flops,
        bytes_per_dev=bytes_per_dev,
        coll_bytes_per_dev=coll,
        compute_s=flops / chip.peak_for("bf16"),
        memory_s=bytes_per_dev / (chip.hbm_gbps * 1e9),
        collective_s=sum(coll.values()) / (collective_axis_gbps * 1e9),
        model_flops_global=model_flops_global,
        hbm_bytes_per_dev=memory_analysis(trace),
        chip=chip,
    )


# ----------------------------------------------------------------------
# paged-decode KV traffic model (serving hot path)
# ----------------------------------------------------------------------


def paged_decode_kv_bytes(kv_len: int, *, block_size: int,
                          max_blocks: int, kv_heads: int, head_dim: int,
                          kv_dtype_bytes: int = 2, scale_bytes: int = 4,
                          mode: str = "gather") -> int:
    """Modeled HBM bytes moved by the K+V read path of ONE decode step,
    per layer per slot, at a current context of `kv_len` tokens.

    mode="gather" (models/attention.gather_paged_cache + the plain
    attention, the servers' ``kernel=False`` oracle):
    the gather reads the pool rows for all `max_blocks` table entries
    (clamped -1s included), writes the [max_blocks*block_size, KH, hd]
    virtual view, and the attention reads that view again — three
    passes over the slot's FULL virtual extent regardless of how short
    its live prefix is.

    mode="kernel" (kernels/paged_attention, the port's ChunkedServer
    read path): the in-kernel block-table walk loads only the
    ceil(kv_len/block_size) valid blocks, once, into shared memory —
    one pass over the live prefix, zero traffic for unallocated tail
    blocks.

    mode="fp8_kernel": same walk on an e4m3 pool — 1 byte per element
    plus one f32 scale per token-row per kv-head (`scale_bytes`).

    The factor-of-3 gather overhead and the valid-block-only kernel
    traffic are the reference's model, unchanged (the tests hold the
    two copies equal).
    """
    row = kv_heads * head_dim
    if mode == "gather":
        return 3 * max_blocks * block_size * row * kv_dtype_bytes * 2
    valid_tokens = -(-kv_len // block_size) * block_size
    if mode == "kernel":
        return valid_tokens * row * kv_dtype_bytes * 2
    if mode == "fp8_kernel":
        return valid_tokens * kv_heads * (head_dim + scale_bytes) * 2
    raise ValueError(f"unknown mode {mode!r}")


def paged_decode_speedup(kv_len: int, *, block_size: int,
                         max_blocks: int, kv_heads: int, head_dim: int
                         ) -> Dict[str, float]:
    """Byte-traffic ratios of the three paged decode read paths at one
    context length (HBM-bound decode: bytes ~ time)."""
    kw = dict(block_size=block_size, max_blocks=max_blocks,
              kv_heads=kv_heads, head_dim=head_dim)
    gather = paged_decode_kv_bytes(kv_len, mode="gather", **kw)
    kern = paged_decode_kv_bytes(kv_len, mode="kernel", **kw)
    fp8 = paged_decode_kv_bytes(kv_len, mode="fp8_kernel", **kw)
    return {"gather_bytes": float(gather), "kernel_bytes": float(kern),
            "fp8_kernel_bytes": float(fp8),
            "kernel_speedup": gather / kern,
            "fp8_speedup": gather / fp8,
            "fp8_vs_kernel_bytes": fp8 / kern}
