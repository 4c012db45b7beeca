"""Parallelism plans: logical-axis -> mesh-axis rule tables.

PyTorch counterpart of ``repro/sharding/plans.py``: the same plans and
rules, over the port's ``Mesh`` and ``PartitionSpec``
(sharding/axes.py).  A plan is two rule dicts (params vs activations —
the same logical name can shard differently: weight "embed" dims shard
over `data` for FSDP/ZeRO-3 while activation "embed" stays unsharded)
plus the batch axes.  Rule values may be a single mesh axis or a tuple
(e.g. batch over ("pod", "data")).

Plans:
  dp        pure data parallel (params replicated)
  fsdp      ZeRO-3 params over `data`, activations DP only
  tp        tensor parallel over `model`, DP over `data`
  fsdp_tp   2D: ZeRO-3 over `data` x TP over `model`   (default)
  fsdp_tp_sp  + sequence-parallel long-context decode (KV over `data`)

The training plans run in the sharded training step of every family
(models/api.loss_fn with ``mesh=``, runtime/trainer.py,
launch/train.py): `param_rules` lay the parameters
(models/convert.shard_params), `batch_axes` split the batch rows
(``batch_placement``), `model` splits the compute by heads, MLP
columns, experts (moe; routing stays global over the batch), Mamba-1
channels and Mamba-2 heads (ssm, hybrid), the encoder, decoder and
cross-attention heads (encdec) and vocab, and ``act_rules["seq"]``
(fsdp_tp_spact) holds the residual stream as row slices over `model`
between blocks.  For a training step
fsdp_tp_sp is fsdp_tp: its `kv_seq_axis` touches decode caches only.
Serving has its own plan
(``serving_plan`` / ``ServingPlan`` below), which ``ChunkedServer(tp=N)``
runs: a 1-axis tensor-parallel mesh over which the transformer weights
shard head-wise / column-row-wise and the KV pool shards along its
KV-head dim, while every scheduler-owned operand stays whole on the
host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple, Union

from repro_torch.sharding.axes import Mesh, PartitionSpec as P, shard_slices

Axis = Union[None, str, Tuple[str, ...]]

# logical axes that carry the TP dimension of weights/activations
_TP_PARAM = ("heads", "kv_heads", "mlp", "vocab", "experts", "ssm_inner",
             "ssm_heads")


@dataclasses.dataclass(frozen=True)
class Plan:
    name: str
    param_rules: Dict[str, Axis]
    act_rules: Dict[str, Axis]
    batch_axes: Axis                    # mesh axes carrying the batch dim
    kv_seq_axis: Axis = None            # SP: decode KV sequence sharding

    def with_pod(self) -> "Plan":
        """Extend for the multi-pod mesh: `pod` joins the batch axes."""
        batch = self.batch_axes
        if batch is None:
            batch = ("pod",)
        elif isinstance(batch, str):
            batch = ("pod", batch)
        else:
            batch = ("pod",) + tuple(batch)
        return dataclasses.replace(self, batch_axes=batch)


def _plan_dp() -> Plan:
    return Plan("dp", param_rules={}, act_rules={"batch": "data",
                                                 "tokens": "data"},
                batch_axes="data")


def _plan_fsdp() -> Plan:
    return Plan(
        "fsdp",
        param_rules={"embed": "data", "vocab": "data", "mlp": "data",
                     "ssm_inner": "data"},
        act_rules={"batch": "data", "tokens": "data"},
        batch_axes="data",
    )


def _tp_act_rules() -> Dict[str, Axis]:
    return {"batch": "data", "tokens": "data", "heads": "model",
            "kv_heads": "model", "mlp": "model", "experts": "model",
            "vocab": "model", "ssm_inner": "model", "ssm_heads": "model"}


def _plan_tp() -> Plan:
    pr = {ax: "model" for ax in _TP_PARAM}
    return Plan("tp", param_rules=pr, act_rules=_tp_act_rules(),
                batch_axes="data")


def _plan_fsdp_tp() -> Plan:
    pr = {ax: "model" for ax in _TP_PARAM}
    pr["embed"] = "data"                 # ZeRO-3 on the non-TP dim
    return Plan("fsdp_tp", param_rules=pr, act_rules=_tp_act_rules(),
                batch_axes="data")


def _plan_fsdp_tp_sp() -> Plan:
    base = _plan_fsdp_tp()
    return dataclasses.replace(base, name="fsdp_tp_sp", kv_seq_axis="data")


def _plan_fsdp_tp_spact() -> Plan:
    """fsdp_tp + Megatron-style activation sequence sharding: the
    residual stream ("seq") shards over `model` between blocks;
    block-internal tensors keep TP sharding."""
    base = _plan_fsdp_tp()
    ar = dict(base.act_rules)
    ar["seq"] = "model"
    return dataclasses.replace(base, name="fsdp_tp_spact", act_rules=ar)


_PLANS = {p.name: p for p in (_plan_dp(), _plan_fsdp(), _plan_tp(),
                              _plan_fsdp_tp(), _plan_fsdp_tp_sp(),
                              _plan_fsdp_tp_spact())}


def get_plan(name: str, *, multi_pod: bool = False) -> Plan:
    plan = _PLANS[name]
    return plan.with_pod() if multi_pod else plan


def default_plan(cfg, shape, *, multi_pod: bool = False) -> Plan:
    """The baseline plan for an (arch, shape) cell: long-context decode
    at a batch under 16 cannot shard the batch and spreads the KV
    sequence over `data` instead (the SP plan)."""
    if shape.kind == "decode" and shape.global_batch < 16:
        return get_plan("fsdp_tp_sp", multi_pod=multi_pod)
    return get_plan("fsdp_tp", multi_pod=multi_pod)


# ----------------------------------------------------------------------
# serving: tensor-parallel plan over a 1-axis device mesh
# ----------------------------------------------------------------------

SERVING_TP_AXIS = "tp"


@dataclasses.dataclass(frozen=True)
class ServingPlan:
    """Tensor-parallel serving contract over a 1-axis ``tp`` mesh.

    Mesh/axis contract (runtime/server.py, launch/mesh.make_tp_mesh):

      * The mesh has exactly one axis (default name ``"tp"``) of size
        ``tp``.  Serving never shards the slot axis: block tables, the
        refcounted allocator and the radix prefix tree are host-side
        numpy structures, so paging, prefix sharing and speculative
        decoding compose with TP unchanged.
      * Weights shard Megatron-style through ``param_rules``: qkv and
        the MLP up/gate projections by columns (logical axes ``heads`` /
        ``kv_heads`` / ``mlp`` carry ``tp``), the attention
        out-projection and MLP down-projection by rows (their leading
        ``heads`` / ``mlp`` dim), the embedding and unembedding over
        ``vocab``.  Dims that do not divide the mesh stay replicated
        (models/common.partition_specs).  Each position holds its slice
        as a tensor of its own (models/convert.shard_params).
      * The KV cache — paged pool ``[L, num_blocks, block_size, KH, hd]``
        or contiguous ``[L, B, T, KH, hd]`` — shards its KV-head dim
        (index 3 in both layouts): each position holds its own dense
        pool of every block but ``KH / tp`` heads, so the KV bytes per
        position shrink by the TP degree while the host allocator keeps
        addressing whole logical blocks.  Requires ``KH % tp == 0`` (the
        server checks).
      * Every other operand (tokens, positions, block tables, the
        sampling mirrors) is replicated: staged once per distinct
        physical device.

    Cross-shard reductions (attention out-projection, MLP
    down-projection) gather every shard's grouped float32 partials in
    shard order and sum them with the fixed tree of
    models/common.fixed_tree_sum (models.transformer.serving_det_groups),
    so outputs at any ``tp`` dividing the group counts are the tp=1
    sums.
    """

    mesh: Mesh
    axis: str = SERVING_TP_AXIS

    @property
    def tp(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def param_rules(self) -> Dict[str, Axis]:
        return {ax: self.axis for ax in _TP_PARAM}

    @property
    def act_rules(self) -> Dict[str, Axis]:
        return {"heads": self.axis, "kv_heads": self.axis,
                "mlp": self.axis, "vocab": self.axis,
                "experts": self.axis}

    @property
    def replicated(self) -> P:
        return P()

    def param_shardings(self, cfg):
        """PartitionSpec tree for the full parameter tree of `cfg`
        (non-divisible dims replicate, as partition_specs)."""
        from repro_torch.models import api
        return api.pspecs(cfg, self.param_rules, {self.axis: self.tp})

    def cache_sharding(self, cfg) -> P:
        """KV cache spec: one spec fits both layouts (the KV-head dim is
        index 3 of the rank-5 ``k``/``v`` leaves); replicated when KH
        does not divide."""
        ax = self.axis if (cfg.num_kv_heads
                           and cfg.num_kv_heads % self.tp == 0) else None
        return P(None, None, None, ax, None)


def serving_plan(mesh: Mesh, axis: str = SERVING_TP_AXIS) -> ServingPlan:
    """The tensor-parallel serving plan for a 1-axis mesh."""
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} not in mesh axes "
                         f"{mesh.axis_names}")
    return ServingPlan(mesh=mesh, axis=axis)


# ----------------------------------------------------------------------
# input / cache partition specs for a cell
# ----------------------------------------------------------------------

def batch_pspec(plan: Plan, batch_size: int, mesh_shape: Dict[str, int],
                extra_dims: int = 0) -> P:
    """Sharding for [B, ...] inputs; replicates when B is too small."""
    axes = plan.batch_axes
    if axes is None:
        return P(*([None] * (1 + extra_dims)))
    ax_tuple = (axes,) if isinstance(axes, str) else tuple(axes)
    size = 1
    for a in ax_tuple:
        size *= mesh_shape[a]
    if batch_size % size:
        # fall back to the largest prefix of the axes that divides B
        keep = []
        size = 1
        for a in ax_tuple:
            if batch_size % (size * mesh_shape[a]) == 0:
                keep.append(a)
                size *= mesh_shape[a]
        ax_tuple = tuple(keep)
    spec = tuple(ax_tuple) if ax_tuple else None
    return P(spec, *([None] * extra_dims))


@dataclasses.dataclass(frozen=True)
class BatchPlacement:
    """Where the rows of a [B, ...] batch live under a plan: `axes` are
    the mesh axes that split them (``batch_pspec``'s: the plan's batch
    axes, or the largest prefix of them that divides B), `sizes` their
    extents, and `rows` the [start, stop) of each data group, one a
    row-major index along `axes`, equal and in order.  Positions that
    differ only along other axes hold the same group's rows."""
    axes: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rows: Tuple[Tuple[int, int], ...]

    def group(self, coord: Dict[str, int]) -> int:
        """The data group of a position's coordinates."""
        g = 0
        for a, n in zip(self.axes, self.sizes):
            g = g * n + coord[a]
        return g

    def position_rows(self, mesh: Mesh) -> List[Tuple[int, int]]:
        """Each position's rows, in mesh order."""
        from repro_torch.sharding.axes import mesh_coords
        return [self.rows[self.group(c)] for c in mesh_coords(mesh)]


def batch_placement(plan: Plan, batch_size: int,
                    mesh: Mesh) -> BatchPlacement:
    """The rows each position holds of a batch of `batch_size` rows,
    by ``batch_pspec``."""
    spec = batch_pspec(plan, batch_size, mesh.shape)[0]
    axes = () if spec is None else (
        (spec,) if isinstance(spec, str) else tuple(spec))
    sizes = tuple(mesh.shape[a] for a in axes)
    n = 1
    for k in sizes:
        n *= k
    return BatchPlacement(axes, sizes, tuple(shard_slices(batch_size, n)))


def input_pspecs(cfg, shape, plan: Plan, mesh: Mesh) -> Dict[str, P]:
    """PartitionSpec per input tensor of a cell (api.input_specs)."""
    from repro_torch.models import api
    mesh_shape = mesh.shape
    out = {}
    for name, sds in api.input_specs(cfg, shape).items():
        nd = len(sds.shape)
        out[name] = P() if nd == 0 else batch_pspec(
            plan, sds.shape[0], mesh_shape, extra_dims=nd - 1)
    return out


def cache_pspecs(cfg, shape, plan: Plan, mesh: Mesh):
    """PartitionSpecs for the decode cache tree (api.cache_specs).

    KV tensors [L, B, T, KH, hd]: batch over the plan's batch axes when
    it divides; heads over `model` when KH divides, otherwise the T dim
    takes `model`; tiny-batch (SP) cells also spread T over
    `kv_seq_axis`.  SSM states shard their channel/head dim over
    `model`."""
    from repro_torch.models import api
    mesh_shape = mesh.shape
    model_sz = mesh_shape.get("model", 1)
    B = shape.global_batch
    bspec = batch_pspec(plan, B, mesh_shape)[0]

    def div(dim: int, ax: Axis) -> bool:
        if ax is None:
            return False
        axs = (ax,) if isinstance(ax, str) else tuple(ax)
        total = 1
        for a in axs:
            total *= mesh_shape.get(a, 1)
        return dim % total == 0

    def kv_spec(L, Bd, T, KH, hd) -> P:
        b_ax = bspec if div(Bd, bspec) else None
        head_ax = "model" if KH % model_sz == 0 else None
        t_axes = []
        if head_ax is None and T % model_sz == 0:
            t_axes.append("model")
        if b_ax is None and plan.kv_seq_axis is not None \
                and div(T, plan.kv_seq_axis):
            t_axes.append(plan.kv_seq_axis)
        t_ax = tuple(t_axes) if len(t_axes) > 1 else \
            (t_axes[0] if t_axes else None)
        if t_ax is not None and not div(T, t_ax):
            t_ax = None
        return P(None, b_ax, t_ax, head_ax, None)

    def spec_for(leaf: str, dims) -> P:
        nd = len(dims)
        if leaf in ("k", "v", "xk", "xv") and nd == 5:
            return kv_spec(*dims)
        if leaf == "ssm" and nd == 4:             # [L, B, di, N]
            return P(None, bspec if div(dims[1], bspec) else None,
                     "model" if dims[2] % model_sz == 0 else None, None)
        if leaf == "ssm" and nd == 6:             # [NS, I, B, H, P, N]
            return P(None, None, bspec if div(dims[2], bspec) else None,
                     "model" if dims[3] % model_sz == 0 else None,
                     None, None)
        if leaf == "conv" and nd == 4:            # [L, B, W-1, C]
            return P(None, bspec if div(dims[1], bspec) else None, None,
                     "model" if dims[3] % model_sz == 0 else None)
        if leaf == "conv" and nd == 5:            # [NS, I, B, W-1, C]
            return P(None, None, bspec if div(dims[2], bspec) else None,
                     None, "model" if dims[4] % model_sz == 0 else None)
        return P(*([None] * nd))

    def walk(tree, key):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return spec_for(key, tuple(tree.shape))

    return walk(api.cache_specs(cfg, shape), "")
