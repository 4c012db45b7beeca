"""Analytic per-cell cost model: FLOPs / HBM bytes / collective bytes.

PyTorch counterpart of ``repro/core/analytic.py``, with its formulas and
constants unchanged (tests hold every field equal to the reference's on
every assigned cell).  It computes a step's cost from the same config
the model code is built from; the dry run (launch/dryrun.py) prints it
beside what a traced step counts (core/roofline.StepTrace).  The
parameter counts are the port's (models/api.param_shapes).  The seconds
follow the MeshSpec's chip: ``hw.TARGET`` (the H100) by default.

All quantities are per device.  Two FLOP numbers are reported:
  model_flops  — useful work (6*N_active*D convention + causal attn)
  impl_flops   — what the implementation executes (full-square masked
                 flash, MoE capacity padding, remat recompute)
useful_ratio = model/impl is the waste metric the assignment asks for.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import hw
from repro_torch.core.roofline import Roofline

BF16 = 2
FP32 = 4

# Coarse per-layer activation-traffic coefficient: reads+writes of the
# residual stream across the ops of one block (norm, proj in/out, act),
# in units of tokens*d_model*BF16.  Calibrated against unrolled HLO.
ACT_COEF = 16.0


@dataclasses.dataclass
class CellCost:
    name: str
    model_flops: float            # global useful
    impl_flops_dev: float
    hbm_bytes_dev: float
    coll_bytes_dev: Dict[str, float]          # by mesh axis
    coll_bytes_by_kind: Dict[str, float]      # by collective kind
    notes: str = ""

    def roofline(self, mesh_spec: hw.MeshSpec) -> Roofline:
        chip = mesh_spec.chip
        coll_s = 0.0
        for axis, byts in self.coll_bytes_dev.items():
            coll_s += byts / (mesh_spec.axis_bandwidth_gbps(axis) * 1e9)
        return Roofline(
            name=self.name,
            mesh_desc="x".join(str(s) for s in mesh_spec.shape),
            num_chips=mesh_spec.num_chips,
            flops_per_dev=self.impl_flops_dev,
            bytes_per_dev=self.hbm_bytes_dev,
            coll_bytes_per_dev={k: int(v) for k, v
                                in self.coll_bytes_by_kind.items()},
            compute_s=self.impl_flops_dev / chip.peak_for("bf16"),
            memory_s=self.hbm_bytes_dev / (chip.hbm_gbps * 1e9),
            collective_s=coll_s,
            model_flops_global=self.model_flops,
            hbm_bytes_per_dev={},
            chip=chip,
        )


def _axis_sizes(mesh_spec: hw.MeshSpec) -> Dict[str, int]:
    return dict(zip(mesh_spec.axis_names, mesh_spec.shape))


def _param_counts(cfg: ModelConfig) -> Tuple[float, float, float]:
    """(total, embed-ish, active) parameter counts."""
    from repro_torch.models import api
    from repro_torch.models.common import count_params
    total = float(count_params(api.param_shapes(cfg)))
    n_embed = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "encdec":
        n_embed = cfg.vocab_size * cfg.d_model
    active = float(api.active_param_count(cfg))
    return total, float(n_embed), active


def _attn_layers(cfg: ModelConfig) -> int:
    if cfg.family in ("dense", "moe", "vlm"):
        return cfg.num_layers
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.dec_layers   # self + cross
    return 0


def _remat_factor(cfg: ModelConfig) -> float:
    return {"none": 3.0, "dots": 3.33, "full": 4.0,
            "full_save_attn": 4.0}.get(cfg.remat, 3.33)


def analyze_cell(cfg: ModelConfig, shape: ShapeConfig,
                 mesh_spec: hw.MeshSpec, plan_name: str = "fsdp_tp",
                 *, causal_skip: bool = True, attn_block: int = 512,
                 ) -> CellCost:
    """`causal_skip`: the flash implementation executes only the
    lower-triangle block pairs (models/attention.py pair-scan);
    False models the paper-faithful full-rectangle masked flash."""
    ax = _axis_sizes(mesh_spec)
    tp = ax.get("model", 1)
    dp = ax.get("data", 1) * ax.get("pod", 1)
    n_total, n_embed, n_active = _param_counts(cfg)
    n_layers_p = n_total - n_embed                  # layer-resident params
    n_active_layers = n_active - n_embed
    H, hd = cfg.num_heads, cfg.head_dim
    d, V = cfg.d_model, cfg.vocab_size

    B = shape.global_batch
    S = (min(shape.seq_len, cfg.max_source_len)
         if cfg.family == "encdec" else shape.seq_len)
    dp_eff = min(dp, B) if B else 1
    B_dev = max(B // dp_eff, 1)
    train = shape.kind == "train"
    decode = shape.kind == "decode"

    if cfg.family == "encdec":
        tokens = B * (S + (cfg.max_target_len if train else 0))
    else:
        tokens = B * S
    tokens_dev = tokens / dp_eff
    if decode:
        tokens_dev = B_dev                          # one token per seq

    # ----- FLOPs -------------------------------------------------------
    # useful matmul work, 2*N_active per token (+ causal attention)
    seq_for_attn = S if not decode else 1
    kv_len = S if decode else S
    attn_pairs = (seq_for_attn * (kv_len + 1) / 2 if not decode
                  else kv_len)                       # causal avg / decode
    attn_model = 4.0 * B_dev * _attn_layers(cfg) * H * hd * attn_pairs
    fwd_model_dev = 2.0 * n_active * tokens_dev / tp + attn_model / tp
    # implementation: full rectangle (masked flash) or lower-triangle
    # block pairs (causal skip) at `attn_block` granularity
    if causal_skip and not decode:
        impl_pairs = seq_for_attn * (kv_len + attn_block) / 2
    else:
        impl_pairs = seq_for_attn * kv_len
    attn_impl = 4.0 * B_dev * _attn_layers(cfg) * H * hd * impl_pairs
    moe_pad = cfg.capacity_factor if cfg.family == "moe" else 1.0
    fwd_impl_dev = (2.0 * (n_active_layers * moe_pad + n_embed)
                    * tokens_dev / tp) + attn_impl / tp
    if cfg.family in ("ssm", "hybrid"):
        n_ssm_layers = (cfg.num_layers if cfg.family == "ssm"
                        else cfg.num_layers)
        scan_flops = 6.0 * tokens_dev * cfg.d_inner * cfg.ssm_state \
            * n_ssm_layers / tp
        fwd_impl_dev += scan_flops
        fwd_model_dev += scan_flops

    if train:
        mult = _remat_factor(cfg)
        impl = fwd_impl_dev * mult + 12.0 * n_total / (dp * tp)
        if cfg.remat == "full_save_attn":
            # full remat but the attention fwd is saved, not recomputed
            impl = fwd_impl_dev * 4.0 - attn_impl / tp \
                + 12.0 * n_total / (dp * tp)
        model_global = (6.0 * n_active * tokens
                        + 3.0 * attn_model * dp_eff)
    elif shape.kind == "prefill":
        impl = fwd_impl_dev
        model_global = 2.0 * n_active * tokens + attn_model * dp_eff
    else:
        impl = fwd_impl_dev
        model_global = 2.0 * n_active * B + attn_model * dp_eff

    # ----- HBM bytes ----------------------------------------------------
    w_bytes_dev = n_layers_p / tp * BF16
    emb_bytes_dev = n_embed / tp * BF16
    if train:
        # fwd read + dgrad read + wgrad write (+unembed), grads, optimizer
        weights = 3.0 * (w_bytes_dev + emb_bytes_dev)
        opt = n_total / (dp * tp) * (FP32 * 6 + BF16 * 2)
        act = ACT_COEF * tokens_dev * d * BF16 \
            * _n_blocks(cfg) / _n_blocks_unit(cfg)
        kv_traffic = 0.0
    else:
        weights = w_bytes_dev + emb_bytes_dev
        opt = 0.0
        act = (ACT_COEF / 2) * tokens_dev * d * BF16 \
            * _n_blocks(cfg) / _n_blocks_unit(cfg)
        kv_traffic = _kv_bytes_dev(cfg, shape, dp_eff, tp) if decode else \
            _kv_bytes_dev(cfg, shape, dp_eff, tp)   # prefill writes = reads
    hbm = weights + opt + act + kv_traffic

    # ----- collective bytes ---------------------------------------------
    coll_axis: Dict[str, float] = {}
    coll_kind: Dict[str, float] = {}

    def add(axis: str, kind: str, byts: float):
        if byts <= 0 or ax.get(axis, 1) <= 1:
            return
        n = ax[axis]
        eff = byts * (n - 1) / n
        coll_axis[axis] = coll_axis.get(axis, 0.0) + eff
        coll_kind[kind] = coll_kind.get(kind, 0.0) + eff

    data_n = ax.get("data", 1)
    if train:
        if "fsdp" in plan_name:
            # ZeRO-3: per-layer param all-gather (fwd + bwd re-gather)
            add("data", "all-gather", 2.0 * n_layers_p / tp * BF16)
            # grad reduce-scatter over data
            add("data", "reduce-scatter", (n_layers_p + n_embed) / tp * BF16)
        else:
            add("data", "all-reduce", 2.0 * (n_layers_p + n_embed) / tp * BF16)
        # pod axis: pure-DP gradient all-reduce (2x for ring AR)
        add("pod", "all-reduce", 2.0 * n_total / (data_n * tp) * BF16)
    if tp > 1:
        # TP: 2 all-reduces per block fwd (+2 bwd if train), ring AR = 2x
        n_ar = _n_blocks(cfg) * (4.0 if train else 2.0)
        add("model", "all-reduce", 2.0 * n_ar * tokens_dev * d * BF16)
        if cfg.family == "moe":
            a2a = 2.0 * tokens_dev * cfg.top_k * d * BF16 \
                * (2.0 if train else 1.0)
            add("model", "all-to-all", a2a)
    if decode and B < dp:
        # SP flash-decode: logsumexp combine per attn layer (tiny)
        add("data", "all-reduce", 3.0 * _attn_layers(cfg) * B_dev * H * hd
            * FP32)

    return CellCost(
        name=f"{cfg.name}/{shape.name}",
        model_flops=model_global,
        impl_flops_dev=impl,
        hbm_bytes_dev=hbm,
        coll_bytes_dev=coll_axis,
        coll_bytes_by_kind=coll_kind,
    )


def _n_blocks(cfg: ModelConfig) -> float:
    if cfg.family == "encdec":
        return cfg.enc_layers + 1.5 * cfg.dec_layers
    return float(cfg.num_layers)


def _n_blocks_unit(cfg: ModelConfig) -> float:
    return 1.0


def _kv_bytes_dev(cfg: ModelConfig, shape: ShapeConfig, dp_eff: int,
                  tp: int) -> float:
    if cfg.family == "ssm":
        st = cfg.num_layers * shape.global_batch * cfg.d_inner \
            * cfg.ssm_state * FP32
        return st / (dp_eff * tp)
    layers = (cfg.num_layers // cfg.attn_every if cfg.family == "hybrid"
              else cfg.dec_layers if cfg.family == "encdec"
              else cfg.num_layers)
    T = (min(shape.seq_len, cfg.max_target_len)
         if cfg.family == "encdec" else shape.seq_len)
    kv = 2.0 * layers * shape.global_batch * T * cfg.num_kv_heads \
        * cfg.head_dim * BF16
    if cfg.family == "hybrid":
        st = cfg.num_layers * shape.global_batch * (cfg.d_inner // cfg.ssm_head_dim) \
            * cfg.ssm_head_dim * cfg.ssm_state * FP32
        kv += st
    # KV shards over batch (dp) and heads (tp); tiny-batch SP shards seq
    shard = dp_eff * min(tp, max(cfg.num_kv_heads, 1))
    return kv / shard
