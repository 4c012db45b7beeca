"""Decoder-only transformer LM (dense, moe, vlm): training and serving.

PyTorch counterpart of ``repro/models/transformer.py``: the dense
family, the moe family (its MLP is ``models/moe.moe_mlp``) and the vlm
backbone (the dense body, with ``prefix_embeds`` in place of the first
token rows).  Layer parameters keep the reference's stacked layout (every
leaf under "layers" has a leading [L] axis, so weights bridge across
unchanged); the reference's scan over layers becomes a Python loop over
layer slices.  The training forward runs each layer under the config's
remat policy (none | dots | full | full_save_attn) through
``torch.utils.checkpoint``; remat changes what is kept for the backward,
never the numbers.  The serving steps' KV cache (the paged pool, or
the contiguous layout with no block table) is updated in place;
``prefill`` runs a whole prompt into the contiguous cache through
``flash_attention``.  ``embed_tokens``, ``_remat``, ``lm_xent`` and the
stacked-layer helpers serve the ssm and hybrid families too.

Tensor-parallel serving (``mesh=``, the reference's ``mesh`` /
``mesh_axis``; dense and vlm): `params` and `cache` are then lists with
one tree per mesh position (models/convert.shard_params, `init_cache`
with ``mesh=``), and one process computes every shard where it lives.
Each layer's input is replicated (one copy per distinct physical
device); each shard projects its heads and MLP columns, writes and
reads its own pool at KH/tp heads through the paged kernels, and forms
the float32 partials of its groups of the out- and down-projections;
`xshard_sum` gathers every shard's partials in shard order on each
device and sums them with the tp=1 fixed tree.  The embedding and the
logits are split over the vocab (each shard looks up its rows and
computes its logit columns; the columns are concatenated on the mesh's
first position, where the sample head runs).

Sharded training (``sharded_loss_fn``; dense, moe and vlm, the
reference's training plans over a (pod,) data, model mesh; the ssm,
hybrid and encdec families build theirs from the same pieces:
`sharded_lm_loss`, `per_group`, `sharded_block`, `attn_residual`,
`mlp_residual`): `params` is a tree of ``Sharded`` leaves
(sharding/axes.py; models/convert.shard_params with the plan's param
rules).  The batch rows are split over the plan's batch axes into data
groups; within a group each `model` position projects its heads and
MLP columns, runs B9 at its heads and forms the float32 partials of
the out- and down-projections, which `xshard_sum` gathers in model
order and sums by the fixed tree, under autograd.  A moe layer routes
over every group's tokens at once (models/moe.sharded_moe_mlp: the
reference's global capacity, drops and aux loss) and each `model`
position runs its block of experts.  A dim that does not divide
`model` (or a plan that puts nothing there: dp, fsdp) leaves its block
whole, computed once by the group's first position.  A leaf on `data`
(FSDP) is gathered in mesh order when its layer runs, inside the remat
unit, so the backward regathers it and reduce-scatters the gradient
onto the owners.  The
embedding and the cross-entropy are vocab-parallel (each id's row and
label logit from the shard that owns it; the log-sum-exp combined in
shard order).  fsdp_tp_spact holds the residual stream between blocks
as S/model row slices.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import sampling
from repro_torch.models.common import (ParamSpec, apply_norm, apply_rope,
                                       chunked_softmax_xent, cross_entropy,
                                       mark, norm_spec, replicate,
                                       vocab_parallel_xent_sum, xshard_sum)
from repro_torch.sharding.axes import DATA_AXIS, MODEL_AXIS, Sharded

Params = Dict[str, Any]


# ----------------------------------------------------------------------
# specs
# ----------------------------------------------------------------------

# the families this module serves and trains (the reference's
# api._TRANSFORMER_FAMILIES)
FAMILIES = ("dense", "moe", "vlm")


def check_family(cfg, what: str = "this path") -> None:
    """Raise NotImplementedError, naming the family, unless `cfg` is of
    a transformer family (dense, moe, vlm): `what` (the paged cache,
    the serving engines, ...) serves those alone, as in the
    reference."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{what}: transformer families {FAMILIES} only for now, not "
            f"family {cfg.family!r}")


def layer_specs(cfg) -> Params:
    specs: Params = {
        "ln1": norm_spec(cfg, cfg.d_model),
        "ln2": norm_spec(cfg, cfg.d_model),
        "attn": attn.attn_specs(cfg),
    }
    if cfg.family == "moe":
        specs["moe"] = moe_mod.moe_specs(cfg)
    else:
        specs["mlp"] = mlp_mod.mlp_specs(cfg)
    return specs


def stack_specs(specs: Params, n: int, axis_name: str = "layers") -> Params:
    if isinstance(specs, ParamSpec):
        return ParamSpec((n,) + specs.shape, (axis_name,) + specs.axes,
                         init=specs.init, scale=specs.scale)
    return {k: stack_specs(v, n, axis_name) for k, v in specs.items()}


def transformer_specs(cfg) -> Params:
    specs: Params = {
        "embed": ParamSpec((cfg.padded_vocab_size, cfg.d_model),
                           ("vocab", "embed"), scale=0.02),
        "layers": stack_specs(layer_specs(cfg), cfg.num_layers),
        "final_norm": norm_spec(cfg, cfg.d_model),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((cfg.d_model, cfg.padded_vocab_size),
                                     ("embed", "vocab"))
    return specs


def layer_slice(tree: Params, i: int) -> Params:
    """Layer i's parameters: a view of every stacked leaf at index i."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: layer_slice(v, i) for k, v in tree.items()}


def layer_list(tree: Params, n: int) -> List[Params]:
    """The n layers' parameters, each leaf of the stack unbound once
    (so the backward stacks the n layer gradients in one op); a
    ``Sharded`` leaf unbinds each of its blocks."""
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    if isinstance(tree, Sharded):
        return tree.layers()
    parts = {k: layer_list(v, n) for k, v in tree.items()}
    return [{k: parts[k][i] for k in parts} for i in range(n)]


# ----------------------------------------------------------------------
# training: blocks, remat, forward, loss
# ----------------------------------------------------------------------

@torch.library.custom_op("repro_torch::checkpoint_name", mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """Identity (a copy) tagged with `name`, as the reference's
    ``jax.ad_checkpoint.checkpoint_name``: a selective-checkpoint
    policy can keep its output for the backward by this op."""
    return x.clone()


@checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


checkpoint_name.register_autograd(lambda ctx, g: (g, None))


def attn_block(cfg, p, x: torch.Tensor, positions: torch.Tensor
               ) -> torch.Tensor:
    q, k, v = attn.qkv_project(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attn.flash_attention(q, k, v, causal=True,
                             window=cfg.sliding_window)
    # tagged so remat="full_save_attn" keeps it instead of recomputing
    o = checkpoint_name(o, "attn_out")
    return attn.out_project(p, o)


def layer_fwd(cfg, p, x: torch.Tensor, positions: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm block. Returns (x, aux_loss)."""
    h = apply_norm(cfg, x, p["ln1"])
    x = x + attn_block(cfg, p["attn"], h, positions)
    h = apply_norm(cfg, x, p["ln2"])
    if cfg.family == "moe":
        y, aux = moe_mod.moe_mlp(cfg, p["moe"], h)
    else:
        y = mlp_mod.mlp(cfg, p["mlp"], h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


# the 2-D products a layer runs (projections, MLP): what "dots" keeps,
# as the reference's dots_with_no_batch_dims_saveable (the attention
# einsums have batch dims and are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_attn_out(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE
            if op is torch.ops.repro_torch.checkpoint_name.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg, fn):
    """none: keep everything; full: keep only the inputs; dots: keep the
    outputs of the layer's matrix products; full_save_attn: keep the
    attention output.  The rest is recomputed in the backward."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    policy = _save_attn_out if cfg.remat == "full_save_attn" else _save_dots
    return functools.partial(
        checkpoint, fn, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     policy))


def embed_tokens(cfg, params, tokens: torch.Tensor,
                 prefix_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """bf16 rows of the embedding (looked up, then cast: the values of
    casting first; the backward adds repeated tokens' gradients in
    float32, deterministically)."""
    x = F.embedding(tokens.long(), params["embed"]).to(torch.bfloat16)
    if prefix_embeds is not None:
        npfx = prefix_embeds.shape[1]
        x = torch.cat([prefix_embeds.to(x.dtype), x[:, npfx:]], dim=1)
    return x


def forward(cfg, params, tokens: torch.Tensor, *,
            prefix_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B,S] -> (final hidden [B,S,d] (pre-unembed), aux)."""
    check_family(cfg)
    B, S = tokens.shape
    x = embed_tokens(cfg, params, tokens, prefix_embeds)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    layer = _remat(cfg, functools.partial(layer_fwd, cfg))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in layer_list(params["layers"], cfg.num_layers):
        x, a = layer(lp, x, positions)
        aux = aux + a
    return apply_norm(cfg, x, params["final_norm"]), aux


def lm_xent(cfg, params, h: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of the final hidden h [B,S,d] against labels [B,S];
    big vocabs go through the chunked-CE loop (every family's loss)."""
    B, S, d = h.shape
    w = unembed_matrix(cfg, params).to(h.dtype)
    if cfg.vocab_size * S * B > 2 ** 28:       # big-vocab: chunk token dim
        return chunked_softmax_xent(h.reshape(B * S, d), w,
                                    labels.reshape(B * S))
    return cross_entropy(h @ w, labels)


def loss_fn(cfg, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Causal-LM loss plus ``aux_loss_weight`` times the moe aux loss."""
    h, aux = forward(cfg, params, batch["tokens"],
                     prefix_embeds=batch.get("prefix_embeds"))
    return lm_xent(cfg, params, h, batch["labels"]) \
        + cfg.aux_loss_weight * aux


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------

def unembed_matrix(cfg, params) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["unembed"]


def logits_fn(cfg, params, h: torch.Tensor) -> torch.Tensor:
    out = h @ unembed_matrix(cfg, params).to(h.dtype)
    # drop the TP-padding columns (never valid tokens)
    if cfg.padded_vocab_size != cfg.vocab_size:
        out = out[..., : cfg.vocab_size]
    return out


def serving_det_groups(cfg) -> Tuple[int, int]:
    """(attention, mlp) group counts of the grouped float32 reductions
    of the serving forward: the largest power of two <= 16 dividing the
    head count / hidden width, as in the reference."""
    def pow2_div(n: int, cap: int = 16) -> int:
        g = 1
        while g < cap and n % (g * 2) == 0:
            g *= 2
        return g
    return pow2_div(cfg.num_heads), pow2_div(cfg.d_ff)


def cache_kv_heads(cfg, tp: int) -> int:
    """KV heads of one mesh position's cache: KH / tp where tp divides
    KH, else all KH (replicated), as ServingPlan.cache_sharding."""
    KH = cfg.num_kv_heads
    return KH // tp if KH % tp == 0 else KH


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
               paged: bool = True, block_size: int = 16,
               num_blocks: Optional[int] = None, device=None,
               fp8_kv: bool = False, mesh=None):
    """Paged block pool [L, num_blocks, block_size, KH, hd] addressed
    through a per-slot block table or, with ``paged=False``, the
    contiguous cache {"k", "v"} [L, batch, max_len, KH, hd].  The
    default pool matches the contiguous capacity (batch *
    ceil(max_len / block_size) blocks).  ``fp8_kv`` (paged only) stores
    e4m3 codes + per-row float32 scales (attention.init_paged_kv_cache).
    With a 1-axis ``mesh`` (tensor-parallel serving) it returns one
    cache per mesh position, each on its position's device with its own
    dense pools of `cache_kv_heads` heads."""
    if mesh is not None:
        kv = cache_kv_heads(cfg, mesh.size)
        sub = dataclasses.replace(cfg, num_kv_heads=kv)
        return [init_cache(sub, batch, max_len, dtype, paged=paged,
                           block_size=block_size, num_blocks=num_blocks,
                           device=d, fp8_kv=fp8_kv)
                for d in mesh.positions]
    if not paged:
        if fp8_kv:
            raise NotImplementedError(
                "fp8_kv requires the paged cache layout")
        # the reference's serving cache carries no "length" leaf
        cache = attn.init_kv_cache(cfg, batch, max_len,
                                   layers=cfg.num_layers, dtype=dtype,
                                   device=device)
        del cache["length"]
        return cache
    if num_blocks is None:
        num_blocks = batch * -(-max_len // block_size)
    return attn.init_paged_kv_cache(num_blocks, block_size,
                                    cfg.num_kv_heads, cfg.head_dim,
                                    layers=cfg.num_layers, dtype=dtype,
                                    device=device, fp8=fp8_kv)


def _cache_attend(q, k1, v1, cl, pos, positions, block_table, *,
                  decode: bool, kernel: bool) -> torch.Tensor:
    """Write a window's k/v into one layer's cache slice `cl` (in place:
    contiguous {"k","v"} when `block_table` is None, else paged bf16
    {"k","v"} or fp8 {"k","v","k_scale","v_scale"}, detected by key)
    and attend over the result.  The contiguous layout reads through
    the plain attention, as in the reference; the kernels take a block
    table, so ``kernel=True`` without one raises.  ``kernel=True`` reads
    the pool through the CUDA block-table kernels; ``kernel=False``
    gathers the virtual view and runs the plain attention (the A/B
    oracle)."""
    if block_table is None:
        if kernel:
            raise ValueError("kernel=True reads the paged pool through "
                             "its block table: pass block_table")
        ck, cv = attn.update_cache(cl["k"], cl["v"], k1, v1, pos)
        if decode:
            return attn.decode_attention(q, ck, cv, pos + 1)
        return attn.chunk_attention(q, ck, cv, positions)
    if "k_scale" in cl:
        attn.update_paged_cache_fp8(cl, k1, v1, pos, block_table)
        scales = {"k_scale": cl["k_scale"], "v_scale": cl["v_scale"]}
    else:
        attn.update_paged_cache(cl["k"], cl["v"], k1, v1, pos, block_table)
        scales = {}
    if kernel:
        if decode:
            return attn.paged_decode_attention(q, cl["k"], cl["v"],
                                               block_table, pos + 1,
                                               **scales)
        return attn.paged_chunk_attention(q, cl["k"], cl["v"],
                                          block_table, pos, **scales)
    if scales:
        kg, vg = attn.gather_paged_cache_fp8(cl, block_table,
                                             out_dtype=q.dtype)
    else:
        kg, vg = attn.gather_paged_cache(cl["k"], cl["v"], block_table)
    if decode:
        return attn.decode_attention(q, kg, vg, pos + 1)
    return attn.chunk_attention(q, kg, vg, positions)


def _serving_scan(cfg, params, cache, x, pos, positions, block_table, *,
                  decode: bool, kernel: bool,
                  quant: Optional[Params] = None) -> torch.Tensor:
    """All layers over x [B, S, d] (each layer's pools updated in
    place), then the final norm.  ``quant`` (te/linear.
    quantize_serving_params output) routes the projections and the MLP
    through the pre-quantized fp8 weights (dense and vlm only).  The
    moe family's MLP is `moe_mlp` over the whole [B, S] window, padding
    rows included (they count in its capacity, as in the reference);
    its aux loss is dropped."""
    ga, gm = serving_det_groups(cfg)
    for i in range(cfg.num_layers):
        lp = layer_slice(params["layers"], i)
        qlp = None if quant is None else layer_slice(quant["layers"], i)
        cl = {k: leaf[i] for k, leaf in cache.items()}
        h = apply_norm(cfg, x, lp["ln1"])
        if qlp is None:
            q, k1, v1 = attn.qkv_project(cfg, lp["attn"], h)
        else:
            q, k1, v1 = attn.qkv_project_fp8(cfg, lp["attn"], qlp["attn"], h)
        q = apply_rope(q, positions, cfg.rope_theta)
        k1 = apply_rope(k1, positions, cfg.rope_theta)
        o = _cache_attend(q, k1, v1, cl, pos, positions, block_table,
                          decode=decode, kernel=kernel)
        if qlp is None:
            x = x + attn.out_project(lp["attn"], o, groups=ga)
        else:
            x = x + attn.out_project_fp8(lp["attn"], qlp["attn"], o)
        h = apply_norm(cfg, x, lp["ln2"])
        if cfg.family == "moe":
            x = x + moe_mod.moe_mlp(cfg, lp["moe"], h)[0]
        elif qlp is None:
            x = x + mlp_mod.mlp(cfg, lp["mlp"], h, groups=gm)
        else:
            x = x + mlp_mod.mlp_fp8(cfg, lp["mlp"], qlp["mlp"], h)
    h = apply_norm(cfg, x, params["final_norm"])
    # the serving forward's hook (the reference tags the same hidden
    # state with checkpoint_name): the analyzer's JX006 looks for it
    mark(h, "serving_hot_path")
    return h


def _tp_groups(cfg, tp: int) -> Tuple[int, int]:
    """The grouped reductions' group counts per shard (ga / tp, gm / tp);
    raises unless tp divides both (the tp=1 sums need whole groups)."""
    ga, gm = serving_det_groups(cfg)
    if ga % tp or gm % tp:
        raise ValueError(
            f"tp={tp} must divide the grouped reductions' groups "
            f"(attention {ga}, mlp {gm}) for the tp=1 sums")
    return ga // tp, gm // tp


def _by_device(mesh, shards: List[Params]) -> Dict[torch.device, Params]:
    """The first shard on each distinct physical device: where a
    replicated leaf (a norm scale, say) is read."""
    out: Dict[torch.device, Params] = {}
    for d, p in zip(mesh.positions, shards):
        out.setdefault(d, p)
    return out


def _tp_attend(cfg, lps, cache, i, hs, mesh, pos, positions,
               block_table, *, decode, kernel) -> List[torch.Tensor]:
    """Each shard's attention output [B, S, H/tp, hd] for layer i: its
    q/k/v heads, rope, and its own pool written and read (through the
    paged kernels at its KH/tp heads).  Where the pools hold all KH
    heads (KH % tp != 0, replicated as the reference's
    `_paged_kernel_call`), each shard attends with every shard's q and
    keeps its own heads."""
    devs = mesh.positions
    qs, kvs = [], []
    for r, d in enumerate(devs):
        q, k1, v1 = attn.qkv_project(cfg, lps[r]["attn"], hs[d])
        qs.append(apply_rope(q, positions[d], cfg.rope_theta))
        kvs.append((apply_rope(k1, positions[d], cfg.rope_theta), v1))
    kv_rep = len(devs) > 1 and kvs[0][0].shape[2] == cfg.num_kv_heads
    q_all = ({d: torch.cat([q.to(d) for q in qs], dim=2)
              for d in mesh.physical} if kv_rep else None)
    outs = []
    for r, d in enumerate(devs):
        cl = {k: leaf[i] for k, leaf in cache[r].items()}
        bt = None if block_table is None else block_table[d]
        q = q_all[d] if kv_rep else qs[r]
        o = _cache_attend(q, kvs[r][0], kvs[r][1], cl, pos[d], positions[d],
                          bt, decode=decode, kernel=kernel)
        if kv_rep:
            hq = qs[r].shape[2]
            o = o[:, :, r * hq:(r + 1) * hq].contiguous()
        outs.append(o)
    return outs


def _serving_scan_tp(cfg, params: List[Params], cache: List[Params], x,
                     pos, positions, block_table, mesh, *, decode: bool,
                     kernel: bool) -> Dict[torch.device, torch.Tensor]:
    """`_serving_scan` over a tensor-parallel mesh (module docstring):
    returns the final hidden state on each distinct physical device."""
    check_family(cfg, "tensor-parallel serving")
    if cfg.family == "moe":
        raise NotImplementedError(
            "tensor-parallel serving is dense/vlm-only, as in the reference")
    ga, gm = _tp_groups(cfg, mesh.size)
    phys = mesh.physical
    rep = _by_device(mesh, params)
    xs = replicate(x, phys)
    pos, positions = replicate(pos, phys), replicate(positions, phys)
    if block_table is not None:
        block_table = replicate(block_table, phys)
    layers = [p["layers"] for p in params]
    for i in range(cfg.num_layers):
        lps = [layer_slice(t, i) for t in layers]
        lrep = {d: layer_slice(p["layers"], i) for d, p in rep.items()}
        hs = {d: apply_norm(cfg, xs[d], lrep[d]["ln1"]) for d in phys}
        outs = _tp_attend(cfg, lps, cache, i, hs, mesh, pos, positions,
                          block_table, decode=decode, kernel=kernel)
        ys = xshard_sum([attn.out_project_parts(lp["attn"], o, ga)
                         for lp, o in zip(lps, outs)], phys,
                        tag="xshard_attn_out")
        xs = {d: xs[d] + ys[d].to(xs[d].dtype) for d in phys}
        hs = {d: apply_norm(cfg, xs[d], lrep[d]["ln2"]) for d in phys}
        ys = xshard_sum([mlp_mod.mlp_parts(cfg, lp["mlp"], hs[d], gm)
                         for lp, d in zip(lps, mesh.positions)], phys,
                        tag="xshard_mlp_down")
        for d in phys:
            y = ys[d].to(xs[d].dtype)
            if cfg.use_bias:
                y = y + lrep[d]["mlp"]["b_down"].to(y.dtype)
            xs[d] = xs[d] + y
    hs = {d: apply_norm(cfg, xs[d], rep[d]["final_norm"]) for d in phys}
    mark(hs[mesh.positions[0]], "serving_hot_path")
    return hs


def _vocab_split(cfg, params: List[Params]) -> bool:
    return params[0]["embed"].shape[0] != cfg.padded_vocab_size


def _embed_tp(cfg, params: List[Params], tokens: torch.Tensor, mesh
              ) -> torch.Tensor:
    """The embedding rows of `tokens` (on the mesh's first device) from
    the vocab-split tables: each shard looks up the ids in its range,
    and the rows are selected, not added, so they are the tp=1 rows."""
    if not _vocab_split(cfg, params):
        return _embed(params[0], tokens)
    first = mesh.positions[0]
    toks = replicate(tokens, mesh.physical)
    x = None
    for r, (d, p) in enumerate(zip(mesh.positions, params)):
        Vs = p["embed"].shape[0]
        local = toks[d].long() - r * Vs
        mine = ((local >= 0) & (local < Vs)).to(first)
        rows = p["embed"][local.clamp(0, Vs - 1)].to(first, torch.bfloat16)
        x = rows if x is None else torch.where(mine[..., None], rows, x)
    return x


def _logits_tp(cfg, params: List[Params], hs, mesh) -> torch.Tensor:
    """Each shard's vocab columns of the logits, concatenated in shard
    order on the mesh's first device, then the padding dropped."""
    first = mesh.positions[0]
    if not _vocab_split(cfg, params):
        return logits_fn(cfg, params[0], hs[first])
    out = torch.cat([(hs[d] @ unembed_matrix(cfg, p).to(hs[d].dtype))
                     .to(first) for d, p in zip(mesh.positions, params)],
                    dim=-1)
    if cfg.padded_vocab_size != cfg.vocab_size:
        out = out[..., : cfg.vocab_size]
    return out


def _check_mesh(mesh, mesh_axis, params, cache) -> None:
    if len(mesh.axis_names) != 1:
        raise ValueError(f"the serving mesh has one axis, not "
                         f"{mesh.axis_names}")
    if mesh_axis is not None and mesh_axis != mesh.axis_names[0]:
        raise ValueError(f"mesh_axis {mesh_axis!r} is not the mesh's axis "
                         f"{mesh.axis_names[0]!r}")
    if len(params) != mesh.size or len(cache) != mesh.size:
        raise ValueError(f"a mesh of {mesh.size} positions takes one "
                         f"param tree and one cache a position, got "
                         f"{len(params)} and {len(cache)}")


def _scan(cfg, params, cache, x, pos, positions, block_table, *, decode,
          kernel, quant, mesh, mesh_axis):
    """The serving scan on one device, or over the mesh's shards (the
    final hidden state on each physical device)."""
    if mesh is None:
        return _serving_scan(cfg, params, cache, x, pos, positions,
                             block_table, decode=decode, kernel=kernel,
                             quant=quant)
    if quant is not None:
        raise NotImplementedError(
            "fp8_linear serving is tp=1-only, as in the reference")
    _check_mesh(mesh, mesh_axis, params, cache)
    return _serving_scan_tp(cfg, params, cache, x, pos, positions,
                            block_table, mesh, decode=decode, kernel=kernel)


def _logits(cfg, params, h, mesh) -> torch.Tensor:
    return (logits_fn(cfg, params, h) if mesh is None
            else _logits_tp(cfg, params, h, mesh))


def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    """Serving activations are bf16 whatever the parameter dtype (the
    rows are cast after the lookup, the same values as casting first)."""
    return params["embed"][tokens.long()].to(torch.bfloat16)


def _per_slot_pos(pos, B: int, device) -> torch.Tensor:
    pos = torch.as_tensor(pos, device=device)
    return pos.to(torch.int32).expand(B)


def _embed_any(cfg, params, tokens, mesh) -> torch.Tensor:
    return (_embed(params, tokens) if mesh is None
            else _embed_tp(cfg, params, tokens, mesh))


def _each(h, fn):
    """fn over the hidden state: one tensor, or one a physical device."""
    return {d: fn(v) for d, v in h.items()} if isinstance(h, dict) else fn(h)


def decode_step(cfg, params, cache: Params, token: torch.Tensor, pos,
                block_table: Optional[torch.Tensor] = None, *,
                kernel: bool = False, quant: Optional[Params] = None,
                mesh=None, mesh_axis: Optional[str] = None
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step.  token [B]; pos scalar or [B] int32 (current
    length): each layer writes its k/v at `pos` (through the table, or
    into the contiguous cache when `block_table` is None) and attends
    to positions <= pos.  ``quant`` routes the linears through
    pre-quantized fp8 weights.  ``mesh`` serves tensor-parallel over
    per-position `params` / `cache` lists (module docstring).  Returns
    (logits [B, vocab], cache); the cache is the same pool, updated in
    place."""
    B = token.shape[0]
    pos = _per_slot_pos(pos, B, token.device)
    x = _embed_any(cfg, params, token, mesh)[:, None, :]  # [B,1,d]
    h = _scan(cfg, params, cache, x, pos, pos[:, None], block_table,
              decode=True, kernel=kernel, quant=quant, mesh=mesh,
              mesh_axis=mesh_axis)
    return _logits(cfg, params, h, mesh)[:, 0], cache


def _chunk_fwd(cfg, params, cache: Params, tokens: torch.Tensor,
               pos: torch.Tensor, block_table: Optional[torch.Tensor], *,
               kernel: bool, quant: Optional[Params], mesh=None,
               mesh_axis: Optional[str] = None):
    """Shared serving forward over a [B, C] token window written into
    the pool at [pos, pos+C): the body of both `chunk_step` (which reads
    out the last valid row) and `verify_step` (which reads out every
    row).  Returns the final hidden [B, C, d] (over a mesh, one a
    physical device)."""
    C = tokens.shape[1]
    x = _embed_any(cfg, params, tokens, mesh)             # [B,C,d]
    positions = pos[:, None] + torch.arange(C, dtype=torch.int32,
                                            device=tokens.device)[None, :]
    return _scan(cfg, params, cache, x, pos, positions, block_table,
                 decode=False, kernel=kernel, quant=quant, mesh=mesh,
                 mesh_axis=mesh_axis)


def chunk_step(cfg, params, cache: Params, tokens: torch.Tensor, pos,
               n_tokens: torch.Tensor,
               block_table: Optional[torch.Tensor] = None, *,
               kernel: bool = False, quant: Optional[Params] = None,
               mesh=None, mesh_axis: Optional[str] = None
               ) -> Tuple[torch.Tensor, Params]:
    """One chunked-prefill/decode step for a batch of server slots.

    tokens [B,C] int32 — per slot, the next `n_tokens[b]` tokens of its
    request (rows past n_tokens[b] are padding); pos [B] int32 — each
    slot's cache length; the chunk's k/v is written at [pos, pos+C)
    through the table (padding rows whose virtual block is unallocated
    are dropped) or, with no table, into the contiguous cache (padding
    rows land past the frontier, where the next write lands first).  Returns (logits [B, vocab] at each slot's last valid
    row, cache)."""
    B, C = tokens.shape
    pos = _per_slot_pos(pos, B, tokens.device)
    h = _chunk_fwd(cfg, params, cache, tokens, pos, block_table,
                   kernel=kernel, quant=quant, mesh=mesh, mesh_axis=mesh_axis)
    last = (n_tokens.long() - 1).clamp(0, C - 1)          # [B]

    def take(x):
        idx = last.to(x.device)[:, None, None].expand(B, 1, x.shape[-1])
        return torch.gather(x, 1, idx)

    return _logits(cfg, params, _each(h, take), mesh)[:, 0], cache


def verify_step(cfg, params, cache: Params, tokens: torch.Tensor, pos,
                block_table: Optional[torch.Tensor] = None, *,
                kernel: bool = False,
                quant: Optional[Params] = None, sample=None,
                mesh=None, mesh_axis: Optional[str] = None
                ) -> Tuple[torch.Tensor, Params]:
    """Speculative-decode verify: score a [B, C] window (row 0 = each
    slot's current token, rows 1..C-1 = draft tokens) in one call and
    return the next-token id at EVERY row.

    The `chunk_step` forward (the same k/v writes at [pos, pos+C), the
    same causal read, through the paged chunk kernel with
    ``kernel=True``), read out at every row.  Rows past the accepted
    frontier leave k/v beyond it, which no later read sees before the
    next window overwrites it; rows past the slot's allocated blocks
    are dropped at the write.

    ``sample=(temp, top_k, top_p, seed)`` (each ``[B]``) draws row j's
    token with the sample head (models/sampling.sample_tokens) keyed by
    ``(seed[b], pos[b] + 1 + j)``: the key the span loop uses for the
    same emitted position.  Greedy rows stay the argmax.
    ``sample=None`` is the argmax head.

    Returns (preds [B, C] int32, cache)."""
    B, C = tokens.shape
    pos = _per_slot_pos(pos, B, tokens.device)
    h = _chunk_fwd(cfg, params, cache, tokens, pos, block_table,
                   kernel=kernel, quant=quant, mesh=mesh, mesh_axis=mesh_axis)
    logits = _logits(cfg, params, h, mesh)                # [B,C,V]
    if sample is None:
        return torch.argmax(logits, dim=-1).to(torch.int32), cache
    temp, top_k, top_p, seed = sample
    index = pos[:, None] + 1 + torch.arange(C, dtype=torch.int32,
                                            device=tokens.device)[None, :]
    return sampling.sample_tokens(logits, temp, top_k, top_p, seed,
                                  index), cache


def prefill(cfg, params, tokens: torch.Tensor, cache: Params, *,
            prefix_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Run the full prompt, filling the contiguous cache {"k", "v"}
    [L, B, T, KH, hd] (``init_cache(..., paged=False)``) at positions
    [0, S) in place; attention over the prompt is flash_attention (B9
    on the card).  Returns (last-position logits [B, vocab], {"k",
    "v"})."""
    B, S = tokens.shape
    ck, cv = cache["k"], cache["v"]
    if "k_scale" in cache or ck.ndim != 5 or ck.shape[1] != B \
            or ck.shape[2] < S:
        raise ValueError(
            f"prefill fills a contiguous cache [L, {B}, >= {S}, KH, hd], "
            f"not {tuple(ck.shape)} (init_cache(..., paged=False))")
    x = embed_tokens(cfg, params, tokens, prefix_embeds)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    for i in range(cfg.num_layers):
        lp = layer_slice(params["layers"], i)
        h = apply_norm(cfg, x, lp["ln1"])
        q, k, v = attn.qkv_project(cfg, lp["attn"], h)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        ck[i, :, :S] = k.to(ck.dtype)
        cv[i, :, :S] = v.to(cv.dtype)
        o = attn.flash_attention(q, k, v, causal=True,
                                 window=cfg.sliding_window)
        x = x + attn.out_project(lp["attn"], o)
        h = apply_norm(cfg, x, lp["ln2"])
        if cfg.family == "moe":
            y, _ = moe_mod.moe_mlp(cfg, lp["moe"], h)
        else:
            y = mlp_mod.mlp(cfg, lp["mlp"], h)
        x = x + y
    x = apply_norm(cfg, x, params["final_norm"])
    return logits_fn(cfg, params, x[:, -1:])[:, 0], {"k": ck, "v": cv}


# ----------------------------------------------------------------------
# sharded training over a ("pod",) "data", "model" mesh
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Worker:
    """A mesh position that computes: its coordinates, device and index
    along `model` (0 on a mesh without that axis)."""
    coord: Dict[str, int]
    device: torch.device
    m: int


@dataclasses.dataclass
class _Group:
    """One data group: its batch rows, its workers in model order and
    their distinct devices (in order); `first` maps each of those
    devices to its first worker, where replicated leaves are read."""
    rows: Tuple[int, int]
    workers: List[_Worker]
    devices: List[torch.device]
    first: Dict[torch.device, _Worker]


def _groups(mesh, plan, batch_size: int) -> List[_Group]:
    """The data groups of a batch (sharding/plans.batch_placement): a
    position computes unless it differs from another only along an axis
    that neither splits the batch nor is `model` (then it would repeat
    that one's work: the reference replicates it, the port runs it
    once)."""
    from repro_torch.sharding.axes import mesh_coords
    from repro_torch.sharding.plans import batch_placement
    batch_axes = plan.batch_axes
    batch_axes = ((batch_axes,) if isinstance(batch_axes, str)
                  else tuple(batch_axes or ()))
    unknown = set(mesh.axis_names) - {"pod", DATA_AXIS, MODEL_AXIS}
    if unknown or not set(batch_axes) <= set(mesh.axis_names):
        raise ValueError(
            f"plan {plan.name!r} (batch axes {batch_axes}) does not fit the "
            f"mesh's axes {mesh.axis_names}: a training mesh has axes from "
            f"('pod', 'data', 'model')")
    place = batch_placement(plan, batch_size, mesh)
    busy = set(place.axes) | {MODEL_AXIS}
    groups = [_Group(r, [], [], {}) for r in place.rows]
    for c, d in zip(mesh_coords(mesh), mesh.positions):
        if any(c[a] for a in mesh.axis_names if a not in busy):
            continue
        g = groups[place.group(c)]
        w = _Worker(c, d, c.get(MODEL_AXIS, 0))
        g.workers.append(w)
        if d not in g.first:
            g.devices.append(d)
            g.first[d] = w
    return groups


class _Reader:
    """A worker's view of sharded leaves: its block along `model`, the
    dim split over `data` gathered in mesh order (Sharded.at), on its
    device.  Each (leaf, block, device) is gathered once a reader, so
    the data groups on one device share the gather; the gather's
    backward is the reduce-scatter of the gradient onto the owners."""

    def __init__(self):
        self.memo: Dict[Any, torch.Tensor] = {}

    def __call__(self, leaf, w: _Worker) -> torch.Tensor:
        from repro_torch.sharding.axes import block_index
        idx = block_index(leaf.axes, w.coord)
        dim = leaf.split(DATA_AXIS)
        if dim is not None:
            idx = idx[:dim] + (-1,) + idx[dim + 1:]
        key = (id(leaf), idx, w.device)
        if key not in self.memo:
            self.memo[key] = leaf.at(w.coord, w.device, gather=DATA_AXIS)
        return self.memo[key]

    def tree(self, tree, w: _Worker):
        return {k: self.tree(v, w) if isinstance(v, dict) else self(v, w)
                for k, v in tree.items()}

    def span(self, leaf, w: _Worker, dim: int, lo: int, hi: int
             ) -> torch.Tensor:
        """Elements [lo, hi) along `dim` of the worker's view, read from
        the `model` blocks that cover them (Sharded.span): a range that
        crosses block boundaries, or a whole dim `model` splits."""
        return leaf.span(w.coord, dim, lo, hi,
                         lambda c: self(leaf, dataclasses.replace(w, coord=c)),
                         gather=DATA_AXIS)

    def whole(self, tree, w: _Worker):
        """The worker's view of a tree with every `model` split undone
        (for a block computed once, on one position)."""
        if isinstance(tree, dict):
            return {k: self.whole(v, w) for k, v in tree.items()}
        dim = tree.split(MODEL_AXIS)
        return (self(tree, w) if dim is None
                else self.span(tree, w, dim, 0, tree.shape[dim]))


def _spact(cfg, plan, mesh, S: int) -> bool:
    """fsdp_tp_spact: the residual stream between blocks as S/model row
    slices, one a model position (when `model` divides S)."""
    M = mesh.shape.get(MODEL_AXIS, 1)
    return (plan.act_rules.get("seq") == MODEL_AXIS and M > 1
            and S % M == 0)


def _entry(g: _Group, x, spact: bool) -> Dict[torch.device, torch.Tensor]:
    """The whole residual on each of the group's devices: as held, or
    (spact) its row slices gathered in model order."""
    if not spact:
        return x
    return {d: torch.cat([s.to(d) for s in x], dim=1) for d in g.devices}


def _exit(g: _Group, xd: Dict[torch.device, torch.Tensor], spact: bool):
    """The residual as held between blocks: whole on each device, or
    (spact) each model position's own rows, a tensor of its own."""
    if not spact:
        return xd
    S = next(iter(xd.values())).shape[1]
    n = S // len(g.workers)
    return [xd[w.device][:, w.m * n:(w.m + 1) * n].clone(
        memory_format=torch.contiguous_format) for w in g.workers]


def norm(cfg, g: _Group, p, xd, read: _Reader):
    """A replicated norm over the group's residual, on each device."""
    return {d: apply_norm(cfg, xd[d], read.tree(p, g.first[d]))
            for d in g.devices}


def attn_residual(cfg, g: _Group, att, xd, h, read: _Reader, *,
                  rope: bool = True, causal: bool = True, kv=None):
    """xd plus the attention of the normed h (one a group device).
    Where `model` splits the heads each worker runs its heads
    (attention.shard_attention: B9 on the card) and forms the float32
    partial of the out-projection; `xshard_sum` gathers the partials in
    model order on each device and sums them by the fixed tree.
    Otherwise the group's first worker attends with every head once,
    as the one-device block does, and the result is copied to the
    others.  `rope`: q and k take RoPE at positions 0..S-1; `kv` (one a
    group device): cross-attention, k/v from it."""
    Bg, S = h[g.devices[0]].shape[:2]
    pos = ({d: torch.arange(S, device=d).expand(Bg, S) for d in g.devices}
           if rope else dict.fromkeys(g.devices))
    kv = kv or dict.fromkeys(g.devices)
    if att["wq"].split(MODEL_AXIS) is not None:
        hq = cfg.num_heads // att["wq"].parts(MODEL_AXIS)
        parts = []
        for w in g.workers:
            p = read.tree(att, w)
            d = w.device
            o = attn.shard_attention(cfg, p, h[d], pos[d],
                                     (w.m * hq, (w.m + 1) * hq),
                                     causal=causal, kv_x=kv[d])
            o = checkpoint_name(o, "attn_out")
            parts.append(attn.out_project_parts(p, o, 1))
        ys = xshard_sum(parts, g.devices, tag="xshard_attn_out")
        return {d: xd[d] + ys[d].to(xd[d].dtype) for d in g.devices}
    w = g.workers[0]
    d = w.device
    p = read.tree(att, w)
    o = attn.shard_attention(cfg, p, h[d], pos[d], (0, cfg.num_heads),
                             causal=causal, kv_x=kv[d])
    y = attn.out_project(p, checkpoint_name(o, "attn_out"))
    return {e: xd[e] + y.to(e) for e in g.devices}


def mlp_residual(cfg, g: _Group, mp, xd, h, read: _Reader):
    """xd plus the MLP of the normed h: each worker its columns (the
    float32 partials of the down-projection summed in model order; the
    down bias added once after the sum) where `model` splits them, else
    the whole MLP once on the first worker."""
    if mp["w_up"].split(MODEL_AXIS) is not None:
        ys = xshard_sum([mlp_mod.mlp_parts(cfg, read.tree(mp, w),
                                           h[w.device], 1)
                         for w in g.workers], g.devices,
                        tag="xshard_mlp_down")
        out = {}
        for d in g.devices:
            y = ys[d].to(xd[d].dtype)
            if cfg.use_bias:
                y = y + read(mp["b_down"], g.first[d]).to(y.dtype)
            out[d] = xd[d] + y
        return out
    w = g.workers[0]
    y = mlp_mod.mlp(cfg, read.tree(mp, w), h[w.device])
    return {d: xd[d] + y.to(d) for d in g.devices}


def attn_half(cfg, g: _Group, lp, xd, read: _Reader):
    """A pre-norm block's first half: xd plus the attention of its
    `ln1` norm."""
    return attn_residual(cfg, g, lp["attn"], xd,
                         norm(cfg, g, lp["ln1"], xd, read), read)


def sharded_block(cfg, g: _Group, lp, xd, read: _Reader):
    """One pre-norm attention + MLP block of one data group (dense and
    vlm layers; the hybrid family's shared block)."""
    xd = attn_half(cfg, g, lp, xd, read)
    return mlp_residual(cfg, g, lp["mlp"], xd,
                        norm(cfg, g, lp["ln2"], xd, read), read)


def per_group(block):
    """A unit of the sharded stack (`sharded_lm_loss`) from a block that
    runs on each data group alone: block(g, lp, xd, *extra, read) -> xd,
    where each of the unit's `extras` is a list of one entry a group
    (the decoder's encoder output)."""
    def unit(groups: List[_Group], spact: bool, lp, xs, *extras):
        read = _Reader()
        return [_exit(g, block(g, lp, _entry(g, x, spact), *extra, read),
                      spact)
                for g, x, *extra in zip(groups, xs, *extras)], None
    return unit


def _sharded_layer(cfg, groups: List[_Group], spact: bool, lp, xs):
    """One transformer layer over every data group, each group's block
    alone (`sharded_block`), except a moe layer's MLP, which runs over
    all the groups at once (moe.sharded_moe_mlp: global routing, as the
    reference's).  Returns (xs, the layer's aux loss or None)."""
    if cfg.family != "moe":
        return per_group(functools.partial(sharded_block, cfg))(
            groups, spact, lp, xs)
    read = _Reader()
    xds = [attn_half(cfg, g, lp, _entry(g, x, spact), read)
           for g, x in zip(groups, xs)]
    hs = [norm(cfg, g, lp["ln2"], xd, read) for g, xd in zip(groups, xds)]
    ys, aux = moe_mod.sharded_moe_mlp(cfg, lp["moe"], groups, hs, read,
                                      groups[0].devices[0])
    return [_exit(g, {d: xd[d] + y[d] for d in g.devices}, spact)
            for g, xd, y in zip(groups, xds, ys)], aux


def _sharded_embed(cfg, g: _Group, params, tokens, prefix, read: _Reader):
    """The group's embedding rows on each of its devices.  A vocab split
    over `model` is looked up shard by shard (ids outside a shard's
    range read a clamped row that is not selected) and each id's row is
    selected from its owner in model order, as `_embed_tp`; the lookup
    is `embed_tokens`, so the rows are the one-device rows."""
    E = params["embed"]
    toks = {d: tokens.to(d) for d in g.devices}
    pfx = {d: None if prefix is None else prefix.to(d) for d in g.devices}
    if E.split(MODEL_AXIS) is None:
        w = g.workers[0]
        x = embed_tokens(cfg, {"embed": read(E, w)}, toks[w.device],
                         pfx[w.device])
        return {d: x.to(d) for d in g.devices}
    Vs = E.shape[0] // E.parts(MODEL_AXIS)
    out: Dict[torch.device, torch.Tensor] = {}
    for w in g.workers:
        local = toks[w.device].long() - w.m * Vs
        mine = (local >= 0) & (local < Vs)
        rows = embed_tokens(cfg, {"embed": read(E, w)},
                            local.clamp(0, Vs - 1), pfx[w.device])
        for d in g.devices:
            r = rows.to(d)
            out[d] = r if d not in out else torch.where(
                mine.to(d)[..., None], r, out[d])
    return out


def _sharded_xent(cfg, g: _Group, params, h, labels, read: _Reader,
                  chunk: int) -> torch.Tensor:
    """The group's token-loss sum (common.vocab_parallel_xent_sum): the
    unembedding's vocab shards (the embedding's, transposed, when tied)
    on their workers, or the whole vocab on the first worker."""
    leaf = params["embed"] if cfg.tie_embeddings else params["unembed"]
    split = leaf.split(MODEL_AXIS) is not None
    shards = g.workers if split else g.workers[:1]
    ws = [read(leaf, w).T if cfg.tie_embeddings else read(leaf, w)
          for w in shards]
    Vs = ws[0].shape[-1]
    d = cfg.d_model
    return vocab_parallel_xent_sum(
        [h[w.device].reshape(-1, d) for w in shards], ws,
        [labels.reshape(-1).to(w.device) for w in shards],
        [w.m * Vs if split else 0 for w in shards], g.devices[0],
        chunk=chunk)


def sharded_lm_head(cfg, params, groups: List[_Group], xs, labels,
                    spact: bool, chunk: int, first: torch.device
                    ) -> torch.Tensor:
    """The final norm and the fixed-order sum of the groups' token-loss
    sums (vocab-parallel), on `first`."""
    read = _Reader()
    total = None
    for g, x in zip(groups, xs):
        xd = _entry(g, x, spact)
        lo, hi = g.rows
        part = _sharded_xent(cfg, g, params,
                             norm(cfg, g, params["final_norm"], xd, read),
                             labels[lo:hi], read, chunk).to(first)
        total = part if total is None else total + part
    return total


def sharded_lm_loss(cfg, params, batch: Dict[str, torch.Tensor], mesh,
                    plan, units) -> torch.Tensor:
    """A decoder-only LM's loss over a mesh: the sharded embedding, then
    each (unit, layer params) of `units` under the config's remat
    policy (unit(groups, spact, lp, xs) -> (xs, aux or None); see
    `per_group`), then the vocab-parallel cross-entropy: the mean of
    `loss_fn`'s cross-entropy, plus ``aux_loss_weight`` times the units'
    aux losses, on the mesh's first device."""
    tokens, labels = batch["tokens"], batch["labels"]
    prefix = batch.get("prefix_embeds")
    B, S = tokens.shape
    groups = _groups(mesh, plan, B)
    spact = _spact(cfg, plan, mesh, S)
    read = _Reader()
    xs = []
    for g in groups:
        lo, hi = g.rows
        xd = _sharded_embed(cfg, g, params, tokens[lo:hi],
                            None if prefix is None else prefix[lo:hi], read)
        xs.append(_exit(g, xd, spact))
    aux = None
    for unit, lp in units:
        xs, a = _remat(cfg, functools.partial(unit, groups, spact))(lp, xs)
        if a is not None:
            aux = a if aux is None else aux + a
    chunk = 8192 if cfg.vocab_size * S * B > 2 ** 28 else 0
    first = mesh.positions[0]
    loss = sharded_lm_head(cfg, params, groups, xs, labels, spact, chunk,
                           first) / (B * S)
    if aux is not None:
        loss = loss + cfg.aux_loss_weight * aux
    return loss


def sharded_loss_fn(cfg, params, batch: Dict[str, torch.Tensor], mesh,
                    plan) -> torch.Tensor:
    """`loss_fn` over a mesh: `params` is a tree of ``Sharded`` leaves
    (models/convert.shard_params with the plan's param rules); the batch
    rows are split over the plan's batch axes, `model` splits the heads,
    the MLP columns, the experts and the vocab (each where it divides),
    and a leaf split over `data` is gathered when its layer runs.  Each
    layer runs under the config's remat policy.  The loss is the
    fixed-order sum of the groups' token-loss sums over the global token
    count (the mean of `loss_fn`), plus ``aux_loss_weight`` times the
    moe layers' global aux losses, on the mesh's first device."""
    check_family(cfg, "the sharded transformer step")
    unit = functools.partial(_sharded_layer, cfg)
    return sharded_lm_loss(cfg, params, batch, mesh, plan,
                           [(unit, lp) for lp in layer_list(
                               params["layers"], cfg.num_layers)])
