"""GQA serving attention over a paged KV pool or a contiguous cache.

PyTorch counterpart of the serving half of ``repro/models/attention.py``:
projections (bf16, or through pre-quantized fp8 weights), the plain
decode/chunk attention over a cache view, the contiguous cache (init,
in-place window write), and the paged block pool (init, gather,
in-place scatter, COW block copy) in bf16/float32 or as e4m3 codes
with per-row scales.  ``paged_decode_attention`` /
``paged_chunk_attention`` route through the hand-written CUDA kernels
of ``repro_torch/kernels/paged_attention.py``.

Paged layout: one shared pool [num_blocks, block_size, KH, hd] per
layer plus a per-slot table block_table [B, max_blocks] int32 mapping
logical block i (virtual positions [i*bs, (i+1)*bs)) to a physical
pool block; -1 marks an unallocated entry.  The fp8 layout adds
"k_scale"/"v_scale" [.., NB, bs, KH, 1] float32: one scale per token
row per kv head.

The training half: ``flash_attention``, the blockwise online-softmax
(flash) attention with GQA, as a ``torch.autograd.Function``.  Its
forward on the card is the hand-written CUDA kernel of
``repro_torch/kernels/flash_attention.py`` (it returns the output and
the log-sum-exp rows); on the CPU it is the plain port of the
reference's ``_attn_fwd`` in the reference's block and pair order.  Its
backward is the port of the reference's hand-written blockwise
backward ``_flash_bwd_rule`` in torch ops, on either device.
``shard_attention`` is one model position's attention in the sharded
training step: its q heads (and the kv heads they read), RoPE, and
``flash_attention`` at those heads alone (``shard_qkv``: its
projections, which sharded prefill also writes into the cache).
``decode_partial`` / ``combine_partials``: a decode step over a cache
whose positions are split into blocks, each block's normalized output
and log-sum-exp, combined in block order (sharded decode).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, apply_rope, fixed_tree_sum
from repro_torch.te import fp8 as te_fp8
from repro_torch.te import linear as te_linear

NEG_INF = -1e30


# ----------------------------------------------------------------------
# params + projections
# ----------------------------------------------------------------------

def attn_specs(cfg, d_model: Optional[int] = None) -> Dict[str, ParamSpec]:
    d = d_model or cfg.d_model
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs = {
        "wq": ParamSpec((d, H, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, KH, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, KH, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.use_bias:
        specs["bq"] = ParamSpec((H, hd), ("heads", "head_dim"), init="zeros")
        specs["bk"] = ParamSpec((KH, hd), ("kv_heads", "head_dim"),
                                init="zeros")
        specs["bv"] = ParamSpec((KH, hd), ("kv_heads", "head_dim"),
                                init="zeros")
    return specs


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one [*, d] @ [d, h*k] product."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).reshape(
        x.shape[:-1] + (h, k))


def qkv_project(cfg, p, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B,S,d] -> q [B,S,H,hd], k/v [B,S,KH,hd]."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.use_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return q, k, v


def qkv_project_fp8(cfg, p, q8, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fp8 serving variant of `qkv_project`: x through weights
    pre-quantized to e4m3 by te/linear.quantize_serving_params, with a
    fresh per-call activation scale.  Biases, if any, stay in the bf16
    params `p`."""
    q = te_linear.fp8_serving_dot(x, q8["wq"])
    k = te_linear.fp8_serving_dot(x, q8["wk"])
    v = te_linear.fp8_serving_dot(x, q8["wv"])
    if cfg.use_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return q, k, v


def _kv_slice(H: int, KH: int, lo: int, hi: int) -> Tuple[int, int, bool]:
    """The kv heads that q heads [lo, hi) read under GQA (q head h reads
    kv head h // (H / KH)): (first, stop, contiguous), where contiguous
    means the q heads read the kv heads [first, stop) as whole groups
    of theirs (or all of them read one kv head), so the slice attends
    as a GQA block of its own; otherwise each q head is paired with its
    kv head one by one."""
    G = H // KH
    first, stop = lo // G, (hi - 1) // G + 1
    n = hi - lo
    ok = (lo % G == 0 and n % G == 0) or stop - first == 1
    return first, stop, ok


def cross_kv(cfg, p, enc_out: torch.Tensor, dt: torch.dtype
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k/v of an encoder output through `p`'s wk / wv (and biases) cast
    to `dt`.  As JAX promotes a product of float32 `enc_out` with bf16
    weights, k/v come out in the wider of the two dtypes."""
    k = _proj(enc_out, p["wk"].to(dt))
    v = _proj(enc_out, p["wv"].to(dt))
    if cfg.use_bias:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return k, v


def shard_qkv(cfg, p, x: torch.Tensor, positions: Optional[torch.Tensor],
              q_heads: Tuple[int, int], *,
              kv_x: Optional[torch.Tensor] = None):
    """The projections of `shard_attention`: (q [B,S,hi-lo,hd], k, v
    [B,Sk,stop-first,hd] at the kv heads [first, stop) the q heads
    read, first, pair), q and k RoPE'd at `positions` (None: none);
    `pair` (or None) maps each q head to its kv head's index in k/v
    where the q heads do not read whole GQA groups."""
    lo, hi = q_heads
    H, KH = cfg.num_heads, cfg.num_kv_heads
    dt = x.dtype
    q = _proj(x, p["wq"])
    if cfg.use_bias:
        q = q + p["bq"].to(dt)
    kp = {k: p[k] for k in ("wk", "wv", "bk", "bv") if k in p}
    first = lo // (H // KH)
    pair = None
    if kp["wk"].shape[1] == KH and hi - lo < H:    # kv heads replicated
        first, stop, ok = _kv_slice(H, KH, lo, hi)
        kp = {k: v[:, first:stop] if k[0] == "w" else v[first:stop]
              for k, v in kp.items()}
        if not ok:
            pair = torch.arange(lo, hi, device=x.device) // (H // KH) - first
    if kv_x is None:
        k, v = _proj(x, kp["wk"]), _proj(x, kp["wv"])
        if cfg.use_bias:
            k = k + kp["bk"].to(dt)
            v = v + kp["bv"].to(dt)
    else:
        k, v = cross_kv(cfg, kp, kv_x, dt)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v, first, pair


def shard_attention(cfg, p, x: torch.Tensor,
                    positions: Optional[torch.Tensor],
                    q_heads: Tuple[int, int], *, causal: bool = True,
                    kv_x: Optional[torch.Tensor] = None,
                    kv_out: Optional[list] = None) -> torch.Tensor:
    """One model position's attention in the sharded training forward.

    x [B,S,d] is the whole (normed) layer input; `p` holds the
    position's q heads [lo, hi) = `q_heads` of wq (and bq) and either
    its own kv heads of wk / wv (kv heads split with the q heads) or all
    KH of them (the kv heads replicated over `model`: reduced
    internvl2-1b's 2 kv heads over 4 positions), of which it projects
    only those its q heads read.  With `positions` q and k take RoPE
    (None: no RoPE, whisper's learned positions).  With `kv_x` (an
    encoder output) it is cross-attention: k/v are `cross_kv` of it, the
    three meet in the promoted dtype (the reference's flash promotes
    inside) and no mask applies; the output comes back in x's dtype.
    B9 (`flash_attention`: the CUDA kernel on the card) attends the
    position's heads alone.  `kv_out` (a list) receives (k, v, first):
    the RoPE'd k/v of the kv heads [first, ...) the position projected
    (sharded prefill writes them into its cache).  Returns
    [B,S,hi-lo,hd]."""
    dt = x.dtype
    q, k, v, first, pair = shard_qkv(cfg, p, x, positions, q_heads,
                                     kv_x=kv_x)
    if kv_out is not None:
        kv_out.append((k, v, first))
    if pair is not None:                           # one kv head a q head
        k, v = k[:, :, pair], v[:, :, pair]
    if kv_x is None:
        return flash_attention(q, k, v, causal=causal,
                               window=cfg.sliding_window)
    ct = torch.promote_types(q.dtype, k.dtype)
    return flash_attention(q.to(ct), k.to(ct), v.to(ct),
                           causal=False).to(dt)


def out_project_fp8(p, q8, o: torch.Tensor) -> torch.Tensor:
    """fp8 serving variant of `out_project`: one fp8 product over the
    (head, head_dim) contraction, no grouped reduction."""
    return te_linear.fp8_serving_dot(o, q8["wo"], x_contract_ndim=2,
                                     w_contract_ndim=2)


def out_project_parts(p, o: torch.Tensor, groups: int) -> torch.Tensor:
    """The grouped partials of `out_project`: o [B,S,H,hd] (a shard's
    heads, contiguous) against its rows of wo as `groups` float32
    partials [groups, B, S, d] of the o.dtype operands."""
    wo = p["wo"].to(o.dtype)
    B, S, H, hd = o.shape
    og = o.reshape(B, S, groups, H // groups, hd).float()
    wg = wo.reshape(groups, H // groups, hd, wo.shape[-1]).float()
    return torch.einsum("bsghk,ghkd->gbsd", og, wg)


def out_project(p, o: torch.Tensor, *, groups: int = 0) -> torch.Tensor:
    """o [B,S,H,hd] -> [B,S,d] through wo.

    With ``groups > 1`` the head contraction is formed as `groups`
    float32 partials of the o.dtype operands (`out_project_parts`),
    reduced by ``fixed_tree_sum`` (the reference's order-deterministic
    grouped reduction, tagged ``xshard_attn_out``); ``groups=0`` is one
    product in o.dtype.
    """
    if groups > 1:
        parts = out_project_parts(p, o, groups)
        return fixed_tree_sum(parts, tag="xshard_attn_out").to(o.dtype)
    wo = p["wo"].to(o.dtype)
    B, S, H, hd = o.shape
    return o.reshape(B, S, H * hd) @ wo.reshape(H * hd, -1)


# ----------------------------------------------------------------------
# plain attention over a gathered cache view (the A/B oracle)
# ----------------------------------------------------------------------

def _masked_softmax_pv(s: torch.Tensor, valid: torch.Tensor,
                       vt: torch.Tensor, pv_dtype: torch.dtype,
                       t_axis: int) -> torch.Tensor:
    """The reference's `sdpa_rows` tail: mask to NEG_INF, float32
    softmax, p rounded to the pool dtype, float32 PV sum.  Masked
    positions contribute an exact 0 to PV even where the gathered V is
    not finite (a NaN-poisoned block behind a -1 entry), where the
    reference's 0 * NaN would leak."""
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True)
    pv = p.to(pv_dtype).float().unsqueeze(-1) * vt
    pv = torch.where(valid.unsqueeze(-1), pv, torch.zeros_like(pv))
    return pv.sum(dim=t_axis)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len) -> torch.Tensor:
    """One-step decode: q [B,1,H,hd] vs cache [B,T,KH,hd]; row b attends
    positions t < kv_len[b].  Scores and PV are explicit float32
    multiply + sum, as in the reference.  `kv_len` is a tensor (scalar
    or [B]) or a Python int (no copy to the device: the call can be
    captured into a CUDA graph)."""
    B, _, H, hd = q.shape
    T, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    qg = q.reshape(B, KH, G, hd).float()
    kt = k_cache.transpose(1, 2).float()              # [B,KH,T,hd]
    vt = v_cache.transpose(1, 2).float()
    s = (qg[:, :, :, None, :] * kt[:, :, None, :, :]).sum(-1) * hd ** -0.5
    if isinstance(kv_len, int):
        bound = kv_len
    else:
        kv_len = torch.as_tensor(kv_len, device=q.device)
        bound = kv_len.reshape(-1, 1, 1, 1) if kv_len.ndim == 1 else kv_len
    valid = torch.arange(T, device=q.device)[None, None, None, :] < bound
    o = _masked_softmax_pv(s, valid, vt[:, :, None, :, :], v_cache.dtype,
                           t_axis=3)                  # [B,KH,G,hd]
    return o.reshape(B, 1, H, hd).to(q.dtype)


def decode_partial(q: torch.Tensor, k_block: torch.Tensor,
                   v_block: torch.Tensor, t0: int, kv_len
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`decode_attention` over one block of the cache's positions
    [t0, t0 + Tb): (o [B,1,H,hd] float32, normalized over the block's
    valid keys t < kv_len, and its log-sum-exp [B,H] float32; a block
    with no valid key gives lse NEG_INF and weighs nothing in
    `combine_partials`).  The same float32 scores, masked softmax and
    rounding of p to the cache dtype as `decode_attention`."""
    B, _, H, hd = q.shape
    Tb, KH = k_block.shape[1], k_block.shape[2]
    G = H // KH
    qg = q.reshape(B, KH, G, hd).float()
    kt = k_block.transpose(1, 2).float()
    vt = v_block.transpose(1, 2).float()
    s = (qg[:, :, :, None, :] * kt[:, :, None, :, :]).sum(-1) * hd ** -0.5
    kv_len = torch.as_tensor(kv_len, device=q.device)
    bound = kv_len.reshape(-1, 1, 1, 1) if kv_len.ndim == 1 else kv_len
    valid = (t0 + torch.arange(Tb, device=q.device)
             )[None, None, None, :] < bound
    o = _masked_softmax_pv(s, valid, vt[:, :, None, :, :], v_block.dtype,
                           t_axis=3)                  # [B,KH,G,hd]
    sm = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = sm.amax(dim=-1)
    lse = m + torch.log(torch.exp(sm - m[..., None]).sum(-1))
    lse = torch.where(valid.any(-1), lse, torch.full_like(lse, NEG_INF))
    return o.reshape(B, 1, H, hd), lse.reshape(B, H)


def combine_partials(os: List[torch.Tensor], lses: List[torch.Tensor]
                     ) -> torch.Tensor:
    """Attention over a cache split along its positions, from each
    block's `decode_partial` (in block order): o = sum_j w_j o_j /
    sum_j w_j, w_j = exp(lse_j - max lse), in float32, each sum by the
    fixed tree (common.fixed_tree_sum): the result does not depend on
    the order the partials arrive in."""
    lse = torch.stack(lses)                           # [n,B,H]
    w = torch.exp(lse - lse.amax(dim=0, keepdim=True))
    num = fixed_tree_sum(w[:, :, None, :, None] * torch.stack(os))
    return num / fixed_tree_sum(w)[:, None, :, None]


def chunk_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor,
                    q_positions: torch.Tensor) -> torch.Tensor:
    """A C-row query chunk vs the cache: q [B,C,H,hd], cache
    [B,T,KH,hd], q_positions [B,C]; row i attends t <= q_positions[b,i]
    (the chunk's own k/v must already be written).  Rows past a slot's
    valid count give garbage rows the caller discards."""
    B, C, H, hd = q.shape
    T, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    qc = q.reshape(B, C, KH, G, hd).permute(0, 2, 3, 1, 4).float()
    kt = k_cache.transpose(1, 2).float()              # [B,KH,T,hd]
    vt = v_cache.transpose(1, 2).float()
    s = (qc[:, :, :, :, None, :]
         * kt[:, :, None, None, :, :]).sum(-1) * hd ** -0.5  # [B,KH,G,C,T]
    mask = (torch.arange(T, device=q.device)[None, None, :]
            <= q_positions[:, :, None])                      # [B,C,T]
    o = _masked_softmax_pv(s, mask[:, None, None], vt[:, :, None, None],
                           v_cache.dtype, t_axis=4)          # [B,KH,G,C,hd]
    return o.permute(0, 3, 1, 2, 4).reshape(B, C, H, hd).to(q.dtype)


# ----------------------------------------------------------------------
# contiguous KV cache: one [T, KH, hd] region per slot
# ----------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, max_len: int, *, layers: int,
                  dtype=torch.bfloat16, device=None
                  ) -> Dict[str, torch.Tensor]:
    """Stacked contiguous cache {"k", "v"}: [layers, batch, max_len, KH,
    hd] zeros, plus the reference's scalar int32 "length" leaf."""
    shape = (layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "length": torch.zeros((), dtype=torch.int32, device=device)}


def update_cache(cache_k: torch.Tensor, cache_v: torch.Tensor,
                 k1: torch.Tensor, v1: torch.Tensor, pos
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write a step's k/v ([B, C, KH, hd], C=1 for decode or a whole
    chunk) at `pos` into [B, T, KH, hd], in place (the reference returns
    new arrays; the port updates the cache where the reference donates
    it).  Returns the two caches.

    `pos` is a scalar (lockstep decode) or a per-slot [B] vector.  As
    ``lax.dynamic_update_slice`` does, a start past T - C is clamped to
    T - C (and a negative one to 0), so an out-of-range window shifts
    onto the tail of the cache: servers allocate T = max_len + chunk so
    that theirs never do.  The clamp runs on the device (no host read),
    so the write can be captured into a CUDA graph."""
    B, C = k1.shape[:2]
    T = cache_k.shape[1]
    pos = torch.as_tensor(pos, device=cache_k.device)
    start = pos.to(torch.int64).expand(B).clamp(0, max(T - C, 0))
    rows = start[:, None] + torch.arange(C, device=cache_k.device)[None, :]
    idx = rows.reshape(B, C, 1, 1).expand(k1.shape)
    cache_k.scatter_(1, idx, k1.to(cache_k.dtype))
    cache_v.scatter_(1, idx, v1.to(cache_v.dtype))
    return cache_k, cache_v


# ----------------------------------------------------------------------
# flash attention (training): blockwise forward + hand-written backward
# ----------------------------------------------------------------------

def _chunk_arrays(q, k, v, qc, kc):
    """Pad + reshape to chunked layouts; returns geometry too."""
    B, Sq, H, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    pad_q = (-Sq) % qc
    pad_k = (-Sk) % kc
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    nq, nk = (Sq + pad_q) // qc, (Sk + pad_k) // kc
    qs = q.reshape(B, nq, qc, KH, G, hd).permute(1, 0, 2, 3, 4, 5)
    ks = k.reshape(B, nk, kc, KH, hd).permute(1, 0, 2, 3, 4)
    vs = v.reshape(B, nk, kc, KH, hd).permute(1, 0, 2, 3, 4)
    return qs, ks, vs, (B, Sq, Sk, H, KH, G, hd, nq, nk)


def _block_mask(qp, kp, kval, causal, window):
    mask = kval[None, :]
    if causal:
        mask = mask & (kp[None, :] <= qp[:, None])
    if window:
        mask = mask & (kp[None, :] > qp[:, None] - window)
    return mask                                   # [qc, kc]


def _causal_pairs(nq, nk, qc, kc, q_offset):
    """Lower-triangle (i, j) block-pair list: block j is needed by block
    i iff its first key position can be attended by i's last query.
    Ordered i-major so the online-softmax state streams per q-block."""
    pairs = []
    for i in range(nq):
        q_max = q_offset + (i + 1) * qc - 1
        for j in range(nk):
            if j * kc <= q_max:
                pairs.append((i, j))
    return pairs


def _positions(nq, nk, qc, kc, Sk, q_offset, device):
    q_pos = q_offset + torch.arange(nq * qc, device=device).reshape(nq, qc)
    k_pos = torch.arange(nk * kc, device=device).reshape(nk, kc)
    k_valid = (torch.arange(nk * kc, device=device) < Sk).reshape(nk, kc)
    return q_pos, k_pos, k_valid


def _scores(qb, kb, scale):
    """s [B,KH,G,qc,kc]: float32 q.k of the (q-block, kv-block) pair,
    times scale after the sum (preferred_element_type=float32)."""
    return torch.einsum("bqkgd,btkd->bkgqt", qb.float(), kb.float()) * scale


def _online_step(m, l, acc, qb, kb, vb, mask, scale):
    """One (q-block, kv-block) step of the online softmax: masked
    scores are NEG_INF, p = exp(s - m_new) is rounded to v's dtype
    before the float32 PV product."""
    s = _scores(qb, kb, scale)
    s = torch.where(mask[None, None, None], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bkgqt,btkd->bqkgd", p.to(vb.dtype).float(),
                      vb.float())
    acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
    return m_new, l, acc


def _attn_fwd(q, k, v, causal, window, qc, kc, q_offset):
    """Blockwise online-softmax forward, the plain version of the
    kernel.  Returns (out [B,Sq,H,hd] in q.dtype, lse [nq,B,KH,G,qc]):
    the lse rows the backward reads, in the reference's chunked layout.
    Causal cells without a window walk only the lower-triangle block
    pairs, i-major, as the reference's pair scan does."""
    qs, ks, vs, (B, Sq, Sk, H, KH, G, hd, nq, nk) = \
        _chunk_arrays(q, k, v, qc, kc)
    scale = hd ** -0.5
    q_pos, k_pos, k_valid = _positions(nq, nk, qc, kc, Sk, q_offset,
                                       q.device)
    if causal and not window and nq > 1:
        pairs = _causal_pairs(nq, nk, qc, kc, q_offset)
    else:
        pairs = [(i, j) for i in range(nq) for j in range(nk)]
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.zeros((nq, B, qc, KH, G, hd), **f32)
    lse = torch.full((nq, B, KH, G, qc), NEG_INF, **f32)
    for t, (i, j) in enumerate(pairs):
        if t == 0 or pairs[t - 1][0] != i:          # a q-block's first pair
            m = torch.full((B, KH, G, qc), NEG_INF, **f32)
            l = torch.zeros((B, KH, G, qc), **f32)
            acc = torch.zeros((B, qc, KH, G, hd), **f32)
        mask = _block_mask(q_pos[i], k_pos[j], k_valid[j], causal, window)
        m, l, acc = _online_step(m, l, acc, qs[i], ks[j], vs[j], mask, scale)
        if t + 1 == len(pairs) or pairs[t + 1][0] != i:   # its last pair
            lse[i] = m + torch.log(torch.clamp(l, min=1e-30))
            out[i] = acc / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[
                ..., None]
    out = out.permute(1, 0, 2, 3, 4, 5).reshape(B, nq * qc, H, hd)
    return out[:, :Sq].to(q.dtype), lse


def lse_rows(lse: torch.Tensor, Sq: int) -> torch.Tensor:
    """The chunked lse [nq,B,KH,G,qc] as rows [B,H,Sq] (the kernel's)."""
    nq, B, KH, G, qc = lse.shape
    return lse.permute(1, 2, 3, 0, 4).reshape(B, KH * G, nq * qc)[..., :Sq]


def lse_chunks(rows: torch.Tensor, KH: int, qc: int) -> torch.Tensor:
    """lse rows [B,H,Sq] in the chunked layout [nq,B,KH,G,qc]; the
    padded rows past Sq get 0, a finite value whose backward
    contributions are exact zeros (their dout and D are 0)."""
    B, H, Sq = rows.shape
    nq = -(-Sq // qc)
    x = F.pad(rows.reshape(B, KH, H // KH, Sq), (0, nq * qc - Sq))
    return x.reshape(B, KH, H // KH, nq, qc).permute(3, 0, 1, 2, 4)


def _flash_bwd(q, k, v, out, lse, g, causal, window, qc, kc, q_offset):
    """Hand-written blockwise backward (the reference's
    `_flash_bwd_rule`): recomputes each (q-block, kv-block) probability
    tile from (q, k, lse) and accumulates dq/dk/dv in float32, j-major;
    causal cells without a window iterate only the lower-triangle
    block pairs."""
    in_dtype = q.dtype
    qs, ks, vs, (B, Sq, Sk, H, KH, G, hd, nq, nk) = \
        _chunk_arrays(q, k, v, qc, kc)
    gs = _chunk_arrays(g.float(), k, v, qc, kc)[0]
    scale = hd ** -0.5
    # D = rowsum(dout * out), per query row
    D = torch.sum(g.float() * out.float(), dim=-1)
    D = F.pad(D, (0, 0, 0, nq * qc - Sq))
    Ds = D.reshape(B, nq, qc, KH, G).permute(1, 0, 3, 4, 2)  # [nq,B,KH,G,qc]
    q_pos, k_pos, k_valid = _positions(nq, nk, qc, kc, Sk, q_offset,
                                       q.device)
    if causal and not window and nq > 1:
        pairs = [(i, j) for j in range(nk) for i in range(nq)
                 if j * kc <= q_offset + (i + 1) * qc - 1]
    else:
        pairs = [(i, j) for j in range(nk) for i in range(nq)]
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.zeros((nq, B, qc, KH, G, hd), **f32)
    dks = torch.zeros((nk, B, kc, KH, hd), **f32)
    dvs = torch.zeros((nk, B, kc, KH, hd), **f32)
    for t, (i, j) in enumerate(pairs):
        if t == 0 or pairs[t - 1][1] != j:          # a kv-block's first pair
            dk_j = torch.zeros((B, kc, KH, hd), **f32)
            dv_j = torch.zeros((B, kc, KH, hd), **f32)
        qb, gb, lseb, Db = qs[i], gs[i], lse[i], Ds[i]
        kb, vb = ks[j], vs[j]
        s = _scores(qb, kb, scale)
        mask = _block_mask(q_pos[i], k_pos[j], k_valid[j], causal, window)
        p = torch.where(mask[None, None, None],
                        torch.exp(s - lseb[..., None]), 0.0)
        dv_j = dv_j + torch.einsum("bkgqt,bqkgd->btkd", p, gb)
        dp = torch.einsum("bqkgd,btkd->bkgqt", gb, vb.float())
        ds = p * (dp - Db[..., None]) * scale
        dk_j = dk_j + torch.einsum("bkgqt,bqkgd->btkd", ds, qb.float())
        dq[i] = dq[i] + torch.einsum("bkgqt,btkd->bqkgd", ds, kb.float())
        if t + 1 == len(pairs) or pairs[t + 1][1] != j:   # its last pair
            dks[j], dvs[j] = dk_j, dv_j
    dq = dq.permute(1, 0, 2, 3, 4, 5).reshape(B, nq * qc, H, hd)[:, :Sq]
    dk = dks.permute(1, 0, 2, 3, 4).reshape(B, nk * kc, KH, hd)[:, :Sk]
    dv = dvs.permute(1, 0, 2, 3, 4).reshape(B, nk * kc, KH, hd)[:, :Sk]
    return dq.to(in_dtype), dk.to(in_dtype), dv.to(in_dtype)


class _Flash(torch.autograd.Function):
    """out = flash(q, k, v); saves (q, k, v, out, lse) for the backward.
    The forward is the CUDA kernel for CUDA tensors and its plain
    version (`_attn_fwd`) for CPU tensors, both through
    kernels/flash_attention.flash_attention_fwd; there is no fallback
    from the card to the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, qc, kc, q_offset):
        from repro_torch.kernels import flash_attention as kfa
        out, rows = kfa.flash_attention_fwd(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            q_chunk=qc, kv_chunk=kc)
        lse = lse_chunks(rows, k.shape[2], qc)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, qc, kc, q_offset)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, g, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_chunk: int = 512, kv_chunk: int = 512,
                    q_offset: int = 0) -> torch.Tensor:
    """Blockwise online-softmax attention with GQA + flash backward.

    q: [B,Sq,H,hd]; k,v: [B,Sk,KH,hd]; H % KH == 0.  `q_offset` is the
    absolute position of q[0].  Returns [B,Sq,H,hd] in q.dtype; softmax
    in fp32.  `q_chunk`/`kv_chunk` are the blocks of the plain forward
    and of the backward (the kernel tiles on its own).
    """
    qc = min(q_chunk, q.shape[1])
    kc = min(kv_chunk, k.shape[1])
    return _Flash.apply(q, k, v, causal, window, qc, kc, q_offset)


def attention_flops(B: int, Sq: int, Sk: int, H: int, hd: int,
                    causal: bool) -> float:
    """Useful FLOPs of the score+value matmuls (for MODEL_FLOPS)."""
    pairs = Sq * Sk if not causal else Sq * Sk - Sq * (Sq - 1) / 2 \
        if Sq == Sk else Sq * Sk
    return 2 * 2 * B * H * pairs * hd


def attention_reference(q, k, v, *, causal=True, window=0, q_offset=0):
    """Naive O(S^2)-memory oracle for tests (small shapes only)."""
    B, Sq, H, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    qg = q.reshape(B, Sq, KH, G, hd)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg.float(),
                     k.float()) * hd ** -0.5
    qp = q_offset + torch.arange(Sq, device=q.device)
    kp = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp[None, :] <= qp[:, None]
    if window:
        mask &= kp[None, :] > qp[:, None] - window
    s = torch.where(mask[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


# ----------------------------------------------------------------------
# paged KV cache: block pool + per-slot block tables
# ----------------------------------------------------------------------

def init_paged_kv_cache(num_blocks: int, block_size: int, kv_heads: int,
                        head_dim: int, *, layers: int,
                        dtype=torch.bfloat16, device=None,
                        fp8: bool = False) -> Dict[str, torch.Tensor]:
    """Stacked block pool {"k", "v"}: [L, NB, bs, KH, hd] zeros.  With
    ``fp8=True`` the pools hold e4m3 codes and "k_scale"/"v_scale"
    [L, NB, bs, KH, 1] float32 ones hold one scale per token row per kv
    head (te/fp8.quantize_rowwise at row = pool row)."""
    shape = (layers, num_blocks, block_size, kv_heads, head_dim)
    if not fp8:
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    sshape = shape[:-1] + (1,)
    return {"k": torch.zeros(shape, dtype=te_fp8.E4M3, device=device),
            "v": torch.zeros(shape, dtype=te_fp8.E4M3, device=device),
            "k_scale": torch.ones(sshape, dtype=torch.float32,
                                  device=device),
            "v_scale": torch.ones(sshape, dtype=torch.float32,
                                  device=device)}


def gather_paged_cache(ck: torch.Tensor, cv: torch.Tensor,
                       block_table: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each slot's virtual view [B, MB*bs, KH, hd] through its table.
    -1 entries are clamped to block 0 (as ``maximum(bt, 0)``); the
    position masks of the attention functions exclude those positions."""
    bt = block_table.long().clamp(min=0)
    NB, bs, KH, hd = ck.shape
    B, MB = bt.shape
    return (ck[bt].reshape(B, MB * bs, KH, hd),
            cv[bt].reshape(B, MB * bs, KH, hd))


def gather_paged_cache_fp8(cache_layer: Dict[str, torch.Tensor],
                           block_table: torch.Tensor,
                           out_dtype=torch.bfloat16
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each slot's virtual view, dequantized, from an fp8 single-layer
    cache {"k", "v", "k_scale", "v_scale"}: elementwise
    ``(codes.float() * scale).to(out_dtype)``, the op the fp8 kernels
    apply in-tile.  Same -1 clamp contract as `gather_paged_cache`.
    The codes are indexed through a uint8 view of the same bytes."""
    bt = block_table.long().clamp(min=0)
    NB, bs, KH, hd = cache_layer["k"].shape
    B, MB = bt.shape

    def dq(pool, scale):
        codes = pool.view(torch.uint8)[bt].view(pool.dtype)
        x = (codes.float() * scale[bt]).to(out_dtype)
        return x.reshape(B, MB * bs, KH, hd)

    return (dq(cache_layer["k"], cache_layer["k_scale"]),
            dq(cache_layer["v"], cache_layer["v_scale"]))


def paged_flat_idx(pos, block_table: torch.Tensor, C: int,
                   block_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flattened-pool row index [B, C] of a C-row write at `pos` through
    the table, and whether each row lands (``_paged_flat_idx``): a row
    whose virtual block is unallocated (-1) or past the table is
    dropped, never clamped."""
    B, MB = block_table.shape
    pos = torch.as_tensor(pos, dtype=torch.int64, device=block_table.device)
    if pos.ndim == 0:                     # lockstep decode: same frontier
        pos = pos.expand(B)
    vpos = pos.long()[:, None] + torch.arange(C, device=pos.device)[None, :]
    blk = vpos // block_size
    phys = torch.gather(block_table.long(), 1, blk.clamp(0, MB - 1))
    valid = (blk < MB) & (phys >= 0)
    return phys * block_size + vpos % block_size, valid


def _paged_scatter(pool: torch.Tensor, flat_idx: torch.Tensor,
                   valid: torch.Tensor, rows: torch.Tensor) -> None:
    """Write rows [N, ...] into pool [NB, bs, ...] at the flat row
    indices [N] where `valid`, in place, dropping the rest.

    The drop takes no host sync (a boolean-mask select would): every
    dropped row is redirected onto the first landing row of the call
    and carries that row's value, so the duplicate writes all store
    the same bytes.  When no row lands, the dropped rows rewrite row 0
    with its own current value.
    """
    flat = pool.view((-1,) + pool.shape[2:])
    # index_select with a [1] tensor: indexing by a 0-dim tensor would
    # read it back to the host
    first = torch.argmax(valid.to(torch.int32)).reshape(1)
    any_valid = valid.any()
    first_idx = flat_idx.index_select(0, first)
    tgt = torch.where(valid, flat_idx,
                      torch.where(any_valid, first_idx,
                                  torch.zeros_like(first_idx)))
    keep = torch.where(any_valid, rows.index_select(0, first), flat[:1])
    vmask = valid.reshape((-1,) + (1,) * (rows.ndim - 1))
    flat.index_copy_(0, tgt, torch.where(vmask, rows, keep))


def update_paged_cache(ck: torch.Tensor, cv: torch.Tensor,
                       k1: torch.Tensor, v1: torch.Tensor, pos,
                       block_table: torch.Tensor) -> None:
    """Scatter a step's k/v ([B, C, KH, hd]) through the block table
    into one layer's pools, in place (the reference returns new pools;
    the port updates the pool where the reference donates it).

    Row i of slot b lands at virtual position pos[b] + i, i.e. physical
    row block_table[b, p // bs] * bs + p % bs; rows whose virtual block
    is unallocated or past the table are dropped."""
    NB, bs, KH, hd = ck.shape
    B, C = k1.shape[:2]
    idx, valid = paged_flat_idx(pos, block_table, C, bs)
    idx, valid = idx.reshape(-1), valid.reshape(-1)
    _paged_scatter(ck, idx, valid, k1.reshape(B * C, KH, hd).to(ck.dtype))
    _paged_scatter(cv, idx, valid, v1.reshape(B * C, KH, hd).to(cv.dtype))


def update_paged_cache_fp8(cache_layer: Dict[str, torch.Tensor],
                           k1: torch.Tensor, v1: torch.Tensor, pos,
                           block_table: torch.Tensor) -> None:
    """fp8 variant of `update_paged_cache` on a single-layer cache
    {"k", "v", "k_scale", "v_scale"}, in place: quantize the step's k/v
    rows to e4m3 with one float32 scale per token row per kv head
    (te/fp8.quantize_rowwise) and scatter codes and scales through the
    same flat-index/drop contract.  The codes are scattered through
    uint8 views of the same bytes (PyTorch has no float8
    ``index_copy_``)."""
    ck = cache_layer["k"]
    NB, bs, KH, hd = ck.shape
    B, C = k1.shape[:2]
    idx, valid = paged_flat_idx(pos, block_table, C, bs)
    idx, valid = idx.reshape(-1), valid.reshape(-1)
    for name, x in (("k", k1), ("v", v1)):
        codes, scale = te_fp8.quantize_rowwise(x, ck.dtype)
        _paged_scatter(cache_layer[name].view(torch.uint8), idx, valid,
                       codes.view(torch.uint8).reshape(B * C, KH, hd))
        _paged_scatter(cache_layer[name + "_scale"], idx, valid,
                       scale.reshape(B * C, KH, 1))


def copy_paged_block(ck: torch.Tensor, cv: torch.Tensor, src,
                     dst) -> None:
    """Copy-on-write helper: duplicate physical block `src` into `dst`
    across every layer of the stacked pool ([L, NB, bs, KH, hd]), in
    place.  `src` / `dst` are ints or [1] int64 tensors on the pool's
    device (the form a CUDA graph captures: no host value in the copy);
    8-bit pools are copied through uint8 views of the same bytes."""
    src, dst = (torch.as_tensor(i, device=ck.device).reshape(1).long()
                for i in (src, dst))
    for pool in (ck, cv):
        flat = pool.view(torch.uint8) if pool.element_size() == 1 else pool
        flat.index_copy_(1, dst, flat.index_select(1, src))


# ----------------------------------------------------------------------
# paged attention through the hand-written kernels
# ----------------------------------------------------------------------

def paged_decode_attention(q: torch.Tensor, ck: torch.Tensor,
                           cv: torch.Tensor, block_table: torch.Tensor,
                           kv_len, *, k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Paged decode: the block-table walk runs inside the CUDA kernel
    (kernels/paged_attention.paged_decode, or paged_decode_fp8 over an
    e4m3 pool when `k_scale`/`v_scale` are given)."""
    from repro_torch.kernels import paged_attention as pk
    if k_scale is None:
        return pk.paged_decode(q, ck, cv, block_table, kv_len)
    return pk.paged_decode_fp8(q, ck, cv, block_table, kv_len,
                               k_scale=k_scale, v_scale=v_scale)


def paged_chunk_attention(q: torch.Tensor, ck: torch.Tensor,
                          cv: torch.Tensor, block_table: torch.Tensor,
                          pos, *, k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Paged chunk attention; `pos` [B] is each slot's cache length
    before the chunk (chunk_attention with q_positions = pos + arange(C)).
    With `k_scale`/`v_scale` the pools are e4m3 (paged_chunk_fp8)."""
    from repro_torch.kernels import paged_attention as pk
    if k_scale is None:
        return pk.paged_chunk(q, ck, cv, block_table, pos)
    return pk.paged_chunk_fp8(q, ck, cv, block_table, pos,
                              k_scale=k_scale, v_scale=v_scale)
